"""The measured window: whole grids back to back, and the rate over them.

A grid that has started runs to its end; a new one starts only while the
window is open, so a window holds at least one grid and its length is
the grids' summed wall time, which may pass ``seconds``. The rate is all
the work of the completed grids over all their wall time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List


@dataclasses.dataclass
class GridRun:
    wall_s: float
    result: Any = None        # what the grid returned (None if it raised)
    error: str = ""           # the exception, if the grid raised


def run_window(run_grid: Callable[[], Any], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> List[GridRun]:
    """Call ``run_grid`` (which returns once its grid's work is done on
    the device) until ``seconds`` have passed since the first call. A
    grid that raises ends the window, recorded with its error."""
    runs: List[GridRun] = []
    start = clock()
    while not runs or clock() - start < seconds:
        t0 = clock()
        try:
            out = run_grid()
        except Exception as e:      # a failed grid is a failed result
            runs.append(GridRun(clock() - t0, None, f"{type(e).__name__}: {e}"))
            break
        runs.append(GridRun(clock() - t0, out))
    return runs


def cell_steps_per_s(runs: List[GridRun], cells: int, steps: int) -> float:
    """Σ cells × engine steps over the completed grids, over their summed
    wall time."""
    done = [r for r in runs if not r.error]
    wall = sum(r.wall_s for r in done)
    return len(done) * cells * steps / wall if wall > 0 else 0.0
