"""A whole run of the harness on the CPU at a small size (no look for a
card; the kernels' plain versions), unbroken and then with the timed
path broken underneath it in each way this kind of cell can break:
``correct`` has to come out true, then false each time."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from portbench import cells
from portbench import run as runmod

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "testbed8.fig5-fluid"


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """fig5-fluid's configuration and limits, at a 4 ms horizon and two
    cells, under the name of the real cell."""
    data = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(BENCH, sub), data / sub)
    shutil.copy(os.path.join(BENCH, "peaks.json"), data / "peaks.json")
    conf = json.loads((data / "configs" / "testbed8.json").read_text())
    conf["spec"]["duration_us"] = 4_000
    (data / "configs" / "testbed8.json").write_text(json.dumps(conf))
    mix = json.loads((data / "traffic" / "fig5-fluid.json").read_text())
    mix.update(loads=[0.8], policies=["ecmp", "lcmp"])
    (data / "traffic" / "fig5-fluid.json").write_text(json.dumps(mix))
    monkeypatch.setattr(cells, "DATA", str(data))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield monkeypatch
    torch.set_num_threads(threads)


def _run(trace: int = 0) -> dict:
    cell = cells.load_cell(CELL)
    args = runmod.parse(["--workload", CELL, "--seed", "2147483659",
                         "--seconds", "0", "--trace", str(trace)])
    return runmod.run_cell(cell, args, "cpu")[0]


def test_sound_run_is_correct(tiny):
    res = _run(trace=1)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 2
    assert list(res)[-1] == "checks"
    assert {"build_s", "score_s", "step_ms"} <= set(res["metrics"])


def _unchanged_state(monkeypatch):
    from repro_torch.netsim import fluid

    def make_step(ar, cfg):
        def step(st, t):
            return st
        step.checker = None
        return step
    monkeypatch.setattr(fluid, "make_step", make_step)


def _half_the_cells(monkeypatch):
    from repro_torch.netsim import sweep
    orig = sweep.run_group

    def run_group(group):
        out = orig(group)
        half = (len(out) + 1) // 2
        return out[:half] + [dataclasses.replace(r, spec=s) for r, s in zip(
            out[:len(out) - half], group.specs[half:])]
    monkeypatch.setattr(sweep, "run_group", run_group)


def _altered_answer(monkeypatch):
    from repro_torch.netsim import sweep
    orig = sweep._view

    def view(st):
        out = orig(st)
        done = np.flatnonzero(out.done)
        out.fct_us = out.fct_us.copy()
        out.fct_us[done[len(done) // 2]] += 1.0
        return out
    monkeypatch.setattr(sweep, "_view", view)


def _scored_wrong(monkeypatch):
    """Scoring off by a thousandth (a wrong ideal FCT), every FCT kept."""
    from repro_torch.netsim import metrics
    orig = metrics.fct_stats

    def fct_stats(*args, **kwargs):
        st = orig(*args, **kwargs)
        return dataclasses.replace(st, slowdown=st.slowdown * 1.001)
    monkeypatch.setattr(metrics, "fct_stats", fct_stats)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_cells,
                                   _altered_answer, _scored_wrong])
def test_broken_path_is_not_correct(tiny, fault):
    fault(tiny)
    res = _run()
    assert not res["correct"] and res["failed"] > 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
