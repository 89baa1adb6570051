"""The profiled slice of the traced run, reached through a wrapped
``make_step``, and what the per-layer metrics read from it; and the
warm-up's step hook.

The slice is K steady engine steps of the first group of a grid from
step ``start`` under ``torch.profiler`` with CUDA activity alone, so the
profiler adds no host time to the steps whose device time and idle
share are read. The K steps after it run under CPU and CUDA activity:
their host ops only name the idle gaps of the breakdown. Each end is
synchronized; the grid is then abandoned (``SliceDone``), since only the
slices are wanted. The world's arrays and the state after the first
slice are kept, read back to numpy, for the byte counts of the
rooflines.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# the world's fields the byte counts read
WORLD_FIELDS = ("arrivals", "f_pair", "pair_cand", "path_links",
                "path_sig_delay", "pair_policy", "path_prop")


class SliceDone(Exception):
    """Raised from the step once the slice is recorded, to end the grid."""


def warm_hook(steps: int):
    """A ``make_step`` wrapper whose step runs steps ``0 .. steps - 1``
    and returns the state unchanged after them: the warm-up meets every
    shape of the steps, the build and the scoring without paying for the
    whole horizon."""
    def hook(make_step):
        def make(ar, cfg):
            step = make_step(ar, cfg)

            def warm(st, t):
                return step(st, t) if t < steps else st
            warm.checker = getattr(step, "checker", None)
            return warm
        make.__wrapped__ = make_step
        return make
    return hook


class Slice:
    """``hook(make_step)`` wraps an engine's ``make_step`` so its steps
    ``start .. start + steps - 1`` run under the profiler with CUDA
    activity alone, and the ``steps`` after them with CPU activity too."""

    def __init__(self, start: int, steps: int, on_card: bool = True):
        self.start, self.steps = start, steps
        self.on_card = on_card
        self.prof = self.labelled = None
        self.window_s = None
        self.world: Dict[str, np.ndarray] = {}
        self.flow_path: Optional[np.ndarray] = None
        self.policy = self.sweep_policies = None
        self.num_links = self.ring = None

    def hook(self, make_step):
        def make(ar, cfg):
            step = make_step(ar, cfg)

            def traced(st, t):
                if t == self.start:
                    self.prof = self._start(cuda_only=self.on_card)
                    self._t0 = time.perf_counter()
                elif t == self.start + self.steps:
                    self.labelled = self._start(cuda_only=False)
                st = step(st, t)
                if t == self.start + self.steps - 1:
                    self._sync()
                    self.window_s = time.perf_counter() - self._t0
                    self.prof.stop()
                    self._keep(ar, cfg, st)
                elif t == self.start + 2 * self.steps - 1:
                    self._sync()
                    self.labelled.stop()
                    raise SliceDone()
                return st
            traced.checker = getattr(step, "checker", None)
            return traced
        make.__wrapped__ = make_step
        return make

    def _start(self, cuda_only: bool):
        """A started profiler, after a synchronize: CUDA activity alone,
        or CPU activity (and CUDA activity on the card). Without a card
        both record CPU activity, which has no kernels."""
        self._sync()
        cpu, cuda = (torch.profiler.ProfilerActivity.CPU,
                     torch.profiler.ProfilerActivity.CUDA)
        acts = ([cuda] if cuda_only else [cpu, cuda]) if self.on_card else [cpu]
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def _keep(self, ar, cfg, st) -> None:
        self.world = {n: getattr(ar, n).cpu().numpy() for n in WORLD_FIELDS
                      if getattr(ar, n) is not None}
        self.flow_path = st.flow_path.cpu().numpy()
        self.num_links = int(ar.link_cap.shape[0])
        self.ring = int(st.hist_c.shape[1])
        self.policy, self.sweep_policies = cfg.policy, cfg.sweep_policies

    # ------------------------------------------------------------ readings
    def events(self):
        """``(kernels, labelled_kernels, cpu_ops)`` as ``(start_us,
        end_us, name)``, each sorted by start: the device kernels of the
        slice, and the device kernels and host ops of the labelled slice
        after it (none where the grid ended before it)."""
        kern, _ = _split(self.prof)
        lab, cpu = _split(self.labelled) if self.labelled else ([], [])
        return kern, lab, cpu


def _split(prof):
    """A profiler's device kernels and ``aten::`` host ops."""
    kern, cpu = [], []
    for e in prof.events():
        rec = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kern.append(rec)
        elif e.name.startswith("aten::"):
            cpu.append(rec)
    return sorted(kern), sorted(cpu)


def busy_us(kernels: List[tuple]) -> float:
    """The union of the kernels' intervals, in us (one stream's kernels
    do not overlap, but a union is right either way)."""
    total, end = 0.0, None
    for a, b, _ in kernels:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_ops(kernels: List[tuple], top: int = 10) -> List[list]:
    """The ``top`` kernels by summed device seconds, ``[name, s]``, a
    name cut to its first 120 characters (kernels that share them are
    summed together)."""
    by: Dict[str, float] = {}
    for a, b, name in kernels:
        by[name[:120]] = by.get(name[:120], 0.0) + (b - a) * 1e-6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


def idle_gaps(kernels: List[tuple], cpu_ops: List[tuple], span: str,
              top: int = 10) -> List[list]:
    """The device's idle gaps between kernels, summed by what the host
    was doing at each gap's midpoint: the innermost host op then running
    (``<span>: aten::...``), else ``<span>: python`` (the host between
    ops). The ``top`` labels by summed seconds, ``[label, s]``."""
    starts = [c[0] for c in cpu_ops]
    by: Dict[str, float] = {}
    end = None
    for a, b, _ in kernels:
        if end is not None and a > end:
            mid = 0.5 * (a + end)
            label = "python"
            i = bisect.bisect_right(starts, mid)
            # the latest-starting op that still runs at mid is the innermost
            for j in range(i - 1, max(i - 64, -1), -1):
                if cpu_ops[j][1] >= mid:
                    label = cpu_ops[j][2]
                    break
            key = f"{span}: {label}"
            by[key] = by.get(key, 0.0) + (a - end) * 1e-6
        end = b if end is None else max(end, b)
    return [[k, s] for k, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
