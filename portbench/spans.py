"""Spans recorded from the benchmark's own files: the program's functions
that ``run_sweep`` calls are wrapped by name for the traced run, each
call timed on the host's clock and closed by a device synchronize, so a
span covers the device work its call enqueued.

Wrapped (module attribute, span name):
- ``repro_torch.netsim.sweep.build_group`` -> ``build``: world, traffic,
  engine build and merge of one static group;
- ``repro_torch.netsim.sweep.run_group`` -> ``group``: the engine run and
  the scoring of every cell of the group;
- ``repro_torch.netsim.<engine>.run`` -> ``engine``: the steps alone;
- ``repro_torch.netsim.<engine>.make_step`` -> the step, which the
  profiled slice (``trace.Slice``) hooks.
"""
from __future__ import annotations

import contextlib
import importlib
import time
from typing import Callable, Dict, List

import torch

TARGETS = (("repro_torch.netsim.sweep", "build_group", "build"),
           ("repro_torch.netsim.sweep", "run_group", "group"),
           ("repro_torch.netsim.fluid", "run", "engine"),
           ("repro_torch.netsim.packet", "run", "engine"))


class Recorder:
    """Spans ``(name, start_s, end_s)`` on the host clock, in memory."""

    def __init__(self, sync: Callable[[], None] = torch.cuda.synchronize):
        self.spans: List[tuple] = []
        self.sync = sync

    def wrap(self, fn, name: str):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.sync()
                self.spans.append((name, t0, time.perf_counter()))
        timed.__wrapped__ = fn
        return timed

    def totals(self) -> Dict[str, float]:
        """Seconds by span name, and ``<name>.n``: how many spans."""
        out: Dict[str, float] = {}
        for name, a, b in self.spans:
            out[name] = out.get(name, 0.0) + (b - a)
            out[name + ".n"] = out.get(name + ".n", 0) + 1
        return out

    def clear(self) -> None:
        self.spans.clear()


@contextlib.contextmanager
def patched(replacements):
    """Set ``module.attr = value`` for each ``(module, attr, value)`` and
    restore every original on exit."""
    saved = []
    try:
        for mod_name, attr, value in replacements:
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, value)
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def span_patches(rec: Recorder) -> list:
    """The replacements that make ``rec`` record every span of
    ``TARGETS``."""
    out = []
    for mod_name, attr, name in TARGETS:
        fn = getattr(importlib.import_module(mod_name), attr)
        out.append((mod_name, attr, rec.wrap(fn, name)))
    return out
