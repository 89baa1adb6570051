"""Per-pair piecewise-constant load schedules (``ExpSpec.load_sched``).

Counterpart of ``repro/traffic/sched.py`` (NumPy, identical arrays).

The paper's evaluation holds offered load fixed per run; real inter-DC
traffic is dominated by the diurnal cycle — each DC's demand follows
local time (timezone ~= longitude / 15 deg per hour), weighted by the
population it serves, punctured by flash crowds and occasional
traffic-matrix shifts. This module builds the ``(sched_t, load_rows,
bg_rows)`` arrays ``traffic.gen.generate`` consumes, from a wire string
with the same grammar as the scenario registry::

    ExpSpec(load_sched="diurnal:amp=0.8,segs=24")
    ExpSpec(load_sched="diurnal:flash_at_ms=150,flash_dur_ms=30,flash_mult=3")
    ExpSpec(load_sched="flash:at_ms=100,dur_ms=20,mult=4")
    ExpSpec(load_sched="const:segs=8")     # == scalar load, bit-for-bit

Rows are load *multipliers* with time-average ~1 per pair (population
weights are normalized to mean 1 within each dose group), so
``ExpSpec.load`` keeps its meaning as the pair's time-average
utilization. Schedules only reshape the flow tables, never
``SimConfig``.

Families (``FAMILIES`` is wire format, pinned by the registry test):

- ``const``  : all-ones rows over ``segs`` segments. Exercises the
  schedule plumbing while reproducing the legacy scalar draw sequence
  bit-for-bit (constant rows take the homogeneous path in gen).
- ``diurnal``: ``w_p * (1 + amp * cos(2 pi * (local_p(t) - peak_h/24)))``
  sampled at segment midpoints, where ``local_p(t) = t/day + lon_src/360``
  is the source DC's local time fraction (one compressed 24 h cycle per
  ``day_ms``, default the run duration) and ``w_p`` the population
  weight ``pop_src * pop_dst`` (mean-1 normalized per group; scenarios
  without ``dc_pop``/``dc_lon`` run unweighted at phase 0). Optional
  flash crowd (``flash_at_ms``/``flash_dur_ms``/``flash_mult``, on all
  pairs or only those sourced at DC ``flash_src``) and a mid-run
  traffic-matrix shift (``shift_ms``: the population-weight assignment
  reverses across each group — demand migrates between metros).
- ``flash``  : flat rows with only the flash-crowd window — the
  isolated burst case (``at_ms``/``dur_ms``/``mult``/``src``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from . import scenarios as scenmod

FAMILIES: Tuple[str, ...] = ("const", "diurnal", "flash")


def _grid(duration_us: int, segs: int) -> np.ndarray:
    """(K,) int64 segment start times: K equal segments over the run."""
    segs = max(int(segs), 1)
    return (np.arange(segs, dtype=np.int64) * int(duration_us)) // segs


def _mids(sched_t: np.ndarray, duration_us: int) -> np.ndarray:
    """(K,) float64 segment midpoints (where shapes are sampled)."""
    ends = np.append(sched_t[1:], duration_us).astype(np.float64)
    return (sched_t + ends) / 2.0


def _weights(table, scen, pids) -> np.ndarray:
    """Mean-1 population weights ``pop_src * pop_dst`` for one dose
    group (all-ones when the scenario carries no ``dc_pop``)."""
    pids = np.asarray(pids, np.int64)
    if scen is None or scen.dc_pop is None or len(pids) == 0:
        return np.ones(len(pids), np.float64)
    pop = np.asarray(scen.dc_pop, np.float64)
    w = (pop[np.asarray(table.pair_src)[pids]]
         * pop[np.asarray(table.pair_dst)[pids]])
    return w / w.mean()


def _src_lon_frac(table, scen, pids) -> np.ndarray:
    """Per-pair timezone phase: source DC longitude as a fraction of the
    day (lon / 15 deg-per-hour / 24 h = lon / 360). Zero without
    ``dc_lon`` metadata."""
    pids = np.asarray(pids, np.int64)
    if scen is None or scen.dc_lon is None or len(pids) == 0:
        return np.zeros(len(pids), np.float64)
    lon = np.asarray(scen.dc_lon, np.float64)
    return lon[np.asarray(table.pair_src)[pids]] / 360.0


def _group_rows(table, scen, pids, sched_t, duration_us, *, amp, day_us,
                peak_frac, weighted, flash_at, flash_dur, flash_mult,
                flash_src, shift_at) -> np.ndarray:
    """(P, K) multiplier rows for one dose group."""
    pids = np.asarray(pids, np.int64)
    mids = _mids(sched_t, duration_us)
    w = (_weights(table, scen, pids) if weighted
         else np.ones(len(pids), np.float64))
    phase = _src_lon_frac(table, scen, pids)
    local = mids[None, :] / day_us + phase[:, None]
    shape = 1.0 + amp * np.cos(2.0 * np.pi * (local - peak_frac))
    rows = w[:, None] * shape
    if shift_at >= 0:
        # traffic-matrix shift: the weight assignment reverses across
        # the group from shift_at on (metro demand migrates)
        rows = np.where(mids[None, :] >= shift_at,
                        w[::-1][:, None] * shape, rows)
    if flash_at >= 0 and flash_dur > 0 and flash_mult != 1.0:
        seg_in = (mids >= flash_at) & (mids < flash_at + flash_dur)
        if flash_src >= 0:
            pair_in = np.asarray(table.pair_src)[pids] == flash_src
        else:
            pair_in = np.ones(len(pids), bool)
        rows = rows * np.where(pair_in[:, None] & seg_in[None, :],
                               float(flash_mult), 1.0)
    return np.clip(rows, 0.0, None)


def _const(duration_us, table, scen, fg_ids, bg_ids, segs: int = 4):
    t = _grid(duration_us, segs)
    return (t, np.ones((len(fg_ids), len(t))), np.ones((len(bg_ids), len(t))))


def _diurnal(duration_us, table, scen, fg_ids, bg_ids, amp: float = 0.8,
             day_ms: int = 0, segs: int = 24, peak_h: float = 20.0,
             weighted: int = 1, flash_at_ms: int = -1,
             flash_dur_ms: int = 0, flash_mult: float = 3.0,
             flash_src: int = -1, shift_ms: int = -1):
    if not 0.0 <= float(amp) < 1.0:
        raise ValueError(f"diurnal amp must be in [0, 1), got {amp}")
    t = _grid(duration_us, segs)
    day_us = float(int(day_ms) * 1000 if int(day_ms) > 0 else duration_us)
    kw = dict(amp=float(amp), day_us=day_us,
              peak_frac=float(peak_h) / 24.0, weighted=int(weighted),
              flash_at=float(flash_at_ms) * 1000.0,
              flash_dur=float(flash_dur_ms) * 1000.0,
              flash_mult=float(flash_mult), flash_src=int(flash_src),
              shift_at=float(shift_ms) * 1000.0)
    return (t, _group_rows(table, scen, fg_ids, t, duration_us, **kw),
            _group_rows(table, scen, bg_ids, t, duration_us, **kw))


def _flash(duration_us, table, scen, fg_ids, bg_ids, at_ms: int = 0,
           dur_ms: int = 0, mult: float = 3.0, src: int = -1,
           segs: int = 24, weighted: int = 0):
    if int(dur_ms) <= 0:
        raise ValueError("flash needs dur_ms > 0")
    t = _grid(duration_us, segs)
    kw = dict(amp=0.0, day_us=float(duration_us), peak_frac=0.0,
              weighted=int(weighted), flash_at=float(at_ms) * 1000.0,
              flash_dur=float(dur_ms) * 1000.0, flash_mult=float(mult),
              flash_src=int(src), shift_at=-1.0)
    return (t, _group_rows(table, scen, fg_ids, t, duration_us, **kw),
            _group_rows(table, scen, bg_ids, t, duration_us, **kw))


_BUILDERS = {"const": _const, "diurnal": _diurnal, "flash": _flash}
assert tuple(sorted(_BUILDERS)) == tuple(sorted(FAMILIES))


def build(spec: str, duration_us: int, table, scen=None,
          fg_ids=(), bg_ids=()) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resolve a schedule string to ``(sched_t (K,), fg_rows (P_fg, K),
    bg_rows (P_bg, K))`` multiplier arrays for ``gen.generate``."""
    name, params = scenmod.parse(spec)
    if name not in _BUILDERS:
        raise ValueError(f"unknown load schedule {name!r}; "
                         f"available: {', '.join(FAMILIES)}")
    try:
        return _BUILDERS[name](int(duration_us), table, scen,
                               list(fg_ids), list(bg_ids), **params)
    except TypeError as e:
        raise ValueError(f"bad parameters for load schedule {name!r}: "
                         f"{e}") from e
