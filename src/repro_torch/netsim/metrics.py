"""FCT-slowdown and utilization metrics (paper §6 "Metrics"); counterpart
of ``repro/netsim/metrics.py`` (``FCTStats`` with ``completion_rate`` and
``by_size_bucket``, ``fct_stats`` with ``mask``, amp's subflow collapse
and the sanitizer's host checks under ``REPRO_CHECKS=1``,
``completion_wall_us``, ``fg_bg_stats``, ``phase_stats``,
``per_pair_stats``, ``link_utilization``).

Slowdown = actual FCT / ideal FCT, the ideal being the flow alone on the
pair's minimum-propagation-delay candidate: prop(best) + size /
bottleneck_cap(best). Final states are read back to numpy once, after
the run; a final state may also be numpy arrays by field name (a sweep
cell's ``CellResult.final``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.netsim import sanitize
from repro_torch.netsim.engine import SimArrays, SimConfig, SimState
from repro_torch.netsim.paths import PathTable
from repro_torch.traffic.gen import FlowSet


@dataclasses.dataclass
class FCTStats:
    slowdown: np.ndarray     # (F_done,)
    sizes: np.ndarray        # (F_done,)
    completed: int
    offered: int

    @property
    def completion_rate(self) -> float:
        """completed/offered: slowdown percentiles cover completed flows
        only, so read this beside them."""
        return self.completed / self.offered if self.offered else float("nan")

    def pct(self, q: float) -> float:
        return (float(np.percentile(self.slowdown, q)) if len(self.slowdown)
                else float("nan"))

    @property
    def p50(self) -> float:
        return self.pct(50)

    @property
    def p99(self) -> float:
        return self.pct(99)

    def by_size_bucket(self, edges) -> Dict[str, Dict[str, float]]:
        out = {}
        for lo, hi in zip(edges[:-1], edges[1:]):
            m = (self.sizes >= lo) & (self.sizes < hi)
            if m.sum() >= 5:
                s = self.slowdown[m]
                out[f"{int(lo)}-{int(hi)}"] = {
                    "p50": float(np.percentile(s, 50)),
                    "p99": float(np.percentile(s, 99)),
                    "n": int(m.sum()),
                }
        return out


def as_numpy(x) -> np.ndarray:
    """A state field as numpy: a tensor read back, else as it is."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _collapse_subflows(flows: FlowSet, done, fct, mask):
    """Per-subflow rows back to parent flows (amp): a parent is done when
    all its subflows delivered, its FCT is the last subflow's, its size
    the summed bytes; ``mask`` and the pair are uniform within a parent."""
    sof = np.asarray(flows.subflow_of)
    n = int(sof.max()) + 1 if len(sof) else 0
    done_p = np.ones(n, bool)
    np.logical_and.at(done_p, sof, done)
    fct_p = np.zeros(n, np.float64)
    np.maximum.at(fct_p, sof, np.where(done, fct, 0.0))
    size_p = np.zeros(n, np.float64)
    np.add.at(size_p, sof, flows.size_bytes)
    pair_p = np.zeros(n, np.int32)
    pair_p[sof] = flows.pair_id
    mask_p = None
    if mask is not None:
        mask_p = np.zeros(n, bool)
        mask_p[sof] = np.asarray(mask)
        done_p = done_p & mask_p
    return done_p, fct_p, size_p, pair_p, mask_p


def fct_stats(final: SimState, table: PathTable, flows: FlowSet,
              cfg: SimConfig, mask=None) -> FCTStats:
    """Slowdown stats over all flows, or the ``mask``-selected subset;
    subflow sets (``flows.subflow_of``) are scored per parent flow."""
    done = as_numpy(final.done)
    fct = as_numpy(final.fct_us)
    sizes = flows.size_bytes
    pair = flows.pair_id
    if getattr(flows, "subflow_of", None) is not None:
        done, fct, sizes, pair, mask = _collapse_subflows(
            flows, done, fct, mask)
    elif mask is not None:
        done = done & mask
    prop = table.pair_ideal_prop[pair].astype(np.float64)
    cap = table.pair_ideal_cap[pair] * 125.0 * cfg.cap_scale
    ideal = prop + sizes / cap
    sl = fct[done] / ideal[done]
    offered = int(mask.sum()) if mask is not None else len(done)
    if sanitize.host_checks_enabled():
        # completion-accounting identity (host-side half of the
        # completion_identity invariant)
        sanitize.host_check(int(done.sum()) <= offered,
                            "completion_identity: more completions than "
                            "offered flows")
        sanitize.host_check(bool((fct[done] > 0.0).all()),
                            "completion_identity: completed flow with "
                            "FCT <= 0")
        sanitize.host_check(bool(np.isfinite(sl).all()),
                            "completion_identity: non-finite slowdown")
    return FCTStats(slowdown=np.maximum(sl, 1.0), sizes=sizes[done],
                    completed=int(done.sum()), offered=offered)


def completion_wall_us(final: SimState, flows: FlowSet) -> np.ndarray:
    """(F,) wall-clock completion time per flow row (arrival plus FCT),
    NaN where the flow never delivered."""
    done = as_numpy(final.done)
    wall = np.asarray(flows.arrival_us, np.float64) + as_numpy(final.fct_us)
    return np.where(done, wall, np.nan)


def fg_bg_stats(final: SimState, table: PathTable, flows: FlowSet,
                cfg: SimConfig, overall: FCTStats = None):
    """(foreground, background) FCTStats; background is None when every
    flow is foreground (``overall`` is reused for that case if given)."""
    fg = flows.foreground
    if fg.all():
        return (overall if overall is not None
                else fct_stats(final, table, flows, cfg)), None
    return (fct_stats(final, table, flows, cfg, mask=fg),
            fct_stats(final, table, flows, cfg, mask=~fg))


def phase_stats(final: SimState, table: PathTable, flows: FlowSet,
                cfg: SimConfig, sched_t, seg_phase,
                mask=None) -> Dict[str, FCTStats]:
    """FCTStats per schedule phase: each flow belongs to the segment of
    ``sched_t`` its arrival falls in, ``seg_phase[k]`` labels segment k;
    one entry per distinct label, in first-appearance order."""
    sched_t = np.asarray(sched_t, np.int64)
    seg_phase = list(seg_phase)
    if len(seg_phase) != len(sched_t):
        raise ValueError(f"seg_phase must label all {len(sched_t)} "
                         f"segments, got {len(seg_phase)}")
    seg = np.searchsorted(sched_t, np.asarray(flows.arrival_us),
                          side="right") - 1
    out: Dict[str, FCTStats] = {}
    for ph in dict.fromkeys(seg_phase):
        in_ph = np.isin(seg, [k for k, p in enumerate(seg_phase)
                              if p == ph])
        if mask is not None:
            in_ph = in_ph & mask
        out[ph] = fct_stats(final, table, flows, cfg, mask=in_ph)
    return out


def per_pair_stats(final: SimState, table: PathTable, flows: FlowSet,
                   cfg: SimConfig) -> Dict[int, FCTStats]:
    """FCTStats per traffic pair present in the flow set."""
    return {int(pid): fct_stats(final, table, flows, cfg,
                                mask=flows.pair_id == pid)
            for pid in np.unique(flows.pair_id)}


def link_utilization(final: SimState, arrs: SimArrays,
                     cfg: SimConfig) -> np.ndarray:
    """Average served utilization per link over the horizon (Fig. 1b),
    normalized by the effective capacity-time integral."""
    T = cfg.num_steps
    cap = arrs.link_cap.cpu().numpy().astype(np.float64)
    alive = np.clip(arrs.link_fail_step.cpu().numpy().astype(np.int64), 0, T)
    deg = np.clip(arrs.link_deg_step.cpu().numpy().astype(np.int64), 0, T)
    full = np.minimum(alive, deg)
    fac = arrs.link_deg_factor.cpu().numpy().astype(np.float64)
    eff_steps = full + fac * np.maximum(alive - full, 0)
    cap_total = cap * eff_steps * cfg.dt_us
    return final.serv_bytes.cpu().numpy() / np.maximum(cap_total, 1e-9)
