"""Iteration-time metrics over a co-simulated run, and the telemetry
feedback loop into ``dist.lcmp_collectives`` (counterpart of
``repro/cosim/iterate.py``). A final state is a run's state (tensors on
any device) or numpy arrays by field name (a sweep cell's
``CellResult.final``).

A training iteration completes when its LAST bucket flow delivers —
barrier semantics per pod: the optimizer step waits on every
reduce-scatter and all-gather bucket of the iteration, so the
iteration's makespan is the wall-clock completion of its straggler
bucket minus the iteration start. ``straggler_routes`` attributes those
waits to the simulated routes the buckets actually took, and
``feed_route_telemetry`` replays the measured per-bucket times into a
``RouteTelemetry`` register file — closing the loop the dist layer
previously faked with synthetic wall times: route demotion for future
buckets is now driven by simulated congestion.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.cosim.workload import CosimPlan
from repro_torch.dist.lcmp_collectives import RouteTelemetry
from repro_torch.netsim import sanitize
from repro_torch.netsim.metrics import as_numpy, completion_wall_us


@dataclasses.dataclass(frozen=True)
class IterStats:
    """Per-iteration makespans of one co-simulated training run."""
    makespan_ms: np.ndarray    # (I,) float64; NaN = iteration incomplete
    iters_total: int

    @property
    def iters_done(self) -> int:
        return int(np.isfinite(self.makespan_ms).sum())

    @property
    def completion_rate(self) -> float:
        return (self.iters_done / self.iters_total if self.iters_total
                else float("nan"))

    def pct(self, q: float) -> float:
        done = self.makespan_ms[np.isfinite(self.makespan_ms)]
        return float(np.percentile(done, q)) if len(done) else float("nan")

    def pct_strict(self, q: float) -> float:
        """Percentile over ALL iterations with incomplete ones at +inf —
        the ordering metric. A policy that drops an iteration trained
        infinitely slowly that step; excluding it would let survivorship
        bias make the worst policy look fastest."""
        if not len(self.makespan_ms):
            return float("nan")
        mk = np.where(np.isfinite(self.makespan_ms), self.makespan_ms,
                      np.inf)
        # nearest-rank: interpolating adjacent ranks would compute
        # inf - inf = nan once any iteration is incomplete
        return float(np.percentile(mk, q, method="nearest"))

    @property
    def p50_ms(self) -> float:
        return self.pct(50)

    @property
    def p99_ms(self) -> float:
        return self.pct(99)


def _cosim_rows(plan: CosimPlan, flows, final):
    """(plan_idx, done, wall_us) for the co-simulated rows of a run."""
    if flows.cosim_of is None:
        raise ValueError("FlowSet has no cosim_of — was it built with "
                         "overlay()?")
    rows = np.nonzero(np.asarray(flows.cosim_of) >= 0)[0]
    pidx = np.asarray(flows.cosim_of)[rows]
    if len(pidx) != plan.num_rows:
        raise ValueError(f"flow set carries {len(pidx)} cosim rows, plan "
                         f"has {plan.num_rows}")
    wall = completion_wall_us(final, flows)[rows]
    done = as_numpy(final.done)[rows]
    return rows, pidx, done, wall


def iteration_stats(plan: CosimPlan, flows, final) -> IterStats:
    """Per-iteration makespan under barrier semantics: an iteration is
    complete iff ALL its bucket flows (both collective phases) delivered
    inside the horizon; its makespan is the straggler bucket's wall
    completion minus the iteration start."""
    _, pidx, done, wall = _cosim_rows(plan, flows, final)
    iters = plan.iter_of[pidx]
    all_done = np.ones(plan.n_iters, bool)
    np.logical_and.at(all_done, iters, done)
    last = np.zeros(plan.n_iters, np.float64)
    np.maximum.at(last, iters, np.where(done, wall, 0.0))
    mk = (last - plan.iter_start_us(np.arange(plan.n_iters))) / 1000.0
    if sanitize.host_checks_enabled():
        # barrier causality: no complete iteration finishes before it
        # starts (would mean a bucket's wall completion predates arrival)
        sanitize.host_check(bool(np.all(mk[all_done] >= 0.0)),
                            "cosim barrier: iteration completes before "
                            "its start")
    return IterStats(makespan_ms=np.where(all_done, mk, np.nan),
                     iters_total=plan.n_iters)


def straggler_routes(plan: CosimPlan, flows, final) -> Dict[int, Dict]:
    """Straggler attribution per simulated route: for each global path
    index the collective buckets landed on, the bucket count, the mean
    and max bucket completion time (ms from the bucket's own arrival),
    and how many times that route carried an iteration's straggler
    bucket. Undelivered buckets attribute to their chosen route with an
    infinite time (they ARE the straggler)."""
    rows, pidx, done, wall = _cosim_rows(plan, flows, final)
    path = as_numpy(final.flow_path)[rows]
    arr = np.asarray(flows.arrival_us)[rows]
    ms = np.where(done, (wall - arr) / 1000.0, np.inf)
    iters = plan.iter_of[pidx]
    # straggler bucket per iteration: the max completion wall (undone
    # buckets dominate via +inf)
    wall_inf = np.where(done, wall, np.inf)
    strag = np.full(plan.n_iters, -1, np.int64)
    for i in range(plan.n_iters):
        sel = np.nonzero(iters == i)[0]
        if len(sel):
            strag[i] = sel[int(np.argmax(wall_inf[sel]))]
    out: Dict[int, Dict] = {}
    for p in np.unique(path):
        m = path == p
        out[int(p)] = {
            "buckets": int(m.sum()),
            "mean_ms": float(ms[m][np.isfinite(ms[m])].mean())
            if np.isfinite(ms[m]).any() else float("inf"),
            "max_ms": float(ms[m].max()),
            "stragglers": int(sum(1 for s in strag
                                  if s >= 0 and path[s] == p)),
        }
    return out


def pair_path_slots(table, pair_id: int) -> Dict[int, int]:
    """{global path index: candidate-slot index} for one pair — the
    mapping that names each simulated route as a telemetry register."""
    out: Dict[int, int] = {}
    for k in range(int(table.pair_ncand[pair_id])):
        out[int(table.pair_cand[pair_id, k])] = k
    return out


def feed_route_telemetry(plan: CosimPlan, flows, final,
                         telemetry: RouteTelemetry,
                         path_slot: Optional[Dict[int, int]] = None,
                         table=None) -> RouteTelemetry:
    """Replay the run's measured per-bucket times into a Q/T/D register
    file, one ``observe_measured`` call per training iteration in order
    — the co-simulation feedback seam: ``schedule_buckets`` consulted
    after this demotes routes that the *simulated* network congested,
    not routes a synthetic wall clock flagged.

    ``path_slot`` maps global path index -> telemetry register (default:
    the measured pair's candidate slots via ``pair_path_slots`` when
    ``table`` is given). Buckets on unmapped paths are dropped (slot -1,
    ``observe_measured`` semantics); undelivered buckets register at the
    horizon-sized time ``2 x period`` — persistently failing routes must
    look slow, not invisible.
    """
    if path_slot is None:
        if table is None:
            raise ValueError("feed_route_telemetry needs path_slot or table")
        path_slot = pair_path_slots(table, int(plan.pair_id[0]))
    rows, pidx, done, wall = _cosim_rows(plan, flows, final)
    path = as_numpy(final.flow_path)[rows]
    arr = np.asarray(flows.arrival_us)[rows]
    ms = np.where(done, (wall - arr) / 1000.0, 2 * plan.period_us / 1000.0)
    slots = np.array([path_slot.get(int(p), -1) for p in path], np.int64)
    iters = plan.iter_of[pidx]
    for i in range(plan.n_iters):
        m = iters == i
        telemetry.observe_measured(ms[m].astype(np.int64), slots[m], step=i)
    return telemetry
