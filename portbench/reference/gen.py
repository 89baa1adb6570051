"""Synthetic inter-DC traffic generation (paper §6 workloads).

Given a topology's path table, a size CDF, and a target average
utilization rho, generate Poisson flow arrivals across the requested
pairs (all-to-all, a single DC pair for the testbed experiments, or a
foreground pair measured under background cross-traffic).

Load calibration follows the standard FCT-benchmark convention, applied
**per pair** (see ``dose_bases``): each pair's arrival byte-rate equals
``rho x (number of distinct first-hop links among its candidates) x
min(first-hop cap / sharing)`` — under ECMP each of the N first-hop
links carries total/N and the smallest link is the binding constraint,
so this is the rho that makes the *ideal* placement run the pair's
bottleneck class at the requested utilization; ``sharing`` splits each
first-hop link's budget across the dosed pairs using it, so all-to-all
grids don't double-count shared links. (Check: 30% on the 8-DC
testbed -> 6 x 40 G x 0.3 = 72 Gbps total -> 200G links at 6%, 40G
links at 30% under ECMP — exactly the paper's quoted Fig. 1b values.)

Historically all requested pairs shared ONE aggregate budget computed
off the *global* min first-hop capacity with flows assigned to pairs
uniformly — on a heterogeneous WAN that under-doses every fat pair and
over-doses every thin one. Each pair now runs its own independent
Poisson process against its own bottleneck class, and the generator
reports the per-pair target and realized byte-rates (``dose_*`` fields)
so benchmarks can assert dosing accuracy instead of trusting it.

``bg_pair_ids``/``bg_load`` add background cross-traffic: those pairs
are dosed at ``bg_load`` while the requested pairs run at ``load``, and
``FlowSet.fg_mask`` marks which flows belong to the measured foreground
set (see ``metrics.fg_bg_stats``).

``sched_t``/``load_rows``/``bg_rows`` promote each pair's dose from a
static scalar to a piecewise-constant **load schedule** (diurnal sine
curves phase-shifted by DC timezone, flash crowds, traffic-matrix
shifts — built by ``traffic.sched``). Non-constant rows run a
non-homogeneous Poisson process by thinning; constant rows take the
legacy homogeneous draw path bit-for-bit, so the schedule machinery is
a strict superset of the scalar interface.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .paths import PathTable
from .cdf import SizeCDF


@dataclasses.dataclass(frozen=True)
class FlowSet:
    """Flat arrays describing all flows of one experiment (numpy)."""
    arrival_us: np.ndarray   # (F,) int64, sorted
    size_bytes: np.ndarray   # (F,) float64
    pair_id: np.ndarray      # (F,) int32 index into PathTable pair_*
    flow_id: np.ndarray      # (F,) uint32 (hash key)
    # foreground-pair membership (None == all foreground, legacy callers)
    fg_mask: Optional[np.ndarray] = None      # (F,) bool
    # multi-subflow transports (amp): row -> parent-flow index. None for
    # ordinary one-flow-per-row sets; when set, metrics score the PARENT
    # (done = all subflows done, FCT = last subflow, size = sum).
    subflow_of: Optional[np.ndarray] = None   # (F,) int32
    # co-simulated collective rows (repro.cosim): row -> index into the
    # CosimPlan's bucket-flow arrays, -1 for ordinary (background) rows.
    # None for sets with no overlay — the legacy wire shape exactly.
    cosim_of: Optional[np.ndarray] = None     # (F,) int32
    # dosing telemetry, one row per dosed pair (None for hand-built sets)
    dose_pair: Optional[np.ndarray] = None    # (P,) int32 pair ids
    dose_target: Optional[np.ndarray] = None  # (P,) float64 target bytes/us
    dose_real: Optional[np.ndarray] = None    # (P,) float64 realized bytes/us

    @property
    def num_flows(self) -> int:
        return len(self.arrival_us)

    @property
    def foreground(self) -> np.ndarray:
        """(F,) bool — True for flows of the measured (foreground) pairs."""
        if self.fg_mask is None:
            return np.ones(self.num_flows, bool)
        return self.fg_mask

    def dosing_error(self) -> float:
        """|realized - target| / target over the aggregate byte-rate —
        the offered-load accuracy benchmarks assert (NaN if untracked)."""
        if self.dose_target is None or self.dose_target.sum() <= 0:
            return float("nan")
        tot_t = float(self.dose_target.sum())
        tot_r = float(self.dose_real.sum())
        return abs(tot_r - tot_t) / tot_t


def dose_bases(table: PathTable, pair_ids) -> np.ndarray:
    """Per-pair calibration bases in Gbps for a *jointly dosed* pair set.

    A pair's basis is ``N_first_hops x min(first-hop cap / sharing)``
    over its candidate paths — the byte budget that runs the pair's own
    bottleneck class at 100% under ideal (ECMP-even) placement, where
    ``sharing`` divides each first-hop link's capacity by the number of
    dosed pairs using it as a first hop. Without the sharing split an
    all-to-all workload double-counts every shared link (two pairs each
    dosing the same 400G chord at its full capacity oversubscribes the
    network at nominal "30% load"); with it, a single-pair run reduces
    to the classic ``N x min(cap)`` convention unchanged."""
    pair_ids = np.asarray(pair_ids, np.int32)
    use: dict = {}         # first-hop link -> number of dosed pairs on it
    per_pair = []          # per pair: {first-hop link: bottleneck cap}
    for pid in pair_ids:
        links = {}
        for k in range(int(table.pair_ncand[pid])):
            p = int(table.pair_cand[pid, k])
            links[int(table.path_first[p])] = int(table.path_cap[p])
        if not links:
            raise ValueError(f"pair {int(pid)} has no installed candidate "
                             "paths")
        per_pair.append(links)
        for li in links:
            use[li] = use.get(li, 0) + 1
    return np.array([len(links) * min(c / use[li]
                                      for li, c in links.items())
                     for links in per_pair], np.float64)


def pair_dose_basis(table: PathTable, pid: int) -> float:
    """Single-pair basis (no sharing): ``N_first_hops x min cap``."""
    return float(dose_bases(table, [pid])[0])


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    """numpy twin of ``core.select.fmix32`` (MurmurHash3 finalizer)."""
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def _split_subflows(arrivals, sizes, pids, fids, fg, k: int):
    """AMP-style multi-subflow expansion: each parent flow becomes ``k``
    subflows of ``size/k`` arriving together, each with its own
    deterministic hash key derived from the parent id (distinct keys are
    what makes the subflows route independently under hash-based
    policies). Returns the expanded arrays plus the ``subflow_of``
    row -> parent map metrics use to score the parent at last-subflow
    completion. Runs AFTER the rng draw sequence is complete, so the
    ``n_subflows=1`` path stays bit-for-bit identical to legacy output."""
    n = len(arrivals)
    rep = lambda a: np.repeat(a, k)
    sub_k = np.tile(np.arange(k, dtype=np.uint32), n)
    sub_fid = _fmix32_np(rep(fids) ^ (sub_k * np.uint32(0x9E3779B9)))
    sub_fid = np.where(sub_fid == 0, np.uint32(1), sub_fid)  # ids stay nonzero
    return (rep(arrivals), rep(sizes) / k, rep(pids), sub_fid, rep(fg),
            np.repeat(np.arange(n, dtype=np.int32), k))


def _poisson_window(rng: np.random.Generator, lam: float,
                    duration_us: int) -> np.ndarray:
    """Arrival times of one Poisson process covering the FULL window.

    Draws ``1.2x expected + 64`` exponential gaps up front and tops up
    until the cumulative sum passes ``duration_us`` — the window is
    covered by construction, never silently cut short."""
    n = int(lam * duration_us * 1.2) + 64
    arr = np.cumsum(rng.exponential(1.0 / lam, n))
    while arr[-1] < duration_us:          # top-up (vanishingly rare)
        more = rng.exponential(1.0 / lam, max(n // 4, 64))
        arr = np.concatenate([arr, arr[-1] + np.cumsum(more)])
    return arr[arr < duration_us * 1e0]


def _poisson_sched(rng: np.random.Generator, lam_row: np.ndarray,
                   sched_t: np.ndarray, duration_us: int) -> np.ndarray:
    """Arrival times of a piecewise-constant non-homogeneous Poisson
    process: rate ``lam_row[k]`` (flows/us) over segment ``k`` starting
    at ``sched_t[k]``.

    Implemented by thinning: draw a homogeneous process at ``max(lam)``
    (the exact legacy ``_poisson_window`` draws), then accept each
    arrival with probability ``lam(t) / max(lam)`` using ONE uniform
    draw per candidate. A *constant* row takes the homogeneous path with
    zero extra draws — that branch is what keeps constant-schedule
    output bit-for-bit identical to the legacy scalar-``load`` path.
    All-zero rows draw nothing."""
    lam_max = float(lam_row.max())
    if lam_max <= 0.0:
        return np.zeros(0, np.float64)
    if float(lam_row.min()) == lam_max:    # constant: legacy draws exactly
        return _poisson_window(rng, lam_max, duration_us)
    arr = _poisson_window(rng, lam_max, duration_us)
    seg = np.searchsorted(sched_t, arr, side="right") - 1
    keep = rng.random(len(arr)) * lam_max < lam_row[seg]
    return arr[keep]


def generate(table: PathTable, cdf: SizeCDF, load: float, duration_us: int,
             pair_ids=None, seed: int = 0, max_flows: int = 200_000,
             cap_scale: float = 1.0, bg_pair_ids=None,
             bg_load: float = 0.0, n_subflows: int = 1,
             sched_t=None, load_rows=None, bg_rows=None) -> FlowSet:
    """Poisson arrivals at per-pair utilization ``load`` over
    ``duration_us`` (plus optional ``bg_load`` cross-traffic on
    ``bg_pair_ids``).

    ``sched_t``/``load_rows``/``bg_rows`` (optional, built by
    ``traffic.sched.build``) promote the per-pair dose from a scalar to
    a **piecewise-constant load schedule**: ``sched_t`` is a shared
    (K,) grid of segment start times (``sched_t[0] == 0``, ascending)
    and ``load_rows[i, k]`` / ``bg_rows[j, k]`` the load *multiplier* of
    foreground pair ``pair_ids[i]`` / background pair ``bg_pair_ids[j]``
    over segment ``k`` — the effective utilization of pair ``i`` during
    segment ``k`` is ``load * load_rows[i, k]``. Arrivals follow a
    non-homogeneous Poisson process via thinning (``_poisson_sched``);
    a pair whose row is constant takes the exact legacy homogeneous
    draw path, so all-ones rows reproduce scalar-``load`` output
    **bit-for-bit**. Dose telemetry targets become the schedule's
    time-average byte-rate.

    ``cap_scale`` must match the simulator's capacity scale so the
    offered byte rate targets the *simulated* capacities. Raises
    ``ValueError`` when the requested load needs more than ``max_flows``
    flows — the pre-fix behavior silently cut the *end* of the arrival
    window instead, simulating less offered load than requested.
    """
    rng = np.random.default_rng(seed)
    if pair_ids is None:
        pair_ids = np.arange(len(table.pair_src))
    pair_ids = np.asarray(pair_ids, np.int32)
    bg_pair_ids = (np.zeros(0, np.int32) if bg_pair_ids is None or bg_load <= 0
                   else np.asarray(bg_pair_ids, np.int32))
    keep_bg = ~np.isin(bg_pair_ids, pair_ids)
    bg_pair_ids = bg_pair_ids[keep_bg]

    if sched_t is None:
        sched_t = np.zeros(1, np.int64)
        load_rows = np.ones((len(pair_ids), 1), np.float64)
        bg_rows = np.ones((len(bg_pair_ids), 1), np.float64)
    else:
        sched_t = np.asarray(sched_t, np.int64)
        if sched_t[0] != 0 or np.any(np.diff(sched_t) <= 0):
            raise ValueError("sched_t must start at 0 and be strictly "
                             "ascending")
        load_rows = np.asarray(load_rows, np.float64)
        if bg_rows is None or len(bg_pair_ids) == 0:
            bg_rows = np.ones((len(bg_pair_ids), len(sched_t)))
        else:            # rows align with the caller's UNfiltered bg list
            bg_rows = np.asarray(bg_rows, np.float64)[keep_bg]
        if load_rows.shape != (len(pair_ids), len(sched_t)) or \
                bg_rows.shape != (len(bg_pair_ids), len(sched_t)):
            raise ValueError(
                f"schedule rows must be (pairs, {len(sched_t)}): got "
                f"{load_rows.shape} fg / {bg_rows.shape} bg")
        if load_rows.min(initial=0.0) < 0 or bg_rows.min(initial=0.0) < 0:
            raise ValueError("schedule rows must be non-negative")
    # per-segment durations (last segment runs to the end of the window)
    seg_dur = np.diff(np.append(sched_t, duration_us)).astype(np.float64)

    mean_size = cdf.mean()
    doses = [(int(p), float(load) * load_rows[i], True)
             for i, p in enumerate(pair_ids)] + \
            [(int(p), float(bg_load) * bg_rows[j], False)
             for j, p in enumerate(bg_pair_ids)]
    # first-hop sharing is split WITHIN each dose group: the foreground
    # pairs divide capacity among themselves (all-to-all stays sane) but
    # keep their full class against the background set — cross-traffic is
    # the interference being measured, not a reason to dose the measured
    # pair less
    bases = np.concatenate([
        dose_bases(table, pair_ids),
        dose_bases(table, bg_pair_ids) if len(bg_pair_ids) else np.zeros(0)])
    # (K,) flows/us rate row per pair; lam_avg is its time average —
    # for a constant row this is the legacy scalar lam exactly
    lams = {p: row * base * 125.0 * cap_scale / mean_size
            for (p, row, _), base in zip(doses, bases)}
    lam_avg = {p: float((lams[p] * seg_dur).sum()) / duration_us
               for p, _, _ in doses}

    expect = (sum(int(lam_avg[p] * duration_us * 1.2) + 64
                  for p, _, _ in doses) * max(int(n_subflows), 1))
    if expect > max_flows:
        raise ValueError(
            f"offered load needs ~{expect} flows but max_flows={max_flows}: "
            f"the arrival window would be silently truncated (under-dosed). "
            f"Raise max_flows (>= {expect}) or chunk the run into shorter "
            f"duration_us segments.")

    row0 = doses[0][1] if doses else np.zeros(1)
    if len(doses) == 1 and doses[0][2] and \
            float(row0.min()) == float(row0.max()) and row0.max() > 0:
        # single foreground pair with a constant (or absent) schedule:
        # keep the exact legacy draw sequence (gaps -> sizes -> pair
        # assignment -> ids from one rng stream) so every pre-existing
        # single-pair experiment, tolerance band, and tuned acceptance
        # test stays bit-for-bit reproducible.
        pid = doses[0][0]
        # use the row's rate, NOT lam_avg: (lam * T) / T can differ from
        # lam by 1 ulp, which would desync the exponential draw stream
        arrivals = _poisson_window(rng, float(lams[pid].max()), duration_us)
        n = len(arrivals)
        sizes = cdf.sample(rng, n)
        pids = pair_ids[rng.integers(0, len(pair_ids), n)]
        fids = rng.integers(1, 1 << 32, n, dtype=np.uint32)
        fg = np.ones(n, bool)
        dose_real = np.array([sizes.sum() / duration_us])
    else:
        chunks = []
        for p, _, is_fg in doses:
            arr = _poisson_sched(rng, lams[p], sched_t, duration_us)
            chunks.append((p, is_fg, arr, cdf.sample(rng, len(arr))))
        # realized byte-rates straight off the per-pair chunks (no
        # per-flow remapping of the merged table needed)
        dose_real = np.array([s.sum() / duration_us
                              for _, _, _, s in chunks])
        arrivals = np.concatenate([a for _, _, a, _ in chunks])
        sizes = np.concatenate([s for _, _, _, s in chunks])
        pids = np.concatenate([np.full(len(a), p, np.int32)
                               for p, _, a, _ in chunks])
        fg = np.concatenate([np.full(len(a), is_fg)
                             for _, is_fg, a, _ in chunks])
        order = np.argsort(arrivals, kind="stable")
        arrivals, sizes, pids, fg = (arrivals[order], sizes[order],
                                     pids[order], fg[order])
        fids = rng.integers(1, 1 << 32, len(arrivals), dtype=np.uint32)

    dose_pair = np.array([p for p, _, _ in doses], np.int32)
    dose_target = np.array(    # schedule time-average byte-rate per pair
        [lam_avg[p] * mean_size for p, _, _ in doses], np.float64)

    # amp-style subflow expansion — after dose telemetry (byte rates are
    # a parent-level property, preserved exactly by the equal split) and
    # after every rng draw (the legacy draw sequence stays untouched)
    subflow_of = None
    if n_subflows > 1:
        (arrivals, sizes, pids, fids, fg,
         subflow_of) = _split_subflows(arrivals, sizes, pids, fids, fg,
                                       int(n_subflows))

    return FlowSet(arrival_us=arrivals.astype(np.int64),
                   size_bytes=sizes, pair_id=pids.astype(np.int32),
                   flow_id=fids, fg_mask=fg, subflow_of=subflow_of,
                   dose_pair=dose_pair, dose_target=dose_target,
                   dose_real=dose_real)
