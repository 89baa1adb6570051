"""Simulation core shared by the reference's two engines: ``SimConfig``,
``SimArrays``, ``SimState``, ``build`` (with the failure and degrade
schedules), the signal plane (``monitor_tick``), the control plane
(``ctrl_refresh``, ``ctrl_tick``), the policy-dispatched decision
(``decide``, every law and the ``sweep`` meta-policy) with its three
callers, ``redte_tick``, the four CC laws (``_cc_update``) and
``merge_cells``/``slice_cell``, which join a grid's cells into one
block-diagonal world and take each back.

Every phase is plain PyTorch (``ref``), on whatever device the tensors
live on. ``SimConfig.sum_dtype`` is the precision of the per-link sums
(offered load, the packet engine's per-link byte sums): ``float64``,
what the benchmark's configurations state, or ``float32``, the control
one step below it.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from . import baselines as bl
from . import select as selmod
from .cong import CongParams, CongState
from .pathq import (PathQParams, calc_path_quality,
                                    path_bottleneck_stats)
from .select import SelectParams
from .tables import bootstrap_tables
from . import ref
from .paths import PathTable
from .gen import FlowSet

HIST = 8192          # history rings (steps); must exceed the max RTT and
                     # signal-delay offsets — build() validates this

# Policy name -> dense code, frozen as in the reference.
POLICY_CODES = {
    "lcmp": 0, "lcmp_w": 1, "ecmp": 2, "ucmp": 3, "wcmp": 4, "redte": 5,
    "fatpaths": 6, "amp": 7, "lcmp_r": 8, "matchrdma": 9,
}
POLICIES = tuple(POLICY_CODES)
# policies whose law re-decides mid-flow on the re-decision epoch
REDECIDE_POLICIES = ("fatpaths", "lcmp_r")
ENGINES = ("fluid", "packet")
CC_LAWS = ("dcqcn", "dctcp", "timely", "hpcc")
_NEVER = (1 << 30)   # sentinel step for "this link never fails/degrades"


def policy_code(policy: str) -> int:
    if policy not in POLICY_CODES:
        raise ValueError(f"unknown policy {policy!r}; valid: {POLICIES}")
    return POLICY_CODES[policy]


def get_engine(name: str):
    """The engine module (``fluid`` or ``packet``) of a
    ``SimConfig.engine`` string."""
    if name == "fluid":
        from . import fluid
        return fluid
    if name == "packet":
        from . import packet
        return packet
    raise ValueError(f"unknown engine {name!r}; valid: {ENGINES}")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The reference's ``SimConfig`` fields that the two engines read,
    with the same defaults."""
    engine: str = "fluid"
    policy: str = "lcmp"
    cc: str = "dcqcn"
    dt_us: int = 200
    horizon_us: int = 2_000_000
    cap_scale: float = 0.125
    buffer_bytes: float = 6e9
    ecn_kmin_bytes: float = 4e5
    ecn_kmax_factor: float = 10.0
    ai_frac: float = 0.002
    md_factor: float = 0.7
    cc_dec_period_us: int = 1_600
    redte_period_us: int = 100_000
    sig_delay_scale: float = 1.0
    ctrl_period_us: int = 100_000
    # packet engine only: packet size, and the PFC XOFF/XON thresholds as
    # fractions of the scaled buffer
    mtu_bytes: int = 1024
    pfc_xoff_frac: float = 0.7
    pfc_xon_frac: float = 0.5
    select: SelectParams = SelectParams()
    pathq: PathQParams = PathQParams()
    congp: CongParams = CongParams()
    # the legacy single-link trip, folded into the schedule at build()
    fail_link: int = -1
    fail_at_us: int = -1
    # ((link_idx, at_us), ...) hard trips; ((link_idx, at_us, factor), ...)
    # silent capacity loss
    fail_sched: tuple = ()
    degrade_sched: tuple = ()
    # policy == "sweep" only: the laws the per-pair dispatch covers
    # (netsim.sweep narrows it to the policies present in a group)
    sweep_policies: tuple = POLICIES
    flowlet_gap_us: int = 0
    redecide_period_us: int = 0
    n_subflows: int = 1
    # precision of the per-link sums: float64 as stated, float32 for the
    # control
    sum_dtype: str = "float64"

    @property
    def num_steps(self) -> int:
        return self.horizon_us // self.dt_us

    @property
    def has_failures(self) -> bool:
        return self.fail_link >= 0 or len(self.fail_sched) > 0

    @property
    def policies(self) -> tuple:
        """The laws a run can apply: ``sweep_policies`` under the sweep,
        else the one policy."""
        return self.sweep_policies if self.policy == "sweep" else (self.policy,)

    @property
    def has_degrade(self) -> bool:
        return len(self.degrade_sched) > 0


def check_slice(cfg: SimConfig) -> None:
    """Raise ``ValueError`` for an unknown engine, policy (a swept one
    included) or CC law."""
    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}; valid: {ENGINES}")
    for p in cfg.policies:
        policy_code(p)
    if cfg.policy == "sweep" and not cfg.sweep_policies:
        raise ValueError("the sweep meta-policy needs sweep_policies")
    if cfg.cc not in CC_LAWS:
        raise ValueError(f"unknown congestion control {cfg.cc!r}; valid: "
                         f"{CC_LAWS}")


@dataclasses.dataclass
class SimState:
    """Field names equal the reference's ``SimState``."""
    # per flow
    flow_path: torch.Tensor    # (F,) i32, -1 until routed
    remaining: torch.Tensor    # (F,) f32 bytes
    rate: torch.Tensor         # (F,) f32 bytes/us
    active: torch.Tensor       # (F,) bool
    done: torch.Tensor         # (F,) bool
    fct_us: torch.Tensor       # (F,) f32
    extra_wait: torch.Tensor   # (F,) f32 queue-wait component
    rtt_steps: torch.Tensor    # (F,) i32
    route_step: torch.Tensor   # (F,) i32 step the flow was routed at
    route_nonce: torch.Tensor  # (F,) i32 re-decision counter
    last_dec: torch.Tensor     # (F,) i32 step of last MD
    cc_alpha: torch.Tensor     # (F,) f32 (DCTCP EWMA)
    cc_target: torch.Tensor    # (F,) f32 (DCQCN target rate)
    prev_delay: torch.Tensor   # (F,) f32 (TIMELY gradient)
    # per link
    q_bytes: torch.Tensor      # (L,) f32
    hist_q: torch.Tensor       # (L, HIST) f32 queue bytes
    hist_u: torch.Tensor       # (L, HIST) f32 utilization
    hist_c: torch.Tensor       # (L, HIST) i32 quantized C_cong per step
    u_ewma: torch.Tensor       # (L,) f32
    link_alive: torch.Tensor   # (L,) bool
    serv_bytes: torch.Tensor   # (L,) f32 served-byte counter (metrics)
    cong: CongState            # LCMP per-link registers
    c_cong: torch.Tensor       # (L,) i32 current LCMP congestion score
    c_path: torch.Tensor       # (NP,) i32 installed path scores
    redte_w: torch.Tensor      # (NPAIR, K) i32 split weights


@dataclasses.dataclass(frozen=True)
class SimArrays:
    """Static (non-scanned) device tensors; fields as in the reference."""
    link_cap: torch.Tensor      # (L,) f32 bytes/us (scaled)
    link_cap_gbps: torch.Tensor # (L,) i32 (unscaled, for tables)
    path_links: torch.Tensor    # (NP, H) i32
    path_prop: torch.Tensor     # (NP,) i32 us
    path_cap: torch.Tensor      # (NP,) f32 bytes/us (scaled bottleneck)
    path_cap_gbps: torch.Tensor # (NP,) i32
    path_first: torch.Tensor    # (NP,) i32
    pair_cand: torch.Tensor     # (NPAIR, K) i32
    arrivals: torch.Tensor      # (T, A) i32 flow idx, -1 pad
    f_arr_us: torch.Tensor      # (F,) f32
    f_size: torch.Tensor        # (F,) f32
    f_pair: torch.Tensor        # (F,) i32
    f_id: torch.Tensor          # (F,) i64 holding uint32 hash keys
    policy_code: torch.Tensor = None      # () i32
    link_fail_step: torch.Tensor = None   # (L,) i32 trip step (_NEVER)
    link_deg_step: torch.Tensor = None    # (L,) i32 degradation onset step
    link_deg_factor: torch.Tensor = None  # (L,) f32 cap multiplier
    path_len: torch.Tensor = None         # (NP,) i32 valid hop count
    link_delay_us: torch.Tensor = None    # (L,) i32 one-way propagation
    path_sig_delay: torch.Tensor = None   # (NP, H) i32 signal delay, steps
    tables: object = None                 # SwitchTables
    # (NPAIR,) i32 law code of each pair's cell: read only under
    # policy == "sweep", set by merge_cells (None elsewhere)
    pair_policy: torch.Tensor = None


def _t(x, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype))).to(dev)


def build(table: PathTable, flows: FlowSet, cfg: SimConfig,
          device="cpu"):
    """Pack numpy tables + flows into tensors on ``device`` and the
    initial state, exactly as the reference's ``build``."""
    check_slice(cfg)
    dev = torch.device(device)
    link_cap_gbps = _infer_link_caps(table)
    L = len(link_cap_gbps)
    link_cap = _t(link_cap_gbps * 125.0 * cfg.cap_scale, np.float32, dev)

    # the world is capacity-scaled, so the switch tables and buffers scale
    # identically (timescales are invariant under cap_scale)
    tb = bootstrap_tables([max(int(c * cfg.cap_scale), 1) for c in link_cap_gbps],
                          buffer_bytes=max(int(cfg.buffer_bytes * cfg.cap_scale),
                                           1 << 20),
                          sample_interval_us=cfg.dt_us, device=dev)
    c_path = calc_path_quality(_t(table.path_prop_us, np.int32, dev),
                               _t(table.path_cap, np.int32, dev),
                               tb.cap_thresh, cfg.pathq)

    # per-path per-hop signal-propagation offsets (hop h's score travels
    # back over hops 0..h-1, x sig_delay_scale)
    link_delay_us = _infer_link_delays(table)
    pl = np.asarray(table.path_links)
    hop_delay = np.where(pl >= 0, link_delay_us[np.maximum(pl, 0)], 0)
    upstream = np.concatenate([np.zeros((pl.shape[0], 1), np.int64),
                               np.cumsum(hop_delay, -1)[:, :-1]], axis=1)
    sig_delay_f = cfg.sig_delay_scale * upstream / cfg.dt_us
    sig_delay = sig_delay_f.astype(np.int32)

    # the history rings alias once a read offset wraps: guard both readers
    # (on the pre-cast floats)
    max_rtt = int(np.max(2 * np.asarray(table.path_prop_us) // cfg.dt_us,
                         initial=1))
    max_sig = int(sig_delay_f.max(initial=0))
    if max(max_rtt, max_sig) >= HIST:
        raise ValueError(
            f"history ring too short: HIST={HIST} steps but the worst path "
            f"needs rtt={max_rtt} and signal-delay={max_sig} steps at "
            f"dt_us={cfg.dt_us} (sig_delay_scale={cfg.sig_delay_scale}); "
            "increase dt_us or reduce sig_delay_scale")

    # arrivals bucketed by step; a stable argsort keeps flows within a
    # step in ascending-index order
    T = cfg.num_steps
    step = np.minimum(flows.arrival_us // cfg.dt_us, T - 1).astype(np.int64)
    counts = np.bincount(step, minlength=T)
    A = max(int(counts.max()), 1)
    arrivals = np.full((T, A), -1, np.int32)
    order = np.argsort(step, kind="stable")
    srt = step[order]
    slot = np.arange(len(srt)) - np.searchsorted(srt, srt, side="left")
    arrivals[srt, slot] = order

    # failure / degradation schedules -> per-link step arrays (the legacy
    # single-link trip folds into the same representation)
    fail_step = np.full(L, _NEVER, np.int32)
    if cfg.fail_link >= 0:
        fail_step[cfg.fail_link] = cfg.fail_at_us // cfg.dt_us
    for li, at_us in cfg.fail_sched:
        fail_step[li] = min(int(fail_step[li]), int(at_us) // cfg.dt_us)
    deg_step = np.full(L, _NEVER, np.int32)
    deg_factor = np.ones(L, np.float32)
    for li, at_us, fac in cfg.degrade_sched:
        deg_step[li] = int(at_us) // cfg.dt_us
        deg_factor[li] = float(fac)

    NPAIR, K = table.pair_cand.shape
    arr = SimArrays(
        link_cap=link_cap,
        link_cap_gbps=_t(link_cap_gbps, np.int32, dev),
        path_links=_t(table.path_links, np.int32, dev),
        path_prop=_t(table.path_prop_us, np.int32, dev),
        path_cap=_t(table.path_cap * 125.0 * cfg.cap_scale, np.float32, dev),
        path_cap_gbps=_t(table.path_cap, np.int32, dev),
        path_first=_t(table.path_first, np.int32, dev),
        pair_cand=_t(table.pair_cand, np.int32, dev),
        arrivals=_t(arrivals, np.int32, dev),
        f_arr_us=_t(flows.arrival_us, np.float32, dev),
        f_size=_t(flows.size_bytes, np.float32, dev),
        f_pair=_t(flows.pair_id, np.int32, dev),
        f_id=_t(np.asarray(flows.flow_id, np.uint32), np.int64, dev),
        policy_code=torch.tensor(policy_code(cfg.policy)
                                 if cfg.policy != "sweep" else 0,
                                 dtype=torch.int32, device=dev),
        link_fail_step=_t(fail_step, np.int32, dev),
        link_deg_step=_t(deg_step, np.int32, dev),
        link_deg_factor=_t(deg_factor, np.float32, dev),
        path_len=_t(table.path_len, np.int32, dev),
        link_delay_us=_t(link_delay_us, np.int32, dev),
        path_sig_delay=_t(sig_delay, np.int32, dev),
        tables=tb,
        # one cell built under the sweep takes law 0, as the reference's
        # policy_code 0; merge_cells gives a group its cells' codes
        pair_policy=(torch.zeros((NPAIR,), dtype=torch.int32, device=dev)
                     if cfg.policy == "sweep" else None),
    )
    F = flows.num_flows

    def full(n, v, dtype):
        return torch.full((n,), v, dtype=dtype, device=dev)

    state = SimState(
        flow_path=full(F, -1, torch.int32),
        remaining=full(F, 0.0, torch.float32),
        rate=full(F, 0.0, torch.float32),
        active=full(F, False, torch.bool),
        done=full(F, False, torch.bool),
        fct_us=full(F, 0.0, torch.float32),
        extra_wait=full(F, 0.0, torch.float32),
        rtt_steps=full(F, 1, torch.int32),
        route_step=full(F, 1 << 20, torch.int32),   # sentinel: unrouted
        route_nonce=full(F, 0, torch.int32),
        last_dec=full(F, -(1 << 20), torch.int32),
        cc_alpha=full(F, 0.0, torch.float32),
        cc_target=full(F, 0.0, torch.float32),
        prev_delay=full(F, 0.0, torch.float32),
        q_bytes=full(L, 0.0, torch.float32),
        hist_q=torch.zeros((L, HIST), dtype=torch.float32, device=dev),
        hist_u=torch.zeros((L, HIST), dtype=torch.float32, device=dev),
        hist_c=torch.zeros((L, HIST), dtype=torch.int32, device=dev),
        u_ewma=full(L, 0.0, torch.float32),
        link_alive=full(L, True, torch.bool),
        serv_bytes=full(L, 0.0, torch.float32),
        cong=CongState.init(L, device=dev),
        c_cong=full(L, 0, torch.int32),
        c_path=c_path,
        redte_w=torch.ones((NPAIR, K), dtype=torch.int32, device=dev),
    )
    return arr, state


def _infer_link_caps(table: PathTable) -> np.ndarray:
    if hasattr(table, "_link_caps"):
        return table._link_caps  # set by attach_link_caps
    raise ValueError("call attach_link_caps(table, topo) before build()")


def _infer_link_delays(table: PathTable) -> np.ndarray:
    if hasattr(table, "_link_delays"):
        return table._link_delays  # set by attach_link_caps
    raise ValueError("call attach_link_caps(table, topo) before build()")


def attach_link_caps(table: PathTable, topo) -> PathTable:
    _, _, cap, dly = topo.arrays()
    object.__setattr__(table, "_link_caps", cap.astype(np.float32))
    object.__setattr__(table, "_link_delays", dly.astype(np.int64))
    return table


# ---------------------------------------------------------- shared step parts
def monitor_tick(t: int, st: SimState, ar: SimArrays, cfg: SimConfig):
    """Switch monitor pass: the ``core.cong`` register pipeline on the
    current queue depths, its score landed in ``hist_c`` slot ``t``."""
    cong, c_cong = ref.monitor_tick_ref(st.cong, st.q_bytes, t * cfg.dt_us,
                                        ar.tables, cfg.congp, st.hist_c,
                                        t % HIST)
    return dataclasses.replace(st, cong=cong, c_cong=c_cong)


def ctrl_refresh(t: int, st: SimState, ar: SimArrays,
                 cfg: SimConfig) -> torch.Tensor:
    """One control-plane tick: the ``C_path`` table recomputed from the
    *effective* per-link capacities (the degrade schedule and liveness
    applied) through ``core.pathq``. Returns a new (NP,) int32 table."""
    eff = ar.link_cap_gbps * torch.where(t >= ar.link_deg_step,
                                         ar.link_deg_factor, 1.0)
    eff = torch.where(st.link_alive, eff, 0.0).to(torch.int32)
    _, cap_eff = path_bottleneck_stats(ar.link_delay_us, eff, ar.path_links,
                                       ar.path_len)
    return calc_path_quality(ar.path_prop, cap_eff, ar.tables.cap_thresh,
                             cfg.pathq)


def ctrl_tick(t: int, st: SimState, ar: SimArrays, cfg: SimConfig):
    """The periodic ``C_path`` re-install: ``ctrl_refresh`` at every step
    ``t`` with ``t % period == 0`` (t = 0 included), written into
    ``st.c_path`` in place. Skipped, as in the reference, when the period
    is 0 (the build-time table) or no schedule can change the effective
    capacities."""
    if cfg.ctrl_period_us > 0 and (cfg.has_failures or cfg.has_degrade):
        if t % max(cfg.ctrl_period_us // cfg.dt_us, 1) == 0:
            st.c_path.copy_(ctrl_refresh(t, st, ar, cfg))
    return st


def redte_tick(t: int, st: SimState, ar: SimArrays, cfg: SimConfig):
    """RedTE's periodic split-ratio re-optimization (``redte`` only):
    every ``redte_period_us`` each pair's weights become the headroom
    ``max(256 - util_q8, 1)`` of each candidate's first link, written
    into ``st.redte_w`` in place. Under the sweep every pair's weights
    are kept when ``redte`` is swept; only redte cells read them."""
    if "redte" in cfg.policies:
        if t % max(cfg.redte_period_us // cfg.dt_us, 1) == 0:
            util_q8 = torch.clamp(st.u_ewma * 256, 0, 255).to(torch.int32)
            first = ar.path_first[torch.clamp_min(ar.pair_cand, 0)]
            head = bl.redte_weights(util_q8[first])
            st.redte_w.copy_(torch.where(ar.pair_cand >= 0, head, 0))
    return st


def decide(t: int, fid, pair, st: SimState, ar: SimArrays, cfg: SimConfig,
           sig_step=None):
    """The policy-dispatched path decision for N ``(fid, pair)``: hash
    keys (N,) int64 and pairs (N,) int32. ``sig_step`` (default ``t``)
    is the step whose ``hist_c`` slot the congestion view reads. Returns
    ``(k_idx, chosen)``, both (N,) int32, -1 where no candidate is valid.
    Under ``policy="sweep"`` each decision takes the law of its pair's
    cell (``ar.pair_policy``)."""
    return ref.decide_ref(t, fid, pair, st, ar, cfg.policy, cfg.select,
                          t if sig_step is None else sig_step,
                          cfg.sweep_policies)


def _route_arrivals(t: int, st: SimState, ar: SimArrays, cfg: SimConfig):
    """Decide paths for the batch of flows arriving this step."""
    return ref.route_arrivals_ref(t, st, ar, cfg.policy, cfg.select,
                                  cfg.dt_us, cfg.sweep_policies)


def path_queue_wait(q_bytes: torch.Tensor, link_cap: torch.Tensor,
                    hop: torch.Tensor) -> torch.Tensor:
    """Standing-queue wait of paths with hops ``hop`` (N, H): the sum
    over hops of queue bytes / link capacity, added hop by hop in hop
    order (as the route kernel adds) with tensor-by-tensor IEEE
    divisions, so the two agree bit for bit."""
    h = torch.clamp_min(hop, 0)
    term = torch.where(hop >= 0, q_bytes[h] / link_cap[h], 0.0)
    qw = term[:, 0]
    for j in range(1, term.shape[1]):
        qw = qw + term[:, j]
    return qw


def _path_queue_wait(st: SimState, ar: SimArrays, path_idx) -> torch.Tensor:
    """Standing-queue wait a path's first packets see (``path_idx``
    clamped >= 0)."""
    return path_queue_wait(st.q_bytes, ar.link_cap, ar.path_links[path_idx])


def _rtt(ar: SimArrays, path_idx, dt_us: int) -> torch.Tensor:
    return torch.clamp_min(torch.div(2 * ar.path_prop[path_idx], dt_us,
                                     rounding_mode="floor"), 1).to(torch.int32)


def _decider(ar: SimArrays, cfg: SimConfig, decide_fn):
    """``decide_fn``, or the engine's ``decide`` with its signature
    ``(t, fid, pair, st, sig_step)``."""
    return decide_fn or (lambda t, fid, pair, st, sig_step:
                         decide(t, fid, pair, st, ar, cfg, sig_step))


def _reroute_dead(t: int, st: SimState, ar: SimArrays, cfg: SimConfig,
                  decide_fn=None) -> SimState:
    """Lazy failover at a trip step: every active flow whose pinned path
    crosses a dead link re-decides under its policy's own law (one
    ``decide`` over all flows, reading the congestion view at ``t - 1``,
    since this step's monitor tick has not run). A moved flow starts
    afresh on its new path (line rate, MD timer and CC memory reset, the
    new path's queue wait and RTT); one with no live candidate becomes
    inactive. ``decide_fn(t, fid, pair, st, sig_step)`` decides,
    ``decide`` by default."""
    decide_fn = _decider(ar, cfg, decide_fn)
    hop = ar.path_links[torch.clamp_min(st.flow_path, 0)]
    dead = torch.where(hop >= 0, ~st.link_alive[torch.clamp_min(hop, 0)],
                       False).any(-1)
    move = st.active & dead & (st.flow_path >= 0)

    k_idx, new_path = decide_fn(t, ar.f_id, ar.f_pair, st, t - 1)
    ok = move & (k_idx >= 0)
    npad = torch.clamp_min(new_path, 0)
    line = ar.path_cap[npad]
    return dataclasses.replace(
        st,
        flow_path=torch.where(ok, new_path, st.flow_path),
        rate=torch.where(ok, line, st.rate),
        cc_target=torch.where(ok, line, st.cc_target),
        last_dec=torch.where(ok, -(1 << 20), st.last_dec),
        cc_alpha=torch.where(ok, 0.0, st.cc_alpha),
        prev_delay=torch.where(ok, 0.0, st.prev_delay),
        extra_wait=torch.where(ok, _path_queue_wait(st, ar, npad),
                               st.extra_wait),
        rtt_steps=torch.where(ok, _rtt(ar, npad, cfg.dt_us), st.rtt_steps),
        route_step=torch.where(ok, t, st.route_step),
        active=torch.where(move & (k_idx < 0), False, st.active))


def wants_redecide(cfg: SimConfig) -> bool:
    """Whether the engine's re-decision plane is armed: a positive knob
    of the run's engine (``flowlet_gap_us`` for the packet engine,
    ``redecide_period_us`` for the fluid one; each ignores the other's)
    and a policy that re-decides (under the sweep, any swept one)."""
    knob = (cfg.flowlet_gap_us if cfg.engine == "packet"
            else cfg.redecide_period_us)
    return knob > 0 and any(p in REDECIDE_POLICIES for p in cfg.policies)


def redecide_tick(t: int, st: SimState, ar: SimArrays, cfg: SimConfig,
                  eligible, decide_fn=None) -> SimState:
    """Mid-flow re-decision of the eligible active flows routed before
    ``t``: each opportunity bumps the flow's nonce and the decision
    hashes ``f_id ^ fmix32(nonce)``. A path change keeps the flow's CC
    rate state; only the route bookkeeping (path, RTT, route step, queue
    wait) follows the new path. Under the sweep only the flows of
    re-deciding cells may move; the others stay pinned, nonce 0."""
    redecide = [p for p in cfg.policies if p in REDECIDE_POLICIES]
    if not redecide:
        return st
    decide_fn = _decider(ar, cfg, decide_fn)
    move = st.active & (st.flow_path >= 0) & eligible & (t > st.route_step)
    if cfg.policy == "sweep":
        law = ar.pair_policy[ar.f_pair]
        cell_ok = torch.zeros_like(move)
        for p in redecide:
            cell_ok |= law == policy_code(p)
        move = move & cell_ok
    nonce = st.route_nonce + move.to(torch.int32)
    fid = ar.f_id ^ selmod.fmix32(nonce)
    k_idx, new_path = decide_fn(t, fid, ar.f_pair, st, t)
    changed = move & (k_idx >= 0) & (new_path != st.flow_path)
    npad = torch.clamp_min(new_path, 0)
    return dataclasses.replace(
        st,
        route_nonce=nonce,
        flow_path=torch.where(changed, new_path, st.flow_path),
        rtt_steps=torch.where(changed, _rtt(ar, npad, cfg.dt_us),
                              st.rtt_steps),
        route_step=torch.where(changed, t, st.route_step),
        extra_wait=torch.where(changed, _path_queue_wait(st, ar, npad),
                               st.extra_wait))


def step_phases(ar: SimArrays, cfg: SimConfig):
    """``(tick, route, decide)`` of a run's step: the plain monitor tick
    and arrival routing, and None for the plain ``decide``."""
    def tick(t, st):
        return monitor_tick(t, st, ar, cfg)

    def route(t, st):
        return _route_arrivals(t, st, ar, cfg)
    return tick, route, None


def trip_steps(ar: SimArrays, cfg: SimConfig):
    """``(trips, down)``: the steps at which a link trips, known when the
    run starts (one host read of the schedule here, none in the step),
    and the steps at which ``link_alive`` changes: the trips and, where a
    trip falls before step 0, step 0, which takes its link down with no
    flow to reroute."""
    if not cfg.has_failures:
        return set(), set()
    fail = ar.link_fail_step.cpu().numpy()
    trips = {int(s) for s in np.unique(fail[(fail >= 0)
                                            & (fail < cfg.num_steps)])}
    return trips, trips | ({0} if (fail < 0).any() else set())


def _cc_update(t: int, st: SimState, ar: SimArrays, cfg: SimConfig,
               path_of_flow, links_f, links_ok):
    """The CC rate laws (dcqcn, dctcp, timely, hpcc), reacting to
    RTT-delayed per-path signals from the ``hist_q``/``hist_u`` rings:
    RED-style marking between Kmin and Kmax, MD on a reaction timer, fast
    recovery and probing towards a target. ``cc_alpha`` and
    ``prev_delay`` are written for every flow, the rate state for the
    active ones, as in the reference."""
    if cfg.cc not in CC_LAWS:
        raise ValueError(cfg.cc)
    if st.hist_q.numel() >= 1 << 31:
        raise ValueError(f"{st.hist_q.shape[0]} links x HIST={HIST} overflow "
                         "the rings' int32 flat index")
    slot = (t - st.rtt_steps) % HIST
    # feedback only once the flow's first packets had a full RTT on its
    # current path
    have_fb = (t - st.route_step) > st.rtt_steps
    lidx = torch.clamp_min(links_f, 0)                          # (F,H)
    flat = lidx * HIST + slot[:, None]
    q_hop = torch.where(links_ok, st.hist_q.reshape(-1)[flat], 0.0)
    q_sig = torch.where(have_fb, q_hop.amax(-1), 0.0)

    line = ar.path_cap[torch.clamp_min(path_of_flow, 0)]
    inv_rtt = 1.0 / st.rtt_steps.to(torch.float32)
    ai = cfg.ai_frac * line * inv_rtt
    dec_gap = torch.minimum(
        st.rtt_steps,
        torch.clamp_min(torch.div(st.rtt_steps, 8, rounding_mode="floor"),
                        max(cfg.cc_dec_period_us // cfg.dt_us, 1)))
    can_dec = (t - st.last_dec) >= dec_gap

    kmin = cfg.ecn_kmin_bytes * cfg.cap_scale
    kmax = cfg.ecn_kmax_factor * kmin
    p_mark = torch.clamp((q_sig - kmin) / (kmax - kmin), 0.0, 1.0)
    u01 = (selmod.fmix32(ar.f_id ^ t).to(torch.float32)
           * (1.0 / 4294967296.0))
    marked = u01 < p_mark

    target = torch.maximum(st.cc_target, 0.05 * line)

    def aimd(dec_event, md_rate):
        """The shared DCQCN-shaped decrease, fast recovery (halfway to
        target per RTT) and probe (+ai_frac of line per RTT)."""
        dec = dec_event & can_dec
        new_target = torch.where(dec, st.rate, target)
        recover = st.rate + (new_target - st.rate) * 0.5 * inv_rtt
        probe = torch.where(st.rate >= 0.95 * new_target, ai, 0.0)
        rate = torch.where(dec, st.rate * md_rate, recover + probe)
        new_target = torch.where(dec, new_target, new_target + probe)
        return rate, new_target, dec

    # scalar / tensor is written tensor / tensor: PyTorch turns ``c / t``
    # into ``c * (1 / t)``, which can round differently
    alpha, pdel = st.cc_alpha, st.prev_delay
    if cfg.cc == "dcqcn":
        rate, new_target, dec = aimd(marked, cfg.md_factor)
    elif cfg.cc == "dctcp":
        alpha = st.cc_alpha * (1 - 1 / 16) + marked.to(torch.float32) / 16
        rate, new_target, dec = aimd(marked, 1.0 - alpha / 2)
    elif cfg.cc == "timely":
        d_hop = torch.where(links_ok, st.hist_q.reshape(-1)[flat]
                            / ar.link_cap[lidx], 0.0)
        d_us = torch.where(have_fb, d_hop.amax(-1), 0.0)
        grad = d_us - st.prev_delay
        t_high = torch.full_like(line, 2.0 * kmin) / line
        rate, new_target, dec = aimd(((d_us > t_high) | (grad > 0))
                                     & (d_us > 0), cfg.md_factor)
        pdel = d_us
    else:                                   # hpcc
        eta = 0.95
        u_hop = torch.where(links_ok, st.hist_u.reshape(-1)[flat], 0.0)
        u_sig = torch.where(have_fb, u_hop.amax(-1), 0.0)
        bdp = line * torch.clamp_min(st.rtt_steps.to(torch.float32)
                                     * cfg.dt_us, 1.0)
        u_tot = u_sig + q_sig / torch.clamp_min(bdp, 1.0)   # inflight-based U
        corr = torch.clamp(torch.full_like(u_tot, eta)
                           / torch.clamp_min(u_tot, 1e-3), 0.3, 1.0)
        rate, new_target, dec = aimd(u_tot > eta, 1.0)      # md via corr
        rate = torch.where(dec, st.rate * corr, rate)

    rate = torch.clamp(rate, 0.001 * line, line)
    new_target = torch.clamp(new_target, 0.001 * line, line)
    last_dec = torch.where(dec, t, st.last_dec)
    act = st.active
    return dataclasses.replace(
        st, rate=torch.where(act, rate, st.rate),
        cc_target=torch.where(act, new_target, st.cc_target),
        cc_alpha=alpha, prev_delay=pdel,
        last_dec=torch.where(act, last_dec, st.last_dec))


# ------------------------------------------------------ merged sweep worlds
# SimArrays fields by what their leading axis runs over, and the index
# fields by what they index (merge_cells offsets those)
_LINK_ARRAYS = ("link_cap", "link_cap_gbps", "link_fail_step", "link_deg_step",
                "link_deg_factor", "link_delay_us")
_PATH_ARRAYS = ("path_prop", "path_cap", "path_cap_gbps", "path_len",
                "path_sig_delay")
_FLOW_ARRAYS = ("f_arr_us", "f_size", "f_id")
_INDEX_ARRAYS = {"path_links": "link0", "path_first": "link0",
                 "pair_cand": "path0", "f_pair": "pair0"}
# SimState fields (a PacketState's too) with a leading flow axis, in the
# reference's order; c_path runs over paths, redte_w over pairs, every
# other field (and CongState, the packet engine's pfc_pause and
# hist_pause) over links. Merged cells are concatenated, not padded, so
# the reference's per-field pad values (STATE_PAD) have no use here.
FLOW_FIELDS = ("flow_path", "remaining", "rate", "active", "done", "fct_us",
               "extra_wait", "rtt_steps", "route_step", "route_nonce",
               "last_dec", "cc_alpha", "cc_target", "prev_delay",
               # packet engine (see packet.PacketState)
               "fq", "credit", "delivered", "last_tx")


@dataclasses.dataclass(frozen=True)
class CellSlice:
    """Where one cell sits in a merged world: its first link, path, pair
    and flow, and how many of each it has."""
    link0: int
    L: int
    path0: int
    NP: int
    pair0: int
    NPAIR: int
    flow0: int
    F: int

    def rows(self, axis: str) -> slice:
        first, n = {"links": (self.link0, self.L), "paths": (self.path0, self.NP),
                    "pairs": (self.pair0, self.NPAIR),
                    "flows": (self.flow0, self.F)}[axis]
        return slice(first, first + n)


def _shift(x: torch.Tensor, off: int) -> torch.Tensor:
    """Index table ``x`` moved by ``off``; -1 pads stay -1."""
    return torch.where(x >= 0, x + off, x) if off else x


def _state_axis(name: str) -> str:
    return ("flows" if name in FLOW_FIELDS
            else {"c_path": "paths", "redte_w": "pairs"}.get(name, "links"))


def merge_cells(built):
    """One block-diagonal world from a sweep group's C built cells
    ``[(SimArrays, SimState), ...]`` (one table and configuration, each
    cell built with its own policy and traffic): cell c's links, paths,
    pairs and flows follow the earlier cells' (offset c·L, c·NP, c·NPAIR
    and the earlier cells' flow count), the index tables are moved by
    those offsets, a step's arrival row is the cells' rows side by side
    and ``pair_policy`` holds each pair's cell's law code. The cells
    share no link, so every link sum, queue and decision of a cell is
    what the cell computes alone. Returns ``(SimArrays, state,
    [CellSlice, ...])``, the state of the cells' class (a
    ``PacketState`` stays one)."""
    ar0 = built[0][0]
    L, NP, NPAIR = (ar0.link_cap.shape[0], ar0.path_links.shape[0],
                    ar0.pair_cand.shape[0])
    slices, flow0 = [], 0
    for c, (ar, _) in enumerate(built):
        if (ar.link_cap.shape[0], ar.path_links.shape[0],
                ar.pair_cand.shape[0]) != (L, NP, NPAIR):
            raise ValueError("merge_cells: the cells must share one world")
        F = ar.f_pair.shape[0]
        slices.append(CellSlice(c * L, L, c * NP, NP, c * NPAIR, NPAIR,
                                flow0, F))
        flow0 += F

    arrs = [a for a, _ in built]
    states = [s for _, s in built]

    def cat(get, items) -> torch.Tensor:
        return torch.cat([get(x, sl) for x, sl in zip(items, slices)])

    fields = {n: cat(lambda a, sl, n=n: getattr(a, n), arrs)
              for n in _LINK_ARRAYS + _PATH_ARRAYS + _FLOW_ARRAYS}
    fields.update({n: cat(lambda a, sl, n=n, o=o: _shift(getattr(a, n),
                                                         getattr(sl, o)), arrs)
                   for n, o in _INDEX_ARRAYS.items()})
    fields["arrivals"] = torch.cat([_shift(a.arrivals, sl.flow0)
                                    for a, sl in zip(arrs, slices)], dim=1)
    fields["pair_policy"] = cat(lambda a, sl: torch.full(
        (NPAIR,), int(a.policy_code), dtype=torch.int32,
        device=a.pair_cand.device), arrs)
    fields["tables"] = dataclasses.replace(ar0.tables, trend_thresh=cat(
        lambda a, sl: a.tables.trend_thresh, arrs))
    arr = dataclasses.replace(ar0, policy_code=torch.zeros_like(ar0.policy_code),
                              **fields)

    cong = CongState(**{f.name: cat(lambda s, sl, n=f.name: getattr(s.cong, n),
                                    states)
                        for f in dataclasses.fields(CongState)})
    cls = type(states[0])
    state = cls(cong=cong, **{
        f.name: cat(lambda s, sl, n=f.name: _shift(getattr(s, n), sl.path0)
                    if n == "flow_path" else getattr(s, n), states)
        for f in dataclasses.fields(cls) if f.name != "cong"})
    return arr, state, slices


def slice_cell(st: SimState, sl: CellSlice) -> SimState:
    """Cell ``sl``'s own state out of a merged world's state, of the
    same class (views; its ``flow_path`` moved back to the cell's path
    indices)."""
    cong = CongState(**{f.name: getattr(st.cong, f.name)[sl.rows("links")]
                        for f in dataclasses.fields(CongState)})
    out = {}
    for f in dataclasses.fields(st):
        if f.name != "cong":
            v = getattr(st, f.name)[sl.rows(_state_axis(f.name))]
            out[f.name] = _shift(v, -sl.path0) if f.name == "flow_path" else v
    return type(st)(cong=cong, **out)
