"""Simulation core shared by the engines (counterpart of
``repro/netsim/engine.py``), in PyTorch.

This slice ports what the fluid engine's main path runs: ``SimConfig``,
``SimArrays``, ``SimState``, ``build``, ``attach_link_caps``, the signal
plane (``monitor_tick``, ``path_cong_view``), ``ctrl_tick`` (a no-op
without schedules), routing at arrival (``decide`` for ``lcmp`` and
``ecmp``, ``_route_arrivals``) and the DCQCN rate law (``_cc_update``).
Everything else raises ``NotImplementedError`` naming its ``ROADMAP.md``
item (``check_slice``).

On CUDA each of the step's two signal-plane phases is one hand-written
CUDA kernel: ``monitor_tick`` launches ``kernels.monitor_tick`` (queue
cells, registers, ``c_cong`` and the ``hist_c`` ring write) and
``_route_arrivals`` launches ``kernels.route_arrivals`` (candidates,
congestion view, the lcmp or ecmp decision, queue wait and the per-flow
writes); ``StepLaunchers`` holds their launchers for a run. ``decide``,
kept for the later failover and re-decision callers, launches
``kernels.lcmp_decide``. On the CPU the same calls run the plain
versions of ``kernels.ref``.

Differences from the reference, by design:
- on CUDA the step updates the state's history rings, congestion
  registers, ``c_cong`` and the eight per-flow fields the route writes
  IN PLACE (the reference's JAX arrays are immutable); a caller that
  needs the pre-step state copies those tensors first;
- flow ids (``SimArrays.f_id``) are int64 tensors holding uint32 values,
  since torch lacks uint32 arithmetic;
- ``SwitchTables.high_water_level`` is a Python int.
The step performs no host sync (no ``.item()``, no tensor truthiness, no
``nonzero``), so a later change can capture it in a CUDA graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import select as selmod
from repro_torch.core.cong import CongParams, CongState
from repro_torch.core.pathq import PathQParams, calc_path_quality
from repro_torch.core.select import SelectParams
from repro_torch.core.tables import bootstrap_tables
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import path_cong_view  # noqa: F401  (re-exported)
from repro_torch.netsim.paths import PathTable
from repro_torch.traffic.gen import FlowSet

HIST = 8192          # history rings (steps); must exceed the max RTT and
                     # signal-delay offsets — build() validates this

# Policy name -> dense code, frozen as in the reference.
POLICY_CODES = {
    "lcmp": 0, "lcmp_w": 1, "ecmp": 2, "ucmp": 3, "wcmp": 4, "redte": 5,
    "fatpaths": 6, "amp": 7, "lcmp_r": 8, "matchrdma": 9,
}
POLICIES = tuple(POLICY_CODES)
ENGINES = ("fluid", "packet")
_NEVER = (1 << 30)   # sentinel step for "this link never fails/degrades"

# what this slice of the port runs
SLICE_POLICIES = ("lcmp", "ecmp")
SLICE_CC = ("dcqcn",)


def policy_code(policy: str) -> int:
    if policy not in POLICY_CODES:
        raise ValueError(f"unknown policy {policy!r}; valid: {POLICIES}")
    return POLICY_CODES[policy]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The reference's ``SimConfig`` fields that this slice reads (the
    out-of-slice ones only so ``check_slice`` can refuse them), with the
    same defaults."""
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
    sig_delay_scale: float = 1.0
    ctrl_period_us: int = 100_000
    select: SelectParams = SelectParams()
    pathq: PathQParams = PathQParams()
    congp: CongParams = CongParams()
    fail_sched: tuple = ()
    degrade_sched: tuple = ()
    flowlet_gap_us: int = 0
    redecide_period_us: int = 0
    n_subflows: int = 1
    checks: bool = False

    @property
    def num_steps(self) -> int:
        return self.horizon_us // self.dt_us

    @property
    def has_failures(self) -> bool:
        return len(self.fail_sched) > 0

    @property
    def has_degrade(self) -> bool:
        return len(self.degrade_sched) > 0


def check_slice(cfg: SimConfig) -> None:
    """Raise ``NotImplementedError`` for any configuration this slice of
    the port does not run, naming the ``ROADMAP.md`` item that will."""
    def todo(what: str, item: str):
        raise NotImplementedError(
            f"{what} is not ported yet: ROADMAP.md queue A item {item}")
    if cfg.engine == "packet":
        todo("the packet engine", "5")
    if cfg.engine != "fluid":
        raise ValueError(f"unknown engine {cfg.engine!r}; valid: {ENGINES}")
    if cfg.policy == "sweep":
        todo("the sweep meta-policy", "6")
    policy_code(cfg.policy)
    if cfg.policy not in SLICE_POLICIES:
        todo(f"policy {cfg.policy!r}", "4")
    if cfg.cc not in SLICE_CC:
        todo(f"congestion control {cfg.cc!r}", "4")
    if cfg.has_failures or cfg.has_degrade:
        todo("failure and degrade schedules (ctrl_refresh, _reroute_dead)",
             "4")
    if cfg.flowlet_gap_us or cfg.redecide_period_us:
        todo("the mid-flow re-decision knobs", "4")
    if cfg.n_subflows != 1:
        todo("multi-subflow transports (amp)", "4")
    if cfg.checks:
        todo("the physics-invariant sanitizer (checks)", "7")


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


def _t(x, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype))).to(dev)


def build(table: PathTable, flows: FlowSet, cfg: SimConfig,
          device=devmod.DEFAULT):
    """Pack numpy tables + flows into tensors on ``device`` and the
    initial state, exactly as the reference's ``build``."""
    check_slice(cfg)
    dev = devmod.resolve(device)
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
        policy_code=torch.tensor(policy_code(cfg.policy), dtype=torch.int32,
                                 device=dev),
        link_fail_step=torch.full((L,), _NEVER, dtype=torch.int32, device=dev),
        link_deg_step=torch.full((L,), _NEVER, dtype=torch.int32, device=dev),
        link_deg_factor=torch.ones((L,), dtype=torch.float32, device=dev),
        path_len=_t(table.path_len, np.int32, dev),
        link_delay_us=_t(link_delay_us, np.int32, dev),
        path_sig_delay=_t(sig_delay, np.int32, dev),
        tables=tb,
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
    current queue depths, its score landed in ``hist_c`` slot ``t``. One
    ``kernels.monitor_tick`` launch on CUDA (registers, ``c_cong`` and
    ring updated in place)."""
    cong, c_cong = ops.monitor_tick(st.cong, st.q_bytes, t * cfg.dt_us,
                                    ar.tables, cfg.congp, st.hist_c,
                                    t % HIST, st.c_cong)
    return dataclasses.replace(st, cong=cong, c_cong=c_cong)


def ctrl_tick(t: int, st: SimState, ar: SimArrays, cfg: SimConfig):
    """Periodic C_path re-install. Without a schedule that changes the
    effective capacities the reference skips it, and so does this slice;
    with one it raises (``ctrl_refresh`` is a later slice)."""
    if cfg.ctrl_period_us > 0 and (cfg.has_failures or cfg.has_degrade):
        raise NotImplementedError(
            "ctrl_refresh is not ported yet: ROADMAP.md queue A item 4")
    return st


def decide(t: int, fid, pair, st: SimState, ar: SimArrays, cfg: SimConfig,
           sig_step=None):
    """The policy-dispatched path decision. ``fid`` (N,) int64 hash keys;
    returns ``(k_idx, chosen)``, both (N,) int32, -1 where no candidate is
    valid. ``lcmp`` goes through ``kernels.lcmp_decide``."""
    cand, hop, valid = ref.candidate_view(pair, st, ar)
    if cfg.policy == "lcmp":
        c_path, c_cong = ref.lcmp_scores(t if sig_step is None else sig_step,
                                         cand, hop, st, ar)
        k_idx = ops.lcmp_decide(fid, c_path, c_cong, valid, cfg.select)
    elif cfg.policy == "ecmp":
        k_idx = selmod.ecmp_select(fid, valid)
    else:
        raise NotImplementedError(
            f"policy {cfg.policy!r} is not ported yet: ROADMAP.md queue A "
            "item 4")
    return k_idx, ref.chosen_path(cand, k_idx)


def _route_arrivals(t: int, st: SimState, ar: SimArrays, cfg: SimConfig):
    """Decide paths for the batch of flows arriving this step. One
    ``kernels.route_arrivals`` launch on CUDA (the eight per-flow fields
    written in place)."""
    return ops.route_arrivals(t, st, ar, cfg.policy, cfg.select, cfg.dt_us)


class StepLaunchers:
    """The fluid step's two fused phases on the card, one launcher each
    for a run: ``monitor(t, st)`` and ``route(t, st)`` launch one kernel
    each and return ``st``, whose tensors they update in place. A
    launcher is built, and its fixed tensors checked, at the first step
    and again only if the state's persistent tensors (registers,
    ``c_cong``, rings, ``link_alive``, ``c_path``) are replaced."""

    def __init__(self, ar: SimArrays, cfg: SimConfig):
        self.ar, self.cfg = ar, cfg
        self.tick = self.router = None

    def monitor(self, t: int, st: SimState) -> SimState:
        if self.tick is None or not self.tick.bound_to(st.cong, st.c_cong,
                                                        st.hist_c):
            self.tick = ops.MonitorTick(
                st.cong, st.c_cong, st.hist_c, self.ar.tables, self.cfg.congp,
                (self.cfg.num_steps - 1) * self.cfg.dt_us)
        self.tick(st.q_bytes, t * self.cfg.dt_us, t % HIST)
        return st

    def route(self, t: int, st: SimState) -> SimState:
        if self.router is None or not self.router.bound_to(st):
            self.router = ops.RouteArrivals(self.ar, st, self.cfg.policy,
                                            self.cfg.select, self.cfg.dt_us)
        self.router(t, st)
        return st


def _cc_update(t: int, st: SimState, ar: SimArrays, cfg: SimConfig,
               path_of_flow, links_f, links_ok):
    """The DCQCN rate law, reacting to RTT-delayed per-path queue signals
    from the ``hist_q`` ring (RED-style marking between Kmin and Kmax,
    MD on a reaction timer, fast recovery and probing towards a target).
    The other laws are a later slice."""
    if cfg.cc != "dcqcn":
        raise NotImplementedError(
            f"congestion control {cfg.cc!r} is not ported yet: ROADMAP.md "
            "queue A item 4")
    slot = (t - st.rtt_steps) % HIST
    # feedback only once the flow's first packets had a full RTT on its
    # current path
    have_fb = (t - st.route_step) > st.rtt_steps
    lidx = torch.clamp_min(links_f, 0)                          # (F,H)
    flat = lidx * HIST + slot[:, None]
    q_sig = torch.where(links_ok, st.hist_q.reshape(-1)[flat], 0.0).amax(-1)
    q_sig = torch.where(have_fb, q_sig, 0.0)

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
    dec = marked & can_dec
    new_target = torch.where(dec, st.rate, target)
    recover = st.rate + (new_target - st.rate) * 0.5 * inv_rtt
    probe = torch.where(st.rate >= 0.95 * new_target, ai, 0.0)
    rate = torch.where(dec, st.rate * cfg.md_factor, recover + probe)
    new_target = torch.where(dec, new_target, new_target + probe)

    rate = torch.clamp(rate, 0.001 * line, line)
    new_target = torch.clamp(new_target, 0.001 * line, line)
    last_dec = torch.where(dec, t, st.last_dec)
    act = st.active
    return dataclasses.replace(
        st, rate=torch.where(act, rate, st.rate),
        cc_target=torch.where(act, new_target, st.cc_target),
        last_dec=torch.where(act, last_dec, st.last_dec))
