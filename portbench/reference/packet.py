"""Slotted packet-level simulator, as a host loop over an eager step.

Flows move bytes of whole MTU packets hop by hop through per-flow
queues, ``fq[f, h]`` the bytes of flow ``f`` queued at the egress of its
``h``-th hop: sources inject CC-paced whole packets inside the rate-BDP
window; each slot serves the hops in path order under per-link byte
budgets split over the flows in proportion to their queued bytes; PFC
XOFF/XON hysteresis lands in the ``hist_pause`` ring and gates the
upstream hop one backward link propagation late; buffer space bounds
every acceptance; a flow completes when its last byte leaves its last
hop queue. The signal, control and routing planes are ``engine``'s.
Every per-link sum sends a masked 0.0 contribution to a parking link
``f % L`` and runs in ``SimConfig.sum_dtype``.
"""
from __future__ import annotations

import dataclasses

import torch

from . import engine
from .engine import (
    HIST, SimArrays, SimConfig, SimState, _cc_update, _reroute_dead,
    check_slice, ctrl_tick, redecide_tick, redte_tick,
    step_phases, trip_steps, wants_redecide)
from .paths import PathTable
from .gen import FlowSet

name = "packet"

_NEVER_SENT = 1 << 20   # last_tx sentinel: t - last_tx < 0, so a routed
                        # flow that has sent nothing is not flowlet-eligible


@dataclasses.dataclass
class PacketState(SimState):
    """``SimState`` plus the packet data plane; field names equal the
    reference's. A flow's in-flight bytes are ``fq[f].sum()``."""
    fq: torch.Tensor          # (F, H) f32 bytes queued at each hop
    credit: torch.Tensor      # (F,) f32 pacing credit
    delivered: torch.Tensor   # (F,) f32 bytes delivered
    last_tx: torch.Tensor     # (F,) i32 last slot with bytes in flight
                              # (kept while the flowlet plane is armed)
    pfc_pause: torch.Tensor   # (L,) bool current XOFF state
    hist_pause: torch.Tensor  # (L, HIST) bool pause ring


def build(table: PathTable, flows: FlowSet, cfg: SimConfig,
          device="cpu"):
    """``engine.build`` plus the zeroed packet state, on ``device``."""
    arr, base = engine.build(table, flows, cfg, device)
    F, L, H = (base.flow_path.shape[0], base.q_bytes.shape[0],
               arr.path_links.shape[1])
    dev = base.q_bytes.device
    state = PacketState(
        **{f.name: getattr(base, f.name) for f in dataclasses.fields(SimState)},
        fq=torch.zeros((F, H), dtype=torch.float32, device=dev),
        credit=torch.zeros((F,), dtype=torch.float32, device=dev),
        delivered=torch.zeros((F,), dtype=torch.float32, device=dev),
        last_tx=torch.full((F,), _NEVER_SENT, dtype=torch.int32, device=dev),
        pfc_pause=torch.zeros((L,), dtype=torch.bool, device=dev),
        hist_pause=torch.zeros((L, HIST), dtype=torch.bool, device=dev))
    return arr, state


def _hop_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of (F, H) ``x``, added in hop order."""
    s = x[:, 0]
    for h in range(1, x.shape[1]):
        s = s + x[:, h]
    return s


def _reroute_dead_packet(t: int, st: PacketState, ar: SimArrays,
                         cfg: SimConfig, decide_fn=None) -> PacketState:
    """Lazy failover with go-back-N: the shared reroute re-decides the
    flows on dead paths; the bytes queued on a moved flow's old path
    (read before the reroute) go back to ``remaining``, and its hop
    queues and pacing credit are zeroed."""
    stranded = _hop_sum(st.fq)
    st2 = _reroute_dead(t, st, ar, cfg, decide_fn)
    moved = st.active & ((st2.flow_path != st.flow_path) | ~st2.active)
    return dataclasses.replace(
        st2,
        remaining=torch.where(moved, st2.remaining + stranded, st2.remaining),
        fq=torch.where(moved[:, None], 0.0, st.fq),
        credit=torch.where(moved, 0.0, st.credit))


def _seg_index(idx: torch.Tensor, ok: torch.Tensor,
               park: torch.Tensor) -> torch.Tensor:
    """Where each contribution to a per-link sum goes: its link ``idx``
    where ``ok``, else its parking link ``park`` (its value is 0.0)."""
    return torch.where(ok, idx, park)


def make_step(ar: SimArrays, cfg: SimConfig):
    """``step(st, t) -> st`` for one slot of the packet model."""
    check_slice(cfg)
    L, F, H = ar.link_cap.shape[0], ar.f_pair.shape[0], ar.path_links.shape[1]
    dev = ar.link_cap.device
    dt = float(cfg.dt_us)
    mtu = float(cfg.mtu_bytes)
    # a tensor divisor: on the card a division by a Python scalar becomes
    # a multiply by its reciprocal, which can round differently
    mtu_t = torch.tensor(mtu, dtype=torch.float32, device=dev)
    buf = float(cfg.buffer_bytes * cfg.cap_scale)
    xoff = cfg.pfc_xoff_frac * buf
    xon = cfg.pfc_xon_frac * buf
    tick, route, decide = step_phases(ar, cfg)
    trips, down = trip_steps(ar, cfg)
    flowlet = wants_redecide(cfg)
    gap_steps = max(cfg.flowlet_gap_us // cfg.dt_us, 1)
    park = (torch.arange(F, device=dev) % L).to(torch.int32)[:, None]
    # backward propagation of each path hop's link, in slots (the delay
    # the pause frame of the hop after it takes to reach it)
    hop_pd = torch.div(ar.link_delay_us[torch.clamp_min(ar.path_links, 0)],
                       cfg.dt_us, rounding_mode="floor")
    acc = getattr(torch, cfg.sum_dtype)

    def seg(vals, idx):
        return torch.zeros((L,), dtype=acc, device=dev).index_add_(
            0, idx, vals.to(acc)).to(torch.float32)

    def step(st: PacketState, t: int) -> PacketState:
        # 0) link trips + lazy failover with go-back-N
        if t in down:
            st.link_alive.copy_(t < ar.link_fail_step)
        if t in trips:
            st = _reroute_dead_packet(t, st, ar, cfg, decide)

        # 1) switch monitor tick + control-plane refresh (shared)
        st = tick(t, st)
        st = ctrl_tick(t, st, ar, cfg)

        # 2) arrivals + routing decisions (shared herd batch)
        st = route(t, st)

        # 2b) flowlet re-decision: a flow whose hop queues drained at
        # least flowlet_gap_us ago may re-decide (checked every slot
        # while the plane is armed)
        if flowlet:
            idle = st.fq.sum(-1) <= 0.0
            st = redecide_tick(t, st, ar, cfg,
                               idle & ((t - st.last_tx) >= gap_steps), decide)

        # geometry of the routed flows; sidx is each hop's link for the
        # per-link sums, with masked hops parked (see _seg_index)
        pf = st.flow_path
        routed = pf >= 0
        pfc = torch.clamp_min(pf, 0)
        links_f = ar.path_links[pfc]                            # (F,H)
        geom_ok = (links_f >= 0) & routed[:, None]
        sidx = _seg_index(torch.clamp_min(links_f, 0), geom_ok, park)
        has_next = links_f[:, 1:] >= 0                          # (F,H-1)

        # 3) PFC XOFF/XON hysteresis; the new state lands in the pause
        # ring at slot t, and the hop before a link reads it back one
        # backward propagation of its own link late
        pause = torch.where(st.q_bytes > xoff, True,
                            torch.where(st.q_bytes < xon, False, st.pfc_pause))
        st.hist_pause[:, t % HIST] = pause
        pslot = (t - hop_pd[pfc][:, :-1]) % HIST     # floors: Python's %
        paused_next = (st.hist_pause.reshape(-1)[sidx[:, 1:] * HIST + pslot]
                       & has_next)
        gate = geom_ok.clone()
        gate[:, :-1] &= ~paused_next

        # 4) injection: CC-paced credit, rate-BDP window, whole packets;
        # the NIC's pause gate reads its first link's current state
        act = st.active & routed
        win = torch.clamp_min(st.rate * st.rtt_steps.to(torch.float32) * dt,
                              mtu)
        credit = torch.where(act, st.credit + st.rate * dt, 0.0)
        credit = torch.minimum(credit, win)
        avail = torch.minimum(credit,
                              torch.clamp_min(win - _hop_sum(st.fq), 0.0))
        l0 = sidx[:, 0]
        avail = torch.where(act & ~pause[l0], avail, 0.0)
        inject = torch.where(st.remaining <= avail, st.remaining,
                             torch.floor(avail / mtu_t) * mtu)
        # ingress buffer space is a hard bound; a space-limited injection
        # is re-quantized to whole packets
        space0 = torch.clamp_min(buf - st.q_bytes, 0.0)
        inj_factor = torch.clamp_max(
            space0 / torch.clamp_min(seg(inject, l0), 1e-9), 1.0)
        scaled = inject * inj_factor[l0]
        inject = torch.where(scaled < inject,
                             torch.floor(scaled / mtu_t) * mtu, inject)
        st = dataclasses.replace(st, remaining=st.remaining - inject,
                                 credit=torch.where(act, credit - inject, 0.0))

        # 5) hop-by-hop store-and-forward under per-link budgets, hops in
        # path order; served keeps every link inside cap x dt, q_now is
        # the intra-slot depth for the buffer acceptance factors
        cap_nom = ar.link_cap
        if cfg.has_degrade:
            cap_nom = cap_nom * torch.where(t >= ar.link_deg_step,
                                            ar.link_deg_factor, 1.0)
        budget = torch.where(st.link_alive, cap_nom, 1e-9) * dt
        fq = st.fq
        fq[:, 0].add_(inject)
        served = torch.zeros((L,), dtype=torch.float32, device=dev)
        in_l = seg(inject, l0)
        q_now = st.q_bytes + in_l
        delivered_add = torch.zeros_like(st.delivered)
        for h in range(H):
            lh = sidx[:, h]
            sendable = torch.where(gate[:, h], fq[:, h], 0.0)
            demand = seg(sendable, lh)
            f_serv = torch.clamp_max(torch.clamp_min(budget - served, 0.0)
                                     / torch.clamp_min(demand, 1e-9), 1.0)
            out = sendable * f_serv[lh]
            if h + 1 < H:
                nxt, ln = has_next[:, h], sidx[:, h + 1]
                # downstream buffer acceptance (delivery is never blocked)
                offered_in = seg(torch.where(nxt, out, 0.0), ln)
                f_in = torch.clamp_max(torch.clamp_min(buf - q_now, 0.0)
                                       / torch.clamp_min(offered_in, 1e-9), 1.0)
                out = out * torch.where(nxt, f_in[ln], 1.0)
                fwd = torch.where(nxt, out, 0.0)
                fq[:, h].sub_(out)
                fq[:, h + 1].add_(fwd)
                s_out, s_fwd = seg(out, lh), seg(fwd, ln)
                served = served + s_out
                in_l = in_l + s_fwd
                q_now = q_now - s_out + s_fwd
                delivered_add = delivered_add + torch.where(nxt, 0.0, out)
            else:                   # the last hop position delivers all
                fq[:, h].sub_(out)
                served = served + seg(out, lh)
                delivered_add = delivered_add + out

        q_new = seg(torch.where(geom_ok, fq, 0.0).reshape(-1), sidx.reshape(-1))
        # offered-load utilization: standing backlog plus every byte that
        # arrived wanting service this slot, over the service capacity
        util = (st.q_bytes + in_l) / torch.clamp_min(budget, 1e-9)
        hslot = t % HIST
        st.hist_q[:, hslot] = q_new
        st.hist_u[:, hslot] = util
        st = dataclasses.replace(
            st, q_bytes=q_new, pfc_pause=pause,
            delivered=st.delivered + delivered_add,
            u_ewma=st.u_ewma * 0.99 + 0.01 * torch.clamp_max(util, 1.0),
            serv_bytes=st.serv_bytes + served)

        # 5b) flowlet clock: a flow is transmitting any slot it injects or
        # still has bytes queued
        if flowlet:
            busy = (inject > 0.0) | (fq.sum(-1) > 0.0)
            st = dataclasses.replace(st, last_tx=torch.where(busy, t,
                                                             st.last_tx))

        # 6) CC rate update from the RTT-delayed rings (shared laws)
        st = _cc_update(t, st, ar, cfg, pf, links_f,
                        geom_ok & st.active[:, None])

        # 7) completion by delivery: all bytes injected and every hop
        # queue drained (exactly: the last service factor is 1.0)
        newly_done = st.active & (st.remaining <= 0.0) & (fq.sum(-1) <= 0.0)
        prop = ar.path_prop[pfc].to(torch.float32)
        fct = (t + 1) * dt - ar.f_arr_us + prop
        st = dataclasses.replace(
            st,
            active=st.active & ~newly_done,
            done=st.done | newly_done,
            fct_us=torch.where(newly_done, fct, st.fct_us))

        # 8) RedTE periodic split-ratio re-optimization (shared tick)
        st = redte_tick(t, st, ar, cfg)
        return st

    return step


@torch.inference_mode()
def run(arrs: SimArrays, state: PacketState, cfg: SimConfig) -> PacketState:
    """The whole horizon -> final state, under ``torch.inference_mode``.
    ``state`` is consumed: its rings, registers and hop queues are
    updated in place."""
    step = make_step(arrs, cfg)
    for t in range(cfg.num_steps):
        state = step(state, t)
    return state
