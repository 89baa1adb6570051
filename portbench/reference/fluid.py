"""Flow-level fluid simulator, as a host loop over an eager step.

Flows are routed at arrival and pinned (``fatpaths`` and ``lcmp_r`` may
re-decide on a ``redecide_period_us`` epoch), share links
max-min-proportionally (each link scales its flows by ``min(1,
cap/offered)``), per-link byte queues integrate overload, the CC law
reacts to RTT-delayed signals from the history rings, and the LCMP
switch runs inside the loop. Step order: trip-step reroute, monitor
tick, control tick, arrival routing, re-decision epoch, offered load,
degraded capacity, CC, drain, completion, RedTE tick.
"""
from __future__ import annotations

import dataclasses

import torch

from .engine import (HIST, SimArrays, SimConfig, SimState, _cc_update,  # noqa: F401
                     _reroute_dead, build, check_slice, ctrl_tick,
                     redecide_tick, redte_tick, step_phases, trip_steps,
                     wants_redecide)

name = "fluid"


def make_step(ar: SimArrays, cfg: SimConfig):
    """``step(st, t) -> st`` for one ``dt`` of the fluid model."""
    check_slice(cfg)
    L = ar.link_cap.shape[0]
    dt = float(cfg.dt_us)
    q_max = float(cfg.buffer_bytes * cfg.cap_scale)
    tick, route, decide = step_phases(ar, cfg)
    trips, down = trip_steps(ar, cfg)
    epoch = (max(cfg.redecide_period_us // cfg.dt_us, 1)
             if wants_redecide(cfg) else 0)
    # the offered-load sum's slots past the links, one per (flow, hop)
    park = L + torch.arange(ar.f_id.shape[0] * ar.path_links.shape[1],
                            dtype=torch.int32, device=ar.link_cap.device
                            ).reshape(-1, ar.path_links.shape[1])
    acc = getattr(torch, cfg.sum_dtype)

    def step(st: SimState, t: int) -> SimState:
        # 0) link trips + lazy failover: flows pinned to a dead path
        # re-decide under their own law (before this step's monitor tick)
        if t in down:
            st.link_alive.copy_(t < ar.link_fail_step)
        if t in trips:
            st = _reroute_dead(t, st, ar, cfg, decide)

        # 1) switch monitor tick + 1b) control-plane refresh
        st = tick(t, st)
        st = ctrl_tick(t, st, ar, cfg)

        # 2) arrivals + routing decisions (the herd batch)
        st = route(t, st)

        # 2b) mid-flow re-decision epoch (every flow eligible)
        if epoch and t % epoch == 0:
            st = redecide_tick(t, st, ar, cfg, torch.ones_like(st.active),
                               decide)

        # 3) offered load per link. Each masked contribution (0.0) is
        # parked on its own slot past the links. In float64 the sum of up
        # to 512 float32 rates within a factor 2^20 of each other is
        # exact, so the order in which index_add_ adds does not show
        pf = st.flow_path
        links_f = ar.path_links[torch.clamp_min(pf, 0)]         # (F,H)
        links_ok = (links_f >= 0) & st.active[:, None] & (pf >= 0)[:, None]
        lidx = torch.clamp_min(links_f, 0)
        contrib = torch.where(links_ok, st.rate[:, None], 0.0)
        offered = torch.zeros((park.numel() + L,), dtype=acc,
                              device=contrib.device).index_add_(
            0, torch.where(links_ok, links_f, park).reshape(-1),
            contrib.reshape(-1).to(acc))[:L].float()

        # 4) per-link share factor and queue integration; degradation is
        # silent: flows stay pinned, only CC and the registers react
        cap_nom = ar.link_cap
        if cfg.has_degrade:
            cap_nom = cap_nom * torch.where(t >= ar.link_deg_step,
                                            ar.link_deg_factor, 1.0)
        cap = torch.where(st.link_alive, cap_nom, 1e-9)
        factor_l = torch.clamp_max(cap / torch.clamp_min(offered, 1e-9), 1.0)
        served = torch.minimum(offered, cap)
        q = torch.clamp(st.q_bytes + (offered - cap) * dt, 0.0, q_max)
        util = offered / cap
        hslot = t % HIST
        st.hist_q[:, hslot] = q
        st.hist_u[:, hslot] = util
        st = dataclasses.replace(
            st, q_bytes=q,
            u_ewma=st.u_ewma * 0.99 + 0.01 * torch.clamp_max(util, 1.0),
            serv_bytes=st.serv_bytes + served * dt)

        # 5) CC rate update from delayed signals
        st = _cc_update(t, st, ar, cfg, pf, links_f, links_ok)

        # 6) drain flows at the bottleneck-shared rate
        f_factor = torch.where(links_ok, factor_l[lidx], 1.0).amin(-1)
        send = torch.where(st.active, st.rate * f_factor, 0.0)
        remaining = st.remaining - send * dt

        newly_done = st.active & (remaining <= 0)
        # completion: propagation + residual queue wait on the path
        qw_now = torch.where(links_ok, q[lidx] / ar.link_cap[lidx],
                             0.0).sum(-1)
        prop = ar.path_prop[torch.clamp_min(pf, 0)].to(torch.float32)
        fct = ((t + 1) * dt - ar.f_arr_us + prop
               + 0.5 * (st.extra_wait + qw_now))
        st = dataclasses.replace(
            st,
            remaining=torch.clamp_min(remaining, 0.0),
            active=st.active & ~newly_done,
            done=st.done | newly_done,
            fct_us=torch.where(newly_done, fct, st.fct_us))

        # 7) RedTE periodic split-ratio re-optimization
        st = redte_tick(t, st, ar, cfg)
        return st

    return step


@torch.inference_mode()
def run(arrs: SimArrays, state: SimState, cfg: SimConfig) -> SimState:
    """The whole horizon -> final state, under ``torch.inference_mode``.
    ``state`` is consumed: its rings and registers are updated in place."""
    step = make_step(arrs, cfg)
    for t in range(cfg.num_steps):
        state = step(state, t)
    return state
