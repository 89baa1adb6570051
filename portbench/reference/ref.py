"""Plain PyTorch decisions of the LCMP switch and the baselines: the
monitor tick, the candidate view, each routing law, the failover and
re-decision ``decide`` and the arrival routing, each a few eager torch
ops on whatever device its tensors live on.

A frozen copy of the port's plain versions as they stood when the
benchmark was written, kept apart from the program so that a later
change to the program cannot move its own yardstick.
"""
from __future__ import annotations

import dataclasses

import torch

from . import baselines as bl
from . import cong as congmod
from . import select as selmod
from .cong import CongParams, CongState
from .select import SelectParams
from .tables import CELL_BYTES, SwitchTables


def lcmp_decide_ref(flow_ids: torch.Tensor, c_path: torch.Tensor,
                    c_cong: torch.Tensor, valid: torch.Tensor,
                    params: SelectParams = SelectParams()) -> torch.Tensor:
    """(F,), (F,P), (F,P), (F,P) -> (F,) candidate index (-1 if none)."""
    idx, _ = selmod.select_egress(flow_ids, c_path, c_cong, valid, params)
    return idx


def cong_update_ref(state: CongState, queue_cells: torch.Tensor, now_us: int,
                    tables: SwitchTables, params: CongParams = CongParams(),
                    hist_c: torch.Tensor | None = None, slot: int = 0):
    """Monitor tick + score derivation. Returns ``(state', c_cong)``;
    with ``hist_c`` given, also writes ``c_cong`` into its column
    ``slot`` (the engine's ring write, which the CUDA kernel fuses)."""
    st = congmod.monitor_update(state, queue_cells, now_us, tables, params)
    c_cong = congmod.calc_cong_cost(st, tables, params)
    if hist_c is not None:
        # reprolint: ignore[RNG001] the caller passes slot = t % HIST
        hist_c[:, slot] = c_cong
    return st, c_cong


def monitor_tick_ref(state: CongState, q_bytes: torch.Tensor, now_us: int,
                     tables: SwitchTables, params: CongParams,
                     hist_c: torch.Tensor, slot: int):
    """The engine's monitor tick: link queues (float32 bytes) to cells,
    then ``cong_update_ref`` with its ring write. Returns
    ``(state', c_cong)``. ``CELL_BYTES`` is a power of two, so the cells
    are exact whether the division is one or a multiply by 2**-10."""
    qcells = (q_bytes / CELL_BYTES).to(torch.int32)
    return cong_update_ref(state, qcells, now_us, tables, params, hist_c, slot)


def path_cong_view(hist_c: torch.Tensor, path_links: torch.Tensor,
                   sig_delay: torch.Tensor, t: int) -> torch.Tensor:
    """Ingress-visible congestion of candidate paths at step ``t``: the
    max over hops of each hop's quantized ``C_cong`` from the ``hist_c``
    ring, read ``sig_delay`` steps late. ``path_links``/``sig_delay``
    (..., H); returns (...,) int32. torch's ``%`` floors like jnp's, so
    the negative offsets of early steps wrap to the ring's end."""
    ring = hist_c.shape[-1]
    lidx = torch.clamp_min(path_links, 0)
    slot = (t - sig_delay) % ring
    # the wrap is by the ring's own width, the engine's HIST, whose
    # build() guard bounds every signal delay
    # reprolint: ignore[RNG001]
    v = hist_c.reshape(-1)[lidx * ring + slot]
    return torch.where(path_links >= 0, v, 0).amax(-1)


def candidate_view(pair: torch.Tensor, st, ar):
    """The candidate paths of each pair in ``pair`` (N,): ``(cand (N, K)
    path index or -1, hop (N, K, H) link index or -1, valid (N, K))``,
    valid where the candidate exists and every hop is alive."""
    cand = ar.pair_cand[pair]
    hop = ar.path_links[torch.clamp_min(cand, 0)]
    hop_alive = torch.where(hop >= 0, st.link_alive[torch.clamp_min(hop, 0)],
                            True)
    return cand, hop, (cand >= 0) & hop_alive.all(-1)


def lcmp_scores(t: int, cand: torch.Tensor, hop: torch.Tensor, st, ar):
    """``(c_path, c_cong)`` (N, K) of the candidates: the installed path
    scores and the congestion view at step ``t``."""
    cpad = torch.clamp_min(cand, 0)
    return st.c_path[cpad], path_cong_view(st.hist_c, hop,
                                           ar.path_sig_delay[cpad], t)


def chosen_path(cand: torch.Tensor, k_idx: torch.Tensor) -> torch.Tensor:
    """The global path index of candidate ``k_idx`` of each row, -1 where
    ``k_idx`` is -1."""
    chosen = cand.gather(1, torch.clamp_min(k_idx, 0).to(torch.int64)[:, None])
    return torch.where(k_idx >= 0, chosen[:, 0], -1)


# the laws of netsim.engine.POLICY_CODES (all but the sweep meta-policy)
LAWS = ("lcmp", "lcmp_w", "ecmp", "ucmp", "wcmp", "redte", "fatpaths", "amp",
        "lcmp_r", "matchrdma")
# the laws that read the delayed congestion view
VIEW_LAWS = ("lcmp", "lcmp_w", "lcmp_r", "fatpaths", "matchrdma")


def law_choice(policy: str, t: int, sig_step: int, fid: torch.Tensor,
               pair: torch.Tensor, cand: torch.Tensor, hop: torch.Tensor,
               valid: torch.Tensor, st, ar,
               select: SelectParams = SelectParams()) -> torch.Tensor:
    """The candidate slot ``policy``'s law picks for each of N decisions
    (-1 where none is valid): hash keys ``fid`` (N,), pairs ``pair`` (N,)
    and their ``candidate_view``. The congestion view reads ``hist_c``
    slot ``sig_step`` less each hop's signal delay; ``matchrdma``'s
    degrade schedule applies at step ``t``."""
    if policy not in LAWS:
        raise ValueError(f"no law for policy {policy!r}; laws: {LAWS}")
    cpad = torch.clamp_min(cand, 0)
    if policy in VIEW_LAWS:
        c_cong = path_cong_view(st.hist_c, hop, ar.path_sig_delay[cpad],
                                sig_step)
    capg = ar.path_cap_gbps[cpad]
    if policy in ("lcmp", "lcmp_r"):    # lcmp_r differs only in the tick
        return selmod.select_egress(fid, st.c_path[cpad], c_cong, valid,
                                    select)[0]
    if policy == "lcmp_w":              # capacity-weighted stage 2
        return selmod.select_egress(fid, st.c_path[cpad], c_cong, valid,
                                    select, weights=capg)[0]
    if policy in ("ecmp", "amp"):       # amp: each subflow its own hash
        return bl.ecmp(fid, None, capg, valid)
    if policy == "ucmp":
        return bl.ucmp(fid, None, capg, valid)
    if policy == "wcmp":
        return bl.wcmp(fid, None, capg, valid)
    if policy == "redte":
        return bl._weighted_hash(fid, st.redte_w[pair], valid)
    if policy == "fatpaths":
        return bl.fatpaths(fid, ar.path_len[cpad], valid, c_cong,
                           cong_thresh=select.cong_fallback)
    # matchrdma: the tightest span's effective capacity (float32, the
    # degrade schedule applied at step t) x the congestion headroom
    eff = ar.link_cap_gbps * torch.where(t >= ar.link_deg_step,
                                         ar.link_deg_factor, 1.0)
    bneck = torch.where(hop >= 0, eff[torch.clamp_min(hop, 0)],
                        1e9).amin(-1)
    avail = bneck * (256 - c_cong).to(torch.float32)
    return bl.matchrdma(fid, torch.clamp_max(avail, 1e9).to(torch.int32),
                        valid)


def pair_law_choice(policy: str, t: int, sig_step: int, fid: torch.Tensor,
                    pair: torch.Tensor, cand: torch.Tensor, hop: torch.Tensor,
                    valid: torch.Tensor, st, ar,
                    select: SelectParams = SelectParams(),
                    sweep_policies: tuple = LAWS) -> torch.Tensor:
    """``law_choice`` of ``policy``, or under ``"sweep"`` of each row's own
    law, ``ar.pair_policy[pair]`` (the law code of the pair's cell in a
    merged sweep world): as the reference's sweep-mode decide, each law of
    ``sweep_policies`` decides every row and each row keeps its own law's
    choice (the laws are row-wise; a row whose code is not swept gets
    -1). No host sync, so the card can capture it in a graph."""
    if policy != "sweep":
        return law_choice(policy, t, sig_step, fid, pair, cand, hop, valid,
                          st, ar, select)
    code = ar.pair_policy[pair]
    k_idx = torch.full_like(code, -1)
    for p in sweep_policies:
        k_idx = torch.where(code == LAWS.index(p),
                            law_choice(p, t, sig_step, fid, pair, cand, hop,
                                       valid, st, ar, select), k_idx)
    return k_idx


def decide_ref(t: int, fid: torch.Tensor, pair: torch.Tensor, st, ar,
               policy: str, select: SelectParams = SelectParams(),
               sig_step=None, sweep_policies: tuple = LAWS):
    """``netsim.engine.decide``'s plain version: ``(k_idx, chosen)``, the
    candidate slot and global path index of each of N decisions (hash
    keys ``fid`` (N,) int64, pairs ``pair`` (N,)), both (N,) int32 and -1
    where no candidate is valid. ``sig_step`` (default ``t``) is the step
    whose ring slot the congestion view reads. ``policy`` is any of
    ``LAWS``, or ``"sweep"`` for each pair's own law of
    ``sweep_policies`` (``pair_law_choice``)."""
    cand, hop, valid = candidate_view(pair, st, ar)
    k_idx = pair_law_choice(policy, t, t if sig_step is None else sig_step,
                            fid, pair, cand, hop, valid, st, ar, select,
                            sweep_policies)
    return k_idx, chosen_path(cand, k_idx)


def route_arrivals_ref(t: int, st, ar, policy: str,
                       select: SelectParams = SelectParams(),
                       dt_us: int = 200, sweep_policies: tuple = LAWS):
    """Route the flows arriving at step ``t`` (row ``t`` of
    ``ar.arrivals``) with the plain law of ``policy`` (any of ``LAWS``, or
    ``"sweep"`` for each pair's own law of ``sweep_policies``). Returns a new state with the
    eight per-flow fields of the routed flows written; pads and flows
    with no valid candidate change nothing."""
    idx = ar.arrivals[t]                        # (A,)
    fidx = torch.clamp_min(idx, 0)
    pair = ar.f_pair[fidx]
    cand, hop, valid = candidate_view(pair, st, ar)
    k_idx = pair_law_choice(policy, t, t, ar.f_id[fidx], pair, cand, hop,
                            valid, st, ar, select, sweep_policies)
    chosen = torch.where(idx >= 0, chosen_path(cand, k_idx), -1)  # (A,)

    # the engine's queue-wait sum, which its failover and re-decision
    # use too (imported here: the engine imports this module)
    from .engine import path_queue_wait

    ok = chosen >= 0
    cpath_sel = torch.clamp_min(chosen, 0)
    qw = path_queue_wait(st.q_bytes, ar.link_cap, ar.path_links[cpath_sel])
    rtt = torch.clamp_min(
        torch.div(2 * ar.path_prop[cpath_sel], dt_us, rounding_mode="floor"), 1)

    F = st.flow_path.shape[0]
    # pad slots and no-decision flows write to a scratch element past the
    # end instead of a real flow (the reference's out-of-bounds drop):
    # a pad write to flow 0 would race a real flow-0 arrival
    tgt = torch.where(ok, fidx, F).to(torch.int64)

    def upd(a, vals):
        ext = torch.cat([a, a.new_empty((1,))])
        ext.index_put_((tgt,), vals.to(a.dtype))
        return ext[:F]

    return dataclasses.replace(
        st,
        flow_path=upd(st.flow_path, chosen),
        remaining=upd(st.remaining, ar.f_size[fidx]),
        rate=upd(st.rate, ar.path_cap[cpath_sel]),
        cc_target=upd(st.cc_target, ar.path_cap[cpath_sel]),
        active=upd(st.active, ok),
        extra_wait=upd(st.extra_wait, qw),
        rtt_steps=upd(st.rtt_steps, rtt),
        route_step=upd(st.route_step, torch.full_like(idx, t)),
    )
