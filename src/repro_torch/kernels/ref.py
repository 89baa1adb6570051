"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro/kernels/ref.py``: the reference semantics, built
on the ported ``core`` so each kernel is pinned to the same decision
path the engine uses. The kernel wrappers run these for CPU tensors;
the CUDA kernels must match them bit for bit.

Besides the TPU kernels' own functions, this holds the plain versions of
the fluid engine's fused phases, ``monitor_tick_ref`` and
``route_arrivals_ref``, and of the failover and re-decision decision,
``decide_ref``, with the candidate view and the policy-dispatched law
(``law_choice``, the reference's ``engine.decide._choice``, and
``pair_law_choice``, its per-pair dispatch for a merged sweep world)
they share. ``decide_records_ref`` and ``decide_pick_ref`` are the plain
versions of the card's two ``decide`` kernels, the per-pair and the
per-decision half of every law, which compose to ``decide_ref``.
They take the engine's ``SimState`` and ``SimArrays`` by field name and
use the ring width of ``hist_c``. ``switch_monitor_ref`` and
``switch_route_ref`` are the plain versions of the switch's monitor pass
and batch of arrivals (``core.switchd``), which take the switch's
``SwitchState`` by field name.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import baselines as bl
from repro_torch.core import cong as congmod
from repro_torch.core import flowcache as fc
from repro_torch.core import select as selmod
from repro_torch.core.cong import CongParams, CongState
from repro_torch.core.select import SelectParams
from repro_torch.core.tables import CELL_BYTES, SwitchTables


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


def switch_monitor_ref(sw, queue_cells: torch.Tensor, now_us: int,
                       params: CongParams = CongParams()):
    """The switch's monitor pass: ``cong_update_ref`` over the registers
    of switch ``sw``. Returns ``(cong', c_cong)``."""
    return cong_update_ref(sw.cong, queue_cells, now_us, sw.tables, params)


def switch_route_ref(sw, flow_ids: torch.Tensor, now_us: int,
                     params: SelectParams = SelectParams()):
    """A batch of arrivals at switch ``sw``: established flows (cache hit,
    live egress) keep their candidate, every other flow takes the fresh
    LCMP decision over the switch's candidates and is inserted into the
    cache (``core.flowcache``'s collision rule). ``flow_ids`` (F,) int64.
    Returns ``(cache', choice, is_new)``: a new cache, (F,) int32
    candidate indices (-1: none valid) and (F,) bool."""
    # the cache stores candidate indices: a candidate is "alive" (and
    # valid for the decision) iff it is installed and its port is alive
    cand_alive = sw.port_alive[sw.cand_port] & sw.cand_valid
    hit, cached_idx, slot = fc.lookup(sw.cache, flow_ids, cand_alive)
    cache = fc.refresh(sw.cache, slot, hit, now_us)

    F, P = flow_ids.shape[0], sw.c_path.shape[0]
    fresh_idx = lcmp_decide_ref(
        flow_ids, sw.c_path.expand(F, P).contiguous(),
        sw.c_cong[sw.cand_port].expand(F, P).contiguous(),
        cand_alive.expand(F, P).contiguous(), params)
    choice = torch.where(hit, cached_idx, fresh_idx)
    cache = fc.insert(cache, flow_ids, fresh_idx, now_us, ~hit)
    return cache, choice, ~hit


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


# decide's factorization: a record per pair, then a pick per decision
RECORD_SLOTS = 8                    # a record's slots (the kernels' P_MAX)
# the laws by the per-decision half they take (``decide_pick_ref``)
RANK_LAWS = ("lcmp", "lcmp_r")
WEIGHTED_LAWS = ("lcmp_w", "wcmp", "redte")
NTH_LAWS = ("ecmp", "amp", "fatpaths")
ROTATE_LAWS = ("ucmp", "matchrdma")


def _slots(x: torch.Tensor, fill) -> torch.Tensor:
    """(N, K) -> (N, ``RECORD_SLOTS``), padded with ``fill``."""
    pad = x.new_full((x.shape[0], RECORD_SLOTS - x.shape[1]), fill)
    return torch.cat([x, pad], 1)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """(N, 8) bool -> (N,) int32 mask, slot k at bit k."""
    shift = torch.arange(RECORD_SLOTS, dtype=torch.int32, device=x.device)
    return (x.to(torch.int32) << shift).sum(1).to(torch.int32)


def _law_records(policy: str, t: int, sig_step: int, pair: torch.Tensor,
                 cand: torch.Tensor, hop: torch.Tensor, valid: torch.Tensor,
                 st, ar, select: SelectParams) -> dict:
    """The per-pair half of ``policy``'s law for the pairs ``pair``, with
    their ``candidate_view`` (see ``decide_records_ref``)."""
    if policy not in LAWS:
        raise ValueError(f"no law for policy {policy!r}; laws: {LAWS}")
    N, K = cand.shape
    dev = cand.device
    slot = torch.arange(RECORD_SLOTS, dtype=torch.int32, device=dev)
    cpad = torch.clamp_min(cand, 0)
    m = valid.sum(1).to(torch.int32)
    zero = torch.zeros(N, dtype=torch.int32, device=dev)
    n, mask = zero, zero
    order = torch.zeros((N, RECORD_SLOTS), dtype=torch.int32, device=dev)
    cum = torch.zeros_like(order)
    capg = torch.where(cand >= 0, ar.path_cap_gbps[cpad], 0)
    if policy in VIEW_LAWS:
        c_cong = path_cong_view(st.hist_c, hop, ar.path_sig_delay[cpad],
                                sig_step)
    if policy in ("lcmp", "lcmp_r", "lcmp_w"):
        cost = torch.where(valid, select.alpha * st.c_path[cpad]
                           + select.beta * c_cong, selmod.COST_INVALID)
        key = _slots(cost, selmod.COST_INVALID) * RECORD_SLOTS + slot
        order = torch.argsort(key, dim=1).to(torch.int32)   # distinct keys
        keep = torch.clamp_min(torch.div(m + select.keep_num - 1,
                                         select.keep_num, rounding_mode="floor"), 1)
        low = torch.where(valid, c_cong, selmod.SCORE_MAX + 1).amin(1)
        n = torch.where(m == 0, 0, torch.where(low >= select.cong_fallback,
                                               1, keep)).to(torch.int32)
        if policy == "lcmp_w":      # the kept ranks' capacities, max(w, 1)
            kept = slot[None, :] < n[:, None]
            w = torch.where(kept, torch.clamp_min(
                _slots(capg, 0).gather(1, order.long()), 1), 0)
            cum = torch.where(kept, torch.cumsum(w, 1), 0).to(torch.int32)
    elif policy in ("ecmp", "amp"):
        mask, n = _bits(_slots(valid, False)), m
    elif policy in ("ucmp", "matchrdma"):
        if policy == "ucmp":
            cost = torch.where(valid, torch.div(
                1_000_000, torch.clamp_min(capg, 1), rounding_mode="floor"),
                bl.BIG)
        else:                       # as law_choice's matchrdma
            eff = ar.link_cap_gbps * torch.where(t >= ar.link_deg_step,
                                                 ar.link_deg_factor, 1.0)
            bneck = torch.where(hop >= 0, eff[torch.clamp_min(hop, 0)],
                                1e9).amin(-1)
            avail = bneck * (256 - c_cong).to(torch.float32)
            cost = torch.where(valid, -torch.clamp_max(avail, 1e9).to(
                torch.int32), bl.BIG)
        least = cost.amin(1, keepdim=True)
        mask = _bits(_slots(valid & (cost == least), False))
        n = torch.full_like(zero, K)
    elif policy in ("wcmp", "redte"):
        x = capg if policy == "wcmp" else st.redte_w[pair]
        w = torch.where(valid, torch.clamp_min(x, 1), 0)
        cum = _slots(torch.cumsum(w, 1).to(torch.int32), 0)
        order = slot.expand(N, RECORD_SLOTS).clone()
        n = torch.full_like(zero, K)
    else:                           # fatpaths
        plen = torch.where(valid, ar.path_len[cpad], bl.BIG)
        layer0 = valid & (plen == plen.amin(1, keepdim=True))
        spill = torch.where(layer0, c_cong, bl.BIG).amin(1) >= select.cong_fallback
        chosen = torch.where(spill[:, None], valid, layer0)
        mask, n = _bits(_slots(chosen, False)), chosen.sum(1).to(torch.int32)
    return dict(law=torch.full_like(zero, LAWS.index(policy)), n=n,
                order=order, mask=mask, cum=cum, path=_slots(cand, -1))


def decide_records_ref(t: int, sig_step: int, st, ar, policy: str,
                       select: SelectParams = SelectParams(),
                       sweep_policies: tuple = LAWS) -> dict:
    """The per-pair half of ``decide_ref``: every pair's record, as the
    ``decide`` kernel's first stage writes it, unpacked (int32 tensors;
    ``kernels.lcmp_decide.unpack_records`` reads the kernel's table into
    the same fields). ``law`` and ``n`` (NPAIR,): the law's code and the
    modulus of its pick (lcmp, lcmp_r: the kept ranks, 1 under the
    congestion fallback; lcmp_w: the weighted kept ranks, likewise;
    wcmp, redte, ucmp, matchrdma: K; ecmp, amp, fatpaths: the mask's
    popcount; 0 when no candidate is valid, or for a law not swept);
    ``order`` (NPAIR, 8): the slot of each rank (lcmp family by cost,
    wcmp and redte the identity; 0 for the mask laws); ``mask`` (NPAIR,):
    the slots ecmp, amp and fatpaths hash over, or ucmp's and matchrdma's
    slots of least cost (0 for the others); ``cum`` (NPAIR, 8): the
    cumulative weights of lcmp_w's kept ranks and of wcmp's and redte's
    slots (0 past ``n`` and for the others); ``path`` (NPAIR, 8): the
    candidates, -1 past K. The view reads ring step ``sig_step``;
    ``matchrdma``'s degrade applies at ``t``. Under ``"sweep"`` each
    pair's record is its own law's."""
    NPAIR = ar.pair_cand.shape[0]
    pair = torch.arange(NPAIR, device=ar.pair_cand.device)
    cand, hop, valid = candidate_view(pair, st, ar)
    args = (t, sig_step, pair, cand, hop, valid, st, ar, select)
    if policy != "sweep":
        return _law_records(policy, *args)
    code = ar.pair_policy
    zero = torch.zeros_like(code)
    zeros = torch.zeros((NPAIR, RECORD_SLOTS), dtype=torch.int32,
                        device=code.device)
    out = dict(law=code, n=zero, order=zeros, mask=zero, cum=zeros,
               path=_slots(cand, -1))
    for p in sweep_policies:
        rec = _law_records(p, *args)
        rows = code == LAWS.index(p)
        out = {k: torch.where(rows.reshape(-1, *[1] * (v.dim() - 1)), rec[k], v)
               for k, v in out.items()}
    return out


def decide_pick_ref(records: dict, fid: torch.Tensor, pair: torch.Tensor):
    """The per-decision half of ``decide_ref``: ``(k_idx, chosen)`` (N,)
    int32 of N decisions (hash keys ``fid``, pairs ``pair``) from the
    pairs' ``decide_records_ref``. Each law reads its key only through
    ``fmix32(fid)``: rank ``fmix32 % n`` of ``order`` (lcmp, lcmp_r); the
    count of ``cum`` entries <= ``int32(fmix32 >> 1) % cum[n-1]``, as a
    rank of ``order`` (lcmp_w, wcmp, redte; -1 when the total is <= 0);
    the ``fmix32 % n``-th set bit of ``mask`` (ecmp, amp, fatpaths); the
    first set bit of ``mask`` at or after ``fmix32 % n``, cyclically
    (ucmp, matchrdma). -1 where ``n`` (or the mask) is 0."""
    r = {k: v[pair] for k, v in records.items()}
    law, n, order, mask, cum = (r[k] for k in ("law", "n", "order", "mask",
                                               "cum"))
    slot = torch.arange(RECORD_SLOTS, device=law.device)
    hv = selmod.fmix32(fid)
    mod = hv % torch.clamp_min(n, 1).to(torch.int64)
    none = torch.full_like(law, -1)

    def rank_slot(rank):
        return order.gather(1, rank.to(torch.int64)[:, None])[:, 0]

    k_rank = torch.where(n > 0, rank_slot(mod), -1)
    total = cum.gather(1, torch.clamp_min(n - 1, 0).to(torch.int64)[:, None])[:, 0]
    h = (hv >> 1) % torch.clamp_min(total, 1)
    count = ((cum <= h[:, None]) & (slot[None, :] < n[:, None])).sum(1)
    k_weighted = torch.where((n > 0) & (total > 0),
                             rank_slot(torch.clamp_max(count, RECORD_SLOTS - 1)), -1)
    bits = ((mask[:, None] >> slot) & 1).bool()
    nth = bits & (torch.cumsum(bits.to(torch.int64), 1) == mod[:, None] + 1)
    k_nth = torch.where(n > 0, nth.to(torch.int32).argmax(1), -1)
    after = bits & (slot[None, :] >= mod[:, None])
    k_rotate = torch.where(mask == 0, -1, torch.where(
        after.any(1), after.to(torch.int32).argmax(1),
        bits.to(torch.int32).argmax(1)))
    k_idx = none
    for laws, k in ((RANK_LAWS, k_rank), (WEIGHTED_LAWS, k_weighted),
                    (NTH_LAWS, k_nth), (ROTATE_LAWS, k_rotate)):
        codes = torch.tensor([LAWS.index(p) for p in laws], device=law.device)
        k_idx = torch.where(torch.isin(law, codes), k.to(torch.int32), k_idx)
    chosen = r["path"].gather(1, torch.clamp_min(k_idx, 0).to(torch.int64)[:, None])
    return k_idx, torch.where(k_idx >= 0, chosen[:, 0], -1)


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
    # use too (imported here: the engine imports the kernels)
    from repro_torch.netsim.engine import path_queue_wait

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


QSR_BLOCK = 1024           # elements per scale block
_QSR_ROWS = 1 << 14        # blocks per pass of the plain quantizer (2**24 elements)


def qsr_int8_ref(x: torch.Tensor, rand_bits: torch.Tensor,
                 block: int = QSR_BLOCK):
    """Blockwise int8 quantization with stochastic rounding.

    ``x`` (N,) float32, N a multiple of ``block``; ``rand_bits`` (N,)
    holding the uint32 pattern, as int32 (two's complement) or as int64
    in [0, 2**32). Returns ``(q (N,) int8, scales (N/block,) float32)``.
    Per block: ``scale = amax/127``, ``q = clip(floor(x*(127/amax) + u),
    -127, 127)`` with ``u = (bits >> 8) * 2**-24`` (exact in float32); a
    zero block gives q = 0 and scale 0. The multiply and the add are
    separate operations, each rounded, as in the reference, and both
    divisions are IEEE divisions, so the CUDA kernel can match this bit
    for bit. Blocks are independent, so the pass runs over 2**24
    elements at a time to bound its temporaries.
    """
    n = x.shape[0]
    if n % block:
        raise ValueError(f"qsr_int8: N={n} is not a multiple of {block}")
    xb = x.reshape(n // block, block)
    bb = rand_bits.reshape(n // block, block)
    q = torch.empty((n // block, block), dtype=torch.int8, device=x.device)
    scales = torch.empty((n // block,), dtype=torch.float32, device=x.device)
    for r in range(0, n // block, _QSR_ROWS):
        xs, bs = xb[r:r + _QSR_ROWS].float(), bb[r:r + _QSR_ROWS]
        amax = xs.abs().amax(dim=1, keepdim=True)
        # tensor / tensor: an IEEE division. PyTorch turns ``127.0 / t``
        # and, on CUDA, ``t / 127.0`` into a multiply by a reciprocal,
        # which can differ in the last bit.
        c127 = torch.full_like(amax, 127.0)
        scales[r:r + _QSR_ROWS] = (amax / c127)[:, 0]
        inv = torch.where(amax > 0, c127 / amax, torch.zeros_like(amax))
        # logical >> 8 of the 32-bit pattern: 24 bits, exact in float32
        u = ((bs >> 8) & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
        q[r:r + _QSR_ROWS] = torch.clamp(torch.floor(xs * inv + u),
                                         -127.0, 127.0).to(torch.int8)
    return q.reshape(n), scales


def qsr_dequant_ref(q: torch.Tensor, scales: torch.Tensor,
                    block: int = QSR_BLOCK) -> torch.Tensor:
    """Inverse transform: (N,) int8 and (N/block,) float32 scales ->
    (N,) float32, ``q * scale[block]``."""
    n = q.shape[0]
    return (q.reshape(n // block, block).to(torch.float32)
            * scales[:, None]).reshape(n)
