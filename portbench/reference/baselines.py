"""Routing baselines the paper compares against (§6.1): ECMP, WCMP, UCMP,
a RedTE-like coarse-timescale policy, a FatPaths-style layered scheme and
MatchRDMA-style per-span rate matching.

Counterpart of ``repro/core/baselines.py``, bit-exact with it. Integer
torch ops; 32-bit hash values are int64 tensors holding [0, 2**32), as
in ``core.select``. Each baseline keeps the reference's signature
    ``choose(flow_ids, path_delay_us, path_cap_gbps, valid, **state) -> idx``
and returns (F,) int32 candidate indices, -1 where none is valid.
RedTE's split weights are engine state (``SimState.redte_w``, set by
``netsim.engine.redte_tick`` from ``redte_weights``) and its choice is
``_weighted_hash`` over them, so the reference's ``RedTEState``,
``redte_update`` and ``redte`` have no counterpart here.
"""
from __future__ import annotations

import torch

from .select import ecmp_select, fmix32

BIG = 1 << 30


def _rows(x: torch.Tensor, F: int) -> torch.Tensor:
    """(P,) or (F, P) -> (F, P) view."""
    return x.expand(F, x.shape[-1])


def ecmp(flow_ids, path_delay_us, path_cap_gbps, valid):
    """Oblivious equal-cost hashing over all candidates (RFC 2992)."""
    del path_delay_us, path_cap_gbps
    return ecmp_select(flow_ids, valid)


def _weighted_hash(flow_ids, weights, valid):
    """Pick candidate i with probability weight_i / sum(weights) by a
    deterministic per-flow hash: the count of cumulative weights <= h,
    ``h = int32(fmix32(id) >> 1) % total`` (zero-weight slots count too)."""
    F = flow_ids.shape[0]
    w = torch.where(valid.to(torch.bool),
                    torch.clamp_min(weights.to(torch.int32), 1), 0)
    cum = torch.cumsum(_rows(w, F), dim=-1)
    total = cum[:, -1]
    h = (fmix32(flow_ids) >> 1) % torch.clamp_min(total, 1)
    choice = (cum <= h[:, None]).sum(-1)
    return torch.where(total > 0, choice, -1).to(torch.int32)


def wcmp(flow_ids, path_delay_us, path_cap_gbps, valid):
    """WCMP: static weights proportional to provisioned capacity."""
    del path_delay_us
    return _weighted_hash(flow_ids, path_cap_gbps, valid)


def _rotated_argmin(flow_ids, cost, valid):
    """The first least ``cost`` over the candidates rotated by
    ``fmix32(id) % P`` (P the full width, pads included); -1 where no
    candidate is valid."""
    F = flow_ids.shape[0]
    cost = _rows(cost, F)
    P = cost.shape[-1]
    rot = fmix32(flow_ids) % P
    idx = (torch.arange(P, dtype=torch.int64, device=cost.device)[None, :]
           + rot[:, None]) % P
    best = torch.argmin(cost.gather(-1, idx), dim=-1)   # first minimum
    choice = idx.gather(-1, best[:, None])[:, 0]
    any_valid = _rows(valid.to(torch.bool), F).any(-1)
    return torch.where(any_valid, choice, -1).to(torch.int32)


def ucmp(flow_ids, path_delay_us, path_cap_gbps, valid,
         wait_cost_us: int = 0):
    """UCMP-style uniform cost: ``wait + 1_000_000 // cap`` in integers,
    the cheapest valid candidate, ties broken by a hashed rotation."""
    del path_delay_us
    cap = torch.clamp_min(path_cap_gbps.to(torch.int32), 1)
    cost = wait_cost_us + torch.div(1_000_000, cap, rounding_mode="floor")
    cost = torch.where(valid.to(torch.bool), cost, BIG)
    return _rotated_argmin(flow_ids, cost, valid)


def fatpaths(flow_ids, path_len, valid, c_cong, cong_thresh: int = 230):
    """FatPaths-style layered routing: hash uniformly inside the valid
    candidates of minimal hop count, spilling to every valid candidate
    when each of those has ``c_cong >= cong_thresh``."""
    F = flow_ids.shape[0]
    plen = _rows(path_len.to(torch.int32), F)
    valid = _rows(valid.to(torch.bool), F)
    cong = _rows(c_cong.to(torch.int32), F)
    minlen = torch.where(valid, plen, BIG).amin(-1)
    layer0 = valid & (plen == minlen[:, None])
    spill = torch.where(layer0, cong, BIG).amin(-1) >= cong_thresh
    return ecmp_select(flow_ids, torch.where(spill[:, None], valid, layer0))


def matchrdma(flow_ids, span_avail, valid):
    """MatchRDMA-style segmented rate matching: the candidate whose
    matched rate ``span_avail`` (int32) is largest, ties broken by the
    same hashed rotation as ``ucmp``."""
    cost = torch.where(valid.to(torch.bool), -span_avail.to(torch.int32), BIG)
    return _rotated_argmin(flow_ids, cost, valid)


def redte_weights(path_util_q8: torch.Tensor) -> torch.Tensor:
    """RedTE's periodic re-optimization: split weights proportional to
    each path's headroom, ``max(256 - util_q8, 1)`` (int32). The choice
    is ``_weighted_hash`` over them."""
    return torch.clamp_min(256 - path_util_q8.to(torch.int32), 1)
