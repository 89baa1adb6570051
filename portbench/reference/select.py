"""Fused cost + diversity-preserving selection (paper §3.1.1 Eq. 1, §3.4).

Counterpart of ``repro/core/select.py`` (``fmix32``, ``select_egress``
with and without ``weights``, ``ecmp_select``), bit-exact with it.

Torch has almost no uint32 arithmetic, so 32-bit hash values live in
int64 tensors holding [0, 2**32). ``fmix32``'s multiplies would overflow
int64 (a 32-bit value times a 32-bit constant), so each constant is split
into 16-bit halves and the product is assembled modulo 2**32 from parts
below 2**49; every value stays non-negative before each ``>>``.
"""
from __future__ import annotations

import dataclasses

import torch

from .tables import SCORE_MAX

COST_INVALID = 1 << 24   # sentinel far above any fusable cost
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SelectParams:
    """Defaults = paper §5/§7: (alpha, beta) = (3, 1); keep lower 50%."""
    alpha: int = 3
    beta: int = 1
    keep_num: int = 2          # keep ceil(m/keep_num): 2 -> lower half
    cong_fallback: int = 230   # "all highly congested" bar


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 finalizer over the low 32 bits of an integer tensor,
    as unsigned values in int64 [0, 2**32)."""
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def fused_cost(c_path: torch.Tensor, c_cong: torch.Tensor,
               params: SelectParams = SelectParams()) -> torch.Tensor:
    """Eq. (1) over broadcastable int32 score tensors."""
    return (params.alpha * c_path.to(torch.int32)
            + params.beta * c_cong.to(torch.int32))


def select_egress(flow_ids: torch.Tensor, c_path: torch.Tensor,
                  c_cong: torch.Tensor, valid: torch.Tensor,
                  params: SelectParams = SelectParams(), weights=None):
    """Two-stage diversity-preserving selection.

    ``flow_ids`` (F,) integer ids (uint32 values); ``c_path``/``c_cong``/
    ``valid`` (F, P) or (P,). Returns ``(choice (F,) int32, cost (F, P)
    int32)`` with -1 where no candidate is valid. ``weights`` (F, P) or
    (P,) integers make the stage-2 hash inside the kept set weighted (the
    beyond-paper ``lcmp_w``): the weights in rank order, ``max(w, 1)``
    inside the kept prefix and 0 outside, and the pick rank is the count
    of their cumulative sums ``<= int32(fmix32(id) >> 1) % total``.
    """
    F = flow_ids.shape[0]
    cost = fused_cost(c_path, c_cong, params)
    P = cost.shape[-1]
    cost = cost.expand(F, P)
    valid = valid.to(torch.bool).expand(F, P)
    c_cong_b = c_cong.to(torch.int32).expand(F, P)

    cost = torch.where(valid, cost, COST_INVALID)

    # stage 1: rank by cost; the index in the low bits breaks ties
    key = cost * P + torch.arange(P, dtype=torch.int32, device=cost.device)
    order = torch.argsort(key, dim=-1, stable=True)          # (F, P) int64

    num_valid = valid.sum(-1).to(torch.int32)
    keep = torch.clamp_min(
        torch.div(num_valid + params.keep_num - 1, params.keep_num,
                  rounding_mode="floor"), 1)

    # stage 2: hash-ECMP inside the kept lowest-cost prefix
    h = fmix32(flow_ids)
    if weights is None:
        pick_rank = h % keep.to(torch.int64)
    else:
        w_sorted = weights.to(torch.int32).expand(F, P).gather(-1, order)
        in_keep = (torch.arange(P, device=cost.device)[None, :]
                   < keep[:, None])
        w_kept = torch.where(in_keep, torch.clamp_min(w_sorted, 1), 0)
        cum = torch.cumsum(w_kept, dim=-1)
        hv = (h >> 1) % torch.clamp_min(cum[:, -1], 1)
        pick_rank = (cum <= hv[:, None]).sum(-1)
    hashed_choice = order.gather(-1, pick_rank[:, None])[:, 0]

    # fallback: all candidates highly congested -> argmin fused cost
    min_cong = torch.where(valid, c_cong_b, SCORE_MAX + 1).amin(-1)
    all_bad = min_cong >= params.cong_fallback
    choice = torch.where(all_bad, order[:, 0], hashed_choice)

    choice = torch.where(num_valid > 0, choice, -1)
    return choice.to(torch.int32), cost


def ecmp_select(flow_ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain ECMP: uniform hash over *all* valid candidates (baseline)."""
    F = flow_ids.shape[0]
    valid = valid.to(torch.bool)
    P = valid.shape[-1]
    valid = valid.expand(F, P)
    num_valid = valid.sum(-1)                                  # int64
    slot = torch.arange(P, dtype=torch.int64, device=valid.device)
    order = torch.argsort(torch.where(valid, 0, 1) * P + slot, dim=-1,
                          stable=True)
    rank = fmix32(flow_ids) % torch.clamp_min(num_valid, 1)
    choice = order.gather(-1, rank[:, None])[:, 0]
    return torch.where(num_valid > 0, choice, -1).to(torch.int32)
