"""Compact control-plane path-quality representation (paper §3.2).

``C_path(p) = min((w_dl * delayScore(p) + w_lc * linkCapScore(p)) >> S_path, 255)``

Counterpart of ``repro/core/pathq.py`` (``calc_delay_cost``,
``calc_linkcap_cost``, ``calc_path_quality``, ``path_bottleneck_stats``),
integer-only and bit-exact with it. Functions follow their inputs' device.
"""
from __future__ import annotations

import dataclasses

import torch

from .tables import SCORE_MAX, level_score_table


@dataclasses.dataclass(frozen=True)
class PathQParams:
    """Integer weights/shifts for Eq. (2). Defaults = paper §7.3 best."""
    w_dl: int = 3
    w_lc: int = 1
    d_shift: int = 8     # delayScore = min(us >> d_shift, 255)

    @property
    def s_path(self) -> int:
        total = self.w_dl + self.w_lc
        return max(total - 1, 0).bit_length()


def calc_delay_cost(delay_us: torch.Tensor,
                    params: PathQParams = PathQParams()) -> torch.Tensor:
    """Alg. 1: saturating shift-based delay -> 0..255 score."""
    d = delay_us.to(torch.int32)
    return torch.clamp_max(d >> params.d_shift, SCORE_MAX).to(torch.int32)


def calc_linkcap_cost(cap_gbps: torch.Tensor,
                      cap_thresh: torch.Tensor) -> torch.Tensor:
    """Alg. 2: capacity class = count of boundaries <= cap, inverted so
    the fattest class costs 0."""
    cap = cap_gbps.to(torch.int32).contiguous()
    num_classes = cap_thresh.shape[0] + 1
    cls = torch.searchsorted(cap_thresh.contiguous(), cap, right=True)
    score_of_class = level_score_table(num_classes, device=cap.device)
    return score_of_class[num_classes - 1 - cls].to(torch.int32)


def calc_path_quality(delay_us: torch.Tensor, cap_gbps: torch.Tensor,
                      cap_thresh: torch.Tensor,
                      params: PathQParams = PathQParams()) -> torch.Tensor:
    """Eq. (2): fused, normalized C_path in [0, 255]."""
    ds = calc_delay_cost(delay_us, params)
    lc = calc_linkcap_cost(cap_gbps, cap_thresh)
    fused = params.w_dl * ds + params.w_lc * lc
    return torch.clamp_max(fused >> params.s_path, SCORE_MAX).to(torch.int32)


def path_bottleneck_stats(link_delay_us: torch.Tensor,
                          link_cap_gbps: torch.Tensor,
                          path_links: torch.Tensor, path_len: torch.Tensor):
    """Per-link attributes to per-path ``(delay = sum, cap = min)`` over
    each path's first ``path_len`` hops, both int32. ``path_links`` (P, H)
    link indices padded with -1. The control plane's refresh
    (``netsim.engine.ctrl_refresh``) passes *effective* capacities
    (degrade factors and liveness applied, 0 for a dead link)."""
    H = path_links.shape[-1]
    hop_valid = (torch.arange(H, device=path_links.device)[None, :]
                 < path_len[:, None])
    safe = torch.clamp_min(path_links, 0).long()
    d = torch.where(hop_valid, link_delay_us[safe], 0).sum(-1)
    c = torch.where(hop_valid, link_cap_gbps[safe],
                    torch.iinfo(torch.int32).max).amin(-1)
    return d.to(torch.int32), c.to(torch.int32)
