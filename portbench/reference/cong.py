"""Realtime on-switch congestion estimator (paper §3.3), as int32 torch ops.

Counterpart of ``repro/core/cong.py``. Per egress port the switch keeps
the registers of ``CongState`` and derives three 8-bit signals:

- Q : instantaneous queue level (qThresh lookup -> levelScore)
- T : short-term trend (shift EWMA, Eq. 3, per-rate thresholds; <=0 -> 0)
- D : duration counter (+1 at or above high water, halved otherwise)

``C_cong = min((w_ql*Q + w_tl*T + w_dp*D) >> S_cong, 255)`` (Eqs. 4-5).

All shifts are arithmetic on int32 (``trend`` goes negative), as in the
reference.
"""
from __future__ import annotations

import dataclasses

import torch

from .tables import SCORE_MAX, SwitchTables


@dataclasses.dataclass(frozen=True)
class CongParams:
    """Integer weights/shifts. Defaults = paper §7.4 recommended (2,1,1)."""
    w_ql: int = 2
    w_tl: int = 1
    w_dp: int = 1
    ewma_k: int = 3      # Eq. 3 K
    dur_shift: int = 2

    @property
    def s_cong(self) -> int:
        total = self.w_ql + self.w_tl + self.w_dp
        return max(total - 1, 0).bit_length()


@dataclasses.dataclass
class CongState:
    """Per-port registers (struct of (num_ports,) int32 tensors)."""
    queue_cur: torch.Tensor    # cells (last sampled)
    queue_prev: torch.Tensor   # cells (previous sample)
    trend: torch.Tensor        # EWMA accumulator (cells/interval)
    dur_cnt: torch.Tensor      # persistence counter
    last_sample: torch.Tensor  # microseconds

    @classmethod
    def init(cls, num_ports: int, device="cpu") -> "CongState":
        device = torch.device(device)

        def z():
            return torch.zeros((num_ports,), dtype=torch.int32, device=device)
        return cls(queue_cur=z(), queue_prev=z(), trend=z(), dur_cnt=z(),
                   last_sample=z())


def _searchsorted_rows(thresh: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-wise count of thresholds <= x: thresh (..., B), x (...,)."""
    return (thresh <= x[..., None]).sum(-1).to(torch.int32)


def monitor_update(state: CongState, queue_cells: torch.Tensor, now_us: int,
                   tables: SwitchTables,
                   params: CongParams = CongParams()) -> CongState:
    """One monitor pass: Eq. 3 trend, duration counter, register shift."""
    q = queue_cells.to(torch.int32)
    delta = q - state.queue_cur
    k = params.ewma_k
    # Eq. (3): T = T_old - (T_old >> K) + (delta >> K)  (arithmetic shifts)
    trend = state.trend - (state.trend >> k) + (delta >> k)

    q_level = _searchsorted_rows(tables.q_thresh, q)
    above = q_level >= tables.high_water_level
    dur = torch.where(above, state.dur_cnt + 1, state.dur_cnt >> 1)

    return CongState(
        queue_cur=q,
        queue_prev=state.queue_cur,
        trend=trend,
        dur_cnt=dur.to(torch.int32),
        last_sample=torch.full_like(state.last_sample, int(now_us)),
    )


def cong_signals(state: CongState, tables: SwitchTables,
                 params: CongParams = CongParams()):
    """The quantized (Q, T, D) score triple from current registers."""
    q_level = _searchsorted_rows(tables.q_thresh, state.queue_cur)
    q_score = tables.level_score[q_level]

    t_level = _searchsorted_rows(tables.trend_thresh, state.trend)
    t_score = torch.where(state.trend > 0, tables.level_score[t_level], 0)

    d_score = torch.clamp_max(state.dur_cnt >> params.dur_shift, SCORE_MAX)
    return (q_score.to(torch.int32), t_score.to(torch.int32),
            d_score.to(torch.int32))


def calc_cong_cost(state: CongState, tables: SwitchTables,
                   params: CongParams = CongParams()) -> torch.Tensor:
    """Eqs. (4)-(5): fused, normalized per-port C_cong in [0, 255]."""
    q, t, d = cong_signals(state, tables, params)
    fused = params.w_ql * q + params.w_tl * t + params.w_dp * d
    return torch.clamp_max(fused >> params.s_cong, SCORE_MAX).to(torch.int32)
