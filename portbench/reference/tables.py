"""Control-plane bootstrap tables (paper §3.1.2, Fig. 3), as int32 tensors.

Counterpart of ``repro/core/tables.py``: the same integer vectors, built
with the same integer arithmetic. Queue depths are in **cells of
1 KiB**, as switch ASICs count them.

``SwitchTables.high_water_level`` is a Python int here (a () int32 array
in the reference): the CUDA monitor kernel takes it as a launch argument,
and reading a device scalar every step would sync the host.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


SCORE_MAX = 255          # all scores are 8-bit quantities (paper: 0-255)
CELL_BYTES = 1024        # queue accounting granularity (1 cell = 1 KiB)


def bytes_to_cells(b, device="cpu") -> torch.Tensor:
    """Bytes -> int32 cells (floor). A Python int or float gives a 0-d
    tensor of ``int(b) // CELL_BYTES`` on ``device``; a tensor or array
    gives float32 ``b / CELL_BYTES`` truncated to int32, on the tensor's
    own device (an array's on ``device``), as the reference computes it."""
    if isinstance(b, (int, float)):
        return torch.tensor(int(b) // CELL_BYTES, dtype=torch.int32,
                            device=torch.device(device))
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b, np.float32),
                            device=torch.device(device))
    return (b.to(torch.float32) / CELL_BYTES).to(torch.int32)


def level_score_table(num_levels: int,
                      device="cpu") -> torch.Tensor:
    """Linear map from level index to a 0-255 score (paper §3.1.2)."""
    device = torch.device(device)
    if num_levels < 2:
        return torch.zeros((max(num_levels, 1),), dtype=torch.int32,
                           device=device)
    idx = torch.arange(num_levels, dtype=torch.int32, device=device)
    return torch.div(idx * SCORE_MAX, num_levels - 1, rounding_mode="floor")


def capacity_class_thresholds(max_capacity_gbps: int, num_classes: int = 10,
                              device="cpu") -> torch.Tensor:
    """(num_classes-1,) increasing Gbps class boundaries."""
    device = torch.device(device)
    cls = torch.arange(1, num_classes, dtype=torch.int32, device=device)
    return torch.div(cls * max_capacity_gbps, num_classes,
                     rounding_mode="floor")


def queue_thresholds(buffer_bytes: int, num_levels: int = 16,
                     device="cpu") -> torch.Tensor:
    """Doubling ladder of queue-cell boundaries, top = full buffer."""
    device = torch.device(device)
    buffer_cells = max(buffer_bytes // CELL_BYTES, num_levels)
    th = [max(buffer_cells >> (num_levels - 1 - i), 1)
          for i in range(1, num_levels)]
    return torch.tensor(th, dtype=torch.int32, device=device)


def trend_thresholds(link_rate_gbps: int, sample_interval_us: int,
                     num_levels: int = 16) -> list:
    """Per-rate trend boundaries (Python ints), ramping linearly to 50%
    of the per-interval line-rate cells."""
    cells_per_interval = ((link_rate_gbps * 10**9 // 8) * sample_interval_us
                          // 1_000_000) // CELL_BYTES
    return [(i * (cells_per_interval // 2)) // (num_levels - 1)
            for i in range(1, num_levels)]


@dataclasses.dataclass(frozen=True)
class SwitchTables:
    """Everything the control plane installs at bootstrap (Fig. 3)."""
    cap_thresh: torch.Tensor     # (num_classes-1,) int32 Gbps boundaries
    level_score: torch.Tensor    # (num_levels,)    int32 0..255
    q_thresh: torch.Tensor       # (num_levels-1,)  int32 cells
    trend_thresh: torch.Tensor   # (num_ports, num_levels-1) int32 per port
    high_water_level: int        # D counter arms at or above this Q level

    @property
    def num_levels(self) -> int:
        return self.level_score.shape[0]


def bootstrap_tables(port_rates_gbps: Sequence[int], *,
                     buffer_bytes: int = 6 * 10**9,
                     sample_interval_us: int = 100,
                     num_classes: int = 10,
                     num_levels: int = 16,
                     max_capacity_gbps: int = 400,
                     high_water_frac: float = 0.625,
                     device="cpu") -> SwitchTables:
    """The full bootstrap table set for one DCI switch, on ``device``."""
    dev = torch.device(device)
    trend = torch.tensor([trend_thresholds(r, sample_interval_us, num_levels)
                          for r in port_rates_gbps], dtype=torch.int32,
                         device=dev).reshape(-1, num_levels - 1)
    return SwitchTables(
        cap_thresh=capacity_class_thresholds(max_capacity_gbps, num_classes,
                                             device=dev),
        level_score=level_score_table(num_levels, device=dev),
        q_thresh=queue_thresholds(buffer_bytes, num_levels, device=dev),
        trend_thresh=trend,
        high_water_level=int(high_water_frac * (num_levels - 1)),
    )
