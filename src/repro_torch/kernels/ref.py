"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro/kernels/ref.py``: the reference semantics, built
on the ported ``core`` so each kernel is pinned to the same decision
path the engine uses. The kernel wrappers run these for CPU tensors;
the CUDA kernels must match them bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import cong as congmod
from repro_torch.core import select as selmod
from repro_torch.core.cong import CongParams, CongState
from repro_torch.core.select import SelectParams
from repro_torch.core.tables import SwitchTables


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
