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
