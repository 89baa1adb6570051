"""Wrappers of the hand-written CUDA int8 wire kernels.

Replace the Pallas TPU kernels ``src/repro/kernels/qsr_int8.py:41``
(``qsr_int8``, body ``_quant_kernel``) and ``:65`` (``qsr_dequant``,
body ``_dequant_kernel``); both live in ``csrc/qsr_int8.cu``, which
states what bounds them on the H100 (bytes) and what the design does
about that. For CPU tensors a wrapper runs the plain version
(``ref.qsr_int8_ref``, ``ref.qsr_dequant_ref``); for CUDA tensors it
launches the kernel or raises. ``qsr_int8.launches`` and
``qsr_dequant.launches`` count kernel launches only.

Random bits are a 4-byte tensor holding the uint32 pattern: int32 on the
card (``dist.compress.rand_bits`` makes them so); the plain version
also takes int64 values in [0, 2**32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

BLOCK = ref.QSR_BLOCK
_GRID_MAX = (1 << 31) - 1


def _check(fn: str, name: str, x: torch.Tensor, dtype, n: int,
           dev: torch.device, align: int) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != (n,) \
            or not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"({n},) on {dev}, {align}-byte aligned; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}"
            f"{' (misaligned)' if x.data_ptr() % align else ''}")


def _blocks(fn: str, n: int) -> int:
    if n % BLOCK:
        raise ValueError(f"{fn}: N={n} is not a multiple of {BLOCK}")
    if n // BLOCK > _GRID_MAX:
        raise ValueError(f"{fn}: N={n} exceeds the kernel's grid")
    return n // BLOCK


def qsr_int8(x: torch.Tensor, rand_bits: torch.Tensor):
    """x (N,) float32, rand_bits (N,) uint32 pattern, N % 1024 == 0 ->
    ``(q (N,) int8, scales (N/1024,) float32)``."""
    dev = x.device
    if dev.type == "cpu":
        return ref.qsr_int8_ref(x, rand_bits)
    if dev.type != "cuda":
        raise ValueError(f"qsr_int8: unsupported device {dev}")
    if x.dim() != 1:
        raise ValueError(f"qsr_int8: x must be 1-D, got {tuple(x.shape)}")
    n = x.shape[0]
    nb = _blocks("qsr_int8", n)
    _check("qsr_int8", "x", x, torch.float32, n, dev, 16)
    _check("qsr_int8", "rand_bits", rand_bits, torch.int32, n, dev, 16)
    q = torch.empty((n,), dtype=torch.int8, device=dev)
    scales = torch.empty((nb,), dtype=torch.float32, device=dev)
    if nb == 0:                 # nothing to quantize: no launch
        return q, scales
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.load("qsr_int8").qsr_int8_launch(
            nb, x.data_ptr(), rand_bits.data_ptr(), q.data_ptr(),
            scales.data_ptr(), stream)
    build.check(err, "qsr_int8")
    qsr_int8.launches += 1
    return q, scales


def qsr_dequant(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(N,) int8 and (N/1024,) float32 -> (N,) float32."""
    dev = q.device
    if dev.type == "cpu":
        return ref.qsr_dequant_ref(q, scales)
    if dev.type != "cuda":
        raise ValueError(f"qsr_dequant: unsupported device {dev}")
    if q.dim() != 1:
        raise ValueError(f"qsr_dequant: q must be 1-D, got {tuple(q.shape)}")
    n = q.shape[0]
    nb = _blocks("qsr_dequant", n)
    _check("qsr_dequant", "q", q, torch.int8, n, dev, 4)
    _check("qsr_dequant", "scales", scales, torch.float32, nb, dev, 4)
    x = torch.empty((n,), dtype=torch.float32, device=dev)
    if nb == 0:
        return x
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.load("qsr_int8").qsr_dequant_launch(
            nb, q.data_ptr(), scales.data_ptr(), x.data_ptr(), stream)
    build.check(err, "qsr_dequant")
    qsr_dequant.launches += 1
    return x


qsr_int8.launches = 0
qsr_dequant.launches = 0
