"""int8 + per-block-scale wire format for cross-pod gradient buckets.

Counterpart of ``repro/dist/compress.py``. Wire layout for a flat f32
vector of N elements:
  q      (Np,)         int8   stochastically rounded mantissas
  scales (Np/1024,)    f32    per-1024-element block scales (amax/127)
with Np = N rounded up to a 1024 multiple, so the wire carries
``N + 4*N/1024`` bytes instead of ``4*N``, 3.98x fewer on the long haul.

Quantization runs through ``kernels.ops.qsr_int8`` (the CUDA kernel on
the card, its plain version on the CPU) with random bits from
``rand_bits``, a counter-based stream that equals the reference's bit for
bit. ``encode_ef`` returns the representation residual, so the caller can
fold it into the next step's gradient (error feedback).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as devmod
from repro_torch.core.select import fmix32, mul32
from repro_torch.kernels import ops
from repro_torch.kernels.qsr_int8 import BLOCK

RAND_CHUNK = 1 << 24        # elements hashed per pass of ``rand_bits``
_M32 = 0xFFFFFFFF
_GOLDEN = 2654435761        # Knuth's multiplicative constant


class Wire(NamedTuple):
    """One compressed bucket as it crosses the long haul."""
    q: torch.Tensor        # (Np,) int8
    scales: torch.Tensor   # (Np/BLOCK,) f32
    orig_len: int          # valid prefix of q (the rest is padding)


def padded_len(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def rand_bits(n: int, seed, salt=0, *, device=devmod.DEFAULT) -> torch.Tensor:
    """Counter-based uint32 stream for the stochastic rounding, as an (n,)
    int32 tensor holding each uint32 pattern (two's complement): element
    i is ``fmix32((i * 2654435761) ^ seed ^ fmix32(salt + 1))``, all mod
    2**32, as the reference computes it.

    ``fmix32`` emulates uint32 in int64 and makes several int64
    temporaries, so the stream is hashed ``RAND_CHUNK`` elements at a time
    into the one 4-byte output: memory is 4n bytes plus a few 2**24-element
    int64 temporaries (under 1 GB), whatever n is.
    """
    dev = devmod.resolve(device)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    mix = int(fmix32(torch.tensor([(int(salt) + 1) & _M32]))[0])
    key = (int(seed) & _M32) ^ mix
    for s in range(0, n, RAND_CHUNK):
        e = min(s + RAND_CHUNK, n)
        ctr = torch.arange(s, e, dtype=torch.int64, device=dev)
        h = fmix32(mul32(ctr, _GOLDEN) ^ key)
        out[s:e] = h - ((h >> 31) << 32)        # uint32 -> int32 pattern
    return out


def encode(x: torch.Tensor, *, seed=0, salt=0) -> Wire:
    """Flat f32 (N,) -> Wire. Pads with zeros up to the block size."""
    n = x.shape[0]
    np_ = padded_len(n)
    xf = x.to(torch.float32).contiguous()
    if np_ != n:
        xf = torch.cat([xf, xf.new_zeros((np_ - n,))])
    q, scales = ops.qsr_int8(xf, rand_bits(np_, seed, salt, device=x.device))
    return Wire(q=q, scales=scales, orig_len=n)


def decode(w: Wire) -> torch.Tensor:
    return ops.qsr_dequant(w.q, w.scales)[: w.orig_len]


def wire_bytes(w: Wire) -> int:
    return int(w.q.numel()) + 4 * int(w.scales.numel())


def encode_ef(x: torch.Tensor, residual: torch.Tensor, *, seed=0,
              salt=0) -> tuple:
    """Error-feedback encode: compress ``x + residual`` and return the
    new residual ``(x + residual) - decode(wire)`` to carry forward."""
    y = x.to(torch.float32) + residual.to(torch.float32)
    w = encode(y, seed=seed, salt=salt)
    return w, y - decode(w)
