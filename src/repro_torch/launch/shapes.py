"""Assigned input-shape cells (counterpart of ``repro/launch/shapes.py``),
as pure data.

Shapes (LM family):
  train_4k     seq=4096   global_batch=256   -> train_step
  prefill_32k  seq=32768  global_batch=32    -> prefill (forward, no bwd)
  decode_32k   seq=32768(KV) global_batch=128 -> serve_step (1 new token)
  long_500k    seq=524288(KV) global_batch=1  -> serve_step; SSM/hybrid only

long_500k is skipped for pure full-attention archs; every arch runs the
other three cells. ``input_specs`` gives the stand-ins of a cell's inputs
that the dry run (``launch/dryrun``) runs on: tensors without storage,
``meta`` tensors by default, or fake tensors when called under a
``FakeTensorMode`` with the mesh's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

# archs allowed to run long_500k (sub-quadratic / O(1)-state decode)
LONG_OK = {"zamba2-1.2b", "falcon-mamba-7b"}


def applicable(cfg, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.name in LONG_OK
    return True


def skip_reason(cfg, shape: str) -> Optional[str]:
    if applicable(cfg, shape):
        return None
    return ("full-attention arch: 500k-context decode requires "
            "sub-quadratic attention (DESIGN.md §4)")


def input_specs(cfg, cell: ShapeCell, *, device="meta") -> Dict:
    """Stand-ins for every model input of this cell, the reference's
    leaves in shape and dtype: ``tokens`` and ``labels`` (B, S) int32,
    and ``extra`` float32 for vlm (B, n_patches, D) and encdec
    (B, enc_seq, D); for decode ``tokens`` (B, 1) int32, a 0-d int32
    ``pos`` and the family's ``cache``."""
    from repro_torch.serve.decode import init_cache
    B, S = cell.batch, cell.seq

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    if cell.kind in ("train", "prefill"):
        batch = dict(tokens=sds((B, S), I32), labels=sds((B, S), I32))
        if cfg.family == "vlm":
            batch["extra"] = sds((B, cfg.n_patches, cfg.d_model), F32)
        if cfg.family == "encdec":
            batch["extra"] = sds((B, cfg.enc_seq, cfg.d_model), F32)
        return batch
    # decode: one new token against a seq-sized KV cache
    return dict(tokens=sds((B, 1), I32),
                pos=sds((), I32),
                cache=init_cache(cfg, B, S, device=device))
