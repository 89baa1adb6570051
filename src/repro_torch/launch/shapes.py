"""Assigned input-shape cells (counterpart of ``repro/launch/shapes.py``),
as pure data.

Shapes (LM family):
  train_4k     seq=4096   global_batch=256   -> train_step
  prefill_32k  seq=32768  global_batch=32    -> prefill (forward, no bwd)
  decode_32k   seq=32768(KV) global_batch=128 -> serve_step (1 new token)
  long_500k    seq=524288(KV) global_batch=1  -> serve_step; SSM/hybrid only

long_500k is skipped for pure full-attention archs; every arch runs the
other three cells. The reference's ``input_specs`` (the abstract inputs
the dry-run lowers) waits for ``launch/dryrun`` (ROADMAP.md queue A
item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
