"""Deterministic synthetic token pipeline (restart-safe).

Counterpart of ``repro/data/synth.py``: every batch is a pure function
of ``(seed, step, host)``, so a restarted run resumes the same sample
stream with no loader state. The stream comes from a ``torch.Generator``
seeded from those three numbers and cannot equal JAX's PRNG; parity
tests hand both packages the same numpy batch instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.models.arch import ArchConfig


def batch_at(cfg: ArchConfig, step: int, *, batch: int, seq: int,
             seed: int = 0, host: int = 0, device=devmod.DEFAULT):
    """``{"tokens": (batch, seq) int64, "labels": tokens shifted left by
    one, -1 at the last position}`` on ``device``."""
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(
            f"the {cfg.family} family's extra inputs (patch or frame "
            "embeddings) are not ported yet (ROADMAP.md, queue A item 11); "
            "batch_at serves the token-only families")
    dev = devmod.resolve(device)
    key = np.random.SeedSequence([seed, step, host]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(key[0] >> np.uint64(1)))
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           dtype=torch.int64)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    return dict(tokens=tokens.to(dev), labels=labels.to(dev))
