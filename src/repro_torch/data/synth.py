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
    one, -1 at the last position}`` on ``device``; for the vlm family
    also ``"extra"``, patch embeddings (batch, n_patches, d_model), and
    for encdec frame embeddings (batch, enc_seq, d_model): float32
    normal x 0.02, drawn after the tokens from the same generator."""
    dev = devmod.resolve(device)
    key = np.random.SeedSequence([seed, step, host]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(key[0] >> np.uint64(1)))
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           dtype=torch.int64)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    out = dict(tokens=tokens.to(dev), labels=labels.to(dev))
    n_extra = {"vlm": cfg.n_patches, "encdec": cfg.enc_seq}.get(cfg.family)
    if n_extra is not None:
        extra = torch.randn((batch, n_extra, cfg.d_model), generator=gen,
                            dtype=torch.float32) * 0.02
        out["extra"] = extra.to(dev)
    return out
