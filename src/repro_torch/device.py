"""The port's one device rule.

Entry points take a ``device`` argument that defaults to ``"cuda"``.
Without a card they raise, unless the caller asks for the CPU
explicitly (the CPU tests pass ``device="cpu"``); nothing falls back to
the CPU on its own.
"""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``device`` (str or ``torch.device``) -> ``torch.device``, raising
    when it names CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU with the kernels' plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def resolve_or_meta(device=DEFAULT) -> torch.device:
    """``resolve``, but a ``"meta"`` device (shapes without storage, which
    no kernel reads) passes through as it is."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve(dev)
