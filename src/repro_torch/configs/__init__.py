"""Architecture registry of the port: ``get(arch_id)``.

Counterpart of ``repro/configs``. Each ``<id>.py`` module exports CONFIG
(the full published configuration) and SMOKE (a reduced config of the
same family for CPU tests). The registry lists only what the port
holds: qwen3-4b, and gemma2-9b, whose parameter count the training
co-simulation reads (its forward waits for ROADMAP.md queue A item 11);
the other families wait for that item.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["gemma2_9b", "qwen3_4b"]

ALIASES = {"gemma2-9b": "gemma2_9b", "qwen3-4b": "qwen3_4b"}


def get(arch_id: str, smoke: bool = False):
    mod_name = ALIASES.get(arch_id, arch_id)
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ROADMAP.md, queue A item 11); "
            f"the port runs {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG
