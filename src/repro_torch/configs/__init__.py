"""Architecture registry of the port: ``get(arch_id)``.

Counterpart of ``repro/configs``. Each ``<id>.py`` module exports CONFIG
(the full published configuration) and SMOKE (a reduced config of the
same family for CPU tests). The registry holds the attention decoders:
the dense qwen3-4b, gemma2-9b, glm4-9b and mistral-nemo-12b and the moe
mixtral-8x7b and dbrx-132b. The ssm, hybrid, encdec and vlm
configurations (falcon-mamba-7b, zamba2-1.2b, whisper-medium,
internvl2-2b) wait for ROADMAP.md queue A item 11.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["gemma2_9b", "glm4_9b", "mistral_nemo_12b", "qwen3_4b",
            "mixtral_8x7b", "dbrx_132b"]

ALIASES = {"gemma2-9b": "gemma2_9b", "glm4-9b": "glm4_9b",
           "mistral-nemo-12b": "mistral_nemo_12b", "qwen3-4b": "qwen3_4b",
           "mixtral-8x7b": "mixtral_8x7b", "dbrx-132b": "dbrx_132b"}


def get(arch_id: str, smoke: bool = False):
    mod_name = ALIASES.get(arch_id, arch_id)
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ROADMAP.md, queue A item 11: "
            f"the ssm, hybrid, encdec and vlm families); the port runs "
            f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG
