"""Architecture registry of the port: ``get(arch_id)``.

Counterpart of ``repro/configs``. Each ``<id>.py`` module exports CONFIG
(the full published configuration) and SMOKE (a reduced config of the
same family for CPU tests). The registry holds the reference's ten
configurations in its order, with its aliases.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "zamba2_1p2b", "gemma2_9b", "glm4_9b", "mistral_nemo_12b", "qwen3_4b",
    "internvl2_2b", "falcon_mamba_7b", "mixtral_8x7b", "dbrx_132b",
    "whisper_medium",
]

ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b", "gemma2-9b": "gemma2_9b",
    "glm4-9b": "glm4_9b", "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen3-4b": "qwen3_4b", "internvl2-2b": "internvl2_2b",
    "falcon-mamba-7b": "falcon_mamba_7b", "mixtral-8x7b": "mixtral_8x7b",
    "dbrx-132b": "dbrx_132b", "whisper-medium": "whisper_medium",
}


def get(arch_id: str, smoke: bool = False):
    mod_name = ALIASES.get(arch_id, arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False):
    return {a: get(a, smoke) for a in ARCH_IDS}
