"""qwen3-4b [dense]: qk-norm + GQA [hf:Qwen/Qwen3-8B family].
36L d_model=2560 32H (kv=8) d_ff=9728 vocab=151936."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
    n_heads=32, n_kv=8, d_ff=9728, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0)

SMOKE = ArchConfig(
    name="qwen3-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=4, n_kv=2, d_ff=256, vocab=512, qk_norm=True)
