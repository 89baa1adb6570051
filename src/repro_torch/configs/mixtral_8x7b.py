"""mixtral-8x7b [moe]: 8 experts top-2, SWA
[arXiv:2401.04088; hf]. 32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=32000, n_experts=8, top_k=2,
    window=4096)

SMOKE = ArchConfig(
    name="mixtral-smoke", family="moe", n_layers=3, d_model=128,
    n_heads=4, n_kv=2, d_ff=256, vocab=512, n_experts=4, top_k=2,
    window=32)
