"""internvl2-2b [vlm]: InternViT frontend (STUB — precomputed
patch embeddings) + InternLM2 backbone [arXiv:2404.16821; hf].
24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92553, 256 patch tokens."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv=8, d_ff=8192, vocab=92553, n_patches=256)

SMOKE = ArchConfig(
    name="internvl2-smoke", family="vlm", n_layers=3, d_model=128,
    n_heads=4, n_kv=2, d_ff=256, vocab=512, n_patches=16)
