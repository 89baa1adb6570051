"""mistral-nemo-12b [dense]: 128k ctx, head_dim 128
(d_model 5120 with 32x128 attention) [hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv=8, d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1_000_000.0)

SMOKE = ArchConfig(
    name="nemo-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=4, n_kv=2, d_ff=256, vocab=512, head_dim=64,
    rope_theta=1_000_000.0)
