"""zamba2-1.2b [hybrid]: Mamba2 + shared attention blocks
[arXiv:2411.15242; hf]. 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64. The shared transformer block fires every 6
Mamba2 layers; at 500k context the shared attention runs sliding-window
(sub-quadratic) — see DESIGN.md arch table."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32000, ssm_state=64,
    shared_attn_every=6, window=4096)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid", n_layers=4, d_model=128,
    n_heads=4, n_kv=4, d_ff=256, vocab=512, ssm_state=16,
    shared_attn_every=2, window=64)
