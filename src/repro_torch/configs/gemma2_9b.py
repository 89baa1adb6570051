"""gemma2-9b [dense]: local+global alternating attention with
logit softcaps [arXiv:2408.00118; hf]. 42L d_model=3584 16H (GQA kv=8)
d_ff=14336 vocab=256000, head_dim=256, window 4096 on local layers."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
    n_heads=16, n_kv=8, d_ff=14336, vocab=256000, head_dim=256,
    alt_local_global=True, window=4096, attn_softcap=50.0,
    final_softcap=30.0)

SMOKE = ArchConfig(
    name="gemma2-smoke", family="dense", n_layers=4, d_model=128,
    n_heads=4, n_kv=2, d_ff=256, vocab=512, head_dim=32,
    alt_local_global=True, window=32, attn_softcap=50.0,
    final_softcap=30.0)
