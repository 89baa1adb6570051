"""dbrx-132b [moe]: 16 experts top-4, fine-grained
[hf:databricks/dbrx-base]. 40L d_model=6144 48H (kv=8) d_ff=10752
vocab=100352."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv=8, d_ff=10752, vocab=100352, n_experts=16, top_k=4)

SMOKE = ArchConfig(
    name="dbrx-smoke", family="moe", n_layers=3, d_model=128,
    n_heads=8, n_kv=2, d_ff=256, vocab=512, n_experts=4, top_k=2)
