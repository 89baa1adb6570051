"""falcon-mamba-7b [ssm]: attention-free Mamba-1
[arXiv:2410.05355]. 64L d_model=4096 vocab=65024, ssm_state=16."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv=1, d_ff=0, vocab=65024, ssm_state=16,
    mamba_version=1)

SMOKE = ArchConfig(
    name="falcon-mamba-smoke", family="ssm", n_layers=3, d_model=128,
    n_heads=1, n_kv=1, d_ff=0, vocab=512, ssm_state=8, mamba_version=1)
