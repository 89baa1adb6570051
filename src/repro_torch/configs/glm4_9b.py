"""glm4-9b [dense]: RoPE, extreme GQA (kv=2)
[hf:THUDM/glm-4-9b; hf]. 40L d_model=4096 32H d_ff=13696 vocab=151552."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv=2, d_ff=13696, vocab=151552)

SMOKE = ArchConfig(
    name="glm4-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=8, n_kv=2, d_ff=256, vocab=512)
