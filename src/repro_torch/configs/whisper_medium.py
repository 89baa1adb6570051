"""whisper-medium [audio]: enc-dec, conv frontend STUB
(precomputed frame embeddings) [arXiv:2212.04356]. 24L enc + 24L dec,
d_model=1024 16H (kv=16) d_ff=4096 vocab=51865, enc_seq=1500."""
from repro_torch.models.arch import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv=16, d_ff=4096, vocab=51865, n_enc_layers=24,
    enc_seq=1500)

SMOKE = ArchConfig(
    name="whisper-smoke", family="encdec", n_layers=3, d_model=128,
    n_heads=4, n_kv=4, d_ff=256, vocab=512, n_enc_layers=2, enc_seq=32)
