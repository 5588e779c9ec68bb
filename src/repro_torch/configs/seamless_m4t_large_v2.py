"""seamless-m4t-large-v2 [audio]: enc-dec, 24L decoder (+24L encoder)
d=1024 16H (kv=16) ff=8192 vocab=256206; audio frontend is a STUB
(precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206, head_dim=64,
    encoder_layers=24, frontend="audio",
)
