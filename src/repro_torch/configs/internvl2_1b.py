"""internvl2-1b [vlm]: 24L d=896 14H (GQA kv=2) ff=4864 vocab=151655;
InternViT frontend is a STUB (precomputed patch embeddings, 256 tokens).
[arXiv:2404.16821; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896, n_heads=14,
    n_kv_heads=2, d_ff=4864, vocab=151655, head_dim=64,
    frontend="vision", frontend_tokens=256, rope_theta=1_000_000.0,
    tie_embeddings=True,
)
