"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1) ff=12288
vocab=256000; Griffin pattern (rec, rec, local-attn) with window 2048.
[arXiv:2402.19427; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, head_dim=256,
    window=2048, attn_every=3, conv_width=4, tie_embeddings=True,
)
