"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) ff=15360 vocab=262144;
5:1 local:global (window 1024), 128k context. [hf:google/gemma-3-1b-pt;
unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840, n_heads=16,
    n_kv_heads=8, d_ff=15360, vocab=262144, head_dim=256, qk_norm=True,
    window=1024, local_global_ratio=5, rope_theta=1_000_000.0,
    tie_embeddings=True,
)
