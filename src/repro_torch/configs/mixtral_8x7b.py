"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) ff=14336 vocab=32000;
8 experts top-2, sliding-window attention (4096). [arXiv:2401.04088; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=32000, head_dim=128,
    n_experts=8, top_k=2, window=4096,
)
