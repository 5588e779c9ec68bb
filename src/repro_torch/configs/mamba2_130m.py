"""mamba2-130m [ssm]: 24L d=768, attention-free SSD, ssm_state=128
vocab=50280. [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, ssm_state=128, conv_width=4,
    tie_embeddings=True,
)
