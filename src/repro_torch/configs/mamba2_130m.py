"""Mamba2-130M: attention-free SSD (state-space duality) stack.
24 layers, d_model 768, d_state 128, head_dim 64 (H=24), no MLP blocks,
tied embeddings. [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    d_ff=0,
    vocab=50280,
    period=("ssm",),
    mlp_pattern=("none",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
)
