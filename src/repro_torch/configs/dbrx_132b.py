"""DBRX (132B total / 36B active): fine-grained MoE, 16 experts top-4.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
    period=("attn",),
    mlp_pattern=("moe",),
)
