"""Phi-3.5-MoE (42B total / 6.6B active): 16 experts top-2, every layer MoE.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    period=("attn",),
    mlp_pattern=("moe",),
)
