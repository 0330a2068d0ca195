"""Jamba 1.5 Large (398B total / ~94B active) — hybrid Mamba+attention 1:7
interleave with MoE every other layer. [arXiv:2403.19887 / 2408.12570; hf]

Period of 8 layers: attention at position 4 (1:7 attn:mamba), channel mixers
alternate dense-MLP / MoE (16 experts, top-2).  The paper series uses
Mamba-1 mixers; our zoo implements the Mamba-2 (SSD) mixer — recorded as an
adaptation in DESIGN.md §7 (same state-space recurrence family, TPU-native
chunked form).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    period=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
    mlp_pattern=("mlp", "moe", "mlp", "moe", "mlp", "moe", "mlp", "moe"),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
)
