"""Phi-3-vision (4.2B): phi3-mini text backbone + CLIP frontend (stubbed —
``input_specs`` supplies precomputed patch embeddings that overwrite the
first ``n_frontend_tokens`` positions).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,  # MHA
    d_ff=8192,
    vocab=32064,
    frontend="patch",
    n_frontend_tokens=576,  # 24x24 CLIP patch grid
)
