"""Command-R (35B): dense GQA, 256k vocab, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
)
