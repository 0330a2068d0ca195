"""H2O-Danube3-4B: llama/mistral-mix dense GQA with sliding-window
attention — the SWA window makes it long_500k-eligible (O(w*S) attention).
[arXiv:2401.16818; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    window=4096,  # mistral-style SWA
)
