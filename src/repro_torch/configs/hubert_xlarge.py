"""HuBERT X-Large (~1B): bidirectional encoder-only audio transformer (same
arch as wav2vec2).  The conv feature extractor is stubbed — ``input_specs``
supplies precomputed frame embeddings; the head classifies each frame over
the 504-unit codebook.  No decode shapes (encoder). [arXiv:2106.07447]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,  # MHA
    d_ff=5120,
    vocab=504,
    causal=False,
    frontend="frame",
    mlp_act="gelu",
)
