"""PyTorch/CUDA port of the ``repro`` model zoo for one NVIDIA H100.

Beside the JAX package ``repro`` (the reference), never importing it or JAX.
This slice serves the dense decoder (prefill + greedy decode) through a
hand-written Hopper flash-attention kernel (``csrc/flash_attention.cu``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.model import DecoderLM
from repro_torch.serving import GenerationResult, ServeEngine
from repro_torch.weights import params_from_reference, params_to_numpy
