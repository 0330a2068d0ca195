"""PyTorch/CUDA port of the ``repro`` model zoo for one NVIDIA H100.

Beside the JAX package ``repro`` (the reference), never importing it or JAX.
It serves the dense decoders and mamba2-130m (prefill + greedy decode)
through hand-written Hopper kernels: flash attention
(``csrc/flash_attention.cu``) and the Mamba-2 SSD scan (``csrc/ssd_scan.cu``).
It trains them (``training.loop.Trainer``) without those kernels, as the
reference trains without its Pallas kernels, fed by its own copy of the
DELI data plane (``core``, ``data``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.model import DecoderLM
from repro_torch.serving import GenerationResult, ServeEngine
from repro_torch.weights import params_from_reference, params_to_numpy
