"""Dispatch to the hand-written kernels.

These are the functions the model calls when ``cfg.use_kernels`` is set.  A
CUDA tensor always goes to the kernel, which launches or raises; a CPU
tensor goes to the kernel's plain PyTorch version.  Any other device raises.
Each has an oracle in kernels/ref.py with the same signature.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Blocked online-softmax attention. q (B,Sq,H,hd); k/v (B,Sk,KV,hd)."""
    if q.is_cuda:
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
