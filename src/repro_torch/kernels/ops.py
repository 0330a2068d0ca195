"""Dispatch to the hand-written kernels.

These are the functions the model calls when ``cfg.use_kernels`` is set.  A
CUDA tensor always goes to the kernel, which launches or raises; a CPU
tensor goes to the kernel's plain PyTorch version.  Any other device raises.
Each has an oracle in kernels/ref.py with the same signature.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd as _ssd


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


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD chunked scan. Returns (y (B,S,H,P), state (B,H,P,N))."""
    if x.is_cuda:
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=chunk)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")
