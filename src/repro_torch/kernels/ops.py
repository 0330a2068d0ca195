"""Dispatch to the hand-written kernels.

These are the functions the model calls when ``cfg.use_kernels`` is set.  A
CUDA tensor always goes to the kernel, which launches or raises; a CPU
tensor goes to the kernel's plain PyTorch version.  Any other device raises.
Each has an oracle in kernels/ref.py with the same signature.  Each call is
a ``kernel.<name>`` leaf span (``obs/spans.py``: no profiler range, so a
caller's range around the entry keeps its kernels) with the shapes it was
handed.

The kernels have no backward, as the reference's Pallas kernels have none:
an input that requires grad, with grad mode on, raises rather than leave the
kernel's contribution silently out of the gradients (training takes the
model's chunked paths, ``models/model.py::train_loss``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd as _ssd
from repro_torch.obs.spans import leaf_span


def _forward_only(name: str, *inputs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the hand-written kernel has no backward and its output would carry "
            "no gradient; train through the model's non-kernel path (train_loss) or call "
            "it under torch.no_grad()"
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Blocked online-softmax attention. q (B,Sq,H,hd); k/v (B,Sk,KV,hd)."""
    _forward_only("flash_attention", q, k, v)
    with leaf_span("kernel.flash_attention", q=q.shape, kv=k.shape):
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
    _forward_only("ssd_scan", x, dt, A, Bm, Cm, D)
    with leaf_span("kernel.ssd_scan", x=x.shape, B=Bm.shape, chunk=chunk):
        if x.is_cuda:
            return _ssd.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
        if x.device.type == "cpu":
            return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=chunk)
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")
