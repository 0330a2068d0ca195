"""Oracles for the kernels (same signatures as ops.py).

They delegate to the model's own attention, so a kernel<->ref comparison is
also a kernel<->model comparison, as in the reference package.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.layers import AttnMask, plain_attention


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    return plain_attention(q, k, v, AttnMask(causal=causal, window=window))
