"""Oracles for the kernels (same signatures as ops.py).

They delegate to the model's own attention and sequential SSD scan, so a
kernel<->ref comparison is also a kernel<->model comparison, as in the
reference package.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.layers import AttnMask, plain_attention
from repro_torch.models.ssm import _sequential_scan


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    return plain_attention(q, k, v, AttnMask(causal=causal, window=window))


def ssd_scan(x, dt, A, Bm, Cm, D):
    """Sequential-scan oracle; returns (y in x's dtype, final_state f32)."""
    xf, dtf, Af, Bf, Cf, Df = (t.float() for t in (x, dt, A, Bm, Cm, D))
    y, state = _sequential_scan(xf, dtf, Af, Bf, Cf)
    return (y + xf * Df[None, None, :, None]).to(x.dtype), state
