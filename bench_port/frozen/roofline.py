"""Peaks, roofline bounds and the device's busy time: frozen copies of
``chip_smoke.py``'s ``roofline``, ``visible_pairs``, ``bound`` and
``ssd_bound`` and of the busy-share arithmetic of its ``profile_once``
(commit 3e2a384), in seconds and without torch dtypes."""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def roofline_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations at
    the dtype's peak and the bytes at the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def visible_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int]) -> int:
    """(q, k) pairs the masks leave visible: the work this input needs."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, q - window + 1) if window is not None else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_bound_s(B, Sq, Sk, H, KV, hd, dtype, causal, window) -> float:
    """Flash attention: 4·hd FLOPs per visible pair per (batch, head),
    against q, k, v read once and o written once."""
    flops = 4 * B * H * hd * visible_pairs(Sq, Sk, causal, window)
    nbytes = ELEMENT_BYTES[dtype] * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    return roofline_s(flops, nbytes, dtype)


def ssd_flops(B, S, H, P, N, Q) -> float:
    """SSD scan at chunk Q: 2Q(QN + QP + 2NP) FLOPs per (batch, head, chunk)
    — the C Bᵀ scores, the M x product, the C Sᵀ term and the state update."""
    return 2 * Q * (Q * N + Q * P + 2 * N * P) * B * H * (S // Q)


def ssd_bound_s(B, S, H, P, G, N, Q, dtype) -> float:
    """SSD scan: ``ssd_flops`` against x read and y written once, dt, B and
    C once per group and the final f32 state written once."""
    es = ELEMENT_BYTES[dtype]
    nbytes = es * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * (B * S * H + B * H * P * N + 2 * H)
    return roofline_s(ssd_flops(B, S, H, P, N, Q), nbytes, dtype)


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals: the time in which at
    least one device operation ran."""
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def gaps(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle (start, end) stretches between the covered intervals."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out
