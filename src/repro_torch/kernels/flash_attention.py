"""Flash attention (causal / sliding-window / GQA) on Hopper: the wrapper of
the hand-written CUDA kernel ``csrc/flash_attention.cu``, and its plain
PyTorch version.

The kernel replaces ``src/repro/kernels/flash_attention.py::_flash_kernel``,
the Pallas TPU kernel, and computes the same function: q (B, Sq, H, hd),
k/v (B, Sk, KV, hd), q head h reads kv head h // (H // KV), optional causal
mask and sliding window (keys with ``kpos > qpos - window`` are kept), online
softmax with m, l, the accumulator, the scores and p all in f32, output
``acc / max(l, 1e-30)`` in q's dtype.  It takes f32 and bf16 and any
head_dim up to 128 (120 for h2o-danube-3-4b).

What bounds it on the card: at prefill lengths it does 4·hd FLOPs per
visible (q, k) pair and moves only q, k, v and o once, so tensor-core FLOPs
bound it.  This first version runs every product as an f32 FMA on the CUDA
cores over K/V tiles in shared memory, and skips tiles that the causal mask
or the window hide entirely; it sits far from the tensor-core bound, and
``wgmma``/TMA are the later step (PERF.md holds its measured times).

``flash_attention`` launches the kernel and only takes CUDA tensors; it
counts its launches in ``flash_attention.launches``.  ``flash_attention_plain``
is the same function in PyTorch (``plain_attention``'s math): the CPU path
and the yardstick the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

HD_MAX = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def _kernel():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name}'s last dim must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, not {q.dtype}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(
            f"flash_attention kernel: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit (B, S, H, hd) / (B, S, KV, hd)"
        )
    KV, Sk = k.shape[2], k.shape[1]
    if min(B, Sq, Sk, KV) < 1 or H % KV:
        raise ValueError(f"flash_attention kernel: empty input or H={H} not a multiple of KV={KV}")
    if not 1 <= hd <= HD_MAX:
        raise ValueError(f"flash_attention kernel takes head_dim 1..{HD_MAX}, got {hd}")
    if max(Sq, Sk) > _INT32_MAX:
        raise ValueError("flash_attention kernel: sequence longer than 2**31 - 1")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention kernel: window must be >= 1, got {window}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on q's current stream; returns (B, Sq, H, hd)
    in q's dtype.  Raises on input the kernel does not take, and if the
    launch is refused."""
    _check(q, k, v, window)
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, Sq, Sk, H, KV, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), -1 if window is None else int(window), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (cudaError {rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: f32 scores of
    (q·hd^-0.5) against k, the masks, softmax, fully-masked rows -> 0, f32
    PV product, output in q's dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    qg = (q * hd ** -0.5).reshape(B, Sq, KV, H // KV, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~ok, -torch.inf), dim=-1).nan_to_num(nan=0.0)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
