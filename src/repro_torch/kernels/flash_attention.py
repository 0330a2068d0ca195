"""Flash attention (causal / sliding-window / GQA) on Hopper: the wrappers of
the two hand-written CUDA kernels, the rule that picks one, and the plain
PyTorch version.

Both kernels replace ``src/repro/kernels/flash_attention.py::_flash_kernel``,
the Pallas TPU kernel, and compute the same function: q (B, Sq, H, hd),
k/v (B, Sk, KV, hd), q head h reads kv head h // (H // KV), optional causal
mask and sliding window (keys with ``kpos > qpos - window`` are kept), online
softmax with m, l and the accumulator in f32, output ``acc / max(l, 1e-30)``
in q's dtype; any head_dim up to 128 (120 for h2o-danube-3-4b).

What bounds it on the card: at prefill lengths it does 4·hd FLOPs per
visible (q, k) pair and moves only q, k, v and o once, so tensor-core FLOPs
bound it.  The two variants:

- ``tensor_core`` (``csrc/flash_attention_tc.cu``, bf16 only): both products
  on the tensor cores as ``wgmma`` (one warpgroup a 64-row q tile, bf16 in,
  f32 accumulate), K/V tiles streamed through a two-stage cp.async ring, the
  online softmax in registers on the accumulator fragments.  Its one extra
  rounding: p is rounded to bf16 before the P·V product (l sums the f32 p).
- ``cuda_core`` (``csrc/flash_attention.cu``, f32 and bf16): every product an
  f32 FMA on the CUDA cores, scores and p in f32.  TF32 keeps about 3
  decimal digits and would miss the f32 tolerance (2e-5), so f32 stays here.

**The dtype rule** (``variant``): bf16 input whose head_dim is a multiple of
8, whose batch/sequence/head strides are multiples of 8 elements and whose
bases are 16-byte aligned (what 16-byte cp.async needs) goes to
``tensor_core``; every other input — f32, or bf16 that fails the alignment —
goes to ``cuda_core``.  Each variant launches or raises; neither falls back
to the other.

``flash_attention`` applies the rule and counts every launch in
``flash_attention.launches``; ``flash_attention_tc`` and
``flash_attention_cuda_core`` launch one variant each and count their own
launches.  ``flash_attention_plain`` is the same function in PyTorch
(``plain_attention``'s math): the CPU path and the yardstick the kernels are
held against on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build

HD_MAX = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"


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


def _tc_kernel():
    lib = _build.load("flash_attention_tc")
    fn = lib.flash_attention_tc_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_tc_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_tc_error_string.restype = ctypes.c_char_p
    return lib


def variant(
    dtype: torch.dtype, head_dim: int, strides: Sequence[int], data_ptrs: Sequence[int]
) -> str:
    """The dtype rule: ``"tensor_core"`` for bf16 that 16-byte cp.async can
    read (head_dim a multiple of 8, every batch/sequence/head stride of q, k
    and v a multiple of 8 elements, every base 16-byte aligned), else
    ``"cuda_core"``.  Pure Python: it reads no tensor."""
    aligned = (
        head_dim % 8 == 0
        and all(s % 8 == 0 for s in strides)
        and all(p % 16 == 0 for p in data_ptrs)
    )
    return TENSOR_CORE if dtype == torch.bfloat16 and aligned else CUDA_CORE


def _variant_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    return variant(q.dtype, q.shape[3], strides, [t.data_ptr() for t in (q, k, v)])


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
    """Launch the variant the dtype rule picks on q's current stream;
    returns (B, Sq, H, hd) in q's dtype.  Raises on input the kernels do not
    take, and if the launch is refused."""
    _check(q, k, v, window)
    if _variant_of(q, k, v) == TENSOR_CORE:
        out = flash_attention_tc(q, k, v, causal=causal, window=window)
    else:
        out = flash_attention_cuda_core(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _launch(fn, err, q, k, v, extra, causal, window) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *extra, B, Sq, Sk, H, KV, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), -1 if window is None else int(window), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: {err(rc).decode()} (cudaError {rc})")
    return out


def flash_attention_tc(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The tensor-core kernel (bf16, cp.async-aligned input only)."""
    _check(q, k, v, window)
    if _variant_of(q, k, v) != TENSOR_CORE:
        raise ValueError(
            "flash_attention_tc takes bf16 with head_dim and strides multiples of 8 and "
            f"16-byte-aligned bases; got {q.dtype}, hd {q.shape[3]}"
        )
    lib = _tc_kernel()
    out = _launch(lib.flash_attention_tc_fwd, lib.flash_attention_tc_error_string,
                  q, k, v, (), causal, window)
    flash_attention_tc.launches += 1
    return out


flash_attention_tc.launches = 0


def flash_attention_cuda_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The CUDA-core kernel (f32 or bf16, any strides with a contiguous last
    dim)."""
    _check(q, k, v, window)
    lib = _kernel()
    out = _launch(lib.flash_attention_fwd, lib.flash_attention_error_string,
                  q, k, v, (_DTYPE_CODES[q.dtype],), causal, window)
    flash_attention_cuda_core.launches += 1
    return out


flash_attention_cuda_core.launches = 0


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
