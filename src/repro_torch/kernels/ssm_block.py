"""The Mamba-2 block's elementwise work on each side of the SSD scan, on
Hopper: the wrappers of the two hand-written CUDA kernels of
``csrc/ssm_block.cu`` and their plain PyTorch versions.

They replace no TPU kernel: the reference leaves this work to XLA, which
fuses it, while eager PyTorch runs each cast, pad, tap, add and activation
as a pass of its own over a whole (B, S, channels) tensor
(``models/ssm.py::ssm_block`` before the scan: about 78 GB a layer of the
mamba2-130m prefill at 128 x 2048).  Each kernel does one side in one pass,
bound by bytes:

- ``ssm_conv``: the causal depthwise conv, its bias and SiLU.  Reads x, B
  and C in place from the in_proj's f32 output, rounds each to the model
  dtype, convolves in f32 (the taps summed left to right), adds the bias,
  applies SiLU and rounds once: ``models/ssm.py::_causal_conv`` on the
  rounded input.  Writes the (B, S, C) xBC activation the SSD scan reads.
  C a multiple of ``CONV_CH``, K at most ``K_MAX``.
- ``ssm_gate_norm``: ``rms_norm(y * silu(z)) * scale`` over a row of
  d_inner, with z the f32 view of the in_proj's output; z, the SiLU and the
  product rounded to the model dtype as ``models/ssm.py`` rounds them, the
  mean of squares, rsqrt and scale in f32.  One warp a row up to d 2048,
  one block a row above (the row in shared memory: d x the dtype's bytes up
  to ``SMEM_MAX``).

Both take float32 and bfloat16, the model dtype.  On the card they agree
with the plain versions to the last bit but where the mean of squares sums
in another order than PyTorch's (within one unit in the model dtype's last
place) and where SiLU's ``exp`` rounds its last f32 bit apart.

``ssm_conv`` and ``ssm_gate_norm`` check their input, launch on the current
stream and count their launches (``.launches``); ``ssm_conv_plain`` and
``ssm_gate_norm_plain`` are the code the kernels replace, the CPU path and
the yardstick on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import rms_norm
from repro_torch.models.ssm import _causal_conv

CH = 8  # elements a 16-byte load of the norm (csrc/ssm_block.cu)
CONV_CH = 4  # channels a conv thread
RUN = 64  # positions a conv thread walks
K_MAX = 4
SMEM_MAX = 232448 - 1024  # shared memory a block may take, less the kernel's own
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    lib = _build.load("ssm_block")
    lib.ssm_conv_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
        + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.ssm_conv_fwd.restype = ctypes.c_int
    lib.ssm_gate_norm_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.ssm_gate_norm_fwd.restype = ctypes.c_int
    lib.ssm_block_error_string.argtypes = [ctypes.c_int]
    lib.ssm_block_error_string.restype = ctypes.c_char_p
    return lib


def _on_card(name: str, first: torch.Tensor, *rest: torch.Tensor) -> None:
    for t in (first, *rest):
        if not t.is_cuda:
            raise ValueError(f"{name} kernel: a tensor is on {t.device}, not a CUDA device")
        if t.device != first.device:
            raise ValueError(f"{name} kernel: tensors on {t.device} and {first.device}")


def _aligned(t: torch.Tensor, strides) -> bool:
    """16-byte loads reach every row of ``t``: its base 16-byte aligned and
    each stride a whole number of 16 bytes."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per == 0 for s in strides)


def _launched(lib, rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.ssm_block_error_string(rc).decode()} (cudaError {rc})")


def ssm_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Launch the conv on xBC's current stream: xBC (B, S, C) f32, any batch
    and sequence strides with contiguous channels (a slice of the in_proj's
    output); w (K, C) and b (C,) f32.  Returns (B, S, C) contiguous in
    ``dtype``.  Raises on input the kernel does not take."""
    _on_card("ssm_conv", xBC, w, b)
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"ssm_conv kernel writes float32 or bfloat16, not {dtype}")
    if xBC.dtype != torch.float32 or w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"ssm_conv kernel takes float32 xBC, w and b, got {xBC.dtype}, {w.dtype}, {b.dtype}")
    if xBC.dim() != 3 or xBC.stride(-1) != 1:
        raise ValueError("ssm_conv kernel: xBC must be (B, S, C) with contiguous channels")
    B, S, C = xBC.shape
    K = w.shape[0]
    if w.dim() != 2 or tuple(w.shape) != (K, C) or tuple(b.shape) != (C,):
        raise ValueError(f"ssm_conv kernel: w {tuple(w.shape)} and b {tuple(b.shape)} do not fit (K, {C}), ({C},)")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("ssm_conv kernel: w and b must be contiguous")
    if C % CONV_CH or not 1 <= K <= K_MAX:
        raise ValueError(f"ssm_conv kernel takes C a multiple of {CONV_CH} and 1 <= K <= {K_MAX}, got C={C}, K={K}")
    if not (1 <= B <= 65535 and 1 <= S and -(-S // RUN) <= 65535):
        raise ValueError(f"ssm_conv kernel: batch {B} or length {S} outside its grid")
    lib = _kernel()
    out = torch.empty((B, S, C), dtype=dtype, device=xBC.device)
    with torch.cuda.device(xBC.device):
        rc = lib.ssm_conv_fwd(
            xBC.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), _DTYPE_CODES[dtype], B, S, C, K,
            xBC.stride(0), xBC.stride(1), int(_aligned(xBC, xBC.stride()[:2])),
            torch.cuda.current_stream(xBC.device).cuda_stream,
        )
    _launched(lib, rc, "ssm_conv_fwd")
    ssm_conv.launches += 1
    return out


ssm_conv.launches = 0


def ssm_conv_plain(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in PyTorch: x, B and C rounded to ``dtype``,
    then ``models/ssm.py::_causal_conv``, then rounded again."""
    return _causal_conv(xBC.to(dtype), w, b).to(dtype)


def ssm_gate_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the gated norm on y's current stream: y (B, S, d) float32 or
    bfloat16, z (B, S, d) f32, each with any batch and sequence strides and a
    contiguous last dim; scale (d,).  Returns (B, S, d) contiguous in y's
    dtype.  Raises on input the kernel does not take."""
    _on_card("ssm_gate_norm", y, z, scale)
    if y.dtype not in _DTYPE_CODES or z.dtype != torch.float32:
        raise TypeError(f"ssm_gate_norm kernel takes float32 or bfloat16 y and float32 z, got {y.dtype}, {z.dtype}")
    if y.dim() != 3 or y.shape != z.shape or tuple(scale.shape) != (y.shape[2],):
        raise ValueError(f"ssm_gate_norm kernel: y {tuple(y.shape)}, z {tuple(z.shape)}, scale "
                         f"{tuple(scale.shape)} do not fit (B, S, d), (B, S, d), (d,)")
    if y.stride(-1) != 1 or z.stride(-1) != 1:
        raise ValueError("ssm_gate_norm kernel: y's and z's last dim must be contiguous")
    B, S, d = y.shape
    if min(B, S, d) < 1 or B * S > 2**31 - 1:
        raise ValueError(f"ssm_gate_norm kernel: {B} x {S} rows of {d}")
    if d > 2048 and d * y.element_size() > SMEM_MAX:
        raise ValueError(f"ssm_gate_norm kernel: a row of {d} {y.dtype} is past {SMEM_MAX} bytes of shared memory")
    scale = scale.float().contiguous()
    vec = d % CH == 0 and all(_aligned(t, t.stride()[:-1]) for t in (y, z, scale))
    lib = _kernel()
    out = torch.empty((B, S, d), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        rc = lib.ssm_gate_norm_fwd(
            y.data_ptr(), z.data_ptr(), scale.data_ptr(), out.data_ptr(), _DTYPE_CODES[y.dtype], B, S, d,
            y.stride(0), y.stride(1), z.stride(0), z.stride(1), eps, int(vec),
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    _launched(lib, rc, "ssm_gate_norm_fwd")
    ssm_gate_norm.launches += 1
    return out


ssm_gate_norm.launches = 0


def ssm_gate_norm_plain(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's function in PyTorch: z rounded to y's dtype, then
    ``rms_norm(y * silu(z), scale, eps)`` (``models/layers.py``)."""
    return rms_norm(y * torch.nn.functional.silu(z.to(y.dtype)), scale, eps)
