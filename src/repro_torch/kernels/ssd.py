"""Mamba-2 SSD chunked scan on Hopper: the wrapper of the hand-written CUDA
kernel ``csrc/ssd_scan.cu``, and its plain PyTorch version.

The kernel replaces ``src/repro/kernels/ssd.py::_ssd_kernel``, the Pallas
TPU kernel, and computes the same function: x (B, S, H, P), dt (B, S, H)
f32, A and D (H,) f32, B/C (B, S, G, N) with head h reading group
h // (H // G); per (b, h) an f32 (P, N) state is carried over chunks of
``chunk`` steps, ``a_cum = cumsum(dt·A)``, the intra-chunk product
``(C Bᵀ ∘ L ∘ dt_j) x`` with ``L[i, j] = exp(a_i − a_j)`` for i ≥ j, the
inter-chunk term ``(C Sᵀ) ∘ exp(a_cum)``, the state update
``S' = exp(a_tot) S + xᵀ(exp(a_tot − a_cum)·dt·B)``; it returns
``y + D·x`` rounded once to x's dtype and the final state in f32.  x/B/C
are f32 or bf16; chunk ≤ 128, P ≤ 64, N ≤ 128 (mamba2-130m: 128, 64, 128).

What bounds it on the card: 2Q(QN + QP + 2NP) FLOPs per (b, h, chunk)
against a few bytes per row, so tensor-core FLOPs at these widths.  This
first version runs one block per (b, h) that loops over the chunks with
the state in shared memory and every product an f32 FMA on the CUDA cores;
it reads x, B and C through their strides (x is a slice of the fused xBC
activation, so its row stride is the conv width), which removes the Pallas
wrapper's four transposes.  It is far from the tensor-core bound; wgmma,
TMA and chunk-parallel state passing are the later steps (PERF.md holds
its measured times).

``ssd_scan`` launches the kernel and only takes CUDA tensors; it counts its
launches in ``ssd_scan.launches``.  ``ssd_scan_plain`` is the same function
in PyTorch (the Pallas kernel's chunk loop): the CPU path and the yardstick
the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

CHUNK_MAX, P_MAX, N_MAX = 128, 64, 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, Bm, Cm, D, chunk: int) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssd_scan kernel: {name} is on {t.device}, not a CUDA device")
        if t.device != x.device:
            raise ValueError(f"ssd_scan kernel: {name} is on {t.device}, x on {x.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan kernel: {name}'s last dim must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x/B/C, not {x.dtype}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan kernel: {name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan kernel: {name} must be float32, got {t.dtype}")
    if x.dim() != 4 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("ssd_scan kernel: x, Bm and Cm must be 4-D")
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (
        tuple(dt.shape) != (Bb, S, H)
        or tuple(A.shape) != (H,)
        or tuple(D.shape) != (H,)
        or tuple(Bm.shape[:2]) != (Bb, S)
        or Cm.shape != Bm.shape
    ):
        raise ValueError(
            f"ssd_scan kernel: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, D {tuple(D.shape)} do not fit "
            "(B,S,H,P), (B,S,H), (H,), (B,S,G,N)"
        )
    if min(Bb, S, H, P, G, N) < 1 or H % G:
        raise ValueError(f"ssd_scan kernel: empty input or H={H} not a multiple of G={G}")
    if not 1 <= chunk <= CHUNK_MAX:
        raise ValueError(f"ssd_scan kernel takes chunk 1..{CHUNK_MAX}, got {chunk}")
    if S % chunk:
        raise ValueError(f"ssd_scan kernel: S={S} is not a multiple of chunk={chunk}")
    if P > P_MAX or N > N_MAX:
        raise ValueError(f"ssd_scan kernel takes P <= {P_MAX} and N <= {N_MAX}, got P={P}, N={N}")
    if Bb > 65535:
        raise ValueError(f"ssd_scan kernel: batch {Bb} above 65535")


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on x's current stream; returns (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) f32).  Raises on input the kernel does
    not take, and if the launch is refused."""
    _check(x, dt, A, Bm, Cm, D, chunk)
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    lib = _kernel()
    with torch.cuda.device(x.device):
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D.data_ptr(), y.data_ptr(), state.data_ptr(),
            _DTYPE_CODES[x.dtype], Bb, S, H, P, G, N, chunk,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: {msg} (cudaError {rc})")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0


def ssd_scan_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device: the Pallas
    kernel's loop over chunks, batched over (b, h), all in f32, with
    ``y + D·x`` rounded to x's dtype at the end."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    assert S % chunk == 0, (S, chunk)
    xf, dtf = x.float(), dt.float()
    Bh = Bm.float().repeat_interleave(rep, dim=2)  # (B,S,H,N)
    Ch = Cm.float().repeat_interleave(rep, dim=2)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]  # (1,Qi,Qj,1)
    state = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bh[:, sl], Ch[:, sl]
        a_cum = torch.cumsum(dtc * A, dim=1)  # (B,Q,H)
        a_tot = a_cum[:, -1]  # (B,H)
        # L[i, j] = exp(a_i - a_j) for i >= j; above the diagonal exp may be
        # inf, and the select (never a product with 0) keeps it out
        L = torch.where(causal, torch.exp(a_cum[:, :, None] - a_cum[:, None]), 0.0)
        cb = torch.einsum("bihn,bjhn->bijh", Cc, Bc)
        y = torch.einsum("bijh,bjhp->bihp", cb * L * dtc[:, None], xc)
        y = y + torch.einsum("bihn,bhpn->bihp", Cc, state) * torch.exp(a_cum)[..., None]
        w = torch.exp(a_tot[:, None] - a_cum) * dtc  # (B,Q,H)
        state = state * torch.exp(a_tot)[..., None, None] + torch.einsum(
            "bjhp,bjhn->bhpn", xc, Bc * w[..., None]
        )
        ys.append(y + xc * D[None, None, :, None])
    return torch.cat(ys, dim=1).to(x.dtype), state
