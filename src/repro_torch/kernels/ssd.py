"""Mamba-2 SSD chunked scan on Hopper: the wrappers of the two hand-written
CUDA kernels, the rule that picks one, and the plain PyTorch version.

Both kernels replace ``src/repro/kernels/ssd.py::_ssd_kernel``, the Pallas
TPU kernel, and compute the same function: x (B, S, H, P), dt (B, S, H)
f32, A and D (H,) f32, B/C (B, S, G, N) with head h reading group
h // (H // G); per (b, h) an f32 (P, N) state is carried over chunks of
``chunk`` steps, ``a_cum = cumsum(dt·A)``, the intra-chunk product
``(C Bᵀ ∘ L ∘ dt_j) x`` with ``L[i, j] = exp(a_i − a_j)`` for i ≥ j, the
inter-chunk term ``(C Sᵀ) ∘ exp(a_cum)``, the state update
``S' = exp(a_tot) S + xᵀ(exp(a_tot − a_cum)·dt·B)``; it returns
``y + D·x`` rounded once to x's dtype and the final state in f32.  Any
chunk that divides S, as the Pallas kernel; P ≤ 64, N ≤ 128 (mamba2-130m:
chunk 128, P 64, N 128; jamba-1.5-large: chunk 256, P 64, N 128).  x, B and
C are read through their strides (x is a slice of the fused xBC activation).

**The tile is not the chunk.**  Both kernels keep 128-row tiles in shared
memory (a 256-row tile of the f32 kernel would take 256 KB of the SM's 227,
and would halve the bf16 kernel's two blocks an SM).  A chunk of ``chunk``
rows runs as ``chunk / tile`` sub-tiles of ``tile = ssd_tile(chunk)`` rows,
the largest divisor of the chunk that is at most 128, with the (P, N) state
carried from one sub-tile to the next.  ``a_cum`` stays the chunk's: one
sequential f32 sum over the whole chunk, carried across its sub-tiles, so
every decay inside a sub-tile is the reference's ``exp(a_i − a_j)``.  A
pair across a sub-tile boundary decays through the state, by
``exp(a_i − a_base)·exp(a_base − a_j)`` (``a_base`` the sum at the end of
the previous sub-tile, 0 at the chunk's start): the same function, up to
one rounding of each factor.  Restarting the sum at each sub-tile would be
the same function too, but its ``a_cum`` rounds apart from the chunk's sum
(``chunk_a_cum``): at jamba's widths that moved f32 y by about 1e-3, past
the 2e-4 tolerance.  A call stays one launch.

What bounds it on the card: 2Q(QN + QP + 2NP) FLOPs per (b, h, tile of Q
rows) against a few bytes per row, so tensor-core FLOPs at these widths.  The two
variants, each one block per (b, h) looping over the chunks:

- ``tensor_core`` (``csrc/ssd_scan_tc.cu``, bf16 x/B/C only): the four
  products on the tensor cores as ``mma.sync.m16n8k16`` with f32
  accumulators, bf16 tiles in 89 KB of shared memory (two blocks an SM), the
  state in registers.  Operand rounding: x, B and C go in as they are; the
  f32 intermediates M, S and w·x are each split into bf16 hi + lo and
  multiplied twice (about 2⁻¹⁶ relative; plain bf16 rounding of them missed
  the 2e-2 tolerance by up to 8x, ``tests/test_torch_kernels_tc.py``).
- ``cuda_core`` (``csrc/ssd_scan.cu``, f32 and bf16): every product an f32
  FMA on the CUDA cores, the state in shared memory.  f32 stays here: TF32
  would miss the f32 tolerance (2e-4).

**The dtype rule** (``variant``): bf16 x/B/C with P and N multiples of 8,
batch/sequence/head strides of x, B and C multiples of 8 elements and
16-byte-aligned bases (what 16-byte cp.async needs) go to ``tensor_core``;
every other input — f32, or bf16 that fails the alignment — goes to
``cuda_core``.  Each variant launches or raises; neither falls back to the
other.

``ssd_scan`` applies the rule and counts every launch in
``ssd_scan.launches``; ``ssd_scan_tc`` and ``ssd_scan_cuda_core`` launch one
variant each and count their own launches.  ``ssd_scan_plain`` is the same
function in PyTorch (the Pallas kernel's chunk loop): the CPU path and the
yardstick the kernels are held against on the card.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build

TILE_MAX, P_MAX, N_MAX = 128, 64, 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"


def _kernel():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _tc_kernel():
    lib = _build.load("ssd_scan_tc")
    fn = lib.ssd_scan_tc_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.ssd_scan_tc_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_tc_error_string.restype = ctypes.c_char_p
    return lib


def ssd_tile(chunk: int) -> int:
    """The rows a kernel takes of a chunk at a time: the largest divisor of
    ``chunk`` that is at most ``TILE_MAX`` (256 -> 128, 200 -> 100, a prime
    above 128 -> 1).  Pure Python."""
    return next(t for t in range(min(chunk, TILE_MAX), 0, -1) if chunk % t == 0)


def variant(
    dtype: torch.dtype, P: int, N: int, strides: Sequence[int], data_ptrs: Sequence[int]
) -> str:
    """The dtype rule: ``"tensor_core"`` for bf16 x/B/C that 16-byte cp.async
    can read (P and N multiples of 8, every batch/sequence/head stride of x,
    B and C a multiple of 8 elements, every base 16-byte aligned), else
    ``"cuda_core"``.  Pure Python: it reads no tensor."""
    aligned = (
        P % 8 == 0
        and N % 8 == 0
        and all(s % 8 == 0 for s in strides)
        and all(p % 16 == 0 for p in data_ptrs)
    )
    return TENSOR_CORE if dtype == torch.bfloat16 and aligned else CUDA_CORE


def _variant_of(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor) -> str:
    strides = [s for t in (x, Bm, Cm) for s in t.stride()[:3]]
    return variant(x.dtype, x.shape[3], Bm.shape[3], strides, [t.data_ptr() for t in (x, Bm, Cm)])


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
    if chunk < 1:
        raise ValueError(f"ssd_scan kernel takes chunk >= 1, got {chunk}")
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
    """Launch the variant the dtype rule picks on x's current stream;
    returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32).  Raises on
    input the kernels do not take, and if the launch is refused."""
    _check(x, dt, A, Bm, Cm, D, chunk)
    if _variant_of(x, Bm, Cm) == TENSOR_CORE:
        out = ssd_scan_tc(x, dt, A, Bm, Cm, D, chunk=chunk)
    else:
        out = ssd_scan_cuda_core(x, dt, A, Bm, Cm, D, chunk=chunk)
    ssd_scan.launches += 1
    return out


ssd_scan.launches = 0


def _launch(fn, err, x, dt, A, Bm, Cm, D, extra, chunk):
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D.data_ptr(), y.data_ptr(), state.data_ptr(),
            *extra, Bb, S, H, P, G, N, chunk, ssd_tile(chunk),
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: {err(rc).decode()} (cudaError {rc})")
    return y, state


def ssd_scan_tc(x, dt, A, Bm, Cm, D, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernel (bf16 x/B/C, cp.async-aligned input only)."""
    _check(x, dt, A, Bm, Cm, D, chunk)
    if _variant_of(x, Bm, Cm) != TENSOR_CORE:
        raise ValueError(
            "ssd_scan_tc takes bf16 x/B/C with P, N and strides multiples of 8 and "
            f"16-byte-aligned bases; got {x.dtype}, P {x.shape[3]}, N {Bm.shape[3]}"
        )
    lib = _tc_kernel()
    out = _launch(lib.ssd_scan_tc_fwd, lib.ssd_scan_tc_error_string,
                  x, dt, A, Bm, Cm, D, (), chunk)
    ssd_scan_tc.launches += 1
    return out


ssd_scan_tc.launches = 0


def ssd_scan_cuda_core(x, dt, A, Bm, Cm, D, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core kernel (f32 or bf16 x/B/C, any strides with a contiguous
    last dim)."""
    _check(x, dt, A, Bm, Cm, D, chunk)
    lib = _kernel()
    out = _launch(lib.ssd_scan_fwd, lib.ssd_scan_error_string,
                  x, dt, A, Bm, Cm, D, (_DTYPE_CODES[x.dtype],), chunk)
    ssd_scan_cuda_core.launches += 1
    return out


ssd_scan_cuda_core.launches = 0


def chunk_a_cum(dt: torch.Tensor, A: torch.Tensor, chunk: int) -> torch.Tensor:
    """``a_cum`` (B, S, H) f32 as the kernels take it: within each chunk, a
    sequential f32 sum of ``dt·A``, the product and each partial sum rounded
    separately.  ``torch.cumsum`` sums in an order of its own (a parallel
    scan on the card, double accumulation on the CPU); at chunk 256 an
    ``a_cum`` of about -200 rounds in steps of 1.5e-5, which moves f32 y by
    about 1e-3 where terms cancel, past the 2e-4 tolerance.  One add a row
    of the chunk, over every chunk at once."""
    Bb, S, H = dt.shape
    dA = (dt.float() * A).reshape(Bb, S // chunk, chunk, H)
    out = torch.empty_like(dA)
    run = torch.zeros_like(dA[:, :, 0])
    for i in range(chunk):
        run = run + dA[:, :, i]
        out[:, :, i] = run
    return out.reshape(Bb, S, H)


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
    kernel's loop over whole chunks, batched over (b, h), all in f32, with
    ``a_cum`` summed as the kernels sum it (``chunk_a_cum``) and
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
    a_all = chunk_a_cum(dtf, A, chunk)
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bh[:, sl], Ch[:, sl]
        a_cum = a_all[:, sl]  # (B,Q,H)
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
