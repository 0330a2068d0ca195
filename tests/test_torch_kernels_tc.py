"""The numerical design of the bf16 tensor-core kernels, held against the
reference's Pallas kernels on JAX's CPU backend (interpret mode); the dtype
rule that picks a kernel variant; and, on a CUDA card only, each tensor-core
kernel against its plain version.

The emulations below repeat in numpy the roundings each kernel makes, so the
design is checked here before the card runs it:

- flash attention (``csrc/flash_attention_tc.cu``): q, k and v in bf16, f32
  scores and online softmax over 128-key tiles, p rounded to bf16 before the
  P·V product (l sums the f32 p), output rounded to bf16;
- the SSD scan (``csrc/ssd_scan_tc.cu``): x, B and C in bf16, and the f32
  intermediates M, S and w·x each split into bf16 hi + lo before their
  products, output rounded to bf16; ``chained`` repeats the order in which
  the Hopper kernel's tiles combine (each tile's own state contribution from
  zero, the state handed on, y = M x + e·C Sᵀ + D x).

On a card: ``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_tc.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_kernels import CUDA_CASES, SSD_CUDA_CASES  # noqa: E402

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402

pytestmark = pytest.mark.slow  # XLA interpret-mode kernels, like tests/test_kernels.py

BF16_TOL = 2e-2  # tests/test_kernels.py's bf16 tolerance, attention and SSD alike
MAX_SHARE = 0.5  # the worst share of that allowance the design may use
BK = 128  # the flash kernel's key tile (csrc/flash_attention_tc.cu: BN)


@pytest.fixture(scope="module")
def jx():
    """The reference kernels, held on JAX's CPU backend (Pallas in interpret
    mode)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops

    with jax.default_device(jax.devices("cpu")[0]):
        yield jnp, ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def bf16(a):
    """Round f32 to the nearest bf16 (ties to even), kept as f32."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32)
    return ((u + ((u >> 16) & 1) + np.uint32(0x7FFF)) & np.uint32(0xFFFF0000)).view(np.float32)


def hi_lo(a):
    """An f32 array as the bf16 pair (hi, lo) the SSD kernel multiplies."""
    hi = bf16(a)
    return hi, bf16(a - hi)


def share(got, want, tol=BF16_TOL):
    """Worst share of the allowance tol + tol·|want| (<= 1 where close)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want) / (tol + tol * np.abs(want))).max())


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------
def flash_tc_emulation(q, k, v, causal, window):
    """The tensor-core kernel's arithmetic: f32 scores of bf16 q and k, scaled
    in the log2 domain, online softmax over 128-key tiles, p in bf16 for P·V,
    output in bf16.  q (B, Sq, H, hd), k/v (B, Sk, KV, hd), bf16 values.

    The kernel's 128-row q tile leaves each row's sums in this order: its
    key tiles start at a multiple of BK (a window's first tile is rounded
    down to one), and the tiles it skips, past the causal diagonal or older
    than the window, are wholly masked, which change neither m, l nor acc
    here."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = np.float32(hd ** -0.5 * np.log2(np.e))
    out = np.zeros(q.shape, np.float32)
    qpos = np.arange(Sq)[:, None]
    for b in range(B):
        for h in range(H):
            qh, kh, vh = q[b, :, h], k[b, :, h // (H // KV)], v[b, :, h // (H // KV)]
            m = np.full((Sq, 1), -np.inf, np.float32)
            l = np.zeros((Sq, 1), np.float32)
            acc = np.zeros((Sq, hd), np.float32)
            for k0 in range(0, Sk, BK):
                kpos = np.arange(k0, min(k0 + BK, Sk))[None, :]
                s = (qh @ kh[k0:k0 + BK].T) * scale
                ok = np.ones(s.shape, bool)
                if causal:
                    ok &= kpos <= qpos
                if window is not None:
                    ok &= kpos > qpos - window
                s = np.where(ok, s, -np.inf)
                m_new = np.maximum(m, s.max(1, keepdims=True))
                m_use = np.where(m_new == -np.inf, 0, m_new)
                alpha = np.where(m == -np.inf, 0, np.exp2(m - m_use)).astype(np.float32)
                p = np.exp2(s - m_use).astype(np.float32)
                l = l * alpha + p.sum(1, keepdims=True)
                acc = acc * alpha + bf16(p) @ vh[k0:k0 + BK]
                m = m_new
            out[b, :, h] = acc / np.maximum(l, 1e-30)
    return bf16(out)


@pytest.mark.parametrize(
    "B,S,H,KV,hd,causal,window",
    [
        (1, 256, 8, 2, 120, True, 64),     # danube's head_dim, GQA 4:1, window bites
        (1, 200, 8, 2, 120, True, None),   # ragged S
        (2, 256, 8, 2, 120, True, None),   # plain causal, several tiles
        (1, 128, 4, 4, 64, False, None),   # non-causal
        (1, 256, 4, 4, 80, False, None),   # hubert's head_dim, no mask
        (1, 256, 8, 8, 96, True, None),    # phi-3-vision's head_dim
        (1, 384, 4, 2, 64, True, 200),     # a window edge inside a 128-key tile
    ],
)
def test_flash_bf16_p_rounding_holds_against_pallas(jx, B, S, H, KV, hd, causal, window):
    jnp, ops = jx
    rng = np.random.default_rng(20)
    shapes = ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    q, k, v = (bf16(rng.standard_normal(s)) for s in shapes)
    got = flash_tc_emulation(q, k, v, causal, window)
    want = ops.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
                               window=window, block_q=64, block_k=64, interpret=True)
    worst = share(got, np.asarray(want.astype(jnp.float32)))
    print(f"flash bf16-p emulation vs Pallas: worst share of the 2e-2 allowance {worst:.4f}")
    assert worst <= MAX_SHARE


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
def ssd_tc_emulation(x, dt, A, Bm, Cm, D, chunk, split=True, tile=None, chained=False):
    """The tensor-core kernel's arithmetic: a sequential f32 a_cum over each
    chunk, C Sᵀ, M x and (w∘x)ᵀ B with M, S and w∘x each as bf16 hi + lo
    (``split``) or as plain bf16 (``split=False``, the rounding the kernel
    does not use).  ``tile`` < ``chunk`` runs each chunk as sub-tiles with
    the chunk's a_cum and the state carried, as the kernel does.

    ``chained`` takes the Hopper kernel's order of a tile's sums: the tile's
    own contribution U = (w∘x)ᵀ B from zero, then S_t = d·S_{t−1} + U in f32
    (d = exp(a_end − a_base)), and y = M x + e·(C S_{t−1}ᵀ) + D x with the
    handed-on S_{t−1} split hi/lo, rounded once.  Without it, the first
    tensor-core kernel's order: y from e·(C Sᵀ) with M x added, and the
    products added onto the decayed state."""
    parts = hi_lo if split else (lambda a: (bf16(a),))
    tile = tile or chunk
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2:]
    y = np.zeros(x.shape, np.float32)
    st = np.zeros((Bb, H, P, N), np.float32)
    tri = np.tri(tile, dtype=bool)
    for b in range(Bb):
        for h in range(H):
            g = h // (H // G)
            s = np.zeros((P, N), np.float32)
            for c0 in range(0, S, chunk):
                a_chunk = np.cumsum((dt[b, c0 : c0 + chunk, h] * A[h]).astype(np.float32))
                a_base = np.float32(0)
                for t0 in range(0, chunk, tile):
                    sl = slice(c0 + t0, c0 + t0 + tile)
                    xc, Bc, Cc, d = x[b, sl, h], Bm[b, sl, g], Cm[b, sl, g], dt[b, sl, h]
                    a = a_chunk[t0 : t0 + tile].astype(np.float32)
                    cs = sum(Cc @ part.T for part in parts(s)) * np.exp(a - a_base)[:, None]
                    L = np.where(tri, np.exp(np.where(tri, a[:, None] - a[None, :], 0)), 0)
                    M = ((Cc @ Bc.T) * L * d[None, :]).astype(np.float32)
                    mx = sum(part @ xc for part in parts(M))
                    w = np.exp(a[-1] - a) * d
                    wx = (w[:, None] * xc).astype(np.float32)
                    decay = np.float32(np.exp(a[-1] - a_base))
                    if chained:
                        u = sum(part.T @ Bc for part in parts(wx)).astype(np.float32)
                        s = (decay * s + u).astype(np.float32)
                        yc = mx + cs
                    else:
                        s = s * decay + sum(part.T @ Bc for part in parts(wx))
                        yc = cs + mx
                    a_base = a[-1]
                    y[b, sl, h] = bf16(yc + xc * D[h])
            st[b, h] = s
    return y, st


def _ssd_inputs(seed, B, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    x, Bm, Cm = (bf16(rng.standard_normal(s)) for s in ((B, S, H, P), (B, S, G, N), (B, S, G, N)))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)  # softplus
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _pallas_ssd(jx, args, chunk):
    jnp, ops = jx
    jargs = [jnp.asarray(a, jnp.bfloat16 if i in (0, 3, 4) else jnp.float32)
             for i, a in enumerate(args)]
    y, st = ops.ssd_scan(*jargs, chunk=chunk, interpret=True)
    return np.asarray(y.astype(jnp.float32)), np.asarray(st)


SSD_DESIGN_SHAPES = [  # B, S, H, P, G, N, chunk: mamba2-130m's widths
    (1, 512, 24, 64, 1, 128, 128),
    (2, 200, 24, 64, 1, 128, 100),  # the chunk a 100-token prompt gives
    (2, 16, 24, 64, 1, 128, 8),     # the chunk an 8-token prompt gives
]


@pytest.mark.parametrize("shape", SSD_DESIGN_SHAPES, ids=["chunk128", "chunk100", "chunk8"])
def test_ssd_hi_lo_operands_hold_against_pallas(jx, shape, record_property):
    B, S, H, P, G, N, chunk = shape
    args = _ssd_inputs(21, B, S, H, P, G, N)
    want_y, want_st = _pallas_ssd(jx, args, chunk)
    y, st = ssd_tc_emulation(*args, chunk)
    worst = max(share(y, want_y), share(st, want_st))
    record_property("worst_share", worst)
    print(f"SSD hi+lo emulation vs Pallas at {shape}: worst share {worst:.4f}")
    assert worst <= MAX_SHARE


def test_ssd_hi_lo_sub_tiles_hold_against_pallas_at_chunk256(jx, record_property):
    """jamba-1.5-large's chunk of 256 (P 64, N 128) as the kernel runs it:
    sub-tiles of ``ssd_tile(256)`` = 128 rows with the chunk's a_cum and the
    state carried, in the tensor-core kernel's roundings, against the Pallas
    kernel at chunk 256."""
    from repro_torch.kernels.ssd import ssd_tile

    B, S, H, P, G, N, chunk = 1, 512, 8, 64, 1, 128, 256
    args = _ssd_inputs(22, B, S, H, P, G, N)
    want_y, want_st = _pallas_ssd(jx, args, chunk)
    y, st = ssd_tc_emulation(*args, chunk, tile=ssd_tile(chunk))
    worst = max(share(y, want_y), share(st, want_st))
    record_property("worst_share", worst)
    print(f"SSD hi+lo sub-tiles vs Pallas at chunk {chunk}: worst share {worst:.4f}")
    assert worst <= MAX_SHARE


@pytest.mark.parametrize("shape", SSD_DESIGN_SHAPES + [(1, 512, 8, 64, 1, 128, 256)],
                         ids=["chunk128", "chunk100", "chunk8", "chunk256-sub-tiles"])
def test_ssd_chained_order_holds_against_pallas(jx, shape, record_property):
    """The Hopper kernel's order of sums (``chained``): each tile's state
    contribution from zero, the handed-on state decayed and added, y as
    M x + e·C Sᵀ + D x; chunk 256 as sub-tiles of ``ssd_tile(256)`` = 128
    rows with the chunk's a_cum carried."""
    from repro_torch.kernels.ssd import ssd_tile

    B, S, H, P, G, N, chunk = shape
    args = _ssd_inputs(23, B, S, H, P, G, N)
    want_y, want_st = _pallas_ssd(jx, args, chunk)
    y, st = ssd_tc_emulation(*args, chunk, tile=ssd_tile(chunk), chained=True)
    worst = max(share(y, want_y), share(st, want_st))
    record_property("worst_share", worst)
    print(f"SSD chained order vs Pallas at {shape}: worst share {worst:.4f}")
    assert worst <= MAX_SHARE


def test_ssd_plain_bf16_operands_would_miss_the_tolerance(jx):
    """Why the kernel splits M, S and w∘x: rounded once to bf16 they take y
    past the 2e-2 allowance at mamba width."""
    B, S, H, P, G, N, chunk = SSD_DESIGN_SHAPES[0]
    args = _ssd_inputs(21, B, S, H, P, G, N)
    want_y, _ = _pallas_ssd(jx, args, chunk)
    y, _ = ssd_tc_emulation(*args, chunk, split=False)
    assert share(y, want_y) > 1.0


# ---------------------------------------------------------------------------
# The dtype rule
# ---------------------------------------------------------------------------
DANUBE_STRIDES = [1024 * 32 * 120, 32 * 120, 120] + [1024 * 8 * 120, 8 * 120, 120] * 2


@pytest.mark.parametrize(
    "dtype,hd,strides,ptrs,want",
    [
        (torch.bfloat16, 120, DANUBE_STRIDES, [0, 256, 512], FA.TENSOR_CORE),
        (torch.float32, 120, DANUBE_STRIDES, [0, 256, 512], FA.CUDA_CORE),
        (torch.bfloat16, 7, [7 * 4] * 9, [0, 256, 512], FA.CUDA_CORE),     # hd not a multiple of 8
        (torch.bfloat16, 16, [16, 16, 4] + [16] * 6, [0] * 3, FA.CUDA_CORE),  # head stride 4
        (torch.bfloat16, 120, DANUBE_STRIDES, [0, 8, 512], FA.CUDA_CORE),   # k's base 8 B off
        (torch.float16, 64, [64] * 9, [0] * 3, FA.CUDA_CORE),
    ],
)
def test_flash_variant_rule(dtype, hd, strides, ptrs, want):
    assert FA.variant(dtype, hd, strides, ptrs) == want


MAMBA_STRIDES = [2048 * 1792, 1792, 64] + [2048 * 1792, 1792, 128] * 2  # x, B, C of one xBC


@pytest.mark.parametrize(
    "dtype,P,N,strides,ptrs,want",
    [
        (torch.bfloat16, 64, 128, MAMBA_STRIDES, [0, 3072, 3328], SSD.TENSOR_CORE),
        (torch.float32, 64, 128, MAMBA_STRIDES, [0, 3072, 3328], SSD.CUDA_CORE),
        (torch.bfloat16, 7, 5, [60 * 7, 42, 7] + [60 * 15, 15, 5] * 2, [0] * 3, SSD.CUDA_CORE),
        (torch.bfloat16, 64, 128, [2048 * 1796, 1796, 64] + MAMBA_STRIDES[3:], [0] * 3,
         SSD.CUDA_CORE),  # row stride 1796: not a multiple of 8
        (torch.bfloat16, 64, 128, MAMBA_STRIDES, [2, 3072, 3328], SSD.CUDA_CORE),
        (torch.bfloat16, 128, 128, [8 * 128] * 9, [0] * 3, SSD.TENSOR_CORE),  # any P: tiles of 64
        (torch.bfloat16, 128, 256, [8 * 256] * 9, [0] * 3, SSD.CUDA_CORE),  # N > 128: the shape rule
    ],
)
def test_ssd_variant_rule(dtype, P, N, strides, ptrs, want):
    assert SSD.variant(dtype, P, N, strides, ptrs) == want


def test_rule_reads_the_tensors_it_is_given():
    """The wrappers apply the rule to the tensors' own strides and bases: a
    bf16 slice one element into a buffer fails the 16-byte alignment."""
    base = torch.zeros(2 * 16 * 4 * 32 + 1, dtype=torch.bfloat16)
    q = base[1:].view(2, 16, 4, 32)
    k = v = torch.zeros(2, 16, 4, 32, dtype=torch.bfloat16)
    assert FA._variant_of(q, k, v) == FA.CUDA_CORE
    assert FA._variant_of(k, k, v) == FA.TENSOR_CORE


def test_variant_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    for fn in (FA.flash_attention_tc, FA.flash_attention_cuda_core):
        before = fn.launches
        with pytest.raises(ValueError, match="not a CUDA device"):
            fn(q, q, q)
        assert fn.launches == before


# ---------------------------------------------------------------------------
# On the card: the tensor-core kernels against their plain versions
# ---------------------------------------------------------------------------
def _qkv(seed, B, S, H, KV, hd, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, S, n, hd, generator=g).to(device=device, dtype=torch.bfloat16)
            for n in (H, KV, KV)]


def _close(got, want, tol=BF16_TOL):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


FLASH_TC_CASES = [c[:5] + c[6:] for c in CUDA_CASES if c[5] == "bfloat16"] + [
    (4, 1024, 32, 8, 120, True, 4096),  # the danube serving prefill
    (1, 6144, 32, 8, 120, True, 4096),  # past the window
    (1, 384, 6, 1, 16, True, None),     # MQA, hd 16
    (2, 96, 4, 2, 64, True, None),      # small S
    (2, 130, 4, 4, 128, False, None),   # non-causal, hd 128, ragged
    (1, 77, 4, 2, 40, True, 10),        # hd 40 at the 64 width, window inside a tile
    (2, 300, 8, 2, 128, True, None),    # S not a multiple of the 128-row / 128-key tiles
    (1, 200, 4, 4, 64, False, None),    # non-causal, ragged Sk
    (2, 1024, 16, 16, 80, False, None),  # hubert's hd 80: P V at n 80
    (2, 600, 8, 8, 96, True, None),     # phi-3-vision's hd 96: P V at n 96
    (1, 512, 7, 7, 64, True, None),     # G 1
    (1, 256, 8, 2, 120, True, None),    # G 4
    (1, 333, 14, 2, 128, True, None),   # G 7: deepseek's kv groups
    (1, 256, 4, 2, 64, True, 1),        # window 1: each row sees its own key only
    (1, 700, 4, 2, 120, True, 200),     # a window edge inside a 128-key tile
    (1, 128, 2, 1, 128, True, None),    # a persistent grid of 2 tiles, fewer than the SMs
    (1, 64, 3, 1, 32, False, None),     # hd 32 width, one q tile half empty
]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FLASH_TC_CASES)
def test_cuda_tc_kernel_matches_plain(cuda, B, S, H, KV, hd, causal, window):
    q, k, v = _qkv(30, B, S, H, KV, hd, cuda)
    before_tc, before_cc = FA.flash_attention_tc.launches, FA.flash_attention_cuda_core.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.flash_attention_tc.launches == before_tc + 1
    assert FA.flash_attention_cuda_core.launches == before_cc
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, FA.flash_attention_plain(q, k, v, causal=causal, window=window))


def test_cuda_tc_kernel_reads_strided_inputs(cuda):
    # q/k/v as slices of one fused projection at danube's head_dim
    B, S, H, KV, hd = 2, 200, 8, 2, 120
    qkv = torch.randn(B, S, (H + 2 * KV) * hd, device=cuda).bfloat16()
    q, k, v = (t.reshape(B, S, -1, hd) for t in qkv.split([H * hd, KV * hd, KV * hd], -1))
    assert not q.is_contiguous()
    before = FA.flash_attention_tc.launches
    got = tops.flash_attention(q, k, v, causal=True, window=64)
    assert FA.flash_attention_tc.launches == before + 1
    _close(got, FA.flash_attention_plain(q, k, v, causal=True, window=64))


def test_cuda_tc_kernel_reads_a_run_of_heads(cuda):
    """A run of a rank's heads (``models/parallel.py::head_runs``): q heads
    14..18 of a rank's 19 reading kv head 2 of its 3, views at a head offset
    into the rank's tensors, as deepseek-coder's split over three ranks
    hands them to the kernel."""
    B, S, hd = 2, 300, 128
    q_all, k_all, v_all = _qkv(34, B, S, 19, 3, hd, cuda)
    q, k, v = q_all[:, :, 14:19], k_all[:, :, 2:3], v_all[:, :, 2:3]
    assert q.data_ptr() != q_all.data_ptr() and not q.is_contiguous()
    before = FA.flash_attention_tc.launches
    got = tops.flash_attention(q, k, v, causal=True)
    assert FA.flash_attention_tc.launches == before + 1
    _close(got, FA.flash_attention_plain(q, k, v, causal=True))


@pytest.mark.parametrize(
    "Sq,Sk,causal,window",
    [
        (100, 300, False, None),
        (300, 100, True, None),
        (1, 257, False, None),
        (600, 40, False, 16),  # q tiles from row 256 on see no key: they store zeros
    ],
)
def test_cuda_tc_kernel_takes_sq_other_than_sk(cuda, Sq, Sk, causal, window):
    g = torch.Generator().manual_seed(35)
    q = torch.randn(2, Sq, 4, 64, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(2, Sk, 2, 64, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    before = FA.flash_attention_tc.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    assert FA.flash_attention_tc.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    _close(got, want)
    if window is not None:
        assert not got[:, Sk + window:].any()


def test_cuda_unaligned_bf16_goes_to_the_cuda_core_kernel(cuda):
    base = torch.randn(2 * 64 * 4 * 32 + 1, device=cuda).bfloat16()
    q = base[1:].view(2, 64, 4, 32)  # 2 bytes off 16-byte alignment
    k, v = _qkv(31, 2, 64, 4, 2, 32, cuda)[1:]
    before_tc, before_cc = FA.flash_attention_tc.launches, FA.flash_attention_cuda_core.launches
    got = tops.flash_attention(q, k, v, causal=True)
    assert (FA.flash_attention_tc.launches, FA.flash_attention_cuda_core.launches) == (
        before_tc, before_cc + 1)
    _close(got, FA.flash_attention_plain(q, k, v, causal=True))
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_tc(q, k, v)


def _ssd_args(seed, B, S, H, P, G, N, device, strided=False):
    g = torch.Generator().manual_seed(seed)
    if strided:
        xbc = torch.randn(B, S, H * P + 2 * G * N, generator=g)
        x, Bm, Cm = xbc.split([H * P, G * N, G * N], -1)
        x, Bm, Cm = x.reshape(B, S, H, P), Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N)
    else:
        x = torch.randn(B, S, H, P, generator=g)
        Bm, Cm = torch.randn(B, S, G, N, generator=g), torch.randn(B, S, G, N, generator=g)
    x, Bm, Cm = (t.to(device).bfloat16() for t in (x, Bm, Cm))
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g)).to(device)
    A = (-torch.exp(torch.randn(H, generator=g) * 0.3)).to(device)
    D = (1.0 + 0.1 * torch.randn(H, generator=g)).to(device)
    return x, dt, A, Bm, Cm, D


SSD_TC_CASES = [c[:7] + (False,) for c in SSD_CUDA_CASES if c[7] == "bfloat16"] + [
    (8, 2048, 24, 64, 1, 128, 128, True),  # the mamba serving prefill, x/B/C slices of xBC
    (2, 100, 24, 64, 1, 128, 100, False),  # a 100-token prompt: chunk 100
    (2, 512, 24, 64, 1, 128, 128, True),
    (1, 64, 2, 16, 1, 16, 16, False),
    (1, 96, 3, 16, 1, 32, 32, False),
    (1, 8192, 128, 64, 1, 128, 256, True),  # a rank's 128 jamba heads: 128 chains of 64 tiles
    (1, 256, 256, 64, 1, 128, 256, True),   # S = chunk: 256 chains of one hand-off, in a chunk
    (1, 128, 200, 64, 1, 128, 128, False),  # S = chunk = the tile: 200 chains, no hand-off
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,strided", SSD_TC_CASES)
def test_cuda_tc_ssd_kernel_matches_plain(cuda, B, S, H, P, G, N, chunk, strided):
    args = _ssd_args(32, B, S, H, P, G, N, cuda, strided)
    before_tc, before_cc = SSD.ssd_scan_tc.launches, SSD.ssd_scan_cuda_core.launches
    y, st = tops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert SSD.ssd_scan_tc.launches == before_tc + 1
    assert SSD.ssd_scan_cuda_core.launches == before_cc
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    want_y, want_st = SSD.ssd_scan_plain(*args, chunk=chunk)
    _close(y, want_y)
    _close(st, want_st)


def test_cuda_tc_ssd_kernel_is_deterministic(cuda):
    """The same inputs give bit-identical y and state, call after call: two
    calls, then 20 back to back.  The tiles hand the state on between
    blocks in whatever order the card schedules them, so a race in the
    hand-off would show here."""
    args = _ssd_args(36, 8, 2048, 24, 64, 1, 128, cuda, strided=True)
    y0, st0 = SSD.ssd_scan_tc(*args, chunk=128)
    y1, st1 = SSD.ssd_scan_tc(*args, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1) and torch.equal(st0, st1)
    outs = [SSD.ssd_scan_tc(*args, chunk=128) for _ in range(20)]
    torch.cuda.synchronize()
    for y, st in outs:
        assert torch.equal(y, y0) and torch.equal(st, st0)


def test_cuda_odd_widths_bf16_go_to_the_cuda_core_ssd_kernel(cuda):
    args = _ssd_args(33, 1, 60, 6, 7, 3, 5, cuda)
    before_tc, before_cc = SSD.ssd_scan_tc.launches, SSD.ssd_scan_cuda_core.launches
    y, st = tops.ssd_scan(*args, chunk=12)
    assert (SSD.ssd_scan_tc.launches, SSD.ssd_scan_cuda_core.launches) == (
        before_tc, before_cc + 1)
    want_y, want_st = SSD.ssd_scan_plain(*args, chunk=12)
    _close(y, want_y)
    _close(st, want_st)
    with pytest.raises(ValueError, match="16-byte"):
        SSD.ssd_scan_tc(*args, chunk=12)
