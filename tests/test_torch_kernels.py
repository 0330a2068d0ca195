"""The kernels' plain versions against the reference's Pallas kernels
(interpret mode) and their oracles: flash attention over the sweep of
tests/test_kernels.py plus head_dim 120, the SSD scan over its sweep in f32
and bf16; the CPU dispatch; and, on a CUDA card only, each hand-written
kernel against its plain version.

The JAX comparisons run on JAX's CPU backend and skip where JAX is not
installed; the CUDA comparisons skip where there is no card, each decided
inside a fixture.  On a card:
``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

pytestmark = pytest.mark.slow  # XLA interpret-mode kernels, like tests/test_kernels.py

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # tests/test_kernels.py's SSD tolerances


@pytest.fixture(scope="module")
def jx():
    """The reference kernels, held on JAX's CPU backend (Pallas in interpret
    mode): on a GPU machine JAX's default f32 products are not full f32."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops, ref

    with jax.default_device(jax.devices("cpu")[0]):
        yield jax, jnp, ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _qkv_np(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def _torch(arrays, dtype, device="cpu"):
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(device=device, dtype=tdt) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _against_reference(jx, arrays, dtype, block, causal=True, window=None):
    jax, jnp, ops, ref = jx
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)
    q, k, v = _torch(arrays, dtype)
    got = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and tuple(got.shape) == tuple(q.shape)
    pallas = ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                 block_q=block, block_k=block, interpret=True)
    oracle = ref.flash_attention(jq, jk, jv, causal=causal, window=window)
    _close(got, pallas, TOL[dtype])
    _close(got, oracle, TOL[dtype])
    # the port's own oracle (the model's plain_attention) agrees too
    _close(got, tref.flash_attention(q, k, v, causal=causal, window=window), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,KV,hd,block",
    [
        (1, 128, 4, 4, 64, 64),    # MHA, one block row
        (2, 256, 8, 2, 32, 64),    # GQA 4:1
        (1, 384, 6, 1, 16, 128),   # MQA, uneven blocks (384 = 3x128)
        (2, 96, 4, 2, 64, 32),     # small seq, multiple blocks
        (1, 200, 8, 2, 120, 64),   # h2o-danube's head_dim, padded seq
    ],
)
def test_plain_matches_pallas_causal(jx, B, S, H, KV, hd, block, dtype):
    _against_reference(jx, _qkv_np(0, B, S, S, H, KV, hd), dtype, block)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_plain_matches_pallas_sliding_window(jx, window):
    _against_reference(jx, _qkv_np(1, 2, 256, 256, 4, 2, 32), "float32", 64, window=window)


def test_plain_matches_pallas_padded_seq(jx):
    _against_reference(jx, _qkv_np(2, 1, 200, 200, 4, 4, 32), "float32", 64)


def test_plain_matches_pallas_noncausal(jx):
    _against_reference(jx, _qkv_np(3, 2, 128, 128, 4, 4, 64), "float32", 64, causal=False)


def test_cpu_dispatch_takes_plain_version_and_never_launches():
    q, k, v = _torch(_qkv_np(4, 2, 40, 40, 4, 2, 120), "float32")
    before = FA.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=True, window=16)
    assert torch.equal(got, FA.flash_attention_plain(q, k, v, causal=True, window=16))
    assert FA.flash_attention.launches == before == 0


SCALES = [1 / 128, 0.3]  # granite-4.0-h-small's attention_multiplier at hd 128; another


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", SCALES)
def test_plain_takes_a_scale(scale, causal):
    """The scores' scale reaches the plain version, the CPU dispatch and
    the port's chunked and plain attention alike, and moves the output."""
    from repro_torch.models import layers as L

    q, k, v = _torch(_qkv_np(9, 2, 70, 70, 4, 2, 128), "float32")
    got = FA.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    assert torch.equal(tops.flash_attention(q, k, v, causal=causal, scale=scale), got)
    mask = L.AttnMask(causal=causal)
    _close(got, L.plain_attention(q, k, v, mask, scale=scale), TOL["float32"])
    _close(got, L.chunked_attention(q, k, v, mask, chunk=32, scale=scale), TOL["float32"])
    assert (got - FA.flash_attention_plain(q, k, v, causal=causal)).abs().max() > 1e-2


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = _torch(_qkv_np(5, 1, 8, 8, 2, 2, 16), "float32")
    with pytest.raises(ValueError, match="not a CUDA device"):
        FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches == 0


def test_dispatch_refuses_other_devices():
    q, k, v = (torch.empty(1, 8, 2, 16, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="no kernel"):
        tops.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
CUDA_CASES = [
    # B, S, H, KV, hd, dtype, causal, window
    (1, 128, 4, 4, 64, "float32", True, None),
    (2, 256, 8, 2, 32, "bfloat16", True, None),
    (1, 384, 6, 1, 16, "float32", True, None),
    (2, 200, 8, 2, 120, "float32", True, 64),
    (1, 1000, 32, 8, 120, "bfloat16", True, 300),
    (2, 130, 4, 4, 128, "float32", False, None),
    (1, 77, 4, 2, 7, "float32", True, None),
]


@pytest.mark.parametrize("B,S,H,KV,hd,dtype,causal,window", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda, B, S, H, KV, hd, dtype, causal, window):
    q, k, v = _torch(_qkv_np(6, B, S, S, H, KV, hd), dtype, cuda)
    before = FA.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.is_cuda
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_takes_a_scale(cuda, dtype, scale):
    """granite-4.0-h-small's attention layer (32 / 8 heads of 128, 4096
    positions) at a scale other than hd ** -0.5: the CUDA-core kernel in
    f32, the tensor-core kernel in bf16."""
    q, k, v = _torch(_qkv_np(10, 1, 4096, 4096, 32, 8, 128), dtype, cuda)
    before = FA.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    _close(got, FA.flash_attention_plain(q, k, v, causal=True, scale=scale), TOL[dtype])


def test_cuda_kernel_reads_strided_inputs(cuda):
    # q/k/v as slices of one fused projection: only the last dim is contiguous
    qkv = _torch(_qkv_np(7, 2, 64, 64, 6, 6, 32)[:1], "float32", cuda)[0]
    q, k, v = qkv[:, :, 0:4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    got = FA.flash_attention(q, k, v, causal=True)
    want = FA.flash_attention_plain(q, k, v, causal=True)
    _close(got, want, TOL["float32"])


def test_cuda_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _torch(_qkv_np(8, 1, 16, 16, 2, 2, 130), "float32", cuda)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, k, v)
    q, k, v = _torch(_qkv_np(8, 1, 16, 16, 2, 2, 16), "float32", cuda)
    with pytest.raises(TypeError):
        FA.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(2, 3), k, v)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
def _ssd_np(seed, B, S, H, P, G, N):
    """x, dt, A, B, C, D as numpy f32, drawn like tests/test_kernels.py's."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))  # softplus
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, S, G, N))
    Cm = rng.standard_normal((B, S, G, N))
    D = 1.0 + 0.1 * rng.standard_normal(H)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]


def _ssd_torch(arrays, dtype, device="cpu"):
    """x/B/C in ``dtype``; dt, A and D f32, as the model hands them over."""
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(device=device, dtype=tdt if i in (0, 3, 4) else torch.float32)
            for i, a in enumerate(arrays)]


SSD_SHAPES = [  # B, S, H, P, G, N, chunk: tests/test_kernels.py's sweep
    (1, 64, 2, 16, 1, 16, 16),   # minimal
    (2, 128, 4, 32, 2, 16, 32),  # grouped B/C
    (1, 96, 3, 16, 1, 32, 32),   # odd head count, 3 chunks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=["minimal", "grouped", "odd-heads"])
def test_ssd_plain_matches_pallas(jx, shape, dtype):
    jax, jnp, ops, ref = jx
    B, S, H, P, G, N, chunk = shape
    arrays = _ssd_np(9, B, S, H, P, G, N)
    jargs = [jnp.asarray(a).astype(getattr(jnp, dtype) if i in (0, 3, 4) else jnp.float32)
             for i, a in enumerate(arrays)]
    targs = _ssd_torch(arrays, dtype)
    y, st = SSD.ssd_scan_plain(*targs, chunk=chunk)
    assert y.dtype == targs[0].dtype and tuple(y.shape) == (B, S, H, P)
    assert st.dtype == torch.float32 and tuple(st.shape) == (B, H, P, N)
    tol = SSD_TOL[dtype]
    for want_y, want_st in (ops.ssd_scan(*jargs, chunk=chunk, interpret=True),
                            ref.ssd_scan(*jargs), tref.ssd_scan(*targs)):
        _close(y, want_y, tol)
        _close(st, want_st, tol)


def test_ssd_plain_matches_port_chunked_path():
    """The kernel's function against the model's chunked path (the reference's
    test_ssd_kernel_matches_model_chunked_path, at its 1e-4)."""
    from repro_torch.models.ssm import ssd_chunked

    args = _ssd_torch(_ssd_np(10, 2, 128, 4, 32, 2, 16), "float32")
    y_k, st_k = SSD.ssd_scan_plain(*args, chunk=32)
    y_m, st_m = ssd_chunked(*args, chunk=32)
    _close(y_k, y_m, 1e-4)
    _close(st_k, st_m, 1e-4)


def test_ssd_cpu_dispatch_takes_plain_version_and_never_launches():
    args = _ssd_torch(_ssd_np(11, 2, 24, 4, 16, 2, 16), "float32")
    before = SSD.ssd_scan.launches
    got = tops.ssd_scan(*args, chunk=8)
    want = SSD.ssd_scan_plain(*args, chunk=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert SSD.ssd_scan.launches == before


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    args = _ssd_torch(_ssd_np(12, 1, 8, 2, 16, 1, 16), "float32")
    before = SSD.ssd_scan.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        SSD.ssd_scan(*args, chunk=8)
    assert SSD.ssd_scan.launches == before


def test_ssd_dispatch_refuses_other_devices():
    args = [torch.empty(s, device="meta") for s in
            ((1, 8, 2, 16), (1, 8, 2), (2,), (1, 8, 1, 16), (1, 8, 1, 16), (2,))]
    with pytest.raises(ValueError, match="no kernel"):
        tops.ssd_scan(*args, chunk=8)


SSD_CUDA_CASES = [
    # B, S, H, P, G, N, chunk, dtype
    (1, 64, 2, 16, 1, 16, 16, "float32"),
    (2, 128, 4, 32, 2, 16, 32, "bfloat16"),
    (1, 96, 3, 16, 1, 32, 32, "float32"),
    (2, 256, 24, 64, 1, 128, 128, "bfloat16"),  # mamba2-130m's widths
    (2, 256, 24, 64, 1, 128, 128, "float32"),
    (2, 100, 24, 64, 1, 128, 100, "float32"),   # a 100-token prompt: chunk 100
    (2, 8, 24, 64, 1, 128, 8, "bfloat16"),      # an 8-token prompt: chunk 8
    (1, 60, 6, 7, 3, 5, 12, "float32"),         # odd P and N, 3 groups
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,dtype", SSD_CUDA_CASES)
def test_cuda_ssd_kernel_matches_plain(cuda, B, S, H, P, G, N, chunk, dtype):
    args = _ssd_torch(_ssd_np(13, B, S, H, P, G, N), dtype, cuda)
    before = SSD.ssd_scan.launches
    y, st = tops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert SSD.ssd_scan.launches == before + 1
    assert y.dtype == args[0].dtype and y.is_cuda and st.dtype == torch.float32
    want_y, want_st = SSD.ssd_scan_plain(*args, chunk=chunk)
    _close(y, want_y, SSD_TOL[dtype])
    _close(st, want_st, SSD_TOL[dtype])


def test_cuda_ssd_kernel_reads_strided_inputs(cuda):
    # x, B and C as slices of one fused (B, S, H*P + 2*G*N) activation
    B, S, H, P, G, N = 2, 64, 4, 16, 1, 32
    x, dt, A, Bm, Cm, D = _ssd_torch(_ssd_np(14, B, S, H, P, G, N), "float32", cuda)
    xbc = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, G * N), Cm.reshape(B, S, G * N)], -1)
    xs, bs, cs = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    xs, bs, cs = xs.reshape(B, S, H, P), bs.reshape(B, S, G, N), cs.reshape(B, S, G, N)
    assert not xs.is_contiguous() and xs.stride(1) == H * P + 2 * G * N
    y, st = SSD.ssd_scan(xs, dt, A, bs, cs, D, chunk=16)
    want_y, want_st = SSD.ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=16)
    _close(y, want_y, SSD_TOL["float32"])
    _close(st, want_st, SSD_TOL["float32"])


# past the zoo's widths (tests/test_torch_ssd_chunk.py holds the plain
# version there against the Pallas kernel): bf16 at N <= 128 takes the
# tensor cores, P in tiles of 64; f32, and bf16 past N 128, the CUDA-core
# kernel, N 256 in tiles of 64 rows
SSD_WIDE_CARD = [(80, 136), (80, 256), (128, 136), (128, 256), (80, 128), (128, 128)]  # (P, N)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,N", SSD_WIDE_CARD, ids=[f"P{p}-N{n}" for p, n in SSD_WIDE_CARD])
def test_cuda_ssd_kernels_at_wide_heads_and_states_match_plain(cuda, P, N, dtype):
    """Each variant the rule picks at these widths against the plain version,
    one launch a call.  f32 against the plain version in float64: at N 256
    unit-normal B and C make |y| reach hundreds, and two f32 summation
    orders part by more than 2e-4 where y cancels."""
    args = _ssd_torch(_ssd_np(19, 2, 384, 4, P, 1, N), dtype, cuda)
    tc = dtype == "bfloat16" and N <= SSD.N_TC_MAX
    kern = SSD.ssd_scan_tc if tc else SSD.ssd_scan_cuda_core
    assert SSD._variant_of(args[0], args[3], args[4]) == (SSD.TENSOR_CORE if tc else SSD.CUDA_CORE)
    before, before_v = SSD.ssd_scan.launches, kern.launches
    y, st = SSD.ssd_scan(*args, chunk=128)
    torch.cuda.synchronize()
    assert (SSD.ssd_scan.launches, kern.launches) == (before + 1, before_v + 1)
    precision = torch.float64 if dtype == "float32" else torch.float32
    want_y, want_st = SSD.ssd_scan_plain(*args, chunk=128, precision=precision)
    _close(y, want_y, SSD_TOL[dtype])
    _close(st, want_st, SSD_TOL[dtype])


def test_cuda_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm, D = _ssd_torch(_ssd_np(15, 1, 32, 2, 16, 1, 16), "float32", cuda)
    with pytest.raises(ValueError, match="multiple of chunk"):
        SSD.ssd_scan(x, dt, A, Bm, Cm, D, chunk=12)
    with pytest.raises(ValueError, match="chunk >= 1"):
        SSD.ssd_scan(x, dt, A, Bm, Cm, D, chunk=0)
    with pytest.raises(TypeError):
        SSD.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, D, chunk=16)
    with pytest.raises(TypeError):
        SSD.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, D, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        SSD.ssd_scan(x.transpose(2, 3), dt, A, Bm, Cm, D, chunk=16)
    with pytest.raises(ValueError, match="multiple of G"):
        SSD.ssd_scan(x, dt, A, Bm.expand(1, 32, 3, 16), Cm.expand(1, 32, 3, 16), D, chunk=16)
    with pytest.raises(ValueError, match="N <= 256"):
        wide = torch.zeros(1, 32, 1, 257, device=cuda)
        SSD.ssd_scan(x, dt, A, wide, wide, D, chunk=16)
