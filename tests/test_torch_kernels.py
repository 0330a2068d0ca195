"""The flash-attention kernel's plain version against the reference's Pallas
kernel (interpret mode) and its oracle, over the sweep of
tests/test_kernels.py plus head_dim 120; the CPU dispatch; and, on a CUDA
card only, the hand-written kernel against its plain version.

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
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

pytestmark = pytest.mark.slow  # XLA interpret-mode kernels, like tests/test_kernels.py

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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
