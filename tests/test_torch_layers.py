"""The port's layers against the reference's, function by function, on the
same numpy inputs.  Tolerances are the reference's own: 2e-5 for attention
in f32 (tests/test_kernels.py), 2e-3 for whole blocks (the model-level
checks), 2e-2 for bf16."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

pytestmark = pytest.mark.slow  # compiles XLA programs, like the reference twins

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BLOCK_TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _both(a, dtype="float32"):
    """One numpy array as a (jax, torch) pair of the same values in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(j, t, tol):
    np.testing.assert_allclose(
        t.detach().float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol
    )


def _qkv(rng, B, Sq, Sk, H, KV, hd, dtype):
    return [
        _both(rng.standard_normal(shape), dtype)
        for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.standard_normal((2, 5, 48)) * 3, dtype)
    sj, st = _both(1 + 0.1 * rng.standard_normal(48), dtype)
    _close(RL.rms_norm(xj, sj, 1e-5), TL.rms_norm(xt, st, 1e-5), ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 120])
def test_apply_rope(hd, dtype):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((2, 37, 3, hd)), dtype)
    pos = np.arange(100, 137)
    got = TL.apply_rope(xt, torch.from_numpy(pos), 10_000.0)
    want = RL.apply_rope(xj, jnp.asarray(pos), 10_000.0)
    assert got.dtype == xt.dtype
    _close(want, got, ATTN_TOL[dtype])


MASKS = [
    pytest.param(dict(causal=True), 0, False, id="causal"),
    pytest.param(dict(causal=True, window=7), 0, False, id="window"),
    pytest.param(dict(causal=False), 0, False, id="full"),
    pytest.param(dict(causal=True, window=5), 11, True, id="decode-kvlen-offset"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kw,q_offset,with_kv_len", MASKS)
def test_plain_attention(mask_kw, q_offset, with_kv_len, dtype):
    rng = np.random.default_rng(2)
    Sq = 3 if q_offset else 24
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, Sq, 24, 4, 2, 16, dtype)
    kv_len = np.array([14, 20], np.int32) if with_kv_len else None
    rm = RL.AttnMask(**mask_kw, kv_len=None if kv_len is None else jnp.asarray(kv_len))
    tm = TL.AttnMask(**mask_kw, kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    want = RL.plain_attention(qj, kj, vj, rm, q_offset=q_offset)
    got = TL.plain_attention(qt, kt, vt, tm, q_offset=q_offset)
    assert got.dtype == qt.dtype and tuple(got.shape) == tuple(want.shape)
    _close(want, got, ATTN_TOL[dtype])


def test_plain_attention_fully_masked_rows_are_zero():
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 4, 8, 2, 2, 16, "float32")
    # kv_len 0 masks every key of every row
    tm = TL.AttnMask(causal=True, kv_len=torch.zeros(1, dtype=torch.int32))
    rm = RL.AttnMask(causal=True, kv_len=jnp.zeros(1, jnp.int32))
    got = TL.plain_attention(qt, kt, vt, tm)
    assert torch.equal(got, torch.zeros_like(got))
    _close(RL.plain_attention(qj, kj, vj, rm), got, 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kw,q_offset,with_kv_len", MASKS)
def test_chunked_attention(mask_kw, q_offset, with_kv_len, dtype):
    rng = np.random.default_rng(4)
    Sq = 3 if q_offset else 45
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, Sq, 45, 4, 1, 16, dtype)  # 45: padded chunk
    kv_len = np.array([30, 41], np.int32) if with_kv_len else None
    rm = RL.AttnMask(**mask_kw, kv_len=None if kv_len is None else jnp.asarray(kv_len))
    tm = TL.AttnMask(**mask_kw, kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    want = RL.chunked_attention(qj, kj, vj, rm, chunk=16, q_offset=q_offset)
    got = TL.chunked_attention(qt, kt, vt, tm, chunk=16, q_offset=q_offset)
    assert got.dtype == qt.dtype
    _close(want, got, ATTN_TOL[dtype])


def _block_params(rng, shapes, dtype):
    pj, pt = {}, {}
    for name, shape in shapes.items():
        scale = shape[0] ** -0.5 if len(shape) == 2 else 0.1
        pj[name], pt[name] = _both(rng.standard_normal(shape) * scale, dtype)
    return pj, pt


def _cfgs(arch, dtype, **kw):
    r = dataclasses.replace(rconfigs.reduce_for_smoke(rconfigs.get(arch)), dtype=dtype, **kw)
    t = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get(arch)), dtype=dtype, **kw)
    return r, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qkv_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("S", [24, 40], ids=["plain", "chunked"])
def test_attention_block_prefill(S, qkv_bias, dtype):
    rcfg, tcfg = _cfgs("h2o-danube-3-4b", dtype, qkv_bias=qkv_bias)
    rng = np.random.default_rng(5)
    pj, pt = _block_params(rng, RL.attn_param_shapes(rcfg), dtype)
    xj, xt = _both(rng.standard_normal((2, S, rcfg.d_model)), dtype)
    want, _ = RL.attention_block(pj, xj, rcfg, positions=jnp.arange(S))
    got, (k, v) = TL.attention_block(
        pt, xt, dataclasses.replace(tcfg, use_kernels=False), positions=torch.arange(S)
    )
    _close(want, got, BLOCK_TOL[dtype])
    assert tuple(k.shape) == (2, S, tcfg.n_kv_heads, tcfg.head_dim) and k.dtype == xt.dtype
    # the kernel path (its plain version on the CPU) gives the same block
    got_k, _ = TL.attention_block(pt, xt, tcfg, positions=torch.arange(S))
    _close(want, got_k, BLOCK_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_decode(dtype):
    rcfg, tcfg = _cfgs("h2o-danube-3-4b", dtype)
    rng = np.random.default_rng(6)
    pj, pt = _block_params(rng, RL.attn_param_shapes(rcfg), dtype)
    B, S_max, pos = 2, 24, 19
    KV, hd = rcfg.n_kv_heads, rcfg.head_dim
    Kj, Kt = _both(rng.standard_normal((B, S_max, KV, hd)), dtype)
    Vj, Vt = _both(rng.standard_normal((B, S_max, KV, hd)), dtype)
    xj, xt = _both(rng.standard_normal((B, 1, rcfg.d_model)), dtype)
    kv_len = np.array([pos + 1, pos - 3], np.int32)
    want, (Kw, Vw) = RL.attention_block(
        pj, xj, rcfg, positions=jnp.asarray([pos]), kv_cache=(Kj, Vj),
        cache_pos=jnp.int32(pos), kv_len=jnp.asarray(kv_len),
    )
    got, (Kg, Vg) = TL.attention_block(
        pt, xt, tcfg, positions=torch.tensor([pos]), kv_cache=(Kt, Vt),
        cache_pos=pos, kv_len=torch.from_numpy(kv_len),
    )
    _close(want, got, BLOCK_TOL[dtype])
    _close(Kw, Kg, BLOCK_TOL[dtype])
    _close(Vw, Vg, BLOCK_TOL[dtype])
    assert Kg is Kt  # written in place


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["internlm2-20b", "hubert-xlarge"], ids=["swiglu", "gelu"])
def test_mlp_block(arch, dtype):
    rcfg, tcfg = _cfgs(arch, dtype)
    rng = np.random.default_rng(7)
    pj, pt = _block_params(rng, RL.mlp_param_shapes(rcfg), dtype)
    xj, xt = _both(rng.standard_normal((2, 9, rcfg.d_model)) * 2, dtype)
    _close(RL.mlp_block(pj, xj, rcfg), TL.mlp_block(pt, xt, tcfg), BLOCK_TOL[dtype])


def test_param_shape_dicts_equal():
    for arch in ("h2o-danube-3-4b", "hubert-xlarge"):
        for bias in (False, True):
            rcfg, tcfg = _cfgs(arch, "float32", qkv_bias=bias)
            assert TL.attn_param_shapes(tcfg) == RL.attn_param_shapes(rcfg)
            assert TL.mlp_param_shapes(tcfg) == RL.mlp_param_shapes(rcfg)


def test_dense_init_scale_and_dtype():
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, (256, 512), torch.bfloat16, 256)
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (256, 512)
    assert abs(w.float().std().item() - 256 ** -0.5) < 2e-3
