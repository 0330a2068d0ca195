"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), function by function, on the same numpy
inputs.  Tolerances are the reference's own: 2e-4 (f32) and 2e-2 (bf16) for
the SSD functions (tests/test_kernels.py), 2e-3 for whole blocks (the
model-level checks).  The block runs on the mamba2-130m smoke config, with
the kernel path (``use_kernels``; its plain version on the CPU) against the
reference's Pallas path (``use_pallas``, interpret mode) and the chunked
path against the chunked path.

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssm.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

pytestmark = pytest.mark.slow  # compiles XLA programs, like the reference twins

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
BLOCK_TOL = 2e-3
# B, S, H, P, G, N, chunk: the SSD sweep of tests/test_kernels.py
SSD_SHAPES = [
    (1, 64, 2, 16, 1, 16, 16),   # minimal
    (2, 128, 4, 32, 2, 16, 32),  # grouped B/C
    (1, 96, 3, 16, 1, 32, 32),   # odd head count, 3 chunks
]


def _both(a, dtype="float32"):
    """One numpy array as a (jax, torch) pair of the same values in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def ssd_inputs(seed, B, S, H, P, G, N):
    """x, dt, A, B, C, D as numpy f32, drawn like tests/test_kernels.py's."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))  # softplus
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, S, G, N))
    Cm = rng.standard_normal((B, S, G, N))
    D = 1.0 + 0.1 * rng.standard_normal(H)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]


def _ssd_pairs(arrays, dtype):
    """x/B/C in ``dtype``; dt, A and D f32, as the model streams them."""
    x, dt, A, Bm, Cm, D = arrays
    return [_both(a, dtype if i in (0, 3, 4) else "float32")
            for i, a in enumerate((x, dt, A, Bm, Cm, D))]


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=["minimal", "grouped", "odd-heads"])
def test_ssd_reference_matches(shape):
    B, S, H, P, G, N, _ = shape
    pairs = _ssd_pairs(ssd_inputs(0, B, S, H, P, G, N), "float32")
    want = RS.ssd_reference(*(j for j, _ in pairs))
    got = TS.ssd_reference(*(t for _, t in pairs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, H, P)
    _close(got, want, SSD_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=["minimal", "grouped", "odd-heads"])
def test_ssd_chunked_matches(shape, dtype):
    B, S, H, P, G, N, chunk = shape
    pairs = _ssd_pairs(ssd_inputs(1, B, S, H, P, G, N), dtype)
    y_r, st_r = RS.ssd_chunked(*(j for j, _ in pairs), chunk=chunk)
    y_t, st_t = TS.ssd_chunked(*(t for _, t in pairs), chunk=chunk)
    # y is rounded to x's dtype per chunk, then x·D is added in f32
    assert y_t.dtype == torch.float32 and st_t.dtype == torch.float32
    assert tuple(st_t.shape) == (B, H, P, N)
    _close(y_t, y_r, SSD_TOL[dtype])
    _close(st_t, st_r, SSD_TOL[dtype])


def test_ssd_chunked_matches_sequential_scan():
    B, S, H, P, G, N, chunk = SSD_SHAPES[1]
    _, t = zip(*_ssd_pairs(ssd_inputs(2, B, S, H, P, G, N), "float32"))
    y_c, _ = TS.ssd_chunked(*t, chunk=chunk)
    _close(y_c, TS.ssd_reference(*t).numpy(), SSD_TOL["float32"])


def test_ssd_decode_step_matches():
    rng = np.random.default_rng(3)
    B, H, P, G, N = 2, 4, 16, 2, 16
    x, dt, A, Bm, Cm, D = ssd_inputs(3, B, 1, H, P, G, N)
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    args = [state, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D]
    pairs = [_both(a) for a in args]
    y_r, st_r = RS.ssd_decode_step(*(j for j, _ in pairs))
    y_t, st_t = TS.ssd_decode_step(*(t for _, t in pairs))
    _close(y_t, y_r, SSD_TOL["float32"])
    _close(st_t, st_r, SSD_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches(dtype):
    rng = np.random.default_rng(4)
    B, S, C, K = 2, 12, 24, 4
    xj, xt = _both(rng.standard_normal((B, S, C)), dtype)
    wj, wt = _both(rng.standard_normal((K, C)) * 0.5)
    bj, bt = _both(rng.standard_normal(C) * 0.1)
    got = TS._causal_conv(xt, wt, bt)
    assert got.dtype == torch.float32  # model-dtype activations times f32 taps
    _close(got, RS._causal_conv(xj, wj, bj), BLOCK_TOL)


def _cfgs(dtype="float32", **kw):
    r = dataclasses.replace(rconfigs.reduce_for_smoke(rconfigs.get("mamba2-130m")), dtype=dtype, **kw)
    t = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get("mamba2-130m")), dtype=dtype, **kw)
    return r, t


def block_params(cfg, seed=5):
    """One SSM block's parameters as numpy f32, by the reference's names."""
    rng = np.random.default_rng(seed)
    shapes = RS.ssm_param_shapes(cfg)
    out = {}
    for name, shape in shapes.items():
        a = rng.standard_normal(shape)
        if name in ("in_proj", "out_proj"):
            a = a * shape[0] ** -0.5
        elif name == "conv_w":
            a = a * 0.5
        elif name in ("gate_norm", "D"):
            a = 1.0 + 0.1 * a
        else:  # conv_b, A_log, dt_bias
            a = 0.3 * a
        out[name] = a.astype(np.float32)
    return out


def test_param_shapes_and_carry_match():
    rcfg, tcfg = _cfgs()
    assert TS.ssm_param_shapes(tcfg) == RS.ssm_param_shapes(rcfg)
    want = RS.ssm_empty_carry(rcfg, 3)
    got = TS.ssm_empty_carry(tcfg, 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and not g.any()
    width = RS.ssm_param_shapes(rcfg)["in_proj"][1]
    zj = jnp.arange(2 * width, dtype=jnp.float32).reshape(1, 2, width)
    for g, w in zip(TS._split_proj(tcfg, torch.from_numpy(np.array(zj))), RS._split_proj(rcfg, zj)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("S", [40, 8], ids=["padded-S40-chunk16", "chunk-eq-S8"])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-path", "chunked-path"])
def test_ssm_block_matches(S, use_kernels):
    rcfg, tcfg = _cfgs()
    rcfg = dataclasses.replace(rcfg, use_pallas=use_kernels)
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    params = block_params(rcfg)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    xj, xt = _both(np.random.default_rng(6).standard_normal((2, S, rcfg.d_model)))
    y_r, (st_r, tail_r) = RS.ssm_block(pj, xj, rcfg)
    y_t, (st_t, tail_t) = TS.ssm_block(pt, xt, tcfg)
    assert y_t.dtype == torch.float32 and tuple(y_t.shape) == (2, S, rcfg.d_model)
    _close(y_t, y_r, BLOCK_TOL)
    _close(st_t, st_r, BLOCK_TOL)
    assert tuple(tail_t.shape) == tail_r.shape == (2, rcfg.ssm_conv - 1, tail_r.shape[-1])
    _close(tail_t, tail_r, BLOCK_TOL)


def test_ssm_block_decode_matches():
    rcfg, tcfg = _cfgs()
    params = block_params(rcfg, seed=7)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    rng = np.random.default_rng(8)
    st0, tail0 = (rng.standard_normal(c.shape).astype(np.float32)
                  for c in RS.ssm_empty_carry(rcfg, 2))
    xj, xt = _both(rng.standard_normal((2, 1, rcfg.d_model)))
    (stj, stt), (tj, tt) = _both(st0), _both(tail0)
    y_r, (st_r, tail_r) = RS.ssm_block_decode(pj, xj, rcfg, (stj, tj))
    y_t, (st_t, tail_t) = TS.ssm_block_decode(pt, xt, tcfg, (stt, tt))
    _close(y_t, y_r, BLOCK_TOL)
    _close(st_t, st_r, BLOCK_TOL)
    _close(tail_t, tail_r, BLOCK_TOL)
