"""The port's model against the reference on carried weights, for the dense
configs and mamba2-130m: the parameter tree, forward, prefill logits and
caches, decode steps, and prefill against token-by-token decode.  f32 at the
reference's model-level 2e-3."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.weights import params_from_reference, params_to_numpy  # noqa: E402

pytestmark = pytest.mark.slow  # compiles XLA programs, like tests/test_arch_smoke.py

DENSE = ["h2o-danube-3-4b", "internlm2-20b"]
TOL = 2e-3


def _cfgs(arch, dtype="float32", **kw):
    r = dataclasses.replace(rconfigs.reduce_for_smoke(rconfigs.get(arch)), dtype=dtype, **kw)
    t = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get(arch)), dtype=dtype, **kw)
    return r, t


def _carried(arch, seed=0, dtype="float32", **kw):
    rcfg, tcfg = _cfgs(arch, dtype, **kw)
    params = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    np_tree = jax.tree.map(np.asarray, params)
    return rcfg, tcfg, params, params_from_reference(np_tree, tcfg, device="cpu")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "qkv_bias"])
@pytest.mark.parametrize("arch", DENSE)
def test_weights_round_trip_every_leaf(arch, bias, dtype):
    rcfg, tcfg, params, model = _carried(arch, dtype=dtype, qkv_bias=bias)
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    got = dict(_leaves(params_to_numpy(model)))
    assert sorted(got) == sorted(want)
    n_leaf_elems = sum(a.size for a in want.values())
    assert n_leaf_elems == sum(p.numel() for p in model.parameters()) == tcfg.param_count()
    for path, a in want.items():
        b = got[path]
        assert b.shape == a.shape, path
        # numpy has no bf16 of its own: bf16 leaves come back as exact f32
        assert b.dtype == (np.float32 if a.dtype.name == "bfloat16" else a.dtype), path
        np.testing.assert_array_equal(b, np.asarray(a, np.float32), err_msg=path)
    # the per-period parameter is the reference's slice, by key path
    assert torch.equal(
        model.layers[1]["pos0"].mixer["wq"].float(),
        torch.from_numpy(np.array(params["stack"]["pos0"]["mixer"]["wq"][1], np.float32)),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_init_params_tree_matches_reference_shapes(arch, dtype):
    rcfg, tcfg = _cfgs(arch, dtype)
    want = dict(_leaves(RM.param_shapes(rcfg)))
    got = dict(_leaves(TM.init_params(tcfg, torch.Generator().manual_seed(0))))
    assert sorted(got) == sorted(want)
    for path, sds in want.items():
        assert tuple(got[path].shape) == tuple(sds.shape), path
        assert str(got[path].dtype) == f"torch.{sds.dtype.name}", path
    assert dict(_leaves(TM.param_shapes(tcfg))).keys() == want.keys()
    # init rules: norms are ones, dense leaves are N(0, 1/fan_in)
    assert torch.equal(got["/final_norm"], torch.ones_like(got["/final_norm"]))
    assert torch.equal(got["/stack/pos0/norm1"], torch.ones_like(got["/stack/pos0/norm1"]))
    wq = got["/stack/pos0/mixer/wq"].float()
    assert abs(wq.std().item() - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5


def test_from_config_seeded_and_frozen():
    _, tcfg = _cfgs("h2o-danube-3-4b")
    a = TM.DecoderLM.from_config(tcfg, seed=3, device="cpu")
    b = TM.DecoderLM.from_config(tcfg, seed=3, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb) and not pa.requires_grad


def test_tree_with_wrong_shape_is_refused():
    rcfg, tcfg = _cfgs("internlm2-20b")
    np_tree = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(0), rcfg))
    np_tree["stack"]["pos0"]["mixer"]["wq"] = np_tree["stack"]["pos0"]["mixer"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_reference(np_tree, tcfg, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken, not refused")
    _, tcfg = _cfgs("h2o-danube-3-4b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.DecoderLM.from_config(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_decode_state(tcfg, 1, 8)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-path", "plain-path"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, use_kernels):
    rcfg, tcfg, params, model = _carried(arch, seed=1)
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    B, S, N = 2, 40, 4  # S > attn_chunk=32: the reference takes its chunked path
    tokens = np.random.default_rng(0).integers(0, rcfg.vocab, (B, S + N)).astype(np.int32)
    prompt = tokens[:, :S]

    want_logits, (want_caches, want_len) = RM.prefill(params, rcfg, {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        got_logits, (got_caches, got_len) = TM.prefill(
            model, tcfg, {"tokens": torch.from_numpy(prompt).long()}
        )
    assert got_logits.dtype == torch.float32 and tuple(got_logits.shape) == (B, rcfg.vocab)
    _close(got_logits, want_logits)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for pos in want_caches:
        for name in ("k", "v"):
            assert tuple(got_caches[pos][name].shape) == want_caches[pos][name].shape
            _close(got_caches[pos][name], want_caches[pos][name])

    # grow both caches and take N decode steps on the same tokens
    pad = ((0, 0), (0, 0), (0, N), (0, 0), (0, 0))
    rstate = ({p: {k: jnp.pad(v, pad) for k, v in sub.items()} for p, sub in want_caches.items()},
              want_len)
    tstate = ({p: {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, N)) for k, v in sub.items()}
               for p, sub in got_caches.items()}, got_len)
    for step in range(N):
        tok = tokens[:, S + step : S + step + 1]
        want_logits, rstate = RM.decode_step(params, rcfg, jnp.asarray(tok), rstate, jnp.int32(S + step))
        with torch.inference_mode():
            got_logits, tstate = TM.decode_step(model, tcfg, torch.from_numpy(tok).long(), tstate, S + step)
        _close(got_logits, want_logits)
        np.testing.assert_array_equal(tstate[1].numpy(), np.asarray(rstate[1]))
    for pos in rstate[0]:
        for name in ("k", "v"):
            _close(tstate[0][pos][name], rstate[0][pos][name])


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill_dense(arch):
    """Twin of tests/test_arch_smoke.py::test_decode_matches_prefill_hybrid on
    the dense configs: prefill of 8 tokens and 8 decode steps from an empty
    state give the same final logits."""
    _, tcfg = _cfgs(arch)
    model = TM.DecoderLM.from_config(tcfg, seed=3, device="cpu")
    B, S = 1, 8
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, tcfg.vocab, (B, S), generator=g)
    with torch.inference_mode():
        logits_pre, _ = TM.prefill(model, tcfg, {"tokens": tokens})
        st = TM.init_decode_state(tcfg, B, S, device="cpu")
        for pos in range(S):
            logits_dec, st = TM.decode_step(model, tcfg, tokens[:, pos : pos + 1], st, pos)
    _close(logits_pre, logits_dec.numpy())


def test_decode_state_k_and_v_are_separate():
    _, tcfg = _cfgs("h2o-danube-3-4b")
    caches, kv_len = TM.init_decode_state(tcfg, 2, 16, device="cpu")
    k, v = caches["pos0"]["k"], caches["pos0"]["v"]
    assert k.data_ptr() != v.data_ptr()
    assert tuple(k.shape) == (tcfg.n_periods, 2, 16, tcfg.n_kv_heads, tcfg.head_dim)
    assert kv_len.dtype == torch.int32 and kv_len.tolist() == [0, 0]


# ---------------------------------------------------------------------------
# mamba2-130m (the SSM slice)
# ---------------------------------------------------------------------------
SSM = "mamba2-130m"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_param_shapes_match_reference(dtype):
    rcfg, tcfg = _cfgs(SSM, dtype)
    want = dict(_leaves(RM.param_shapes(rcfg)))
    got = dict(_leaves(TM.param_shapes(tcfg)))
    assert sorted(got) == sorted(want)
    assert "/head" not in got  # tied embeddings
    for path, sds in want.items():
        assert tuple(got[path].shape) == tuple(sds.shape), path
        assert str(got[path].dtype) == f"torch.{sds.dtype.name}", path
    # the small SSM leaves stay f32 inside a bf16 model
    for leaf in ("A_log", "D", "dt_bias"):
        assert got[f"/stack/pos0/mixer/{leaf}"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_weights_round_trip_every_leaf(dtype):
    rcfg, tcfg, params, model = _carried(SSM, dtype=dtype)
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    got = dict(_leaves(params_to_numpy(model)))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        b = got[path]
        assert b.shape == a.shape, path
        assert b.dtype == (np.float32 if a.dtype.name == "bfloat16" else a.dtype), path
        np.testing.assert_array_equal(b, np.asarray(a, np.float32), err_msg=path)
    assert model.layers[1]["pos0"].mixer["A_log"].dtype == torch.float32
    assert torch.equal(
        model.layers[1]["pos0"].mixer["in_proj"].float(),
        torch.from_numpy(np.array(params["stack"]["pos0"]["mixer"]["in_proj"][1], np.float32)),
    )


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-path", "chunked-path"])
def test_ssm_forward_prefill_and_decode_match_reference(use_kernels):
    """use_kernels against the reference's use_pallas (the Pallas SSD kernel
    in interpret mode), and the chunked path against the chunked path."""
    rcfg, tcfg, params, model = _carried(SSM, seed=1)
    rcfg = dataclasses.replace(rcfg, use_pallas=use_kernels)
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    B, S, N = 2, 40, 4  # S = 40 is padded to 48 inside the block (chunk 16)
    tokens = np.random.default_rng(2).integers(0, rcfg.vocab, (B, S + N)).astype(np.int32)
    prompt = tokens[:, :S]

    want_h, _ = RM.forward(params, rcfg, {"tokens": jnp.asarray(prompt)})
    want_logits, (want_caches, want_len) = RM.prefill(params, rcfg, {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        got_h, _ = TM.forward(model, tcfg, {"tokens": torch.from_numpy(prompt).long()})
        got_logits, (got_caches, got_len) = TM.prefill(
            model, tcfg, {"tokens": torch.from_numpy(prompt).long()}
        )
    _close(got_h, want_h)
    _close(got_logits, want_logits)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for name in ("state", "conv"):
        assert tuple(got_caches["pos0"][name].shape) == want_caches["pos0"][name].shape
        assert got_caches["pos0"][name].dtype == torch.float32
        _close(got_caches["pos0"][name], want_caches["pos0"][name])

    rstate, tstate = (want_caches, want_len), (got_caches, got_len)
    for step in range(N):
        tok = tokens[:, S + step : S + step + 1]
        want_logits, rstate = RM.decode_step(params, rcfg, jnp.asarray(tok), rstate, jnp.int32(S + step))
        with torch.inference_mode():
            got_logits, tstate = TM.decode_step(model, tcfg, torch.from_numpy(tok).long(), tstate, S + step)
        _close(got_logits, want_logits)
    for name in ("state", "conv"):  # written in place by the port
        assert tstate[0]["pos0"][name] is got_caches["pos0"][name]
        _close(tstate[0]["pos0"][name], rstate[0]["pos0"][name])


def test_decode_matches_prefill_ssm():
    """Twin of tests/test_arch_smoke.py::test_decode_matches_prefill_hybrid on
    mamba2-130m: prefill of 8 tokens and 8 decode steps from an empty state
    give the same final logits."""
    _, tcfg = _cfgs(SSM)
    model = TM.DecoderLM.from_config(tcfg, seed=3, device="cpu")
    B, S = 2, 8
    tokens = torch.randint(0, tcfg.vocab, (B, S), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        logits_pre, _ = TM.prefill(model, tcfg, {"tokens": tokens})
        st = TM.init_decode_state(tcfg, B, S, device="cpu")
        for pos in range(S):
            logits_dec, st = TM.decode_step(model, tcfg, tokens[:, pos : pos + 1], st, pos)
    _close(logits_pre, logits_dec.numpy())


def test_ssm_decode_state_matches_reference_layout():
    rcfg, tcfg = _cfgs(SSM)
    want, want_len = RM.init_decode_state(rcfg, 3, 16)
    got, got_len = TM.init_decode_state(tcfg, 3, 16, device="cpu")
    assert sorted(got["pos0"]) == sorted(want["pos0"]) == ["conv", "state"]
    for name in ("state", "conv"):
        assert tuple(got["pos0"][name].shape) == want["pos0"][name].shape
        assert got["pos0"][name].dtype == torch.float32 and not got["pos0"][name].any()
    assert got_len.dtype == torch.int32 and tuple(got_len.shape) == want_len.shape


@pytest.mark.parametrize("arch", [SSM, "h2o-danube-3-4b"])
def test_init_params_without_generator_is_seeded(arch):
    _, tcfg = _cfgs(arch)
    a = dict(_leaves(TM.init_params(tcfg, device="cpu")))
    b = dict(_leaves(TM.init_params(tcfg, device="cpu")))
    want = dict(_leaves(TM.init_params(tcfg, torch.Generator().manual_seed(0))))
    for path, t in a.items():
        assert t.device.type == "cpu"
        assert torch.equal(t, b[path]) and torch.equal(t, want[path]), path
    meta = dict(_leaves(TM.init_params(tcfg, device="meta")))
    assert all(t.is_meta for t in meta.values()) and meta.keys() == a.keys()


def test_init_params_defaults_to_the_card():
    _, tcfg = _cfgs(SSM)
    if torch.cuda.is_available():
        leaves = dict(_leaves(TM.init_params(tcfg)))
        assert all(t.is_cuda for t in leaves.values())
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TM.init_params(tcfg)
