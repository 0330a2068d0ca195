"""The port's MoE channel mixer against the reference: ``router_probs``,
``moe_block`` (swiglu and gelu, capacity that drops tokens, dbrx's top-4) and
the dense oracle ``moe_reference``; then the MoE configs (phi3.5-moe, dbrx)
and the hybrid jamba period end to end — the parameter tree, forward,
prefill, decode, ``train_loss`` and every gradient leaf.  Inputs come from
numpy seeds and reach both packages as numpy arrays.

Tolerances: the block at 1e-5 in f32 and 2e-2 in bf16 (the reference's
kernel-level bf16 tolerance), the routing weights at 1e-6, model level at
the reference's 2e-3; routed indices and dropped-token sets exactly."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro.models.config import ArchConfig as RArch  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402
from repro_torch.models.layers import dense_init  # noqa: E402
from repro_torch.weights import (  # noqa: E402
    _to_numpy,
    opt_state_from_reference,
    opt_state_to_numpy,
    params_from_reference,
    params_to_numpy,
    stack_by_reference_key,
)

PHI, DBRX, JAMBA = "phi3.5-moe-42b-a6.6b", "dbrx-132b", "jamba-1.5-large-398b"
MOE_ARCHS = [PHI, DBRX, JAMBA]
TOL = 2e-3
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def jax_on_cpu():
    """JAX's default f32 products on a GPU are not full f32."""
    with jax.default_device(jax.devices("cpu")[0]):
        yield


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------
def _block_cfgs(case: str, dtype: str):
    """(reference cfg, port cfg) of one block case, at d=64, f=128."""
    kw = dict(name=f"moe-{case}", family="moe", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab=512, dtype=dtype, n_experts=8, top_k=2,
              period=("attn",), mlp_pattern=("moe",))
    if case == "gelu":
        kw["mlp_act"] = "gelu"
    elif case == "drops":
        kw["capacity_factor"] = 0.5
    elif case == "dbrx-top4":  # dbrx's routing: 16 experts, top-4
        dbrx = rconfigs.get(DBRX)
        kw.update(n_experts=dbrx.n_experts, top_k=dbrx.top_k)
    return RArch(**kw), TArch(**kw)


def _block_inputs(cfg, seed: int, B: int = 2, S: int = 32):
    """numpy params (the reference's shapes, N(0, 1/fan_in)) and x (B,S,d)."""
    rng = np.random.default_rng(seed)
    params = {
        name: (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
        for name, shape in RMoE.moe_param_shapes(cfg).items()
    }
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return params, x


def _as_jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _as_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _topk_margin(probs: np.ndarray, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th routing probability."""
    s = -np.sort(-probs, axis=-1)
    return float((s[:, k - 1] - s[:, k]).min()) if s.shape[-1] > k else float("inf")


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["swiglu", "dbrx-top4"])
def test_router_probs_match_reference(case, dtype):
    rcfg, tcfg = _block_cfgs(case, dtype)
    params, x = _block_inputs(rcfg, seed=0)
    x_flat = x.reshape(-1, rcfg.d_model)
    want_idx, want_w = RMoE.router_probs(_as_jax(x_flat, dtype), _as_jax(params["router"], dtype),
                                         rcfg.top_k)
    got_idx, got_w = TMoE.router_probs(_as_torch(x_flat, dtype), _as_torch(params["router"], dtype),
                                       tcfg.top_k)
    probs = torch.softmax(TMoE._dot_f32(_as_torch(x_flat, dtype), _as_torch(params["router"], dtype)), -1)
    print(f"{case} {dtype}: smallest top-{rcfg.top_k} margin {_topk_margin(probs.numpy(), rcfg.top_k):.3g}")
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert got_w.dtype == torch.float32
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_w.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["swiglu", "gelu", "drops", "dbrx-top4"])
def test_moe_block_matches_reference(case, dtype):
    rcfg, tcfg = _block_cfgs(case, dtype)
    params, x = _block_inputs(rcfg, seed=1)
    rp = {k: _as_jax(v, dtype) for k, v in params.items()}
    tp = {k: _as_torch(v, dtype) for k, v in params.items()}
    want = RMoE.moe_block(rp, _as_jax(x, dtype), rcfg)
    got = TMoE.moe_block(tp, _as_torch(x, dtype), tcfg)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == x.shape
    tol = BLOCK_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["swiglu", "gelu", "dbrx-top4"])
def test_moe_block_without_drops_matches_dense_oracle(case, dtype):
    """At capacity_factor 1e3 no token is dropped, and the block equals the
    reference's dense all-experts oracle; the port's oracle equals it too."""
    rcfg, tcfg = _block_cfgs(case, dtype)
    params, x = _block_inputs(rcfg, seed=2)
    want = RMoE.moe_reference({k: _as_jax(v, dtype) for k, v in params.items()}, _as_jax(x, dtype), rcfg)
    tp = {k: _as_torch(v, dtype) for k, v in params.items()}
    got = TMoE.moe_block(tp, _as_torch(x, dtype), tcfg, capacity_factor=1e3)
    oracle = TMoE.moe_reference(tp, _as_torch(x, dtype), tcfg)
    tol = BLOCK_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(oracle), _f32(want), atol=tol, rtol=tol)


def _selected_tokens(select_compute, to_pkg, from_pkg, weight, capacity: int) -> set:
    """The tokens an expert's ``_expert_select_compute`` takes, read from its
    output: with x = ones and identity weights every selected assigned token
    gets silu(1)·weight ≠ 0, every other row 0."""
    T = weight.shape[0]
    eye = to_pkg(np.eye(64, dtype=np.float32))
    out = from_pkg(select_compute(to_pkg(np.ones((T, 64), np.float32)), weight, eye, eye, eye,
                                  capacity, "swiglu"))
    return set(np.flatnonzero(np.abs(out).sum(-1) > 0).tolist())


@pytest.mark.slow
def test_capacity_drops_the_same_tokens_as_reference():
    """capacity_factor 0.5: each expert keeps its first ``capacity`` assigned
    tokens in flattened B*S order and drops the rest; the dropped set of
    every expert equals the reference's."""
    rcfg, tcfg = _block_cfgs("drops", "float32")
    params, x = _block_inputs(rcfg, seed=3)
    x_flat = x.reshape(-1, rcfg.d_model)
    T = x_flat.shape[0]
    cap = RMoE._capacity(T, rcfg, None)
    assert cap == TMoE._capacity(T, tcfg, None) == 8
    r_idx, r_w = RMoE.router_probs(jnp.asarray(x_flat), jnp.asarray(params["router"]), rcfg.top_k)
    t_idx, t_w = TMoE.router_probs(torch.from_numpy(x_flat), torch.from_numpy(params["router"]), tcfg.top_k)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(r_idx))

    def port_select(*args):
        idx, out = TMoE._expert_select_compute(*args)
        return torch.zeros(T, 64).index_add_(0, idx, out)

    n_dropped = 0
    for e in range(rcfg.n_experts):
        rw = RMoE._expert_weight(r_idx, r_w, e, rcfg.n_experts)
        tw = TMoE._expert_weight(t_idx, t_w, e)
        assigned = set(np.flatnonzero(tw.numpy() > 0).tolist())
        assert assigned == set(np.flatnonzero(np.asarray(rw) > 0).tolist())
        want = assigned - _selected_tokens(RMoE._expert_select_compute, jnp.asarray, np.asarray, rw, cap)
        got = assigned - _selected_tokens(port_select, torch.from_numpy, lambda t: t.numpy(), tw, cap)
        assert got == want, f"expert {e}"
        # first come, first served: the kept tokens are the earliest assigned
        assert got == set(sorted(assigned)[cap:])
        n_dropped += len(got)
    assert n_dropped > 0  # the case drops tokens


def test_sharded_context_raises():
    """A model axis that does not divide the experts raises, as the
    reference's does (the sharded path itself is held across processes in
    tests/test_torch_sharded_moe.py); a model axis of 1 is the local path."""
    _, tcfg = _block_cfgs("swiglu", "float32")
    params, x = _block_inputs(tcfg, seed=0)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="n_experts=8 not divisible by model axis 3"):
        TMoE.moe_block(tp, torch.from_numpy(x), tcfg, ctx=types.SimpleNamespace(model_size=3))
    single = TMoE.moe_block(tp, torch.from_numpy(x), tcfg, ctx=types.SimpleNamespace(model_size=1))
    assert torch.equal(single, TMoE.moe_block(tp, torch.from_numpy(x), tcfg))


def test_moe_block_gradients_flow_to_every_expert_leaf():
    """``index_add_`` into the f32 accumulator keeps the autograd graph: every
    leaf of a block whose experts all receive tokens gets a gradient."""
    _, tcfg = _block_cfgs("swiglu", "float32")
    params, x = _block_inputs(tcfg, seed=4)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    (TMoE.moe_block(tp, xt, tcfg) ** 2).sum().backward()
    for name, p in tp.items():
        assert p.grad is not None and p.grad.abs().sum(dim=tuple(range(1, p.ndim))).gt(0).all(), name
    assert xt.grad.abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_init_draws_a_stacked_leaf_slice_by_slice(dtype):
    """A stacked expert leaf drawn one matrix at a time keeps the init rule
    N(0, 1/fan_in) in every slice, in the leaf's dtype; on the CPU its values
    are those of one draw of the whole leaf (matrix sizes multiples of 16)."""
    shape, fan_in = (3, 4, 64, 96), 64
    dt = getattr(torch, dtype)
    w = dense_init(torch.Generator().manual_seed(7), shape, dt, fan_in, "cpu")
    assert tuple(w.shape) == shape and w.dtype == dt
    flat = w.float().reshape(12, -1)
    std = fan_in ** -0.5
    assert flat.mean(-1).abs().max().item() < 0.05 * std  # a mean of 6144 draws: ~0.013 std
    assert (flat.std(-1) / std - 1).abs().max().item() < 0.05
    whole = (torch.randn(shape, generator=torch.Generator().manual_seed(7)) * std).to(dt)
    assert torch.equal(w, whole)
    assert dense_init(None, shape, dt, fan_in, "meta").shape == shape


# ---------------------------------------------------------------------------
# The MoE and hybrid configs end to end
# ---------------------------------------------------------------------------
def _cfgs(arch, dtype="float32", **kw):
    r = dataclasses.replace(rconfigs.reduce_for_smoke(rconfigs.get(arch)), dtype=dtype, **kw)
    t = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get(arch)), dtype=dtype, **kw)
    return r, t


def _carried(arch, seed=0, dtype="float32", trainable=False, **kw):
    rcfg, tcfg = _cfgs(arch, dtype, **kw)
    params = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu", trainable=trainable)
    return rcfg, tcfg, params, model


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_f32(got) if isinstance(got, torch.Tensor) else np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_tree_and_round_trip_match_reference(arch, dtype):
    """Shapes, dtypes and init rules of ``init_params`` against the
    reference's ``param_shapes``; the reference's tree carried into the port
    and back, every leaf (experts and router by key path) bit for bit."""
    rcfg, tcfg, params, model = _carried(arch, dtype=dtype)
    shapes = dict(_leaves(RM.param_shapes(rcfg)))
    init = dict(_leaves(TM.init_params(tcfg, torch.Generator().manual_seed(0))))
    assert sorted(init) == sorted(shapes)
    for path, sds in shapes.items():
        assert tuple(init[path].shape) == tuple(sds.shape), path
        assert str(init[path].dtype) == f"torch.{sds.dtype.name}", path
    moe_pos = f"pos{tcfg.mlp_pattern.index('moe')}"
    for leaf, fan_in in (("router", tcfg.d_model), ("w_gate", tcfg.d_model), ("w_down", tcfg.d_ff)):
        w = init[f"/stack/{moe_pos}/mlp/{leaf}"].float()
        assert abs(w.std().item() / fan_in ** -0.5 - 1) < 0.1, leaf

    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    got = dict(_leaves(params_to_numpy(model)))
    assert sorted(got) == sorted(want)
    assert sum(a.size for a in want.values()) == sum(p.numel() for p in model.parameters())
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(a, np.float32), err_msg=path)
    assert torch.equal(
        model.layers[1][moe_pos].mlp["w_down"].float(),
        torch.from_numpy(np.array(params["stack"][moe_pos]["mlp"]["w_down"][1], np.float32)),
    )
    # the optimizer state's moments by the same key paths
    rng = np.random.default_rng(0)
    np_opt = {kind: jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
              for kind in ("m", "v")}
    np_opt["step"] = np.int32(3)
    back = opt_state_to_numpy(opt_state_from_reference(np_opt, model))
    for kind in ("m", "v"):
        for path, a in _leaves(np_opt[kind]):
            np.testing.assert_array_equal(dict(_leaves(back[kind]))[path], a, err_msg=f"{kind}{path}")
    assert int(back["step"]) == 3


@pytest.mark.slow
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-path", "plain-path"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_prefill_and_decode_match_reference(arch, use_kernels):
    """Default capacity (1.25): prefill routes B*S tokens, each decode step
    B tokens at capacity 1, so both drop tokens, as the reference does."""
    rcfg, tcfg, params, model = _carried(arch, seed=1)
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    B, S, N = 2, 40, 4  # S > attn_chunk=32; jamba's SSD pads 40 to 48 (chunk 16)
    tokens = np.random.default_rng(2).integers(0, rcfg.vocab, (B, S + N)).astype(np.int32)
    prompt = tokens[:, :S]
    want_h, _ = RM.forward(params, rcfg, {"tokens": jnp.asarray(prompt)})
    want_logits, (want_caches, want_len) = RM.prefill(params, rcfg, {"tokens": jnp.asarray(prompt)})
    with torch.inference_mode():
        got_h, _ = TM.forward(model, tcfg, {"tokens": torch.from_numpy(prompt).long()})
        got_logits, (got_caches, got_len) = TM.prefill(model, tcfg, {"tokens": torch.from_numpy(prompt).long()})
    _close(got_h, want_h, what="hidden")
    _close(got_logits, want_logits, what="prefill logits")
    assert sorted(got_caches) == sorted(want_caches)
    for pos, sub in want_caches.items():
        assert sorted(got_caches[pos]) == sorted(sub)
        for name, want in sub.items():
            assert tuple(got_caches[pos][name].shape) == want.shape, (pos, name)
            _close(got_caches[pos][name], want, what=f"{pos}/{name}")

    def grow(caches, pad):
        return {p: {k: pad(v) if k in ("k", "v") else v for k, v in sub.items()} for p, sub in caches.items()}

    rstate = (grow(want_caches, lambda v: jnp.pad(v, ((0, 0), (0, 0), (0, N), (0, 0), (0, 0)))), want_len)
    tstate = (grow(got_caches, lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, N))), got_len)
    for step in range(N):
        tok = tokens[:, S + step : S + step + 1]
        want_logits, rstate = RM.decode_step(params, rcfg, jnp.asarray(tok), rstate, jnp.int32(S + step))
        with torch.inference_mode():
            got_logits, tstate = TM.decode_step(model, tcfg, torch.from_numpy(tok).long(), tstate, S + step)
        _close(got_logits, want_logits, what=f"decode step {step}")
    for pos, sub in rstate[0].items():
        for name, want in sub.items():
            _close(tstate[0][pos][name], want, what=f"after decode {pos}/{name}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_prefill(arch):
    """Twin of tests/test_arch_smoke.py::test_decode_matches_prefill_hybrid:
    prefill of 8 tokens and 8 decode steps from an empty state give the same
    final logits, at a capacity that drops no token (as tests/test_serving.py
    sets it), since decode routes B tokens a step and prefill B*S."""
    _, tcfg = _cfgs(arch, capacity_factor=16.0)
    model = TM.DecoderLM.from_config(tcfg, seed=3, device="cpu")
    B, S = 2, 8
    tokens = torch.randint(0, tcfg.vocab, (B, S), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        logits_pre, _ = TM.prefill(model, tcfg, {"tokens": tokens})
        st = TM.init_decode_state(tcfg, B, S, device="cpu")
        for pos in range(S):
            logits_dec, st = TM.decode_step(model, tcfg, tokens[:, pos : pos + 1], st, pos)
    _close(logits_pre, logits_dec.numpy())


def _batches(vocab, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(), "labels": torch.from_numpy(toks[:, 1:]).long()})


def _port_grads(model):
    return stack_by_reference_key(((n, p.grad) for n, p in model.named_parameters()), _to_numpy)


def _ref_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.slow
@pytest.mark.parametrize("policy", ["minimal", "sublayer", "dots"])
@pytest.mark.parametrize("arch", [PHI, JAMBA])
def test_train_loss_and_every_grad_leaf_match_reference(arch, policy):
    """Through the capacity-limited block (the default 1.25 drops tokens at
    B*S = 80); every remat policy gives the same values as "minimal"."""
    rcfg, tcfg, params, model = _carried(arch, trainable=True)
    rb, tb = _batches(rcfg.vocab, 2, 40, seed=1)
    want, grads = jax.value_and_grad(RM.train_loss)(params, rcfg, rb, None, None, policy)
    loss = TM.train_loss(model, tcfg, tb, policy)
    loss.backward()
    _close(loss.item(), float(want), what="loss")
    got = _port_grads(model)
    assert len(got) == len(jax.tree.leaves(grads))
    for path, g in got.items():
        _close(g, _ref_leaf(grads, path), what="/".join(path))
    if policy != "minimal":
        base = params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu", trainable=True)
        want_loss = TM.train_loss(base, tcfg, tb, "minimal")
        want_loss.backward()
        assert loss.item() == want_loss.item()
        for path, g in _port_grads(base).items():
            np.testing.assert_array_equal(got[path], g, err_msg="/".join(path))
