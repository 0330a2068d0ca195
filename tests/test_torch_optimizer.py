"""The port's hand-written AdamW and train step against the reference's:
1 and 10 ``adamw_update`` steps on identical gradients (f32 and bf16
moments, the clip active and inactive), the weight-decay rule on stacked norm
scales against ``final_norm``, and ``make_train_step`` with two
microbatches.  f32 within rtol 1e-6 (pow and sqrt may round differently in
the last place), bf16 within one bf16 ulp (a bf16 parameter one ulp a step),
each at the largest value the element held; the train step at the
model-level 2e-3.  The CUDA case (one step on the card against the CPU) skips where
there is no card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.launch.steps import make_train_step as r_make_train_step  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.config import ArchConfig as RArch  # noqa: E402
from repro.training import optimizer as RO  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.weights import (  # noqa: E402
    opt_state_from_reference,
    opt_state_to_numpy,
    params_from_reference,
    params_to_numpy,
)

pytestmark = pytest.mark.slow  # compiles XLA programs, like tests/test_training_loop.py

LM_TEST = dict(name="lm-test", family="dense", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab=512, attn_chunk=64)


@pytest.fixture(autouse=True, scope="module")
def jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(dtype):
    rcfg, tcfg = RArch(**LM_TEST, dtype=dtype), TArch(**LM_TEST, dtype=dtype)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu", trainable=True)
    return rcfg, tcfg, params, model


def _grads(params, seed, scale):
    """Random gradients with the parameters' shapes and dtypes, scaled so
    that their global norm is ``scale`` times that of unit normals."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(scale * rng.standard_normal(p.shape).astype(np.float32), p.dtype), params
    )


def _port_grads(np_grads, model):
    tree = params_from_reference(np_grads, model.cfg, "cpu")  # grads as a model, by key path
    return {n: t.detach() for n, t in tree.named_parameters()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v, np.float32)


def _bf16_ulp(x):
    """One bf16 ulp at each of ``x``'s values (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _flat(params, opt):
    """Every value of a (params, opt_state) pair of numpy trees, by path."""
    out = {f"params{k}": v for k, v in _leaves(params)}
    for kind in ("m", "v"):
        out.update({f"{kind}{k}": v for k, v in _leaves(opt[kind])})
    return out


def _assert_close(got, want, largest, steps, bf16):
    """Each value within rtol 1e-6 (f32) or one bf16 ulp (bf16) of the
    largest magnitude the element held over the run: a step may round its
    global norm, pow or sqrt differently in the last place, a difference
    that ``b·m + (1-b)·g`` or ``p - lr·update`` can leave far larger than
    its result when they cancel.  A bf16 parameter may differ by one ulp
    per step: each step rounds it once and it carries every earlier
    difference in full (a moment scales its own by b1 or b2 first)."""
    assert sorted(got) == sorted(want)
    for path, b in want.items():
        if bf16:
            allowed = _bf16_ulp(largest[path]) * (steps if path.startswith("params") else 1)
        else:
            allowed = 1e-6 * largest[path]
        bad = np.abs(got[path] - b) > allowed
        assert not bad.any(), f"{path}: {bad.sum()} of {b.size} values differ by more than allowed"


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("clip", ["clip-inactive", "clip-active"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments, clip, steps):
    """bf16 moments run on a bf16 model (the reference picks them for large
    bf16 models); their values are held to one bf16 ulp."""
    bf16 = moments == "bfloat16"
    rcfg, tcfg, params, model = _pair("bfloat16" if bf16 else "float32")
    settings = RO.OptSettings(lr=1e-2, moment_dtype=moments)
    tsettings = TO.OptSettings(lr=1e-2, moment_dtype=moments)
    # the unit-normal grads of lm-test have a global norm of about 370
    scale = 1e-3 if clip == "clip-inactive" else 1.0
    r_opt = RO.adamw_init(params, settings)
    t_opt = TO.adamw_init(model, tsettings)
    largest = {k: np.abs(v) for k, v in _flat(*jax.tree.map(np.asarray, (params, r_opt))).items()}
    for i in range(steps):
        g = _grads(params, seed=i, scale=scale)
        gnorm = float(RO._global_norm(g))
        assert (gnorm > settings.grad_clip) == (clip == "clip-active"), gnorm
        params, r_opt = RO.adamw_update(params, g, r_opt, settings)
        model, t_opt = TO.adamw_update(model, _port_grads(jax.tree.map(np.asarray, g), model),
                                       t_opt, tsettings)
        want = _flat(*jax.tree.map(np.asarray, (params, r_opt)))
        largest = {k: np.maximum(largest[k], np.abs(v)) for k, v in want.items()}
    assert int(t_opt["step"]) == int(r_opt["step"]) == steps
    assert t_opt["m"]["embed"].dtype == getattr(torch, moments)
    _assert_close(_flat(params_to_numpy(model), opt_state_to_numpy(t_opt)), want, largest, steps, bf16)


def test_weight_decay_follows_the_reference_tree_rank():
    """The reference decays every leaf of rank > 1: its stacked norm scales
    (n_periods, d) are decayed, the top-level ``final_norm`` (d,) is not.
    With zero gradients the update is the decay alone."""
    rcfg, tcfg, params, model = _pair("float32")
    settings = RO.OptSettings()
    zero = jax.tree.map(jnp.zeros_like, params)
    params, _ = RO.adamw_update(params, zero, RO.adamw_init(params, settings), settings)
    model, _ = TO.adamw_update(model, {n: torch.zeros_like(p) for n, p in model.named_parameters()},
                               TO.adamw_init(model, TO.OptSettings()), TO.OptSettings())
    decayed = 1.0 - settings.lr * settings.weight_decay
    assert TO.decays("layers.0.pos0.norm1", model.layers[0]["pos0"].norm1)
    assert not TO.decays("final_norm", model.final_norm)
    np.testing.assert_allclose(model.layers[1]["pos0"].norm1.detach().numpy(), decayed, rtol=1e-6)
    np.testing.assert_array_equal(model.final_norm.detach().numpy(), 1.0)
    for (path, a), (_, b) in zip(sorted(_leaves(params_to_numpy(model))), sorted(_leaves(params))):
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=path)


def test_opt_state_shapes_match_reference():
    rcfg, tcfg = RArch(**LM_TEST, dtype="bfloat16"), TArch(**LM_TEST, dtype="bfloat16")
    for moments in ("float32", "bfloat16"):
        want = RO.opt_state_shapes(RM.param_shapes(rcfg), RO.OptSettings(moment_dtype=moments))
        got = TO.opt_state_shapes(TM.param_shapes(tcfg), TO.OptSettings(moment_dtype=moments))
        assert got["step"].dtype == torch.int32 and got["step"].shape == ()
        for kind in ("m", "v"):
            w = dict(_leaves_meta(want[kind]))
            g = dict(_leaves_meta(got[kind]))
            assert sorted(g) == sorted(w)
            for path, leaf in w.items():
                assert tuple(g[path].shape) == tuple(leaf.shape), path
                assert str(g[path].dtype) == f"torch.{leaf.dtype}", path
                assert g[path].device.type == "meta"


def _leaves_meta(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_meta(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def test_opt_state_carries_between_the_trees():
    rcfg, tcfg, params, model = _pair("float32")
    settings = RO.OptSettings()
    _, r_opt = RO.adamw_update(params, _grads(params, 0, 1e-2), RO.adamw_init(params, settings), settings)
    np_opt = jax.tree.map(np.asarray, r_opt)
    back = opt_state_to_numpy(opt_state_from_reference(np_opt, model))
    assert int(back["step"]) == 1
    for kind in ("m", "v"):
        for (pa, a), (pb, b) in zip(sorted(_leaves(back[kind])), sorted(_leaves(np_opt[kind]))):
            assert pa == pb
            np.testing.assert_array_equal(a, b)


def _step_batch(vocab, B=4, S=96, seed=5):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(), "labels": torch.from_numpy(toks[:, 1:]).long()})


def _close_tree(got, want, tol=2e-3):
    for (pa, a), (pb, b) in zip(sorted(_leaves(got)), sorted(_leaves(want))):
        assert pa == pb
        np.testing.assert_allclose(a, b, atol=tol * max(np.abs(b).max(), 1e-12), rtol=tol, err_msg=pa)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    rcfg, tcfg, params, model = _pair("float32")
    settings, tsettings = RO.OptSettings(lr=1e-3), TO.OptSettings(lr=1e-3)
    rb, tb = _step_batch(rcfg.vocab)
    step = jax.jit(r_make_train_step(rcfg, settings, microbatches=microbatches))
    loss, params, r_opt = step(params, RO.adamw_init(params, settings), rb)
    t_loss, model, t_opt = make_train_step(tcfg, tsettings, microbatches=microbatches)(
        model, TO.adamw_init(model, tsettings), tb
    )
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=2e-3, atol=2e-3)
    _close_tree(params_to_numpy(model), params)
    got, want = opt_state_to_numpy(t_opt), jax.tree.map(np.asarray, r_opt)
    for kind in ("m", "v"):
        _close_tree(got[kind], want[kind])
    assert all(p.grad is None for p in model.parameters())


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 step of lm-test on the card against the same step on the CPU
    (the path held against JAX above) at 2e-3."""
    _, tcfg, params, _ = _pair("float32")
    np_tree = jax.tree.map(np.asarray, params)
    settings = TO.OptSettings(lr=1e-3)
    _, tb = _step_batch(tcfg.vocab)
    out = {}
    for dev in ("cpu", cuda):
        model = params_from_reference(np_tree, tcfg, dev, trainable=True)
        batch = {k: v.to(dev) for k, v in tb.items()}
        loss, model, opt = make_train_step(tcfg, settings)(model, TO.adamw_init(model, settings), batch)
        out[str(dev)] = (loss.item(), params_to_numpy(model), opt_state_to_numpy(opt))
    (l_cpu, p_cpu, o_cpu), (l_gpu, p_gpu, o_gpu) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=2e-3, atol=2e-3)
    _close_tree(p_gpu, p_cpu)
    for kind in ("m", "v"):
        _close_tree(o_gpu[kind], o_cpu[kind])
