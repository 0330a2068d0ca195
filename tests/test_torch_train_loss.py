"""The port's training loss against the reference: ``chunked_ce_loss`` (the
dropped tail, masked labels), ``train_loss`` and every gradient leaf against
``jax.value_and_grad(M.train_loss)`` on carried weights under each remat
policy, the kernel-free training path, and the dispatch's refusal to run a
forward-only kernel on inputs that require grad.  f32 at the reference's
model-level 2e-3; the CUDA case (the f32-output product's gradient) skips
where there is no card."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.config import ArchConfig as RArch  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402
from repro_torch.weights import _to_numpy, params_from_reference, stack_by_reference_key  # noqa: E402

pytestmark = pytest.mark.slow  # compiles XLA programs, like tests/test_training_loop.py

TOL = 2e-3
POLICIES = ["minimal", "sublayer", "dots"]
# tests/test_training_loop.py:19-22
LM_TEST = dict(name="lm-test", family="dense", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab=512, dtype="float32", attn_chunk=64)


@pytest.fixture(autouse=True, scope="module")
def jax_on_cpu():
    """JAX's default f32 products on a GPU are not full f32."""
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the f32-output bf16 product runs only there")
    return torch.device("cuda")


def _cfgs(arch):
    if arch == "lm-test":
        return RArch(**LM_TEST), TArch(**LM_TEST)
    r = dataclasses.replace(rconfigs.reduce_for_smoke(rconfigs.get(arch)), dtype="float32")
    t = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get(arch)), dtype="float32")
    return r, t


def _carried(arch, seed=0):
    rcfg, tcfg = _cfgs(arch)
    params = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu", trainable=True)
    return rcfg, tcfg, params, model


def _batches(vocab, B, S, seed=0, masked=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[:, :masked] = -1  # e.g. frontend positions
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(), "labels": torch.from_numpy(labels).long()})


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _port_grads(model):
    """The model's gradients in the reference's tree layout, by key path."""
    return stack_by_reference_key(((n, p.grad) for n, p in model.named_parameters()), _to_numpy)


def _ref_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("S,masked", [(600, 0), (600, 40), (300, 17)],
                         ids=["S600-tail88", "S600-masked", "S300-one-chunk"])
def test_chunked_ce_loss_matches_reference(S, masked):
    """S=600 keeps 512 positions (the 88-token tail is dropped, as in the
    reference); masked labels (< 0) leave the mean; S < 512 is one chunk."""
    rcfg, tcfg, params, model = _carried("lm-test")
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    rb, tb = _batches(rcfg.vocab, 2, S, seed=4, masked=masked)

    def ref_loss(h, p):
        return RM.chunked_ce_loss(p, rcfg, h, rb["labels"])

    want, (want_dh, want_dp) = jax.value_and_grad(ref_loss, argnums=(0, 1))(jnp.asarray(hidden), params)
    h = torch.from_numpy(hidden).requires_grad_()
    got = TM.chunked_ce_loss(model, tcfg, h, tb["labels"])
    got.backward()
    _close(got.item(), float(want), what="loss")
    _close(h.grad.numpy(), want_dh, what="d hidden")
    _close(model.head.grad.numpy(), want_dp["head"], what="d head")
    if S > 512:  # the dropped tail has no gradient
        assert not h.grad[:, 512:].any()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["lm-test", "mamba2-130m"])
def test_train_loss_and_every_grad_leaf_match_reference(arch, policy):
    rcfg, tcfg, params, model = _carried(arch)
    S = 130 if arch == "lm-test" else 40  # lm-test: 3 KV chunks of 64, padded
    rb, tb = _batches(rcfg.vocab, 2, S, seed=1)
    want, grads = jax.value_and_grad(RM.train_loss)(params, rcfg, rb, None, None, policy)
    loss = TM.train_loss(model, tcfg, tb, policy)
    loss.backward()
    _close(loss.item(), float(want), what="loss")
    got = _port_grads(model)
    assert len(got) == len(jax.tree.leaves(grads))
    for path, g in got.items():
        _close(g, _ref_leaf(grads, path), what="/".join(path))
    if policy != "minimal":  # the policies recompute; they never change a value
        base = params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu", trainable=True)
        want_loss = TM.train_loss(base, tcfg, tb, "minimal")
        want_loss.backward()
        assert loss.item() == want_loss.item()
        for path, g in _port_grads(base).items():
            np.testing.assert_array_equal(got[path], g, err_msg="/".join(path))


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.mm:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_saves_the_projections():
    """"dots" keeps the projections' products for the backward, so it
    recomputes none of them; "minimal" recomputes every one."""
    _, tcfg, _, model = _carried("lm-test")
    _, tb = _batches(tcfg.vocab, 2, 64)
    counts = {}
    for policy in ("minimal", "dots"):
        loss = TM.train_loss(model, tcfg, tb, policy)
        with _CountMM() as mode:
            loss.backward()
        counts[policy] = mode.n
        model.zero_grad(set_to_none=True)
    projections = 7 * tcfg.n_layers  # q, k, v, o, gate, up, down
    # "dots": two products per projection in the backward, and the one CE
    # chunk's head product recomputed (1) and differentiated (2); no
    # projection recomputed.  "minimal" recomputes the projections whose
    # outputs the backward reads (not w_down's: the recompute stops early).
    assert counts["dots"] == 2 * projections + 3, counts
    assert counts["minimal"] == counts["dots"] + 6 * tcfg.n_layers, counts


def test_use_kernels_config_trains_through_the_plain_path(monkeypatch):
    """A config that serves through the kernels still trains without them,
    as the reference trains without its Pallas kernels."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("training reached a hand-kernel dispatch")

    monkeypatch.setattr(tops, "flash_attention", no_kernel)
    monkeypatch.setattr(tops, "ssd_scan", no_kernel)
    for arch in ("lm-test", "mamba2-130m"):
        rcfg, tcfg, params, model = _carried(arch)
        kcfg = dataclasses.replace(tcfg, use_kernels=True)
        rb, tb = _batches(rcfg.vocab, 2, 40, seed=2)
        loss = TM.train_loss(model, kcfg, tb)
        loss.backward()
        want = jax.value_and_grad(RM.train_loss)(params, rcfg, rb)[0]
        _close(loss.item(), float(want), what=arch)


def test_kernel_dispatch_refuses_inputs_that_require_grad():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 64, 2, 16), (1, 64, 2, 16), (1, 64, 2, 16)))
    x = torch.from_numpy(rng.standard_normal((1, 32, 2, 8)).astype(np.float32))
    dt = torch.rand(1, 32, 2)
    A, D = -torch.ones(2), torch.ones(2)
    Bm, Cm = torch.randn(1, 32, 1, 4), torch.randn(1, 32, 1, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.ssd_scan(x, dt, A, Bm.requires_grad_(), Cm, D, chunk=16)
    with torch.no_grad():  # forward-only use stays allowed
        assert tops.flash_attention(q, k, v).shape == q.shape
        assert tops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=16)[0].shape == x.shape
    out = tops.flash_attention(q.detach(), k, v)  # nothing requires grad
    assert out.grad_fn is None


def test_dot_f32_gradient_on_card(cuda):
    """The bf16 product with an f32 result has a derivative on the card (the
    native ``mm(..., out_dtype=float32)`` has none), against an f32 product
    at bf16's 2e-2."""
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(2, 96, 384, generator=g)
    w = torch.randn(384, 256, generator=g) / 20
    up = torch.randn(2, 96, 256, generator=g)
    xb = x.to(cuda, torch.bfloat16).requires_grad_()
    wb = w.to(cuda, torch.bfloat16).requires_grad_()
    out = TL._dot_f32(xb, wb)
    assert out.dtype == torch.float32
    (out * up.to(cuda)).sum().backward()
    xf, wf = xb.detach().float().cpu().requires_grad_(), wb.detach().float().cpu().requires_grad_()
    ((xf @ wf) * up).sum().backward()
    for got, want in ((xb.grad, xf.grad), (wb.grad, wf.grad)):
        assert got.dtype == torch.bfloat16
        scale = want.abs().max().item()
        np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(), atol=2e-2 * scale, rtol=2e-2)
