"""Twins of tests/test_arch_smoke.py over every id of the zoo, on the port,
with values held against the reference on carried weights: the published
parameter trees, smoke forward and loss, prefill then greedy decode for the
causal models, and hybrid decode against prefill.  Then the two frontends the
reference stubs (``embed_inputs``): the VLM's patch embeddings over its first
token positions, which give ``embed`` no gradient, and the audio encoder's
frame embeddings, whose config has no ``embed`` leaf; and the encoder through
the attention kernel's path without the causal mask.  The gradients of every
leaf are in tests/test_torch_zoo_grads.py.

f32 at the reference's model-level 2e-3; greedy tokens and embeddings
exactly.  JAX stays on its CPU backend.

    PYTHONPATH=src python -m pytest -q tests/test_torch_zoo.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.config import applicable_shapes as rapplicable_shapes  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import applicable_shapes  # noqa: E402
from repro_torch.weights import params_from_reference, params_to_numpy  # noqa: E402

pytestmark = pytest.mark.slow  # compiles XLA programs, like tests/test_arch_smoke.py

TOL = 2e-3
VLM, AUDIO = "phi-3-vision-4.2b", "hubert-xlarge"
CAUSAL = [a for a in tconfigs.ARCH_IDS if tconfigs.get(a).causal]
# the nominal sizes tests/test_arch_smoke.py holds param_count to (within 12 %)
NOMINAL = {
    "jamba-1.5-large-398b": 398e9,
    "phi3.5-moe-42b-a6.6b": 42e9,
    "dbrx-132b": 132e9,
    "internlm2-20b": 20e9,
    "h2o-danube-3-4b": 4e9,
    "deepseek-coder-33b": 33e9,
    "command-r-35b": 35e9,
    "mamba2-130m": 130e6,
}


@pytest.fixture(autouse=True, scope="module")
def jax_on_cpu():
    """JAX's default f32 products on a GPU are not full f32."""
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _cfgs(arch, dtype="float32", **kw):
    r = dataclasses.replace(rconfigs.reduce_for_smoke(rconfigs.get(arch)), dtype=dtype, **kw)
    t = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get(arch)), dtype=dtype, **kw)
    return r, t


def _carried(arch, seed=0, dtype="float32", trainable=False, **kw):
    rcfg, tcfg = _cfgs(arch, dtype, **kw)
    params = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu", trainable=trainable)
    return rcfg, tcfg, params, model


def smoke_batch(cfg, seed, B=2, S=64):
    """tests/test_arch_smoke.py's batch, drawn with numpy: frame embeddings or
    tokens, labels, and patch embeddings for a patch config."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "frame":
        out["frame_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.frontend == "patch":
        out["patch_embeds"] = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# Twins of tests/test_arch_smoke.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_full_config_is_published_shape(arch):
    """The full config's parameter tree (meta tensors) against the
    reference's ``param_shapes``, leaf by leaf, and param_count within 12 %
    of the id's nominal size where the id carries one."""
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    want = dict(_leaves(RM.param_shapes(rcfg)))
    got = dict(_leaves(TM.param_shapes(tcfg)))
    assert sorted(got) == sorted(want)
    for path, sds in want.items():
        assert tuple(got[path].shape) == tuple(sds.shape), path
        assert str(got[path].dtype) == f"torch.{sds.dtype.name}", path
        assert got[path].is_meta, path
    assert ("/embed" in got) == (tcfg.frontend != "frame")
    if arch in NOMINAL:
        n = tcfg.param_count()
        assert abs(n - NOMINAL[arch]) / NOMINAL[arch] < 0.12, (arch, n)
    assert [s.name for s in applicable_shapes(tcfg)] == [s.name for s in rapplicable_shapes(rcfg)]
    assert applicable_shapes(tcfg)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_smoke_forward_and_loss(arch):
    rcfg, tcfg, params, model = _carried(arch)
    batch = smoke_batch(rcfg, 0)
    want_loss = RM.train_loss(params, rcfg, as_jax(batch))
    want_h, _ = RM.forward(params, rcfg, as_jax(batch), remat=False)
    with torch.no_grad():
        loss = TM.train_loss(model, tcfg, as_torch(batch))
        hidden, _ = TM.forward(model, tcfg, as_torch(batch), remat=False)
    assert loss.shape == () and np.isfinite(loss.item())
    assert tuple(hidden.shape) == (2, 64, tcfg.d_model)
    _close(hidden, want_h, what="hidden")
    _close(loss, want_loss, what="loss")


@pytest.mark.parametrize("arch", CAUSAL)
def test_smoke_prefill_then_decode(arch):
    """Prefill logits against the reference's, then 4 greedy decode steps
    from a fresh max-length state on each side (as the reference's twin
    does): logits at 2e-3 and the greedy tokens exactly.  The VLM's prompt
    carries its patches; its decode is text only."""
    rcfg, tcfg, params, model = _carried(arch, seed=2)
    B, S = 2, 32
    batch = smoke_batch(rcfg, 2, B, S)
    batch.pop("labels")
    want_logits, _ = RM.prefill(params, rcfg, as_jax(batch))
    with torch.no_grad():
        logits, _ = TM.prefill(model, tcfg, as_torch(batch))
    assert tuple(logits.shape) == (B, tcfg.vocab)
    _close(logits, want_logits, what="prefill logits")

    rstate = RM.init_decode_state(rcfg, B, S + 8)
    tstate = TM.init_decode_state(tcfg, B, S + 8, device="cpu")
    tok = batch["tokens"][:, :1]
    for pos in range(4):
        want_logits, rstate = RM.decode_step(params, rcfg, jnp.asarray(tok), rstate, jnp.int32(pos))
        with torch.no_grad():
            logits, tstate = TM.decode_step(model, tcfg, torch.from_numpy(tok).long(), tstate, pos)
        _close(logits, want_logits, what=f"decode step {pos}")
        want_tok = np.asarray(jnp.argmax(want_logits, -1))
        got_tok = torch.argmax(logits, -1).numpy()
        np.testing.assert_array_equal(got_tok, want_tok, err_msg=f"greedy token, step {pos}")
        tok = want_tok[:, None].astype(np.int32)


def test_decode_matches_prefill_hybrid():
    """Twin of the reference's test of the same name: prefill of 8 tokens
    and 8 decode steps give the same final logits (f32, a capacity that
    drops no token), and the port's prefill is the reference's."""
    rcfg, tcfg, params, model = _carried("jamba-1.5-large-398b", seed=3, capacity_factor=16.0)
    B, S = 1, 8
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    want, _ = RM.prefill(params, rcfg, {"tokens": jnp.asarray(tokens)})
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits_pre, _ = TM.prefill(model, tcfg, {"tokens": t})
        st = TM.init_decode_state(tcfg, B, S, device="cpu")
        for pos in range(S):
            logits_dec, st = TM.decode_step(model, tcfg, t[:, pos : pos + 1], st, pos)
    _close(logits_pre, want, what="prefill against the reference")
    _close(logits_dec, logits_pre.numpy(), what="decode against prefill")


# ---------------------------------------------------------------------------
# The frontends
# ---------------------------------------------------------------------------
# phi-3-vision's attention layout (32 q heads over 32 kv heads, head_dim 96)
# at smoke width: d 64, so q is 64 -> 3072
VLM_HEADS = dict(n_heads=32, n_kv_heads=32, head_dim=96)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw", [(VLM, VLM_HEADS), (AUDIO, {})], ids=["vlm-mha-hd96", "audio"])
def test_weights_round_trip_every_leaf(arch, kw, dtype):
    """The reference's tree carried into the port and back, bit for bit:
    the VLM's MHA tree by key path, the audio encoder's tree without
    ``embed``."""
    rcfg, tcfg, params, model = _carried(arch, dtype=dtype, **kw)
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    got = dict(_leaves(params_to_numpy(model)))
    assert sorted(got) == sorted(want)
    assert ("/embed" in got) == (arch == VLM)
    assert sum(a.size for a in want.values()) == sum(p.numel() for p in model.parameters())
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(a, np.float32), err_msg=path)
    if arch == VLM:
        assert tuple(model.layers[0]["pos0"].mixer["wq"].shape) == (tcfg.d_model, 32 * 96)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", VLM, AUDIO], ids=["text", "patch", "frame"])
def test_embed_inputs_match_reference(arch, dtype):
    """``embed_inputs`` for each frontend, exactly: the lookup, the patch
    embeddings over the first ``n_frontend_tokens`` positions in the
    embedding's dtype, the frame embeddings in the model dtype."""
    rcfg, tcfg, params, model = _carried(arch, dtype=dtype)
    batch = smoke_batch(rcfg, 4, 2, 16)
    want = RM.embed_inputs(params, rcfg, as_jax(batch))
    got = TM.embed_inputs(model, tcfg, as_torch(batch))
    assert got.dtype == tcfg.torch_dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    if arch == VLM:
        n = tcfg.n_frontend_tokens
        assert torch.equal(got[:, :n], torch.from_numpy(batch["patch_embeds"]).to(got.dtype))


def test_frame_config_has_no_embed_leaf():
    _, tcfg = _cfgs(AUDIO)
    assert "embed" not in TM.param_shapes(tcfg) and not tcfg.tie_embeddings
    model = TM.DecoderLM.from_config(tcfg, seed=0, device="cpu")
    assert model.embed is None and model.device.type == "cpu"
    names = [n for n, _ in model.named_parameters()]
    assert "embed" not in names and "head" in names
    assert tuple(model.head.shape) == (tcfg.d_model, tcfg.vocab)


def test_patch_positions_give_embed_no_gradient():
    """Tokens under the patch positions are overwritten before the stack:
    their embedding rows get no gradient, on either side, and the whole
    ``embed`` gradient matches the reference's."""
    rcfg, tcfg, params, model = _carried(VLM, trainable=True)
    n, V = tcfg.n_frontend_tokens, tcfg.vocab
    batch = smoke_batch(rcfg, 5, 2, 32)
    rng = np.random.default_rng(5)
    # ids below V // 2 only under the patches, the rest only after them
    batch["tokens"][:, :n] = rng.integers(0, V // 2, (2, n))
    batch["tokens"][:, n:] = rng.integers(V // 2, V, (2, 32 - n))
    grads = jax.grad(RM.train_loss)(params, rcfg, as_jax(batch))
    TM.train_loss(model, tcfg, as_torch(batch)).backward()
    g = model.embed.grad
    assert torch.equal(g[: V // 2], torch.zeros_like(g[: V // 2]))
    assert g[np.unique(batch["tokens"][:, n:])].abs().sum(-1).gt(0).all()
    _close(g, grads["embed"], what="embed gradient")


def test_patch_embeds_longer_than_the_prompt_raise():
    _, tcfg = _cfgs(VLM)
    model = TM.DecoderLM.from_config(tcfg, seed=0, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "patch_embeds": torch.zeros((1, tcfg.n_frontend_tokens, tcfg.d_model))}
    assert tcfg.n_frontend_tokens > 4
    with pytest.raises(ValueError, match="patch embeddings"):
        TM.embed_inputs(model, tcfg, batch)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel-path", "plain-path"])
def test_encoder_matches_reference(use_kernels):
    """hubert's per-frame logits at S 128, a multiple of the Pallas block
    (its wrapper refuses a ragged non-causal Sk): the kernel path (the flash
    kernel's plain version on the CPU) against the reference's Pallas path in
    interpret mode, the plain path against the plain path."""
    rcfg, tcfg, params, model = _carried(AUDIO, seed=6)
    rcfg = dataclasses.replace(rcfg, use_pallas=use_kernels)
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    batch = smoke_batch(rcfg, 6, 2, 128)
    hidden, _ = RM.forward(params, rcfg, as_jax(batch), remat=False)
    want = RM.lm_head(params, rcfg, hidden)
    with torch.no_grad():
        h, _ = TM.forward(model, tcfg, as_torch(batch), remat=False)
        got = TM.lm_head(model, tcfg, h)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 128, tcfg.vocab)
    _close(got, want, what="per-frame logits")


def test_encoder_ragged_kernel_path_matches_plain_path():
    """A ragged non-causal S (1000), which the port's kernels take and the
    Pallas wrapper refuses: the kernel path against the port's plain path
    (chunked attention over padded key chunks)."""
    _, tcfg = _cfgs(AUDIO)
    model = TM.DecoderLM.from_config(tcfg, seed=7, device="cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 1000, tcfg.d_model)).astype(np.float32))
    out = {}
    with torch.no_grad():
        for use_kernels in (True, False):
            cfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
            h, _ = TM.forward(model, cfg, {"frame_embeds": x}, remat=False)
            out[use_kernels] = TM.lm_head(model, cfg, h)
    _close(out[True], out[False].numpy(), what="ragged S=1000")
