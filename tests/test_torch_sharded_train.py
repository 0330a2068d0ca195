"""Sharded training on (data 2, model 2) CPU ranks against the reference's
local train step and the port's single-process step.

The reference's sharded train step does not run under JAX 0.9 (its embedding
gather raises ``ShardingTypeError``, src/repro/models/model.py:132), and
under GSPMD a sharded step computes the local step's function, so the port's
sharded step is held against the reference's LOCAL ``make_train_step`` under
``jax.jit`` in this process, and against the port's single-process step.
One rank group of four CPU processes (``run_ranks``, gloo over a file store)
runs every case (``_torch_rank_cases.train_rank``); this process never joins
a process group.

Held, for reduced danube, phi3.5-moe (at a capacity that drops no token),
mamba2 (tied embeddings, on V/2 rows a rank), danube with one kv head and
danube at a vocabulary of 511 (``embed`` and ``head`` whole on every rank)
in f32, at a global batch of 4 (split over data) and of 1 (which
divides no data axis), at 2e-3: the loss and every updated parameter after
one and after two steps; one step with a binding clip and one with 2
microbatches against the single process; one step with labels masked
unevenly across the data ranks and the microbatches, with 1 and with 2
microbatches, against the reference's local step; each shard's reduced
gradient and the global gradient norm; each gathered gradient equal across
the ranks of a model group (1e-6 relative); checkpoints crossing between
the shards and one process bit for bit (tests/test_training_loop.py:70's
standard); and a sharded save holding one whole leaf at a time on the
device, with only rank 0 copying the tree to the host.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_train.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_rank_cases as C  # noqa: E402
from repro import configs as rconfigs  # noqa: E402
from repro.launch import steps as RSt  # noqa: E402
from repro.training.optimizer import OptSettings as ROptSettings  # noqa: E402
from repro.training.optimizer import adamw_init as r_adamw_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.distributed.ranks import run_ranks  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models.model import DecoderLM  # noqa: E402
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.training.optimizer import OptSettings, _global_norm, adamw_init, decays  # noqa: E402
from repro_torch.weights import params_to_numpy, reference_key  # noqa: E402

pytestmark = pytest.mark.slow  # starts a group of four processes and compiles XLA programs

TOL = 2e-3
SIZES = dict(zip(("data", "model"), C.TRAIN_MESH))
CASES = [(a, b) for a in C.TRAIN_ARCHS for b in C.TRAIN_BATCHES]
CASE_IDS = [f"{a}-B{b}" for a, b in CASES]


@pytest.fixture(autouse=True, scope="module")
def jax_on_cpu():
    """JAX's default f32 products on a GPU are not full f32."""
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _cfg(arch):
    return C.serve_cfg(tconfigs, arch)


def _batch(arch, B, run="default"):
    raw = C.train_batch(_cfg(arch), B) if run == "default" else C.train_inputs(_cfg(arch), run)
    return {k: torch.from_numpy(v).long() for k, v in raw.items()}


def _runs(run):
    """(steps, microbatches) of a run."""
    return (C.TRAIN_STEPS, 1) if run == "default" else (1, C.TRAIN_RUNS[run][0])


def _single(arch, B, run="default"):
    """The port's single-process run of a case: (losses, named parameters
    after each step, the final model and optimizer state)."""
    cfg = _cfg(arch)
    settings = C.train_settings(run, OptSettings)
    n_steps, mb = _runs(run)
    model = DecoderLM.from_config(cfg, seed=C.SEED, device="cpu", trainable=True)
    opt = adamw_init(model, settings)
    step = make_train_step(cfg, settings, microbatches=mb)
    losses, params = [], []
    for _ in range(n_steps):
        loss, model, opt = step(model, opt, _batch(arch, B, run))
        losses.append(float(loss))
        params.append({n: p.detach().clone() for n, p in model.named_parameters()})
    return losses, params, model, opt


@pytest.fixture(scope="module")
def singles():
    cache = {}

    def get(arch, B, run="default"):
        if (arch, B, run) not in cache:
            cache[arch, B, run] = _single(arch, B, run)
        return cache[arch, B, run]

    return get


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory, singles):
    """(a single-process checkpoint per arch, written before the group
    starts; the directory the group writes its own to)."""
    base = tmp_path_factory.mktemp("sharded_ckpt")
    for arch in C.TRAIN_ARCHS:
        _, _, model, opt = singles(arch, 4)
        save_checkpoint(str(base / "in" / arch), 1, model, opt)
    return base / "in", base / "out"


@pytest.fixture(scope="module")
def ranks(ckpt_dirs):
    return run_ranks(C.train_rank, 4, args=tuple(str(d) for d in ckpt_dirs), timeout_s=300,
                     env={"JAX_PLATFORMS": "cpu"})


def _whole(ranks, key, name, shape):
    """The whole leaf ``name`` put together from every rank's shard."""
    lay = TS._leaf_layouts(_cfg(key.split("|")[0]), _stand_in_rules())[name]
    out = np.full(shape, np.nan, np.float32)
    for r in ranks:
        out[TS.local_slices(lay.spec, lay.shape, SIZES, tuple(r["coord"]))] = r[f"{key}|{name}"]
    assert not np.isnan(out).any(), name
    return out


class _StandIn:
    shape, axis_names = SIZES, tuple(SIZES)


def _stand_in_rules():
    return TS.ShardingRules(_StandIn, fsdp_axes=("data",))


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _reference(arch, B, run="default"):
    """The reference's local train step under ``jax.jit`` from the same
    weights: (losses, reference trees after each step)."""
    cfg = _cfg(arch)
    rcfg = C.serve_cfg(rconfigs, arch)
    settings = ROptSettings()
    n_steps, mb = _runs(run)
    params = jax.tree.map(jnp.asarray, params_to_numpy(DecoderLM.from_config(cfg, seed=C.SEED, device="cpu")))
    opt = r_adamw_init(params, settings)
    step = jax.jit(RSt.make_train_step(rcfg, settings, microbatches=mb))
    raw = C.train_batch(cfg, B) if run == "default" else C.train_inputs(cfg, run)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    losses, trees = [], []
    for _ in range(n_steps):
        loss, params, opt = step(params, opt, batch)
        losses.append(float(loss))
        trees.append(jax.tree.map(np.asarray, params))
    return losses, trees


def _ref_leaf(tree, name):
    path, period = reference_key(name)
    for k in path:
        tree = tree[k]
    return tree if period is None else tree[period]


@pytest.mark.parametrize("arch,B", CASES, ids=CASE_IDS)
def test_sharded_steps_match_reference_local_step(ranks, arch, B):
    want_losses, want_trees = _reference(arch, B)
    key = C.train_key(arch, B)
    for s in range(C.TRAIN_STEPS):
        for r in ranks:
            _close(r[f"{key}|loss{s}"], want_losses[s], f"loss of step {s + 1}")
        for name in _names(arch):
            want = _ref_leaf(want_trees[s], name)
            _close(_whole(ranks, f"{key}|step{s}", name, want.shape), want, f"step {s + 1} {name}")


def _names(arch):
    return list(TS._leaf_layouts(_cfg(arch), _stand_in_rules()))


@pytest.mark.parametrize("arch,B", CASES, ids=CASE_IDS)
def test_sharded_steps_match_single_process(ranks, singles, arch, B):
    losses, params, _, _ = singles(arch, B)
    key = C.train_key(arch, B)
    for s in range(C.TRAIN_STEPS):
        for r in ranks:
            _close(r[f"{key}|loss{s}"], losses[s], f"loss of step {s + 1}")
        for name, want in params[s].items():
            _close(_whole(ranks, f"{key}|step{s}", name, want.shape), want, f"step {s + 1} {name}")


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_binding_clip_matches_single_process(ranks, singles, arch):
    cfg = _cfg(arch)
    model = DecoderLM.from_config(cfg, seed=C.SEED, device="cpu", trainable=True)
    _, grads = loss_and_grads(model, cfg, _batch(arch, 4))
    assert float(_global_norm(grads.values())) > 2 * C.TRAIN_CLIP  # the clip binds
    losses, params, _, _ = singles(arch, 4, "clip")
    key = C.train_key(arch, 4, "clip")
    for r in ranks:
        _close(r[f"{key}|loss0"], losses[0], "loss")
    for name, want in params[0].items():
        _close(_whole(ranks, f"{key}|step0", name, want.shape), want, name)


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_two_microbatches_match_one(ranks, singles, arch):
    one = C.train_key(arch, 4)
    two = C.train_key(arch, 4, "mb2")
    _, params, _, _ = singles(arch, 4, "mb2")
    for r in ranks:
        _close(r[f"{two}|loss0"], r[f"{one}|loss0"], "loss")
    for name, want in params[0].items():
        got = _whole(ranks, f"{two}|step0", name, want.shape)
        _close(got, _whole(ranks, f"{one}|step0", name, want.shape), f"{name} against 1 microbatch")
        _close(got, want, f"{name} against the single process")


def _grads_close(ranks, key, grads):
    for name, want in grads.items():
        want = want.numpy()
        got = _whole(ranks, f"{key}|grad", name, want.shape)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("arch,B", CASES, ids=CASE_IDS)
def test_reduced_gradients_match_single_process(ranks, arch, B):
    """Each shard's gradient after the rule's reduction is its slice of the
    single-process gradient (2e-3 of the leaf's largest magnitude, and
    relative).  The parameter checks alone would not show a wrong
    reduction: a first AdamW step moves every element by about ``lr``."""
    cfg = _cfg(arch)
    model = DecoderLM.from_config(cfg, seed=C.SEED, device="cpu", trainable=True)
    _, grads = loss_and_grads(model, cfg, _batch(arch, B))
    _grads_close(ranks, C.train_key(arch, B), grads)


MASK_RUNS = [(a, r) for a in C.TRAIN_ARCHS for r in ("mask", "mask_mb2")]


@pytest.mark.parametrize("arch,run", MASK_RUNS, ids=[f"{a}-{r}" for a, r in MASK_RUNS])
def test_masked_labels_match_reference_local_step(ranks, arch, run):
    """Labels masked unevenly across the data ranks and the microbatches
    (``_torch_rank_cases.masked_train_batch``): the loss and every updated
    parameter against the reference's local step with as many
    microbatches, and each shard's reduced gradient against the single
    process.  Each rank's loss is its masked sum over the global count, so
    a rank holding fewer labels weighs less, as in the reference's global
    mean."""
    cfg = _cfg(arch)
    n_mask = [(r < 0).sum() for r in C.masked_train_batch(cfg)["labels"]]
    assert n_mask[0] + n_mask[1] != n_mask[2] + n_mask[3]  # the data ranks hold different counts
    want_losses, want_trees = _reference(arch, 4, run)
    key = C.train_key(arch, 4, run)
    for r in ranks:
        _close(r[f"{key}|loss0"], want_losses[0], "loss")
    for name in _names(arch):
        want = _ref_leaf(want_trees[0], name)
        _close(_whole(ranks, f"{key}|step0", name, want.shape), want, name)
    model = DecoderLM.from_config(cfg, seed=C.SEED, device="cpu", trainable=True)
    _, grads = loss_and_grads(model, cfg, _batch(arch, 4, run), microbatches=C.TRAIN_RUNS[run][0])
    _grads_close(ranks, key, grads)


def test_dim_split_over_both_axes_gathers_and_sums_over_data_only(ranks):
    """A dim split over two mesh axes (first axis major, as ``(pod, data)``
    split one on the multi-pod mesh) gathers back to the whole leaf, and its
    gradient, each rank's cotangent ``rank + 1`` times the leaf, comes back
    summed over ``data`` (ranks m and 2 + m: 2m + 4 times the leaf) and
    sliced over ``model``."""
    whole = C.joint_leaf()
    for r in ranks:
        d, m = (int(c) for c in r["coord"])
        np.testing.assert_array_equal(r["joint|gathered"], whole)
        sl = TS.local_slices(C.JOINT_SPEC, whole.shape, SIZES, (d, m))
        np.testing.assert_array_equal(r["joint|grad"], whole[sl] * (2 * m + 4))


@pytest.mark.parametrize("arch,B", CASES, ids=CASE_IDS)
def test_global_norm_counts_every_element_once(ranks, arch, B):
    cfg = _cfg(arch)
    model = DecoderLM.from_config(cfg, seed=C.SEED, device="cpu", trainable=True)
    _, grads = loss_and_grads(model, cfg, _batch(arch, B))
    want = float(_global_norm(grads.values()))
    for r in ranks:
        _close(r[f"{C.train_key(arch, B)}|grad_norm"], want, "global norm", tol=TOL * want)


@pytest.mark.parametrize("arch,B", CASES, ids=CASE_IDS)
def test_gathered_gradients_equal_across_model_group(ranks, arch, B):
    """Every rank of a model group computes the same gradient for a leaf it
    gathers whole (the rule slices it over ``model``, never sums it).  The
    leaves gathered whole are exactly those no layer splits over ``model``:
    ``embed`` and ``head`` among them only where the vocabulary does not
    split (reduced danube at 511)."""
    prefix = f"{C.train_key(arch, B)}|gathered_grad|"
    names = sorted(k[len(prefix):] for k in ranks[0] if k.startswith(prefix))
    whole = sorted(n for n, lay in TS._leaf_layouts(_cfg(arch), _stand_in_rules()).items()
                   if not lay.keep and not lay.summed_over)
    assert "final_norm" in names and names == whole
    assert ("head" in names or "embed" in names) == (_cfg(arch).vocab % SIZES["model"] != 0)
    groups = {}
    for r in ranks:
        groups.setdefault(int(r["coord"][0]), []).append(r)
    for group in groups.values():
        assert len(group) == SIZES["model"]
        for name in names:
            a, b = (g[prefix + name] for g in group)
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * np.abs(a).max(), err_msg=name)


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_sharded_checkpoint_restores_into_one_process_bit_for_bit(ranks, ckpt_dirs, arch):
    cfg = _cfg(arch)
    model = DecoderLM.from_config(cfg, seed=0, device="cpu", trainable=True)
    opt = adamw_init(model, OptSettings())
    restore_checkpoint(str(ckpt_dirs[1] / arch), like=(model, opt))
    assert int(opt["step"]) == C.TRAIN_STEPS
    key = f"{C.train_key(arch, 4)}|step{C.TRAIN_STEPS - 1}"
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _whole(ranks, key, name, p.shape), name)
        for kind in ("m", "v"):
            np.testing.assert_array_equal(opt[kind][name].numpy(),
                                          _whole(ranks, f"{arch}|saved|{kind}", name, p.shape),
                                          f"{kind} {name}")


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_sharded_save_gathers_one_leaf_at_a_time(ranks, arch):
    """While a sharded checkpoint saves, no rank holds more than one whole
    leaf on its device beyond its shards, and only rank 0, which writes,
    copies the whole tree (parameters and both moments, all f32 here, and
    the step) to the host."""
    cfg = _cfg(arch)
    full = dict(DecoderLM.from_config(cfg, seed=0, device="cpu").named_parameters())
    largest = max(p.numel() * 4 for p in full.values())
    tree = 3 * sum(p.numel() * 4 for p in full.values()) + 4
    for r in ranks:
        assert 0 < int(r[f"{arch}|saved|peak_whole_bytes"]) <= largest
        writes = tuple(r["coord"]) == (0, 0)
        assert int(r[f"{arch}|saved|host_bytes"]) == (tree if writes else 0)


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_single_process_checkpoint_restores_into_shards_bit_for_bit(ranks, singles, arch):
    _, _, model, opt = singles(arch, 4)
    for r in ranks:
        assert int(r[f"{arch}|restored|step"]) == int(opt["step"])
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(_whole(ranks, f"{arch}|restored|params", name, p.shape),
                                      p.detach().numpy(), name)
        for kind in ("m", "v"):
            np.testing.assert_array_equal(_whole(ranks, f"{arch}|restored|{kind}", name, p.shape),
                                          opt[kind][name].numpy(), f"{kind} {name}")


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_decays_a_shard_as_its_leaf(arch):
    cfg = _cfg(arch)
    full = dict(DecoderLM.from_config(cfg, seed=0, device="cpu").named_parameters())
    for name, lay in TS._leaf_layouts(cfg, _stand_in_rules()).items():
        shard = full[name][TS.local_slices(lay.spec, lay.shape, SIZES, (1, 1))]
        assert decays(name, shard) == decays(name, full[name]), name
