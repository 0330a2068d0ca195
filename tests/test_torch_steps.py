"""The port's step builders and input stand-ins against the reference's
(``repro.launch.steps``, ``repro.launch.inputs``), single-device part.

``step_for_cell`` for every applicable cell kind of every id of the zoo, on
the smoke configs and carried weights: the same (takes_params_and_opt,
microbatches) and the same outputs at the reference's model-level 2e-3
(the encoder step for the audio encoder's prefill cell, the prefill step's
logits and caches, three decode steps from a fresh state, one AdamW train
step for the two frontend configs).  ``batch_structs`` / ``input_specs`` at
every full-size cell against the reference's ``ShapeDtypeStruct``s.  JAX
stays on its CPU backend.

    PYTHONPATH=src python -m pytest -q tests/test_torch_steps.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import inputs as RI  # noqa: E402
from repro.launch import steps as RSt  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.config import applicable_shapes as r_applicable  # noqa: E402
from repro.training.optimizer import adamw_init as r_adamw_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import inputs as TI  # noqa: E402
from repro_torch.launch import steps as TSt  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import applicable_shapes  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402
from test_torch_zoo import _carried, _close, _leaves, as_jax, as_torch, smoke_batch  # noqa: E402

pytestmark = pytest.mark.slow  # compiles XLA programs, like tests/test_arch_smoke.py

CELLS = [(arch, s.name) for arch in tconfigs.ARCH_IDS for s in applicable_shapes(tconfigs.get(arch))]
KINDS = sorted({(arch, s.kind) for arch in tconfigs.ARCH_IDS
                for s in applicable_shapes(tconfigs.get(arch))})


@pytest.fixture(autouse=True, scope="module")
def jax_on_cpu():
    """JAX's default f32 products on a GPU are not full f32."""
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _shape(arch, kind, B=2, S=32):
    """The arch's first cell of ``kind``, cut to B x S."""
    shape = next(s for s in applicable_shapes(tconfigs.get(arch)) if s.kind == kind)
    return dataclasses.replace(shape, global_batch=B, seq_len=S)


@pytest.mark.parametrize("arch,kind", KINDS)
def test_step_for_cell_matches_reference(arch, kind):
    rcfg, tcfg, params, model = _carried(arch, seed=4)
    shape = _shape(arch, kind)
    r_fn, r_takes, r_mb = RSt.step_for_cell(rcfg, shape)
    t_fn, t_takes, t_mb = TSt.step_for_cell(tcfg, shape)
    assert (t_takes, t_mb) == (r_takes, r_mb) == (kind == "train", 1)
    B, S = shape.global_batch, shape.seq_len
    batch = smoke_batch(rcfg, 4, B, S)
    if kind == "train":
        return  # one AdamW step is held below, for the frontend configs
    batch.pop("labels")
    if kind == "prefill" and tcfg.is_encoder:
        want = r_fn(params, as_jax(batch))
        got = t_fn(model, as_torch(batch))
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, tcfg.vocab)
        _close(got, want, what="per-frame logits")
    elif kind == "prefill":
        want, (want_caches, want_len) = r_fn(params, as_jax(batch))
        got, (got_caches, got_len) = t_fn(model, as_torch(batch))
        _close(got, want, what="prefill logits")
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
        for path, w in _leaves(want_caches):
            _close(dict(_leaves(got_caches))[path], w, what=f"cache {path}")
    else:
        rstate = RM.init_decode_state(rcfg, B, S)
        tstate = TM.init_decode_state(tcfg, B, S, device="cpu")
        tok = batch["tokens"][:, :1]
        for pos in range(3):
            want, rstate = r_fn(params, rstate, jnp.asarray(tok), jnp.int32(pos))
            got, tstate = t_fn(model, tstate, torch.from_numpy(tok).long(), pos)
            _close(got, want, what=f"decode step {pos}")
            tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "hubert-xlarge"])
def test_train_step_for_cell_matches_reference(arch):
    """One AdamW step of the train cell's step function: the loss and every
    parameter after the update at 2e-3."""
    rcfg, tcfg, params, model = _carried(arch, seed=5, trainable=True)
    shape = _shape(arch, "train")
    r_fn, _, _ = RSt.step_for_cell(rcfg, shape)
    t_fn, _, _ = TSt.step_for_cell(tcfg, shape)
    settings = TSt.OptSettings.auto(tcfg.param_count())
    batch = smoke_batch(rcfg, 5, shape.global_batch, shape.seq_len)
    want_loss, want_params, _ = r_fn(params, r_adamw_init(params, settings), as_jax(batch))
    loss, model, opt = t_fn(model, adamw_init(model, settings), as_torch(batch))
    _close(loss, want_loss, what="loss")
    assert int(opt["step"]) == 1
    got = dict(_leaves(params_to_numpy(model)))
    for path, w in _leaves(jax.tree.map(np.asarray, want_params)):
        _close(got[path], w, what=path)


def _struct_of(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _jstruct_of(s):
    return tuple(s.shape), s.dtype.name


@pytest.mark.parametrize("arch,cell", CELLS)
def test_input_specs_match_reference(arch, cell):
    """Every input stand-in of a full-size cell, as meta tensors: the same
    keys, shapes and dtypes as the reference's ShapeDtypeStructs."""
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    shape = next(s for s in applicable_shapes(tcfg) if s.name == cell)
    rshape = next(s for s in r_applicable(rcfg) if s.name == cell)
    want, got = RI.input_specs(rcfg, rshape), TI.input_specs(tcfg, shape)
    assert len(got) == len(want)
    if shape.kind in ("train", "prefill"):
        (wb,), (gb,) = want, got
        assert sorted(gb) == sorted(wb)
        for k in wb:
            assert gb[k].is_meta and _struct_of(gb[k]) == _jstruct_of(wb[k]), k
        direct = TI.batch_structs(tcfg, shape, with_labels=shape.kind == "train")
        assert {k: _struct_of(v) for k, v in direct.items()} == {k: _struct_of(v) for k, v in gb.items()}
        return
    (wc, wlen), wtok, wpos = want
    (gc, glen), gtok, gpos = got
    w_leaves, g_leaves = dict(_leaves(wc)), dict(_leaves(gc))
    assert sorted(g_leaves) == sorted(w_leaves)
    for path, s in w_leaves.items():
        assert g_leaves[path].is_meta and _struct_of(g_leaves[path]) == _jstruct_of(s), path
    for g, w in ((glen, wlen), (gtok, wtok), (gpos, wpos)):
        assert g.is_meta and _struct_of(g) == _jstruct_of(w)
