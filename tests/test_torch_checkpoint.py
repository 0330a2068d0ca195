"""The port's checkpoints against the reference's: the same layout, key
names and manifest dtypes; a checkpoint written by either package restores
in the other bit for bit, f32 and bf16 leaves (bf16 travels as its raw bits,
as the reference writes it); ``AsyncCheckpointer`` keeps the newest
``keep`` steps and ``latest_step`` finds the newest, and what it writes is
the step it was given, whatever training does in place meanwhile."""
import json
import pathlib
import threading
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from repro.models import model as RM  # noqa: E402
from repro.models.config import ArchConfig as RArch  # noqa: E402
from repro.training import checkpoint as RC  # noqa: E402
from repro.training import optimizer as RO  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402
from repro_torch.training import checkpoint as TC  # noqa: E402
from repro_torch.weights import opt_state_from_reference, params_from_reference, reference_key  # noqa: E402

pytestmark = pytest.mark.slow  # runs the reference's optimizer under JAX

LM_TEST = dict(name="lm-test", family="dense", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab=512, attn_chunk=64)


@pytest.fixture(autouse=True, scope="module")
def jax_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _states(dtype):
    """The same trained-one-step params and optimizer state in both
    packages (moments in the model dtype, so bf16 moments are covered)."""
    rcfg, tcfg = RArch(**LM_TEST, dtype=dtype), TArch(**LM_TEST, dtype=dtype)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    settings = RO.OptSettings(moment_dtype=dtype)
    grads = jax.tree.map(lambda p: p * 0.5 + 0.01, params)
    params, opt = RO.adamw_update(params, grads, RO.adamw_init(params, settings), settings)
    np_params, np_opt = jax.tree.map(np.asarray, (params, opt))
    model = params_from_reference(np_params, tcfg, "cpu", trainable=True)
    return params, opt, model, opt_state_from_reference(np_opt, model)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _tensor_bits(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _npz_members(path):
    with zipfile.ZipFile(pathlib.Path(path) / "arrays.npz") as z:
        return sorted(z.namelist())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_keys_and_bytes_equal_reference(tmp_path, dtype):
    params, opt, model, t_opt = _states(dtype)
    r_path = RC.save_checkpoint(str(tmp_path / "r"), 7, params, opt, loader_state={"epoch": 1},
                                extra={"step": 7})
    t_path = TC.save_checkpoint(str(tmp_path / "t"), 7, model, t_opt, loader_state={"epoch": 1},
                                extra={"step": 7})
    assert pathlib.Path(t_path).name == pathlib.Path(r_path).name == "step_00000007"
    assert _npz_members(t_path) == _npz_members(r_path)
    r_man = json.loads((pathlib.Path(r_path) / "manifest.json").read_text())
    t_man = json.loads((pathlib.Path(t_path) / "manifest.json").read_text())
    assert t_man == r_man  # keys, dtypes ("bfloat16" included), loader state, extra
    with np.load(pathlib.Path(r_path) / "arrays.npz") as r, np.load(pathlib.Path(t_path) / "arrays.npz") as t:
        for key in r_man["keys"]:
            assert t[key].shape == r[key].shape and t[key].dtype.itemsize == r[key].dtype.itemsize, key
            assert _bits(t[key]) == _bits(r[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port_bit_for_bit(tmp_path, dtype):
    params, opt, _, _ = _states(dtype)
    RC.save_checkpoint(str(tmp_path), 3, params, opt, extra={"step": 3})
    # a target of the right dtype, zeroed, so nothing passes by accident
    _, _, model, t_opt = _states(dtype)
    for p in model.parameters():
        p.data.zero_()
    for kind in ("m", "v"):
        for t in t_opt[kind].values():
            t.zero_()
    model, t_opt, loader_state, extra = TC.restore_checkpoint(str(tmp_path), like=(model, t_opt))
    assert extra == {"step": 3} and loader_state == {}
    np_params, np_opt = jax.tree.map(np.asarray, (params, opt))
    for name, p in model.named_parameters():
        path, period = reference_key(name)
        want = np_params
        for k in path:
            want = want[k]
        assert _tensor_bits(p) == _bits(want if period is None else want[period]), name
        for kind in ("m", "v"):
            want = np_opt[kind]
            for k in path:
                want = want[k]
            got = t_opt[kind][name]
            assert got.dtype == p.dtype
            assert _tensor_bits(got) == _bits(want if period is None else want[period]), (kind, name)
    assert int(t_opt["step"]) == int(opt["step"]) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_reference_bit_for_bit(tmp_path, dtype):
    params, opt, model, t_opt = _states(dtype)
    TC.save_checkpoint(str(tmp_path), 5, model, t_opt)
    assert RC.latest_step(str(tmp_path)) == 5
    r_params, r_opt, _, _ = RC.restore_checkpoint(str(tmp_path))
    np_params, np_opt = jax.tree.map(np.asarray, (params, opt))
    for prefix, tree, restored in (("", np_params, r_params), ("m/", np_opt["m"], r_opt),
                                   ("v/", np_opt["v"], r_opt)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = prefix + "/".join(p.key for p in path)
            assert _bits(restored[key]) == _bits(leaf), key
            if dtype == "bfloat16":  # the reference reads bf16 back as its raw bits
                assert np.asarray(leaf).dtype.name == "bfloat16"
                np.testing.assert_array_equal(restored[key].view(np.asarray(leaf).dtype), leaf)
    assert int(r_opt["step"]) == 1


def test_restore_without_like_gives_flat_tensors(tmp_path):
    _, _, model, t_opt = _states("bfloat16")
    TC.save_checkpoint(str(tmp_path), 2, model, t_opt)
    params, opt, _, _ = TC.restore_checkpoint(str(tmp_path), 2)
    assert params["embed"].dtype == torch.bfloat16
    assert torch.equal(params["embed"], model.embed.detach())
    stacked = params["stack/pos0/mixer/wq"]
    assert stacked.shape[0] == model.cfg.n_periods
    assert torch.equal(stacked[1], model.layers[1]["pos0"].mixer["wq"].detach())
    assert int(opt["step"]) == 1 and sorted({k.split("/")[0] for k in opt}) == ["m", "step", "v"]
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(str(tmp_path / "none"))


def test_async_checkpointer_gc_keeps_newest(tmp_path):
    _, _, model, t_opt = _states("float32")
    saver = TC.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (2, 4, 6, 8):
        saver.save(step, model, t_opt, loader_state={"cursor": step}, extra={"step": step})
    saver.wait()
    assert TC.list_steps(str(tmp_path)) == [6, 8]
    assert TC.latest_step(str(tmp_path)) == 8
    assert saver.last_path.endswith("step_00000008")
    assert not list(pathlib.Path(tmp_path).glob(".tmp_ckpt_*"))  # writes were atomic
    assert TC.restore_checkpoint(str(tmp_path))[2] == {"cursor": 8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_async_save_holds_the_step_it_was_given(tmp_path, monkeypatch, dtype):
    """``save()`` copies every leaf before it returns: parameters and moments
    changed in place while the write waits do not reach the checkpoint,
    which equals a synchronous save of the same step byte for byte."""
    _, _, model, t_opt = _states(dtype)
    TC.save_checkpoint(str(tmp_path / "sync"), 1, model, t_opt)
    go, write = threading.Event(), TC._write
    monkeypatch.setattr(TC, "_write", lambda *a: go.wait() and write(*a))
    saver = TC.AsyncCheckpointer(str(tmp_path / "async"))
    saver.save(1, model, t_opt)
    with torch.no_grad():  # the next step, as adamw_update writes it: in place
        for t in [*model.parameters(), *t_opt["m"].values(), *t_opt["v"].values()]:
            t.add_(1)
    go.set()
    saver.wait()
    sync, later = (pathlib.Path(tmp_path) / k / "step_00000001" for k in ("sync", "async"))
    assert _npz_members(sync) == _npz_members(later)
    with np.load(sync / "arrays.npz") as a, np.load(later / "arrays.npz") as b:
        for key in a.files:
            assert _bits(a[key]) == _bits(b[key]), key
