"""The port's sharding rules against the reference's, on stand-in meshes (no
devices, no processes): every parameter leaf's spec for all ten ids, the
KV-cache and SSM-state sweeps of tests/test_sharding_rules.py, the batch,
input and decode-state specs, the mesh context's batch axes, the activation
spec, ``auto_microbatches``, ``input_specs`` with rules and the H100
``HardwareSpec``; then the port's own helpers, ``placements`` and
``local_slices``.

The reference runs on ``jax.sharding.AbstractMesh`` (sizes and names only),
the port on a stand-in with a ``shape`` dict and ``axis_names``, as the
reference's ``FakeRules`` (tests/test_sharding_rules.py:27-39) does.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharding.py
"""
import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: deterministic fallback sweep
    from _hypothesis_fallback import given, settings, strategies as st

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.launch import inputs as RI  # noqa: E402
from repro.launch import mesh as RMesh  # noqa: E402
from repro.launch import steps as RSt  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.config import applicable_shapes as r_applicable  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import inputs as TI  # noqa: E402
from repro_torch.launch import mesh as TMesh  # noqa: E402
from repro_torch.launch import steps as TSt  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import applicable_shapes  # noqa: E402
from repro_torch.training.optimizer import OptSettings  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _rules(mesh_id):
    """(reference rules on an AbstractMesh, port rules on a stand-in)."""
    sizes, names = MESHES[mesh_id]
    fsdp = ("pod", "data") if "pod" in names else ("data",)
    stand_in = types.SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)
    return (RS.ShardingRules(AbstractMesh(sizes, names), fsdp_axes=fsdp),
            TS.ShardingRules(stand_in, fsdp_axes=fsdp))


def _norm(spec):
    """A spec as a tuple of axis tuples (the reference writes ("data",) as
    "data"), its length kept."""
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    return RM.param_shapes(rconfigs.get(arch)), TM.param_shapes(tconfigs.get(arch))


def _cells(arch):
    return list(zip(r_applicable(rconfigs.get(arch)), applicable_shapes(tconfigs.get(arch))))


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_leaf_specs_equal_reference(arch, mesh_id):
    """Every parameter leaf's spec from the port's ``_leaf_spec`` (through
    ``param_shardings``) equals the reference's, and each sharded dim
    divides by its axes."""
    r_rules, t_rules = _rules(mesh_id)
    r_shapes, t_shapes = _shapes(arch)
    want = {p: _norm(s.spec) for p, s in _leaves(RS.param_shardings(r_rules, rconfigs.get(arch), r_shapes))}
    got = {p: _norm(s) for p, s in _leaves(TS.param_shardings(t_rules, tconfigs.get(arch), t_shapes))}
    assert got == want
    sizes = t_rules.mesh.shape
    for path, leaf in _leaves(t_shapes):
        for dim, axes in zip(leaf.shape, got[path]):
            n = 1
            for a in axes:
                n *= sizes[a]
            assert dim % n == 0, (path, dim, axes)


def _fake(data, model):
    names = ("data", "model")
    return (RS.ShardingRules(AbstractMesh((data, model), names), fsdp_axes=("data",)),
            TS.ShardingRules(types.SimpleNamespace(shape={"data": data, "model": model}, axis_names=names),
                             fsdp_axes=("data",)))


@settings(max_examples=200, deadline=None)
@given(
    data=st.sampled_from([1, 2, 4, 8, 16, 32, 256]),
    model=st.sampled_from([1, 2, 4, 8, 16]),
    batch=st.integers(1, 512),
    seq=st.sampled_from([1, 128, 4096, 32768, 524288]),
    kv=st.sampled_from([1, 2, 7, 8, 16, 24, 56]),
)
def test_kv_cache_spec_matches_reference(data, model, batch, seq, kv):
    """Twin of tests/test_sharding_rules.py's sweep: the same spec as the
    reference, every sharded dim divisible, no axis twice."""
    r_rules, t_rules = _fake(data, model)
    spec = _norm(TS.kv_cache_spec(t_rules, batch, seq, kv))
    assert spec == _norm(RS.kv_cache_spec(r_rules, batch, seq, kv))
    seen = [a for axes in spec for a in axes]
    assert len(seen) == len(set(seen)), spec
    for dim, axes in zip((batch, seq, kv, 128), spec):
        n = 1
        for a in axes:
            n *= t_rules.axis_size(a)
        assert dim % n == 0, (dim, axes)


@settings(max_examples=200, deadline=None)
@given(
    data=st.sampled_from([1, 4, 16, 32, 256]),
    model=st.sampled_from([1, 4, 16]),
    batch=st.integers(1, 512),
    heads=st.sampled_from([1, 3, 24, 64, 128, 256]),
)
def test_ssm_state_spec_matches_reference(data, model, batch, heads):
    r_rules, t_rules = _fake(data, model)
    spec = _norm(TS.ssm_state_spec(t_rules, batch, heads))
    assert spec == _norm(RS.ssm_state_spec(r_rules, batch, heads))
    seen = [a for axes in spec for a in axes]
    assert len(seen) == len(set(seen)), spec
    for dim, axes in zip((batch, heads, 64, 128), spec):
        n = 1
        for a in axes:
            n *= t_rules.axis_size(a)
        assert dim % n == 0, (dim, axes)


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_batch_spec_equals_reference(mesh_id):
    r_rules, t_rules = _rules(mesh_id)
    for b in (1, 2, 3, 4, 8, 16, 32, 48, 128, 256, 512, 1024):
        for extra in (0, 1, 2):
            assert _norm(TS.batch_spec(t_rules, b, extra)) == _norm(RS.batch_spec(r_rules, b, extra)), (b, extra)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cell_specs_equal_reference(arch, mesh_id):
    """At every full-size cell of the id: ``input_specs`` with rules (the
    batch's ``input_shardings``, the decode state's ``state_shardings``,
    the tokens'), the mesh context's batch axes (the port's context exists
    wherever the model axis is over 1 as well: its tensor-parallel layers
    read it), the activation spec and ``auto_microbatches``."""
    r_rules, t_rules = _rules(mesh_id)
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    for rshape, tshape in _cells(arch):
        B = tshape.global_batch
        want = RI.input_specs(rcfg, rshape, r_rules)
        got = TI.input_specs(tcfg, tshape, t_rules)
        if tshape.kind == "decode":
            (r_caches, r_len), r_tok, _ = want
            (t_caches, t_len), t_tok, t_pos = got
            assert t_pos.is_meta and not isinstance(t_pos, TI.Sharded)
            pairs = [(t_len, r_len), (t_tok, r_tok)]
            r_c, t_c = dict(_leaves(r_caches)), dict(_leaves(t_caches))
            assert sorted(r_c) == sorted(t_c)
            pairs += [(t_c[k], r_c[k]) for k in r_c]
        else:
            (r_batch,), (t_batch,) = want, got
            assert sorted(r_batch) == sorted(t_batch)
            pairs = [(t_batch[k], r_batch[k]) for k in r_batch]
        assert pairs
        for t, r in pairs:
            assert t.struct.is_meta and tuple(t.struct.shape) == tuple(r.shape)
            assert _norm(t.spec) == _norm(r.sharding.spec), (tshape.name, r.shape)
        r_ctx = RSt.make_mesh_context(r_rules, rcfg, B)
        t_ctx = TSt.make_mesh_context(t_rules, tcfg, B)
        # the reference's context carries its MoE shard_map; the port's also
        # carries the tensor-parallel layers, wherever the model axis is over 1
        assert (r_ctx is None) == ("moe" not in tcfg.mlp_pattern)
        assert (t_ctx is None) == (r_ctx is None and t_rules.model_size == 1)
        if r_ctx is not None:
            assert t_ctx.batch_axes == r_ctx.batch_axes and t_ctx.model_size == r_ctx.model_size
        if t_ctx is not None:
            assert t_ctx.batch_axes == TSt._fitting_batch_axes(t_rules, B)
        assert _norm(TSt.act_partition_spec(t_rules, B)) == _norm(RSt.act_partition_spec(r_rules, B))
        assert TSt.auto_microbatches(tcfg, tshape, t_rules) == RSt.auto_microbatches(rcfg, rshape, r_rules)


def test_no_rules_means_no_context():
    cfg, shape = tconfigs.get("phi3.5-moe-42b-a6.6b"), applicable_shapes(tconfigs.get("phi3.5-moe-42b-a6.6b"))[0]
    assert TSt.make_mesh_context(None, cfg, 8) is None and TSt.act_partition_spec(None, 8) is None
    assert TSt.auto_microbatches(cfg, shape, None) == 1


def test_hardware_spec_is_the_h100():
    r_fields = [f.name for f in dataclasses.fields(RMesh.HardwareSpec)]
    assert [f.name for f in dataclasses.fields(TMesh.HardwareSpec)] == r_fields
    h = TMesh.H100_SXM
    assert (h.name, h.peak_flops, h.hbm_bw, h.ici_bw, h.hbm_bytes) == (
        "NVIDIA H100 80GB HBM3", 989e12, 3.35e12, 450e9, 80e9)
    assert TMesh.batch_axes(_rules("pod2x16x16")[1].mesh) == ("pod", "data")
    assert TMesh.batch_axes(_rules("2x2")[1].mesh) == ("data",)


def test_train_step_with_rules_over_ranks_raises():
    """The name is kept from when the sharded train step raised.  It now
    builds over ranks, and ``step_for_cell`` returns it as a step that takes
    the parameters and the optimizer state, with the reference's
    microbatches (tests/test_torch_sharded_train.py runs it)."""
    arch = "phi3.5-moe-42b-a6.6b"
    rcfg = rconfigs.reduce_for_smoke(rconfigs.get(arch))
    cfg = tconfigs.reduce_for_smoke(tconfigs.get(arch))
    rrules, rules = _rules("2x2")
    assert callable(TSt.make_train_step(cfg, OptSettings(), rules, 4))
    shape = dataclasses.replace(applicable_shapes(cfg)[0], global_batch=4, seq_len=32)
    assert shape.kind == "train"
    _, r_takes, r_mb = RSt.step_for_cell(rcfg, shape, rrules)
    _, takes, mb = TSt.step_for_cell(cfg, shape, rules)
    assert (takes, mb) == (r_takes, r_mb) == (True, 1)


# ---------------------------------------------------------------------------
# The port's own helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_id", ["2x2", "4x2", "pod2x16x16"])
def test_local_slices_tile_every_leaf(mesh_id):
    """Over every coordinate of the mesh, each leaf's slices cover each
    element as often as the axes its spec leaves out multiply."""
    import itertools

    import numpy as np

    _, rules = _rules(mesh_id)
    sizes = rules.mesh.shape
    cfg = dataclasses.replace(tconfigs.reduce_for_smoke(tconfigs.get("jamba-1.5-large-398b")),
                              d_model=512, d_ff=1024, vocab=1024)
    shapes = TM.param_shapes(cfg)
    leaves = dict(_leaves(shapes))
    for path, spec in _leaves(TS.param_shardings(rules, cfg, shapes)):
        leaf = leaves[path]
        used = {a for axes in _norm(spec) for a in axes}
        rep = int(np.prod([n for a, n in sizes.items() if a not in used]))
        count = np.zeros(tuple(leaf.shape), np.int32)
        for coord in itertools.product(*(range(n) for n in sizes.values())):
            count[TS.local_slices(spec, leaf.shape, sizes, coord)] += 1
        assert (count == rep).all(), path


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 4, "model": 2}, axis_names=("pod", "data", "model"))
    assert TS.placements(("model", ("pod", "data"), None), mesh) == [Shard(1), Shard(1), Shard(0)]
    assert TS.placements((None,), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="out of mesh order"):
        TS.placements((("data", "pod"),), mesh)
