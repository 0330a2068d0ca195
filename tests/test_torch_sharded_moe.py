"""The port's sharded MoE block and its parameter layout against the
reference's, across processes.

The reference's side runs in one JAX subprocess with four XLA host devices
(``_jax_sharded_reference.py``; this process keeps the single real CPU
device).  The port's side runs in two rank groups of CPU processes
(``run_ranks``: gloo over a file store), one a mesh shape, (data 1, model 2)
and (data 2, model 2), each covering every case of its shape
(``_torch_rank_cases.sharded_block_rank``).  This process never joins a
process group.

Held:
  * ``local_slices`` of every leaf of reduced phi3.5-moe and jamba on (2, 2)
    equals the reference's ``devices_indices_map``, coordinate by
    coordinate, and torch's ``distribute_tensor`` with ``placements`` holds
    exactly that slice on each rank;
  * the sharded block (reduced phi3.5-moe and dbrx, a capacity that drops
    tokens) against the reference's sharded block, at the block tolerances
    of tests/test_torch_moe.py (f32 1e-5, bf16 2e-2), and, at a data axis
    of 1 in f32, exactly equal to the port's local path;
  * its gradients (x, the router, each rank's experts) against the
    reference's ``jax.grad`` at 2e-3, each rank's partial gradients summed
    over the data axis as a data-parallel step would;
  * ``run_ranks`` itself puts its ranks on the card unless the caller
    passes ``device="cpu"`` (without a card, the default raises).

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_moe.py
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_rank_cases as C  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed.ranks import run_ranks  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.parallel import MeshContext  # noqa: E402

pytestmark = pytest.mark.slow  # compiles XLA programs and starts processes

BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_torch_moe.py:45
GRAD_TOL = 2e-3
TESTS = os.path.dirname(os.path.abspath(__file__))
CASES = [(a, d, m) for m in C.BLOCK_MESHES for a in C.BLOCK_ARCHS for d in C.BLOCK_DTYPES]
COORDS = [(d, m) for d in range(2) for m in range(2)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results, from one JAX process with 4 host devices."""
    out = tmp_path_factory.mktemp("jax_reference") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    res = subprocess.run([sys.executable, os.path.join(TESTS, "_jax_sharded_reference.py"), str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ranks():
    """Each mesh shape's ranks' results, by mesh shape."""
    return {shape: run_ranks(C.sharded_block_rank, shape[0] * shape[1], args=shape, device="cpu",
                             env={"JAX_PLATFORMS": "cpu"})
            for shape in C.BLOCK_MESHES}


def _by_coord(results):
    return {tuple(int(c) for c in r["coord"]): r for r in results}


def _assemble(results, key, n_data):
    """The global (B, S, d) array of every rank's batch slice, after checking
    that the ranks of a model group agree exactly."""
    by = _by_coord(results)
    parts = []
    for d in range(n_data):
        group = [r[key] for (dd, _), r in sorted(by.items()) if dd == d]
        for other in group[1:]:
            np.testing.assert_array_equal(other, group[0])
        parts.append(group[0])
    return np.concatenate(parts, 0)


# ---------------------------------------------------------------------------
# The parameter layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("coord", COORDS, ids=lambda c: f"{c[0]}{c[1]}")
@pytest.mark.parametrize("arch", C.TABLE_ARCHS)
def test_local_slices_equal_devices_indices_map(reference, ranks, arch, coord):
    mine = _by_coord(ranks[(2, 2)])[coord]
    keys = [k for k in mine if k.startswith(f"table|{arch}|")]
    assert len(keys) > 10
    for k in keys:
        np.testing.assert_array_equal(mine[k], reference[f"{k}|{coord[0]}{coord[1]}"], err_msg=k)


@pytest.mark.parametrize("coord", COORDS, ids=lambda c: f"{c[0]}{c[1]}")
@pytest.mark.parametrize("arch", C.TABLE_ARCHS)
def test_distribute_tensor_holds_the_local_slice(ranks, arch, coord):
    mine = _by_coord(ranks[(2, 2)])[coord]
    held = {k: bool(v) for k, v in mine.items() if k.startswith(f"dtensor|{arch}|")}
    assert held and all(held.values()), [k for k, v in held.items() if not v]
    # the model axis splits the experts: this coordinate's slice of E
    cfg = tconfigs.reduce_for_smoke(tconfigs.get(arch))
    w = mine[f"table|{arch}|/stack/pos{cfg.mlp_pattern.index('moe')}/mlp/w_gate"]
    E = cfg.n_experts
    assert tuple(w[1]) == (coord[1] * E // 2, (coord[1] + 1) * E // 2)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype,mesh", CASES)
def test_sharded_block_matches_reference(reference, ranks, arch, dtype, mesh):
    key = C.block_key(arch, dtype, mesh)
    got = _assemble(ranks[mesh], f"{key}|y", mesh[0])
    tol = BLOCK_TOL[dtype]
    np.testing.assert_allclose(got, reference[f"{key}|y"], atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", C.BLOCK_ARCHS)
def test_sharded_block_equals_local_path_at_data_1(ranks, arch):
    """At a data axis of 1 every token reaches its top-2 experts on one rank
    or two, and the other rank adds exact zeros: f32 sums are equal."""
    key = C.block_key(arch, "float32", (1, 2))
    for r in ranks[(1, 2)]:
        np.testing.assert_array_equal(r[f"{key}|y"], r[f"{key}|local_y"])


@pytest.mark.parametrize("mesh", C.BLOCK_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", C.BLOCK_ARCHS)
def test_sharded_block_gradients_match_reference(reference, ranks, arch, mesh):
    key = C.block_key(arch, "float32", mesh)
    n_data, n_model = mesh
    by = _by_coord(ranks[mesh])
    np.testing.assert_allclose(_assemble(ranks[mesh], f"{key}|grad_x", n_data),
                               reference[f"{key}|grad_x"], atol=GRAD_TOL, rtol=GRAD_TOL)
    names = [k.rsplit("|grad_", 1)[1] for k in by[(0, 0)] if k.startswith(f"{key}|grad_")]
    assert "router" in names and "w_gate" in names
    for name in names:
        if name == "x":
            continue
        # sum each rank's partial over the data axis (a data-parallel step's
        # reduction); the router is replicated, the experts split over model
        per_model = [sum(by[(d, m)][f"{key}|grad_{name}"] for d in range(n_data))
                     for m in range(n_model)]
        got = per_model[0] if name == "router" else np.concatenate(per_model, 0)
        if name == "router":
            for other in per_model[1:]:
                np.testing.assert_allclose(other, got, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got, reference[f"{key}|grad_{name}"], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("mesh", C.BLOCK_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", C.BLOCK_ARCHS)
def test_block_cases_drop_tokens(arch, mesh):
    """The capacity of each data shard's own tokens drops tokens, so the
    cases above hold the dropping path."""
    cfg = C.case_cfg(tconfigs, arch, capacity_factor=C.BLOCK_CAPACITY)
    params, x, _ = C.block_inputs(cfg)
    dropped = 0
    for xs in np.split(x, mesh[0]):
        flat = torch.from_numpy(xs.reshape(-1, cfg.d_model))
        idx, _ = TMoE.router_probs(flat, torch.from_numpy(params["router"]), cfg.top_k)
        cap = TMoE._capacity(flat.shape[0], cfg, None)
        counts = torch.bincount(idx.flatten(), minlength=cfg.n_experts)
        dropped += int(torch.clamp_min(counts - cap, 0).sum())
    assert dropped > 0


def test_n_experts_must_divide_the_model_axis():
    cfg = C.case_cfg(tconfigs, C.PHI, capacity_factor=C.BLOCK_CAPACITY)
    params, x, _ = C.block_inputs(cfg)
    ctx = MeshContext(mesh=type("Mesh", (), {"shape": {"data": 1, "model": 3}})())
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="not divisible by model axis 3"):
        TMoE.moe_block(tp, torch.from_numpy(x), cfg, ctx)


def test_run_ranks_puts_ranks_on_the_card_unless_asked_for_the_cpu():
    """The launcher's default is the card, as every entry point of the port:
    rank r on card r % device_count, and without a card a clear error; the
    CPU only where the caller passes ``device="cpu"``."""
    assert [int(r["card"]) for r in run_ranks(C.device_rank, 2, device="cpu")] == [-1, -1]
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert [int(r["card"]) for r in run_ranks(C.device_rank, 2)] == [0, 1 % n]
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            run_ranks(C.device_rank, 2)
