"""The port's launch tooling: ``launch/roofline.py`` against the reference's,
``launch/counting.py`` on known products, and ``launch/dryrun.py`` run as a
user runs it, in subprocesses of its own (each starts a fake process group;
this process never joins one).

Held in this process: ``model_flops`` equal to the reference's for every
applicable cell of the ten ids; ``RooflineReport``'s properties equal the
reference's for the same fields, with the reference's hardware constants
passed in; the counts of a product and of an op with a view; and the
FLOPs ``count_step`` counts over the port's single-process step of reduced
danube, phi3.5-moe and mamba2 (train and prefill) against the reference's
``HloAnalyzer`` over its own local step's HLO.  Held from the
subprocesses: every smoke cell (reduced danube, phi3.5-moe and mamba2, every
applicable shape cut to a batch of at most 4 and 64 positions) ok on fake
(1, 1) and (2, 2) groups, with argument bytes equal to the sum of this
rank's ``local_slices`` of every parameter and moment, no collective bytes on
(1, 1), and on (1, 1) the FLOPs that ``count_step`` counts over the port's
single-process step on real CPU tensors; and one full-size cell (danube
``train_4k`` on the 16 x 16 production mesh, in one microbatch) completing on
the CPU, which it could not if anything were materialised; and on a fake
(1, 2) group, reduced danube's train step counting the layers outside the
period stack whole and 1/2 of the stack (tensor parallelism on model).

    PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun.py
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.launch.hlo_analysis import HloAnalyzer  # noqa: E402
from repro.launch.inputs import batch_structs as r_batch_structs  # noqa: E402
from repro.launch.mesh import TPU_V5E  # noqa: E402
from repro.launch.steps import step_for_cell as r_step_for_cell  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.config import applicable_shapes as r_applicable  # noqa: E402
from repro.training.optimizer import OptSettings as ROptSettings  # noqa: E402
from repro.training.optimizer import opt_state_shapes as r_opt_state_shapes  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch.counting import Counts, count_step  # noqa: E402
from repro_torch.launch.dryrun import SMOKE_MESHES, cell_config  # noqa: E402
from repro_torch.launch.inputs import batch_structs  # noqa: E402
from repro_torch.launch.mesh import H100_SXM  # noqa: E402
from repro_torch.launch.steps import step_for_cell  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import applicable_shapes  # noqa: E402
from repro_torch.training.optimizer import OptSettings, adamw_init  # noqa: E402

SMOKE_ARCHS = ["h2o-danube-3-4b", "phi3.5-moe-42b-a6.6b", "mamba2-130m"]
SMOKE_CELLS = [(a, s.name, m) for a in SMOKE_ARCHS for s in applicable_shapes(tconfigs.get(a))
               for m in SMOKE_MESHES]
SMOKE_IDS = [f"{a}-{s}-{m[0]}x{m[1]}" for a, s, m in SMOKE_CELLS]


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_model_flops_equal_reference(arch):
    shapes = applicable_shapes(tconfigs.get(arch))
    assert [s.name for s in shapes] == [s.name for s in r_applicable(rconfigs.get(arch))]
    for s, rs in zip(shapes, r_applicable(rconfigs.get(arch))):
        assert TR.model_flops(tconfigs.get(arch), s) == RR.model_flops(rconfigs.get(arch), rs)


FIELDS = [  # (compute_s, memory_s, collective_s, hlo_flops): each term dominant once, and all 0
    (3.0, 1.0, 2.0, 4e15), (1.0, 5.0, 2.0, 9e14), (1.0, 2.0, 7.5, 2e15), (0.0, 0.0, 0.0, 0.0),
]


@pytest.mark.parametrize("terms", FIELDS)
def test_report_properties_equal_reference(terms):
    compute_s, memory_s, collective_s, hlo_flops = terms
    common = dict(arch="a", shape="s", mesh="m", chips=256, hlo_flops=hlo_flops, hlo_bytes=1e12,
                  collective_bytes=3e11, compute_s=compute_s, memory_s=memory_s,
                  collective_s=collective_s, model_flops=1.5e15, collectives={})
    ref = RR.RooflineReport(**common)
    port = TR.RooflineReport(**common, peak_flops=TPU_V5E.peak_flops)
    for prop in ("dominant", "bound_s", "useful_ratio", "roofline_fraction"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert set(ref.to_json()) <= set(port.to_json())


def test_analyze_divides_each_count_by_its_rate():
    cfg = tconfigs.get("h2o-danube-3-4b")
    shape = applicable_shapes(cfg)[0]
    counts = Counts(flops=989e12, hbm_bytes=6.7e12, collective_bytes=45e9,
                    collectives={"all-gather": {"count": 3, "operand_bytes": 45e9}})
    r = TR.analyze("d", shape.name, "pod16x16", 256, counts, cfg, shape)
    assert (r.compute_s, r.memory_s, r.collective_s) == pytest.approx((1.0, 2.0, 0.1))
    assert r.hlo_flops == 989e12 * 256 and r.collective_bytes == 45e9 * 256
    assert r.dominant == "memory" and r.peak_flops == H100_SXM.peak_flops


def test_count_step_counts_a_product_and_skips_views():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    out, c = count_step(lambda x, y: (x @ y).T.contiguous(), a, b)
    assert tuple(out.shape) == (4, 8)
    assert c.flops == 2 * 8 * 16 * 4
    # mm reads a and b and writes 8x4; the transpose is a view; the copy
    # reads and writes 8x4
    assert c.hbm_bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * 2 * (8 * 4)
    assert c.collective_bytes == 0 and c.collectives == {}


def test_peak_leaves_out_meta_tensors():
    """A meta tensor holds no memory: the dry-run's peak counts the devices'
    bytes only (meta stand-ins of the global decode state, which the
    prefill's ``shard_state`` once made, alone made a prefill_32k cell's
    peak hundreds of GB)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch.dryrun import _peak_bytes

    tracker = MemTracker()
    with tracker:
        held = torch.ones(1024)
        stand_in = torch.empty(1 << 30, device="meta")
    assert _peak_bytes(tracker) == held.numel() * 4, stand_in.shape


def _single_process_flops(arch, shape_name):
    """``count_step`` over the port's single-process step of a smoke cell,
    on real CPU tensors."""
    cfg, shape = cell_config(arch, shape_name, smoke=True)
    train = shape.kind == "train"
    model = TM.DecoderLM.from_config(cfg, seed=0, device="cpu", trainable=train)
    step, takes_opt, _ = step_for_cell(cfg, shape)
    args = [model] + ([adamw_init(model, OptSettings.auto(cfg.param_count()))] if takes_opt else [])
    if shape.kind == "decode":
        args += [TM.init_decode_state(cfg, shape.global_batch, shape.seq_len, device="cpu"),
                 torch.zeros((shape.global_batch, 1), dtype=torch.long), shape.seq_len - 1]
    else:
        structs = batch_structs(cfg, shape, with_labels=train)
        args.append({k: torch.zeros(v.shape, dtype=v.dtype) for k, v in structs.items()})
    return count_step(step, *args)[1].flops


def _reference_hlo_flops(arch, shape_name):
    """The reference's own count of a smoke cell: ``HloAnalyzer.flops()``
    over the compiled HLO of its LOCAL step (no rules, this process's one
    CPU device), at the smoke cell's batch and length."""
    _, shape = cell_config(arch, shape_name, smoke=True)
    cfg = rconfigs.reduce_for_smoke(rconfigs.get(arch))
    rshape = {s.name: s for s in r_applicable(rconfigs.get(arch))}[shape_name]
    rshape = dataclasses.replace(rshape, global_batch=shape.global_batch, seq_len=shape.seq_len)
    step, takes_opt, _ = r_step_for_cell(cfg, rshape)
    shapes = RM.param_shapes(cfg)
    args = [shapes] + ([r_opt_state_shapes(shapes, ROptSettings.auto(cfg.param_count()))] if takes_opt else [])
    args.append(r_batch_structs(cfg, rshape, with_labels=rshape.kind == "train"))
    with jax.default_device(jax.devices("cpu")[0]):
        hlo = jax.jit(step).lower(*args).compile().as_text()
    return HloAnalyzer(hlo, n_devices=1).flops()


FLOP_CELLS = [(a, s) for a in SMOKE_ARCHS for s in ("train_4k", "prefill_32k")]
FLOP_TOL = 0.2


@pytest.mark.slow  # compiles six XLA programs
@pytest.mark.parametrize("arch,shape_name", FLOP_CELLS)
def test_counted_flops_match_reference_hlo_count(arch, shape_name):
    """``count_step``'s FLOPs of the port's single-process step against the
    reference's HLO counter over its local step, cell by cell, within 20%.
    The reference also counts one flop for each element of every float
    elementwise op and reduction, and XLA's CPU compiler duplicates a few
    products (an f32 copy of the q and k projections around rope), where
    ``FlopCounterMode`` counts the products alone: on these cells the port
    counts 0.82 to 1.01 of the reference.  A count without the remat
    recompute or without the backward falls outside."""
    want = _reference_hlo_flops(arch, shape_name)
    got = _single_process_flops(arch, shape_name)
    assert abs(got - want) <= FLOP_TOL * want, (got, want, got / want)


# ---------------------------------------------------------------------------
# In subprocesses
# ---------------------------------------------------------------------------
def _env():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    return dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.abspath(src)] + sys.path),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def smoke_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_smoke")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "smoke", "--out", str(out)]
    for a in SMOKE_ARCHS:
        cmd += ["--arch", a]
    p = subprocess.run(cmd, env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return {(d["arch"], d["shape"], d["mesh"]): d
            for d in (json.loads(f.read_text()) for f in out.glob("*.json"))}


class _StandIn:
    def __init__(self, sizes):
        self.shape, self.axis_names = sizes, tuple(sizes)


def _argument_bytes(arch, shape_name, mesh):
    """This rank's (coordinate 0, 0) parameter and moment bytes from the
    specs: every leaf's ``local_slices``."""
    cfg, shape = cell_config(arch, shape_name, smoke=True)
    sizes = dict(zip(("data", "model"), mesh))
    rules = TS.ShardingRules(_StandIn(sizes), fsdp_axes=("data",))
    n = 0
    moment = torch.empty((), dtype=getattr(torch, OptSettings.auto(cfg.param_count()).moment_dtype))
    for lay in TS._leaf_layouts(cfg, rules).values():
        numel = int(np.prod([s.stop - s.start for s in TS.local_slices(lay.spec, lay.shape, sizes, (0, 0))]))
        n += numel * torch.empty((), dtype=lay.dtype).element_size()
        if shape.kind == "train":
            n += 2 * numel * moment.element_size()
    return n


@pytest.mark.slow
@pytest.mark.parametrize("arch,shape_name,mesh", SMOKE_CELLS, ids=SMOKE_IDS)
def test_dryrun_smoke_cell(smoke_cells, arch, shape_name, mesh):
    d = smoke_cells[(arch, shape_name, f"pod{mesh[0]}x{mesh[1]}")]
    assert d["status"] == "ok", d.get("error")
    assert d["memory"]["argument_size_in_bytes"] == _argument_bytes(arch, shape_name, mesh)
    assert d["memory"]["peak_size_in_bytes"] >= d["memory"]["argument_size_in_bytes"] > 0
    r = d["roofline"]
    assert r["chips"] == mesh[0] * mesh[1] and r["hlo_flops"] > 0
    if mesh == (1, 1):
        assert r["collective_bytes"] == 0 and r["collectives"] == {}
        assert r["hlo_flops"] == _single_process_flops(arch, shape_name)
    elif shape_name == "train_4k":
        assert r["collectives"]["all-gather"]["count"] > 0
        assert r["collectives"]["reduce-scatter"]["count"] > 0


def _single_process_flops_at(arch, shape_name, layers, **kw):
    """``_single_process_flops`` of the smoke cell cut to ``layers`` layers
    (and with the config fields ``kw``)."""
    cfg, shape = cell_config(arch, shape_name, smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=layers, **kw)
    model = TM.DecoderLM.from_config(cfg, seed=0, device="cpu", trainable=True)
    step, _, _ = step_for_cell(cfg, shape)
    structs = batch_structs(cfg, shape, with_labels=True)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in structs.items()}
    return count_step(step, model, adamw_init(model, OptSettings.auto(cfg.param_count())), batch)[1].flops


@pytest.mark.slow
def test_tensor_parallel_rank_counts_its_share_of_the_layers():
    """Reduced danube's train step on a fake (data 1, model 2) group: rank
    0's FLOPs are 1/2 of the period stack's plus 1/2 of the head's and the
    CE's (its 512-token vocabulary splits over model 2), within 10%.  The
    stack's count is the single process's at 2 layers less its count at 1
    layer, twice; the rest is what is left at 2 layers: the head product of
    every CE chunk (the embedding lookup and the norms count no FLOPs).  A
    rank that ran every layer whole (the replicated layers before tensor
    parallelism) counts the whole stack, and one that ran the head and CE
    over the whole vocabulary counts the whole rest: the check tells both
    apart."""
    arch, shape_name = "h2o-danube-3-4b", "train_4k"
    f1, f2 = (_single_process_flops_at(arch, shape_name, n) for n in (1, 2))
    stack = 2 * (f2 - f1)
    rest = f2 - stack
    want = rest / 2 + stack / 2
    code = ("import json; from repro_torch.launch.dryrun import run_cell; "
            f"print(json.dumps(run_cell({arch!r}, {shape_name!r}, False, verbose=False, "
            "mesh_shape=(1, 2), smoke=True)))")
    p = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    d = json.loads(p.stdout.strip().splitlines()[-1])
    got = d["roofline"]["hlo_flops"] / d["roofline"]["chips"]
    assert d["status"] == "ok" and d["roofline"]["chips"] == 2
    assert abs(got - want) <= 0.1 * want, (got, want, rest, stack)
    replicated = rest + stack
    assert abs(replicated - want) > 0.1 * want, (replicated, want)
    whole_vocab = rest + stack / 2
    assert abs(whole_vocab - want) > 0.1 * want, (whole_vocab, want, rest)


@pytest.mark.slow
def test_uneven_head_split_rank_counts_its_heads():
    """Reduced danube's train step on a fake (data 1, model 3) group, whose
    model axis divides neither its 4 query heads, nor its d_ff of 128, nor
    its 512-token vocabulary: rank 0 runs attention on its ⌈4/3⌉ = 2 heads
    (and the 2 kv heads they read) and everything else whole, so its FLOPs
    are the single process's with 2 query and 2 kv heads, exactly (within
    1%).  A rank that ran attention on all 4 heads counts 24% more."""
    arch, shape_name = "h2o-danube-3-4b", "train_4k"
    cfg, _ = cell_config(arch, shape_name, smoke=True)
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 4) and cfg.d_ff % 3 and cfg.vocab % 3
    want = _single_process_flops_at(arch, shape_name, cfg.n_layers, n_heads=2, n_kv_heads=2)
    whole = _single_process_flops_at(arch, shape_name, cfg.n_layers)
    code = ("import json; from repro_torch.launch.dryrun import run_cell; "
            f"print(json.dumps(run_cell({arch!r}, {shape_name!r}, False, verbose=False, "
            "mesh_shape=(1, 3), smoke=True)))")
    p = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    d = json.loads(p.stdout.strip().splitlines()[-1])
    got = d["roofline"]["hlo_flops"] / d["roofline"]["chips"]
    assert d["status"] == "ok" and d["roofline"]["chips"] == 3
    assert abs(got - want) <= 0.01 * want, (got, want, whole)
    assert abs(whole - want) > 0.1 * want, (whole, want)


@pytest.mark.slow
def test_dryrun_full_size_cell_completes_on_cpu():
    """danube train_4k on the 16 x 16 production mesh (rank 0's view of a
    256-rank fake group), at full width and depth in one microbatch."""
    code = ("import json; from repro_torch.launch.dryrun import run_cell; "
            "print(json.dumps(run_cell('h2o-danube-3-4b', 'train_4k', False, verbose=False, "
            "microbatches=1)))")
    p = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    d = json.loads(p.stdout.strip().splitlines()[-1])
    assert d["status"] == "ok" and d["mesh"] == "pod16x16" and d["microbatches"] == 1
    cfg = tconfigs.get("h2o-danube-3-4b")
    assert d["roofline"]["model_flops"] == TR.model_flops(cfg, applicable_shapes(cfg)[0])
    # every rank holds 1/256 of every parameter that divides, and two f32 moments of it
    assert d["memory"]["argument_size_in_bytes"] < 3 * 4 * cfg.param_count() / 128
    assert d["memory"]["peak_size_in_bytes"] > d["memory"]["argument_size_in_bytes"]
    assert d["roofline"]["collective_bytes"] > 0 and 0 < d["roofline"]["useful_ratio"] < 1
