"""Dry-run of every (architecture x input-shape) cell on the production
meshes, in one CPU process and without a card: the port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh smoke --arch h2o-danube-3-4b

Each cell starts a fake process group of the mesh's size in this process
(``torch.testing``'s ``FakeStore``, backend ``"fake"``: every collective
returns at once) and takes rank 0's view, where the reference forces 512 XLA
host devices.  Under ``FakeTensorMode`` it builds the ``ShardedLM`` from the
parameter shapes (``ShardedLM.empty``: every tensor is fake, nothing is
allocated), the optimizer state and the inputs, runs one step from
``step_for_cell`` and reports:

  * the argument bytes: this rank's parameter and moment shards, exact from
    the specs;
  * the peak of live (fake) tensor bytes during the step
    (``torch.distributed._tools.mem_tracker.MemTracker``), and whether it
    fits the card's HBM (``H100_SXM.hbm_bytes``);
  * the roofline terms of ``launch/roofline.py`` from ``launch/counting.py``.

The cells run as the reference's dry-run does, without the hand kernels
(``use_pallas`` is False there): a fake tensor cannot enter a compiled
kernel, so prefill takes the chunked attention.  ``--mesh smoke`` runs the
reduced configs on (1, 1) and (2, 2) groups, each applicable shape cut to a
batch of at most 4 and 64 positions.  Results are written one JSON per
cell, so the sweep is resumable (``--skip-existing``); a failed cell is
recorded with its error and the sweep goes on.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.distributed.sharding import (
    ShardedLM,
    ShardingRules,
    from_local,
    local_slices,
    placements,
    state_shardings,
)
from repro_torch.launch import roofline as R
from repro_torch.launch.counting import count_step
from repro_torch.launch.inputs import batch_structs
from repro_torch.launch.mesh import H100_SXM, batch_axes, make_custom_mesh, make_production_mesh, mesh_sizes
from repro_torch.launch.steps import step_for_cell
from repro_torch.models import model as M
from repro_torch.models.config import applicable_shapes
from repro_torch.training.optimizer import OptSettings, adamw_init

SMOKE_MESHES = ((1, 1), (2, 2))
SMOKE_BATCH, SMOKE_SEQ = 4, 64


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks in this process, as rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return f"pod{mesh_shape[0]}x{mesh_shape[1]}"
    return "pod2x16x16" if multi_pod else "pod16x16"


def cell_config(arch: str, shape_name: str, smoke: bool = False):
    """(config, shape) of a cell: without the hand kernels, and for a smoke
    cell the reduced config at a batch of at most 4 and 64 positions."""
    cfg = configs.get(arch)
    if smoke:
        cfg = configs.reduce_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, use_kernels=False)
    shape = {s.name: s for s in applicable_shapes(cfg)}[shape_name]
    if smoke:
        shape = dataclasses.replace(shape, global_batch=min(shape.global_batch, SMOKE_BATCH),
                                    seq_len=SMOKE_SEQ)
    return cfg, shape


def _zeros(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros(t.shape, dtype=t.dtype)


def step_inputs(cfg, shape, rules):
    """The step's inputs after (params, opt_state): the global batch, or a
    decode state laid out by ``state_shardings`` with the global tokens and
    the last cache slot."""
    if shape.kind in ("train", "prefill"):
        structs = batch_structs(cfg, shape, with_labels=shape.kind == "train")
        return ({k: _zeros(v) for k, v in structs.items()},)
    mesh = rules.mesh
    sizes, coord = mesh_sizes(mesh), mesh.get_coordinate()
    caches, kv_len = M.init_decode_state(cfg, shape.global_batch, shape.seq_len, device="meta")
    specs, kv_spec = state_shardings(rules, cfg, (caches, kv_len))

    def shard(t, spec):
        sl = local_slices(spec, t.shape, sizes, coord)
        local = torch.zeros([s.stop - s.start for s in sl], dtype=t.dtype)
        return from_local(local, mesh, placements(spec, mesh), t.shape)

    state = ({pos: {n: shard(t, specs[pos][n]) for n, t in sub.items()} for pos, sub in caches.items()},
             shard(kv_len, kv_spec))
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.long)
    return state, tokens, shape.seq_len - 1


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _peak_bytes(tracker) -> int:
    """The peak of live bytes on the devices, the meta device left out: a
    meta tensor (a shape stand-in) holds no memory."""
    snap = tracker.get_tracker_snapshot("peak")
    return int(sum(dev["Total"] for where, dev in snap.items() if torch.device(where).type != "meta"))


def _fake_step(cfg, shape_cfg, rules, microbatches):
    """One step of rank 0 on fake tensors: (counts, peak live bytes, argument
    bytes, microbatches)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    model = ShardedLM.empty(cfg, rules, "cpu", trainable=shape_cfg.kind == "train")
    step, takes_opt, n_micro = step_for_cell(cfg, shape_cfg, rules, microbatches=microbatches)
    args = [model]
    held = list(model.parameters())
    if takes_opt:
        opt = adamw_init(model, OptSettings.auto(cfg.param_count()))
        args.append(opt)
        held += list(opt["m"].values()) + list(opt["v"].values())
    argument_bytes = _nbytes(held)
    inputs = step_inputs(cfg, shape_cfg, rules)
    tracker = MemTracker()
    tracker.track_external(*held)
    with tracker:
        _, counts = count_step(step, *args, *inputs)
    peak = _peak_bytes(tracker)
    return counts, peak, argument_bytes, n_micro


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    verbose: bool = True,
    microbatches: int = None,
    mesh_shape: tuple = None,  # (data, model), e.g. the smoke meshes
    smoke: bool = False,
) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, shape_cfg = cell_config(arch, shape_name, smoke)
    name = mesh_name(multi_pod, mesh_shape)
    world = 1
    for n in (mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))):
        world *= n
    t0 = time.time()
    with fake_group(world):
        if mesh_shape is not None:  # built outside fake mode: a mesh holds real rank ids
            mesh = make_custom_mesh(*mesh_shape, device_type="cpu")
        else:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = ShardingRules(mesh, fsdp_axes=batch_axes(mesh))
        chips = mesh.size()
        with FakeTensorMode():
            counts, peak, argument_bytes, n_micro = _fake_step(cfg, shape_cfg, rules, microbatches)
    report = R.analyze(arch, shape_name, name, chips, counts, cfg, shape_cfg)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": name,
        "status": "ok",
        "microbatches": n_micro,
        "global_batch": shape_cfg.global_batch,
        "seq_len": shape_cfg.seq_len,
        "count_s": round(time.time() - t0, 1),
        "memory": {
            "argument_size_in_bytes": argument_bytes,
            "peak_size_in_bytes": peak,
            "hbm_bytes": H100_SXM.hbm_bytes,
            "fits": peak <= H100_SXM.hbm_bytes,
        },
        "roofline": report.to_json(),
    }
    if verbose:
        r = report
        print(
            f"[{arch} x {shape_name} x {name}] compute={r.compute_s:.4f}s "
            f"memory={r.memory_s:.4f}s collective={r.collective_s:.4f}s "
            f"dominant={r.dominant} useful={r.useful_ratio:.2f} "
            f"roofline_frac={r.roofline_fraction:.3f} peak={peak / 1e9:.2f}GB", flush=True
        )
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="an arch id, may be repeated (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all applicable)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "smoke"])
    ap.add_argument("--out", default="results/dryrun_torch", help="output dir (one JSON per cell)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = args.arch or configs.ARCH_IDS
    smoke = args.mesh == "smoke"
    if smoke:
        meshes = [(False, m) for m in SMOKE_MESHES]
    else:
        meshes = [(multi, None) for multi in {"single": [False], "multi": [True],
                                              "both": [False, True]}[args.mesh]]

    failures = []
    for arch in archs:
        shapes = [s.name for s in applicable_shapes(configs.get(arch))]
        if args.shape:
            if args.shape not in shapes:
                print(f"SKIP {arch} x {args.shape}: not applicable")
                continue
            shapes = [args.shape]
        for shape_name in shapes:
            for multi, mesh_shape in meshes:
                name = mesh_name(multi, mesh_shape)
                path = outdir / f"{arch}__{shape_name}__{name}.json"
                if args.skip_existing and path.exists():
                    print(f"SKIP (exists) {path.name}")
                    continue
                print(f"=== {arch} x {shape_name} x {name} ===", flush=True)
                try:
                    result = run_cell(arch, shape_name, multi, mesh_shape=mesh_shape, smoke=smoke)
                except Exception as e:  # record the failure, keep sweeping
                    traceback.print_exc()
                    result = {
                        "arch": arch, "shape": shape_name, "mesh": name,
                        "status": "fail", "error": f"{type(e).__name__}: {e}",
                    }
                    failures.append(path.name)
                path.write_text(json.dumps(result, indent=1))
    if failures:
        print(f"FAILED cells ({len(failures)}): {failures}")
        raise SystemExit(1)
    print("all requested cells OK")


if __name__ == "__main__":
    main()
