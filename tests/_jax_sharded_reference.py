"""The reference's side of tests/test_torch_sharded_moe.py, in a process of
its own: it needs four XLA host devices, and the test process must keep the
single real CPU device (tests/conftest.py).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/_jax_sharded_reference.py OUT.npz

Writes, for every block case of ``_torch_rank_cases`` (reduced phi3.5-moe and
dbrx, f32 and bf16, meshes (1, 2) and (2, 2)), the reference's sharded
``moe_block`` output and, in f32, ``jax.grad`` of sum(y * g) with respect to
the parameters and x; and, for the table configs on (2, 2), every
parameter leaf's ``NamedSharding.devices_indices_map`` as (start, stop)
pairs by mesh coordinate.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

import _torch_rank_cases as C
from repro import configs
from repro.distributed.sharding import ShardingRules, param_shardings
from repro.launch.mesh import make_smoke_mesh
from repro.models import model as RM
from repro.models.moe import MeshContext, moe_block


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def block_cases(out: dict) -> None:
    for shape in C.BLOCK_MESHES:
        mesh = make_smoke_mesh(*shape)
        ctx = MeshContext(mesh, batch_axes=("data",))
        for arch in C.BLOCK_ARCHS:
            for dtype in C.BLOCK_DTYPES:
                cfg = C.case_cfg(configs, arch, dtype, capacity_factor=C.BLOCK_CAPACITY)
                key = C.block_key(arch, dtype, shape)
                params, x, g = C.block_inputs(cfg)
                dt = jnp.dtype(dtype)
                p = {k: jnp.asarray(v, dt) for k, v in params.items()}
                xj = jnp.asarray(x, dt)
                y = jax.jit(lambda p, x: moe_block(p, x, cfg, ctx))(p, xj)
                out[f"{key}|y"] = np.asarray(y.astype(jnp.float32))
                if dtype != "float32":
                    continue

                def loss(p, x):
                    return (moe_block(p, x, cfg, ctx).astype(jnp.float32) * g).sum()

                with jax.set_mesh(mesh):  # make_mesh's axes are Explicit
                    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, xj)
                out[f"{key}|grad_x"] = np.asarray(gx)
                for k, v in gp.items():
                    out[f"{key}|grad_{k}"] = np.asarray(v)


def tables(out: dict) -> None:
    mesh = make_smoke_mesh(2, 2)
    rules = ShardingRules(mesh, fsdp_axes=("data",))
    for arch in C.TABLE_ARCHS:
        cfg = C.case_cfg(configs, arch)
        shapes = RM.param_shapes(cfg)
        shard = dict(_leaves(param_shardings(rules, cfg, shapes)))
        for path, leaf in _leaves(shapes):
            held = shard[path].devices_indices_map(leaf.shape)
            for d in range(2):
                for m in range(2):
                    sl = held[mesh.devices[d, m]]
                    out[f"table|{arch}|{path}|{d}{m}"] = np.array(
                        [s.indices(n)[:2] for s, n in zip(sl, leaf.shape)])


def main(path: str) -> None:
    if len(jax.devices()) < 4:
        raise SystemExit(f"need 4 XLA host devices, have {len(jax.devices())}: set XLA_FLAGS")
    out: dict = {}
    block_cases(out)
    tables(out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
