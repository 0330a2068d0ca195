"""Device meshes, and the card's roofline constants: the port of
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dim names
``("data", "model")`` over the ranks of the current process group, which
the caller initialises (``repro_torch.distributed.ranks.run_ranks`` starts
one).  Code that only needs the mesh's sizes reads them by axis name
(``mesh_sizes``), so a stand-in with a ``shape`` dict and ``axis_names``
serves as well as a real mesh.

``make_production_mesh`` gives the reference's production layouts over the
current group; the dry-run (``launch/dryrun.py``) builds them over a fake
group of one process.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production layouts over the ranks of the current
    group (256 or 512 of them): ``(data 16, model 16)``, or ``(pod 2, data
    16, model 16)``, with the reference's axis names, so a cell of either
    package's dry-run names the same layout.

    On H100s a model axis of 16 spans two 8-GPU NVLink nodes: the roofline's
    one link rate (``HardwareSpec.ici_bw``) does not model the link between
    them, nor the one between pods (the reference has no such term either).
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_smoke_mesh(n_data: int = 1, n_model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over every rank of the current group; the world
    size must be ``n_data * n_model``.  The card by default; pass
    ``device_type="cpu"`` for CPU ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def make_custom_mesh(n_data: int, n_model: int, device_type: str = "cuda"):
    """Any (data, model) split of the current group's ranks."""
    return make_smoke_mesh(n_data, n_model, device_type)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or of a stand-in
    whose ``shape`` is already such a dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple:
    """The mesh axes the global batch is sharded over (FSDP axes)."""
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants per card, under the reference's field names
    (``ici_bw`` is the card-to-card link).

    The defaults are NVIDIA's data sheet for the H100 SXM5 at its 700 W
    limit (the figures PERF.md §2 uses): 989 TFLOP/s dense bf16 on the
    tensor cores, 3.35 TB/s of HBM3, 900 GB/s of NVLink in both directions
    together (450 GB/s each way), 80 GB.  They are data-sheet figures, not
    measurements."""

    name: str = "NVIDIA H100 80GB HBM3"
    peak_flops: float = 989e12  # bf16 FLOP/s, dense
    hbm_bw: float = 3.35e12  # bytes/s
    ici_bw: float = 450e9  # bytes/s, NVLink, one direction
    hbm_bytes: float = 80e9  # capacity


H100_SXM = HardwareSpec()
