"""Roofline terms of one step: the port of ``repro.launch.roofline``.

Three terms, in seconds a step, on the card's data-sheet constants
(``launch.mesh.H100_SXM``):

    compute    = FLOPs            / (chips * peak_flops)
    memory     = HBM bytes        / (chips * hbm_bw)
    collective = collective bytes / (chips * ici_bw)

The counts come from ``launch/counting.py`` (one dispatch-mode pass over one
rank's step) in place of the reference's post-SPMD HLO walker; collective
bytes are operand bytes, the reference's definition (an all-gather's
operand is its input, a reduce-scatter's its whole input).  Also reported:
MODEL_FLOPS (6·N_active·tokens for training, 2·N_active·tokens for
inference) and the usefulness ratio MODEL_FLOPS / FLOPs, which catches
remat and redundant work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.launch.mesh import H100_SXM, HardwareSpec
from repro_torch.models.config import ArchConfig, ShapeConfig


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N_active·D for training, 2·N_active·D for inference (D = tokens
    processed in the step: B·S for train/prefill, B for decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens_per_step
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
    return 2.0 * n_active * tokens


@dataclasses.dataclass
class RooflineReport:
    """The reference's report, field for field.  ``hlo_flops`` and
    ``hlo_bytes`` hold the counted FLOPs and eager HBM bytes of every rank
    together (per-rank counts times chips); ``xla_flops`` and ``xla_bytes``
    (XLA's cost analysis in the reference) stay 0, kept so both packages'
    JSONs share their keys.  ``peak_flops`` is the card's, which
    ``roofline_fraction`` divides by."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per-rank FLOPs * chips (total)
    hlo_bytes: float
    collective_bytes: float  # total operand bytes across chips
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    collectives: Dict[str, Dict]
    xla_flops: float = 0.0
    xla_bytes: float = 0.0
    peak_flops: float = H100_SXM.peak_flops

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chips' peak FLOP/s the step would achieve if it
        ran exactly at the max(terms) bound: model-useful MFU upper bound."""
        if not self.bound_s:
            return 0.0
        return self.model_flops / (self.bound_s * self.chips * self.peak_flops)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["useful_ratio"] = self.useful_ratio
        d["roofline_fraction"] = self.roofline_fraction
        d["bound_s"] = self.bound_s
        return d


def analyze(
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    counts,
    cfg: ArchConfig,
    shape_cfg: ShapeConfig,
    hw: HardwareSpec = H100_SXM,
) -> RooflineReport:
    """The report from one rank's ``counting.Counts`` (SPMD: every rank runs
    the same step, so totals scale by chips)."""
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=counts.flops * chips,
        hlo_bytes=counts.hbm_bytes * chips,
        collective_bytes=counts.collective_bytes * chips,
        compute_s=counts.flops / hw.peak_flops,
        memory_s=counts.hbm_bytes / hw.hbm_bw,
        collective_s=counts.collective_bytes / hw.ici_bw,
        model_flops=model_flops(cfg, shape_cfg),
        collectives=counts.collectives,
        peak_flops=hw.peak_flops,
    )
