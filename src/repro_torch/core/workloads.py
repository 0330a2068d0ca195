"""Workload specs for the paper's experiments and for TPU-scale goodput
analysis.

The two paper workloads (§V-A) with their measured compute times (§V-B:
"our models spent an average of 14.7 s and 147.2 s training on MNIST and
CIFAR-10 respectively" per epoch):
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    n_samples: int  # training-set size
    sample_bytes: int  # raw sample payload
    batch_size: int
    compute_per_epoch_s: float  # per-node compute time for its partition
    n_nodes: int = 3  # the paper's fixed 3-node setup

    @property
    def partition_size(self) -> int:
        return self.n_samples // self.n_nodes

    @property
    def batches_per_epoch(self) -> int:
        return self.partition_size // self.batch_size

    @property
    def compute_per_batch_s(self) -> float:
        return self.compute_per_epoch_s / max(1, self.batches_per_epoch)

    @property
    def dataset_gb(self) -> float:
        return self.n_samples * self.sample_bytes / 1e9

    def scaled(self, factor: float) -> "WorkloadSpec":
        """Shrink a workload for fast tests, preserving every ratio that the
        paper's results depend on (compute:fetch balance, partition:batch)."""
        n = max(self.n_nodes * self.batch_size, int(self.n_samples * factor))
        return dataclasses.replace(
            self,
            name=f"{self.name}-x{factor:g}",
            n_samples=n,
            compute_per_epoch_s=self.compute_per_epoch_s * (n / self.n_samples),
        )


# MNIST: 60k train images, 28x28 grayscale = 784 B raw; 2-conv CNN.
MNIST = WorkloadSpec(
    name="mnist-cnn",
    n_samples=60_000,
    sample_bytes=784,
    batch_size=256,
    compute_per_epoch_s=14.7,
)

# CIFAR-10: 50k train images, 32x32x3 = 3072 B raw; ResNet-50 (~15x slower
# per batch than the CNN, §V-D).
CIFAR10 = WorkloadSpec(
    name="cifar10-resnet50",
    n_samples=50_000,
    sample_bytes=3072,
    batch_size=256,
    compute_per_epoch_s=147.2,
)

PAPER_WORKLOADS = {w.name: w for w in (MNIST, CIFAR10)}


def lm_token_workload(
    name: str,
    seq_len: int,
    global_batch: int,
    steps_per_epoch: int,
    step_time_s: float,
    n_hosts: int,
    bytes_per_token: int = 4,
) -> WorkloadSpec:
    """Cast an LM pre-training shard into the same pipeline vocabulary:
    one 'sample' = one packed sequence of ``seq_len`` tokens.  Used by the
    TPU-scale goodput analysis (EXPERIMENTS.md §Perf) to size fetch/threshold
    for the assigned architectures."""
    return WorkloadSpec(
        name=name,
        n_samples=global_batch * steps_per_epoch,
        sample_bytes=seq_len * bytes_per_token,
        batch_size=max(1, global_batch // n_hosts),
        compute_per_epoch_s=step_time_s * steps_per_epoch,
        n_nodes=n_hosts,
    )
