"""Samplers: epoch ordering + distributed partitioning.

``DistributedPartitionSampler`` mirrors the behaviour of
``torch.utils.data.DistributedSampler`` that the paper's experiments rely on
(§V-A): every epoch a *new* seeded global permutation is drawn and node ``i``
takes a strided slice — so a node's partition is re-randomized each epoch.
This is precisely what produces the paper's ~66% epoch-2 miss rate for an
unlimited cache (Fig. 5): only ~1/n of a node's new partition was in its
previous partition.

``LocalityAwareSampler`` (beyond-paper, §VI direction + Yang & Cong '19):
keeps the global permutation but assigns each sample preferentially to a
node that already holds it in cache, subject to exact load balance.  All
nodes compute the same assignment from the same inputs (cache key sets are
exchanged via an all-gather in a real deployment; here they are passed in),
so no coordination service is needed.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np


class Sampler:
    """Base: iterable over dataset indices for the current epoch."""

    def __init__(self, n_samples: int):
        self.n_samples = n_samples
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> List[int]:
        raise NotImplementedError

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        return self.n_samples


class SequentialSampler(Sampler):
    def indices(self) -> List[int]:
        return list(range(self.n_samples))


class RandomSampler(Sampler):
    def __init__(self, n_samples: int, seed: int = 0):
        super().__init__(n_samples)
        self.seed = seed

    def indices(self) -> List[int]:
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(self.n_samples).tolist()


def _global_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng((seed, epoch)).permutation(n)


class DistributedPartitionSampler(Sampler):
    """Random global permutation, strided slice per node (PyTorch semantics).

    Node ``rank`` of ``world`` sees indices perm[rank::world]; all ranks draw
    the identical permutation (same seed+epoch), so partitions are disjoint
    and exhaustive. ``drop_last``-style truncation keeps partitions equal.
    """

    def __init__(self, n_samples: int, rank: int, world: int, seed: int = 0):
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} out of range for world {world}")
        super().__init__(n_samples)
        self.rank = rank
        self.world = world
        self.seed = seed

    @property
    def partition_size(self) -> int:
        return self.n_samples // self.world

    def indices(self) -> List[int]:
        perm = _global_permutation(self.n_samples, self.seed, self.epoch)
        usable = self.partition_size * self.world
        return perm[:usable][self.rank :: self.world].tolist()

    def __len__(self) -> int:
        return self.partition_size


class SharedShuffleSampler(Sampler):
    """Every node streams the *full* dataset in its own seeded order.

    The paper's experiments partition each epoch (DistributedSampler
    semantics), so two nodes never touch the same index within one epoch —
    which makes *same-epoch* cross-node cache effects invisible by
    construction.  Hoard's setting (Pinto et al.) is the opposite: nodes
    run IID passes over the whole dataset, so node B routinely wants a
    sample node A cached minutes ago in the *current* epoch.  This sampler
    models that regime; it is what the mid-epoch peer-visibility tests (and
    the event-interleaved scheduler's fidelity claim) exercise.

    The permutation is a pure function of ``(seed, rank, epoch)``: no
    coordination, deterministic on every node and on both execution paths.
    """

    def __init__(self, n_samples: int, rank: int, world: int, seed: int = 0):
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} out of range for world {world}")
        super().__init__(n_samples)
        self.rank = rank
        self.world = world
        self.seed = seed

    @property
    def partition_size(self) -> int:
        return self.n_samples  # every node sees everything

    def indices(self) -> List[int]:
        rng = np.random.default_rng((self.seed, self.rank, self.epoch))
        return rng.permutation(self.n_samples).tolist()


class LocalityAwareSampler(Sampler):
    """Cache-aware epoch partitioning (beyond-paper).

    Given every node's cached index set, assign each sample of the epoch's
    global permutation to a node that caches it when possible, while keeping
    partitions exactly balanced.  Determinism: assignment is a pure function
    of (seed, epoch, sorted cache sets), identical on every node.

    Expected effect: with an unlimited cache the epoch-2 miss rate drops
    from ~(1 - 1/n) to ~0 — benchmarked in benchmarks/beyond_paper.py.
    Shuffling quality note: within-node order remains a random subsequence
    of a uniform global permutation; cross-node sample-to-node assignment
    becomes cache-correlated, which is an explicit trade-off (recorded in
    DESIGN.md) and can be annealed with ``locality_fraction``.
    """

    def __init__(
        self,
        n_samples: int,
        rank: int,
        world: int,
        seed: int = 0,
        locality_fraction: float = 1.0,
        peer_aware: bool = False,
    ):
        super().__init__(n_samples)
        self.rank = rank
        self.world = world
        self.seed = seed
        self.locality_fraction = locality_fraction
        # Cooperative peer-cache tier: an index cached *anywhere* is cheap
        # for every node (one peer RTT), only bucket-only indices pay a
        # Class B GET.  With ``peer_aware`` the leftover fill spreads the
        # bucket-only indices evenly across nodes (on-node > on-peer >
        # bucket-only preference) so no node eats a disproportionate share
        # of the expensive misses.
        self.peer_aware = peer_aware
        self._cache_views: Optional[List[frozenset]] = None

    def update_cache_views(self, cached_indices_per_node: Sequence[Sequence[int]]) -> None:
        if len(cached_indices_per_node) != self.world:
            raise ValueError("need one cache view per node")
        self._cache_views = [frozenset(v) for v in cached_indices_per_node]

    @property
    def partition_size(self) -> int:
        return self.n_samples // self.world

    def _assign(self) -> Dict[int, List[int]]:
        perm = _global_permutation(self.n_samples, self.seed, self.epoch)
        usable = perm[: self.partition_size * self.world]
        quota = {r: self.partition_size for r in range(self.world)}
        assignment: Dict[int, List[int]] = {r: [] for r in range(self.world)}
        views = self._cache_views or [frozenset()] * self.world
        # Budget of locality-preferred picks per node (annealing knob).
        locality_budget = {
            r: int(self.partition_size * self.locality_fraction) for r in range(self.world)
        }
        leftovers: List[int] = []
        for idx in usable.tolist():
            holders = [r for r in range(self.world) if idx in views[r]]
            placed = False
            # Prefer the holder with the most remaining quota (break ties by
            # rank) — greedy balance.
            for r in sorted(holders, key=lambda r: (-quota[r], r)):
                if quota[r] > 0 and locality_budget[r] > 0:
                    assignment[r].append(idx)
                    quota[r] -= 1
                    locality_budget[r] -= 1
                    placed = True
                    break
            if not placed:
                leftovers.append(idx)
        # Round-robin the rest into remaining quota, in permutation order.
        # Peer-aware tiering: fill bucket-only leftovers first (max-quota
        # greedy spreads them evenly — they are the expensive ones under a
        # peer-cache tier), then the on-peer leftovers, which any node can
        # serve cheaply from whoever holds them.
        if self.peer_aware:
            anywhere = frozenset().union(*views)
            leftovers = sorted(leftovers, key=lambda idx: idx in anywhere)
        ranks_cycle = sorted(range(self.world), key=lambda r: -quota[r])
        for idx in leftovers:
            ranks_cycle.sort(key=lambda r: -quota[r])
            r = ranks_cycle[0]
            assignment[r].append(idx)
            quota[r] -= 1
        assert all(q == 0 for q in quota.values())
        return assignment

    def indices(self) -> List[int]:
        return self._assign()[self.rank]

    def __len__(self) -> int:
        return self.partition_size


def partition_fingerprint(indices: Sequence[int]) -> str:
    """Stable digest of a partition (used by elastic restart validation)."""
    h = hashlib.sha256()
    for i in indices:
        h.update(int(i).to_bytes(8, "little"))
    return h.hexdigest()[:16]
