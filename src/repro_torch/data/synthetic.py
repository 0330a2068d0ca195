"""Synthetic LM dataset + the DELI pipeline assembly the trainer reads from.
The port's copy of ``repro.data.synthetic``, without its spec layer.

One "sample" (bucket object) = one packed int32 token sequence of
``seq_len + 1`` tokens (inputs + shifted labels), which mirrors how
pre-training shards store sequences as objects.

The reference builds ``make_lm_pipeline`` through its declarative
``DataPlaneSpec``, which is not ported; here it always takes the reference's
manual-store branch over a ``SimulatedBucketStore`` of the same payloads,
which yields the same batches (indices and bytes) as the spec path.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.bandwidth import BucketModel
from repro_torch.core.cache import CappedCache
from repro_torch.core.clock import Clock, RealClock
from repro_torch.core.dataset import CachingDataset
from repro_torch.core.loader import DeliLoader
from repro_torch.core.policy import PrefetchConfig
from repro_torch.core.prefetcher import PrefetchService
from repro_torch.core.sampler import DistributedPartitionSampler
from repro_torch.core.store import SampleStore, SimulatedBucketStore
from repro_torch.core.workloads import WorkloadSpec

#: The historical make_lm_pipeline bucket: Table-I ratios at 1/1000 wall
#: time, so threaded LM runs finish in test time.
FAST_FORWARD_BUCKET = BucketModel(
    request_latency_s=0.020e-3, per_connection_bw=20e9, listing_latency_s=0.050e-3
)


def make_lm_payloads(
    n_samples: int, seq_len: int, vocab: int, seed: int = 0
) -> Dict[int, bytes]:
    """Markov-ish synthetic token streams (so the loss actually falls)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(n_samples, seq_len + 1), dtype=np.int32)
    # inject learnable structure: every odd position repeats its predecessor
    base[:, 1::2] = base[:, 0:-1:2]
    return {i: base[i].tobytes() for i in range(n_samples)}


def decode_tokens(payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, dtype=np.int32)


def lm_workload(
    n_samples: int, seq_len: int, batch_size: int, world: int = 1
) -> WorkloadSpec:
    """The LM shard as a pipeline workload: one sample = one packed
    ``seq_len + 1``-token int32 sequence (inputs + shifted labels).
    Compute is 0 here — the trainer's real step time drives the clock on
    the free-running path."""
    return WorkloadSpec(
        name="lm-synthetic",
        n_samples=n_samples,
        sample_bytes=(seq_len + 1) * 4,
        batch_size=batch_size,
        compute_per_epoch_s=0.0,
        n_nodes=world,
    )


def make_lm_pipeline(
    *,
    n_samples: int,
    seq_len: int,
    vocab: int,
    batch_size: int,
    cache_items: int = 2048,
    rank: int = 0,
    world: int = 1,
    policy: Optional[PrefetchConfig] = None,
    store: Optional[SampleStore] = None,
    bucket_model: Optional[BucketModel] = None,
    clock: Optional[Clock] = None,
    seed: int = 0,
) -> Tuple[DeliLoader, PrefetchService, CachingDataset]:
    """Rank's ``(loader, service, dataset)`` over ``store``, or else over a
    simulated bucket of ``make_lm_payloads(n_samples, seq_len, vocab, seed)``
    timed by ``bucket_model`` (the fast-forwarded bucket by default).

    Callers ``service.start()`` (or ``with service:``), iterate the loader,
    and ``service.close()`` at exit — the reference's contract.
    """
    clock = clock or RealClock()
    policy = policy or PrefetchConfig.fifty_fifty(cache_items)
    if store is None:
        store = SimulatedBucketStore(
            make_lm_payloads(n_samples, seq_len, vocab, seed=seed),
            model=bucket_model or FAST_FORWARD_BUCKET,
            clock=clock,
        )
    cache = CappedCache(max_items=cache_items)
    dataset = CachingDataset(store, cache, insert_on_miss=policy.enabled is False)
    service = PrefetchService(store=store, cache=cache, n_connections=16, clock=clock)
    sampler = DistributedPartitionSampler(n_samples, rank=rank, world=world, seed=seed)
    loader = DeliLoader(
        dataset, sampler, batch_size=batch_size, config=policy,
        service=service, clock=clock, node=rank,
    )
    return loader, service, dataset
