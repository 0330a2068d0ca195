"""repro_torch.core — the port's own copy of the DELI data plane that the
trainer runs: stores, the capped cache, the pre-fetch policy and service,
samplers, the loader and the lock-step machinery the loader shares.

Each module is a copy of its namesake in ``repro.core`` (the import rule: the
port never imports ``repro``); the copies differ only in their imports and in
the parity-linter marker comments, which mark a mirror pair in the reference
and are left out here.  The simulator, the cost model and supersamples are
not copied: the trainer needs none of them.
"""
from repro_torch.core.bandwidth import (
    DEFAULT_BUCKET,
    DEFAULT_DISK,
    DEFAULT_NETWORK,
    DEFAULT_PIPELINE,
    DEFAULT_PROFILE,
    BucketModel,
    CollectiveModel,
    DiskModel,
    NetworkModel,
    NodeProfile,
    PipelineCostModel,
    arch_gradient_bytes,
    mnist_cnn_gradient_bytes,
    straggler_profiles,
)
from repro_torch.core.cache import CappedCache, EvictionPolicy, FifoEviction
from repro_torch.core.clock import RealClock, VirtualClock
from repro_torch.core.dataset import CachingDataset
from repro_torch.core.listing_cache import ListingCache
from repro_torch.core.lockstep import (
    STEP_BATCH_END,
    STEP_CONTINUE,
    STEP_DONE,
    BucketedBatchComm,
    LockstepPrefetchService,
    SubstepAccess,
)
from repro_torch.core.loader import Batch, DeliLoader, run_epochs
from repro_torch.core.policy import PrefetchConfig, PrefetchPlanner, validate_config_against_cache
from repro_torch.core.prefetcher import PrefetchService
from repro_torch.core.sampler import (
    DistributedPartitionSampler,
    LocalityAwareSampler,
    RandomSampler,
    SequentialSampler,
    SharedShuffleSampler,
)
from repro_torch.core.store import (
    FileSystemStore,
    InMemoryStore,
    ReliableStore,
    SampleStore,
    SimulatedBucketStore,
    StoreError,
    make_synthetic_payloads,
)
from repro_torch.core.types import (
    EpochStats,
    FetchRequest,
    RunStats,
    Sample,
    SampleKey,
    StoreStats,
    aggregate_tier_hits,
)
from repro_torch.core.workloads import CIFAR10, MNIST, PAPER_WORKLOADS, WorkloadSpec, lm_token_workload
