"""The port's copy of ``repro.pipeline.tiers``: the read-tier stack that the
dataset and the pre-fetch service read through.  The declarative spec layer
(``DataPlaneSpec``), the registry and the parity harness are not copied."""
from repro_torch.pipeline.tiers import (  # noqa: F401
    LOCAL_TIERS,
    BucketTier,
    DiskSourceTier,
    DiskTier,
    PeerTier,
    RamTier,
    ReadTier,
    TierResult,
    TierStack,
    local_tiers_for_cache,
    tiers_for_store,
)

__all__ = [
    "LOCAL_TIERS",
    "BucketTier",
    "DiskSourceTier",
    "DiskTier",
    "PeerTier",
    "RamTier",
    "ReadTier",
    "TierResult",
    "TierStack",
    "local_tiers_for_cache",
    "tiers_for_store",
]
