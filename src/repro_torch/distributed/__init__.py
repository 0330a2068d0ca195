"""The port's copy of ``repro.distributed.peer_cache`` (the peer tier the
read-tier stack can hold).  Sharding waits for the multi-GPU slice."""
from repro_torch.distributed.peer_cache import PeerCacheRegistry, PeerStore

__all__ = ["PeerCacheRegistry", "PeerStore"]
