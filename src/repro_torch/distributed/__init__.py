"""The port's copy of ``repro.distributed.peer_cache`` (the peer tier the
read-tier stack can hold); ``sharding``, the port of
``repro.distributed.sharding`` on a ``DeviceMesh``; and ``ranks``, which runs
a rank group in processes of its own."""
from repro_torch.distributed.peer_cache import PeerCacheRegistry, PeerStore

__all__ = ["PeerCacheRegistry", "PeerStore"]
