"""The port's copy of ``repro.engine.kernels``: the per-sample cost
arithmetic (``DemandKernel``) that the loader shares with the lock-step
machinery.  The vector engine belongs to the simulator and is not copied."""
from repro_torch.engine.kernels import DemandKernel

__all__ = ["DemandKernel"]
