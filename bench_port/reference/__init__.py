"""Plain float32 PyTorch references of the benchmark's configurations.
They import neither the port nor JAX: only torch, numpy and the standard
library."""
