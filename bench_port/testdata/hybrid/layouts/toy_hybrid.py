"""The toy hybrid's layout: the built-in leaves of its tied twin, then the
untied head, which the layout draws itself (one leaf added); the counts
are the built-ins'.  ``CALLED`` records which of the three the harness
asked for."""
from bench_port import weights
from bench_port.frozen import flops

CALLED = set()


def leaves(cfg):
    CALLED.add("leaves")
    return weights.leaves(dict(cfg, tie_embeddings=True)) + [("head", (cfg["d_model"], cfg["vocab"]), "dense")]


def matmul_params(cfg):
    CALLED.add("matmul_params")
    return flops.matmul_params(cfg)


def mixer_flops(cfg, B, S):
    CALLED.add("mixer_flops")
    return flops.mixer_flops(cfg, B, S)
