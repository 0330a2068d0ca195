"""Granite 4.0-H's layout: the built-in leaves and counts, and beside each
mixture of experts its shared SwiGLU expert of ``shared_intermediate_size``
(``mlp/shared_gate`` and ``mlp/shared_up`` (d, F), ``mlp/shared_down``
(F, d)), which every token's products use: 3·d·F weights a layer."""
from bench_port import layouts, weights
from bench_port.frozen import flops


def _moe_positions(cfg):
    """The positions of the period that hold a shared expert: every MoE's, where it has one."""
    if not cfg.get("shared_intermediate_size", 0):
        return []
    return [i for i, (_, mlp) in enumerate(layouts.positions(cfg)) if mlp == "moe"]


def leaves(cfg):
    d, F, n = cfg["d_model"], cfg["shared_intermediate_size"], layouts.n_periods(cfg)
    out = weights.leaves(cfg)
    for i in _moe_positions(cfg):
        p = f"stack/pos{i}/mlp/"
        out += [(p + "shared_gate", (n, d, F), "dense"), (p + "shared_up", (n, d, F), "dense"),
                (p + "shared_down", (n, F, d), "dense")]
    return out


def matmul_params(cfg):
    shared = 3 * cfg["d_model"] * cfg["shared_intermediate_size"]
    return flops.matmul_params(cfg) + layouts.n_periods(cfg) * len(_moe_positions(cfg)) * shared


def mixer_flops(cfg, B, S):
    return flops.mixer_flops(cfg, B, S)
