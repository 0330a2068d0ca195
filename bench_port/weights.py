"""Weights of a configuration, drawn from the run's seed on the run's device.

The layout is the port's parameter tree (``DecoderLM(cfg, tree)`` checks
every leaf's shape and dtype): ``embed``, ``head`` (untied only),
``final_norm`` and ``stack/pos0/...`` leaves with a leading axis of layers.
Every matrix comes out of one ``torch.randn`` call in the served dtype,
scaled by fan_in ** -0.5; norms are ones, biases zeros; an SSM's ``A_log``,
``dt_bias`` and ``D`` follow the Mamba-2 initialisation (A uniform in
[1, 16], dt log-uniform in [1e-3, 1e-1]).  The same seed on the same device
gives the same bits, so the reference can draw them again.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _leaves(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(path, shape, rule) of every leaf; rule is "dense", "ones", "zeros",
    or an SSM rule ("A_log", "dt_bias", "D")."""
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    out = [("embed", (V, d), "dense")]
    if not cfg.get("tie_embeddings", False):
        out.append(("head", (d, V), "dense"))
    out.append(("final_norm", (d,), "ones"))
    p = "stack/pos0/"
    out.append((p + "norm1", (L, d), "ones"))
    if cfg["family"] == "ssm":
        di = cfg["ssm_expand"] * d
        H = di // cfg["ssm_head_dim"]
        GN = cfg["ssm_groups"] * cfg["ssm_state"]
        conv = di + 2 * GN
        out += [
            (p + "mixer/in_proj", (L, d, 2 * di + 2 * GN + H), "dense"),
            (p + "mixer/conv_w", (L, cfg["ssm_conv"], conv), "dense"),
            (p + "mixer/conv_b", (L, conv), "zeros"),
            (p + "mixer/A_log", (L, H), "A_log"),
            (p + "mixer/D", (L, H), "D"),
            (p + "mixer/dt_bias", (L, H), "dt_bias"),
            (p + "mixer/gate_norm", (L, di), "ones"),
            (p + "mixer/out_proj", (L, di, d), "dense"),
        ]
        return out
    hd = cfg["head_dim"]
    q, kv, f = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd, cfg["d_ff"]
    out += [
        (p + "mixer/wq", (L, d, q), "dense"),
        (p + "mixer/wk", (L, d, kv), "dense"),
        (p + "mixer/wv", (L, d, kv), "dense"),
        (p + "mixer/wo", (L, q, d), "dense"),
        (p + "norm2", (L, d), "ones"),
        (p + "mlp/w_gate", (L, d, f), "dense"),
        (p + "mlp/w_up", (L, d, f), "dense"),
        (p + "mlp/w_down", (L, f, d), "dense"),
    ]
    return out


F32_LEAVES = ("A_log", "D", "dt_bias")  # an SSM's small leaves stay f32


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flat dict path -> tensor (``nest`` makes the port's tree of it)."""
    dt = _DTYPES[cfg["dtype"]]
    g = torch.Generator(device=device).manual_seed(seed)
    leaves = _leaves(cfg)
    dense = [(p, s) for p, s, r in leaves if r == "dense"]
    flat = torch.randn(sum(math.prod(s) for _, s in dense), generator=g, dtype=dt, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for path, shape in dense:
        n = math.prod(shape)
        out[path] = flat[at : at + n].view(shape).mul_(shape[-2] ** -0.5)
        at += n
    for path, shape, rule in leaves:
        if rule == "dense":
            continue
        leaf_dt = torch.float32 if path.rsplit("/", 1)[-1] in F32_LEAVES else dt
        if rule in ("ones", "D"):
            out[path] = torch.ones(shape, dtype=leaf_dt, device=device)
        elif rule == "zeros":
            out[path] = torch.zeros(shape, dtype=leaf_dt, device=device)
        elif rule == "A_log":
            u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
            out[path] = torch.log(1 + 15 * u)
        else:  # dt_bias: softplus(dt_bias) = dt, log-uniform in [1e-3, 1e-1]
            u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
            dtv = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            out[path] = dtv + torch.log(-torch.expm1(-dtv))
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """The port's nested tree of a flat dict of paths."""
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def leaf_slices(flat: Dict[str, torch.Tensor]):
    """(name, tensor) of every per-layer slice and whole leaf, named as the
    port names its parameters."""
    for path, t in flat.items():
        if path.startswith("stack/"):
            rest = path[len("stack/"):].replace("/", ".")
            for layer in range(t.shape[0]):
                yield f"layers.{layer}.{rest}", t[layer]
        else:
            yield path.replace("/", "."), t
