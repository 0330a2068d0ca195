"""Weights of a configuration, drawn from the run's seed on the run's device.

The layout is the port's parameter tree (``DecoderLM(cfg, tree)`` checks
every leaf's shape and dtype): ``embed`` (none for a ``frame`` frontend),
``head`` (untied only), ``final_norm`` and, for each position ``i`` of the
period (``layouts.positions``), ``stack/pos{i}/...`` leaves with a leading
axis of ``n_layers / len(period)``.  A configuration that names a
``layout`` module takes its leaves from it (``layouts/__init__.py``).
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

from bench_port import layouts

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
RULES = ("dense", "ones", "zeros", "A_log", "dt_bias", "D")
Leaf = Tuple[str, tuple, str]  # (path, shape, rule)


def attention_leaves(cfg: dict) -> List[Leaf]:
    d, H = cfg["d_model"], cfg["n_heads"]
    hd = cfg.get("head_dim") or d // H
    q, kv = H * hd, (cfg.get("n_kv_heads") or H) * hd
    out = [("wq", (d, q), "dense"), ("wk", (d, kv), "dense"), ("wv", (d, kv), "dense"), ("wo", (q, d), "dense")]
    if cfg.get("qkv_bias", False):
        out += [("bq", (q,), "zeros"), ("bk", (kv,), "zeros"), ("bv", (kv,), "zeros")]
    return out


def ssm_leaves(cfg: dict) -> List[Leaf]:
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    H = di // cfg["ssm_head_dim"]
    GN = cfg["ssm_groups"] * cfg["ssm_state"]
    conv = di + 2 * GN
    return [
        ("in_proj", (d, 2 * di + 2 * GN + H), "dense"),
        ("conv_w", (cfg["ssm_conv"], conv), "dense"),
        ("conv_b", (conv,), "zeros"),
        ("A_log", (H,), "A_log"),
        ("D", (H,), "D"),
        ("dt_bias", (H,), "dt_bias"),
        ("gate_norm", (di,), "ones"),
        ("out_proj", (di, d), "dense"),
    ]


def mlp_leaves(cfg: dict) -> List[Leaf]:
    d, f = cfg["d_model"], cfg["d_ff"]
    gate = [("w_gate", (d, f), "dense")] if cfg.get("mlp_act", "swiglu") == "swiglu" else []
    return gate + [("w_up", (d, f), "dense"), ("w_down", (f, d), "dense")]


def moe_leaves(cfg: dict) -> List[Leaf]:
    d, f, E = cfg["d_model"], cfg["d_ff"], cfg["n_experts"]
    up = [("w_up", (E, d, f), "dense")] if cfg.get("mlp_act", "swiglu") == "swiglu" else []
    return [("router", (d, E), "dense"), ("w_gate", (E, d, f), "dense")] + up + [("w_down", (E, f, d), "dense")]


MIXERS = {"attn": attention_leaves, "ssm": ssm_leaves}
CHANNEL_MIXERS = {"mlp": mlp_leaves, "moe": moe_leaves}


def leaves(cfg: dict) -> List[Leaf]:
    """The built-in layout: (path, shape, rule) of every leaf, in the order
    they are drawn; rule is one of ``RULES``."""
    d, V = cfg["d_model"], cfg["vocab"]
    n = layouts.n_periods(cfg)
    out = [] if cfg.get("frontend", "none") == "frame" else [("embed", (V, d), "dense")]
    if not cfg.get("tie_embeddings", False):
        out.append(("head", (d, V), "dense"))
    out.append(("final_norm", (d,), "ones"))
    for i, (mixer, mlp) in enumerate(layouts.positions(cfg)):
        p = f"stack/pos{i}/"
        out.append((p + "norm1", (n, d), "ones"))
        out += [(p + "mixer/" + k, (n, *s), r) for k, s, r in MIXERS[mixer](cfg)]
        if mlp != "none":
            out.append((p + "norm2", (n, d), "ones"))
            out += [(p + "mlp/" + k, (n, *s), r) for k, s, r in CHANNEL_MIXERS[mlp](cfg)]
    return out


F32_LEAVES = ("A_log", "D", "dt_bias")  # an SSM's small leaves stay f32


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flat dict path -> tensor (``nest`` makes the port's tree of it)."""
    dt = _DTYPES[cfg["dtype"]]
    g = torch.Generator(device=device).manual_seed(seed)
    layout = layouts.find(cfg)
    drawn = (layout.leaves if layout else leaves)(cfg)
    unknown = sorted({r for _, _, r in drawn} - set(RULES))
    if unknown:
        raise ValueError(f"unknown rules {unknown}; a layout draws with {RULES}")
    dense = [(p, s) for p, s, r in drawn if r == "dense"]
    flat = torch.randn(sum(math.prod(s) for _, s in dense), generator=g, dtype=dt, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for path, shape in dense:
        n = math.prod(shape)
        out[path] = flat[at : at + n].view(shape).mul_(shape[-2] ** -0.5)
        at += n
    for path, shape, rule in drawn:
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
    """(name, tensor) of every per-period slice and whole leaf, named as
    the port names its parameters (``layers.{p}.pos{i}...``)."""
    for path, t in flat.items():
        if path.startswith("stack/"):
            rest = path[len("stack/"):].replace("/", ".")
            for p in range(t.shape[0]):
                yield f"layers.{p}.{rest}", t[p]
        else:
            yield path.replace("/", "."), t
