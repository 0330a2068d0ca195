"""Model FLOPs of a step or a prefill, counted from the configuration's
shapes (the ``mfu.*`` numerators).  Recomputed operations are not counted;
embedding lookups, norms and elementwise work are not counted.

* training: 6 × (matmul parameters) × tokens, plus attention's
  12 × hd × visible pairs × heads for each attention layer (forward 4,
  backward 8), and the SSD scan's products three times over for each SSM
  layer;
* prefill: 2 × (matmul parameters of the layers) × tokens, plus
  2 × d_model × vocab for each position the head computes (the last one of
  each prompt), plus attention's 4 × hd × visible pairs × heads, or the SSD
  scan's products at the configuration's chunk, for each layer.

The layers are counted position by position of the period
(``layouts.positions``); a configuration that names a ``layout`` module
takes ``matmul_params`` and ``mixer_flops`` from it.  A configuration is
the dict of a ``configs/<name>.json`` file.
"""
from __future__ import annotations

from bench_port import layouts
from bench_port.frozen.roofline import ssd_flops, visible_pairs


def _ssm_sizes(cfg: dict):
    """(d_inner, heads, G·N) of an SSM layer."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    return di, di // cfg["ssm_head_dim"], cfg["ssm_groups"] * cfg["ssm_state"]


def _heads(cfg: dict):
    """(query heads, kv heads, head width) of an attention layer."""
    H = cfg["n_heads"]
    return H, cfg.get("n_kv_heads") or H, cfg.get("head_dim") or cfg["d_model"] // H


def mixer_params(cfg: dict, kind: str) -> int:
    """Weights of one token mixer that enter a matrix product."""
    d = cfg["d_model"]
    if kind == "ssm":
        di, H, GN = _ssm_sizes(cfg)
        return d * (2 * di + 2 * GN + H) + di * d
    H, KV, hd = _heads(cfg)
    return 2 * d * H * hd + 2 * d * KV * hd


def channel_params(cfg: dict, kind: str) -> int:
    """Weights of one channel mixer that a token's products use: a dense
    MLP's 3 matrices (2 unless SwiGLU); an MoE's router and its ``top_k``
    experts; nothing for "none"."""
    if kind == "none":
        return 0
    mlp = (3 if cfg.get("mlp_act", "swiglu") == "swiglu" else 2) * cfg["d_model"] * cfg["d_ff"]
    return mlp if kind == "mlp" else cfg["d_model"] * cfg["n_experts"] + cfg["top_k"] * mlp


def matmul_params(cfg: dict) -> int:
    """Weights of the whole layer stack that a token's products use."""
    per_period = sum(mixer_params(cfg, m) + channel_params(cfg, c) for m, c in layouts.positions(cfg))
    return layouts.n_periods(cfg) * per_period


def mixer_flops(cfg: dict, B: int, S: int) -> float:
    """The sequence mixers' own products in one forward over (B, S), all
    layers: attention's 4·hd per visible pair and head, or the SSD scan's."""
    total = 0.0
    for kind, _ in layouts.positions(cfg):
        if kind == "ssm":
            _, H, _ = _ssm_sizes(cfg)
            total += ssd_flops(B, S, H, cfg["ssm_head_dim"], cfg["ssm_state"], cfg["ssm_chunk"])
        else:
            H, _, hd = _heads(cfg)
            pairs = visible_pairs(S, S, cfg.get("causal", True), cfg.get("window"))
            total += 4.0 * hd * pairs * H * B
    return layouts.n_periods(cfg) * total


def _counts(cfg: dict):
    """(matmul parameters, mixer FLOPs over (B, S)) of the configuration's layout."""
    layout = layouts.find(cfg)
    if layout is None:
        return matmul_params, mixer_flops
    return layout.matmul_params, layout.mixer_flops


def train_flops(cfg: dict, B: int, S: int) -> float:
    """One training step over B sequences of S positions."""
    params, mixer = _counts(cfg)
    dense = params(cfg) + cfg["d_model"] * cfg["vocab"]
    return 6.0 * dense * B * S + 3.0 * mixer(cfg, B, S)


def prefill_flops(cfg: dict, B: int, S: int) -> float:
    """One prefill of B prompts of S tokens, the head at the last position."""
    params, mixer = _counts(cfg)
    return 2.0 * params(cfg) * B * S + 2.0 * cfg["d_model"] * cfg["vocab"] * B + mixer(cfg, B, S)
