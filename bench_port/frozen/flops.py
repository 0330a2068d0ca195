"""Model FLOPs of a step or a prefill, counted from the configuration's
shapes (the ``mfu.*`` numerators).  Recomputed operations are not counted;
embedding lookups, norms and elementwise work are not counted.

* training: 6 × (matmul parameters) × tokens, plus attention's
  12 × hd × visible pairs × heads × layers (forward 4, backward 8), or the
  SSD scan's products three times over;
* prefill: 2 × (matmul parameters of the layers) × tokens, plus
  2 × d_model × vocab for each position the head computes (the last one of
  each prompt), plus attention's 4 × hd × visible pairs × heads × layers,
  or the SSD scan's products at the configuration's chunk.

A configuration is the dict of a ``configs/<name>.json`` file.
"""
from __future__ import annotations

from bench_port.frozen.roofline import ssd_flops, visible_pairs


def layer_matmul_params(cfg: dict) -> int:
    """Weights of one layer that enter a matrix product."""
    d = cfg["d_model"]
    if cfg["family"] == "ssm":
        di = cfg["ssm_expand"] * d
        H = di // cfg["ssm_head_dim"]
        GN = cfg["ssm_groups"] * cfg["ssm_state"]
        return d * (2 * di + 2 * GN + H) + di * d
    hd = cfg["head_dim"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    return d * q + 2 * d * kv + q * d + 3 * d * cfg["d_ff"]


def mixer_flops(cfg: dict, B: int, S: int) -> float:
    """The sequence mixer's own products in one forward over (B, S), all
    layers: attention's 4·hd per visible pair and head, or the SSD scan's."""
    L = cfg["n_layers"]
    if cfg["family"] == "ssm":
        di = cfg["ssm_expand"] * cfg["d_model"]
        P = cfg["ssm_head_dim"]
        return L * ssd_flops(B, S, di // P, P, cfg["ssm_state"], cfg["ssm_chunk"])
    pairs = visible_pairs(S, S, True, cfg.get("window"))
    return L * 4.0 * cfg["head_dim"] * pairs * cfg["n_heads"] * B


def train_flops(cfg: dict, B: int, S: int) -> float:
    """One training step over B sequences of S positions."""
    tokens = B * S
    dense = cfg["n_layers"] * layer_matmul_params(cfg) + cfg["d_model"] * cfg["vocab"]
    return 6.0 * dense * tokens + 3.0 * mixer_flops(cfg, B, S)


def prefill_flops(cfg: dict, B: int, S: int) -> float:
    """One prefill of B prompts of S tokens, the head at the last position."""
    dense = cfg["n_layers"] * layer_matmul_params(cfg)
    return 2.0 * dense * B * S + 2.0 * cfg["d_model"] * cfg["vocab"] * B + mixer_flops(cfg, B, S)
