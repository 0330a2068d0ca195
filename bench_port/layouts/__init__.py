"""A configuration's layer pattern, and the layouts the built-in one does
not know.

Every configuration is a stack of ``n_layers`` layers in repetitions of a
period: position ``i`` of the period has the token mixer ``period[i]``
("attn" or "ssm") and the channel mixer ``mlp_pattern[i]`` ("mlp", "moe"
or "none").  A configuration file without ``period`` is a period of one
position taken from its ``family``: an SSM layer with no channel mixer, or
attention with an MLP.  ``weights.leaves`` draws the parameters of any
such pattern, and ``frozen/flops.py`` counts its products.

A configuration file may name ``"layout": "<module>"``: ``layouts/<module>.py``
in the checkout the configuration was read from then exports
``leaves(cfg)``, ``matmul_params(cfg)`` and ``mixer_flops(cfg, B, S)``,
which replace the built-ins for that configuration.  Such a module may call
the built-ins and add to them, and draws with the built-in rules only.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

from bench_port import harness

COUNTS = ("leaves", "matmul_params", "mixer_flops")


def positions(cfg: dict) -> List[Tuple[str, str]]:
    """(token mixer, channel mixer) of each position of the period."""
    if "period" in cfg:
        return list(zip(cfg["period"], cfg["mlp_pattern"]))
    return [("ssm", "none")] if cfg["family"] == "ssm" else [("attn", "mlp")]


def n_periods(cfg: dict) -> int:
    return cfg["n_layers"] // len(positions(cfg))


@functools.lru_cache(maxsize=None)
def _load(name: str, root: str):
    mod = harness.load_module("layouts", name, root)
    missing = [f for f in COUNTS if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"layout {name!r} does not export {missing}")
    return mod


def find(cfg: dict):
    """The configuration's layout module, or None for the built-in layout."""
    name = cfg.get("layout")
    return None if name is None else _load(name, cfg.get(harness.ROOT_KEY, harness.ROOT))
