"""Assigned architecture configs (public literature) + reduced smoke variants.

Each ``<id>.py`` module exports ``CONFIG: ArchConfig`` with the exact
published numbers from the assignment table.  ``get(name)`` resolves ids,
``reduce_for_smoke(cfg)`` produces a tiny same-family config that runs a
real forward step on CPU.  The port's own copy of ``repro.configs``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

ARCH_IDS: List[str] = [
    "jamba-1.5-large-398b",
    "phi3.5-moe-42b-a6.6b",
    "dbrx-132b",
    "phi-3-vision-4.2b",
    "internlm2-20b",
    "h2o-danube-3-4b",
    "deepseek-coder-33b",
    "command-r-35b",
    "hubert-xlarge",
    "mamba2-130m",
]

_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "dbrx-132b": "dbrx_132b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "internlm2-20b": "internlm2_20b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "command-r-35b": "command_r_35b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-130m": "mamba2_130m",
}


def get(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {name: get(name) for name in ARCH_IDS}


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Same family / layer pattern, toy width — for CPU smoke tests."""
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads) if cfg.n_kv_heads < cfg.n_heads else n_heads
    head_dim = 16
    replace = dict(
        name=cfg.name + "-smoke",
        n_layers=2 * len(cfg.period),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        attn_chunk=32,
        window=16 if cfg.window is not None else None,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 8),
    )
    if cfg.n_experts:
        replace.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.has_ssm:
        replace.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    return dataclasses.replace(cfg, **replace)
