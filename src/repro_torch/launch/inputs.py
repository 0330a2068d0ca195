"""Stand-ins for every model input on the meta device — shapes and dtypes,
no allocation.  The single-device part of ``repro.launch.inputs``: the
sharded variants (its ``rules`` argument) wait for the multi-GPU slice.

  * train / prefill feed (tokens, labels) / (tokens,);
  * decode feeds ONE new token and a decode state whose KV/SSM caches are
    sized for ``seq_len``;
  * a patch config (the VLM) adds precomputed patch embeddings, a frame
    config (the audio encoder) replaces tokens with precomputed frame
    embeddings (the modality frontends are stubs, as in the reference).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig, ShapeConfig


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_structs(cfg: ArchConfig, shape: ShapeConfig, *, with_labels: bool) -> Dict:
    """The host batch as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict = {}
    if cfg.frontend == "frame":
        out["frame_embeds"] = _struct((B, S, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = _struct((B, S), torch.int32)
    if with_labels:
        out["labels"] = _struct((B, S), torch.int32)
    if cfg.frontend == "patch":
        out["patch_embeds"] = _struct((B, cfg.n_frontend_tokens, cfg.d_model), torch.bfloat16)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Tuple:
    """The non-parameter inputs of this cell's step function, as meta
    tensors, in the step's argument order.

    train:    (batch,)
    prefill:  (batch,)
    decode:   (state, tokens, cache_pos)
    """
    if shape.kind in ("train", "prefill"):
        return (batch_structs(cfg, shape, with_labels=shape.kind == "train"),)
    B, S = shape.global_batch, shape.seq_len
    state = M.init_decode_state(cfg, B, S, device="meta")
    return (state, _struct((B, 1), torch.int32), _struct((), torch.int32))
