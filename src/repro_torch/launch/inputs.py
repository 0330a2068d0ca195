"""Stand-ins for every model input on the meta device — shapes and dtypes,
no allocation — and, given sharding rules, each one's partition spec beside
it.  The port of ``repro.launch.inputs``.

  * train / prefill feed (tokens, labels) / (tokens,);
  * decode feeds ONE new token and a decode state whose KV/SSM caches are
    sized for ``seq_len``;
  * a patch config (the VLM) adds precomputed patch embeddings, a frame
    config (the audio encoder) replaces tokens with precomputed frame
    embeddings (the modality frontends are stubs, as in the reference).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import ShardingRules, input_shardings, state_shardings
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig, ShapeConfig


class Sharded(NamedTuple):
    """A meta stand-in and the partition spec it is laid out by (the
    reference's ``ShapeDtypeStruct`` with its sharding)."""

    struct: torch.Tensor
    spec: tuple


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


def _placed(tree, specs):
    return {k: _placed(v, specs[k]) if isinstance(v, dict) else Sharded(v, specs[k])
            for k, v in tree.items()}


def input_specs(
    cfg: ArchConfig, shape: ShapeConfig, rules: Optional[ShardingRules] = None
) -> Tuple:
    """The non-parameter inputs of this cell's step function, as meta
    tensors, in the step's argument order; with ``rules``, each leaf but
    ``cache_pos`` a ``Sharded`` pair.

    train:    (batch,)
    prefill:  (batch,)
    decode:   (state, tokens, cache_pos)
    """
    if shape.kind in ("train", "prefill"):
        batch = batch_structs(cfg, shape, with_labels=shape.kind == "train")
        if rules is not None:
            batch = _placed(batch, input_shardings(rules, cfg, batch))
        return (batch,)
    B, S = shape.global_batch, shape.seq_len
    state = M.init_decode_state(cfg, B, S, device="meta")
    tokens = _struct((B, 1), torch.int32)
    if rules is not None:
        cspecs, kv_spec = state_shardings(rules, cfg, state)
        state = (_placed(state[0], cspecs), Sharded(state[1], kv_spec))
        tokens = Sharded(tokens, input_shardings(rules, cfg, {"t": tokens})["t"])
    return (state, tokens, _struct((), torch.int32))
