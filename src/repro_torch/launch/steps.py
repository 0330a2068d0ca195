"""Step-function builders, single-device part: the port of
``repro.launch.steps`` (``make_train_step``, ``make_prefill_step``,
``make_decode_step``, ``make_encoder_step``, ``step_for_cell``).  Each
builder closes over the config and returns a function of the model and
tensors only.  The mesh context, the activation spec, ``auto_microbatches``
and the builders' sharding ``rules`` wait for the multi-GPU slice."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.training.optimizer import OptSettings, adamw_update


def loss_and_grads(
    params: M.DecoderLM,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    remat_policy: str = "minimal",
    microbatches: int = 1,
):
    """``jax.value_and_grad(M.train_loss)`` over the batch: (loss, grads by
    parameter name).  ``microbatches`` > 1 accumulates the gradients in f32
    over slices of the batch and averages them with the losses, as the
    reference's scan does; with one microbatch the gradients stay in the
    parameters' dtype."""
    named = list(params.named_parameters())
    if microbatches == 1:
        loss = M.train_loss(params, cfg, batch, remat_policy)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in named}
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named}
    loss = torch.zeros((), dtype=torch.float32, device=params.device)
    for i in range(microbatches):
        mb = {k: x.chunk(microbatches)[i] for k, x in batch.items()}
        loss_i = M.train_loss(params, cfg, mb, remat_policy)
        loss_i.backward()
        for n, p in named:
            grads[n].add_(p.grad)
            p.grad = None
        loss = loss + loss_i.detach()
    for g in grads.values():
        g.div_(microbatches)
    return loss / microbatches, grads


def make_train_step(
    cfg: ArchConfig,
    settings: OptSettings,
    remat_policy: str = "minimal",
    microbatches: int = 1,
):
    """fwd+bwd+AdamW: ``loss_and_grads`` then ``adamw_update``.  The step
    updates the model and the optimizer state in place and returns
    ``(loss, params, opt_state)``, loss a 0-dim f32 tensor on the model's
    device."""

    def train_step(params: M.DecoderLM, opt_state: Dict, batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(params, cfg, batch, remat_policy, microbatches)
        params, opt_state = adamw_update(params, grads, opt_state, settings)
        for p in params.parameters():
            p.grad = None
        return loss, params, opt_state

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch)`` -> (last-position logits f32 (B, V),
    decode state), ``M.prefill`` without gradients."""

    @torch.no_grad()
    def prefill_step(params: M.DecoderLM, batch: Dict[str, torch.Tensor]):
        return M.prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``serve_step(params, state, tokens, cache_pos)`` -> (logits f32
    (B, V), new state), ``M.decode_step`` without gradients; the caches in
    ``state`` are written in place."""

    @torch.no_grad()
    def serve_step(params: M.DecoderLM, state, tokens: torch.Tensor, cache_pos: int):
        return M.decode_step(params, cfg, tokens, state, cache_pos)

    return serve_step


def make_encoder_step(cfg: ArchConfig):
    """Encoder-only 'prefill': ``encode_step(params, batch)`` -> per-frame
    logits f32 (B, S, V), the full forward without remat and no cache."""

    @torch.no_grad()
    def encode_step(params: M.DecoderLM, batch: Dict[str, torch.Tensor]):
        hidden, _ = M.forward(params, cfg, batch, remat=False)
        return M.lm_head(params, cfg, hidden)

    return encode_step


def step_for_cell(
    cfg: ArchConfig,
    shape: ShapeConfig,
    settings: Optional[OptSettings] = None,
    microbatches: int = 1,
    remat_policy: str = "minimal",
):
    """(step_fn, takes_params_and_opt, microbatches) for one cell.
    ``microbatches`` defaults to what the reference's ``auto_microbatches``
    picks without sharding rules: 1."""
    if shape.kind == "train":
        settings = settings or OptSettings.auto(cfg.param_count())
        step = make_train_step(cfg, settings, remat_policy=remat_policy, microbatches=microbatches)
        return step, True, microbatches
    if shape.kind == "prefill":
        if cfg.is_encoder:
            return make_encoder_step(cfg), False, 1
        return make_prefill_step(cfg), False, 1
    return make_decode_step(cfg), False, 1
