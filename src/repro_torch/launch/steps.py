"""The train-step builder, single-device part: the port of
``repro.launch.steps.make_train_step``.  The mesh context, the activation
spec and the prefill/decode builders wait for the multi-GPU slice."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
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
