"""Faults planted under the timed path, to show that the check catches
them: each is a context manager that patches the port and undoes it."""
from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def state_unchanged():
    """The training step computes its gradients and returns the model and
    optimizer state as they were."""
    import repro_torch.launch.steps as steps

    with mock.patch.object(steps, "adamw_update", lambda params, grads, opt_state, settings: (params, opt_state)):
        yield


@contextlib.contextmanager
def half_batch():
    """The training loss takes the mean over the first half of the batch
    and leaves the rest out."""
    import repro_torch.models.model as M

    loss = M.train_loss

    def half(params, cfg, batch, *args, **kwargs):
        n = batch["tokens"].shape[0] // 2
        return loss(params, cfg, {k: v[:n] for k, v in batch.items()}, *args, **kwargs)

    with mock.patch.object(M, "train_loss", half):
        yield


@contextlib.contextmanager
def token_altered():
    """The prefill's first row serves the token after its best one: its
    last-position logits rolled by one place."""
    import repro_torch.models.model as M

    prefill = M.prefill

    def altered(*args, **kwargs):
        logits, state = prefill(*args, **kwargs)
        logits = logits.clone()
        logits[0] = logits[0].roll(1)
        return logits, state

    with mock.patch.object(M, "prefill", altered):
        yield


@contextlib.contextmanager
def cache_altered():
    """The prefill hands on its caches with the last position of the period
    altered: each of its entries negated in the first period."""
    import repro_torch.models.model as M

    prefill = M.prefill

    def altered(*args, **kwargs):
        logits, (caches, kv_len) = prefill(*args, **kwargs)
        last = max(caches, key=lambda pos: int(pos[len("pos"):]))
        caches = dict(caches, **{last: {name: t.clone() for name, t in caches[last].items()}})
        for t in caches[last].values():
            t[0].neg_()
        return logits, (caches, kv_len)

    with mock.patch.object(M, "prefill", altered):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "token_altered": token_altered,
          "cache_altered": cache_altered}
