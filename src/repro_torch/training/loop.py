"""The training loop: DELI data plane -> device tensors -> train step, with
the paper's data-wait accounting at STEP granularity, step-atomic async
checkpointing, restart recovery, and elastic re-partitioning.  The port of
``repro.training.loop``.

The loader's miss/wait metrics decide whether the input pipeline (not the
card) is the bottleneck, exactly the measurement DELI §V makes — per
training step, because a job wants to see data-wait within the step budget,
not after an epoch is lost.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.loader import Batch, DeliLoader
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import DecoderLM, resolve_device
from repro_torch.obs.spans import span
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import OptSettings, adamw_init
from repro_torch.weights import params_from_reference


@dataclasses.dataclass
class StepMetrics:
    step: int
    loss: float
    data_wait_s: float
    compute_s: float
    hits: int
    misses: int

    @property
    def wait_fraction(self) -> float:
        tot = self.data_wait_s + self.compute_s
        return self.data_wait_s / tot if tot else 0.0


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int
    batch_size: int  # per-host samples per step
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    log_every: int = 10


class Trainer:
    """Single-device driver: the DELI loader feeds ``make_train_step`` on
    ``device`` (the card unless the caller asks for the CPU).

    ``params``, a reference-layout tree of numpy arrays (what
    ``jax.tree.map(np.asarray, params)`` gives), starts training from those
    weights; by default they are drawn from ``seed``."""

    def __init__(
        self,
        cfg: ArchConfig,
        loader: DeliLoader,
        tcfg: TrainerConfig,
        decode_fn: Callable[[bytes], np.ndarray],
        settings: Optional[OptSettings] = None,
        seed: int = 0,
        params: Optional[Dict] = None,
        device=None,
    ):
        self.cfg = cfg
        self.loader = loader
        self.tcfg = tcfg
        self.decode_fn = decode_fn
        self.device = resolve_device(device)
        self.settings = settings or OptSettings.auto(cfg.param_count())
        if params is None:
            self.params = DecoderLM.from_config(cfg, seed, self.device, trainable=True)
        else:
            self.params = params_from_reference(params, cfg, self.device, trainable=True)
        self.opt_state = adamw_init(self.params, self.settings)
        self.step = 0
        self.metrics: List[StepMetrics] = []
        self._step_fn = make_train_step(cfg, self.settings)
        self._ckpt = (
            ckpt.AsyncCheckpointer(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
            if tcfg.checkpoint_dir
            else None
        )

    # -- data ----------------------------------------------------------------
    def _to_device_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        with span("train.batch_to_device"):
            tokens = batch.stacked(self.decode_fn).astype(np.int64)
            tokens = torch.from_numpy(tokens[:, : self.tcfg.seq_len + 1]).to(self.device)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    # -- checkpoint/restore ----------------------------------------------------
    def try_restore(self) -> bool:
        if not self.tcfg.checkpoint_dir:
            return False
        step = ckpt.latest_step(self.tcfg.checkpoint_dir)
        if step is None:
            return False
        _, _, loader_state, extra = ckpt.restore_checkpoint(
            self.tcfg.checkpoint_dir, step, like=(self.params, self.opt_state)
        )
        self.step = int(extra.get("step", step))
        if loader_state:
            self.loader.load_state_dict(loader_state)
        return True

    def _maybe_checkpoint(self):
        if self._ckpt and self.step % self.tcfg.checkpoint_every == 0:
            self._ckpt.save(
                self.step,
                self.params,
                self.opt_state,
                loader_state=self.loader.state_dict(),
                extra={"step": self.step},
            )

    # -- the loop ---------------------------------------------------------------
    def train(self, num_steps: int, epochs: int = 10_000) -> List[StepMetrics]:
        """``num_steps`` steps, each a ``train.step`` span (``obs/spans.py``)
        around the loader's ``next`` (``train.next_batch``), the batch's copy,
        the step and the loss's read (``train.sync``)."""
        target = self.step + num_steps
        epoch = self.loader.state_dict()["epoch"]
        tokens = self.tcfg.batch_size * self.tcfg.seq_len
        while self.step < target and epoch < epochs:
            self.loader.set_epoch(epoch)
            batches = iter(self.loader)
            while self.step < target:
                with span("train.step", step=self.step + 1, tokens=tokens):
                    with span("train.next_batch"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    dev_batch = self._to_device_batch(batch)
                    t0 = time.monotonic()
                    loss, self.params, self.opt_state = self._step_fn(
                        self.params, self.opt_state, dev_batch
                    )
                    with span("train.sync"):
                        loss = loss.item()  # synchronises: includes device compute
                    compute_s = time.monotonic() - t0
                    self.step += 1
                    m = StepMetrics(
                        self.step, loss, batch.data_wait_s, compute_s,
                        batch.hits, batch.misses,
                    )
                    self.metrics.append(m)
                    if self.step % self.tcfg.log_every == 0:
                        print(
                            f"step {self.step} loss {loss:.4f} "
                            f"wait {m.data_wait_s*1e3:.1f}ms ({m.wait_fraction:.0%}) "
                            f"miss {batch.misses}/{batch.hits + batch.misses}"
                        )
                    self._maybe_checkpoint()
            epoch += 1
        if self._ckpt:
            self._ckpt.wait()
        return self.metrics

    # -- paper metrics ------------------------------------------------------------
    def epoch_wait_summary(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for s in self.loader.epoch_history:
            out[s.epoch] = s.data_wait_seconds
        return out


def elastic_repartition(loader: DeliLoader, new_rank: int, new_world: int) -> None:
    """Elastic scaling: re-partition the sample space when the data-parallel
    world changes (nodes joined/left).  The cache is preserved — entries are
    keyed by dataset index, so samples that stay on this node keep hitting;
    the prefetcher simply starts announcing the new partition."""
    from repro_torch.core.sampler import DistributedPartitionSampler

    old = loader.sampler
    loader.sampler = DistributedPartitionSampler(
        n_samples=old.n_samples,
        rank=new_rank,
        world=new_world,
        seed=getattr(old, "seed", 0),
    )
    loader.sampler.set_epoch(loader.state_dict()["epoch"])
    loader._resume_cursor = 0  # partition changed: restart the epoch slice
