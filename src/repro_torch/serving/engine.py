"""Batched serving engine: padded-prompt batched prefill + one-token decode
steps against the model's KV/SSM cache, with per-sequence lengths.  The PyTorch
port of ``repro.serving.engine``.

On the card the clock is read only after ``torch.cuda.synchronize()``, so
``prefill_s`` and ``decode_s`` measure the device's work and not just the
launches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class GenerationResult:
    tokens: List[List[int]]  # generated ids per sequence
    prefill_s: float
    decode_s: float

    @property
    def total_new_tokens(self) -> int:
        return sum(len(t) for t in self.tokens)


def grow_kv(caches: Dict, grow: int) -> Dict:
    """The prefill caches with ``grow`` more slots on the sequence axis (2)
    of every K and V, so decode steps have slots to write into.  SSM
    positions' ``state`` and ``conv`` have no sequence axis and pass as
    they are."""
    return {
        pos: {
            name: F.pad(t, (0, 0, 0, 0, 0, grow)) if name in ("k", "v") else t
            for name, t in sub.items()
        }
        for pos, sub in caches.items()
    }


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: M.DecoderLM, max_len: int = 512, device=None):
        if cfg.is_encoder:
            raise ValueError("encoder-only models have no decode step")
        self.device = M.resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"parameters are on {params.device}, the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic()

    @torch.inference_mode()
    def generate(
        self,
        prompts: List[List[int]],
        max_new_tokens: int = 16,
        greedy: bool = True,
        seed: int = 0,
    ) -> GenerationResult:
        """Batched greedy/sampled generation (uniform prompt lengths — the
        continuous-batching scheduler that relaxes this is out of scope).
        Sampling draws from a seeded ``torch.Generator``; it cannot match
        the reference's ``jax.random`` stream."""
        lens = {len(p) for p in prompts}
        if len(lens) != 1:
            raise ValueError("ServeEngine.generate requires uniform prompt lengths")
        toks = torch.tensor(prompts, dtype=torch.int64, device=self.device)
        B, L = toks.shape
        t0 = self._clock()
        logits, (caches, kv_len) = M.prefill(self.params, self.cfg, {"tokens": toks})
        caches = grow_kv(caches, max_new_tokens)
        state = (caches, kv_len)
        prefill_s = self._clock() - t0

        gen = torch.Generator(device=self.device).manual_seed(seed)
        out: List[List[int]] = [[] for _ in range(B)]
        t1 = self._clock()
        current = torch.argmax(logits, -1)[:, None]
        for i, t in enumerate(current[:, 0].tolist()):
            out[i].append(t)
        for step in range(max_new_tokens - 1):
            logits, state = M.decode_step(self.params, self.cfg, current, state, L + step)
            if greedy:
                nxt = torch.argmax(logits, -1)
            else:
                probs = torch.softmax(logits, -1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            current = nxt[:, None]
            for i, t in enumerate(nxt.tolist()):
                out[i].append(t)
        decode_s = self._clock() - t1
        return GenerationResult(out, prefill_s, decode_s)
