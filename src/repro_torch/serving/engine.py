"""Batched serving engine: padded-prompt batched prefill + one-token decode
steps against the model's KV/SSM cache, with per-sequence lengths.  The PyTorch
port of ``repro.serving.engine``.

On the card ``prefill_s`` and ``decode_s`` come from CUDA event pairs on the
stream, read once the tokens are on the host, so they measure the device's
work and ``generate`` waits for the device only where the host needs the
tokens; on the CPU they come from the host clock.  Each call is a
``serve.generate`` span (``obs/spans.py``) holding the prompts' copy to the
device (``serve.prompts_to_device``) and the model's spans.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.obs.spans import span


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
        self.batches = 0  # generate calls so far: each call's batch id

    def _mark(self):
        """A point in the device's work: a timing event recorded on the
        current stream on the card, the host clock on the CPU."""
        if self.device.type != "cuda":
            return time.monotonic()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    @staticmethod
    def _seconds(start, end) -> float:
        """Seconds between two marks; events must have completed."""
        return end - start if isinstance(start, float) else start.elapsed_time(end) / 1e3

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
        self.batches += 1
        with span("serve.generate", batch=self.batches, requests=len(prompts),
                  prompt_tokens=len(prompts) * lens.pop()):
            with span("serve.prompts_to_device"):
                toks = torch.tensor(prompts, dtype=torch.int64, device=self.device)
            B, L = toks.shape
            t0 = self._mark()
            logits, (caches, kv_len) = M.prefill(self.params, self.cfg, {"tokens": toks})
            caches = grow_kv(caches, max_new_tokens)
            state = (caches, kv_len)
            t1 = self._mark()

            gen = torch.Generator(device=self.device).manual_seed(seed)
            out: List[List[int]] = [[] for _ in range(B)]
            current = torch.argmax(logits, -1)[:, None]
            t2 = self._mark()  # marked before each read of the tokens, which waits for it
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
                t2 = self._mark()
                for i, t in enumerate(nxt.tolist()):
                    out[i].append(t)
        return GenerationResult(out, self._seconds(t0, t1), self._seconds(t1, t2))
