"""A frozen copy of ``src/repro_torch/data/synthetic.py::make_lm_payloads``
(commit 3e2a384): the training cell's dataset, made from the run's seed."""
from __future__ import annotations

from typing import Dict

import numpy as np


def make_lm_payloads(n_samples: int, seq_len: int, vocab: int, seed: int = 0) -> Dict[int, bytes]:
    """``n_samples`` int32 sequences of ``seq_len + 1`` tokens, every odd
    position a copy of its predecessor (structure a model can learn)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(n_samples, seq_len + 1), dtype=np.int32)
    base[:, 1::2] = base[:, 0:-1:2]
    return {i: base[i].tobytes() for i in range(n_samples)}
