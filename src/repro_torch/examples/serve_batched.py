"""Batched serving with the PyTorch port: a dense decoder (h2o-danube-3-4b)
from seeded random weights answers a batch of prompts — batched prefill
through the flash-attention kernel, then per-token greedy decode steps
against the KV cache.  The twin of ``examples/serve_batched.py``, on the
dense config (the reference's jamba needs SSM and MoE, not ported yet).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched            # full width, on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.models.model import DecoderLM
from repro_torch.serving import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="reduced width and depth, f32")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = configs.get("h2o-danube-3-4b")
    if args.smoke:
        cfg = dataclasses.replace(configs.reduce_for_smoke(cfg), dtype="float32")
    model = DecoderLM.from_config(cfg, seed=0, device=args.device)
    engine = ServeEngine(cfg, model, max_len=96, device=model.device)

    B, L = 4, 32
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, L), generator=g).tolist()
    result = engine.generate(prompts, max_new_tokens=16)
    for i, toks in enumerate(result.tokens):
        print(f"seq {i}: +{len(toks)} tokens: {toks}")
    where = (torch.cuda.get_device_name(model.device) if model.device.type == "cuda" else "CPU")
    tps = result.total_new_tokens / max(result.decode_s, 1e-9)
    print(
        f"{cfg.name} ({cfg.dtype}) on {where}: prefill {result.prefill_s * 1e3:.1f} ms | "
        f"decode {result.decode_s * 1e3:.1f} ms ({tps:.1f} tok/s, batch {B})"
    )
    return result


if __name__ == "__main__":
    main()
