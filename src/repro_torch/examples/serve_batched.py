"""Batched serving with the PyTorch port: a model from seeded random weights
answers a batch of prompts — batched prefill (through the hand kernels on
the card), then per-token greedy decode steps against the KV/SSM cache.  The
twin of ``examples/serve_batched.py``: ``--smoke`` serves what it serves, the
reduced hybrid jamba (Mamba + attention + MoE) in f32, 4 prompts of 32
tokens and 16 new tokens each.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_batched            # danube, full width, on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch phi3.5-moe-42b-a6.6b --layers 24
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.models.model import DecoderLM
from repro_torch.serving import ServeEngine

SMOKE_ARCH = "jamba-1.5-large-398b"  # what examples/serve_batched.py serves
FULL_ARCH = "h2o-danube-3-4b"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=configs.ARCH_IDS,
                    help=f"default: {SMOKE_ARCH} with --smoke, else {FULL_ARCH}")
    ap.add_argument("--smoke", action="store_true", help="reduced width and depth, f32")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (phi3.5-moe fits one card at 24)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch or (SMOKE_ARCH if args.smoke else FULL_ARCH))
    if args.smoke:
        cfg = dataclasses.replace(configs.reduce_for_smoke(cfg), dtype="float32")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
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
        f"{cfg.name} ({cfg.dtype}, {cfg.n_layers} layers) on {where}: prefill "
        f"{result.prefill_s * 1e3:.1f} ms | decode {result.decode_s * 1e3:.1f} ms "
        f"({tps:.1f} tok/s, batch {B})"
    )
    return result


if __name__ == "__main__":
    main()
