"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
with ALL training data served through the port's DELI pipeline (simulated
cloud bucket + capped cache + async pre-fetch, 50/50 policy), with
step-atomic checkpointing.  The loss must fall.  The port of
``examples/train_lm_e2e.py``, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e [--steps 300]

The model is a 12-layer / d=768 GQA transformer (~103M params with its
8k vocab) — trained in float32.
"""
import argparse
import tempfile

from repro_torch.core import PrefetchConfig
from repro_torch.data import decode_tokens, make_lm_pipeline
from repro_torch.models.config import ArchConfig
from repro_torch.training.loop import Trainer, TrainerConfig
from repro_torch.training.optimizer import OptSettings

SEQ = 256
CACHE = 512


def make_model() -> ArchConfig:
    return ArchConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=8192, dtype="float32", attn_chunk=256,
    )


def main(argv=None) -> dict:
    """Runs the example; returns its totals (first and last 20-step mean
    loss, steps, data-wait and compute seconds)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = make_model()
    print(f"model: {cfg.name}, {cfg.param_count()/1e6:.1f}M params")
    loader, service, _ = make_lm_pipeline(
        n_samples=8192, seq_len=SEQ, vocab=cfg.vocab, batch_size=args.batch,
        cache_items=CACHE, policy=PrefetchConfig.fifty_fifty(CACHE),
    )
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="deli_ckpt_")
    trainer = Trainer(
        cfg,
        loader,
        TrainerConfig(
            seq_len=SEQ, batch_size=args.batch, checkpoint_dir=ckpt_dir,
            checkpoint_every=100, log_every=20,
        ),
        decode_fn=decode_tokens,
        settings=OptSettings(lr=3e-4, moment_dtype="float32"),
        device=args.device,
    )
    with service:
        metrics = trainer.train(args.steps)
    first = sum(m.loss for m in metrics[:20]) / 20
    last = sum(m.loss for m in metrics[-20:]) / 20
    wait = sum(m.data_wait_s for m in metrics)
    comp = sum(m.compute_s for m in metrics)
    print(
        f"\nloss {first:.3f} -> {last:.3f} over {len(metrics)} steps | "
        f"total data-wait {wait:.2f}s vs compute {comp:.1f}s "
        f"({wait/(wait+comp):.1%} of step time) | checkpoints in {ckpt_dir}"
    )
    assert last < first, "loss did not decrease"
    return dict(first_loss=first, last_loss=last, steps=len(metrics),
                data_wait_s=wait, compute_s=comp)


if __name__ == "__main__":
    main()
