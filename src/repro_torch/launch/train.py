"""Training launcher: ``--arch <id>`` selects any assigned architecture.  The
port of ``repro.launch.train``, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --smoke --steps 30 --device cpu

As in the reference, a config of more than 1e9 parameters is refused without
``--smoke`` (``chip_smoke.py`` trains h2o-danube-3-4b at full width through
``Trainer`` directly).  The process feeds its device from its own DELI
pipeline (rank/world partition the sample space).
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch import configs
from repro_torch.core import PrefetchConfig, RealClock
from repro_torch.data import decode_tokens, make_lm_pipeline
from repro_torch.training.loop import Trainer, TrainerConfig
from repro_torch.training.optimizer import OptSettings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache", type=int, default=256)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.reduce_for_smoke(cfg)
    elif cfg.param_count() > 1e9:
        raise SystemExit(
            f"{args.arch} has {cfg.param_count()/1e9:.0f}B params — full-size "
            "training goes through Trainer on the card (chip_smoke.py); use "
            "--smoke here."
        )
    if cfg.frontend == "frame":
        raise SystemExit("audio encoder training uses precomputed frame "
                         "embeds; see tests/test_arch_smoke.py for the path")
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M")

    loader, service, _ = make_lm_pipeline(
        n_samples=max(1024, args.batch * 64),
        seq_len=args.seq_len,
        vocab=cfg.vocab,
        batch_size=args.batch,
        cache_items=args.cache,
        rank=args.rank,
        world=args.world,
        policy=PrefetchConfig.fifty_fifty(args.cache),
        clock=RealClock(),
    )
    trainer = Trainer(
        cfg,
        loader,
        TrainerConfig(
            seq_len=args.seq_len,
            batch_size=args.batch,
            checkpoint_dir=args.ckpt_dir or tempfile.mkdtemp(prefix="deli_"),
            checkpoint_every=max(10, args.steps // 3),
            log_every=10,
        ),
        decode_fn=decode_tokens,
        settings=OptSettings.auto(cfg.param_count()),
        device=args.device,
    )
    if args.resume and trainer.try_restore():
        print(f"resumed from step {trainer.step}")
    with service:
        metrics = trainer.train(args.steps)
    wait = sum(m.data_wait_s for m in metrics)
    comp = sum(m.compute_s for m in metrics)
    print(
        f"done: step {trainer.step} loss {metrics[-1].loss:.4f} | "
        f"data-wait {wait:.2f}s / compute {comp:.1f}s "
        f"({wait/(wait+comp):.1%} wait fraction)"
    )


if __name__ == "__main__":
    main()
