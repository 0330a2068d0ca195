"""Fault tolerance with the PyTorch port: preempt a training run mid-epoch,
restart from the latest step-atomic checkpoint (params + optimizer +
data-plane cursor), and elastically re-partition when the world size
changes.  The twin of ``examples/fault_tolerance.py``: lm-tiny in f32, fed by
the port's DELI pipeline, a checkpoint every 10 steps.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance                 # on the card
    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.core import PrefetchConfig
from repro_torch.data import decode_tokens, make_lm_pipeline
from repro_torch.models.config import ArchConfig
from repro_torch.training.loop import Trainer, TrainerConfig, elastic_repartition
from repro_torch.training.optimizer import OptSettings

SEQ, CACHE, BATCH, N_SAMPLES = 128, 256, 8, 2048
CFG = ArchConfig(
    name="lm-tiny", family="dense", n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab=2048, dtype="float32", attn_chunk=128,
)


def make_trainer(ckpt_dir: str, device, rank: int = 0, world: int = 1):
    loader, service, _ = make_lm_pipeline(
        n_samples=N_SAMPLES, seq_len=SEQ, vocab=CFG.vocab, batch_size=BATCH,
        cache_items=CACHE, policy=PrefetchConfig.fifty_fifty(CACHE),
        rank=rank, world=world,
    )
    t = Trainer(
        CFG, loader,
        TrainerConfig(seq_len=SEQ, batch_size=BATCH, checkpoint_dir=ckpt_dir,
                      checkpoint_every=10, log_every=50),
        decode_fn=decode_tokens,
        settings=OptSettings(lr=1e-3, moment_dtype="float32"),
        device=device,
    )
    return t, service


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="deli_ft_")

    # --- run 1: train 25 steps, then 'die' (process exits mid-epoch) --------
    t1, svc1 = make_trainer(ckpt, args.device)
    with svc1:
        t1.train(25)
    print(f"run 1 stopped at step {t1.step} (simulated preemption)")

    # --- run 2: a fresh trainer restores params+opt+loader cursor -----------
    t2, svc2 = make_trainer(ckpt, args.device)
    restored = t2.try_restore()
    restored_step = t2.step
    print(f"run 2 restored={restored} at step {t2.step} "
          f"(loader cursor {t2.loader.state_dict()})")
    assert restored and t2.step >= 20  # latest checkpoint at step 20
    with svc2:
        t2.train(15)
    print(f"run 2 advanced to step {t2.step}")

    # --- elastic: the cluster shrinks to world=2, this node becomes rank 0 --
    elastic_repartition(t2.loader, new_rank=0, new_world=2)
    partition = len(t2.loader.sampler)
    print(f"elastic re-partition: node now owns {partition} samples (was {N_SAMPLES})")
    assert partition == N_SAMPLES // 2
    print("OK: preempt -> restore -> elastic resize all succeeded")
    return dict(run1_step=t1.step, restored=restored, restored_step=restored_step,
                run2_step=t2.step, partition=partition, device=str(t2.device))


if __name__ == "__main__":
    main()
