"""The port's Trainer over its own threaded DELI pipeline — twins of
tests/test_training_loop.py (loss falls, restore resumes exactly, gc keeps
the newest, elastic re-partitioning) — and a lock-step check: the reference
Trainer and the port's, from the same weights over the same DELI batches,
give per-step losses within 2e-3 over 10 steps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.core import PrefetchConfig, RealClock  # noqa: E402
from repro_torch.data import decode_tokens, make_lm_pipeline  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.loop import Trainer, TrainerConfig, elastic_repartition  # noqa: E402
from repro_torch.training.optimizer import OptSettings  # noqa: E402
from repro_torch.weights import opt_state_to_numpy, params_to_numpy  # noqa: E402

pytestmark = pytest.mark.slow  # threaded pipeline on a real clock, like its twin

SEQ, CACHE, BATCH = 64, 128, 4
LM_TEST = dict(name="lm-test", family="dense", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab=512, dtype="float32", attn_chunk=64)
CFG = ArchConfig(**LM_TEST)


def _trainer(ckpt_dir=None, every=5, n_samples=512, params=None):
    loader, service, _ = make_lm_pipeline(
        n_samples=n_samples, seq_len=SEQ, vocab=CFG.vocab, batch_size=BATCH,
        cache_items=CACHE, policy=PrefetchConfig.fifty_fifty(CACHE), clock=RealClock(),
    )
    t = Trainer(
        CFG, loader,
        TrainerConfig(seq_len=SEQ, batch_size=BATCH, checkpoint_dir=ckpt_dir,
                      checkpoint_every=every, log_every=1000),
        decode_fn=decode_tokens,
        settings=OptSettings(lr=3e-3, moment_dtype="float32"),
        params=params,
        device="cpu",
    )
    return t, service


def test_loss_decreases_through_deli_pipeline():
    t, svc = _trainer()
    with svc:
        metrics = t.train(30)
    assert len(metrics) == 30
    first = np.mean([m.loss for m in metrics[:5]])
    last = np.mean([m.loss for m in metrics[-5:]])
    assert last < first, (first, last)
    assert all(np.isfinite(m.loss) for m in metrics)
    assert all(m.compute_s > 0 and m.data_wait_s >= 0 for m in metrics)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_checkpoint_restore_resumes_exactly(tmp_path):
    d = str(tmp_path)
    t1, svc1 = _trainer(ckpt_dir=d, every=5)
    with svc1:
        t1.train(12)
    assert ckpt.latest_step(d) == 10

    t2, svc2 = _trainer(ckpt_dir=d, every=5)
    assert t2.try_restore()
    assert t2.step == 10
    # params match the checkpointed run bit-exactly
    saved = ckpt.restore_checkpoint(d, 10)[0]
    restored = dict(_flat(params_to_numpy(t2.params)))
    assert sorted(saved) == sorted(restored)
    for key, a in saved.items():
        np.testing.assert_array_equal(a.numpy(), restored[key], err_msg=key)
    assert int(t2.opt_state["step"]) == 10
    with svc2:
        t2.train(3)
    assert t2.step == 13


def test_checkpoint_holds_its_step_while_training_goes_on(tmp_path):
    """The checkpoint of step 5 equals the parameters and moments the Trainer
    held at step 5, bit for bit, though its write overlaps steps 6 to 8,
    which update those tensors in place."""
    d = str(tmp_path)
    t, svc = _trainer(ckpt_dir=d, every=5)
    snaps, save = {}, t._ckpt.save

    def snapshot_then_save(step, params, opt_state, **kw):
        snaps[step] = {
            **{f"params/{k}": np.array(v) for k, v in _flat(params_to_numpy(params))},
            **{f"opt/{k}": np.array(v) for k, v in _flat(opt_state_to_numpy(opt_state))},
        }
        save(step, params, opt_state, **kw)

    t._ckpt.save = snapshot_then_save
    with svc:
        t.train(8)
    params, opt, _, _ = ckpt.restore_checkpoint(d, 5)
    saved = {**{f"params/{k}": v for k, v in params.items()}, **{f"opt/{k}": v for k, v in opt.items()}}
    assert sorted(saved) == sorted(snaps[5])
    for key, a in saved.items():
        np.testing.assert_array_equal(a.numpy(), snaps[5][key], err_msg=key)


def test_checkpoint_atomic_and_gc(tmp_path):
    d = str(tmp_path)
    t, svc = _trainer(ckpt_dir=d, every=2)
    t.tcfg = TrainerConfig(seq_len=SEQ, batch_size=BATCH, checkpoint_dir=d,
                           checkpoint_every=2, keep_checkpoints=2, log_every=1000)
    t._ckpt.keep = 2  # the AsyncCheckpointer captured keep at __init__
    with svc:
        t.train(10)
    steps = ckpt.list_steps(d)
    assert len(steps) <= 2 and steps[-1] == 10  # gc keeps the latest


def test_elastic_repartition_halves_partition():
    t, svc = _trainer(n_samples=512)
    with svc:
        t.train(3)
    assert len(t.loader.sampler) == 512
    elastic_repartition(t.loader, new_rank=1, new_world=2)
    assert len(t.loader.sampler) == 256
    assert t.loader.sampler.rank == 1
    with svc:
        t.train(3)  # keeps training on the new partition
    assert t.step == 6


def test_lock_step_with_reference_trainer():
    """Same weights, same DELI batch sequence, same settings: the per-step
    losses of ten steps agree within 2e-3."""
    jax = pytest.importorskip("jax")
    from repro.core import PrefetchConfig as RPrefetch
    from repro.data import make_lm_pipeline as r_make_lm_pipeline
    from repro.models.config import ArchConfig as RArch
    from repro.training.loop import Trainer as RTrainer
    from repro.training.loop import TrainerConfig as RTrainerConfig
    from repro.training.optimizer import OptSettings as ROpt

    with jax.default_device(jax.devices("cpu")[0]):
        loader, service, _ = r_make_lm_pipeline(
            n_samples=512, seq_len=SEQ, vocab=CFG.vocab, batch_size=BATCH,
            cache_items=CACHE, policy=RPrefetch.fifty_fifty(CACHE),
        )
        ref = RTrainer(
            RArch(**LM_TEST), loader,
            RTrainerConfig(seq_len=SEQ, batch_size=BATCH, log_every=1000),
            decode_fn=decode_tokens, settings=ROpt(lr=3e-3, moment_dtype="float32"),
        )
        weights = jax.tree.map(np.asarray, ref.params)
        with service:
            want = [m.loss for m in ref.train(10)]
    port, svc = _trainer(params=weights)
    with svc:
        got = [m.loss for m in port.train(10)]
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
