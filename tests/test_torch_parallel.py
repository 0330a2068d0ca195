"""The uneven head split of ``models/parallel.py``: each rank's heads under
``head_range`` and their runs under ``head_runs``, and the attention core
run once a run (``layers._by_runs``) against the reference's attention over
every head, sliced to the rank's.

The partition is pure Python, held for deepseek-coder-33b's 56 query heads
over 8 kv heads on 16 and on 3 ranks and for a sweep of head counts, kv
groups and model sizes: every head covered exactly once, ⌈H/m⌉ heads on
the first H mod m ranks and ⌊H/m⌋ on the others, at most three runs a
rank, and each run's kv heads those ``h // (H/KV)`` gives.  The core by
runs is held against the reference's Pallas flash kernel (interpret mode,
as tests/test_kernels.py runs it on the CPU), chunked and plain attention
at the reference's f32 attention tolerance (2e-5).

    PYTHONPATH=src python -m pytest -q tests/test_torch_parallel.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.parallel import (  # noqa: E402
    attn_even, attn_split, head_range, head_runs, kv_heads_read, kv_split,
)

DEEPSEEK = "deepseek-coder-33b"
# (H, KV, m): deepseek on 16 and 3, danube's even split, the rank-test
# variants on model 2, and a sweep of uneven splits and group sizes
PARTITIONS = [(56, 8, 16), (56, 8, 3), (32, 8, 16), (3, 1, 2), (6, 3, 2), (4, 2, 2), (4, 1, 2),
              (48, 8, 5), (48, 8, 7), (9, 3, 2), (7, 7, 7), (7, 1, 7), (21, 3, 4), (64, 8, 48),
              (16, 16, 3), (56, 8, 56)]


def _cfg(H, KV):
    return dataclasses.replace(tconfigs.get(DEEPSEEK), n_heads=H, n_kv_heads=KV)


@pytest.mark.parametrize("H,KV,m", PARTITIONS, ids=[f"{h}x{kv}-m{m}" for h, kv, m in PARTITIONS])
def test_every_head_on_one_rank_in_runs_of_one_mapping(H, KV, m):
    cfg, G = _cfg(H, KV), H // KV
    assert attn_split(cfg, m)
    seen = []
    for r in range(m):
        h0, h1 = head_range(H, m, r)
        assert h1 - h0 == (-(-H // m) if r < H % m else H // m)
        seen += range(h0, h1)
        runs = head_runs(cfg, h0, h1)
        assert 1 <= len(runs) <= 3
        assert [lo for lo, _ in runs] == [h0] + [hi for _, hi in runs[:-1]] and runs[-1][1] == h1
        for lo, hi in runs:
            c0, c1 = kv_heads_read(cfg, lo, hi)
            assert list(range(c0, c1)) == sorted({h // G for h in range(lo, hi)})
            # one mapping: each kv head read by as many of the run's heads (flash's H % KV)
            assert (hi - lo) % (c1 - c0) == 0
            group = (hi - lo) // (c1 - c0)
            assert all((h - lo) // group + c0 == h // G for h in range(lo, hi))
            assert c1 - c0 == 1 or (lo % G == 0 and hi % G == 0)
    assert seen == list(range(H))
    if attn_even(cfg, m):
        assert all(len(head_runs(cfg, *head_range(H, m, r))) == 1 for r in range(m))


def test_deepseek_splits_unevenly_on_16_and_3():
    """56 heads: 4 on ranks 0-7 and 3 on ranks 8-15 (at most 2 runs a rank);
    19 / 19 / 18 on three ranks, in 2 / 3 / 2 runs.  No attention leaf
    keeps its model shard (the split is not even)."""
    cfg = tconfigs.get(DEEPSEEK)
    ranges = [head_range(cfg.n_heads, 16, r) for r in range(16)]
    assert [h1 - h0 for h0, h1 in ranges] == [4] * 8 + [3] * 8
    assert max(len(head_runs(cfg, *hr)) for hr in ranges) == 2
    ranges = [head_range(cfg.n_heads, 3, r) for r in range(3)]
    assert ranges == [(0, 19), (19, 38), (38, 56)]
    assert [head_runs(cfg, *hr) for hr in ranges] == [
        [(0, 14), (14, 19)], [(19, 21), (21, 35), (35, 38)], [(38, 42), (42, 56)]]
    for m in (3, 16):
        assert attn_split(cfg, m) and not attn_even(cfg, m) and not kv_split(cfg, m)
    assert not attn_split(cfg, 57) and not attn_split(cfg, 1)


B, S, HD, WINDOW = 1, 80, 16, 48
CORES = ["flash", "chunked", "plain"]
RANKS = [(m, r) for m in (3, 16) for r in range(m) if m == 3 or r in (0, 1, 8, 11)]


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(22)
    cfg = tconfigs.get(DEEPSEEK)
    return [rng.standard_normal((B, S, n, HD)).astype(np.float32)
            for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]


@pytest.fixture(scope="module")
def reference(qkv):
    """The reference's attention over all 56 heads, by core."""
    q, k, v = map(jnp.asarray, qkv)
    mask = RL.AttnMask(causal=True, window=WINDOW)
    return {"flash": np.asarray(rops.flash_attention(q, k, v, causal=True, window=WINDOW, block_q=32,
                                                      block_k=32, interpret=True)),
            "chunked": np.asarray(RL.chunked_attention(q, k, v, mask, chunk=32)),
            "plain": np.asarray(RL.plain_attention(q, k, v, mask))}


@pytest.mark.slow
@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("m,r", RANKS, ids=[f"m{m}-rank{r}" for m, r in RANKS])
@pytest.mark.parametrize("held", ["every_kv", "own_kv"])
def test_core_by_runs_matches_reference_on_a_ranks_heads(qkv, reference, core, m, r, held):
    """A rank's query heads through the core once a run, on views of q and
    of K/V holding every kv head (the prefill's cache) or only the kv heads
    the rank reads, against the reference's output for those heads (2e-5;
    on the CPU the flash entry point is its plain version, which
    tests/test_torch_kernels.py holds against the kernel on a card)."""
    from repro_torch.kernels import ops

    cfg = tconfigs.get(DEEPSEEK)
    h0, h1 = head_range(cfg.n_heads, m, r)
    k0, k1 = kv_heads_read(cfg, h0, h1)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    if held == "own_kv":
        k, v = k[:, :, k0:k1].clone(), v[:, :, k0:k1].clone()
    mask = TL.AttnMask(causal=True, window=WINDOW)
    fn = {"flash": lambda q, k, v: ops.flash_attention(q, k, v, causal=True, window=WINDOW),
          "chunked": lambda q, k, v: TL.chunked_attention(q, k, v, mask, chunk=32),
          "plain": lambda q, k, v: TL.plain_attention(q, k, v, mask)}[core]
    calls = []

    def spy(q_run, k_run, v_run):
        calls.append((q_run.shape[2], k_run.shape[2]))
        for run, whole in ((q_run, q), (k_run, k), (v_run, v)):  # views, never copies
            assert run.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
        return fn(q_run, k_run, v_run)

    got = TL._by_runs(spy, q[:, :, h0:h1], k, v, cfg, h0, h1, k0)
    runs = head_runs(cfg, h0, h1)
    assert calls == [(hi - lo, kv_heads_read(cfg, lo, hi)[1] - kv_heads_read(cfg, lo, hi)[0])
                     for lo, hi in runs]
    np.testing.assert_allclose(got.numpy(), reference[core][:, :, h0:h1], atol=2e-5, rtol=2e-5)
