"""The port's rules-aware serving steps on (data 2, model 2) against its own
single-process steps.

The reference's rules-aware steps do not run under JAX 0.9 (``decode_step``
with an activation spec raises ``DuplicateSpecError``, model.py:428-429 via
steps.py:150), so the port's are held against the port's single-process
path, which tests/test_torch_steps.py holds against the reference.  One
rank group of four CPU processes (``run_ranks``, gloo over a file store)
runs every case (``_torch_rank_cases.steps_rank``); this process never
joins a process group.

Every step runs tensor-parallel on model (``models/parallel.py``), with
DTensor's ``redistribute`` made to raise in the ranks.  Held: greedy tokens
of reduced phi3.5-moe (batch 2, and batch 1, which divides no data axis),
danube, jamba, danube with grouped kv heads (4 over 2, at batch 2 and 1;
4 over 1, gathered; 3 over 1, which do not split) and danube at a
vocabulary of 511, which does not split over model 2, through
``make_prefill_step`` and ``make_decode_step`` with rules, exactly equal to
the single-process run
(tests/test_serving.py:51's standard), with their logits at 2e-3; each
rank's decode-cache shards shaped as ``state_shardings`` lays them out;
hubert's ``make_encoder_step`` logits at 2e-3; phi-3-vision's prefill
logits on a patch prompt at 2e-3; and ``make_train_step`` with
the rules running, its loss the single process's at 2e-3
(tests/test_torch_sharded_train.py holds the sharded step in full); and
the widths each rank's layers compute on (H/2 query heads, H_ssm/2 SSD
heads, d_ff/2, V/2 head columns and embedding rows).  The MoE
configs run at a capacity that drops no token
(``_torch_rank_cases.NO_DROP_CAPACITY``): a data shard's capacity is that of
its own tokens, the single process's that of the global batch.

    PYTHONPATH=src python -m pytest -q tests/test_torch_steps_rules.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_rank_cases as C  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed.ranks import run_ranks  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_encoder_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models.model import DecoderLM  # noqa: E402
from repro_torch.serving.engine import grow_kv  # noqa: E402
from repro_torch.training.optimizer import OptSettings, adamw_init  # noqa: E402

pytestmark = pytest.mark.slow  # starts a group of four processes

TOL = 2e-3
CASE_IDS = [f"{a}-B{b}" for a, b in C.SERVE_CASES]


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(C.steps_rank, 4, env={"JAX_PLATFORMS": "cpu"})


def _single(arch, B):
    cfg = C.serve_cfg(tconfigs, arch)
    model = DecoderLM.from_config(cfg, seed=C.SEED, device="cpu")
    prompt = torch.from_numpy(C.serve_prompt(cfg, B))
    toks, logits, _ = C.greedy(make_prefill_step(cfg), make_decode_step(cfg), model, prompt,
                               C.SERVE_NEW, lambda t: t, lambda st, n: (grow_kv(st[0], n), st[1]))
    return toks.numpy(), logits.numpy()


@pytest.mark.parametrize("arch,B", C.SERVE_CASES, ids=CASE_IDS)
def test_greedy_tokens_equal_single_process(ranks, arch, B):
    want_toks, want_logits = _single(arch, B)
    key = f"{arch}|{B}"
    for r in ranks:
        np.testing.assert_array_equal(r[f"{key}|tokens"], want_toks)
        np.testing.assert_allclose(r[f"{key}|logits"], want_logits, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,B", C.SERVE_CASES, ids=CASE_IDS)
def test_decode_state_follows_state_shardings(ranks, arch, B):
    key = f"{arch}|{B}|layout|"
    for r in ranks:
        held = {k: r[k] for k in r if k.startswith(key)}
        assert f"{key}kv_len" in held and len(held) > 1
        for k, ok in held.items():
            assert ok.all(), k


def test_encoder_logits_match_single_process(ranks):
    cfg = C.case_cfg(tconfigs, C.HUBERT)
    model = DecoderLM.from_config(cfg, seed=C.SEED, device="cpu")
    want = make_encoder_step(cfg)(model, {"frame_embeds": torch.from_numpy(C.encode_frames(cfg))})
    for r in ranks:
        np.testing.assert_allclose(r[f"{C.HUBERT}|logits"], want.numpy(), atol=TOL, rtol=TOL)


def test_patch_prompt_logits_match_single_process(ranks):
    """phi-3-vision's prefill on a prompt whose first positions are patch
    embeddings: the patches replace those positions after the ranks' V/2
    lookups are summed, so the logits are the single process's (2e-3)."""
    cfg = C.case_cfg(tconfigs, C.VLM)
    assert cfg.frontend == "patch" and cfg.vocab % 2 == 0
    model = DecoderLM.from_config(cfg, seed=C.SEED, device="cpu")
    want, _ = make_prefill_step(cfg)(model, {k: torch.from_numpy(v) for k, v in C.patch_prompt(cfg).items()})
    for r in ranks:
        np.testing.assert_allclose(r[f"{C.VLM}|logits"], want.numpy(), atol=TOL, rtol=TOL)


def _want_widths(cfg, m=2):
    """The widths a rank's layers compute on, on a model axis of ``m``: H/m
    query heads, H_ssm/m SSD heads, d_ff/m, and V/m head columns and
    embedding rows where the axis divides them, all of them where it does
    not."""
    def part(n):
        return n // m if n % m == 0 else n

    return {"attn_heads": [part(cfg.n_heads)] if "attn" in cfg.period else [],
            "ssd_heads": [part(cfg.ssm_heads)] if "ssm" in cfg.period else [],
            "mlp_hidden": [part(cfg.d_ff)] if "mlp" in cfg.mlp_pattern else [],
            "head_cols": [part(cfg.vocab)],
            "embed_rows": [part(cfg.vocab)] if cfg.frontend != "frame" else []}


WIDTH_CASES = [(f"{a}|{b}", C.serve_cfg(tconfigs, a)) for a, b in C.SERVE_CASES] + [
    (C.HUBERT, C.case_cfg(tconfigs, C.HUBERT)), (C.VLM, C.case_cfg(tconfigs, C.VLM)),
    ("train", C.serve_cfg(tconfigs, C.PHI))]


@pytest.mark.parametrize("key,cfg", WIDTH_CASES, ids=[k.replace("|", "-B") for k, _ in WIDTH_CASES])
def test_layers_compute_on_this_ranks_share(ranks, key, cfg):
    """Tensor-parallel on model 2: each rank's attention core sees H/2 query
    heads (3 heads do not split: all 3), its SSD scan H_ssm/2 heads, its
    dense MLP a hidden width of d_ff/2, and its head product and embedding
    lookup V/2 of the vocabulary (511 does not split: all of it), in
    prefill, decode, encode and training."""
    want = _want_widths(cfg)
    assert cfg.n_heads != 3 or want["attn_heads"] == [3]
    assert cfg.vocab != 511 or want["head_cols"] == [511]
    for r in ranks:
        for kind, widths in want.items():
            assert r[f"{key}|seen|{kind}"].tolist() == widths, kind


def test_steps_never_redistribute(ranks):
    """Every case above ran with DTensor's ``redistribute`` made to raise in
    the ranks (``_torch_rank_cases.no_redistribution``)."""
    for r in ranks:
        assert bool(r["redistribute_refused"])


def test_train_step_with_rules_raises(ranks):
    """The name is kept from when the sharded step raised; it now runs, and
    its loss is the single-process step's."""
    cfg = C.serve_cfg(tconfigs, C.PHI)
    model = DecoderLM.from_config(cfg, seed=C.SEED, device="cpu", trainable=True)
    batch = {k: torch.from_numpy(v).long() for k, v in C.train_batch(cfg, 2).items()}
    want, _, _ = make_train_step(cfg, OptSettings())(model, adamw_init(model, OptSettings()), batch)
    for r in ranks:
        assert np.isfinite(r["train_loss"])
        np.testing.assert_allclose(r["train_loss"], want.numpy(), atol=TOL, rtol=TOL)
