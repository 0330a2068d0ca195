"""Granite 4.0-H's pieces in the port, on the CPU: the dropless MoE block
against the oracle ``moe_reference`` (also where capacity would drop
tokens), the shared expert counted once, the MoE spans and their counts,
and a toy Granite model (Mamba-2 and attention without rotary, every
channel mixer an MoE with a shared expert, every multiplier other than 1)
through prefill and greedy decode against the benchmark's plain reference
``GraniteHybridRef``; each multiplier and the softmax scale moves the
output, so none is silently ignored.

Tolerances: the block at 1e-5 in f32 (as ``test_torch_moe.py``); the
model in f32 at 1e-4 of the reference's norm, which differs from the port
only in the order of its sums."""
import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # the benchmark's reference, at the repository's root
    sys.path.insert(0, ROOT)

from bench_port import harness, weights  # noqa: E402
from bench_port.reference.granite_hybrid import GraniteHybridRef  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.serving.engine import grow_kv  # noqa: E402

BLOCK_TOL = 1e-5
MODEL_TOL = 1e-4
BLOCK = ArchConfig(name="moe-block", family="moe", n_layers=1, d_model=32, n_heads=4, d_ff=48, vocab=64,
                   n_experts=6, top_k=2, mlp_pattern=("moe",), dtype="float32", moe_dropless=True)
TOY = dict(name="toy-granite", family="hybrid", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
           d_ff=32, vocab=256, window=None, rope_theta=10000.0, n_experts=6, top_k=3, moe_dropless=True,
           shared_intermediate_size=48, period=["ssm", "ssm", "attn", "ssm"], mlp_pattern=["moe"] * 4,
           mlp_act="swiglu", ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_groups=1, ssm_conv=4, ssm_chunk=16,
           norm_eps=1e-5, tie_embeddings=True, position_embedding_type="nope", attention_multiplier=0.05,
           embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0, dtype="float32",
           layout="granite_hybrid", reference="granite_hybrid", reference_class="GraniteHybridRef")
SEED = 2**31 + 77


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def block_params(cfg: ArchConfig, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {name: torch.randn(shape, generator=g) * shape[-2] ** -0.5
            for name, shape in MoE.moe_param_shapes(cfg).items()}


def skewed(x: torch.Tensor, params: dict) -> None:
    """Every token's largest router logit on expert 0: one input feature
    lifted and the router's column 0 reading it strongly."""
    x[..., 0] = 3.0
    params["router"][0, 0] = 10.0


@pytest.mark.parametrize("skew", [False, True, "idle"], ids=["uniform", "skewed", "idle-expert"])
def test_dropless_block_is_the_oracle(skew):
    params = block_params(BLOCK, 1)
    x = torch.randn(2, 40, BLOCK.d_model, generator=torch.Generator().manual_seed(2))
    if skew:
        skewed(x, params)
    if skew == "idle":  # and no token chooses expert 5: an expert with no rows
        params["router"][0, 5] = -10.0
        assert 5 not in MoE.router_probs(x.reshape(-1, BLOCK.d_model), params["router"], BLOCK.top_k)[0]
    want = MoE.moe_reference(params, x, BLOCK)
    assert rel(MoE.moe_block(params, x, BLOCK), want) < BLOCK_TOL
    capped = dataclasses.replace(BLOCK, moe_dropless=False)
    if skew:  # capacity 1.25 drops expert 0's late tokens; the dropless path keeps them
        assert rel(MoE.moe_block(params, x, capped), want) > 1e-2
    else:  # a capacity of every token drops none: the capacity path agrees
        roomy = MoE.moe_block(params, x, capped, capacity_factor=BLOCK.n_experts / BLOCK.top_k)
        assert rel(roomy, want) < BLOCK_TOL


@pytest.mark.parametrize("rows", [1, 7, 128])
def test_dropless_rows_rounding_changes_nothing(rows, monkeypatch):
    """Each expert's GEMMs over its rows rounded up to ``ROWS`` write into
    the next experts' rows, which those write again: any rounding gives the
    oracle, the skewed router's long expert 0 and the idle expert included."""
    monkeypatch.setattr(MoE, "ROWS", rows)
    params = block_params(BLOCK, 7)
    x = torch.randn(2, 40, BLOCK.d_model, generator=torch.Generator().manual_seed(8))
    skewed(x, params)
    params["router"][0, 5] = -10.0
    assert rel(MoE.moe_block(params, x, BLOCK), MoE.moe_reference(params, x, BLOCK)) < BLOCK_TOL


def test_shared_expert_is_counted_once():
    cfg = dataclasses.replace(BLOCK, shared_intermediate_size=24)
    params = block_params(cfg, 3)
    assert set(params) - set(MoE.moe_param_shapes(BLOCK)) == {"shared_gate", "shared_up", "shared_down"}
    x = torch.randn(3, 17, cfg.d_model, generator=torch.Generator().manual_seed(4))
    flat = x.reshape(-1, cfg.d_model)
    h = torch.nn.functional.silu(flat @ params["shared_gate"]) * (flat @ params["shared_up"])
    want = MoE.moe_reference(params, x, cfg) + (h @ params["shared_down"]).view(x.shape)
    assert rel(MoE.moe_block(params, x, cfg), want) < BLOCK_TOL
    assert cfg.param_count() - BLOCK.param_count() == 3 * cfg.d_model * 24
    assert cfg.active_param_count() - BLOCK.active_param_count() == 3 * cfg.d_model * 24


def test_shared_expert_needs_the_dropless_path():
    with pytest.raises(ValueError, match="dropless"):
        dataclasses.replace(BLOCK, moe_dropless=False, shared_intermediate_size=8)
    with pytest.raises(ValueError, match="position_embedding_type"):
        dataclasses.replace(BLOCK, position_embedding_type="alibi")


def test_dropless_spans_count_every_pair():
    cfg = dataclasses.replace(BLOCK, shared_intermediate_size=16)
    params = block_params(cfg, 5)
    x = torch.randn(2, 30, cfg.d_model, generator=torch.Generator().manual_seed(6))
    skewed(x, params)
    with profile(activities=[ProfilerActivity.CPU]):
        MoE.moe_block(params, x, cfg)
    events = spans.RECORDER.latest()
    kinds = [e.kind for e in events]
    assert kinds == ["model.moe.route", "model.moe.experts", "model.moe.shared"]
    route, experts = events[0], events[1]
    T = x.shape[0] * x.shape[1]
    assert experts.attr("rows") == T * cfg.top_k
    assert route.attr("rows_mean") == T * cfg.top_k / cfg.n_experts
    assert route.attr("rows_max") == T  # every token chose expert 0


def toy_model(cfg: dict):
    flat = weights.make_weights(cfg, SEED, "cpu")
    arch = harness.arch_config(cfg)
    return arch, M.DecoderLM(arch, weights.nest(flat)), GraniteHybridRef(cfg, flat)


def prompts(cfg: dict, B: int = 2, S: int = 40) -> torch.Tensor:
    return torch.randint(0, cfg["vocab"], (B, S), generator=torch.Generator().manual_seed(8))


def test_toy_granite_prefill_and_decode_match_the_reference():
    cfg = dict(TOY)
    arch, model, ref = toy_model(cfg)
    toks = prompts(cfg)
    B, S = toks.shape
    with torch.no_grad():
        logits, (caches, kv_len) = M.prefill(model, arch, {"tokens": toks})
        ref_caches = {}
        want = ref.prefill(toks, lambda l, entries: ref_caches.update({(l, k): t for k, t in entries.items()}))
        assert rel(logits, want) < MODEL_TOL
        n = len(arch.period)
        for (l, name), t in ref_caches.items():
            assert rel(caches[f"pos{l % n}"][name][l // n], t) < MODEL_TOL, (l, name)
        state = (grow_kv(caches, 3), kv_len)
        seq = toks
        steps = []
        for step in range(3):
            nxt = logits.argmax(-1)[:, None]
            seq = torch.cat([seq, nxt], dim=1)
            logits, state = M.decode_step(model, arch, nxt, state, S + step)
            steps.append(logits)
        full = ref.logits(seq, 4)  # the prompt's last position and the three decoded
        for step, got in enumerate(steps):
            assert rel(got, full[:, step + 1]) < MODEL_TOL, step


MOVES = [("embedding_multiplier", 1.0), ("residual_multiplier", 1.0), ("logits_scaling", 1.0),
         ("attention_multiplier", None), ("position_embedding_type", "rope"), ("shared_intermediate_size", 0)]


@pytest.mark.parametrize("field,plain", MOVES, ids=[f for f, _ in MOVES])
def test_each_setting_moves_the_output(field, plain):
    """With ``field`` at its plain value the port's logits move by far more
    than the tolerance, and at either value they are the reference's."""
    toks = prompts(TOY, B=1, S=24)
    out = {}
    for name, cfg in (("granite", dict(TOY)), ("plain", dict(TOY, **{field: plain}))):
        arch, model, ref = toy_model(cfg)
        with torch.no_grad():
            out[name] = M.prefill(model, arch, {"tokens": toks})[0]
            assert rel(out[name], ref.prefill(toks)) < MODEL_TOL
    assert rel(out["plain"], out["granite"]) > 1e-2
