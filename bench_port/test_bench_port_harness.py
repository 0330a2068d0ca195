"""The harness on the CPU: discovery by name, a cell and a configuration of
any layer pattern added by files alone, the weights of every configuration
the port runs, the frozen arithmetic against hand-worked numbers, and the
import rule."""
import ast
import dataclasses
import json
import math
import os
import shutil

import pytest

from bench_port import faults, harness, layouts, testing, weights
from bench_port.drivers import prefill, train
from bench_port.frozen import bucket, flops, roofline
from bench_port.reference.common import worst

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
CHECKOUT = ("configs", "traffic", "limits", "metrics", "reference", "layouts")  # what a cell finds by name
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    spec = harness.load_cell(workload)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["kind"] in ("train", "prefill")
    harness.driver(spec)  # the driver module of its kind
    assert harness.reference_class(spec["config"]).__name__ == spec["config"]["reference_class"]
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
    moved = {m["moves"] for m in spec["per_layer"]}
    assert moved <= set(names)


@pytest.mark.parametrize("name", METRICS)
def test_metric_found_by_name(name):
    assert callable(harness.metric(name).read)


def test_cell_added_by_files_alone(tmp_path):
    """A new cell is a traffic file, a limits file and an entry: the
    harness runs it without a change to any file it has."""
    root = tmp_path / "checkout"
    here = root / "bench_port"
    for sub in CHECKOUT:
        shutil.copytree(os.path.join(harness.HERE, sub), here / sub)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="mamba2-130m.prefill.toy", config="mamba2-130m",
                                   traffic="prefill.toy", chips=1, why="a cell added by files alone"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mamba2-130m.prefill.2k" in m.get("workloads", []):
            m["workloads"].append("mamba2-130m.prefill.toy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (here / "traffic" / "prefill.toy.json").write_text(json.dumps(dict(kind="prefill", batch=3, prompt_len=40,
                                                                       max_new_tokens=1, profile_batches=1,
                                                                       handoff_requests=6)))
    shutil.copy(here / "limits" / "mamba2-130m.prefill.2k.json", here / "limits" / "mamba2-130m.prefill.toy.json")
    run = testing.toy_run("mamba2-130m.prefill.toy", root=str(root))
    assert run.requests and run.checks
    line = harness.result(run, False, 1)
    assert {"setup_s", "prefill_tokens_per_s", "ttft_p95_ms"} <= set(line["metrics"])
    assert list(line)[-1] == "checks"


def test_flash_bound_hand_worked():
    # danube 4 x 1024: 4·120·(1024·1025/2)·4·32 FLOPs at 989e12/s = 0.0326 ms
    ms = roofline.flash_bound_s(4, 1024, 1024, 32, 8, 120, "bfloat16", True, 4096) * 1e3
    assert ms == pytest.approx(4 * 120 * 1024 * 1025 / 2 * 4 * 32 / 989e12 * 1e3)
    assert round(ms, 4) == 0.0326


def test_ssd_bound_hand_worked():
    # mamba 8 x 2048 x 24 heads, P 64, N 128, chunk 128: bound by bytes, 0.0349 ms
    ms = roofline.ssd_bound_s(8, 2048, 24, 64, 1, 128, 128, "bfloat16") * 1e3
    nbytes = 2 * (2 * 8 * 2048 * 24 * 64 + 2 * 8 * 2048 * 128) + 4 * (8 * 2048 * 24 + 8 * 24 * 64 * 128 + 48)
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert round(ms, 4) == 0.0349


def test_visible_pairs_window():
    assert roofline.visible_pairs(8, 8, True, None) == 36
    assert roofline.visible_pairs(8, 8, True, 3) == 1 + 2 + 3 * 6
    assert roofline.visible_pairs(4, 6, False, None) == 24


def test_model_flops_hand_worked():
    danube = harness.load_json(os.path.join(harness.HERE, "configs", "h2o-danube-3-4b.json"))
    layer = 2 * 3840 * 3840 + 2 * 3840 * 960 + 3 * 3840 * 10240
    assert flops.matmul_params(danube) == 24 * layer
    pairs = 2048 * 2049 // 2
    want = 6 * (24 * layer + 3840 * 32000) * 4096 + 12 * 24 * 32 * 120 * pairs * 2
    assert flops.train_flops(danube, 2, 2048) == pytest.approx(want)
    assert want == pytest.approx(9.90e13, rel=1e-3)
    mamba = harness.load_json(os.path.join(harness.HERE, "configs", "mamba2-130m.json"))
    assert flops.matmul_params(mamba) == 24 * (768 * (2 * 1536 + 256 + 24) + 1536 * 768)
    scan = 24 * 2 * 256 * (256 * 128 + 256 * 64 + 2 * 128 * 64) * 32 * 24 * 8  # chunk 256
    want = 2 * flops.matmul_params(mamba) * 32 * 2048 + 2 * 768 * 50288 * 32 + scan
    assert flops.prefill_flops(mamba, 32, 2048) == pytest.approx(want)
    # the cells' own sizes: danube's step, mamba's prefill of 128 x 2048, danube's prefill of 4 x 4096
    assert flops.train_flops(danube, 2, 2048) == 98982470615040.0
    assert flops.prefill_flops(mamba, 128, 2048) == 67037146644480.0
    assert flops.prefill_flops(danube, 4, 4096) == 134135831592960.0


PHI35_MOE = dict(family="moe", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=6400,
                 vocab=32064, n_experts=16, top_k=2, window=None, mlp_act="swiglu", period=["attn"],
                 mlp_pattern=["moe"])
JAMBA = dict(family="hybrid", n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128, d_ff=24576,
             vocab=65536, n_experts=16, top_k=2, window=None, mlp_act="swiglu",
             period=["ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"], mlp_pattern=["mlp", "moe"] * 4,
             ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1, ssm_conv=4, ssm_chunk=256)


def test_moe_flops_hand_worked():
    # phi3.5-moe at full size, one step of 1 x 4096: a layer's attention
    # projections, then the router and the top 2 of 16 SwiGLU experts
    layer = 2 * 4096 * 32 * 128 + 2 * 4096 * 8 * 128 + 4096 * 16 + 2 * 3 * 4096 * 6400
    assert layer == 199_294_976
    assert flops.matmul_params(PHI35_MOE) == 32 * layer
    pairs = 4096 * 4097 // 2
    want = 6 * (32 * layer + 4096 * 32064) * 4096 + 3 * 32 * 4 * 128 * pairs * 32
    assert flops.train_flops(PHI35_MOE, 1, 4096) == want
    assert want == pytest.approx(1.7316e14, rel=1e-4)


def test_hybrid_flops_hand_worked():
    # jamba-1.5-large at full size, a prefill of 1 x 8192: 9 periods of 7 SSD
    # layers and 1 attention layer, 4 dense MLPs and 4 MoEs (top 2 of 16)
    ssm = 8192 * (2 * 16384 + 2 * 128 + 256) + 16384 * 8192
    attn = 2 * 8192 * 64 * 128 + 2 * 8192 * 8 * 128
    mlp = 3 * 8192 * 24576
    moe = 8192 * 16 + 2 * mlp
    period = 7 * ssm + attn + 4 * mlp + 4 * moe
    assert period == 10_247_208_960
    assert flops.matmul_params(JAMBA) == 9 * period
    scan = 2 * 256 * (256 * 128 + 256 * 64 + 2 * 128 * 64) * 256 * (8192 // 256)  # B 1, 256 heads, chunk 256
    att = 4 * 128 * (8192 * 8193 // 2) * 64
    assert flops.mixer_flops(JAMBA, 1, 8192) == 9 * (7 * scan + att)
    want = 2 * 9 * period * 8192 + 2 * 8192 * 65536 + 9 * (7 * scan + att)
    assert flops.prefill_flops(JAMBA, 1, 8192) == want
    assert want == pytest.approx(1.5382e15, rel=1e-4)


def test_builtin_leaves_keep_the_cells_order():
    """The cells' configurations draw the leaves they drew before any
    pattern was known, in the same order, so a seed gives the same bits."""
    danube = harness.load_json(os.path.join(harness.HERE, "configs", "h2o-danube-3-4b.json"))
    p = "stack/pos0/"
    L, d, f = 24, 3840, 10240
    assert weights.leaves(danube) == [
        ("embed", (32000, d), "dense"), ("head", (d, 32000), "dense"), ("final_norm", (d,), "ones"),
        (p + "norm1", (L, d), "ones"), (p + "mixer/wq", (L, d, d), "dense"), (p + "mixer/wk", (L, d, 960), "dense"),
        (p + "mixer/wv", (L, d, 960), "dense"), (p + "mixer/wo", (L, d, d), "dense"), (p + "norm2", (L, d), "ones"),
        (p + "mlp/w_gate", (L, d, f), "dense"), (p + "mlp/w_up", (L, d, f), "dense"),
        (p + "mlp/w_down", (L, f, d), "dense")]
    mamba = harness.load_json(os.path.join(harness.HERE, "configs", "mamba2-130m.json"))
    d, conv = 768, 1536 + 256
    assert weights.leaves(mamba) == [
        ("embed", (50288, d), "dense"), ("final_norm", (d,), "ones"), (p + "norm1", (L, d), "ones"),
        (p + "mixer/in_proj", (L, d, 2 * 1536 + 256 + 24), "dense"), (p + "mixer/conv_w", (L, 4, conv), "dense"),
        (p + "mixer/conv_b", (L, conv), "zeros"), (p + "mixer/A_log", (L, 24), "A_log"), (p + "mixer/D", (L, 24), "D"),
        (p + "mixer/dt_bias", (L, 24), "dt_bias"), (p + "mixer/gate_norm", (L, 1536), "ones"),
        (p + "mixer/out_proj", (L, 1536, d), "dense")]


def _port_configs():
    from repro_torch import configs

    return configs.ARCH_IDS


@pytest.mark.parametrize("arch", _port_configs())
def test_weights_build_every_port_configuration(arch):
    """The weights of each configuration the port runs, at its smoke size,
    pass ``DecoderLM``'s check of every leaf's shape and dtype."""
    from repro_torch import configs
    from repro_torch.models.model import DecoderLM

    arch_cfg = configs.reduce_for_smoke(configs.get(arch))
    cfg = dataclasses.asdict(arch_cfg)
    flat = weights.make_weights(cfg, testing.SEED, "cpu")
    model = DecoderLM(arch_cfg, weights.nest(flat))
    names = {n for n, _ in model.named_parameters()}
    assert names == {n for n, _ in weights.leaf_slices(flat)}
    assert flops.train_flops(cfg, 2, 32) > 6 * flops.matmul_params(cfg) * 64 > 0


def test_busy_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 11)]
    assert roofline.union_s(iv) == 3 + 2 + 1
    assert roofline.gaps(iv) == [(3, 5), (7, 10)]


def test_table_one_bucket():
    assert bucket.get_seconds(784) == pytest.approx(784 / 49.80e3)
    assert bucket.sharing_penalty(1) == 1.0
    assert bucket.sharing_penalty(16) == pytest.approx(16 / (281.73 / 49.80))
    assert bucket.sharing_penalty(64) == bucket.sharing_penalty(16)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files(sub=""):
    top = os.path.join(harness.HERE, sub)
    for d, _, names in os.walk(top):
        yield from (os.path.join(d, n) for n in names if n.endswith(".py"))


def test_no_jax_or_reference_package_imported():
    for path in _files():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_no_port():
    allowed = {"torch", "numpy", "math", "typing", "__future__", "bench_port"}
    for path in _files("reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in allowed, (path, name)
            assert not name.startswith("bench_port.") or name.startswith("bench_port.reference"), (path, name)


def test_forbidden_modules_named_whole():
    assert harness.loaded_forbidden(["repro_torch", "repro_torch.models", "torch", "reprox"]) == []
    found = harness.loaded_forbidden(["repro_torch", "repro.core", "jaxlib.xla_client", "flax"])
    assert found == ["flax", "jaxlib", "repro"]


HYBRID = "toy-hybrid.prefill"


@pytest.fixture
def hybrid_checkout(tmp_path):
    """A checkout to which the toy hybrid was added by files alone: its
    configuration, layout module, plain reference, traffic and limits
    (``testdata/hybrid``), one ``configs`` and one ``workloads`` entry, and
    its name appended to the lists of the metrics of a prefill cell."""
    root = tmp_path / "checkout"
    here = root / "bench_port"
    for sub in CHECKOUT:
        shutil.copytree(os.path.join(harness.HERE, sub), here / sub)
    added = os.path.join(harness.HERE, "testdata", "hybrid")
    for sub in os.listdir(added):
        for name in os.listdir(os.path.join(added, sub)):
            assert not (here / sub / name).exists()
            shutil.copy(os.path.join(added, sub, name), here / sub / name)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="toy-hybrid", source="a test configuration",
                                 file="bench_port/configs/toy-hybrid.json", reduced=[], why="every kind of layer"))
    bench["workloads"].append(dict(name=HYBRID, config="toy-hybrid", traffic="prefill.toy-hybrid", chips=1,
                                   why="a configuration of a three-position period added by files alone"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mamba2-130m.prefill.2k" in m.get("workloads", []):
            m["workloads"].append(HYBRID)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def test_hybrid_added_by_files_alone(hybrid_checkout):
    """A period of attention, SSD and MoE layers and one with no channel
    mixer, with a layout module of its own, runs through the prefill
    driver and comes out correct against its plain reference, every
    position's caches compared; its control does not."""
    spec = testing.toy_spec(HYBRID, hybrid_checkout)
    assert [m for m, _ in layouts.positions(spec["config"])] == ["ssm", "attn", "ssm"]
    layout = layouts.find(spec["config"])
    assert layout is not None and layout.__file__.startswith(hybrid_checkout)
    run = testing.toy_run(HYBRID, control=True, root=hybrid_checkout)
    assert layout.CALLED == {"leaves", "matmul_params", "mixer_flops"}
    assert run.requests and run.correct, run.checks
    assert run.readings["control"]["logits_rel"] > run.spec["limits"]["logits_rel"], run.readings
    assert run.batches[0]["flops"] == flops.prefill_flops(spec["config"], 4, 48)
    line = harness.result(run, False, 1)
    assert {"setup_s", "prefill_tokens_per_s", "ttft_p95_ms"} <= set(line["metrics"])


def test_hybrid_caches_compared_at_every_position(hybrid_checkout):
    """The kept batch's caches by absolute layer: the toy hybrid's six
    layers, each with its own kind of cache, all compared."""
    seen = []
    layer_caches = prefill.layer_caches

    def recording(caches, period, r0, r1):
        out = layer_caches(caches, period, r0, r1)
        seen.append(sorted(out))
        return out

    prefill.layer_caches = recording
    try:
        testing.toy_run(HYBRID, root=hybrid_checkout)
    finally:
        prefill.layer_caches = layer_caches
    kinds = {"ssm": ["conv", "state"], "attn": ["k", "v"]}
    period = ["ssm", "attn", "ssm"]
    assert seen and seen[0] == sorted((l, n) for l in range(6) for n in kinds[period[l % 3]])


def test_hybrid_fault_in_a_cache_past_pos0_fails(hybrid_checkout):
    """The caches of the last position (``pos2``) altered as the prefill
    hands them on: the check comes out not correct, on ``cache_rel``."""
    with faults.cache_altered():
        run = testing.toy_run(HYBRID, root=hybrid_checkout)
    assert not run.correct and run.checks["cache_rel"]["value"] > run.checks["cache_rel"]["limit"], run.checks
    assert run.checks["logits_rel"]["value"] <= run.checks["logits_rel"]["limit"]


@pytest.mark.parametrize("workload", ["mamba2-130m.prefill.2k", "danube3-4b.prefill.4k"])
def test_prefill_window_sends_each_batch_its_prompts(workload):
    """The window's prompts are drawn a batch ahead, while the device works
    on the one before; each batch the port prefills in the window is still
    batch ``i`` of the window's stream, in order, and none is skipped."""
    from unittest import mock

    import numpy as np
    import repro_torch.models.model as M

    sent, prefill_fn = [], M.prefill

    def recording(params, cfg, batch, *args, **kwargs):
        sent.append(batch["tokens"].cpu().numpy().copy())
        return prefill_fn(params, cfg, batch, *args, **kwargs)

    with mock.patch.object(M, "prefill", recording):
        run = testing.toy_run(workload)
    spec = testing.toy_spec(workload)
    B, L, V = spec["traffic"]["batch"], spec["traffic"]["prompt_len"], spec["config"]["vocab"]
    window = sent[2:]  # after set-up's two warm-up batches
    assert len(window) == len(run.batches) >= spec["limits"]["keep_within"]
    for i, toks in enumerate(window):
        np.testing.assert_array_equal(toks, prefill.prompts(testing.SEED, prefill.WINDOW, i, B, L, V))
    assert run.correct, run.checks


def test_worst_keeps_a_nan_wherever_it_stands():
    assert worst(0.1, 0.3, 0.2) == 0.3
    assert math.isnan(worst(0.1, float("nan"))) and math.isnan(worst(float("nan"), 0.1))


def test_a_nan_reading_is_not_correct():
    """A training step whose loss or a leaf reads NaN fails the check,
    wherever the NaN stands among the steps and leaves."""
    ref = dict(losses=[5.0, 4.9, 4.8], grad={"a": 1.0, "b": 2.0, "c": 3.0}, change={"a": 1.0, "b": 2.0, "c": 3.0})
    prog = dict(losses=[5.0, float("nan"), 4.8], grad=dict(ref["grad"], b=float("nan")),
                change=dict(ref["change"], c=float("nan")))
    nums = train.compare(prog, ref)
    assert all(math.isnan(v) for v in nums.values()), nums
    assert not all(v <= 1.0 for v in nums.values())


def test_mamba2_reference_gradients_by_recomputation():
    """``Mamba2Ref.loss_and_grads``, which recomputes each layer from its
    kept input, gives the gradients of autograd over the whole model, the
    tied embedding's two uses summed."""
    import torch
    import torch.nn.functional as F

    from bench_port.reference.common import rms_norm
    from bench_port.reference.mamba2 import Mamba2Ref

    cfg = testing.toy_config(harness.load_json(os.path.join(harness.HERE, "configs", "mamba2-130m.json")))
    cfg.update(n_layers=3, dtype="float32")
    W = weights.make_weights(cfg, testing.SEED, "cpu")
    rows = torch.randint(0, cfg["vocab"], (2, 33), generator=torch.Generator().manual_seed(7))
    loss, grads = Mamba2Ref(cfg, W).loss_and_grads(rows[:, :-1], rows[:, 1:])

    leaves = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    ref = Mamba2Ref(cfg, leaves)
    x = leaves["embed"][rows[:, :-1]]
    for l in range(cfg["n_layers"]):
        x = ref.layer(ref.layer_weights(l), x)[0]
    logits = rms_norm(x, leaves["final_norm"], cfg["norm_eps"]) @ leaves["embed"].T
    whole = F.cross_entropy(logits.reshape(-1, cfg["vocab"]), rows[:, 1:].reshape(-1))
    want = dict(zip(leaves, torch.autograd.grad(whole, list(leaves.values()))))
    assert loss == pytest.approx(whole.item(), rel=1e-6)
    assert set(grads) == set(want)
    for k, g in want.items():
        torch.testing.assert_close(grads[k], g, rtol=1e-4, atol=1e-6, msg=k)
