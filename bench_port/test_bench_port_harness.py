"""The harness on the CPU: discovery by name, a cell added by files alone,
the frozen arithmetic against hand-worked numbers, and the import rule."""
import ast
import json
import os
import shutil

import pytest

from bench_port import harness, testing
from bench_port.frozen import bucket, flops, roofline

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
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
    for sub in ("configs", "traffic", "limits", "metrics"):
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
    assert flops.layer_matmul_params(danube) == layer
    pairs = 2048 * 2049 // 2
    want = 6 * (24 * layer + 3840 * 32000) * 4096 + 12 * 24 * 32 * 120 * pairs * 2
    assert flops.train_flops(danube, 2, 2048) == pytest.approx(want)
    assert want == pytest.approx(9.90e13, rel=1e-3)
    mamba = harness.load_json(os.path.join(harness.HERE, "configs", "mamba2-130m.json"))
    assert 24 * flops.layer_matmul_params(mamba) == 24 * (768 * (2 * 1536 + 256 + 24) + 1536 * 768)
    scan = 24 * 2 * 256 * (256 * 128 + 256 * 64 + 2 * 128 * 64) * 32 * 24 * 8  # chunk 256
    want = 2 * 24 * flops.layer_matmul_params(mamba) * 32 * 2048 + 2 * 768 * 50288 * 32 + scan
    assert flops.prefill_flops(mamba, 32, 2048) == pytest.approx(want)


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
