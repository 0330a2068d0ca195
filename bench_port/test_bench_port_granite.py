"""The Granite 4.0-H cell on the CPU: its path at toy size (the run, its
metrics, its check), with the control and the planted faults coming out not
correct; and the FLOPs its layout module counts, against hand-worked
numbers.

The toy keeps the cell's pattern (two periods of ten: Mamba-2 at positions
0-4 and 6-9, attention without rotary at 5, every channel mixer an MoE with
a shared expert, every multiplier the published one) at the harness's toy
widths, with no window and a shared expert of 48.  It runs in float32: at
toy width bf16's roundings compound over the twenty layers past the cell's
limits (the SSM state of layer 19 reads 0.04-0.11 where layer 0's reads
0.004), where at the cell's width they do not.  In float32 the port reads
rounding and the control's fp8 products read far above the limits."""
import time

import pytest

from bench_port import faults, harness, layouts, testing
from bench_port.frozen import flops

WORKLOAD = "granite4h-small.prefill.4k"


def toy_run(control: bool = False, trace: bool = False) -> harness.Run:
    import torch

    spec = testing.toy_spec(WORKLOAD)
    spec["config"].update(window=None, shared_intermediate_size=48, dtype="float32")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.driver(spec).run(spec, testing.SEED, 0.5, trace, "cpu", time.monotonic(), control=control)
    finally:
        torch.set_num_threads(threads)


def test_toy_cell_runs_is_correct_and_its_control_is_not():
    run = toy_run(control=True, trace=True)
    assert run.attempted > 0 and run.failed == 0
    line = harness.result(run, False, 1)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "prefill_tokens_per_s", "ttft_p95_ms"}
    limits, control = run.spec["limits"], run.readings["control"]
    assert any(control[name] > limits[name] for name in control), (control, limits)
    traced = harness.result(run, True, 1)["metrics"]
    for name in ("moe_route_ms.prefill", "moe_experts_ms.prefill", "mlp_ms.prefill", "mixer_self_ms.prefill"):
        assert traced[name]["value"] > 0, name
    assert traced["moe_load_ratio.prefill"]["value"] >= 1.0


@pytest.mark.parametrize("fault", ["token_altered", "cache_altered"])
def test_toy_fault_fails_the_check(fault):
    with faults.FAULTS[fault]():
        run = toy_run()
    assert not run.correct, run.checks


def granite(n_layers: int) -> dict:
    cfg = harness.load_cell(WORKLOAD)["config"]
    return dict(cfg, n_layers=n_layers)


def test_granite_flops_hand_worked():
    # one period of granite-4.0-h-small: 9 Mamba-2 layers (d 4096, d_inner
    # 8192, 128 heads, N 128) and one GQA layer (32 / 8 heads of 128), each
    # with the router over 72 experts, the top 10 SwiGLU experts of 768 and
    # the shared SwiGLU expert of 1536
    ssm = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    attn = 2 * 4096 * 32 * 128 + 2 * 4096 * 8 * 128
    moe = 4096 * 72 + 10 * 3 * 4096 * 768 + 3 * 4096 * 1536
    assert (ssm, attn, moe) == (102_236_160, 41_943_040, 113_541_120)
    period = 9 * ssm + attn + 10 * moe
    assert period == 2_097_479_680
    one = granite(10)
    layout = layouts.find(one)
    assert layout is not None and flops._counts(one) == (layout.matmul_params, layout.mixer_flops)
    assert layout.matmul_params(one) == period
    # a prefill of 4 x 4096: the scan at chunk 256 (16 chunks, 128 heads),
    # attention's 4·hd a visible pair and head, the head at the last position
    scan = 2 * 256 * (256 * 128 + 256 * 64 + 2 * 128 * 64) * 4 * 128 * 16
    att = 4 * 128 * (4096 * 4097 // 2) * 32 * 4
    assert layout.mixer_flops(one, 4, 4096) == 9 * scan + att
    want = 2 * period * 4 * 4096 + 2 * 4096 * 100352 * 4 + 9 * scan + att
    assert flops.prefill_flops(one, 4, 4096) == want
    # the cell: two periods
    cell = granite(20)
    assert flops.prefill_flops(cell, 4, 4096) == 2 * (want - 2 * 4096 * 100352 * 4) + 2 * 4096 * 100352 * 4
    assert flops.prefill_flops(cell, 4, 4096) == 143511299031040.0
