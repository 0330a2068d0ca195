"""Each cell's path at toy size on the CPU: the run, its metrics and its
check; the control (the reference with fp8 products in the port's place)
and the faults planted under the timed path must each come out not
correct."""
import pytest

from bench_port import faults, harness, testing

CELLS = ["danube3-4b.train.bucket", "mamba2-130m.prefill.2k", "danube3-4b.prefill.4k"]


@pytest.mark.parametrize("workload", CELLS)
def test_toy_cell_runs_and_is_correct(workload):
    """A whole run at toy size.  A prefill cell is held to its limits; at
    toy width the bf16 rounding of a training step's parameters reads
    higher than at the cell's widths, so the training cell's compared
    numbers are held to its control's at the same size instead, and its
    rows exactly."""
    run = testing.toy_run(workload, trace=True, control=workload.endswith(".train.bucket"))
    assert run.attempted > 0 and run.failed == 0
    line = harness.result(run, False, 1)
    if "control" in run.readings:
        program, control = run.readings["program"], run.readings["control"]
        assert all(program[k] < control[k] for k in program), run.readings
        assert line["checks"]["rows_wrong"]["value"] == 0 and line["checks"]["rows_repeated"]["value"] == 0
    else:
        assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in run.spec["end_to_end"]}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    traced = harness.result(run, True, 1)
    assert traced["metrics"]  # the counters' and spans' metrics; device ones need the card
    assert list(traced)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_toy_control_fails_the_check(workload):
    run = testing.toy_run(workload, control=True)
    limits = run.spec["limits"]
    control = run.readings["control"]
    assert any(control[name] > limits[name] for name in control), (control, limits)


@pytest.mark.parametrize(
    "workload,fault",
    [("danube3-4b.train.bucket", "state_unchanged"), ("danube3-4b.train.bucket", "half_batch"),
     ("mamba2-130m.prefill.2k", "token_altered"), ("danube3-4b.prefill.4k", "token_altered"),
     ("mamba2-130m.prefill.2k", "cache_altered"), ("danube3-4b.prefill.4k", "cache_altered")],
)
def test_toy_fault_fails_the_check(workload, fault):
    with faults.FAULTS[fault]():
        run = testing.toy_run(workload)
    assert not run.correct, run.checks
