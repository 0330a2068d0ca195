"""The port's example twins on the CPU, asserting what the originals assert:
``serve_batched --smoke`` serves the reduced hybrid jamba, as
examples/serve_batched.py does, and ``fault_tolerance`` preempts, restores
at step 20 and re-partitions to half the samples, as
examples/fault_tolerance.py does."""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.slow  # training and serving processes on a real clock


def test_serve_batched_smoke_serves_jamba(capsys):
    from repro_torch.examples import serve_batched

    res = serve_batched.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [len(t) for t in res.tokens] == [16] * 4
    assert all(0 <= t < 512 for seq in res.tokens for t in seq)
    assert "jamba-1.5-large-398b-smoke (float32, 16 layers) on CPU" in out
    assert sum(line.startswith("seq ") for line in out.splitlines()) == 4


def test_serve_batched_takes_arch_and_layers(capsys):
    from repro_torch.examples import serve_batched

    res = serve_batched.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--layers", "1",
                              "--device", "cpu"])
    assert [len(t) for t in res.tokens] == [16] * 4
    assert "phi3.5-moe-42b-a6.6b-smoke (float32, 1 layers) on CPU" in capsys.readouterr().out


def test_fault_tolerance_twin(tmp_path, capsys):
    from repro_torch.examples import fault_tolerance

    res = fault_tolerance.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert res["run1_step"] == 25
    assert res["restored"] and res["restored_step"] == 20  # the latest checkpoint
    assert res["run2_step"] == 35
    assert res["partition"] == 1024
    assert "OK: preempt -> restore -> elastic resize all succeeded" in capsys.readouterr().out
