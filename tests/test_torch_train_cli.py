"""The port's training launcher end to end on the CPU, as a user runs it,
and its refusal of a full-size config without ``--smoke``."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.slow  # a training process on a real clock


def _run(*args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )


def test_train_cli_smoke_on_cpu(tmp_path):
    out = _run("--arch", "h2o-danube-3-4b", "--smoke", "--steps", "3", "--device", "cpu",
               tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "arch=h2o-danube-3-4b-smoke" in out.stdout
    done = [line for line in out.stdout.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and done[0].startswith("done: step 3 loss "), out.stdout


def test_train_cli_moe_smoke_on_cpu(tmp_path):
    """phi3.5-moe's reduced config reaches the MoE block through train_loss."""
    out = _run("--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--steps", "3", "--device", "cpu",
               tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "arch=phi3.5-moe-42b-a6.6b-smoke" in out.stdout
    done = [line for line in out.stdout.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and done[0].startswith("done: step 3 loss "), out.stdout


def test_train_cli_refuses_full_size_without_smoke(tmp_path):
    out = _run("--arch", "h2o-danube-3-4b", "--steps", "1", "--device", "cpu", tmp_path=tmp_path)
    assert out.returncode != 0
    assert "4B params" in out.stderr and "--smoke" in out.stderr
