"""The port's training launcher on the CPU (``--device cpu``), tp x dp gloo
ranks spawned by ``parallel.spmd.run``: the counterparts of
tests/test_train_integration.py (the verification gate and a loss that
falls, checkpoint, kill and resume, and a resume onto another mesh), a
sequence-parallel launch whose gate proves the SP plan, the launch it
refuses with exit 2 before any weight is drawn (``--zero1`` with ``--dp >
1``, where the JAX launcher crashes) and its refusal to run without a GPU
unless asked."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as launch_train  # noqa: E402


def _train(args: list[str], capsys) -> str:
    assert launch_train.main([*args, "--device", "cpu"]) == 0
    return capsys.readouterr().out


def _losses(stdout: str) -> list[float]:
    return [float(m) for m in re.findall(r"loss (\d+\.\d+)", stdout)]


def test_train_verify_gate_and_loss_decreases(capsys):
    out = _train(["--arch", "qwen3_4b", "--smoke", "--steps", "40",
                  "--tp", "2", "--dp", "2", "--seq", "64", "--batch", "8",
                  "--lr", "3e-3"], capsys)
    assert "[verify] VERIFIED" in out and "[done] 40 steps" in out
    losses = _losses(out)
    assert len(losses) == 5 and losses[0] - losses[-1] > 0.3, f"no learning: {losses}"


def test_kill_and_resume_continues(tmp_path, capsys):
    """A run resumed from step 20 prints the losses of a run that was never
    stopped.  (The JAX test asks only that the resumed loss be no higher
    than the first one: on mamba2_130m's SMOKE stream neither package's
    loss falls within 30 steps, JAX's own reading 5.89-6.05, so that order
    is a coin toss of the seed; equality with the uninterrupted run is the
    property resuming must have.)"""
    common = ["--arch", "mamba2_130m", "--smoke", "--tp", "1", "--dp", "2", "--seq", "32",
              "--batch", "4", "--ckpt-every", "10", "--skip-verify"]
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt")]
    # phase 1: 20 steps, checkpoint every 10
    out1 = _train(["--steps", "20", *ckpt, *common], capsys)
    assert "saved step 10" in out1 and "saved step 20" in out1
    # phase 2: "restart after failure", resumes from step 20
    out2 = _train(["--steps", "30", "--resume", *ckpt, *common], capsys)
    assert "resumed" in out2 and "at step 20" in out2 and "[done] 10 steps" in out2
    whole = _train(["--steps", "30", "--ckpt-dir", str(tmp_path / "whole"), *common], capsys)
    assert _losses(out2) == pytest.approx(_losses(whole)[-2:], rel=1e-4)


def test_elastic_resume_different_mesh(tmp_path, capsys):
    """A checkpoint written under dp=2 restores under tp=2 x dp=2: every rank
    reads the logical leaves and cuts its shard; the data stream replays its
    position.  The resumed run's first step equals the dp=2 run's own next
    step (the same weights, moments and batch)."""
    ckpt = str(tmp_path / "ckpt")
    common = ["--arch", "qwen3_4b", "--smoke", "--seq", "32", "--batch", "8",
              "--ckpt-dir", ckpt, "--ckpt-every", "10", "--skip-verify"]
    _train(["--steps", "10", "--tp", "1", "--dp", "2", *common], capsys)
    out = _train(["--steps", "14", "--tp", "2", "--dp", "2", "--resume", *common], capsys)
    assert "resumed" in out and "at step 10" in out
    steady = _train(["--steps", "11", "--tp", "1", "--dp", "2", "--resume", *common], capsys)
    assert _losses(out)[0] == pytest.approx(_losses(steady)[0], rel=1e-3)


@pytest.mark.parametrize("flags", [["--zero1", "--dp", "2"],
                                   ["--zero1", "--dp", "2", "--tp", "2", "--sp"]])
def test_refused_launches_exit_2_before_any_weight(flags, monkeypatch, capsys):
    """``--zero1 --dp 2`` on any device, with or without TP and SP (the CPU
    has no card, so the device is stood in for: ``--sp`` alone is no longer
    refused on the card)."""
    monkeypatch.setattr(launch_train, "Model", lambda *a, **kw: pytest.fail("model built"))
    monkeypatch.setattr(launch_train, "resolve_device", lambda d: torch.device("cuda"))
    assert launch_train.main(["--arch", "qwen3_4b", "--smoke", *flags]) == 2
    out = capsys.readouterr().out
    assert "REFUSED" in out and "step" not in out.replace("steps", "")


def test_sp_launch_gate_proves_the_sp_plan(capsys):
    """``--sp`` on tp 2 x dp 2 ranks: the gate verifies the sequence-parallel
    plan (sp-forward beside dp-forward), then the ranks train with SP."""
    out = _train(["--arch", "qwen3_4b", "--smoke", "--steps", "3", "--tp", "2",
                  "--dp", "2", "--sp", "--seq", "32", "--batch", "4"], capsys)
    gate = next(line for line in out.splitlines() if line.startswith("[verify] checking"))
    assert "+sp" in gate and "[verify] VERIFIED" in out and "[done] 3 steps" in out
    assert len(_losses(out)) == 2


def test_launcher_needs_gpu_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3_4b", "--smoke", "--steps", "1"])
