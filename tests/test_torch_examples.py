"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU: the quickstart's verdicts and localization, as the reference's
``examples/quickstart.py`` prints them; the serving example; the training
example's launch (its 130M-parameter steps take about a minute each on a
CPU, so its launcher is stubbed); the zoo sweep on one arch."""
import tempfile

import pytest

pytest.importorskip("torch")

from repro_torch.examples import (quickstart, serve_batched, train_e2e,  # noqa: E402
                                  verify_model_zoo)


def test_quickstart_verifies_then_localizes(capsys):
    quickstart.main()
    out = capsys.readouterr().out
    first, second = out.split("=== 2.")
    assert "\nVERIFIED" in first
    assert "UNVERIFIED" in second and "missing_all_reduce" in second
    assert "-> localized: True" in second


def test_serve_batched_answers_every_request(capsys):
    assert serve_batched.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert sum(line.startswith("[done] req") for line in out.splitlines()) == 6


def test_train_e2e_launches_the_reference_run(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(train_e2e, "train_main", lambda argv: seen.append(argv) or 0)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # as TMPDIR would
    assert train_e2e.main(["--steps", "3", "--device", "cpu"]) == 0
    argv = seen[0]
    assert argv[argv.index("--arch") + 1] == "mamba2_130m"
    assert argv[argv.index("--steps") + 1] == "3" and "--resume" in argv
    assert argv[-2:] == ["--device", "cpu"]
    # its checkpoints stay under the process's temporary directory
    assert argv[argv.index("--ckpt-dir") + 1] == str(tmp_path / "repro_torch_e2e_ckpt")


def test_verify_model_zoo_warm_session(monkeypatch, capsys):
    monkeypatch.setattr(verify_model_zoo, "ARCH_IDS", ["gemma_2b"])
    verify_model_zoo.main(["--layers", "2", "--tp", "16"])
    out = capsys.readouterr().out
    assert "gemma_2b" in out and "True" in out and "geomean over 1 archs" in out
