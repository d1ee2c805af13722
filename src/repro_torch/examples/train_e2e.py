"""End-to-end training: mamba2_130m (130M parameters) for a few hundred
steps on the deterministic synthetic Markov stream, with checkpoints and
resume, on the card (``--device cpu`` on a host without one).

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 300
"""
import argparse
import sys
import tempfile
from pathlib import Path

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    # under the temporary directory of this process's environment (TMPDIR)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_torch_e2e_ckpt"))
    args, extra = ap.parse_known_args(argv)
    return train_main([
        "--arch", "mamba2_130m",
        "--steps", str(args.steps),
        "--tp", "1", "--dp", "1",
        "--seq", "128", "--batch", "8",
        "--lr", "3e-3",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--resume",
        "--skip-verify",  # tp=1: nothing to verify
        *extra,
    ])


if __name__ == "__main__":
    sys.exit(main())
