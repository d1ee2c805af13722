"""Batched serving: the engine over a SMOKE model with mixed prompt
lengths, on the card (``--device cpu`` on a host without one).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch gemma_2b
"""
import argparse
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b")
    args, extra = ap.parse_known_args(argv)
    return serve_main(["--arch", args.arch, "--smoke", "--requests", "6",
                       "--max-new", "12", "--slots", "3", *extra])


if __name__ == "__main__":
    sys.exit(main())
