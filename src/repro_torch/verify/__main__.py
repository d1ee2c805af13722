"""``python -m repro_torch.verify`` — the CLI verification gate."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
