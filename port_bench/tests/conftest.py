"""The harness's CPU tests: ``python -m pytest port_bench/tests`` from the
repo root.  The harness's folder and the port's ``src`` go on the path as
``run.py`` puts them."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent.parent / "src"), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

