"""The JAX reference's ``lint_detected`` column for every (arch, scenario)
pair of ``chip_smoke.CAMPAIGN_REFERENCE``, beside the port's, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/campaign_lint_reference.py

Prints, per pair, the injectors whose cell the lint tier flags in each
package, and exits 1 if the port's column differs from the reference's
(chip_smoke.py holds the card's run to the printed reference)."""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import CAMPAIGN_REFERENCE, DP_SIZE, TP_SIZE  # noqa: E402
from repro.verify.campaign import run_campaign as jrun_campaign  # noqa: E402
from repro_torch.verify import run_campaign  # noqa: E402


def flagged(rep) -> tuple:
    return tuple(sorted(c.injector for c in rep.cells if c.lint_detected))


def main() -> int:
    differ = []
    for arch, kind in CAMPAIGN_REFERENCE:
        t0 = time.perf_counter()
        want = flagged(jrun_campaign([arch], tp=TP_SIZE, dp=DP_SIZE, scenarios=[kind]))
        got = flagged(run_campaign([arch], tp=TP_SIZE, dp=DP_SIZE, scenarios=[kind]))
        print(f"({arch!r}, {kind!r}): {want!r},  # port {got!r}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if got != want:
            differ.append((arch, kind))
    print("differ:", differ)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
