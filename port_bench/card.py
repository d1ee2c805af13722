"""The card as a run reads it: its name and power limit, its clocks and
power around the window, finished work, and memory."""
from __future__ import annotations

import subprocess

import torch


def describe() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


STATE = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")
# the reasons the card holds its clocks down, a bit mask (nvidia-smi's
# newer field name first): 0x1 idle, 0x4 the software power cap, 0x8 a
# hardware slowdown, 0x20 and 0x40 thermal slowdowns
REASONS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")


def state() -> dict | None:
    """The card's SM and memory clocks (MHz), power draw (W), temperature
    (C) and the active clock-event reasons, as nvidia-smi reads them now;
    None where it cannot."""
    for reasons in REASONS:
        try:
            out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(STATE)},{reasons}",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            return None
        if out.returncode == 0 and out.stdout.strip():
            vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
            got = dict(zip(STATE, vals[:-1]))
            got["reasons"] = vals[-1]
            return got
    return None


def sync(device: str) -> None:
    """Wait until the card has finished its queued work."""
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def memory(device: str) -> tuple[int, int]:
    """(the allocator's peak since the last reset, the card's memory), once
    the card has finished; (0, 0) off the card."""
    if not device.startswith("cuda"):
        return 0, 0
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated(),
            torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory)


def reset_peak(device: str) -> None:
    """Start the allocator's peak afresh once queued work has finished."""
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
