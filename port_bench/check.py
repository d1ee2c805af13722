"""The comparison that decides ``correct`` for a prefill cell.

A request's answer is the program's greedy next token at every position of
its prompt.  The reference (``reference/decoder.py``, float32) runs once
over the same prompts, and at each position reads the gap by which its
logit of the program's token lies below its best logit: 0 where they agree,
small where rounding picked a near tie, large where the token is wrong.
The numbers compared, each with its limit from ``limits/<cell>.json``, are
among ``Gaps.numbers()``.
"""
from __future__ import annotations

import importlib

import torch

ROWS = 4096  # positions whose float32 logits are formed at once


def reference_module(cfg_file: dict):
    return importlib.import_module(f"reference.{cfg_file['reference']}")


class Gaps:
    """The gaps of the positions seen, and which of them flipped (the token
    is not the reference's first)."""

    def __init__(self):
        self.gaps, self.flips = [], []

    def add(self, ref_logits: torch.Tensor, ids: torch.Tensor) -> None:
        best, first = ref_logits.max(-1)
        self.gaps.append((best - ref_logits.gather(-1, ids[:, None])[:, 0]).cpu())
        self.flips.append((ids != first).cpu())

    def numbers(self) -> dict:
        """``gap_max``, the widest gap; ``gap_mean``, the mean gap over the
        positions; ``flip_pct``, the share of positions that flipped."""
        gaps = torch.cat(self.gaps)
        return {"gap_max": float(gaps.max()), "gap_mean": float(gaps.mean()),
                "flip_pct": 100.0 * float(torch.cat(self.flips).float().mean())}


def gaps_of(ref, m: dict, params: dict, tokens: torch.Tensor, answers: dict,
            gaps: dict) -> None:
    """Run the float32 reference over ``tokens`` (B, S) and add, for each
    ``answers[name]`` (B, S) of token ids, its positions to ``gaps[name]``.
    A name ``"control"`` in ``answers`` with the value None stands for the
    fp8 reference's own first tokens (the control)."""
    h = ref.hidden(m, params, tokens, ref.Precision("f32")).reshape(-1, m["d_model"])
    hc = None
    if "control" in answers:
        hc = ref.hidden(m, params, tokens, ref.Precision("fp8")).reshape(-1, m["d_model"])
    w = ref.head_weight(m, params)
    for r0 in range(0, h.shape[0], ROWS):
        lg = ref.logits(m, params, h[r0: r0 + ROWS], ref.Precision("f32"), w)
        for name, ans in answers.items():
            if name == "control":
                lc = ref.logits(m, params, hc[r0: r0 + ROWS], ref.Precision("fp8"), w)
                ids = lc.argmax(-1)
                del lc
            else:
                ids = ans.reshape(-1)[r0: r0 + ROWS].to(lg.device)
            gaps.setdefault(name, Gaps()).add(lg, ids)
        del lg
