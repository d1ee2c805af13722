"""Batched serving engine.

Continuous-batching-lite, with the slot and queue logic of the JAX
package's engine: a fixed decode batch of slots; finished/empty slots are
refilled from a request queue; prefill runs token-by-token through
``decode_step``, then the slot joins the decode batch.  All slots decode at
one position, the largest of the fed slots' positions.  Steps are eager
calls under ``torch.inference_mode()``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.models import Model


@dataclass
class ServeConfig:
    max_len: int = 512
    batch_slots: int = 4
    temperature: float = 0.0  # 0 = greedy
    eos_token: int = -1  # -1: never stop early
    seed: int = 0


@dataclass
class _Slot:
    request_id: int
    prompt: list[int]
    generated: list[int] = field(default_factory=list)
    pos: int = 0
    max_new: int = 16
    done: bool = False


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig):
        self.model = model
        self.params = params
        self.cfg = cfg
        with torch.inference_mode():
            self.caches = model.init_cache(cfg.batch_slots, cfg.max_len)
        self._step = model.decode_step
        self._slots: list[Optional[_Slot]] = [None] * cfg.batch_slots
        self._queue: list[_Slot] = []
        self._next_id = 0
        self._gen = torch.Generator(device=model.device).manual_seed(cfg.seed)

    # -- public api -----------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int = 16) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Slot(rid, list(prompt), max_new=max_new))
        return rid

    def run(self) -> dict[int, list[int]]:
        """Run until all submitted requests complete.  Returns generations."""
        results: dict[int, list[int]] = {}
        with torch.inference_mode():
            while self._queue or any(s and not s.done for s in self._slots):
                self._fill_slots()
                self._decode_round()
                for i, s in enumerate(self._slots):
                    if s and s.done:
                        results[s.request_id] = s.generated
                        self._slots[i] = None
        return results

    # -- internals ------------------------------------------------------------
    def _fill_slots(self) -> None:
        for i, s in enumerate(self._slots):
            if s is None and self._queue:
                slot = self._queue.pop(0)
                self._slots[i] = slot
                self._prefill(i, slot)

    def _prefill(self, slot_idx: int, slot: _Slot) -> None:
        """Feed prompt tokens through decode_step (slot-batched: other slots
        receive a pad that is discarded)."""
        for t in slot.prompt[:-1]:
            self._advance(feed={slot_idx: t}, sample=False)
            slot.pos += 1
        # the final prompt token is fed by the first decode round
        slot.generated = []

    def _decode_round(self) -> None:
        feed = {}
        for i, s in enumerate(self._slots):
            if s is None or s.done:
                continue
            if not s.generated:
                feed[i] = s.prompt[-1] if s.prompt else 0
            else:
                feed[i] = s.generated[-1]
        if not feed:
            return
        next_tokens = self._advance(feed=feed, sample=True)
        for i, s in enumerate(self._slots):
            if s is None or s.done or i not in feed:
                continue
            tok = next_tokens[i]
            s.generated.append(tok)
            s.pos += 1
            if len(s.generated) >= s.max_new or tok == self.cfg.eos_token:
                s.done = True

    def _advance(self, feed: dict[int, int], sample: bool):
        tokens = [0] * self.cfg.batch_slots
        pos = 0
        for i, t in feed.items():
            tokens[i] = t
            pos = max(pos, self._slots[i].pos if self._slots[i] else 0)
        token_t = torch.tensor(tokens, dtype=torch.int64).to(self.model.device)
        # the position as a 0-d tensor on the model's device (a fill, not a
        # copy from the host): the step run here is the one the verifier
        # traces, where the position is an input
        pos_t = torch.full((), pos, dtype=torch.int64, device=self.model.device)
        logits, self.caches = self._step(self.params, token_t, self.caches, pos_t)
        if not sample:
            return None
        if self.cfg.temperature <= 0:
            return logits.argmax(dim=-1).tolist()
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].tolist()
