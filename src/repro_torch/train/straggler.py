"""Straggler mitigation at the host level.

On a real pod, SPMD steps are synchronous — a slow host stalls everyone.  The
two levers a framework controls from the host side are (1) *detection* with
actionable telemetry, and (2) keeping the input pipeline off the critical
path so data hiccups never become stragglers.  Both are implemented here and
wired into the training driver; the collective-level mitigation (backup
workers / elasticity) is handled by checkpoint-restart + elastic resharding
(train/checkpoint.py), which these signals trigger.

* :class:`StepTimer` — per-step EMA + robust outlier detection.  A step
  slower than ``threshold x EMA`` is flagged; ``should_checkpoint_and_rebalance``
  latches after ``patience`` consecutive flags (the driver then snapshots and
  can re-launch without the sick host — elastic restore does the resharding).
* :class:`PrefetchIterator` — a background-thread data prefetcher with a
  deadline: if the next batch misses the deadline, the previous batch is
  *re-served* (training-stat impact: one duplicate batch, vs a stalled step).
  Deterministic replay on restore is preserved because served step indices
  are recorded.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class StepTimer:
    ema_decay: float = 0.9
    threshold: float = 3.0  # x EMA counts as a straggler step
    patience: int = 3  # consecutive flags before escalation
    warmup_steps: int = 5  # ignore compile/first steps

    _ema: float = 0.0
    _seen: int = 0
    _consecutive: int = 0
    flagged_steps: list = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True if this step is a straggler."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            self._ema = seconds if self._ema == 0 else self._ema
            return False
        slow = self._ema > 0 and seconds > self.threshold * self._ema
        if slow:
            self._consecutive += 1
            self.flagged_steps.append((step, seconds, self._ema))
        else:
            self._consecutive = 0
            self._ema = self.ema_decay * self._ema + (1 - self.ema_decay) * seconds
        return slow

    @property
    def should_checkpoint_and_rebalance(self) -> bool:
        return self._consecutive >= self.patience

    @property
    def ema(self) -> float:
        return self._ema


class PrefetchIterator:
    """Deadline-bounded background prefetch of ``fetch(step) -> batch``."""

    def __init__(self, fetch: Callable[[int], Any], start_step: int = 0,
                 deadline_s: float = 5.0, depth: int = 2):
        self._fetch = fetch
        self._deadline = deadline_s
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._last: Optional[Any] = None
        self.reserved_count = 0  # batches re-served due to missed deadlines
        self.served_steps: list[int] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self._fetch(step)
            except Exception:
                break
            self._q.put((step, batch))
            step += 1

    def next(self) -> Any:
        try:
            step, batch = self._q.get(timeout=self._deadline)
            self._last = batch
            self.served_steps.append(step)
            return batch
        except queue.Empty:
            if self._last is None:  # nothing to re-serve yet: block
                step, batch = self._q.get()
                self._last = batch
                self.served_steps.append(step)
                return batch
            self.reserved_count += 1
            self.served_steps.append(self.served_steps[-1])
            return self._last

    def close(self) -> None:
        self._stop.set()
