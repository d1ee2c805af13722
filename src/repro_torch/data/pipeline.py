"""Synthetic-but-learnable token pipeline, the JAX package's stream as torch
tensors.

The stream is a deterministic function of (seed, step, host shard): a mixture
of first-order Markov chains whose transition tables derive from the seed.
The numpy generator calls are the JAX package's, call for call, so the
tokens and labels are its own bit for bit (int32, as ``input_specs`` types
them), on the CPU; callers move them to their device.

  * **sharded**: ``batch_at(step, shard=r, n_shards=n)`` is a disjoint
    stream of its own.  A data-parallel rank does not use it: it takes its
    rows of the global ``batch_at(step)``, as ``shard_map`` cuts the batch;
  * **resumable**: ``state = (seed, step)`` fully determines the batch;
  * **learnable**: the Markov structure is compressible, so a small model
    visibly reduces loss within tens of steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64  # markov chain order-1 state count


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse-ish transition structure: each state prefers ~8 tokens
        k = min(8, cfg.vocab)
        self._prefs = rng.integers(0, cfg.vocab, size=(cfg.n_states, k))
        self._state_of = rng.integers(0, cfg.n_states, size=cfg.vocab)

    def batch_at(self, step: int, *, shard: int = 0, n_shards: int = 1) -> dict:
        """The (deterministic) global batch at ``step``, restricted to a
        shard of its own stream.  Tokens and next-token labels."""
        cfg = self.cfg
        b_loc = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        toks = np.empty((b_loc, cfg.seq_len + 1), np.int32)
        state = rng.integers(0, cfg.n_states, size=b_loc)
        toks[:, 0] = self._prefs[state, rng.integers(0, self._prefs.shape[1], b_loc)]
        for t in range(1, cfg.seq_len + 1):
            state = self._state_of[toks[:, t - 1]]
            choice = rng.integers(0, self._prefs.shape[1], b_loc)
            explore = rng.random(b_loc) < 0.1
            nxt = self._prefs[state, choice]
            nxt = np.where(explore, rng.integers(0, cfg.vocab, b_loc), nxt)
            toks[:, t] = nxt
        return {
            "tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:])),
        }

    def iter_from(self, step: int, **kw) -> Iterator[dict]:
        while True:
            yield self.batch_at(step, **kw)
            step += 1


def make_batch_for(cfg_arch, shape_spec, *, seed: int = 0, step: int = 0,
                   shard: int = 0, n_shards: int = 1) -> dict:
    """Concrete batch matching configs.input_specs for smoke/e2e runs (on the
    CPU; patch and frame embeddings rounded to bf16 as JAX rounds them)."""
    B = shape_spec.global_batch // n_shards
    S = shape_spec.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard]))
    out = {}
    if cfg_arch.frontend == "vision_patches":
        out["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg_arch.frontend_len, cfg_arch.frontend_dim),
                                np.float32)).to(torch.bfloat16)
        out["tokens"] = torch.from_numpy(
            rng.integers(0, cfg_arch.vocab, (B, S - cfg_arch.frontend_len)).astype(np.int32))
    elif cfg_arch.frontend == "audio_frames":
        out["frames"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg_arch.d_model), np.float32)).to(torch.bfloat16)
    else:
        data = SyntheticLM(DataConfig(cfg_arch.vocab, S, shape_spec.global_batch, seed))
        return data.batch_at(step, shard=shard, n_shards=n_shards)
    out["labels"] = torch.from_numpy(
        rng.integers(0, cfg_arch.vocab, (B, S)).astype(np.int32))
    return out
