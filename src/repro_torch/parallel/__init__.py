"""Parallel context (Megatron TP over functional collectives), sharding
specs, the vocab-parallel embedding, and gloo ranks for running a per-rank
program."""
from .ctx import ParallelCtx

__all__ = ["ParallelCtx"]
