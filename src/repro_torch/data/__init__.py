"""Deterministic synthetic data pipeline with sharded, resumable iteration."""
from .pipeline import DataConfig, SyntheticLM, make_batch_for

__all__ = ["DataConfig", "SyntheticLM", "make_batch_for"]
