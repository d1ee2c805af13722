"""Architecture configs (the dense attention-only archs and mamba2_130m
ported so far)."""
from .base import ARCH_IDS, EXTRA_IDS, ArchConfig, get_config
