"""Architecture configs (the dense attention-only archs, mamba2_130m, and the
audio and vision frontends ported so far)."""
from .base import (ARCH_IDS, EXTRA_IDS, SHAPES, ArchConfig, ShapeDtype, ShapeSpec,
                   get_config, input_specs, skip_reason)
