"""Training substrate: optimizer, trainer loop, checkpointing/fault
tolerance, gradient compression."""
from .optimizer import adamw_init, adamw_update, lr_schedule

__all__ = ["adamw_init", "adamw_update", "lr_schedule"]
