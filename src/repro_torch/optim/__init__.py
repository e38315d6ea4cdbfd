"""Optimizers (from scratch): AdamW, Adafactor, schedules, grad clipping."""

from repro_torch.optim.adamw import (AdamW, Adafactor, clip_by_global_norm,
                                     cosine_schedule, global_norm, make_optimizer)

__all__ = ["AdamW", "Adafactor", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "make_optimizer"]
