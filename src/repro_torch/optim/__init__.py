"""AdamW with warmup + cosine schedule, global-norm clipping and f32
master copies (the reference package's ``optim``)."""

from repro_torch.optim.adamw import (AdamWConfig, OptState, apply,
                                     global_norm, init, schedule)

__all__ = ["AdamWConfig", "OptState", "apply", "global_norm", "init",
           "schedule"]
