"""Training: AdamW with f32 masters, the warmup-cosine schedule, the
train step with microbatches, step-atomic checkpoints (the port of
``repro.train``)."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedule import warmup_cosine
from .step import TrainStepConfig, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "warmup_cosine", "TrainStepConfig", "make_train_step"]
