"""Training: AdamW, LR schedules, the train step, the synthetic data
stream, checkpoints in the reference's layout and the fault-tolerant loop
(ports of ``repro/train/*``, one device)."""
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.schedule import cosine_schedule
from repro_torch.train.step import TrainState, make_train_step

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "make_train_step",
    "TrainState",
]
