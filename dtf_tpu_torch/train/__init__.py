"""Training: schedules, optimizers and the single-device loop."""

from dtf_tpu_torch.train.loop import Trainer, TrainState  # noqa: F401
