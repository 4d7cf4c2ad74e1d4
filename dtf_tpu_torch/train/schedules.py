"""Learning-rate schedules as pure functions of the global step -- a copy
of ``dtf_tpu/train/schedules.py`` over Python numbers.

Each schedule is ``fn(step) -> float`` for an int (or 0-d tensor) step.
The reference's three LR paths (the CIFAR and ImageNet per-batch
callbacks and the tensor PiecewiseConstantDecayWithWarmup) keep their
semantics: epoch-granular decay, fractional-epoch warmup, linear
scaling of the base LR with the batch.  The JAX versions compute in
float32 inside the compiled step; these compute in double, so the two
agree to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

BASE_LEARNING_RATE = 0.1  # the reference's common.py

# (multiplier, epoch_to_start) tables of the reference mains
CIFAR_LR_SCHEDULE = ((0.1, 91), (0.01, 136), (0.001, 182))
IMAGENET_LR_SCHEDULE = ((1.0, 5), (0.1, 30), (0.01, 60), (0.001, 80))

Schedule = Callable[[int], float]


def piecewise_by_epoch(batch_size: int, steps_per_epoch: int,
                       base_batch: int, table: Sequence,
                       warmup_epochs: float = 0.0) -> Schedule:
    """Epoch-granular piecewise-constant decay with optional per-step
    linear warmup; linear scaling rule ``BASE_LR * batch / base_batch``."""
    initial_lr = BASE_LEARNING_RATE * batch_size / base_batch

    def fn(step):
        step = float(step)
        epoch = math.floor(step / steps_per_epoch)
        lr = initial_lr
        for mult, start_epoch in table:
            if epoch >= start_epoch:
                lr = initial_lr * mult
        if warmup_epochs > 0 and step < warmup_epochs * steps_per_epoch:
            lr = initial_lr * (step / steps_per_epoch / warmup_epochs)
        return lr

    return fn


def cifar_schedule(batch_size: int, steps_per_epoch: int) -> Schedule:
    """No warmup, /128 scaling, decay at epochs 91/136/182."""
    return piecewise_by_epoch(batch_size, steps_per_epoch, 128,
                              CIFAR_LR_SCHEDULE)


def imagenet_schedule(batch_size: int, steps_per_epoch: int) -> Schedule:
    """Fractional-epoch 5-epoch warmup, then decay at 30/60/80; /256
    scaling."""
    initial_lr = BASE_LEARNING_RATE * batch_size / 256
    warmup_mult, warmup_end = IMAGENET_LR_SCHEDULE[0]

    def fn(step):
        frac_epoch = float(step) / steps_per_epoch
        epoch = math.floor(frac_epoch)
        lr = initial_lr
        for mult, start_epoch in IMAGENET_LR_SCHEDULE:
            if epoch >= start_epoch:
                lr = initial_lr * mult
        if frac_epoch < warmup_end:
            return initial_lr * warmup_mult * frac_epoch / warmup_end
        return lr

    return fn


def piecewise_constant_with_warmup(batch_size: int, epoch_size: int,
                                   warmup_epochs: int = 5,
                                   boundaries: Sequence[int] = (30, 60, 80),
                                   multipliers: Sequence[float] = (
                                       1.0, 0.1, 0.01, 0.001),
                                   ) -> Schedule:
    """The --use_tensor_lr path: step-boundary decay (not epoch-floor)
    and warmup to the unmultiplied rescaled LR."""
    if len(boundaries) != len(multipliers) - 1:
        raise ValueError("len(boundaries) must be len(multipliers) - 1")
    steps_per_epoch = epoch_size // batch_size
    rescaled_lr = BASE_LEARNING_RATE * batch_size / 256
    step_boundaries = [float(steps_per_epoch) * b for b in boundaries]
    lr_values = [rescaled_lr * m for m in multipliers]
    warmup_steps = warmup_epochs * steps_per_epoch

    def fn(step):
        step = float(step)
        if step < warmup_steps:
            return rescaled_lr * step / max(warmup_steps, 1)
        lr = lr_values[0]
        for b, v in zip(step_boundaries, lr_values[1:]):
            if step > b:
                lr = v
        return lr

    return fn


def horovod_schedule(num_replicas: int, steps_per_epoch: int,
                     warmup_epochs: float = 3.0,
                     base_lr: float = BASE_LEARNING_RATE) -> Schedule:
    """Constant ``base_lr * num_replicas``, ramped linearly from
    ``base_lr`` over the first ``warmup_epochs``."""
    scaled = base_lr * num_replicas

    def fn(step):
        frac = min(float(step) / (warmup_epochs * steps_per_epoch), 1.0)
        return base_lr + (scaled - base_lr) * frac

    return fn


def lm_schedule(total_steps: int, peak_lr: float = 3e-4,
                final_frac: float = 0.1) -> Schedule:
    """Linear warmup over the first tenth of training (capped at 2000
    steps), then cosine decay to ``final_frac`` of the peak.  Step 0's
    LR is exactly 0."""
    warmup = max(1, min(2000, total_steps // 10))
    decay_steps = max(total_steps - warmup, 1)

    def fn(step):
        step = float(step)
        if step < warmup:
            return peak_lr * step / warmup
        progress = min(max((step - warmup) / decay_steps, 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac) * 0.5 * (
            1 + math.cos(math.pi * progress)))

    return fn


def constant(lr: float) -> Schedule:
    def fn(step):
        del step
        return float(lr)
    return fn


def for_dataset(dataset: str, batch_size: int, steps_per_epoch: int,
                epoch_size: int, use_tensor_lr: bool = False,
                train_epochs: int = 1) -> Schedule:
    if dataset.startswith("cifar"):
        return cifar_schedule(batch_size, steps_per_epoch)
    if dataset == "lm":
        return lm_schedule(steps_per_epoch * max(train_epochs, 1))
    if use_tensor_lr:
        return piecewise_constant_with_warmup(batch_size, epoch_size)
    return imagenet_schedule(batch_size, steps_per_epoch)
