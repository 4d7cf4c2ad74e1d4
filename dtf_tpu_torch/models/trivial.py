"""Trivial throughput-probe model -- the PyTorch counterpart of
``dtf_tpu/models/trivial.py``: flatten -> Dense(1) -> Dense(num_classes),
to measure the input path with next to no device compute
(``--use_trivial_model``).

The flatten runs over the NHWC batch, so ``fc1.weight`` holds its
inputs in (H, W, C) order, the flax kernel's rows; flax infers that
width from the first batch, the port takes it as ``in_features``.
Both Dense layers have flax's default initializer (lecun_normal) and
zero biases.
"""

from __future__ import annotations

import torch
from torch import nn

from dtf_tpu_torch.models.initializers import variance_scaling_
from dtf_tpu_torch.models.resnet import Dense, init_vision_weights


class TrivialModel(nn.Module):
    """NHWC images -> float32 logits [batch, num_classes]."""

    def __init__(self, num_classes: int = 1001, dtype=torch.float32,
                 in_features: int = 224 * 224 * 3):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.fc1 = Dense(in_features, 1, dtype=dtype)
        self.fc = Dense(1, num_classes, dtype=dtype)

    def forward(self, x):
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        return self.fc(self.fc1(x)).float()

    def init_weights(self, seed: int):
        # flax's Dense default, lecun_normal
        return init_vision_weights(
            self, seed,
            lambda w, gen: variance_scaling_(w, 1.0, w.shape[1], gen))
