"""ResNet-(6n+2) for 32x32 CIFAR -- the PyTorch counterpart of
``dtf_tpu/models/resnet_cifar.py``.

Basic blocks of two 3x3 convs, stages of 16/32/64 filters at strides
1/2/2, each stage's first block with a 1x1 + BN projection shortcut; a
3x3/1 stem with an explicit (1, 1) pad; BatchNorm momentum 0.997 and
epsilon 1e-5.  The layers, their names and their numerics are those of
``models/resnet.py`` (``bn_group`` for sync BN included) with one
difference the JAX package has too: this
family's BatchNorm returns float32 (flax ``dtype=jnp.float32``), so
under bf16 compute the residual adds run in float32 and each conv casts
its input back to bf16.  ``resnet662`` keeps the reference's misnamed
``resnet10`` (110 blocks a stage).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from dtf_tpu_torch.models.resnet import (BatchNorm, Conv2d, Dense,
                                         classifier_init,
                                         init_vision_weights, to_nchw)

BATCH_NORM_DECAY = 0.997
BATCH_NORM_EPSILON = 1e-5


def _bn(n: int, group) -> BatchNorm:
    # dtype None: the float32 result of the normalize math
    return BatchNorm(n, BATCH_NORM_DECAY, BATCH_NORM_EPSILON, dtype=None,
                     group=group)


class BasicBlock(nn.Module):
    """identity_building_block / conv_building_block of the reference."""

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 projection: bool = False, dtype=torch.float32,
                 bn_group=None):
        super().__init__()
        self.conv_a = Conv2d(in_channels, filters, 3, stride=strides,
                             dtype=dtype)
        self.bn_a = _bn(filters, bn_group)
        self.conv_b = Conv2d(filters, filters, 3, dtype=dtype)
        self.bn_b = _bn(filters, bn_group)
        self.projection = projection
        if projection:
            self.conv_proj = Conv2d(in_channels, filters, 1, stride=strides,
                                    dtype=dtype)
            self.bn_proj = _bn(filters, bn_group)

    def forward(self, x):
        y = F.relu(self.bn_a(self.conv_a(x)))
        y = self.bn_b(self.conv_b(y))
        shortcut = (self.bn_proj(self.conv_proj(x)) if self.projection
                    else x)
        return F.relu(y + shortcut.to(y.dtype))


class CifarResNet(nn.Module):
    """NHWC images -> float32 logits [batch, num_classes]."""

    def __init__(self, num_blocks: int = 9, num_classes: int = 10,
                 dtype=torch.float32, bn_group=None):
        super().__init__()
        self.num_blocks = num_blocks
        self.num_classes = num_classes
        self.dtype = dtype
        self.conv1 = Conv2d(3, 16, 3, padding=1, dtype=dtype)
        self.bn_conv1 = _bn(16, bn_group)
        self.block_names = []
        cin = 16
        for s, (filters, stride) in enumerate(((16, 1), (32, 2), (64, 2)),
                                              start=2):
            for b in range(num_blocks):
                name = f"stage{s}_block{b}"
                self.add_module(name, BasicBlock(
                    cin, filters, strides=stride if b == 0 else 1,
                    projection=b == 0, dtype=dtype, bn_group=bn_group))
                self.block_names.append(name)
                cin = filters
        self.fc = Dense(cin, num_classes, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.bn_conv1(self.conv1(to_nchw(x.to(self.dtype)))))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(x.mean((2, 3))).float()

    def init_weights(self, seed: int):
        return init_vision_weights(self, seed, classifier_init)


resnet20 = functools.partial(CifarResNet, num_blocks=3)
resnet32 = functools.partial(CifarResNet, num_blocks=5)
resnet56 = functools.partial(CifarResNet, num_blocks=9)
resnet110 = functools.partial(CifarResNet, num_blocks=18)
# strict parity with the reference's misnamed "resnet10" (num_blocks=110)
resnet662 = functools.partial(CifarResNet, num_blocks=110)
