"""flax's truncated-normal initializers over torch tensors, drawn from
an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import torch
from torch import nn

# the std of a unit normal truncated to +-2
TRUNC_STD = 0.87962566103423978


def variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                      gen: torch.Generator) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``
    into ``w``: truncated to +-2 std, the std corrected so the truncated
    distribution has variance ``scale / fan_in``.  ``he_normal`` is
    scale 2, ``lecun_normal`` scale 1."""
    std = math.sqrt(scale / fan_in) / TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
