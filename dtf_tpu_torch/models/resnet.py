"""ResNet-50 v1.5 for 224x224 ImageNet -- the PyTorch counterpart of
``dtf_tpu/models/resnet.py``, plus the pieces the CIFAR ResNets share.

The model takes NHWC batches, as the JAX package's does, and computes
in NCHW tensors laid out ``torch.channels_last``: the permute of an
NHWC batch is that layout without a copy, and cuDNN runs NHWC
convolutions on it.  Module names follow the flax tree (``conv1``,
``bn_conv1``, ``stage{s}_block{b}.conv_a/bn_a/...``, ``fc``), so
``convert.py`` maps one onto the other leaf by leaf.

What a direct translation would get wrong, pinned here and in the tests:

  BatchNorm (:class:`BatchNorm`) keeps flax's math: the batch variance
      is the biased ``E[x^2] - E[x]^2`` clamped at 0, in at least
      float32; the running buffers move by ``m * old + (1 - m) * new``
      with the reference momentum (0.9 here, 0.997 for CIFAR), not
      ``nn.BatchNorm2d``'s unbiased rule; the normalize keeps flax's
      order (``y = x - mean``, ``mul = rsqrt(var + eps) * scale``,
      ``y * mul + bias``).  ResNet-50's BN returns the compute dtype;
      the CIFAR ResNets' returns float32.
  'SAME' padding (:func:`same_pads`) is XLA's split, which is
      asymmetric -- (0, 1) -- for a stride-2 3x3 window over an even
      size and (1, 1) over an odd one; the max-pool pads with -inf.
  The space-to-depth stem (:class:`Stem`) is the 7x7/2 conv computed
      as a 4x4/1 conv over 2x2 blocks of 12 channels; the parameter
      keeps the reference shape, ``conv1.weight`` [64, 3, 7, 7].

Mixed precision is flax's ``dtype`` / ``param_dtype`` split: float32
parameters cast to ``dtype`` where they are used, batch statistics in
float32, logits cast to float32.  Parameters are drawn by
:func:`init_vision_weights` from flax's initializers (``he_normal``
convolutions, N(0, 0.01) classifier).

Sync BN (the JAX package's ``bn_axis``) is ``bn_group``: a process
group over which each BatchNorm averages its batch statistics
(``parallel/collectives.py``).

``remat=True`` is ``RESNET_REMAT_POLICY``, applied to each bottleneck
block in training only (``nn.remat(BottleneckBlock, ...)``): a selective
checkpoint policy (:func:`resnet_remat_context`) saves the convolution
outputs and BatchNorm's batch statistics and recomputes the
normalize/ReLU chains in the backward, so no convolution runs again.
The policy names aten ops where the CPU and cuDNN agree: a convolution
reaches the dispatcher as ``aten.convolution`` on both, the statistics
as ``aten.mean.dim``.  The recompute moves no running statistics (each
BatchNorm updates its buffers in the first forward only); under sync
BN it averages the saved statistics over the group again, every rank
in the same order.  Not ported: the fp8-residual probe
(``Fp8ResidConv``), which has no flag in the JAX package either.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from dtf_tpu_torch.models.initializers import variance_scaling_
from dtf_tpu_torch.parallel.collectives import all_reduce_mean_grad

BATCH_NORM_DECAY = 0.9
BATCH_NORM_EPSILON = 1e-5

# RESNET_REMAT_POLICY's names, as aten ops: "conv_out" and "bn_stats"
REMAT_SAVED_OPS = (torch.ops.aten.convolution.default,
                   torch.ops.aten.mean.dim)


def _resnet_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in REMAT_SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def resnet_remat_context():
    """``context_fn`` of the selective policy for
    ``torch.utils.checkpoint``: conv outputs and batch statistics
    saved, everything else recomputed."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_resnet_policy)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding of one spatial dim: (before, after), the
    extra element after when the total is odd."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0):
    """(x, padding) for an NCHW window op with 'SAME' padding: a
    symmetric split is returned as the op's own ``padding``; an
    asymmetric one is applied to ``x`` with ``value``."""
    (h0, h1), (w0, w1) = (same_pads(n, k, s) for n, k, s in
                          zip(x.shape[2:], kernel, stride))
    if h0 == h1 and w0 == w1:
        return x, (h0, w0)
    return F.pad(x, (w0, w1, h0, h1), value=value), (0, 0)


def max_pool_same(x, kernel: int = 3, stride: int = 2):
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``."""
    x, pad = pad_same(x, (kernel, kernel), (stride, stride),
                      value=-math.inf)
    return F.max_pool2d(x, kernel, stride, pad)


def to_nchw(x):
    """An NHWC batch as NCHW in the channels_last layout (a view when
    ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv(use_bias=False, dtype=dtype)``: input and kernel
    cast to ``dtype``, padding ``"SAME"`` (XLA's split) or an explicit
    symmetric int."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding="SAME", dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=0 if padding == "SAME" else padding,
                         bias=False)
        self.same = padding == "SAME"
        self.compute_dtype = dtype

    def forward(self, x):
        x = x.to(self.compute_dtype)
        pad = self.padding
        if self.same:
            x, pad = pad_same(x, self.kernel_size, self.stride)
        return F.conv2d(x, self.weight.to(self.compute_dtype), None,
                        self.stride, pad)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias in
    ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of an NCHW tensor.

    Train mode normalizes with the batch statistics and moves the
    running buffers; eval mode normalizes with the buffers.  ``dtype``
    is the output dtype; None returns the promoted type of the math
    (float32 for bfloat16 or float32 input), as the CIFAR ResNets'
    ``dtype=jnp.float32`` does.  With a process ``group`` (sync BN,
    flax's ``axis_name``) the stacked ``[mean, E[x^2]]`` is averaged
    over the group in one all-reduce, differentiably, before the
    variance is formed."""

    def __init__(self, num_features: int, momentum: float,
                 epsilon: float = BATCH_NORM_EPSILON,
                 dtype: Optional[torch.dtype] = None, group=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.out_dtype = dtype
        self.group = group
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, update_stats: bool = True):
        """``update_stats`` False (a remat recompute) leaves the running
        buffers as they are."""
        if self.training:
            # flax _compute_stats: reductions in at least float32, the
            # fast variance with its negative-roundoff clamp
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xs.mean((0, 2, 3))
            mean2 = xs.square().mean((0, 2, 3))
            if self.group is not None:
                mean, mean2 = all_reduce_mean_grad(
                    torch.stack([mean, mean2]), self.group)
            var = torch.clamp_min(mean2 - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                if update_stats:
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        y = x - mean.view(shape)
        mul = torch.rsqrt(var.view(shape) + self.epsilon)
        mul = mul * self.weight.view(shape)
        y = y * mul + self.bias.view(shape)
        return y if self.out_dtype is None else y.to(self.out_dtype)


class Stem(Conv2d):
    """ResNet-50's conv1: 7x7/2 with an explicit (3, 3) pad and no bias,
    taking the NHWC batch.  With ``space_to_depth`` (the JAX default)
    and an even RGB input it runs ``Conv1SpaceToDepth``'s exact
    reformulation: the padded input in 2x2 blocks of 12 channels, the
    kernel zero-padded to 8x8 and cut into the same blocks, one 4x4/1
    conv.  Either way the output is NCHW, channels_last."""

    def __init__(self, features: int = 64, space_to_depth: bool = True,
                 dtype=torch.float32):
        super().__init__(3, features, 7, stride=2, padding=3, dtype=dtype)
        self.space_to_depth = space_to_depth

    def forward(self, x):
        b, h, w, c = x.shape
        dt = self.compute_dtype
        x = x.to(dt)
        if not (self.space_to_depth and h % 2 == 0 and w % 2 == 0
                and c == 3):
            return F.conv2d(to_nchw(x), self.weight.to(dt), None, 2, 3)
        x = F.pad(x, (0, 0, 3, 3, 3, 3))
        hb, wb = (h + 6) // 2, (w + 6) // 2
        x = x.reshape(b, hb, 2, wb, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hb, wb, 4 * c)
        f = self.out_channels
        k = F.pad(self.weight.permute(2, 3, 1, 0), (0, 0, 0, 0, 0, 1, 0, 1))
        k = k.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
        k = k.reshape(4, 4, 4 * c, f).permute(3, 2, 0, 1)
        return F.conv2d(to_nchw(x), k.to(dt))


class BottleneckBlock(nn.Module):
    """[1x1, 3x3 (stride), 1x1] with BN after each conv, the stride on the
    3x3 (v1.5), and a 1x1 + BN projection shortcut when asked."""

    def __init__(self, in_channels: int, filters: Sequence[int],
                 strides: int = 1, projection: bool = False,
                 dtype=torch.float32, bn_group=None, remat: bool = False):
        super().__init__()
        f1, f2, f3 = filters
        self.remat = remat

        def bn(n):
            return BatchNorm(n, BATCH_NORM_DECAY, BATCH_NORM_EPSILON,
                             dtype=dtype, group=bn_group)

        self.conv_a = Conv2d(in_channels, f1, 1, dtype=dtype)
        self.bn_a = bn(f1)
        self.conv_b = Conv2d(f1, f2, 3, stride=strides, dtype=dtype)
        self.bn_b = bn(f2)
        self.conv_c = Conv2d(f2, f3, 1, dtype=dtype)
        self.bn_c = bn(f3)
        self.projection = projection
        if projection:
            self.conv_proj = Conv2d(in_channels, f3, 1, stride=strides,
                                    dtype=dtype)
            self.bn_proj = bn(f3)

    def forward(self, x):
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self._forward(x, True)
        # the first call is the forward, the second the backward's
        # recompute, which must not move the running statistics again
        first = [True]

        def run(x):
            update, first[0] = first[0], False
            return self._forward(x, update)

        return torch.utils.checkpoint.checkpoint(
            run, x, use_reentrant=False, context_fn=resnet_remat_context)

    def _forward(self, x, update: bool):
        y = F.relu(self.bn_a(self.conv_a(x), update))
        y = F.relu(self.bn_b(self.conv_b(y), update))
        y = self.bn_c(self.conv_c(y), update)
        shortcut = (self.bn_proj(self.conv_proj(x), update)
                    if self.projection else x)
        return F.relu(y + shortcut.to(y.dtype))


class ResNet50(nn.Module):
    """NHWC images -> float32 logits [batch, num_classes]."""

    STAGES = (((64, 64, 256), 3, 1), ((128, 128, 512), 4, 2),
              ((256, 256, 1024), 6, 2), ((512, 512, 2048), 3, 2))

    def __init__(self, num_classes: int = 1001, dtype=torch.float32,
                 stem_space_to_depth: bool = True, bn_group=None,
                 remat: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.conv1 = Stem(64, stem_space_to_depth, dtype=dtype)
        self.bn_conv1 = BatchNorm(64, BATCH_NORM_DECAY, BATCH_NORM_EPSILON,
                                  dtype=dtype, group=bn_group)
        self.block_names = []
        cin = 64
        for s, (filters, blocks, stride) in enumerate(self.STAGES, start=2):
            for b in range(blocks):
                name = f"stage{s}_block{b}"
                self.add_module(name, BottleneckBlock(
                    cin, filters, strides=stride if b == 0 else 1,
                    projection=b == 0, dtype=dtype, bn_group=bn_group,
                    remat=remat))
                self.block_names.append(name)
                cin = filters[-1]
        self.fc = Dense(cin, num_classes, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.bn_conv1(self.conv1(x)))
        x = max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(x.mean((2, 3))).float()

    def init_weights(self, seed: int):
        return init_vision_weights(self, seed, classifier_init)


def classifier_init(w: torch.Tensor, gen) -> None:
    # the ResNets' Dense: normal(stddev=0.01)
    nn.init.normal_(w, std=0.01, generator=gen)


@torch.no_grad()
def init_vision_weights(model: nn.Module, seed: int,
                        dense_init: Callable) -> nn.Module:
    """Fill a vision model's parameters from ``torch.Generator(seed)``
    in module order, drawn on the CPU in float32 and copied into each
    parameter's device: conv kernels ``he_normal``, Dense kernels
    ``dense_init(weight, gen)`` and zero biases, BN scale 1 and bias 0
    with running mean 0 and variance 1.  Returns the model."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            w = torch.empty(mod.weight.shape)
            variance_scaling_(w, 2.0, w[0].numel(), gen)   # he_normal
            mod.weight.copy_(w)
        elif isinstance(mod, nn.Linear):
            w = torch.empty(mod.weight.shape)
            dense_init(w, gen)
            mod.weight.copy_(w)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model
