"""Model registry + the L2-as-loss-term rule -- the vision and
transformer, pipeline and MoE LM entries of
``dtf_tpu/models/registry.py``, with the same names, default class
counts and L2 weights: ResNet-50 v1.5, the CIFAR ResNet-(6n+2) family,
the trivial input probe, the transformer LMs (a tensor-parallel shard
through the transformer's ``model_parallelism``, ``model_index`` and
``shard_vocab``), the pipeline-stacked LMs (a pipeline stage through
the same ``model_parallelism`` and ``model_index``) and the
mixture-of-experts LMs (an expert shard through ``expert_axis``,
``expert_parallelism`` and ``expert_index``).  Sync BN, the JAX
package's ``bn_axis``, is ``bn_group``: a process group for the BNs of
every vision model but the trivial probe.

The reference applies L2 through Keras kernel_regularizers, which fold
into the loss: every conv/dense kernel is penalized, plus the final
classifier's bias (``fc``), never a normalization scale or bias.
:func:`l2_weight_penalty` re-expresses that rule over torch parameter
names: the ``weight`` of every Linear and Conv module (flax ``kernel``)
and the ``bias`` of a module whose path has an ``fc`` component.  On a
tensor-parallel shard (``model.model_group`` set) the sum of squares
of the sharded leaves goes through ``tp_psum`` over the model group and
each replicated leaf counts once, so the term and its gradient are the
unsharded model's (the JAX rule with ``param_specs``).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from dtf_tpu_torch.models import (moe, pipeline_lm, resnet, resnet_cifar,
                                  transformer, trivial)
from dtf_tpu_torch.parallel.collectives import tp_psum

# reference weight-decay constants
L2_IMAGENET = 1e-4
L2_CIFAR = 2e-4

_REGISTRY = {
    "resnet50": (resnet.ResNet50, 1001, L2_IMAGENET),
    "resnet20": (resnet_cifar.resnet20, 10, L2_CIFAR),
    "resnet32": (resnet_cifar.resnet32, 10, L2_CIFAR),
    "resnet56": (resnet_cifar.resnet56, 10, L2_CIFAR),
    "resnet110": (resnet_cifar.resnet110, 10, L2_CIFAR),
    "resnet662": (resnet_cifar.resnet662, 10, L2_CIFAR),
    "trivial": (trivial.TrivialModel, 1001, 0.0),
    # LM family (no L2: the reference's weight-decay rule is ResNet-only)
    "transformer": (transformer.TransformerLM, 32_768, 0.0),
    "transformer_small": (
        functools.partial(transformer.TransformerLM, num_layers=4,
                          d_model=256, num_heads=4, d_ff=1024),
        32_768, 0.0),
    # GPT-2-small-sized flagship with 6 heads x d_head 128 (the same
    # parameter shapes and count as GPT-2's 12 x 64)
    "transformer_tpu": (
        functools.partial(transformer.TransformerLM, num_layers=12,
                          d_model=768, num_heads=6, d_ff=3072),
        32_768, 0.0),
    # routed-expert LM family (expert parallelism over the data axis, or
    # the model axis under --model_parallelism)
    "moe_transformer": (moe.MoETransformerLM, 32_768, 0.0),
    "moe_transformer_small": (
        functools.partial(moe.MoETransformerLM, num_layers=4, d_model=256,
                          num_heads=4, d_ff=1024, num_experts=4),
        32_768, 0.0),
    # pipeline-stacked LM family (pipeline stages over the model axis)
    "pipeline_transformer": (pipeline_lm.PipelinedTransformerLM,
                             32_768, 0.0),
    "pipeline_transformer_small": (
        functools.partial(pipeline_lm.PipelinedTransformerLM, num_layers=4,
                          d_model=256, num_heads=4, d_ff=1024),
        32_768, 0.0),
}

_KERNEL_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def is_vision(name: str) -> bool:
    """True for the image-classifier entries (ResNets, trivial)."""
    return not name.startswith(("transformer", "pipeline_transformer",
                                "moe_transformer"))


def is_pipeline(name: str) -> bool:
    """True for the pipeline-stacked LM family."""
    return name.startswith("pipeline_transformer")


def auto_num_microbatches(pp: int, per_replica_batch: int) -> int:
    """The pipeline family's microbatch count when ``--num_microbatches``
    is unset, the JAX runner's rule: 4 pp -- the bubble is
    (pp - 1) / (M + pp - 1), so M = 4 pp keeps it under 20% -- halved
    until it divides the per-replica batch."""
    m = 4 * max(int(pp), 1)
    while m > 1 and per_replica_batch % m:
        m //= 2
    return m


def is_moe(name: str) -> bool:
    """True for the mixture-of-experts LM family."""
    return name.startswith("moe_transformer")


def build_model(name: str, num_classes: int | None = None,
                dtype=torch.float32, bn_group=None, **model_kw):
    """Returns (module, l2_weight).  Parameters are float32 and left as
    constructed: a vision model draws them with its ``init_weights(seed)``
    and an LM with ``serve.bridge.random_init``, both called by
    ``cli/runner.py``.  ``bn_group`` (a process group, or None for
    per-replica statistics) makes the BatchNorms sync BN."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    ctor, default_classes, l2 = _REGISTRY[name]
    classes = num_classes or default_classes
    if is_vision(name):
        if name != "trivial":
            model_kw["bn_group"] = bn_group
        module = ctor(num_classes=classes, dtype=dtype, **model_kw)
    else:
        module = ctor(vocab_size=classes, dtype=dtype, **model_kw)
    return module, l2


def penalized_parameters(model: nn.Module):
    """(name, parameter) pairs the L2 rule covers: each Linear/Conv
    weight, and the bias of a module under an ``fc`` path component."""
    out = []
    for mod_name, mod in model.named_modules():
        if not isinstance(mod, _KERNEL_MODULES):
            continue
        prefix = f"{mod_name}." if mod_name else ""
        out.append((prefix + "weight", mod.weight))
        if mod.bias is not None and "fc" in mod_name.split("."):
            out.append((prefix + "bias", mod.bias))
    return out


def l2_weight_penalty(model: nn.Module, l2_weight: float) -> torch.Tensor:
    """Keras-parity L2 term: ``l2 * sum(w^2)`` over the penalized
    parameters (Keras ``regularizers.l2(l)`` has no 1/2 factor), in
    float32 -- a 0-d tensor, zero when ``l2_weight`` is 0."""
    dev = next(model.parameters()).device
    if not l2_weight:
        return torch.zeros((), dtype=torch.float32, device=dev)
    group = getattr(model, "model_group", None)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    sharded = torch.zeros((), dtype=torch.float32, device=dev)
    for name, p in penalized_parameters(model):
        ss = p.float().square().sum()
        if group is not None and model.split(name) is not None:
            sharded = sharded + ss
        else:
            total = total + ss
    if group is not None:
        total = total + tp_psum(sharded, group)
    return l2_weight * total
