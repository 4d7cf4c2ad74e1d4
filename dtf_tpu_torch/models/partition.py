"""The tensor-parallel partition rule of the transformer LM -- the
PyTorch counterpart of ``dtf_tpu/models/partition.py`` and of
``param_partition_specs`` in ``dtf_tpu/models/transformer.py``, under
the port's parameter names.

Megatron's layout over the 'model' axis: the qkv projection is sharded
on its heads, fc1 on d_ff (both column-parallel), the attention's
``out`` and fc2 on their input (row) dimension, the ``lm_head`` on the
vocabulary under ``--shard_lm_head``, and everything else (embeddings,
LayerNorms) is replicated.  :func:`rule` says which dimension of a
parameter (or of a tensor in its layout: a gradient, an optimizer
moment) is sharded; :func:`shard` cuts model shard ``index`` of ``mp``
from the full tensor and :func:`unshard` joins the shards back, so
slicing and gathering go through one rule.  The pipeline family's rule
is its own (``models/pipeline_lm.py``: the layer dimension of a stacked
block leaf, ``Split(0)``), and so is the MoE family's (``models/moe.py``:
the expert dimension of an expert leaf, over the data or the model
axis); :func:`shard_for` cuts by whichever rule the model carries, at
the model's own place (:func:`place`).

In the port's layout a Linear weight is [out, in]: qkv's [3·H·Dh, d]
orders its rows (3, H, Dh), so its heads are the inner part of dim 0
viewed as (3, H·Dh) -- ``Split(0, groups=3)`` takes heads h0:h1 of each
of q, k and v, not a contiguous third of the rows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch


class Split(NamedTuple):
    """A sharded dimension: ``dim`` viewed as (``groups``, n / groups),
    the inner part cut into the shards."""

    dim: int
    groups: int = 1


def rule(name: str, shard_vocab: bool = False) -> Optional[Split]:
    """The sharded dimension of the parameter ``name`` (a state-dict
    key, ``block0.attn.qkv.weight``), or None for a replicated one."""
    keys = name.split(".")
    last = keys[-1]
    if "qkv" in keys:
        # weight [3*H*Dh, d] / bias [3*H*Dh]: the heads of each of q, k, v
        return Split(0, 3)
    if "fc1" in keys:
        # weight [ff, d] / bias [ff]
        return Split(0)
    if ("out" in keys or "fc2" in keys) and last == "weight":
        # weight [d, in]: the row-parallel input dimension
        return Split(1)
    if shard_vocab and "lm_head" in keys:
        # weight [V, d] / bias [V]
        return Split(0)
    return None


def _grouped(t: torch.Tensor, split: Split) -> torch.Tensor:
    shape = list(t.shape)
    n = shape[split.dim]
    return t.reshape(shape[:split.dim] + [split.groups, n // split.groups]
                     + shape[split.dim + 1:])


def shard(t: torch.Tensor, split: Optional[Split], mp: int,
          index: int) -> torch.Tensor:
    """Model shard ``index`` of ``mp`` of the full tensor ``t`` (a new
    contiguous tensor; the whole of ``t`` when ``split`` is None)."""
    if split is None or mp == 1:
        return t.clone()
    g = _grouped(t, split)
    inner = split.dim + 1
    n = g.shape[inner]
    if n % mp:
        raise ValueError(f"dimension of {n} not divisible by "
                         f"model_parallelism {mp}")
    k = n // mp
    local = g.narrow(inner, index * k, k)
    shape = list(t.shape)
    shape[split.dim] = shape[split.dim] // mp
    return local.reshape(shape).contiguous()


def unshard(parts: List[torch.Tensor], split: Optional[Split]
            ) -> torch.Tensor:
    """The full tensor from its shards in model order."""
    if split is None or len(parts) == 1:
        return parts[0]
    full = torch.cat([_grouped(p, split) for p in parts], split.dim + 1)
    shape = list(parts[0].shape)
    shape[split.dim] *= len(parts)
    return full.reshape(shape)


def shard_state_dict(sd: dict, mp: int, index: int,
                     shard_vocab: bool = False) -> dict:
    """Model shard ``index`` of a full state dict."""
    return {k: shard(v, rule(k, shard_vocab), mp, index)
            for k, v in sd.items()}


def place(model) -> tuple:
    """(shards, index): how many parts ``model``'s rule cuts a split
    leaf into and which is the model's -- its expert shard for a MoE
    model under either placement, else its model-axis shard."""
    return (getattr(model, "expert_parallelism", model.model_parallelism),
            getattr(model, "expert_index", model.model_index))


def shard_for(model, sd: dict) -> dict:
    """``model``'s own part of a full state dict: each leaf cut by the
    model's rule (``model.split``) -- its tensor-parallel shard, its
    pipeline stage's layers of a stacked leaf, or its experts."""
    n, index = place(model)
    return {k: shard(v, model.split(k), n, index) for k, v in sd.items()}
