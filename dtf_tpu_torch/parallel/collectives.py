"""Collectives over the data axis -- the data-parallel subset of
``dtf_tpu/parallel/collectives.py``.

The JAX package's collectives run inside ``shard_map`` over a mesh axis
name; here the axis is a ``torch.distributed`` process group and a
replica is a process.  Each function takes the group (``None``: world
1, and the function is the identity), works in place on one tensor and
returns it.  Only ``all_reduce`` and ``broadcast`` run, so the gloo
backend serves CUDA tensors too.

  reference mechanism                     -> here
  -------------------------------------------------------------------
  NCCL ring allreduce (Horovod)           -> all_reduce_sum / _mean
  hvd.BroadcastGlobalVariablesCallback(0) -> broadcast_from(root=0)

:func:`all_reduce_mean_grad` is the differentiable form that sync
BatchNorm needs: the mean forward, and in backward the sum of the
cotangents over the group divided by its size -- ``lax.pmean``'s
transpose under ``shard_map``.

Not ported yet: ``axis_size``/``axis_index`` (``MeshRuntime`` holds the
rank and size), ``all_gather``, ``reduce_scatter``, ``ring_shift`` and
the tensor-parallel ``tp_region`` / ``tp_psum``, which wait for model
parallelism.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_mean(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        x.div_(dist.get_world_size(group))
    return x


def broadcast_from(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                   root: int = 0) -> torch.Tensor:
    """Every replica gets ``root``'s ``x``."""
    if group is not None:
        dist.broadcast(x, src=dist.get_global_rank(group, root),
                       group=group)
    return x


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_mean(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_mean(grad.clone(), ctx.group), None


def all_reduce_mean_grad(x: torch.Tensor,
                         group: Optional[dist.ProcessGroup]
                         ) -> torch.Tensor:
    """The group mean of ``x``, differentiable (a new tensor)."""
    if group is None:
        return x
    return _AllReduceMean.apply(x, group)
