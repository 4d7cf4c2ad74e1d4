"""Collectives over the data and model axes -- the PyTorch
counterpart of ``dtf_tpu/parallel/collectives.py``.

The JAX package's collectives run inside ``shard_map`` over a mesh axis
name; here the axis is a ``torch.distributed`` process group and a
replica is a process.  Each function takes the group (``None``: world
1, and the function is the identity), works in place on one tensor and
returns it (``all_gather`` and ``reduce_scatter`` return new
tensors).

  reference mechanism                     -> here
  -------------------------------------------------------------------
  NCCL ring allreduce (Horovod)           -> all_reduce_sum / _mean
  hvd.BroadcastGlobalVariablesCallback(0) -> broadcast_from(root=0)
  lax.all_gather(tiled=True) over 'data'  -> all_gather
  lax.psum_scatter(tiled=True) over 'data'-> reduce_scatter

``all_gather`` and ``reduce_scatter`` (ZeRO's, ``train/zero.py``) pick
the call by the group's backend, never by what fails: NCCL takes
``all_gather_into_tensor`` and ``reduce_scatter_tensor``.  gloo has no
reduce-scatter for CUDA tensors, and the two ranks that share one card
run on gloo (``runtime/mesh.py``), so on gloo ``reduce_scatter`` is an
``all_reduce`` followed by the rank's own slice -- for CPU tensors too,
so the CPU tests run the path the card's ranks run -- and
``all_gather`` is the list form of ``all_gather``, which gloo has for
both devices.  A sum of two ranks' values does not depend on their
order, so at world 2 either form gives the reduce-scatter's bits.

:func:`all_reduce_mean_grad` is the differentiable form that sync
BatchNorm needs: the mean forward, and in backward the sum of the
cotangents over the group divided by its size -- ``lax.pmean``'s
transpose under ``shard_map``.

Tensor parallelism's pair (Megatron's f and g operators) are
``torch.autograd.Function``s over the model group, the counterparts of
the JAX ``custom_vjp``s:

  tp_region  identity forward, all-reduce (sum) backward: a
             column-parallel layer's input cotangent is partial, each
             shard back-propagating only its slice of the weight, so
             every parameter upstream (LayerNorm, embeddings) needs the
             sum;
  tp_psum    all-reduce (sum) forward, identity backward: the
             row-parallel output.  Not a raw all-reduce in both
             directions: that would multiply the upstream cotangent by
             the axis size at every layer.

Each takes the group (None: the identity both ways).  ``all_max`` is
``lax.pmax`` (no gradient), ``gather_dim`` the model axis's tiled
all-gather along one dimension (the checkpoint's full leaves).

Not ported yet: ``axis_size``/``axis_index`` (``MeshRuntime`` holds the
ranks and sizes) and ``ring_shift``, which waits for ring attention.
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


def all_gather(x: torch.Tensor,
               group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The group's ``x`` (1-d, one per rank) concatenated in rank
    order: ``lax.all_gather(x, axis=0, tiled=True)``."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((n * x.numel(),))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def reduce_scatter(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """This rank's slice of the group's elementwise sum of ``x`` (1-d,
    its length a multiple of the group's size):
    ``lax.psum_scatter(x, scatter_dimension=0, tiled=True)``."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    k = x.numel() // n
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((k,))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out
    # gloo: an all-reduce, then the rank's own slice
    total = x.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    rank = dist.get_rank(group)
    return total[rank * k:(rank + 1) * k].clone()


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


def all_max(x: torch.Tensor,
            group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The group's elementwise maximum of ``x``, in place (no
    gradient: ``lax.pmax``)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_dim(x: torch.Tensor, dim: int,
               group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order:
    ``lax.all_gather(x, axis=dim, tiled=True)``."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the group's sum of ``x``."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _TpRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.group), None


class _TpPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_region(x: torch.Tensor,
              group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Enter a tensor-parallel region: identity forward, the group's sum
    of the cotangent backward (Megatron's f)."""
    if group is None:
        return x
    return _TpRegion.apply(x, group)


def tp_psum(x: torch.Tensor,
            group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Exit a tensor-parallel region: the group's sum forward, identity
    backward (Megatron's g)."""
    if group is None:
        return x
    return _TpPsum.apply(x, group)
