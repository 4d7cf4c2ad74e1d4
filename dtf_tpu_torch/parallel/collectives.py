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

``ring_shift`` (``lax.ppermute`` around the seq ring, the building
block of ``parallel/ring_attention.py``) is an autograd Function over
the seq group: shard i's tensor goes to shard (i + shift) % n, and the
backward sends the cotangent the other way, as autodiff through
``ppermute`` does.  Each rank posts its receive and its send together
(``batch_isend_irecv``) and waits for both, so no two ranks wait on each
other.  gloo moves CPU tensors only: a CUDA tensor on a gloo group (the
ranks that share one card) rides through a pinned host buffer each way,
as the model axis's all-reduces ride gloo through the host.  Every call
adds one to the default registry's ``ring_shift_calls`` and its
payload's bytes to ``ring_shift_bytes`` (``obs/registry.py``).

``all_to_all`` (the tiled ``lax.all_to_all`` over the data axis, expert
parallelism's token exchange, ``models/moe.py``) is an autograd
Function too: ``x`` is cut into n equal chunks along ``split_dim``,
chunk j goes to rank j, and the chunks received are joined along
``concat_dim`` in rank order -- [E, C, d] split on 0 and joined on 1 is
[E/n, n C, d], the slots ordered by their source rank.  Its backward is
the inverse exchange (split ``concat_dim``, join ``split_dim``).  NCCL
takes ``all_to_all_single``, which cuts dim 0 only, so the chunks are
moved to dim 0 around the call; a CUDA tensor on gloo rides pinned host
buffers both ways, as ``ring_shift``'s do.  Every call adds one to
``all_to_all_calls`` and the input's bytes to ``all_to_all_bytes``.

Not ported: ``axis_size``/``axis_index`` (``MeshRuntime`` holds the
ranks and sizes).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from dtf_tpu_torch.obs.registry import default_registry


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


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` from the rank ``shift`` places behind on the group's ring;
    this rank's ``x`` goes to the rank ``shift`` places ahead."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    reg = default_registry()
    reg.counter("ring_shift_calls").inc()
    reg.counter("ring_shift_bytes", "bytes").inc(x.numel() * x.element_size())
    x = x.contiguous()
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.cpu().pin_memory() if host else x
    recv = torch.empty_like(send, pin_memory=host)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.irecv, recv, src, group),
        dist.P2POp(dist.isend, send, dst, group)])
    for r in reqs:
        r.wait()
    return recv.to(x.device) if host else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift), None, None


def ring_shift(x: torch.Tensor, group: Optional[dist.ProcessGroup],
               shift: int = 1) -> torch.Tensor:
    """Rotate shards around the group's ring: rank i's ``x`` lands on
    rank (i + shift) % n (a new tensor; differentiable, the cotangent
    rotating back).  None: the identity."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _RingShift.apply(x, group, shift)


def _exchange(x: torch.Tensor, group, split_dim: int,
              concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all of ``x`` over ``group`` (a new tensor)."""
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} ({x.shape[split_dim]}"
                         f") not divisible by the group's {n} ranks")
    reg = default_registry()
    reg.counter("all_to_all_calls").inc()
    reg.counter("all_to_all_bytes", "bytes").inc(x.numel()
                                                  * x.element_size())
    # the chunks on dim 0, each contiguous: chunk j is rank j's
    send = x.movedim(split_dim, 0).contiguous()
    host = send.is_cuda and dist.get_backend(group) == "gloo"
    if host:
        send = send.cpu().pin_memory()
    recv = torch.empty_like(send, pin_memory=host)
    dist.all_to_all_single(recv, send, group=group)
    if host:
        recv = recv.to(x.device)
    parts = recv.chunk(n, 0)
    return torch.cat([p.movedim(0, split_dim) for p in parts], concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        group, split_dim, concat_dim = ctx.args
        return _exchange(grad, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group: Optional[dist.ProcessGroup],
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`` over ``group``: differentiable, its backward the
    inverse exchange.  None, or a group of one rank: the identity."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)
