"""ZeRO weight-update sharding -- the PyTorch counterpart of
``dtf_tpu/train/zero.py``: the per-leaf layout and the collective
helpers behind stages 1-3 (PAPERS.md: Xu et al. 2020, arXiv
2004.13336).

One layout contract, used by the train step (``train/loop.py``), the
stage-3 parameter store and the canonical-checkpoint conversions: a
leaf's ZeRO slice is a padded flat buffer -- the leaf flattened,
zero-padded to nd * k and cut into nd chunks of k, rank r holding chunk
r (the JAX ``PartitionSpec('data')``).  The data axis is the runtime's
process group (``runtime/mesh.py``); None is world 1.

The padding is zeros at init and stays zero under the optimizers the
port has (SGD, momentum, AdamW: zero gradients in, zero updates out),
which is what makes dropping and re-creating it across a checkpoint
round trip exact.  Every leaf here is a parameter of this rank's model
or its optimizer moment; the step count stays whole in both layouts.
Under tensor parallelism a leaf is the rank's model shard, and it is
that local tensor which is sliced over the data group: each (data,
model) coordinate owns one slice of its model shard, the JAX layout.
Under sequence parallelism the slices are replicated over the seq axis:
each seq rank of a (data, model) coordinate holds the same slice, and a
gradient's slice is the data group's reduce-scatter averaged over the
seq group (the JAX ``pmean`` over 'seq' after the ``psum_scatter``).
A MoE expert leaf on the data axis (``expert=True``; ``models/moe.py``)
is already sharded over it -- each data rank holds distinct experts --
so it keeps its local shape at every stage: it is neither sliced nor
gathered, and its gradient is averaged over the seq group and divided
by nd, not reduce-scattered (reverse-mode all_to_all has already summed
it over the data group), in float32 whatever ``--zero_wire``.

``comm_off=True`` replaces each collective with a local op of the same
output shape (the values are garbage).  It exists for one purpose: the
``--zero_probe`` timing twin, a step whose wall time is the step minus
its data-axis collectives, so the exposed communication is a measured
number.  Never use a comm_off result as state.
"""

from __future__ import annotations

from typing import Optional

import torch

from dtf_tpu_torch.parallel.collectives import (all_gather, all_reduce_mean,
                                                reduce_scatter)


def slice_len(numel: int, nd: int) -> int:
    """k: the length of each of the nd slices of a leaf of ``numel``."""
    return -(-numel // nd)


def pad_flat(p: torch.Tensor, nd: int) -> torch.Tensor:
    """Flatten and zero-pad to a multiple of ``nd`` (the slice grid);
    the padding lives at the tail and is trimmed off after a gather."""
    flat = p.reshape(-1)
    pad = nd * slice_len(flat.numel(), nd) - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    return flat


def slice_view(p: torch.Tensor, nd: int, idx: int,
               expert: bool = False) -> torch.Tensor:
    """Rank ``idx``'s ZeRO slice of a full leaf: a view of a
    contiguous leaf that needs no padding, else of its padded copy; an
    expert leaf itself."""
    if expert:
        return p
    flat = pad_flat(p, nd)
    k = flat.numel() // nd
    return flat[idx * k:(idx + 1) * k]


def slice_leaf(p: torch.Tensor, nd: int, idx: int,
               expert: bool = False) -> torch.Tensor:
    """Rank ``idx``'s ZeRO slice of a full leaf (a new tensor)."""
    return slice_view(p, nd, idx, expert).clone()


def gather_leaf(s: torch.Tensor, shape, dtype, nd: int, group,
                comm_off: bool = False, expert: bool = False
                ) -> torch.Tensor:
    """The full leaf (``shape``, ``dtype``) from its ZeRO slices: the
    stage-3 parameter all-gather, and the canonical-checkpoint
    re-gather (an expert leaf is its own slice: nothing to gather)."""
    if expert:
        return s.view(tuple(shape)).to(dtype)
    full = s.repeat(nd) if comm_off else all_gather(s, group)
    numel = 1
    for d in shape:
        numel *= d
    return full[:numel].view(tuple(shape)).to(dtype)


def scatter_leaf(g: torch.Tensor, nd: int, group, comm_off: bool = False,
                 idx: int = 0, wire=torch.float32, seq_group=None,
                 expert: bool = False) -> torch.Tensor:
    """Reduce-scatter one full gradient leaf into this rank's float32
    slice of the replicas' mean (over ``group``, the data axis, then
    averaged over ``seq_group``, the seq axis; None: no seq axis).

    ``wire`` is the reduce-scatter's dtype (``--zero_wire``): bf16
    halves the stage-2/3 scatter volume, and the collective then also
    sums in bf16 -- the documented trade.  The slice returned is float32
    whatever crossed the wire, so the accumulation carry and the
    optimizer's math keep full precision.  An expert leaf's gradient,
    already summed over the data group, is averaged over the seq group
    and divided by nd in float32."""
    if expert:
        g = g.float()
        if not comm_off:
            g = all_reduce_mean(g.clone(), seq_group)
        return g / nd
    flat = pad_flat(g.to(wire), nd)
    if comm_off:
        k = flat.numel() // nd
        return flat[idx * k:(idx + 1) * k].float() / nd
    return all_reduce_mean(reduce_scatter(flat, group).float() / nd,
                           seq_group)


def slice_zeros(p: torch.Tensor, nd: int,
                expert: bool = False) -> torch.Tensor:
    """float32 zeros shaped like :func:`scatter_leaf`'s output for the
    full leaf ``p``: the stage-2 gradient-accumulation carry and the
    ZeRO optimizer state's proto."""
    if expert:
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros((slice_len(p.numel(), nd),), dtype=torch.float32,
                       device=p.device)


def nbytes(tensors) -> int:
    """Bytes held by ``tensors`` (a list; None entries count 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def wire_dtype(name: Optional[str]) -> torch.dtype:
    """``--zero_wire``'s dtype: ``bf16`` or float32."""
    return torch.bfloat16 if name == "bf16" else torch.float32
