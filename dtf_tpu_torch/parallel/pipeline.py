"""GPipe-style pipeline parallelism over a process group -- the PyTorch
counterpart of ``dtf_tpu/parallel/pipeline.py``.

The JAX package runs the schedule as one ``lax.scan`` inside
``shard_map``: each tick computes one stage and rotates the activation
to the next shard with ``lax.ppermute``, and reverse-mode AD of the
scan is the backward schedule.  Here a stage is a rank of the pipeline
group (the model axis, ``runtime/mesh.py``), the scan is a Python loop
over the ticks, and the rotation is ``parallel.collectives.ring_shift``
(rank j's activation to rank (j + 1) % pp, the last stage's to the
first); autograd of the loop is the backward schedule, each
``ring_shift`` sending its cotangent back the other way.

Every rank runs every tick, bubble ticks included, on placeholder data,
and picks its input and writes its output with ``torch.where`` on a
flag it computes from (tick, stage): the JAX ``jnp.where``, term for
term.  That is what keeps the backward from hanging.  A rank that chose
its input with a Python ``if`` would drop the received activation from
its graph on the ticks it injects a microbatch; autograd would then
skip that ``ring_shift``'s backward on that rank while its neighbour
waits in the matching receive.  With the ``where`` every tick's output
feeds the next tick's ``ring_shift`` and its own output slot on every
rank, so each rank runs the same backward shifts in the same order --
all but the last tick's, whose received value no rank uses -- and the
bubble gets zero cotangents, as in JAX.

Semantics are the JAX package's: ``num_microbatches`` M flow through
pp stages in M + pp - 1 ticks (GPipe), or through 2 pp virtual stages
in 2 pp ceil(M / pp) + pp - 1 half-stage ticks (interleaved, Megatron's
two chunks a device).  The outputs are valid on the last stage and
zeros elsewhere; :func:`last_stage_broadcast` hands them to every stage
(each call adds one to the default registry's
``pipeline_broadcast_calls`` and its payload's bytes to
``pipeline_broadcast_bytes``, as ``ring_shift`` counts its own).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from dtf_tpu_torch.obs.registry import default_registry
from dtf_tpu_torch.parallel.collectives import ring_shift


def _flags(device):
    """The two condition tensors a tick picks from (a fill each, made
    once a schedule: a scalar copied from the host would synchronize
    the stream at every tick)."""
    return (torch.ones((), dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def _stage(group: Optional[dist.ProcessGroup]):
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _clip(i: int, m: int) -> int:
    return min(max(i, 0), m - 1)


def pipeline_spmd(stage_fn: Callable, x_microbatches,
                  group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Run ``stage_fn`` as this rank's pipeline stage of ``group``.

    stage_fn: activation -> activation, shape-preserving (this stage's
      stack of layers).
    x_microbatches: [M, microbatch, ...], the same on every stage (only
      stage 0 reads it).

    Returns [M, microbatch, ...]: the last stage's outputs on the last
    stage, zeros elsewhere."""
    pp, idx = _stage(group)
    xs = x_microbatches.unbind(0)
    m = len(xs)
    yes, no = _flags(x_microbatches.device)
    recv = torch.zeros_like(xs[0])
    outputs = [recv] * m
    for t in range(m + pp - 1):
        # stage 0 injects microbatch t (a clamped read on the drain
        # ticks, discarded downstream); the others take what they got
        out = stage_fn(torch.where(yes if idx == 0 else no,
                                   xs[_clip(t, m)], recv))
        # the last stage finishes microbatch t - (pp - 1) at tick t
        w = _clip(t - (pp - 1), m)
        valid = idx == pp - 1 and t >= pp - 1
        outputs[w] = torch.where(yes if valid else no, out, outputs[w])
        recv = ring_shift(out, group, 1)
    return torch.stack(outputs)


def pipeline_spmd_interleaved(stage_fn: Callable, x_microbatches,
                              group: Optional[dist.ProcessGroup]
                              ) -> torch.Tensor:
    """Two virtual stages a rank (interleaved GPipe): rank j runs
    virtual stages j and j + pp, so a microbatch circles the ring twice,
    through the rank's first layer chunk on lap 0 and its second on lap
    1.  2 pp ceil(M / pp) + pp - 1 ticks of half a stage each: the
    fill/drain bubble costs pp - 1 half ticks.

    Rank 0 injects microbatch b pp + r at tick 2 pp b + r; its lap-1
    activation comes back to rank 0 pp ticks later, in the block that
    injects nothing.  The lap at (rank j, tick t) is the parity of
    (t - j) // pp: a function of the tick alone, as in the JAX scan.

    stage_fn: (activation, lap) -> activation, ``lap`` in {0, 1}
      selecting the rank's layer chunk.
    Returns [M, microbatch, ...], valid on the last rank (which hosts
    the final virtual stage 2 pp - 1), zeros elsewhere."""
    pp, idx = _stage(group)
    xs = x_microbatches.unbind(0)
    m = len(xs)
    yes, no = _flags(x_microbatches.device)
    recv = torch.zeros_like(xs[0])
    outputs = [recv] * m
    ticks = 2 * pp * -(-m // pp) + pp - 1
    for t in range(ticks):
        tj = t - idx                      # ticks since this activation
        lap = (tj // pp) % 2 if tj >= 0 else 0
        inj = tj - lap * pp               # its injection tick at rank 0
        mb = inj - (inj // (2 * pp)) * pp
        inject = idx == 0 and lap == 0
        out = stage_fn(torch.where(yes if inject else no,
                                   xs[_clip(mb, m)], recv), lap)
        w = _clip(mb, m)
        valid = idx == pp - 1 and lap == 1 and tj >= 0 and 0 <= mb < m
        outputs[w] = torch.where(yes if valid else no, out, outputs[w])
        recv = ring_shift(out, group, 1)
    return torch.stack(outputs)


class _LastStageBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        reg = default_registry()
        reg.counter("pipeline_broadcast_calls").inc()
        reg.counter("pipeline_broadcast_bytes", "bytes").inc(
            x.numel() * x.element_size())
        pp, idx = _stage(group)
        ctx.last = idx == pp - 1
        out = x.contiguous().clone() if ctx.last else torch.zeros_like(
            x, memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else torch.zeros_like(grad)), None


def last_stage_broadcast(x: torch.Tensor,
                         group: Optional[dist.ProcessGroup]
                         ) -> torch.Tensor:
    """The last stage's ``x`` on every stage: the masked all-reduce over
    ``group`` forward; backward the cotangent on the last stage alone,
    at unit scale, with no collective (a plain all-reduce's backward
    would hand the pipeline pp times the cotangent, one copy per
    stage's identical loss).  None: the identity."""
    if group is None:
        return x
    return _LastStageBroadcast.apply(x, group)
