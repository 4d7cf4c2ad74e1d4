"""Ring attention -- sequence parallelism over the seq group; the
PyTorch counterpart of ``dtf_tpu/parallel/ring_attention.py``.

The sequence dimension is sharded over the ranks of the seq group
(``runtime/mesh.py``): each rank owns one query shard and one K/V shard.
The K/V shards rotate around the ring (``parallel.collectives.
ring_shift``, the counterpart of ``lax.ppermute``), and each rank folds
every visiting K/V block into the online-softmax carry
(``ops.blockwise.block_accumulate``: the flash attention's rule, with
"block" = "shard").  After n steps every query has attended to the whole
global sequence; no [S, S] score matrix and no all-gather of K/V ever
exists.

Causal masking uses absolute positions: at step t a rank holds the K/V
shard that started on rank ``(idx - t) % n``, so a rotating shard is
masked by where it came from, not where it is.  A shard entirely in a
rank's future is masked (all ``NEG_INF``), not skipped, as in the JAX
package, and a row that every block so far masked stays finite (the
carry's clamp in ``block_accumulate``).  As in the JAX scan, the loop
takes n steps and rotates after each, so the last rotation's result is
unused (and autograd runs no backward for it).

The JAX package computes the ring outside any Pallas kernel, on its
``ops/blockwise``; so does this one, in plain torch, the carry in
float32, autograd supplying the backward (each ``ring_shift`` sends the
cotangent back the other way).  Under the MFU ledger's count
(``obs/ledger.py``) it reports the operations it performs: every block
whole (a masked block is computed too), two products forward and four
backward (autograd keeps P, so nothing is recomputed).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from dtf_tpu_torch.obs import ledger
from dtf_tpu_torch.ops import blockwise as bw
from dtf_tpu_torch.parallel.collectives import ring_shift


def ring_attention(q, k, v, group: Optional[dist.ProcessGroup], *,
                   causal: bool = False, scale: Optional[float] = None):
    """Attention over a sequence-sharded q/k/v: this rank's shards
    [batch, seq_shard, heads, head_dim] of globally [batch, seq, heads,
    head_dim] arrays sharded over ``group`` in rank order.  Returns the
    local output shard, shaped and typed as q.  ``group`` None: one
    shard, plain blockwise attention over it."""
    orig_dtype = q.dtype
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    n = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    s_loc = q.shape[-3]
    dev = q.device
    acc = bw.acc_dtype(q.dtype)
    to_bhsd = lambda x: x.transpose(-3, -2).to(acc)
    qt = to_bhsd(q)
    q_pos = idx * s_loc + torch.arange(s_loc, device=dev)
    o = torch.zeros_like(qt)
    m = torch.full(qt.shape[:-1], bw.NEG_INF, dtype=acc, device=dev)
    l = torch.zeros(qt.shape[:-1], dtype=acc, device=dev)
    if ledger.counting():
        b, _, h, d = q.shape
        grad = torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v))
        ledger.kernel_ops(2 * (2 + 4 * grad) * d * b * h * s_loc * s_loc * n)
    kc, vc = k, v
    for t in range(n):
        bias = None
        if causal:
            src = (idx - t) % n          # the shard kc holds at step t
            k_pos = src * s_loc + torch.arange(s_loc, device=dev)
            bias = bw.causal_bias(q_pos, k_pos).to(acc)
        o, m, l = bw.block_accumulate(o, m, l, qt, to_bhsd(kc),
                                      to_bhsd(vc), scale, bias)
        # K and V move on to the next rank of the ring
        kc = ring_shift(kc, group, 1)
        vc = ring_shift(vc, group, 1)
    return bw.finalize(o, l).transpose(-3, -2).to(orig_dtype)


def ring_self_attention(q, k, v, group: Optional[dist.ProcessGroup], *,
                        causal: bool = False,
                        scale: Optional[float] = None):
    """Ring attention over globally shaped [B, S, H, D] q/k/v, which
    every rank of ``group`` holds whole: each rank takes its sequence
    shard (rank i: rows [i S/n, (i+1) S/n)), runs the ring and returns
    its output shard [B, S/n, H, D].  Differentiable."""
    n = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    s = q.shape[-3]
    if s % n:
        raise ValueError(f"sequence {s} not divisible by the ring's {n} "
                         f"ranks")
    rows = slice(idx * (s // n), (idx + 1) * (s // n))
    return ring_attention(q[:, rows], k[:, rows], v[:, rows], group,
                          causal=causal, scale=scale)
