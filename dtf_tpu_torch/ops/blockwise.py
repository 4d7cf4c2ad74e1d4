"""Online-softmax blockwise attention -- the shared math core.

The PyTorch counterpart of ``dtf_tpu/ops/blockwise.py``.  One
accumulation rule serves the flash forward (``ops.flash_attention``),
the paged decode (``ops.paged_attention``) and the tests (against
``mha_reference``); the two CUDA kernels apply the same rule per tile
(``csrc/attn_tile.cuh``).

The rule (Milakov & Gimelshein online softmax): carry the running row
max ``m``, the running denominator ``l`` and the un-normalized output
``o`` across K/V blocks; each block rescales the carry by
``exp(m_old - m_new)``.  Masked positions get the additive ``NEG_INF``
bias, never a post-hoc where -- so fully masked blocks are inert.

Internal layout is [batch, heads, seq, head_dim] ("BHSD").  Scores and
the carry are float32 whatever the inputs' dtype: products of bf16
values are exact in float32, which is what the JAX code's
``preferred_element_type=float32`` einsums compute.  Float64 inputs are
the one exception (:func:`acc_dtype`): they keep float64 throughout, an
exact reference to hold the float32 kernels to.
"""

from __future__ import annotations

from typing import Optional

import torch

# Large-but-finite mask bias: exp() of a masked score is exactly 0,
# and a fully masked row never computes -inf - -inf = nan.  Kept in
# float32 (in float16 -1e30 would overflow to -inf).
NEG_INF = -1e30


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of scores and sums for inputs of ``dtype``: float64 for
    float64, float32 for everything else."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def block_accumulate(o, m, l, q, k, v, scale: float, bias=None):
    """Fold one K/V block into the (o, m, l) carry.

    Shapes (BHSD layout): q [.., Sq, D], k/v [.., Sk, D], o [.., Sq, D],
    m/l [.., Sq]; ``bias`` broadcastable to [.., Sq, Sk] (additive,
    NEG_INF = masked).  Returns the updated (o, m, l); ``o`` stays
    un-normalized until :func:`finalize`."""
    acc = acc_dtype(q.dtype)
    s = torch.einsum("...qd,...kd->...qk", q.to(acc), k.to(acc)) * scale
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m, s.amax(dim=-1))
    # m_new is NEG_INF only while every block so far was fully masked;
    # clamp the subtrahend so exp() sees finite arguments
    m_safe = torch.clamp(m_new, min=NEG_INF)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(m - m_safe)
    l_new = l * corr + p.sum(dim=-1)
    # P.V at the value dtype's precision with f32 accumulation: for bf16
    # values p is rounded to bf16 first, the flash-attention trade the
    # kernels make; f32 callers are unchanged
    o_new = o * corr[..., None] + torch.einsum(
        "...qk,...kd->...qd", p.to(v.dtype).to(acc), v.to(acc))
    return o_new, m_new, l_new


def finalize(o, l):
    """Normalize the accumulated output; fully masked rows become 0."""
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return o / denom[..., None]


def causal_bias(q_pos, k_pos):
    """Additive causal mask from absolute positions: q_pos [Sq], k_pos
    [Sk] -> [Sq, Sk] float32, 0 where k_pos <= q_pos, NEG_INF elsewhere."""
    return torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                       NEG_INF).float()


def _to_bhsd(x):
    return x.transpose(-3, -2)


def mha_reference(q, k, v, *, causal: bool = False,
                  scale: Optional[float] = None):
    """Plain O(S^2)-memory attention, the numerical ground truth.

    q, k, v: [batch, seq, heads, head_dim]; computes in float32 and
    returns q's dtype."""
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    qt, kt, vt = (_to_bhsd(t).float() for t in (q, k, v))
    s = torch.einsum("...qd,...kd->...qk", qt, kt) * scale
    if causal:
        s = s + causal_bias(torch.arange(q.shape[-3], device=q.device),
                            torch.arange(k.shape[-3], device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("...qk,...kd->...qd", p, vt)
    return _to_bhsd(out).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None, block_k: int = 512,
                        q_offset=0, k_offset=0):
    """Memory-efficient attention: scans K/V in blocks of ``block_k``.

    q, k, v: [batch, seq, heads, head_dim].  ``q_offset``/``k_offset``
    are the absolute positions of q[.., 0, ..] and k[.., 0, ..] (ints or
    0-d tensors), so shards whose global position differs from their
    local index can reuse it.  Differentiable through autograd."""
    sq, sk = q.shape[-3], k.shape[-3]
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    block_k = min(block_k, sk)
    num_blocks, rem = divmod(sk, block_k)
    if rem:
        raise ValueError(f"kv length {sk} not divisible by block_k "
                         f"{block_k}")
    qt, kt, vt = (_to_bhsd(t).float() for t in (q, k, v))
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    o = torch.zeros_like(qt)
    m = torch.full(qt.shape[:-1], NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(qt.shape[:-1], dtype=torch.float32, device=dev)
    for i in range(num_blocks):
        sl = slice(i * block_k, (i + 1) * block_k)
        bias = None
        if causal:
            k_pos = k_offset + i * block_k + torch.arange(block_k,
                                                          device=dev)
            bias = causal_bias(q_pos, k_pos)
        o, m, l = block_accumulate(o, m, l, qt, kt[..., sl, :],
                                   vt[..., sl, :], scale, bias)
    return _to_bhsd(finalize(o, l)).to(q.dtype)
