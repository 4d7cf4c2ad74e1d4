"""Flash attention forward -- CUDA kernel K1 beside its plain version.

The PyTorch counterpart of ``dtf_tpu/ops/flash_attention.py``, forward
only.  ``flash_forward`` returns ``(o, lse)`` -- lse natural-log float32
[B*H, Sq], the residual contract of the JAX ``_flash_fwd`` -- and
``flash_attention`` returns o.  q/k/v are [B, S, H, D].

Dispatch is by device, never by fallback: a CUDA tensor goes to the
hand-written kernel (``csrc/flash_fwd.cu``), a CPU tensor to
:func:`flash_forward_plain`, the same online-softmax rule in plain
PyTorch (``ops.blockwise``).  The backward kernels come with the
training slice, so a CUDA tensor that requires grad raises rather than
differentiating through the plain version behind the caller's back.

The TPU's block rules do not carry over: no 1024-square default
blocks, no (8, 128) tile minimum -- the kernel has its own tile and
masks ragged sequence ends itself.  ``block_k`` sizes the plain
version's K/V blocks only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dtf_tpu_torch.ops import _build
from dtf_tpu_torch.ops import blockwise as bw

# launches of the CUDA kernel in this process -- a run shows with it
# that its path really went through the kernel
launches = 0

# the head dims of the registered transformer models
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_kernel_args(q, k, v) -> None:
    """What the kernel accepts; raises ValueError on anything else.
    Device-independent, so the CPU tests reach it too."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, D], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name}: kernel takes float32 or bfloat16, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must be on one device")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch, heads or head_dim")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {KERNEL_HEAD_DIMS}")


def flash_forward_plain(q, k, v, *, causal: bool, scale: float,
                        block_k: int = 64):
    """The kernel's function in plain PyTorch: K/V blocks folded into
    the f32 carry by ``bw.block_accumulate`` (operands in their own
    dtype, P rounded to v's dtype before P.V), the causal mask from
    positions counted from 0 for both q and k, a ragged last block.
    Returns (o [B, Sq, H, D] in q's dtype, lse float32 [B*H, Sq])."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), bw.NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    q_pos = torch.arange(sq, device=dev)
    for k0 in range(0, sk, block_k):
        k1 = min(k0 + block_k, sk)
        bias = (bw.causal_bias(q_pos, torch.arange(k0, k1, device=dev))
                if causal else None)
        o, m, l = bw.block_accumulate(o, m, l, qt, kt[:, :, k0:k1],
                                      vt[:, :, k0:k1], scale, bias)
    out = bw.finalize(o, l).to(q.dtype).transpose(1, 2)
    lse = (torch.clamp(m, min=bw.NEG_INF)
           + torch.log(torch.where(l == 0.0, torch.ones_like(l), l)))
    return out, lse.reshape(b * h, sq)


def _flash_forward_cuda(q, k, v, causal: bool, scale: float):
    global launches
    check_kernel_args(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or sk == 0:
        return o.zero_(), lse.fill_(bw.NEG_INF)
    fn = _build.load("flash_fwd")
    # the stream of the tensors' device, taken in the calling thread:
    # the serving engine launches from its own thread
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, sq, sk, d, KERNEL_DTYPES[q.dtype],
                 int(causal), ctypes.c_float(scale), stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return o, lse


def flash_forward(q, k, v, *, causal: bool = False,
                  scale: Optional[float] = None,
                  block_q: Optional[int] = None,
                  block_k: Optional[int] = None):
    """(o, lse) of softmax(q k^T scale) v; q/k/v [B, S, H, D].

    CUDA tensors run the kernel; CPU tensors the plain version (whose
    K/V blocks ``block_k`` sizes).  ``block_q`` is accepted for the JAX
    signature's sake: neither formulation tiles queries by it."""
    del block_q
    scale = float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5
    if q.is_cuda:
        if q.requires_grad or k.requires_grad or v.requires_grad:
            raise NotImplementedError(
                "backward kernels land with the training slice")
        return _flash_forward_cuda(q, k, v, causal, scale)
    return flash_forward_plain(q, k, v, causal=causal, scale=scale,
                               block_k=block_k or 64)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """Multi-head attention, flash-style; q, k, v [B, S, H, D] -> o."""
    return flash_forward(q, k, v, causal=causal, scale=scale,
                         block_q=block_q, block_k=block_k)[0]
