"""Flash attention -- CUDA kernels K1 (forward), K2a + K2b (the split
backward) and K3 (the fused backward), each beside its plain version.

The PyTorch counterpart of ``dtf_tpu/ops/flash_attention.py``.
``flash_forward`` returns ``(o, lse)`` -- lse natural-log float32
[B*H, Sq], the residual contract of the JAX ``_flash_fwd`` --
``flash_backward`` returns ``(dq, dk, dv)`` from those residuals, as
``_pallas_backward`` does, and ``flash_attention`` is the differentiable
op: a ``torch.autograd.Function`` whose forward runs K1 and saves
``(q, k, v, o, lse)``, and whose backward runs K3, or K2a + K2b, on
them.  q/k/v are [B, S, H, D].

Dispatch is by device, never by fallback: a CUDA tensor goes to the
hand-written kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
``csrc/flash_bwd_fused.cu``) or raises, a CPU tensor to the plain
versions -- the same tile arithmetic in plain PyTorch.  No gradient is
ever taken by autograd through the plain forward.  Inside the C entry
points of every flash kernel -- K1, K2a, K2b and K3 -- the dtype picks
the route, and neither route stands in for the other: bfloat16 runs
the tensor-core kernels (wgmma: ``csrc/flash_fwd_tc.cuh`` K1,
``csrc/flash_bwd_dq_tc.cuh`` K2a, ``csrc/flash_bwd_tc.cuh`` K2b and K3).
float32 runs all four on the tensor cores too, in split products
(``csrc/flash_fwd_x3.cuh`` K1, ``csrc/flash_bwd_dq_x3.cuh`` K2a,
``csrc/flash_bwd_x3.cuh`` K2b and K3): each operand is the sum of two
TF32 halves and each product three TF32 products (``csrc/tf32x3.cuh``),
about 7e-7 from exact per term, summed in short chains folded into f32
sums (the tensor core truncates its own sums), so the f32 route stays
inside 1e-5 of the exact plain versions -- a single TF32 product would
keep three digits, and is used nowhere.  Their bound is the tensor
cores' 165 TFLOP/s of such f32-accurate work (495 TFLOP/s of TF32 over
three products).  On the card the exact reference is the plain
versions, run with TF32 off (``runtime/device.py``).

The backward keeps the JAX formulation choice: ``fused_bwd=None`` picks
the single-pass K3 when Sq == Sk and the TPU kernel's [Sq, D] f32 dq
scratch would fit its 2 MB VMEM gate (Sq * D * 4 bytes), else the split
pair -- the same shape takes the same formulation as in the reference.

The TPU's block rules do not carry over: no 1024-square default
blocks, no (8, 128) tile minimum -- the kernels have their own tiles and
mask ragged sequence ends themselves.  ``block_k`` sizes the plain
forward's K/V blocks only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dtf_tpu_torch.ops import _build
from dtf_tpu_torch.ops import blockwise as bw

# launches of each CUDA kernel in this process -- a run shows with them
# that its path really went through the kernels: K1, K2a, K2b, K3
launches = 0
launches_dq = 0
launches_dkdv = 0
launches_fused = 0

# the head dims of the registered transformer models
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# exp(x) = exp2(x log2 e): the backward recomputes probabilities in base 2
# from lse * LOG2E, as the JAX kernels do
LOG2E = 1.4426950408889634

# the JAX package's gate for the fused backward: its [Sq, D] f32 dq
# scratch must fit 2 MB of VMEM (dtf_tpu/ops/flash_attention.py)
FUSED_DQ_SCRATCH_MAX = 2 * 1024 * 1024

# tile edge of the plain backward versions; any size gives the same
# function, the sums only run in another order
PLAIN_BWD_BLOCK = 128

# keys per dq partial slot of K3: both routes walk 128-key blocks
# (csrc/flash_bwd_x3.cuh, csrc/flash_bwd_tc.cuh), and the C entry point
# dtf_flash_bwd_fused_partial_floats counts the same slots
FUSED_SLOT_KEYS = {torch.float32: 128, torch.bfloat16: 128}


def check_kernel_args(q, k, v, *more) -> None:
    """What the kernels accept; raises ValueError on anything else.
    ``more`` are further [B, S, H, D] tensors that must match q (dO for
    the backward).  Device-independent, so the CPU tests reach it too."""
    named = [("q", q), ("k", k), ("v", v)] + [
        (f"arg{i + 3}", t) for i, t in enumerate(more)]
    for name, t in named:
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
    if len({t.dtype for _, t in named}) != 1:
        raise ValueError(f"q/k/v dtypes differ: "
                         f"{', '.join(str(t.dtype) for _, t in named)}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("q/k/v must be on one device")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch, heads or head_dim")
    for i, t in enumerate(more):
        if t.shape != q.shape:
            raise ValueError(f"arg{i + 3} {tuple(t.shape)} does not match "
                             f"q {tuple(q.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {KERNEL_HEAD_DIMS}")


def _check_rows(name, t, b, h, sq) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != (b * h, sq)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 [B*H, Sq] = "
                         f"{(b * h, sq)}, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# forward: K1
# ---------------------------------------------------------------------------

def flash_forward_plain(q, k, v, *, causal: bool, scale: float,
                        block_k: int = 64):
    """The kernel's function in plain PyTorch: K/V blocks folded into
    the f32 carry by ``bw.block_accumulate`` (operands in their own
    dtype, P rounded to v's dtype before P.V), the causal mask from
    positions counted from 0 for both q and k, a ragged last block.
    Returns (o [B, Sq, H, D] in q's dtype, lse float32 [B*H, Sq]); for
    float64 inputs everything is float64 (``bw.acc_dtype``)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    acc = bw.acc_dtype(q.dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    o = torch.zeros((b, h, sq, d), dtype=acc, device=dev)
    m = torch.full((b, h, sq), bw.NEG_INF, dtype=acc, device=dev)
    l = torch.zeros((b, h, sq), dtype=acc, device=dev)
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


def _stream(t):
    # the stream of the tensors' device, taken in the calling thread:
    # the serving engine launches from its own thread
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, what):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


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
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, sq, sk, d, KERNEL_DTYPES[q.dtype],
                 int(causal), ctypes.c_float(scale), _stream(q))
    _raise_on(err, "flash_fwd")
    launches += 1
    return o, lse


def flash_forward(q, k, v, *, causal: bool = False,
                  scale: Optional[float] = None,
                  block_q: Optional[int] = None,
                  block_k: Optional[int] = None):
    """(o, lse) of softmax(q k^T scale) v; q/k/v [B, S, H, D].  Not
    differentiable: :func:`flash_attention` is.

    CUDA tensors run the kernel; CPU tensors the plain version (whose
    K/V blocks ``block_k`` sizes).  ``block_q`` is accepted for the JAX
    signature's sake: neither formulation tiles queries by it."""
    del block_q
    scale = float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5
    with torch.no_grad():
        if q.is_cuda:
            return _flash_forward_cuda(q, k, v, causal, scale)
        return flash_forward_plain(q, k, v, causal=causal, scale=scale,
                                   block_k=block_k or 64)


# ---------------------------------------------------------------------------
# backward: K2a (dq), K2b (dk, dv), K3 (all three in one walk)
# ---------------------------------------------------------------------------

def _bwd_plain(q, k, v, do, lse, delta, causal, scale, want_dq,
               want_dkdv, block):
    """The backward kernels' tile arithmetic in plain PyTorch, over
    ``block``-square tiles: dead causal tiles skipped, the mask (the
    finite NEG_INF, replacing the score) only on tiles the diagonal
    crosses, probabilities recomputed in base 2 from lse * LOG2E with
    exp2, dS = p (dp - delta) scale rounded to q's dtype before both its
    products, p rounded to dO's dtype before the dv product, f32 sums,
    outputs in the inputs' dtypes (float64 inputs keep float64 sums,
    ``bw.acc_dtype``).  Rows and keys of a ragged last tile are simply
    absent."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    acc = bw.acc_dtype(q.dtype)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    lse2 = (lse * LOG2E).reshape(b, h, sq)
    delta = delta.reshape(b, h, sq)
    dq = (torch.zeros((b, h, sq, d), dtype=acc, device=dev)
          if want_dq else None)
    dk = dv = None
    if want_dkdv:
        dk = torch.zeros((b, h, sk, d), dtype=acc, device=dev)
        dv = torch.zeros_like(dk)
    for q0 in range(0, sq, block):
        q1 = min(q0 + block, sq)
        q_t, do_t = qt[:, :, q0:q1].to(acc), dot[:, :, q0:q1].to(acc)
        for k0 in range(0, sk, block):
            if causal and k0 > q1 - 1:
                break                              # dead: past the diagonal
            k1 = min(k0 + block, sk)
            k_t, v_t = kt[:, :, k0:k1].to(acc), vt[:, :, k0:k1].to(acc)
            s2 = torch.einsum("bhqd,bhkd->bhqk", q_t, k_t) * (scale * LOG2E)
            if causal and k1 - 1 > q0:             # the diagonal crosses
                keep = (torch.arange(q0, q1, device=dev)[:, None]
                        >= torch.arange(k0, k1, device=dev)[None, :])
                s2 = torch.where(keep, s2, bw.NEG_INF)
            p = torch.exp2(s2 - lse2[:, :, q0:q1, None])
            dp = torch.einsum("bhqd,bhkd->bhqk", do_t, v_t)
            ds = (p * (dp - delta[:, :, q0:q1, None]) * scale).to(
                q.dtype).to(acc)
            if want_dq:
                dq[:, :, q0:q1] += torch.einsum("bhqk,bhkd->bhqd", ds, k_t)
            if want_dkdv:
                p_r = p.to(do.dtype).to(acc)
                dv[:, :, k0:k1] += torch.einsum("bhqk,bhqd->bhkd", p_r, do_t)
                dk[:, :, k0:k1] += torch.einsum("bhqk,bhqd->bhkd", ds, q_t)

    def out(x, like):
        return None if x is None else x.to(like.dtype).transpose(
            1, 2).contiguous()

    return out(dq, q), out(dk, k), out(dv, v)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool,
                       scale: float, block: int = PLAIN_BWD_BLOCK):
    """K2a's function: dq [B, Sq, H, D] in q's dtype.  lse (natural log)
    and delta = rowsum(dO * o) are float32 [B*H, Sq]."""
    return _bwd_plain(q, k, v, do, lse, delta, causal, scale, True, False,
                      block)[0]


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, *, causal: bool,
                         scale: float, block: int = PLAIN_BWD_BLOCK):
    """K2b's function: (dk, dv) [B, Sk, H, D] in k's and v's dtypes."""
    return _bwd_plain(q, k, v, do, lse, delta, causal, scale, False, True,
                      block)[1:]


def flash_bwd_fused_plain(q, k, v, do, lse, delta, *, causal: bool,
                          scale: float, block: int = PLAIN_BWD_BLOCK):
    """K3's function: (dq, dk, dv) from one walk of the tiles."""
    return _bwd_plain(q, k, v, do, lse, delta, causal, scale, True, True,
                      block)


def _bwd_launch_args(q, k, v, do, lse, delta, causal, scale):
    check_kernel_args(q, k, v, do)
    b, sq, h, d = q.shape
    _check_rows("lse", lse, b, h, sq)
    _check_rows("delta", delta, b, h, sq)
    lse2 = lse * LOG2E
    scale_log2e = ctypes.c_float(scale * LOG2E)
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse2, delta)]
    tail = [b, h, sq, k.shape[1], d, KERNEL_DTYPES[q.dtype], int(causal),
            ctypes.c_float(scale), scale_log2e, _stream(q)]
    # lse2 is returned so the caller holds it until the launch is queued
    # (the caching allocator then orders any reuse after it on the stream)
    return ptrs, tail, lse2


def _empty_shapes(q, k) -> bool:
    return q.numel() == 0 or k.numel() == 0


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """K2a on CUDA tensors (raises on anything it does not take), its
    plain version on CPU tensors."""
    global launches_dq
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                  scale=scale)
    dq = torch.empty_like(q)
    if _empty_shapes(q, k):
        check_kernel_args(q, k, v, do)
        return dq.zero_()
    ptrs, tail, lse2 = _bwd_launch_args(q, k, v, do, lse, delta, causal,
                                        scale)
    fn = _build.load("flash_bwd_dq")
    with torch.cuda.device(q.device):
        err = fn(*ptrs, dq.data_ptr(), *tail)
    _raise_on(err, "flash_bwd_dq")
    launches_dq += 1
    return dq


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """K2b on CUDA tensors, its plain version on CPU tensors."""
    global launches_dkdv
    if not q.is_cuda:
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, causal=causal,
                                    scale=scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _empty_shapes(q, k):
        check_kernel_args(q, k, v, do)
        return dk.zero_(), dv.zero_()
    ptrs, tail, lse2 = _bwd_launch_args(q, k, v, do, lse, delta, causal,
                                        scale)
    fn = _build.load("flash_bwd_dkdv")
    with torch.cuda.device(q.device):
        err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail)
    _raise_on(err, "flash_bwd_dkdv")
    launches_dkdv += 1
    return dk, dv


def fused_partial_floats(b: int, h: int, sq: int, sk: int, d: int,
                         dtype) -> int:
    """f32 floats of K3's dq partial buffer: one [B*H, Sq, D] slot per
    key tile of ``FUSED_SLOT_KEYS[dtype]`` keys.  The C entry point
    ``dtf_flash_bwd_fused_partial_floats`` computes the same, and the
    kernel refuses a smaller buffer."""
    return -(-sk // FUSED_SLOT_KEYS[dtype]) * b * h * sq * d


def fused_partial_bytes(q, k) -> int:
    """Bytes of K3's f32 dq partial buffer for these tensors."""
    b, sq, h, d = q.shape
    return 4 * fused_partial_floats(b, h, sq, k.shape[1], d, q.dtype)


def flash_bwd_fused(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """K3 on CUDA tensors (both of its passes), its plain version on CPU
    tensors.  Returns (dq, dk, dv)."""
    global launches_fused
    if not q.is_cuda:
        return flash_bwd_fused_plain(q, k, v, do, lse, delta, causal=causal,
                                     scale=scale)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _empty_shapes(q, k):
        check_kernel_args(q, k, v, do)
        return dq.zero_(), dk.zero_(), dv.zero_()
    ptrs, tail, lse2 = _bwd_launch_args(q, k, v, do, lse, delta, causal,
                                        scale)
    partial = torch.empty(fused_partial_bytes(q, k) // 4,
                          dtype=torch.float32, device=q.device)
    fn = _build.load("flash_bwd_fused")
    with torch.cuda.device(q.device):
        err = fn(*ptrs, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 partial.data_ptr(), partial.numel(), *tail)
    _raise_on(err, "flash_bwd_fused")
    launches_fused += 1
    return dq, dk, dv


def use_fused_backward(sq: int, sk: int, d: int,
                       fused: Optional[bool] = None) -> bool:
    """The JAX package's rule (``_pallas_backward``): ``fused`` forces a
    formulation; None picks K3 when Sq == Sk and Sq * D * 4 bytes fit
    FUSED_DQ_SCRATCH_MAX."""
    if fused is not None:
        return bool(fused)
    return sq == sk and sq * d * 4 <= FUSED_DQ_SCRATCH_MAX


def flash_backward(q, k, v, o, lse, do, *, causal: bool, scale: float,
                   fused: Optional[bool] = None):
    """(dq, dk, dv) from the forward's residuals (q, k, v, o, lse) and
    the output gradient dO, all [B, S, H, D] but lse [B*H, Sq] f32.
    delta = rowsum(dO * o) in f32 is a plain op, as in the JAX package;
    then K3 or K2a + K2b (see :func:`use_fused_backward`)."""
    b, sq, h, d = q.shape
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        b * h, sq).contiguous()
    if use_fused_backward(sq, k.shape[1], d, fused):
        return flash_bwd_fused(q, k, v, do, lse, delta, causal=causal,
                               scale=scale)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, causal=causal,
                            scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """o = flash attention of (q, k, v); the backward from the saved
    (q, k, v, o, lse) through the backward kernels (their plain versions
    on the CPU), never through autograd of the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_k, fused_bwd):
        o, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                               block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.fused_bwd = causal, scale, fused_bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over a strided gradient (a view's backward)
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    causal=ctx.causal, scale=ctx.scale,
                                    fused=ctx.fused_bwd)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    fused_bwd: Optional[bool] = None):
    """Multi-head attention, flash-style; q, k, v [B, S, H, D] -> o.

    Differentiable: the backward runs K3 or K2a + K2b (``fused_bwd``
    None = the JAX package's auto rule, True/False = force)."""
    del block_q
    scale = float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5
    return _FlashAttention.apply(q, k, v, causal, scale, block_k,
                                 fused_bwd)
