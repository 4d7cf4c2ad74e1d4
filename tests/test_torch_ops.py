"""The port's attention ops (dtf_tpu_torch.ops) against the JAX package.

Inputs come from a numpy seed and go through both packages.  JAX
functions that reach a Pallas kernel run as the JAX package's own tests
run them on the CPU: ``_pallas_forward(..., interpret=True)``,
``_pallas_backward(..., interpret=True)`` and
``paged_flash_decode(..., interpret=True)``.  On the CPU the port's
wrappers run their kernels' plain versions, which is what is held to
the kernels' JAX oracles here; the CUDA kernels themselves are held to
the plain versions on the card (``chip_smoke.py`` and the ``cuda``
tests below).

Tolerances: float32 at 1e-5 (the sums run in another order than XLA's),
plus argmax equality; against the plain-JAX backward oracle
``_blockwise_bwd`` 1e-4, its own tolerance in the JAX tests; the page
writes and gathers are exact.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.ops import blockwise as jbw
from dtf_tpu_torch.ops import _build
from dtf_tpu_torch.ops import blockwise as tbw
from dtf_tpu_torch.ops import flash_attention as tfa
from dtf_tpu_torch.ops import paged_attention as tpa

# the modules, not the functions dtf_tpu.ops re-exports under their names
jfa = importlib.import_module("dtf_tpu.ops.flash_attention")
jpa = importlib.import_module("dtf_tpu.ops.paged_attention")

torch.set_num_threads(1)

TOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# blockwise: the shared math core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_matches_jax(causal):
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 2, 12, 3, 16) for _ in range(3))
    port = tbw.mha_reference(*map(torch.from_numpy, (q, k, v)),
                             causal=causal)
    _close(port, jbw.mha_reference(q, k, v, causal=causal))


@pytest.mark.parametrize("causal,q_offset,k_offset,block_k",
                         [(True, 0, 0, 4), (False, 0, 0, 16),
                          (True, 8, 0, 8), (True, 0, 4, 4),
                          (False, 5, 3, 2)])
def test_blockwise_attention_matches_jax(causal, q_offset, k_offset,
                                         block_k):
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 2, 16, 2, 8) for _ in range(3))
    port = tbw.blockwise_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, block_k=block_k,
        q_offset=q_offset, k_offset=k_offset)
    ref = jbw.blockwise_attention(q, k, v, causal=causal, block_k=block_k,
                                  q_offset=q_offset, k_offset=k_offset)
    _close(port, ref)


def test_blockwise_rejects_ragged_block():
    x = torch.zeros(1, 10, 1, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tbw.blockwise_attention(x, x, x, block_k=4)


def test_block_accumulate_and_finalize_match_jax_with_masked_rows():
    """A block whose bias masks whole rows leaves those rows' carry at
    (0, NEG_INF, 0), and finalize turns them into exact zeros."""
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 1, 4, 8), _rand(rng, 1, 6, 8), _rand(rng, 1, 6, 8)
    bias = np.zeros((4, 6), np.float32)
    bias[1:3] = tbw.NEG_INF                       # rows 1, 2 fully masked
    bias[0, 3:] = tbw.NEG_INF
    o0 = np.zeros((1, 4, 8), np.float32)
    m0 = np.full((1, 4), tbw.NEG_INF, np.float32)
    l0 = np.zeros((1, 4), np.float32)
    po, pm, pl = tbw.block_accumulate(
        *map(torch.from_numpy, (o0, m0, l0, q, k, v)), 0.5,
        torch.from_numpy(bias))
    jo, jm, jl = jbw.block_accumulate(o0, m0, l0, q, k, v, 0.5, bias)
    for p, j in ((po, jo), (pm, jm), (pl, jl)):
        _close(p, j)
    # fully masked rows carry p = exp(NEG_INF - NEG_INF) = 1 per key; a
    # real block later rescales them away (corr = 0).  finalize of a
    # zero denominator gives exact zeros:
    out = tbw.finalize(torch.zeros(1, 4, 8), torch.zeros(1, 4))
    assert torch.equal(out, torch.zeros(1, 4, 8))
    _close(tbw.finalize(po, pl), jbw.finalize(jo, jl))


def test_causal_bias_matches_jax():
    qp, kp = np.arange(3, 9), np.arange(0, 12)
    port = tbw.causal_bias(torch.from_numpy(qp), torch.from_numpy(kp))
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(jbw.causal_bias(qp, kp)))


# ---------------------------------------------------------------------------
# flash forward (K1's plain version) vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,block", [((2, 16, 2, 32), 8),
                                         ((1, 24, 3, 16), 8),
                                         ((1, 8, 1, 8), 8)])
def test_flash_forward_o_and_lse_match_pallas_interpret(shape, block,
                                                        causal):
    rng = np.random.default_rng(3)
    b, s, h, d = shape
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    scale = d ** -0.5
    po, plse = tfa.flash_forward(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal)

    def merge(x):
        return jnp.swapaxes(x, 1, 2).reshape(b * h, s, d)

    jo, jlse = jfa._pallas_forward(merge(q), merge(k), merge(v), scale,
                                   causal, block, block, True)
    jo = np.swapaxes(np.asarray(jo).reshape(b, h, s, d), 1, 2)
    _close(po, jo)
    _close(plse, jlse)
    assert tuple(plse.shape) == (b * h, s) and plse.dtype == torch.float32
    np.testing.assert_array_equal(po.numpy().argmax(-1), jo.argmax(-1))


@pytest.mark.parametrize("s", [1, 5, 13, 70])
def test_flash_attention_ragged_lengths_match_jax_reference(s):
    """The port takes any sequence length (ragged tails are masked,
    not rejected); the JAX oracle is mha_reference."""
    rng = np.random.default_rng(s)
    q, k, v = (_rand(rng, 1, s, 2, 16) for _ in range(3))
    port = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=True, block_k=8)
    _close(port, jbw.mha_reference(q, k, v, causal=True))


def test_flash_cross_attention_shapes_match_jax_reference():
    rng = np.random.default_rng(4)
    q = _rand(rng, 2, 6, 2, 8)
    k, v = _rand(rng, 2, 11, 2, 8), _rand(rng, 2, 11, 2, 8)
    port = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    _close(port, jbw.mha_reference(q, k, v))


# ---------------------------------------------------------------------------
# flash backward (K2a, K2b, K3's plain versions) vs the Pallas kernels
# ---------------------------------------------------------------------------

def _merge(x):                        # [B, S, H, D] -> [B*H, S, D]
    b, s, h, d = x.shape
    return np.swapaxes(x, 1, 2).reshape(b * h, s, d)


def _split(x, b, h):                  # [B*H, S, D] -> [B, S, H, D]
    x = np.asarray(x)
    return np.swapaxes(x.reshape(b, h, *x.shape[1:]), 1, 2)


def _bwd_case(shape, causal, seed, dtype=np.float32, sk=None):
    """Inputs, the JAX forward's residuals (o, lse) and the port's
    delta for one backward case; q/k/v/dO in ``dtype``; k and v hold
    ``sk`` keys where given (cross-length attention)."""
    rng = np.random.default_rng(seed)
    b, s, h, d = shape
    kv = (b, s if sk is None else sk, h, d)
    q, k, v, do = (_rand(rng, *x).astype(dtype)
                   for x in (shape, kv, kv, shape))
    jo, jlse = jfa._pallas_forward(*(_merge(x) for x in (q, k, v)),
                                   d ** -0.5, causal, 8, 8, True)
    o = _split(jo, b, h)
    lse = np.asarray(jlse)
    delta = (do.astype(np.float32) * o.astype(np.float32)).sum(-1)
    delta = np.swapaxes(delta, 1, 2).reshape(b * h, s)
    return q, k, v, do, o, lse, delta


def _t(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,block", [((2, 16, 2, 32), 8),
                                         ((1, 24, 3, 16), 16)])
@pytest.mark.parametrize("fused", [True, False])
def test_plain_backward_matches_pallas_interpret(shape, block, causal,
                                                 fused):
    """K3's plain version against ``_pallas_backward(fused=True)``, and
    K2a's + K2b's against ``fused=False``, at the Pallas kernels' block 8
    -- with the port's tiles of 16 ragged against S = 24."""
    b, s, h, d = shape
    q, k, v, do, o, lse, delta = _bwd_case(shape, causal, s + int(fused))
    scale = d ** -0.5
    ref = jfa._pallas_backward(*(_merge(x) for x in (q, k, v, o)), lse,
                               _merge(do), scale, causal, 8, 8, True,
                               fused=fused)
    args = [_t(x) for x in (q, k, v, do, lse, delta)]
    if fused:
        port = tfa.flash_bwd_fused_plain(*args, causal=causal, scale=scale,
                                         block=block)
    else:
        port = (tfa.flash_bwd_dq_plain(*args, causal=causal, scale=scale,
                                       block=block),
                *tfa.flash_bwd_dkdv_plain(*args, causal=causal, scale=scale,
                                          block=block))
    for p, r in zip(port, ref):
        assert p.dtype == torch.float32 and tuple(p.shape) == shape
        _close(p, _split(r, b, h))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(16, 24), (24, 16)])
def test_plain_split_backward_cross_length_matches_pallas_interpret(
        sq, sk, causal):
    """Cross-length attention, the split pair's own case under the auto
    rule: K2a's and K2b's plain versions against
    ``_pallas_backward(fused=False)`` at block 8, Sq < Sk and Sq > Sk,
    with the port's tiles of 16 ragged against 24.  Positions count from
    0 for queries and keys alike: under causal masking keys past the
    last query get zero dk and dv, and queries past the last key see
    every key."""
    shape = (2, sq, 2, 16)
    b, _, h, d = shape
    q, k, v, do, o, lse, delta = _bwd_case(shape, causal, sq + 2 * sk, sk=sk)
    scale = d ** -0.5
    ref = jfa._pallas_backward(*(_merge(x) for x in (q, k, v, o)), lse,
                               _merge(do), scale, causal, 8, 8, True,
                               fused=False)
    args = [_t(x) for x in (q, k, v, do, lse, delta)]
    port = (tfa.flash_bwd_dq_plain(*args, causal=causal, scale=scale,
                                   block=16),
            *tfa.flash_bwd_dkdv_plain(*args, causal=causal, scale=scale,
                                      block=16))
    for p, r, want in zip(port, ref, (q.shape, k.shape, v.shape)):
        assert p.dtype == torch.float32 and tuple(p.shape) == want
        _close(p, _split(r, b, h))
    if causal and sk > sq:
        assert not port[1][:, sq:].any() and not port[2][:, sq:].any()


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_blockwise_oracle(causal):
    """The formulation the port runs by default at this shape (the auto
    rule picks K3) against the plain-JAX oracle ``_blockwise_bwd``."""
    shape = (2, 32, 2, 16)
    b, s, h, d = shape
    q, k, v, do, o, lse, _ = _bwd_case(shape, causal, 40)
    scale = d ** -0.5
    ref = jfa._blockwise_bwd(*(_merge(x) for x in (q, k, v, o)), lse,
                             _merge(do), scale, causal, 8)
    port = tfa.flash_backward(*(_t(x) for x in (q, k, v, o, lse, do)),
                              causal=causal, scale=scale)
    for p, r in zip(port, ref):
        _close(p, _split(r, b, h), tol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_in_float64_match_pallas_interpret(causal):
    """Float64 inputs keep float64 through the plain versions -- the
    exact reference chip_smoke.py holds the f32 kernels to on peaked
    attention -- and land within the f32 gate of the Pallas kernels'
    f32 results, here with q scaled by 4 as there."""
    shape = (1, 40, 2, 32)
    b, s, h, d = shape
    q, k, v, do, o, lse, delta = _bwd_case(shape, causal, 70)
    q = q * 4
    jo, jlse = jfa._pallas_forward(*(_merge(x) for x in (q, k, v)),
                                   d ** -0.5, causal, 8, 8, True)
    o64, lse64 = tfa.flash_forward_plain(
        *(torch.from_numpy(x).double() for x in (q, k, v)), causal=causal,
        scale=d ** -0.5)
    assert o64.dtype == lse64.dtype == torch.float64
    _close(o64, _split(jo, b, h))
    _close(lse64, jlse)
    o = _split(jo, b, h)
    lse = np.array(jlse)
    delta = np.swapaxes((do * o).sum(-1), 1, 2).reshape(b * h, s)
    refs = _pallas_bwd_ref(q, k, v, do, o, lse, causal, fused=True)
    port = tfa.flash_bwd_fused_plain(
        *(torch.from_numpy(np.array(x)).double()
          for x in (q, k, v, do, lse, delta)),
        causal=causal, scale=d ** -0.5)
    assert all(p.dtype == torch.float64 for p in port)
    assert _grad_gap(port, refs) <= 1.0


def test_plain_backward_bf16_matches_pallas_interpret():
    """bf16 operands: dS rounded to q's dtype before both products, P to
    dO's before the dv product, outputs in bf16 -- the Pallas kernels'
    roundings.  Each output row (one position and head) within two bf16
    steps at its own largest |ref| (the f32 sums run in another order, so
    a rounding may land one step apart)."""
    shape = (1, 16, 2, 32)
    b, s, h, d = shape
    q, k, v, do, o, lse, delta = _bwd_case(shape, True, 41, jnp.bfloat16)
    scale = d ** -0.5
    for fused in (True, False):
        ref = jfa._pallas_backward(*(_merge(x) for x in (q, k, v, o)), lse,
                                   _merge(do), scale, True, 8, 8, True,
                                   fused=fused)
        port = tfa.flash_backward(*(_t(x) for x in (q, k, v, o, lse, do)),
                                  causal=True, scale=scale, fused=fused)
        for p, r in zip(port, ref):
            assert p.dtype == torch.bfloat16
            _assert_rows_close(p, torch.from_numpy(
                np.asarray(_split(r, b, h), np.float32)))


def test_plain_split_backward_bf16_cross_length_matches_pallas_interpret():
    """bf16 at Sq 16 / Sk 24, causal, through ``flash_backward``'s auto
    rule (the split pair) against ``_pallas_backward(fused=False)``
    under the backward's row rule (:func:`_assert_grads_close`): each
    output row within two bf16 steps at its own largest |ref|, floored
    at 2^-8 of the output's largest |ref| -- causal dq's first row is
    exactly zero and comes out as f32 rounding noise."""
    shape = (1, 16, 2, 32)
    b, s, h, d = shape
    q, k, v, do, o, lse, delta = _bwd_case(shape, True, 43, jnp.bfloat16,
                                           sk=24)
    scale = d ** -0.5
    ref = jfa._pallas_backward(*(_merge(x) for x in (q, k, v, o)), lse,
                               _merge(do), scale, True, 8, 8, True,
                               fused=False)
    port = tfa.flash_backward(*(_t(x) for x in (q, k, v, o, lse, do)),
                              causal=True, scale=scale)
    for p, r in zip(port, ref):
        assert p.dtype == torch.bfloat16
        _assert_grads_close(p, torch.from_numpy(
            np.asarray(_split(r, b, h), np.float32)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fused_bwd", [None, True, False])
def test_flash_attention_grad_matches_jax_grad(causal, fused_bwd):
    """torch.autograd.grad through the port's autograd Function equals
    jax.grad through the JAX flash attention run by the Pallas
    interpreter, for a random linear loss."""
    rng = np.random.default_rng(50)
    shape = (2, 16, 2, 32)
    q, k, v, w = (_rand(rng, *shape) for _ in range(4))

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal=causal,
                                use_pallas="interpret", fused_bwd=fused_bwd)
        return jnp.sum(o * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal, fused_bwd=fused_bwd)
    _close(o.detach(), jfa.flash_attention(q, k, v, causal=causal,
                                           use_pallas="interpret"))
    port = torch.autograd.grad((o * torch.from_numpy(w)).sum(),
                               (tq, tk, tv))
    for p, r in zip(port, ref):
        _close(p, r)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(16, 24), (24, 8)])
def test_flash_attention_cross_length_grad_matches_jax_grad(sq, sk, causal,
                                                            monkeypatch):
    """At Sq != Sk the auto rule picks the split pair (K2a + K2b) -- K3
    is never called -- and the port's gradient equals jax.grad through
    the JAX flash attention run by the Pallas interpreter."""
    rng = np.random.default_rng(52 + sq + sk)
    q, w = (_rand(rng, 1, sq, 2, 32) for _ in range(2))
    k, v = (_rand(rng, 1, sk, 2, 32) for _ in range(2))

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal=causal,
                                use_pallas="interpret")
        return jnp.sum(o * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)

    def no_fused(*a, **kw):
        raise AssertionError("the auto rule took K3 at Sq != Sk")

    monkeypatch.setattr(tfa, "flash_bwd_fused", no_fused)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    port = torch.autograd.grad((o * torch.from_numpy(w)).sum(),
                               (tq, tk, tv))
    for p, r in zip(port, ref):
        _close(p, r)


def test_flash_attention_grad_takes_a_strided_output_gradient():
    """The output gradient autograd hands the backward can be a strided
    view; the Function makes it contiguous first."""
    rng = np.random.default_rng(51)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 8, 2, 16)).requires_grad_()
               for _ in range(3))
    o = tfa.flash_attention(q, k, v, causal=True)
    (o.transpose(1, 2) * torch.arange(8.0)[:, None]).sum().backward()
    want = torch.autograd.grad(
        (tfa.flash_attention(q, k, v, causal=True)
         * torch.arange(8.0)[None, :, None, None]).sum(), q)[0]
    _close(q.grad, want)


def test_fused_backward_rule_is_the_jax_rule():
    """K3 where Sq == Sk and the TPU kernel's [Sq, D] f32 scratch fits
    2 MB; the split pair otherwise; an explicit choice wins."""
    assert tfa.FUSED_DQ_SCRATCH_MAX == jfa._FUSED_DQ_SCRATCH_MAX
    assert tfa.use_fused_backward(2048, 2048, 128)
    assert tfa.use_fused_backward(4096, 4096, 128)
    assert not tfa.use_fused_backward(8192, 8192, 128)
    assert not tfa.use_fused_backward(2048, 1024, 128)
    assert tfa.use_fused_backward(2048, 1024, 128, fused=True)
    assert not tfa.use_fused_backward(64, 64, 64, fused=False)


def test_fused_partial_buffer_size_is_pinned():
    """K3's f32 dq partial buffer is a pure function of the shapes: one
    [B*H, Sq, D] slot per 128-key block on both routes (the float32
    split-product walk and the bfloat16 wgmma walk) -- 16 slots, 0.81 GB
    at the training shape [8, 2048, 6, 128]; the C entry point
    ``dtf_flash_bwd_fused_partial_floats`` counts the same (checked on
    the card by chip_smoke.py)."""
    per_slot = 8 * 6 * 2048 * 128
    assert tfa.FUSED_SLOT_KEYS == {torch.float32: 128, torch.bfloat16: 128}
    for dtype in (torch.bfloat16, torch.float32):
        assert tfa.fused_partial_floats(8, 6, 2048, 2048, 128,
                                        dtype) == 16 * per_slot
        q = torch.empty(8, 2048, 6, 128, dtype=dtype, device="meta")
        assert tfa.fused_partial_bytes(q, q) == 805_306_368
        # ragged keys round up to a whole slot; Sq counts rows, not slots
        assert tfa.fused_partial_floats(2, 3, 200, 200, 64,
                                        dtype) == 2 * 6 * 200 * 64
        assert tfa.fused_partial_floats(1, 1, 64, 129, 128,
                                        dtype) == 2 * 64 * 128
        assert tfa.fused_partial_floats(1, 1, 64, 128, 128,
                                        dtype) == 64 * 128


# ---------------------------------------------------------------------------
# the float32 routes of K1, K2a, K2b and K3: the split product, emulated
# on the CPU
# ---------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, the low 13 bits of the f32 pattern cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tc_einsum(eq, a, b, terms):
    """``torch.einsum(eq, a, b)`` of f32 operands as the f32 kernels'
    tensor cores form it: ``terms`` 3 is the split product a_lo b_hi +
    a_hi b_lo + a_hi b_hi (hi = TF32 of x, lo = TF32 of x - hi), the
    kernels' design; 1 a single TF32 product, which they never use."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if terms == 1:
        return torch.einsum(eq, a_hi, b_hi)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _tc_forward(q, k, v, causal, terms):
    """K1's float32 route with its products emulated: base-2 softmax of
    S = Q K^T, o = P V / l, lse = m ln 2 + log l; [B, S, H, D] in,
    (o [B, Sq, H, D], lse [B*H, Sq]) out."""
    b, sq, h, d = q.shape
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s = _tc_einsum("bhqd,bhkd->bhqk", qt, kt, terms) * (d ** -0.5
                                                       * tfa.LOG2E)
    if causal:
        s = s + tbw.causal_bias(torch.arange(sq), torch.arange(k.shape[1]))
    m = s.amax(-1).clamp_min(tbw.NEG_INF)
    p = torch.exp2(s - m[..., None])
    l = p.sum(-1)
    o = _tc_einsum("bhqk,bhkd->bhqd", p, vt, terms) / l[..., None]
    lse = m * math.log(2.0) + torch.log(l)
    return o.transpose(1, 2), lse.reshape(b * h, sq)


def _tc_backward(q, k, v, do, lse, delta, causal, terms,
                 grads=("dq", "dk", "dv")):
    """The float32 backward routes with their products emulated, the
    numerics of ``_bwd_tile``: p = exp2(s2 - lse log2 e), the mask a
    replacement by NEG_INF, dS = p (dp - delta) scale.  All three
    ``grads`` are K3's five products; ("dq",) K2a's three (S, dP, dQ),
    ("dk", "dv") K2b's four (S, dP, dK, dV)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    s2 = _tc_einsum("bhqd,bhkd->bhqk", qt, kt, terms) * (scale * tfa.LOG2E)
    if causal:
        keep = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s2 = torch.where(keep, s2, tbw.NEG_INF)
    p = torch.exp2(s2 - (lse * tfa.LOG2E).reshape(b, h, sq, 1))
    dp = _tc_einsum("bhqd,bhkd->bhqk", dot, vt, terms)
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * scale
    products = {"dq": lambda: _tc_einsum("bhqk,bhkd->bhqd", ds, kt, terms),
                "dk": lambda: _tc_einsum("bhqk,bhqd->bhkd", ds, qt, terms),
                "dv": lambda: _tc_einsum("bhqk,bhqd->bhkd", p, dot, terms)}
    return [products[g]().transpose(1, 2) for g in grads]


def _pallas_fwd_ref(q, k, v, causal):
    b, sq, h, d = q.shape
    jo, jlse = jfa._pallas_forward(*(_merge(x) for x in (q, k, v)),
                                   d ** -0.5, causal, 8, 8, True)
    return torch.from_numpy(_split(jo, b, h).copy()), torch.from_numpy(
        np.array(jlse))


def _forward_gap(o, lse, ref_o, ref_lse):
    """The f32 gate of K1 (chip_smoke.py): o within 1e-5 absolute, lse
    within 1e-5 of max(1, max |lse|); returns the worse error over its
    tolerance."""
    lse_tol = 1e-5 * max(1.0, float(ref_lse.abs().max()))
    return max(float((o - ref_o).abs().max()) / 1e-5,
               float((lse - ref_lse).abs().max()) / lse_tol)


def _grad_gap(outs, refs):
    """The f32 gate of K3 (chip_smoke.py grad_tolerance): each output
    within 1e-5 of max(1, its largest |ref|); the worst error over its
    tolerance."""
    return max(float((o - r).abs().max())
               / (1e-5 * max(1.0, float(r.abs().max())))
               for o, r in zip(outs, refs))


def _pallas_bwd_ref(q, k, v, do, o, lse, causal, fused):
    b, _, h, d = q.shape
    ref = jfa._pallas_backward(*(_merge(x) for x in (q, k, v, o)), lse,
                               _merge(do), d ** -0.5, causal, 8, 8, True,
                               fused=fused)
    return [torch.from_numpy(_split(r, b, h).copy()) for r in ref]


TC_SHAPES = [(24, 24), (16, 40), (40, 24)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", TC_SHAPES)
def test_split_product_forward_matches_pallas_interpret(sq, sk, d, causal):
    """K1's float32 route -- every product a 3xTF32 split product --
    against ``_pallas_forward(interpret=True)`` within the 1e-5 gate,
    at lengths ragged against the kernel's 128-row and 32-key tiles and
    at cross lengths."""
    rng = np.random.default_rng(200 + sq + sk + d)
    q = _rand(rng, 2, sq, 2, d)
    k, v = (_rand(rng, 2, sk, 2, d) for _ in range(2))
    o, lse = _tc_forward(*map(torch.from_numpy, (q, k, v)), causal, terms=3)
    assert _forward_gap(o, lse, *_pallas_fwd_ref(q, k, v, causal)) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", TC_SHAPES)
def test_split_product_backward_matches_pallas_interpret(sq, sk, d, causal):
    """K3's float32 route with its five split products against
    ``_pallas_backward(fused=True, interpret=True)`` within the f32
    scaled gate, ragged against the kernel's 128-key blocks and 32-row
    tiles and at cross lengths."""
    q, k, v, do, o, lse, delta = _bwd_case((2, sq, 2, d), causal,
                                           300 + sq + sk + d, sk=sk)
    refs = _pallas_bwd_ref(q, k, v, do, o, lse, causal, fused=True)
    outs = _tc_backward(*(_t(x) for x in (q, k, v, do, lse, delta)), causal,
                        terms=3)
    assert _grad_gap(outs, refs) <= 1.0


def _tc_split_pair(args, causal, terms):
    """K2a (dq) and K2b (dk, dv) on the float32 route, each with its own
    S and dP, emulated."""
    return (_tc_backward(*args, causal, terms, grads=("dq",))
            + _tc_backward(*args, causal, terms, grads=("dk", "dv")))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", TC_SHAPES)
def test_split_product_split_pair_matches_pallas_interpret(sq, sk, d,
                                                           causal):
    """K2a's float32 route (three split products) and K2b's (four)
    against ``_pallas_backward(fused=False, interpret=True)`` within the
    f32 scaled gate, ragged against the kernels' tiles (K2a: 128 query
    rows, 32-key tiles; K2b: 128-key blocks, 32-row tiles) and at cross
    lengths in both directions."""
    q, k, v, do, o, lse, delta = _bwd_case((2, sq, 2, d), causal,
                                           600 + sq + sk + d, sk=sk)
    refs = _pallas_bwd_ref(q, k, v, do, o, lse, causal, fused=False)
    args = [_t(x) for x in (q, k, v, do, lse, delta)]
    assert _grad_gap(_tc_split_pair(args, causal, 3), refs) <= 1.0


@pytest.mark.parametrize("which", ["forward", "backward", "split_pair"])
def test_single_tf32_product_fails_the_f32_gate(which):
    """The gate tells the designs apart: the same computation with one
    TF32 product per tile product, not three, misses the f32 gate the
    split product passes, on the same inputs -- K1, K3 and the split
    pair K2a + K2b."""
    q, k, v, do, o, lse, delta = _bwd_case((2, 24, 2, 128), True, 400)
    if which == "forward":
        args = [torch.from_numpy(x) for x in (q, k, v)]
        ref = _pallas_fwd_ref(q, k, v, True)
        gaps = [_forward_gap(*_tc_forward(*args, True, terms), *ref)
                for terms in (3, 1)]
    elif which == "backward":
        refs = _pallas_bwd_ref(q, k, v, do, o, lse, True, fused=True)
        args = [_t(x) for x in (q, k, v, do, lse, delta)]
        gaps = [_grad_gap(_tc_backward(*args, True, terms), refs)
                for terms in (3, 1)]
    else:
        refs = _pallas_bwd_ref(q, k, v, do, o, lse, True, fused=False)
        args = [_t(x) for x in (q, k, v, do, lse, delta)]
        gaps = [_grad_gap(_tc_split_pair(args, True, terms), refs)
                for terms in (3, 1)]
    assert gaps[0] <= 1.0 < gaps[1], gaps


def _rz32(x):
    """f64 values rounded to f32 toward zero: the tensor core's own sum
    inside one mma, as the kernels' notes model it (csrc/tf32x3.cuh)."""
    y = x.to(torch.float32)
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)),
                       y).double()


def test_truncating_chain_drifts_past_the_gate_and_the_fold_does_not():
    """K3's dV over a 2048-row walk, its split products summed as the
    tensor core sums them (each mma's result truncated to f32): carried
    in one accumulator through the whole walk (768 mmas) it drifts past
    the f32 gate; as fresh chains of one k8 slice folded into an f32 sum
    with rounded adds -- the kernels' design -- it stays well inside."""
    rng = np.random.default_rng(500)
    rows, keys, d = 2048, 64, 16
    s = torch.from_numpy(rng.standard_normal((rows, rows)))
    s = s.masked_fill(torch.ones(rows, rows, dtype=torch.bool).triu(1),
                      -math.inf)
    p = torch.softmax(s, -1)[:, :keys].float().double()
    do = torch.from_numpy(_rand(rng, rows, d)).double()
    exact = p.T @ do
    tol = 1e-5 * max(1.0, float(exact.abs().max()))
    pairs = [(_tf32(x.float()).double(), x) for x in (p.T.contiguous(), do)]
    (p_hi, pt), (do_hi, _) = pairs
    p_lo = _tf32((pt - p_hi).float()).double()
    do_lo = _tf32((do - do_hi).float()).double()
    gaps = []
    for fold in (False, True):
        acc = torch.zeros(keys, d, dtype=torch.float64)
        for r0 in range(0, rows, 8):
            sl = slice(r0, r0 + 8)
            t = torch.zeros_like(acc) if fold else acc
            for a, b in ((p_lo, do_hi), (p_hi, do_lo), (p_hi, do_hi)):
                t = _rz32(t + a[:, sl] @ b[sl])
            acc = (acc + t).float().double() if fold else t
        gaps.append(float((acc - exact).abs().max()) / tol)
    assert gaps[1] <= 0.5 < 1.0 < gaps[0], gaps


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """On the CPU a wrapper takes its plain version because the tensor
    lies on the CPU: it never builds, loads or counts a kernel."""
    def no_build(name):
        raise AssertionError(f"CPU call tried to load kernel {name}")

    monkeypatch.setattr(_build, "load", no_build)

    def counts():
        return (tfa.launches, tfa.launches_dq, tfa.launches_dkdv,
                tfa.launches_fused, tpa.launches)

    before = counts()
    x = torch.randn(1, 8, 2, 32)
    tfa.flash_forward(x, x, x, causal=True)
    pool = torch.randn(3, 4, 2, 32)
    tpa.paged_flash_decode(x[:, :1], pool, pool,
                           torch.tensor([[1, 2]], dtype=torch.int32),
                           torch.tensor([5], dtype=torch.int32))
    for fused in (True, False):
        y = x.clone().requires_grad_()
        tfa.flash_attention(y, y, y, causal=True,
                            fused_bwd=fused).sum().backward()
    assert counts() == before


def test_flash_kernel_argument_checks():
    ok = torch.zeros(1, 8, 2, 64)
    tfa.check_kernel_args(ok, ok, ok)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        h = ok.half()
        tfa.check_kernel_args(h, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 2, 8, 64).transpose(1, 2)
        tfa.check_kernel_args(t, t, t)
    for d in (32, 48):
        with pytest.raises(ValueError, match="head_dim"):
            odd = torch.zeros(1, 8, 2, d)
            tfa.check_kernel_args(odd, odd, odd)
    with pytest.raises(ValueError, match="disagree"):
        tfa.check_kernel_args(ok, torch.zeros(1, 8, 3, 64),
                              torch.zeros(1, 8, 3, 64))
    with pytest.raises(ValueError, match="dtypes differ"):
        tfa.check_kernel_args(ok, ok.bfloat16(), ok)
    # the backward's output gradient must match q
    tfa.check_kernel_args(ok, ok, ok, ok)
    with pytest.raises(ValueError, match="does not match"):
        tfa.check_kernel_args(ok, ok, ok, torch.zeros(1, 7, 2, 64))
    with pytest.raises(ValueError, match="contiguous"):
        tfa.check_kernel_args(ok, ok, ok, t)


def test_paged_kernel_argument_checks():
    q = torch.zeros(2, 1, 2, 64)
    pool = torch.zeros(4, 4, 2, 64)
    tab = torch.zeros(2, 3, dtype=torch.int32)
    idx = torch.zeros(2, dtype=torch.int32)
    tpa.check_kernel_args(q, pool, pool, tab, idx)
    with pytest.raises(ValueError, match="int32"):
        tpa.check_kernel_args(q, pool, pool, tab.long(), idx)
    with pytest.raises(ValueError, match="block_table"):
        tpa.check_kernel_args(q, pool, pool, tab[:1], idx)
    with pytest.raises(ValueError, match="index"):
        tpa.check_kernel_args(q, pool, pool, tab, idx[:1])
    with pytest.raises(ValueError, match="do not match"):
        tpa.check_kernel_args(q, torch.zeros(4, 4, 3, 64),
                              torch.zeros(4, 4, 3, 64), tab, idx)
    with pytest.raises(ValueError, match="head_dim"):
        q32, pool32 = torch.zeros(2, 1, 2, 32), torch.zeros(4, 4, 2, 32)
        tpa.check_kernel_args(q32, pool32, pool32, tab, idx)


# ---------------------------------------------------------------------------
# paged KV cache vs dtf_tpu/ops/paged_attention.py
# ---------------------------------------------------------------------------

PAGE = 8
M = 4                                    # pages per row: 32 positions


def _paged_setup(rng, lengths, s=1, h=2, d=16):
    """Pools, block table and index for rows holding ``lengths`` tokens
    (0 = an idle row: all-zeros table, index 0), pages shuffled."""
    n_pages = 1 + sum(-(-n // PAGE) for n in lengths)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((len(lengths), M), np.int32)
    used = 0
    for r, n in enumerate(lengths):
        k = -(-n // PAGE)
        table[r, :k] = perm[used:used + k]
        used += k
    index = np.array([max(n - s, 0) for n in lengths], np.int32)
    pool_k = _rand(rng, n_pages, PAGE, h, d)
    pool_v = _rand(rng, n_pages, PAGE, h, d)
    q = _rand(rng, len(lengths), s, h, d)
    return q, pool_k, pool_v, table, index


def _both_paged(q, pool_k, pool_v, table, index):
    t = (torch.from_numpy(q), torch.from_numpy(pool_k),
         torch.from_numpy(pool_v), torch.from_numpy(table),
         torch.from_numpy(index))
    port = tpa.paged_flash_decode(*t)
    ref = jpa.paged_flash_decode(q, pool_k, pool_v, table, index,
                                 interpret=True)
    return t, port, np.asarray(ref)


@pytest.mark.parametrize("lengths", [[1, 7, 8, 31],
                                     [31, 0, 8, 0, 1, 7]])
def test_paged_flash_decode_matches_pallas_interpret(lengths):
    """Decode (S = 1) at the page edges {1, 7, 8, 31} of page 8, alone
    and mixed with idle rows (all-zeros tables -> the scratch page)."""
    rng = np.random.default_rng(sum(lengths))
    t, port, ref = _both_paged(*_paged_setup(rng, lengths))
    live = [i for i, n in enumerate(lengths) if n]
    _close(port[live], ref[live])
    np.testing.assert_array_equal(port.numpy()[live].argmax(-1),
                                  ref[live].argmax(-1))
    # the gather oracle agrees on the same inputs
    _close(tpa.paged_attention(*t)[live],
           np.asarray(jpa.paged_attention(*(x.numpy() for x in t)))[live])


@pytest.mark.parametrize("start", [0, 8, 16, 24])
def test_paged_chunk_starts_match_pallas_interpret(start):
    """A continuation chunk of S = 8 queries at each page-aligned start:
    causal within the chunk, the whole prefix before it."""
    rng = np.random.default_rng(100 + start)
    q, pk, pv, table, _ = _paged_setup(rng, [32], s=8)
    index = np.array([start], np.int32)
    _, port, ref = _both_paged(q, pk, pv, table, index)
    _close(port, ref)
    np.testing.assert_array_equal(port.numpy().argmax(-1), ref.argmax(-1))


def test_paged_reference_gather_and_auto_agree():
    """The plain kernel version, the gather and the CPU dispatch (with
    the window trim) compute one function."""
    rng = np.random.default_rng(5)
    q, pk, pv, table, index = _paged_setup(rng, [32, 20], s=4)
    t = [torch.from_numpy(x) for x in (q, pk, pv, table, index)]
    ref = tpa.paged_flash_decode_reference(*t)
    _close(tpa.paged_attention(*t), ref)
    _close(tpa.paged_attention_auto(*t, window_pages=M), ref)
    _close(np.asarray(jpa.paged_flash_decode_reference(q, pk, pv, table,
                                                       index)), ref)


def test_cached_attention_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, 2, 3, 2, 8), _rand(rng, 2, 10, 2, 8), \
        _rand(rng, 2, 10, 2, 8)
    mask = rng.random((2, 3, 10)) < 0.6
    mask[:, :, 0] = True
    port = tpa.cached_attention(*map(torch.from_numpy, (q, k, v, mask)))
    _close(port, jpa.cached_attention(q, k, v, mask))


def _pool_pair(rng, pages=6):
    pool = _rand(rng, pages, PAGE, 2, 4)
    return pool, torch.from_numpy(pool.copy())


def test_write_pages_token_path_matches_jax_exactly():
    rng = np.random.default_rng(7)
    pool, tpool = _pool_pair(rng)
    table = np.array([[3, 1, 0, 0], [2, 5, 4, 0]], np.int32)
    index = np.array([6, 13], np.int32)        # both rows cross a page
    new = _rand(rng, 2, 3, 2, 4)
    out = tpa.write_pages(tpool, torch.from_numpy(new),
                          torch.from_numpy(table), torch.from_numpy(index))
    assert out is tpool                        # written in place
    ref = jpa.write_pages(jnp.asarray(pool), new, table, index)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_write_pages_page_aligned_matches_jax_exactly():
    rng = np.random.default_rng(8)
    pool, tpool = _pool_pair(rng)
    table = np.array([[3, 1, 5, 0]], np.int32)
    index = np.array([8], np.int32)
    new = _rand(rng, 1, 2 * PAGE, 2, 4)
    out = tpa.write_pages(tpool, torch.from_numpy(new),
                          torch.from_numpy(table), torch.from_numpy(index),
                          page_aligned=True)
    ref = jpa.write_pages(jnp.asarray(pool), new, table, index,
                          page_aligned=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the token path writes the same bytes
    _, tpool2 = _pool_pair(np.random.default_rng(8))
    tok = tpa.write_pages(tpool2, torch.from_numpy(new),
                          torch.from_numpy(table), torch.from_numpy(index))
    assert torch.equal(tok, out)


def test_write_pages_clamps_past_capacity():
    """Positions past M * page land on the last logical slot, for the
    token path and the page path alike (the capacity clamp)."""
    pool = torch.zeros(4, PAGE, 1, 1)
    table = torch.tensor([[1, 2]], dtype=torch.int32)    # capacity 16
    new = torch.arange(1, 4, dtype=torch.float32).reshape(1, 3, 1, 1)
    tpa.write_pages(pool, new, table, torch.tensor([14], dtype=torch.int32))
    assert pool[2, 6, 0, 0] == 1.0
    assert pool[2, 7, 0, 0] in (2.0, 3.0)      # 15 and the clamped 16
    assert pool[0].abs().sum() == 0 and pool[3].abs().sum() == 0
    pool2 = torch.zeros(4, PAGE, 1, 1)
    chunk = torch.ones(1, 2 * PAGE, 1, 1)
    tpa.write_pages(pool2, chunk, table, torch.tensor([8], dtype=torch.int32),
                    page_aligned=True)
    assert pool2[2].sum() == PAGE and pool2[1].sum() == 0


def test_gather_pages_matches_jax_exactly():
    rng = np.random.default_rng(9)
    pool, tpool = _pool_pair(rng)
    table = np.array([[3, 1, 0, 0], [2, 5, 4, 1]], np.int32)
    out = tpa.gather_pages(tpool, torch.from_numpy(table))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jpa.gather_pages(pool, table)))


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


def _assert_rows_close(out, ref, floor=0.0):
    """float32: 1e-5.  bfloat16: o is rounded to 8 significant bits and
    the kernel and the plain version add their f32 terms in different
    orders, so a value may round one bf16 step apart: each output row
    (one query and head) within two bf16 steps at the larger of its own
    largest |ref| and ``floor``, 2^(e - 6) for that maximum in
    [2^e, 2^(e+1))."""
    err = (out.float() - ref.float()).abs().amax(-1)
    if out.dtype == torch.float32:
        assert err.max() <= 1e-5
        return
    top = ref.float().abs().amax(-1).clamp_min(max(floor, 2.0 ** -126))
    tol = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 7)
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [5, 64, 200, 320])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, s, d):
    """K1 -- split TF32 products in float32 (128-row, 32-key tiles),
    wgmma in bfloat16 (128-row, 64-key tiles) -- at lengths ragged
    against its tiles."""
    gen = torch.Generator().manual_seed(s + d)
    q, k, v = (torch.randn(2, s, 3, d, generator=gen).to(cuda_device,
                                                          dtype)
               for _ in range(3))
    for causal in (True, False):
        n = tfa.launches
        o, lse = tfa.flash_forward(q, k, v, causal=causal)
        po, plse = tfa.flash_forward_plain(q, k, v, causal=causal,
                                           scale=d ** -0.5)
        torch.cuda.synchronize()
        assert tfa.launches == n + 1
        _assert_rows_close(o, po)
        assert (lse - plse).abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain_on_card(cuda_device, dtype):
    rng = np.random.default_rng(10)
    for s, lengths in ((1, [1, 7, 8, 31, 0]), (8, [32, 16])):
        q, pk, pv, table, index = (
            torch.from_numpy(x).to(cuda_device)
            for x in _paged_setup(rng, lengths, s=s, d=64))
        q, pk, pv = (x.to(dtype) for x in (q, pk, pv))
        n = tpa.launches
        o = tpa.paged_flash_decode(q, pk, pv, table, index)
        ref = tpa.paged_flash_decode_reference(q, pk, pv, table, index)
        torch.cuda.synchronize()
        assert tpa.launches == n + 1
        _assert_rows_close(o, ref)


def _assert_grads_close(out, ref):
    """float32: 1e-5 absolute, scaled by the output's largest |ref| where
    that exceeds 1 (sums over up to S terms).  bfloat16: the per-row rule
    of :func:`_assert_rows_close` with a floor of 2^-8 of the output's
    largest |ref| -- a row whose exact value is zero (causal dq's first
    row: dS = p (dp - delta) with dp = delta) comes out as f32 rounding
    noise whose size follows the order of the sums."""
    if out.dtype == torch.float32:
        top = max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) <= 1e-5 * top
    else:
        _assert_rows_close(out, ref,
                           floor=2.0 ** -8 * float(ref.float().abs().max()))


def _card_bwd_inputs(device, dtype, b, s, h, d, seed, sk=None):
    """q, k, v, dO on the card; k and v hold ``sk`` keys where given."""
    gen = torch.Generator().manual_seed(seed)
    kv = (b, s if sk is None else sk, h, d)
    return [torch.randn(x, generator=gen).to(device, dtype)
            for x in ((b, s, h, d), kv, kv, (b, s, h, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,d", [(5, 5, 64), (64, 64, 128),
                                     (200, 200, 64), (200, 200, 128),
                                     (320, 320, 64), (320, 320, 128),
                                     (200, 320, 128), (320, 200, 128),
                                     (64, 256, 64), (130, 70, 64),
                                     (33, 97, 64), (97, 33, 128)])
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, sq, sk,
                                              d):
    """K2a and K2b -- and K3 where Sq == Sk -- against their plain
    versions on the same inputs, causal and full, ragged against the
    kernels' tiles (float32, split TF32: K2a 128 query rows and 32-key
    tiles, K2b and K3 128 keys and 32-row query tiles; bf16, wgmma: K2a
    128 query rows and 64-key tiles, K2b and K3 128 keys and 64-row
    query tiles) and at cross lengths, Sq < Sk and Sq > Sk; K3 against
    K2a + K2b; each launch counted once."""
    q, k, v, do = _card_bwd_inputs(cuda_device, dtype, 2, sq, 3, d,
                                   sq + sk + d, sk)
    scale = d ** -0.5
    for causal in (True, False):
        o, lse = tfa.flash_forward(q, k, v, causal=causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
            -1, sq).contiguous()
        args = (q, k, v, do, lse, delta)
        n = (tfa.launches_dq, tfa.launches_dkdv, tfa.launches_fused)
        dq = tfa.flash_bwd_dq(*args, causal=causal, scale=scale)
        dk, dv = tfa.flash_bwd_dkdv(*args, causal=causal, scale=scale)
        outs = [dq, dk, dv]
        if sq == sk:
            outs += tfa.flash_bwd_fused(*args, causal=causal, scale=scale)
        torch.cuda.synchronize()
        assert (tfa.launches_dq, tfa.launches_dkdv,
                tfa.launches_fused) == (n[0] + 1, n[1] + 1,
                                        n[2] + int(sq == sk))
        plain = tfa.flash_bwd_fused_plain(*args, causal=causal, scale=scale)
        for out, ref in zip(outs, plain + plain):
            assert out.dtype == dtype
            _assert_grads_close(out, ref)
        if dtype == torch.float32 and sq == sk:
            for a, b_ in zip(outs[3:], outs[:3]):
                _assert_grads_close(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backward_kernel_is_deterministic_on_card(cuda_device, dtype):
    """K3 sums its dq partial slots in a fixed order: two runs give the
    same bits, on both routes, at a length where several key blocks
    and query tiles meet."""
    q, k, v, do = _card_bwd_inputs(cuda_device, dtype, 2, 384, 4, 128, 7)
    o, lse = tfa.flash_forward(q, k, v, causal=True)
    first = tfa.flash_backward(q, k, v, o, lse, do, causal=True,
                               scale=128 ** -0.5, fused=True)
    again = tfa.flash_backward(q, k, v, o, lse, do, causal=True,
                               scale=128 ** -0.5, fused=True)
    torch.cuda.synchronize()
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", [384, 200])
def test_split_backward_kernels_are_deterministic_on_card(cuda_device,
                                                          dtype, sk):
    """K2a and K2b have one writer per output tile: two runs give the
    same bits, on both routes, at equal and at cross lengths."""
    q, k, v, do = _card_bwd_inputs(cuda_device, dtype, 2, 384, 4, 128, 8,
                                   sk)
    o, lse = tfa.flash_forward(q, k, v, causal=True)
    first = tfa.flash_backward(q, k, v, o, lse, do, causal=True,
                               scale=128 ** -0.5, fused=False)
    again = tfa.flash_backward(q, k, v, o, lse, do, causal=True,
                               scale=128 ** -0.5, fused=False)
    torch.cuda.synchronize()
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_bwd", [True, False])
def test_flash_attention_grad_runs_kernels_on_card(cuda_device, fused_bwd):
    """On CUDA tensors that require grad the autograd Function runs K1
    forward and K3 (or K2a + K2b) backward, and its gradient equals the
    plain versions'."""
    q, k, v, w = _card_bwd_inputs(cuda_device, torch.float32, 1, 96, 2, 64,
                                  3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    n = (tfa.launches, tfa.launches_fused, tfa.launches_dq)
    o = tfa.flash_attention(q, k, v, causal=True, fused_bwd=fused_bwd)
    grads = torch.autograd.grad((o * w).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert tfa.launches == n[0] + 1
    assert tfa.launches_fused == n[1] + int(fused_bwd)
    assert tfa.launches_dq == n[2] + int(not fused_bwd)
    with torch.no_grad():
        po, plse = tfa.flash_forward_plain(q, k, v, causal=True,
                                           scale=64 ** -0.5)
        want = tfa.flash_backward(q.cpu(), k.cpu(), v.cpu(), po.cpu(),
                                  plse.cpu(), w.cpu(), causal=True,
                                  scale=64 ** -0.5)
    for g, r in zip(grads, want):
        _assert_grads_close(g.cpu(), r)
