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


def _bwd_case(shape, causal, seed, dtype=np.float32):
    """Inputs, the JAX forward's residuals (o, lse) and the port's
    delta for one backward case; q/k/v/dO in ``dtype``."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_rand(rng, *shape).astype(dtype) for _ in range(4))
    b, s, h, d = shape
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


def _assert_rows_close(out, ref):
    """float32: 1e-5.  bfloat16: o is rounded to 8 significant bits and
    the kernel and the plain version add their f32 terms in different
    orders, so a value may round one bf16 step apart: each output row
    (one query and head) within two bf16 steps at its own largest
    |ref|, 2^(e - 6) for that maximum in [2^e, 2^(e+1))."""
    err = (out.float() - ref.float()).abs().amax(-1)
    if out.dtype == torch.float32:
        assert err.max() <= 1e-5
        return
    top = ref.float().abs().amax(-1).clamp_min(2.0 ** -126)
    tol = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 7)
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [5, 64, 200])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, s):
    gen = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(2, s, 3, 64, generator=gen).to(cuda_device,
                                                           dtype)
               for _ in range(3))
    for causal in (True, False):
        n = tfa.launches
        o, lse = tfa.flash_forward(q, k, v, causal=causal)
        po, plse = tfa.flash_forward_plain(q, k, v, causal=causal,
                                           scale=64 ** -0.5)
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
    of :func:`_assert_rows_close`."""
    if out.dtype == torch.float32:
        top = max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) <= 1e-5 * top
    else:
        _assert_rows_close(out, ref)


def _card_bwd_inputs(device, dtype, b, s, h, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=gen).to(device, dtype)
            for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(5, 64), (64, 128), (200, 64)])
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, s, d):
    """K2a, K2b and K3 against their plain versions on the same inputs,
    causal and full, ragged against the kernels' 32-row tiles; K3
    against K2a + K2b; each launch counted once."""
    q, k, v, do = _card_bwd_inputs(cuda_device, dtype, 2, s, 3, d, s + d)
    scale = d ** -0.5
    for causal in (True, False):
        o, lse = tfa.flash_forward(q, k, v, causal=causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
            -1, s).contiguous()
        args = (q, k, v, do, lse, delta)
        n = (tfa.launches_dq, tfa.launches_dkdv, tfa.launches_fused)
        dq = tfa.flash_bwd_dq(*args, causal=causal, scale=scale)
        dk, dv = tfa.flash_bwd_dkdv(*args, causal=causal, scale=scale)
        fq, fk, fv = tfa.flash_bwd_fused(*args, causal=causal, scale=scale)
        torch.cuda.synchronize()
        assert (tfa.launches_dq, tfa.launches_dkdv,
                tfa.launches_fused) == (n[0] + 1, n[1] + 1, n[2] + 1)
        plain = tfa.flash_bwd_fused_plain(*args, causal=causal, scale=scale)
        for out, ref in zip((dq, dk, dv, fq, fk, fv), plain + plain):
            assert out.dtype == dtype
            _assert_grads_close(out, ref)
        if dtype == torch.float32:
            for a, b_ in ((fq, dq), (fk, dk), (fv, dv)):
                _assert_grads_close(a, b_)


@pytest.mark.cuda
def test_fused_backward_kernel_is_deterministic_on_card(cuda_device):
    """K3 sums its dq partial slots in a fixed order: two runs give the
    same bits."""
    q, k, v, do = _card_bwd_inputs(cuda_device, torch.bfloat16, 2, 256, 4,
                                   128, 7)
    o, lse = tfa.flash_forward(q, k, v, causal=True)
    first = tfa.flash_backward(q, k, v, o, lse, do, causal=True,
                               scale=128 ** -0.5, fused=True)
    again = tfa.flash_backward(q, k, v, o, lse, do, causal=True,
                               scale=128 ** -0.5, fused=True)
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
