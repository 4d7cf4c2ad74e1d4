"""The port's TransformerLM, weight converter and paged Decoder against
the JAX package, on one set of JAX-initialized weights carried across by
``dtf_tpu_torch.convert``.

Tolerances: logits at 1e-4 (float32; twelve-odd matmuls summed in
another order than XLA's), the pinned structure exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.serve.decode import Decoder as JaxDecoder
from dtf_tpu.serve.decode import teacher_forced_logits as jax_tf_logits
from dtf_tpu_torch import convert
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.models.transformer import LN_EPS, TransformerLM
from dtf_tpu_torch.serve import bridge
from dtf_tpu_torch.serve.decode import Decoder, teacher_forced_logits

torch.set_num_threads(1)

VOCAB, SEQ, PAGE = 64, 32, 4
TOL = 1e-4
DIMS = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=2,
            d_ff=64, max_seq_len=SEQ)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) on the same weights."""
    jmodel = JaxLM(**DIMS)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, SEQ), jnp.int32))["params"]
    tmodel = TransformerLM(**DIMS)
    tmodel.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tmodel))
    return jmodel, params, tmodel.eval()


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("batch,seq", [(1, 1), (2, 20), (3, SEQ)])
def test_teacher_forced_logits_match_jax(pair, batch, seq):
    jmodel, params, tmodel = pair
    toks = np.random.default_rng(seq).integers(0, VOCAB, (batch, seq))
    port = teacher_forced_logits(tmodel, toks)
    assert port.dtype == torch.float32 and port.shape == (batch, seq, VOCAB)
    ref = np.asarray(jax_tf_logits(jmodel, params, toks.astype(np.int32)))
    _close(port, ref)
    np.testing.assert_array_equal(port.numpy().argmax(-1), ref.argmax(-1))


def test_teacher_forced_logits_match_jax_pallas_interpret(pair):
    """The same against the JAX model running its flash kernel through
    the Pallas interpreter."""
    _, params, tmodel = pair
    jmodel = JaxLM(**DIMS, use_pallas="interpret")
    toks = np.random.default_rng(11).integers(0, VOCAB, (1, 16))
    _close(teacher_forced_logits(tmodel, toks),
           jax_tf_logits(jmodel, params, toks.astype(np.int32)))


def test_structure_is_pinned(pair):
    """The details a direct translation gets wrong: LayerNorm epsilon
    1e-6 (flax), no bias on out and fc2, a bias on qkv/fc1/lm_head."""
    _, params, tmodel = pair
    blk = tmodel.block0
    assert LN_EPS == 1e-6
    for ln in (blk.ln1, blk.ln2, tmodel.ln_f):
        assert ln.eps == 1e-6
    assert blk.attn.out.bias is None and blk.fc2.bias is None
    assert blk.attn.qkv.bias is not None and blk.fc1.bias is not None
    assert tmodel.lm_head.bias is not None
    assert "bias" not in params["block0"]["fc2"]
    assert "bias" not in params["block0"]["attn"]["out"]


def test_gelu_is_the_tanh_approximation(pair):
    """jax's nn.gelu default is the tanh form; erf would move the logits
    past the tolerance, so the parity test above would catch a swap.
    Pin it directly on one MLP."""
    _, _, tmodel = pair
    blk = tmodel.block0
    x = torch.randn(1, 3, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        x1 = x + blk.attn(blk.ln1(x))
        h = blk.fc1(blk.ln2(x1))
        got = blk(x)
        want = x1 + blk.fc2(F.gelu(h, approximate="tanh"))
        erf = x1 + blk.fc2(F.gelu(h))
    assert torch.allclose(got, want, atol=1e-6)
    assert not torch.allclose(got, erf, atol=1e-7)


def _paged_pair(pair, num_slots):
    jmodel, params, tmodel = pair
    jdec = JaxDecoder(jmodel, params, num_slots=num_slots, max_seq_len=SEQ,
                      kv_page_size=PAGE)
    tdec = Decoder(tmodel, num_slots=num_slots, max_seq_len=SEQ,
                   kv_page_size=PAGE)
    return jdec, tdec


def test_fresh_cache_shapes_match_jax(pair):
    jdec, tdec = _paged_pair(pair, 2)
    jcache = jdec.fresh_cache()
    tcache = tdec.fresh_cache()
    assert len(tcache) == 2
    for i, layer in enumerate(tcache):
        for name in ("paged_key", "paged_value"):
            ref = jcache[f"block{i}"]["attn"][name]
            assert tuple(layer[name].shape) == tuple(ref.shape)
            assert not layer[name].any()


def test_prefill_chunks_and_decode_steps_match_jax(pair):
    """One prompt prefilled in page-aligned chunks (the first through
    the flash forward, the next over the pages), then decode steps for
    two rows, one of them idle (all-zeros table) for the first steps:
    the port's logits equal the JAX Decoder's at every call."""
    jdec, tdec = _paged_pair(pair, 2)
    jcache, tcache = jdec.fresh_cache(), tdec.fresh_cache()
    rng = np.random.default_rng(5)
    pages = tdec.pages_per_slot
    rows = np.zeros((2, pages), np.int32)
    rows[0] = np.arange(1, 1 + pages)
    rows[1] = np.arange(1 + pages, 1 + 2 * pages)
    prompts = [rng.integers(0, VOCAB, (11,)).astype(np.int32),
               rng.integers(0, VOCAB, (5,)).astype(np.int32)]
    firsts = []
    for r, prompt in enumerate(prompts):
        padded = np.zeros((-(-len(prompt) // PAGE) * PAGE,), np.int32)
        padded[:len(prompt)] = prompt
        for start in range(0, len(padded), 8):
            chunk = padded[start:start + 8]
            last = start + len(chunk) >= len(prompt)
            sp = len(prompt) - 1 - start if last else 0
            jt, jcache, jl = jdec.prefill_chunk(jcache, chunk, rows[r],
                                                start, sp, 0.0, seed=r)
            tt, tcache, tl = tdec.prefill_chunk(tcache, chunk, rows[r],
                                                start, sp, 0.0, seed=r)
            _close(tl, jl)
            assert int(tt) == int(jt)
        firsts.append(int(tt))
    tokens = np.array(firsts, np.int32)
    index = np.array([len(p) for p in prompts], np.int32)
    temps = np.zeros(2, np.float32)
    seeds = np.zeros(2, np.int64)
    for step in range(6):
        tables = rows.copy()
        if step < 2:
            tables[1] = 0                       # row 1 idle: scratch page
        jt, jcache, jl = jdec.decode_step(jcache, tokens, index, temps,
                                          block_tables=tables,
                                          seeds=seeds.astype(np.uint32))
        tt, tcache, tl = tdec.decode_step(tcache, tokens, index, temps,
                                          tables, seeds=seeds)
        live = [0] if step < 2 else [0, 1]
        _close(tl[live], np.asarray(jl)[live])
        np.testing.assert_array_equal(tt.numpy()[live],
                                      np.asarray(jt)[live])
        tokens = np.where(np.isin(np.arange(2), live), tt.numpy(),
                          tokens).astype(np.int32)
        index = index + np.isin(np.arange(2), live)
    # the pools themselves hold the same K/V (page 0 aside: scratch)
    for i, layer in enumerate(tcache):
        ref = np.asarray(jcache[f"block{i}"]["attn"]["paged_key"])
        _close(layer["paged_key"][1:], ref[1:])


def test_decode_rejects_unaligned_chunk(pair):
    _, tdec = _paged_pair(pair, 1)
    cache = tdec.fresh_cache()
    with pytest.raises(ValueError, match="page-aligned"):
        tdec.prefill_chunk(cache, np.zeros(6, np.int32),
                           np.arange(1, 9, dtype=np.int32), 0, 0, 0.0)


def test_decoder_rejects_bad_geometry(pair):
    _, _, tmodel = pair
    with pytest.raises(ValueError, match="position table"):
        Decoder(tmodel, num_slots=1, max_seq_len=SEQ + 1, kv_page_size=4)
    with pytest.raises(ValueError, match=">= 1"):
        Decoder(tmodel, num_slots=1, max_seq_len=SEQ, kv_page_size=0)
    with pytest.raises(ValueError, match="scratch"):
        Decoder(tmodel, num_slots=1, max_seq_len=SEQ, kv_page_size=4,
                kv_pool_pages=1)


def test_model_rejects_overlong_sequence(pair):
    _, _, tmodel = pair
    with pytest.raises(ValueError, match="max_seq_len"):
        tmodel(torch.zeros(1, SEQ + 1, dtype=torch.long))


def test_convert_rejects_missing_leaf_and_bad_shape(pair):
    _, params, tmodel = pair
    flat = jax.tree_util.tree_map(np.asarray, params)
    missing = {k: v for k, v in flat.items() if k != "ln_f"}
    with pytest.raises(KeyError, match="ln_f"):
        convert.from_flax_params(missing, tmodel)
    bad = dict(flat)
    bad["pos_embed"] = np.zeros((SEQ + 1, 32), np.float32)
    with pytest.raises(ValueError, match="pos_embed"):
        convert.from_flax_params(bad, tmodel)


def test_convert_layouts(pair):
    """Dense kernels [in, out] -> Linear [out, in]; the qkv kernel
    [d, 3, H, Dh] flattens its (3, H, Dh) output in that order."""
    _, params, tmodel = pair
    sd = convert.from_flax_params(jax.tree_util.tree_map(np.asarray,
                                                         params), tmodel)
    fc1 = np.asarray(params["block1"]["fc1"]["kernel"])
    np.testing.assert_array_equal(sd["block1.fc1.weight"].numpy(), fc1.T)
    qkv = np.asarray(params["block0"]["attn"]["qkv"]["kernel"])
    w = sd["block0.attn.qkv.weight"].numpy().reshape(3, 2, 16, 32)
    np.testing.assert_array_equal(w[1, 0, 3], qkv[:, 1, 0, 3])


def test_npz_bridge_round_trip(pair, tmp_path):
    """flax params saved as an .npz of "/"-joined paths load through
    serve.bridge into the same logits."""
    _, params, tmodel = pair
    flat = {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    np.savez(tmp_path / "params.npz", **flat)
    fresh = bridge.load_for_serving(TransformerLM(**DIMS),
                                    str(tmp_path / "params.npz"))
    toks = np.arange(12).reshape(1, 12) % VOCAB
    assert torch.equal(teacher_forced_logits(fresh, toks),
                       teacher_forced_logits(tmodel, toks))


def test_random_init_is_a_function_of_the_seed():
    a = bridge.random_init(TransformerLM(**DIMS), 3)
    b = bridge.random_init(TransformerLM(**DIMS), 3)
    c = bridge.random_init(TransformerLM(**DIMS), 4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("ln1.weight"):
            assert torch.equal(pa, torch.ones_like(pa))
        elif pa.dim() == 2:
            assert not torch.equal(pa, pc), name
    assert float(a.pos_embed.detach().std()) == pytest.approx(0.02, rel=0.2)


def test_registry_matches_jax_widths():
    for name in ("transformer", "transformer_small", "transformer_tpu"):
        model, l2 = registry.build_model(name, num_classes=64,
                                         max_seq_len=16)
        assert l2 == 0.0
        from dtf_tpu.models.registry import build_model as jax_build
        jmodel, _ = jax_build(name, num_classes=64)
        for attr in ("num_layers", "d_model", "num_heads", "d_ff"):
            assert getattr(model, attr) == getattr(jmodel, attr), (name, attr)
    tpu, _ = registry.build_model("transformer_tpu", max_seq_len=8)
    assert (tpu.num_layers, tpu.d_model, tpu.num_heads, tpu.d_ff,
            tpu.vocab_size) == (12, 768, 6, 3072, 32768)
    with pytest.raises(ValueError, match="unknown model"):
        registry.build_model("resnet50")


def test_bf16_model_runs_paged_on_cpu():
    """bf16 weights and pools: prefill + decode give finite f32 logits
    that track the f32 model's."""
    f32 = bridge.random_init(TransformerLM(**DIMS), 0).eval()
    bf16 = bridge.random_init(TransformerLM(**DIMS, dtype=torch.bfloat16),
                              0).eval()
    outs = []
    for model in (f32, bf16):
        dec = Decoder(model, num_slots=1, max_seq_len=SEQ, kv_page_size=PAGE)
        cache = dec.fresh_cache()
        assert cache[0]["paged_key"].dtype == model.dtype
        row = np.arange(1, 1 + dec.pages_per_slot, dtype=np.int32)
        _, cache, first = dec.prefill_chunk(cache, np.arange(8), row, 0, 7,
                                            0.0)
        _, cache, logits = dec.decode_step(cache, [3], [8], [0.0], row[None])
        outs.append(logits)
        assert logits.dtype == torch.float32
        assert bool(torch.isfinite(logits).all())
    assert torch.allclose(outs[0], outs[1], atol=0.1)
