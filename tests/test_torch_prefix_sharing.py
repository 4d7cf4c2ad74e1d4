"""Prefix sharing with copy-on-write pages, cancellation, drain and
streaming in the port's ServeEngine, against the JAX ServeEngine.

The scenarios of tests/test_prefix_sharing.py run on both engines over
the same weights (``convert.py``) and the same prompts; the port must
match the JAX engine EXACTLY in greedy tokens, prefix-hit pages, COW
copies, evicted pages, the pool's high-water mark and what the registry
keeps.  Both run their plain paths on the CPU (the JAX engine's gather
oracle, the port's plain versions of K1 and K4).  Concurrent scenarios
fill their batch before admitting (``max_delay_s``), so both engines
admit the same requests together and the counts are deterministic.
The contiguous cache (``kv_page_size`` 0) is held token for token to
the JAX contiguous Decoder.  Then the port's own lifecycle: cancelling
a queued or a running request, the drain (with a prefill chunk in
flight), the request trace records, the heartbeat, and serve_main
draining on SIGTERM as a process that exits 0.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dtf_tpu.serve.engine as jax_engine_mod
import dtf_tpu_torch.serve.engine as engine_mod
from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.serve import Backpressure as JaxBackpressure
from dtf_tpu.serve import PagePool as JaxPagePool
from dtf_tpu.serve.decode import Decoder as JaxDecoder
from dtf_tpu.serve.engine import PrefixRegistry as JaxRegistry
from dtf_tpu.serve.engine import ServeEngine as JaxEngine
from dtf_tpu_torch import convert
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.watchdog import Heartbeat, read_heartbeat
from dtf_tpu_torch.serve import Backpressure, PagePool, ServeEngine
from dtf_tpu_torch.serve.decode import Decoder
from dtf_tpu_torch.serve.engine import PrefixRegistry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, PS = 64, 64, 8
DIMS = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=2,
            d_ff=64, max_seq_len=SEQ)
PREFIX = np.arange(1, 2 * PS + 1, dtype=np.int32)     # 2 full pages
# distinct tokens from PREFIX: a shared head would dodge the starvation
BIG = ((np.arange(1, 40, dtype=np.int32) * 3 + 1) % VOCAB).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxLM(**DIMS)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, SEQ), jnp.int32))["params"]
    tmodel = TransformerLM(**DIMS)
    tmodel.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tmodel))
    return jmodel, params, tmodel.eval()


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", SEQ)
    kw.setdefault("max_delay_s", 0.0)
    kw.setdefault("kv_page_size", PS)
    return kw


def jax_engine(pair, **kw):
    jmodel, params, _ = pair
    return JaxEngine(jmodel, params, **_kw(kw))


def port_engine(pair, **kw):
    return ServeEngine(pair[2], **_kw(kw))


def _settle(eng, timeout=10.0):
    """Wait until the engine thread has retired everything: the pool
    and registry are then quiescent."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        with eng._cond:
            if not eng._pending and all(s is None for s in eng._slots):
                return
        time.sleep(0.01)
    raise TimeoutError("engine did not go idle")


def _observe(eng, tokens) -> dict:
    m = eng.metrics
    return {"tokens": tokens,
            "hit_pages": m.get("serve_prefix_hit_pages_total").value,
            "cow": m.get("serve_prefix_cow_total").value,
            "evicted": m.get("serve_prefix_evicted_total").value,
            "high_water": eng.pool.high_water,
            "used_pages": eng.pool.used_pages,
            "registry": len(eng.registry)}


def both(pair, scenario, **kw) -> dict:
    """The scenario on the JAX engine, then on the port's: every
    observable equal.  Returns the port's."""
    got = {}
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        eng = make(pair, **kw)
        try:
            got[name] = _observe(eng, scenario(eng))
        finally:
            eng.stop(drain=False)
    assert got["port"] == got["jax"]
    return got["port"]


def unshared(pair, prompts, n_new, **kw):
    """Greedy tokens of the port's engine with sharing off."""
    eng = port_engine(pair, prefix_sharing=False, **kw)
    try:
        return [eng.generate(p, max_new_tokens=n_new).tokens
                for p in prompts]
    finally:
        eng.stop(drain=False)


# ---------------------------------------------------------------------------
# pool refcounts and the registry, unit level, beside the JAX classes
# ---------------------------------------------------------------------------

def test_pool_share_free_refcount_lifecycle():
    for cls in (PagePool, JaxPagePool):
        pool = cls(6)                       # pages 1..5 usable
        pages = pool.alloc(2)
        assert pool.used_pages == 2 and pool.refcount(pages[0]) == 1
        pool.share(pages)                   # second holder
        assert pool.shared_refs == 2
        assert pool.free(pages) == []       # first release: still live
        assert pool.used_pages == 2
        assert sorted(pool.free(pages)) == sorted(pages)   # last holder
        assert pool.used_pages == 0 and pool.shared_refs == 0
        assert pool.free_pages == 5
        with pytest.raises(ValueError, match="double free"):
            pool.free([pages[0]])
        with pytest.raises(ValueError, match="not allocated"):
            pool.share([pages[0]])


def test_pool_high_water_counts_physical_pages_once():
    """Ten holders of one page are one physical page."""
    for cls in (PagePool, JaxPagePool):
        pool = cls(6)
        (p,) = pool.alloc(1)
        for _ in range(9):
            pool.share([p])
        assert pool.high_water == 1 and pool.shared_refs == 9


def test_registry_lookup_verifies_stored_tokens(monkeypatch):
    """Two prefixes under a forced-equal digest: lookup returns the
    registered one's pages and MISSES the impostor, in both packages;
    the digests themselves are the JAX package's."""
    a = np.arange(4, dtype=np.int32)
    b = a[::-1].copy()
    assert engine_mod._page_digest("", a) == jax_engine_mod._page_digest(
        "", a)
    for mod, cls in ((engine_mod, PrefixRegistry),
                     (jax_engine_mod, JaxRegistry)):
        reg = cls(4)
        assert reg.register(a, [7]) == [7]
        assert reg.lookup(b) == []
        with monkeypatch.context() as mp:
            mp.setattr(mod, "_page_digest", lambda prev, t: "same")
            reg2 = cls(4)
            reg2.register(a, [7])
            assert reg2.lookup(a) == [7]
            assert reg2.lookup(b) == []      # digest hits, tokens differ


def test_registry_chain_eviction_order_matches_jax():
    """register / pages_by_depth_desc / drop_page on a two-prompt tree:
    the same newly registered pages, the same deepest-first order and
    the same lookups after a drop."""
    p1 = np.arange(1, 13, dtype=np.int32)
    p2 = np.concatenate([p1[:8], [50, 51, 52, 53]]).astype(np.int32)
    out = []
    for cls in (PrefixRegistry, JaxRegistry):
        reg = cls(4)
        got = [reg.register(p1, [3, 4, 5]), reg.register(p2, [3, 4, 9]),
               reg.register(p2, [6, 7, 8])]
        order = reg.pages_by_depth_desc()
        reg.drop_page(4)
        got += [order, reg.lookup(p1), reg.lookup(p2), len(reg)]
        out.append(got)
    assert out[0] == out[1]
    assert out[0][:2] == [[3, 4, 5], [9]]


# ---------------------------------------------------------------------------
# sharing: one physical copy, release on retire
# ---------------------------------------------------------------------------

def test_shared_prefix_single_physical_copy_and_release(pair):
    """Three sequential same-prefix requests: the two prefix pages are
    written once and hit twice; once all retire the only live pages are
    the registry's cached prefix."""
    tails = [np.array([t], np.int32) for t in (5, 9, 13)]
    prompts = [np.concatenate([PREFIX, t]) for t in tails]

    def scenario(eng):
        out = []
        for p in prompts:
            out.append(eng.submit(p, max_new_tokens=3).result(120).tokens)
            _settle(eng)
        return out

    got = both(pair, scenario, kv_pool_pages=25)
    assert got["hit_pages"] == 4
    assert got["registry"] == 2 and got["used_pages"] == 2
    assert got["tokens"] == unshared(pair, prompts, 3, kv_pool_pages=25)


def test_refcount_high_water_concurrent_burst(pair):
    """Four CONCURRENT same-prefix requests after a warm-up: the
    high-water mark is one prefix copy plus the tails, far below four
    full copies."""
    tails = [np.array([t, t + 1], np.int32) for t in (3, 7, 11, 15)]

    def scenario(eng):
        eng.submit(PREFIX, max_new_tokens=2).result(120)
        _settle(eng)
        eng.reset_measurement()
        hs = [eng.submit(np.concatenate([PREFIX, t]), max_new_tokens=4)
              for t in tails]
        return [h.result(120).tokens for h in hs]

    # the batch fills (4 of 4) before admission, in both engines alike
    got = both(pair, scenario, kv_pool_pages=33, max_delay_s=0.5)
    # per request ceil((18 + 4) / 8) = 3 pages, 2 shared -> 1 fresh
    # each; + 1 for the warm request's tail page until its retire
    assert got["high_water"] <= 2 + 4 + 1
    assert got["hit_pages"] == 8


# ---------------------------------------------------------------------------
# copy-on-write
# ---------------------------------------------------------------------------

def test_cow_on_fully_shared_prompt_exact_and_pristine(pair):
    """A prompt that IS a registered prefix re-decodes its last token
    into a COPIED page; the original stays pristine, so a third request
    sharing the prefix is still exact."""
    tail = np.array([33], np.int32)
    long_p = np.concatenate([PREFIX, tail])

    def scenario(eng):
        eng.submit(long_p, max_new_tokens=2).result(120)
        _settle(eng)
        r_cow = eng.submit(PREFIX, max_new_tokens=4).result(120)
        assert eng.metrics.get("serve_prefix_cow_total").value == 1
        _settle(eng)
        r_share = eng.submit(long_p, max_new_tokens=4).result(120)
        _settle(eng)
        return [r_cow.tokens, r_share.tokens]

    got = both(pair, scenario, kv_pool_pages=25)
    assert got["cow"] == 1
    assert got["tokens"] == unshared(pair, [PREFIX, long_p], 4)


def test_divergent_tail_never_cows(pair):
    """A prompt extending PAST the registered prefix writes only fresh
    pages: no COW."""
    def scenario(eng):
        eng.submit(PREFIX, max_new_tokens=2).result(120)
        _settle(eng)
        return eng.submit(np.concatenate([PREFIX, [1, 2, 3]]),
                          max_new_tokens=3).result(120).tokens

    got = both(pair, scenario, kv_pool_pages=25)
    assert got["cow"] == 0 and got["hit_pages"] == 2


# ---------------------------------------------------------------------------
# hash-collision guard
# ---------------------------------------------------------------------------

def test_hash_collision_degrades_to_miss(pair, monkeypatch):
    """With every digest colliding, the stored token ids catch the
    mismatch: no false hit, exact tokens."""
    for mod in (engine_mod, jax_engine_mod):
        monkeypatch.setattr(mod, "_page_digest", lambda prev, t: "collide")
    a = np.concatenate([PREFIX, [5]]).astype(np.int32)
    b = np.concatenate([PREFIX[::-1], [5]]).astype(np.int32)

    def scenario(eng):
        ra = eng.submit(a, max_new_tokens=3).result(120)
        _settle(eng)
        rb = eng.submit(b, max_new_tokens=3).result(120)
        _settle(eng)
        return [ra.tokens, rb.tokens]

    got = both(pair, scenario, kv_pool_pages=25)
    assert got["hit_pages"] == 0
    assert got["tokens"] == unshared(pair, [a, b], 3)


# ---------------------------------------------------------------------------
# pool pressure with shared pages held
# ---------------------------------------------------------------------------

def test_cached_prefix_evicted_under_pool_pressure(pair):
    """A pool too small for a new request plus the cached prefix: the
    registry-only pages are evicted (deepest first) and the request is
    admitted instead of waiting behind a cold cache."""
    state = {}

    def scenario(eng):
        eng.submit(PREFIX, max_new_tokens=2).result(120)
        _settle(eng)
        assert len(eng.registry) == 2 and eng.pool.used_pages == 2
        # needs 6 pages; 5 are free until the cached prefix yields
        r = eng.submit(BIG, max_new_tokens=8).result(120)
        _settle(eng)
        state[type(eng).__module__] = len(eng.registry.lookup(PREFIX))
        return r.tokens

    got = both(pair, scenario, kv_pool_pages=8)
    assert len(got["tokens"]) == 8 and got["evicted"] >= 1
    # the original chain lost (at least) its deepest page
    assert all(n < 2 for n in state.values())


def test_live_shared_pages_survive_pressure_then_admit(pair):
    """Pages a LIVE slot holds are never evicted: a starved admit waits
    FIFO for the retire, then proceeds, and the holder's tokens are
    unaffected."""
    def scenario(eng):
        holder = eng.submit(PREFIX, max_new_tokens=7)
        first = next(iter(holder.stream(timeout=120)))   # decoding now
        starved = eng.submit(BIG, max_new_tokens=8)
        rh, rs = holder.result(120), starved.result(120)
        assert rh.tokens[0] == first and len(rs.tokens) == 8
        assert starved.request.admit_time >= holder.request.finish_time
        _settle(eng)
        return [rh.tokens, rs.tokens]

    got = both(pair, scenario, kv_pool_pages=8, max_batch=2)
    assert got["tokens"][0] == unshared(pair, [PREFIX], 7)[0]


def test_pool_sized_request_with_cached_prompt_no_livelock(pair):
    """A request sized EXACTLY to the pool whose whole prompt is cached:
    the COW target would need usable + 1 pages, so admission degrades
    the hit (prefills the last page) and completes."""
    def scenario(eng):
        ra = eng.submit(PREFIX, max_new_tokens=2 * PS).result(120)
        _settle(eng)
        assert len(eng.registry) == 2
        rb = eng.submit(PREFIX, max_new_tokens=2 * PS).result(120)
        _settle(eng)
        return [ra.tokens, rb.tokens]

    # usable 4; prompt 2 pages + budget 2 pages = exactly 4
    got = both(pair, scenario, kv_pool_pages=5, max_batch=2)
    assert got["tokens"][0] == got["tokens"][1]
    assert got["cow"] == 0 and got["hit_pages"] == 1


# ---------------------------------------------------------------------------
# drain with live shared prefixes
# ---------------------------------------------------------------------------

def test_drain_finishes_inflight_shared_prefixes(pair):
    """begin_drain with same-prefix requests in flight: they finish
    (exact), new submits shed, stop() joins cleanly."""
    prompts = [np.concatenate([PREFIX, [t]]).astype(np.int32)
               for t in (3, 9)]

    def scenario(eng):
        eng.submit(PREFIX, max_new_tokens=2).result(120)
        _settle(eng)
        handles = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.begin_drain()
        assert eng.draining
        with pytest.raises((Backpressure, JaxBackpressure)):
            eng.submit(np.array([1], np.int32), max_new_tokens=2)
        results = [h.result(timeout=120) for h in handles]
        assert all(len(r.tokens) == 6 and not r.cancelled
                   for r in results)
        eng.stop(drain=True)
        return [r.tokens for r in results]

    got = both(pair, scenario, kv_pool_pages=33, max_delay_s=0.3)
    assert got["tokens"] == unshared(pair, prompts, 6)


def test_begin_drain_racing_inflight_prefill_chunk(pair):
    """begin_drain() between a request's prefill chunks: the drain
    finishes that request -- the remaining chunks run, decode completes,
    every token streams -- while new submits shed; the pool ends empty
    (sharing off: the registry keeps nothing)."""
    rng = np.random.default_rng(23)
    long_p = rng.integers(0, VOCAB, (SEQ - 4,)).astype(np.int32)
    want = unshared(pair, [long_p], 4, prefill_chunk=8)[0]
    eng = port_engine(pair, max_batch=2, prefix_sharing=False,
                      prefill_chunk=8)
    try:
        h = eng.submit(long_p, max_new_tokens=4)    # 60 tokens: 8 chunks
        chunks = eng.metrics.get("serve_prefill_chunks_total")
        deadline = time.time() + 120
        while chunks.value < 1 and time.time() < deadline:
            time.sleep(0.001)
        eng.begin_drain()
        with pytest.raises(Backpressure):
            eng.submit(np.array([1], np.int32), max_new_tokens=1)
        streamed = list(h.stream(timeout=300))
        r = h.result(timeout=300)
        assert not r.cancelled and r.tokens == want == streamed
        assert chunks.value == 8
        eng.stop(drain=True)
        assert eng.pool.used_pages == 0
        assert eng.shed_count == 1
    finally:
        eng.stop(drain=False)


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------

def test_cancel_running_request_reclaims_pages(pair):
    """A request cancelled mid-decode comes back ``cancelled`` with the
    tokens it had, its pages reclaimed down to what the registry holds,
    and it stays out of the completion statistics; a queued request
    cancelled before admission resolves with no tokens."""
    eng = port_engine(pair, max_batch=1, kv_pool_pages=25)
    try:
        h = eng.submit(np.concatenate([PREFIX, [7]]).astype(np.int32),
                       max_new_tokens=40)
        queued = eng.submit(np.array([3], np.int32), max_new_tokens=4)
        it = h.stream(timeout=120)
        first = [next(it), next(it)]
        queued.cancel()
        h.cancel()
        assert h.cancelled
        r = h.result(timeout=120)
        rq = queued.result(timeout=120)
        assert r.cancelled and 2 <= len(r.tokens) < 40
        assert r.tokens[:2] == first
        assert rq.cancelled and rq.tokens == []
        _settle(eng)
        assert eng.pool.used_pages == len(eng.registry) == 2
        assert eng.metrics.get("serve_cancelled_total").value == 2
        assert eng.metrics.get("serve_completed_total").value == 0
        assert eng.completed == [] and eng.outstanding == 0
        # the engine serves on
        assert len(eng.generate(PREFIX, max_new_tokens=2).tokens) == 2
    finally:
        eng.stop(drain=False)


def test_concurrent_submit_cancel_stress(pair):
    """Twelve client threads (more than the cores) submit same-prefix
    requests and cancel half of them at random points while the engine
    runs, with a short switch interval: every handle resolves, every
    uncancelled one with its full budget, and the pool ends holding
    exactly the registry's pages -- no page lost or double-freed."""
    eng = port_engine(pair, kv_pool_pages=25, queue_size=64)
    results, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(n):
            try:
                rng = np.random.default_rng(n)
                for _ in range(3):
                    p = np.concatenate([PREFIX, rng.integers(
                        0, VOCAB, (int(rng.integers(1, 9)),))]).astype(
                            np.int32)
                    h = eng.submit(p, max_new_tokens=6)
                    if rng.random() < 0.5:
                        time.sleep(float(rng.random()) * 0.01)
                        h.cancel()
                    results.append((h.cancelled, h.result(timeout=120)))
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(n,))
                   for n in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors, errors
        assert len(results) == 36
        for asked, r in results:
            # a cancel may land after the last token: then it completed
            assert asked or not r.cancelled
            if not r.cancelled:
                assert len(r.tokens) == 6
        _settle(eng)
        assert eng.pool.used_pages == len(eng.registry)
        assert eng.outstanding == 0 and eng.failed is None
        m = eng.metrics
        assert (m.get("serve_completed_total").value
                + m.get("serve_cancelled_total").value) == 36
    finally:
        eng.stop(drain=False)


def test_cancel_matches_jax_engine(pair):
    """The same cancellation on both engines: a running slot retired at
    a token boundary, pages and registry as the JAX engine leaves
    them."""
    def scenario(eng):
        h = eng.submit(np.concatenate([PREFIX, [7]]).astype(np.int32),
                       max_new_tokens=40)
        it = h.stream(timeout=120)
        next(it)
        h.cancel()
        r = h.result(timeout=120)
        assert r.cancelled
        _settle(eng)
        return eng.metrics.get("serve_cancelled_total").value

    got = both(pair, scenario, kv_pool_pages=25, max_batch=1)
    assert got["tokens"] == 1 and got["used_pages"] == 2


# ---------------------------------------------------------------------------
# the contiguous cache
# ---------------------------------------------------------------------------

def test_contiguous_decoder_token_exact_to_jax(pair):
    """kv_page_size None: prefill into slots and batched decode steps
    over [slots, max_seq_len, H, Dh] slabs, logits and tokens as the
    JAX contiguous Decoder's."""
    jmodel, params, tmodel = pair
    jdec = JaxDecoder(jmodel, params, num_slots=2, max_seq_len=SEQ)
    tdec = Decoder(tmodel, num_slots=2, max_seq_len=SEQ)
    jcache, tcache = jdec.fresh_cache(), tdec.fresh_cache()
    assert tuple(tcache[0][0]["cached_key"].shape) == (2, SEQ, 2, 16)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, (n,)).astype(np.int32)
               for n in (9, 3)]
    toks = []
    for slot, p in enumerate(prompts):
        jt, jcache, jl = jdec.prefill(jcache, p, slot, 0.0, seed=slot)
        tt, tcache, tl = tdec.prefill(tcache, p, slot, 0.0, seed=slot)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                                   rtol=2e-5)
        assert int(tt) == int(jt)
        toks.append(int(tt))
    tokens = np.array(toks, np.int32)
    index = np.array([len(p) for p in prompts], np.int32)
    temps = np.zeros(2, np.float32)
    for _ in range(6):
        jt, jcache, jl = jdec.decode_step(
            jcache, tokens, index, temps, seeds=np.zeros(2, np.uint32))
        tt, tcache, tl = tdec.decode_step(tcache, tokens, index, temps,
                                          seeds=np.zeros(2, np.int64))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        tokens, index = tt.numpy().astype(np.int32), index + 1
    for i, layer in enumerate(tcache[0]):
        ref = np.asarray(jcache[f"block{i}"]["attn"]["cached_key"])
        np.testing.assert_allclose(layer["cached_key"].numpy(), ref,
                                   atol=2e-5, rtol=2e-5)


def test_contiguous_engine_matches_jax_engine(pair):
    """The engine's contiguous branch against the JAX engine's: greedy
    tokens of a batch that retires and re-admits slots."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, VOCAB, (n,)).astype(np.int32)
               for n in (1, 7, 12, 20, 33)]
    got = {}
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        eng = make(pair, max_batch=2, kv_page_size=None)
        try:
            assert eng.pool is None and not eng.prefix_sharing
            hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            got[name] = [h.result(120).tokens for h in hs]
        finally:
            eng.stop(drain=False)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# token streaming
# ---------------------------------------------------------------------------

def test_stream_yields_every_token_in_order(pair):
    """stream() and result() see the same tokens; the callback fires
    from the engine thread per retired token."""
    eng = port_engine(pair)
    try:
        seen = []
        h = eng.submit(np.array([2, 4, 6], np.int32), max_new_tokens=5,
                       on_token=seen.append)
        streamed = list(h.stream(timeout=60))
        r = h.result(timeout=60)
        assert streamed == r.tokens == seen
        assert len(streamed) == 5
    finally:
        eng.stop(drain=False)


def test_stream_first_token_before_retire(pair):
    """The streaming consumer receives token 1 while the request still
    decodes; the stream-lag histogram observes it."""
    eng = port_engine(pair)
    try:
        got_first = threading.Event()
        h = eng.submit(np.array([3], np.int32), max_new_tokens=40,
                       on_token=lambda _: got_first.set())
        assert got_first.wait(timeout=60)
        assert not h.done()
        next(iter(h.stream(timeout=60)))
        assert len(h.result(timeout=60).tokens) == 40
        assert eng.metrics.get("serve_stream_lag_s").count >= 1
    finally:
        eng.stop(drain=False)


def test_stream_timeout_raises(pair):
    eng = port_engine(pair)
    try:
        h = eng.submit(np.array([1], np.int32), max_new_tokens=2)
        h.result(timeout=60)
        # after completion the stream yields the buffered tokens, ends
        assert len(list(h.stream(timeout=0.05))) == 2
        with pytest.raises(TimeoutError):
            next(iter(engine_mod._Handle(engine_mod.ServeRequest(
                prompt=np.array([1], np.int32))).stream(timeout=0.05)))
    finally:
        eng.stop(drain=False)


def test_streaming_works_on_contiguous_cache(pair):
    eng = port_engine(pair, max_batch=2, kv_page_size=None)
    try:
        h = eng.submit(np.array([5, 6], np.int32), max_new_tokens=4)
        assert list(h.stream(timeout=60)) == h.result(timeout=60).tokens
    finally:
        eng.stop(drain=False)


def test_on_token_exception_does_not_kill_engine(pair):
    eng = port_engine(pair)
    try:
        def bad(_tok):
            raise RuntimeError("client bug")

        r = eng.submit(np.array([7], np.int32), max_new_tokens=3,
                       on_token=bad).result(timeout=60)
        assert len(r.tokens) == 3
        assert len(eng.generate(np.array([8], np.int32),
                                max_new_tokens=2).tokens) == 2
        assert eng.failed is None
    finally:
        eng.stop(drain=False)


# ---------------------------------------------------------------------------
# request traces and the heartbeat
# ---------------------------------------------------------------------------

def test_request_trace_records_and_heartbeat(pair, tmp_path):
    """With tracing on every request gets a trace id: serve_submit,
    serve_admit (the shared depth in tokens), serve_retire or
    serve_cancelled under it, a drain shed as a serve_shed anomaly; the
    engine beats its heartbeat with the completed count."""
    hb = Heartbeat(str(tmp_path / "hb" / "heartbeat_rank0.json"),
                   interval_s=0.0)
    trace.configure(str(tmp_path / "t"), rank=0)
    try:
        eng = port_engine(pair, kv_pool_pages=25, heartbeat=hb)
        try:
            warm = eng.submit(PREFIX, max_new_tokens=2, trace_id="warm")
            warm.result(120)
            _settle(eng)
            hit = eng.submit(np.concatenate([PREFIX, [9]]).astype(np.int32),
                             max_new_tokens=2, trace_parent="up")
            hit.result(120)
            gone = eng.submit(np.array([4], np.int32), max_new_tokens=30)
            next(iter(gone.stream(timeout=60)))
            gone.cancel()
            gone.result(120)
            _settle(eng)
            eng.begin_drain()
            with pytest.raises(Backpressure):
                eng.submit(np.array([1], np.int32), trace_id="late")
        finally:
            eng.stop(drain=False)
        time.sleep(0.05)
        beat = read_heartbeat(str(tmp_path / "hb" / "heartbeat_rank0.json"))
        assert beat["step"] == 2
    finally:
        trace.disable()
    recs = trace.read_records(str(tmp_path / "t" / "trace_rank0.jsonl"))
    tid = hit.request.trace_id
    assert tid and tid != "warm" and hit.result(timeout=10).trace_id == tid

    def names(t):
        return [r["name"] for r in recs if r.get("trace") == t
                and r["kind"] == "event"]

    assert names("warm") == ["serve_submit", "serve_admit", "serve_retire"]
    assert names(tid) == ["serve_submit", "serve_admit", "serve_retire"]
    assert names(gone.request.trace_id) == [
        "serve_submit", "serve_admit", "serve_cancelled"]
    admit = [r for r in recs if r.get("trace") == tid
             and r["name"] == "serve_admit"][0]
    assert admit["shared_tokens"] == 2 * PS
    assert admit["parent_span"] == "up"
    shed = [r for r in recs if r["kind"] == "anomaly"]
    assert [(r["name"], r["reason"], r["trace"]) for r in shed] == [
        ("serve_shed", "draining", "late")]
    assert any(r["name"] == "ledger_summary"
               and r["exec"] == "serve_decode_step" for r in recs)


# ---------------------------------------------------------------------------
# serve_main: SIGTERM drains, the process exits 0
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_serve_main_sigterm_drains_and_exits_zero(tmp_path):
    """serve_main as a CPU process with --metrics_port: /metrics carries
    the serve_* and ledger_* series; SIGTERM mid-run turns /healthz to
    503 while the in-flight requests finish, and the process exits 0
    with every submitted request completed."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = [sys.executable, "-m", "dtf_tpu_torch.cli.serve_main",
            "--serve_random_init", "--device", "cpu", "--model",
            "transformer_small", "--num_classes", "64",
            "--serve_max_seq_len", "256", "--serve_requests", "4",
            "--serve_max_new_tokens", "200", "--serve_prompt_len", "12",
            "--serve_max_batch", "2", "--kv_page_size", "4",
            "--metrics_port", str(port),
            "--benchmark_log_dir", str(tmp_path / "blog")]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(argv, cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        body = None
        while time.time() < deadline and proc.poll() is None:
            try:
                status, body = _get(f"{base}/metrics")
                if "serve_decode_step_s_count" in body and json.loads(
                        _get(f"{base}/healthz")[1])["outstanding"]:
                    m = [ln for ln in body.splitlines()
                         if ln.startswith("serve_decode_step_s_count")]
                    if float(m[0].split()[1]) > 2:
                        break
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            time.sleep(0.05)
        assert body and "# TYPE serve_prefix_hit_pages_total counter" in body
        assert "ledger_serve_decode_step_flops" in body
        proc.send_signal(signal.SIGTERM)
        # the handler runs in the process's main thread at its next
        # bytecode boundary: poll until the probe reads the drain
        seen = None
        deadline = time.time() + 60
        while seen is None and time.time() < deadline:
            status, hz = _get(f"{base}/healthz")
            if status == 503:
                seen = json.loads(hz)
            time.sleep(0.01)
        assert seen is not None and seen["draining"] is True
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0, err[-3000:]
    assert "SIGTERM - draining" in err
    assert "drained after SIGTERM" in err
    stats = [ln for ln in err.splitlines() if "Serve stats:" in ln][-1]
    assert "'requests': 4" in stats and "'drained': True" in stats
    names = [json.loads(line)["name"]
             for line in open(tmp_path / "blog" / "metric.log")]
    assert "serve_cancelled_total" in names
