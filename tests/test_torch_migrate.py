"""KV-page wire migration in the port (``serve/migrate.py`` and the
engine's export/import surface), the cases of tests/test_migrate.py over
the port's engines on the CPU in float32, and the wire between the two
packages.

The invariants (serve/migrate.py module docs):

  - a migrated page is BIT-IDENTICAL to a locally-prefilled one --
    decode after import is token-exact vs a colocated oracle, at every
    awkward prompt length (1, page-1, page, 3*page+7);
  - a page under a migration hold can NEVER be evicted, even when the
    pool is starving -- refcount >= 2 by construction;
  - holds balance: fetch, push, abort and a dead peer all release
    exactly what they took (serve_migration_holds returns to 0);
  - verification is layered: a torn payload raises TornTransfer, a
    colliding digest with different tokens is rejected, a chain-digest
    mismatch aborts.

Across the packages, at 12 layers (the JAX wire lists a page's leaves
in string-sorted block order, block0, block1, block10, block11, block2,
..., which a model under 11 layers cannot tell from the natural one): a
JAX engine's chain imports into the port, which then serves the prompt
with a prefix hit and no flash-forward (K1) call, token-exact to the
JAX engine on the weights ``convert.py`` carries across; the port's
pages decode in the JAX package and serve there; and a bfloat16 chain
from the JAX engine, imported into the port and exported again, is the
JAX payload byte for byte, with ml_dtypes importable and with it hidden.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dtf_tpu_torch.models.transformer as transformer_mod
from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.serve import migrate as jax_migrate
from dtf_tpu.serve.engine import ServeEngine as JaxEngine
from dtf_tpu_torch import chaos, convert
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.serve import ServeEngine
from dtf_tpu_torch.serve import migrate
from dtf_tpu_torch.serve.bridge import random_init
from dtf_tpu_torch.serve.decode import BF16Words, wire_leaf_order
from dtf_tpu_torch.serve.replica import ReplicaServer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, PS = 64, 64, 8
DIMS = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=2,
            d_ff=64, max_seq_len=SEQ)
DIMS12 = dict(DIMS, num_layers=12)


@pytest.fixture(scope="module")
def model():
    return random_init(TransformerLM(**DIMS), 0).eval()


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    yield
    chaos.disable()


@pytest.fixture(scope="module")
def engine_pair(model):
    """One (src, dst) pair shared by the read-mostly tests here; they
    only ever ADD registry chains to a 25-page pool, and each uses a
    prompt with its own salt so their chains never alias."""
    src = make_engine(model)
    dst = make_engine(model)
    yield src, dst
    src.stop()
    dst.stop()


def _engine_kw(kw):
    kw = dict(kw)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", SEQ)
    kw.setdefault("max_delay_s", 0.0)
    kw.setdefault("kv_page_size", PS)
    kw.setdefault("kv_pool_pages", 25)
    kw.setdefault("seed", 3)
    return kw


def make_engine(model, **kw):
    return ServeEngine(model, **_engine_kw(kw))


def _prompt(n, salt=0):
    return ((np.arange(1, n + 1, dtype=np.int32) + salt) % 63) + 1


def _export_all(eng, prompt, mig=migrate):
    """Pull a whole chain out of ``eng`` through the export surface
    (holds taken and released), as wire-decoded payloads."""
    pages, digests = eng.export_chain_begin(prompt)
    try:
        leaves = eng.export_chain_read(pages, 0, len(pages))
        return ([mig.decode_page(mig.encode_page(l)) for l in leaves],
                digests)
    finally:
        eng.export_chain_end(pages)


def _wire(eng, prompt, mig):
    """The chain of ``prompt`` in ``eng`` as ``mig``'s wire dicts, after
    a JSON round trip (what crosses the socket)."""
    pages, _ = eng.export_chain_begin(prompt)
    try:
        leaves = eng.export_chain_read(pages, 0, len(pages))
    finally:
        eng.export_chain_end(pages)
    return [json.loads(json.dumps(mig.encode_page(l))) for l in leaves]


# ---------------------------------------------------------------------------
# serialization + verification layers (no engine)
# ---------------------------------------------------------------------------

def test_encode_decode_roundtrip_and_torn_detection():
    leaves = [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              np.arange(6, dtype=np.int32).reshape(3, 2)]
    out = migrate.decode_page(migrate.encode_page(leaves))
    for a, b in zip(leaves, out):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # a payload whose bytes do not hash to the claimed digest is TORN
    enc = migrate.encode_page(leaves)
    other = migrate.encode_page([l + 1 for l in leaves])
    enc["leaves"][0]["data"] = other["leaves"][0]["data"]
    with pytest.raises(migrate.TornTransfer):
        migrate.decode_page(enc)
    # layout is content too: same bytes, different shape = torn
    enc2 = migrate.encode_page(leaves)
    enc2["leaves"][0]["shape"] = [4, 3, 2]
    with pytest.raises(migrate.TornTransfer):
        migrate.decode_page(enc2)
    # a tag that is not numpy's own name of a dtype is never guessed
    enc3 = migrate.encode_page(leaves)
    enc3["leaves"][0]["dtype"] = "f4"
    with pytest.raises(migrate.MigrationError, match="unknown dtype"):
        migrate.decode_page(enc3)
    # bfloat16 words: the tag, and the same bytes back
    words = np.arange(24, dtype=np.uint16).reshape(2, 3, 4).view(BF16Words)
    enc4 = migrate.encode_page([words])
    assert enc4["leaves"][0]["dtype"] == "bfloat16"
    (back,) = migrate.decode_page(enc4)
    assert isinstance(back, BF16Words) and back.tobytes() == words.tobytes()


def test_verify_page_rejects_collision_and_foreign_chain(monkeypatch):
    prompt = _prompt(2 * PS)
    expect = migrate.expected_chain(prompt, PS)
    leaves = [np.zeros((PS, 2, 4), np.float32)]
    good = {"depth": 1, "digest": expect[1],
            "tokens": [int(t) for t in prompt[PS:2 * PS]],
            "payload": migrate.encode_page(leaves)}
    assert migrate._verify_page(good, prompt, PS, expect)
    # COLLISION GUARD: force every chain digest to collide -- a page
    # whose digest "matches" but whose tokens differ must still be
    # rejected (the wire form of the registry's stored-token check)
    monkeypatch.setattr(migrate, "_page_digest",
                        lambda prev, toks: "collide")
    collide = migrate.expected_chain(prompt, PS)
    assert collide == ["collide", "collide"]
    bad = dict(good, digest="collide",
               tokens=[int(t) for t in prompt[:PS]])
    with pytest.raises(migrate.MigrationError, match="tokens differ"):
        migrate._verify_page(bad, prompt, PS, collide)
    monkeypatch.undo()
    # chain-digest mismatch (two sides disagree what prefix this is)
    with pytest.raises(migrate.MigrationError, match="chain digest"):
        migrate._verify_page(dict(good, digest="deadbeef"),
                             prompt, PS, expect)
    # depth past the receiver's own chain
    with pytest.raises(migrate.MigrationError, match="only"):
        migrate._verify_page(dict(good, depth=7), prompt, PS, expect)


# ---------------------------------------------------------------------------
# decoder + engine level: bit identity and token exactness
# ---------------------------------------------------------------------------

def test_decoder_page_roundtrip_bit_identity(engine_pair):
    """Decoder level: write_page(read_page(p)) reproduces the page's
    exact bytes -- the primitive the bit-identity contract rests on."""
    eng = engine_pair[0]
    prompt = _prompt(2 * PS)
    eng.generate(prompt, max_new_tokens=2)
    pages, _ = eng.export_chain_begin(prompt)
    assert len(pages) == 2

    def roundtrip():
        src = pages[0]
        leaves = eng.decoder.read_page(eng._cache, src)
        dst = eng.pool.alloc(1)[0]
        eng._cache = eng.decoder.write_page(eng._cache, dst, leaves)
        back = eng.decoder.read_page(eng._cache, dst)
        eng.pool.free([dst])
        return leaves, back

    leaves, back = eng.run_on_engine(roundtrip)
    eng.export_chain_end(pages)
    assert len(leaves) == 2 * DIMS["num_layers"]
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # nothing is cast: a payload of another dtype is refused
    with pytest.raises(ValueError, match="does not match"):
        eng.run_on_engine(lambda: eng.decoder.write_page(
            eng._cache, 0, [a.astype(np.float16) for a in leaves]))


def test_nonpaged_engine_has_no_migration_surface(model):
    eng = make_engine(model, kv_page_size=0, kv_pool_pages=None)
    try:
        prompt = _prompt(2 * PS)
        assert eng.export_chain_begin(prompt) == ([], [])
        with pytest.raises(RuntimeError, match="paged"):
            eng.import_chain(prompt, [[np.zeros(1, np.float32)]])
    finally:
        eng.stop()


@pytest.mark.parametrize("plen", [1, PS - 1, PS, 3 * PS + 7])
def test_migrated_chain_token_exact_vs_colocated(engine_pair, plen):
    """Engine level, the acceptance contract: decode after migration
    is token-exact vs the colocated oracle at every awkward prompt
    length.  Sub-page prompts have no full pages -- the transfer is a
    clean no-op and exactness still holds.  Salting by plen keeps each
    length's chain disjoint on the shared pair, so the importer is
    genuinely cold for every case."""
    src, dst = engine_pair
    prompt = _prompt(plen, salt=1000 + plen)
    want = src.generate(prompt, max_new_tokens=8).tokens
    payloads, digests = _export_all(src, prompt)
    assert len(payloads) == plen // PS
    assert digests == migrate.expected_chain(prompt, PS)
    assert dst.import_chain(prompt, payloads) == len(payloads)
    got = dst.generate(prompt, max_new_tokens=8).tokens
    assert got == want
    if payloads:
        hits = dst.metrics.get("serve_prefix_hit_pages_total").value
        assert hits >= len(payloads)
        # bit identity end to end: re-export from the importer and
        # compare raw bytes against what crossed the wire
        back, _ = _export_all(dst, prompt)
        for pa, pb in zip(payloads, back):
            for la, lb in zip(pa, pb):
                assert la.tobytes() == lb.tobytes()
    assert src.metrics.get("serve_migration_holds").value == 0
    assert dst.metrics.get("serve_migration_holds").value == 0


# ---------------------------------------------------------------------------
# migration holds vs eviction / refcount balance
# ---------------------------------------------------------------------------

def test_hold_survives_starvation_eviction(model):
    """A mid-transfer chain outlives pool starvation: the flood evicts
    every refcount-1 registry page it can, but held pages (refcount
    >= 2) are untouchable -- their bytes after the flood are identical
    to before."""
    eng = make_engine(model, kv_pool_pages=12)
    try:
        prompt = _prompt(3 * PS)
        eng.generate(prompt, max_new_tokens=2)
        pages, _ = eng.export_chain_begin(prompt)
        assert len(pages) == 3
        before = eng.export_chain_read(pages, 0, 3)
        # flood: distinct 2-page prompts whose registered pages exceed
        # the free pool -- _evict_for must starve-evict cached prefixes
        for i in range(8):
            eng.generate(_prompt(2 * PS, salt=100 + 7 * i),
                         max_new_tokens=2)
        assert eng.registry.lookup(prompt) == pages
        after = eng.export_chain_read(pages, 0, 3)
        for pa, pb in zip(before, after):
            for la, lb in zip(pa, pb):
                assert la.tobytes() == lb.tobytes()
        eng.export_chain_end(pages)
        assert eng.metrics.get("serve_migration_holds").value == 0
        # the hold was the only shield: the same flood now evicts it
        for i in range(8):
            eng.generate(_prompt(2 * PS, salt=200 + 7 * i),
                         max_new_tokens=2)
        assert len(eng.registry.lookup(prompt)) < 3
    finally:
        eng.stop()


def test_refcounts_balance_after_export_abort(engine_pair):
    """An aborted transfer (begin, maybe some reads, end) leaves the
    pool exactly where it started."""
    eng = engine_pair[0]
    prompt = _prompt(3 * PS)
    eng.generate(prompt, max_new_tokens=2)
    used0 = eng.pool.used_pages
    shared0 = eng.pool.shared_refs
    for reads in (0, 2):
        pages, _ = eng.export_chain_begin(prompt)
        assert eng.pool.shared_refs == shared0 + 3
        assert eng.metrics.get("serve_migration_holds").value == 3
        if reads:
            eng.export_chain_read(pages, 0, reads)
        eng.export_chain_end(pages)          # abort: no import ever
        assert eng.pool.used_pages == used0
        assert eng.pool.shared_refs == shared0
        assert eng.metrics.get("serve_migration_holds").value == 0
    # double-end of the same chain must not double-free
    pages, _ = eng.export_chain_begin(prompt)
    eng.export_chain_end(pages)
    eng.export_chain_end([])
    assert eng.pool.shared_refs == shared0


def test_dead_peer_connection_releases_holds(model):
    """A migration client that vanishes mid-transfer cannot pin pages:
    the replica connection's teardown drops its transfers' holds."""
    eng = make_engine(model)
    rdv = tempfile.mkdtemp()
    srv = ReplicaServer(eng, 0, rdv).start()
    try:
        prompt = _prompt(3 * PS)
        eng.generate(prompt, max_new_tokens=2)
        conn = socket.create_connection((srv.host, srv.port), timeout=5)
        rf, wf = conn.makefile("rb"), conn.makefile("wb")
        wf.write((json.dumps(
            {"op": "page_fetch", "xfer": "t1",
             "prompt": [int(t) for t in prompt], "lo": 0, "n": 1})
            + "\n").encode())
        wf.flush()
        # one page + end marker arrive; the hold is now live
        msgs = [json.loads(rf.readline()) for _ in range(2)]
        assert msgs[0]["op"] == "page_push" and msgs[1].get("end")
        assert eng.metrics.get("serve_migration_holds").value == 3
        for c in (rf, wf, conn):             # vanish without release
            c.close()
        deadline = time.monotonic() + 5
        while (eng.metrics.get("serve_migration_holds").value
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert eng.metrics.get("serve_migration_holds").value == 0
    finally:
        srv.stop()
        eng.stop()


# ---------------------------------------------------------------------------
# the wire client end to end
# ---------------------------------------------------------------------------

def test_fetch_chain_wire_token_exact_and_stall_chaos(model):
    """fetch_chain over a real socket: windowed pull, import, token
    exactness -- with a page_fetch_stall chaos arm proving the stall
    delays but never corrupts the transfer."""
    src = make_engine(model)
    dst = make_engine(model)
    rdv = tempfile.mkdtemp()
    srv = ReplicaServer(src, 0, rdv).start()
    try:
        prompt = _prompt(3 * PS + 7)
        want = src.generate(prompt, max_new_tokens=8).tokens
        chaos.configure("page_fetch_stall@replica0:0.01", rank=0)
        t0 = time.monotonic()
        stats = migrate.fetch_chain(dst, srv.host, srv.port, prompt,
                                    window=2)
        assert stats == {"pages": 3, "chain_len": 3, "torn": 0}
        assert time.monotonic() - t0 >= 0.02     # 2 windows stalled
        assert dst.generate(prompt, max_new_tokens=8).tokens == want
        assert src.metrics.get("serve_migration_holds").value == 0
        assert src.metrics.get("serve_pages_exported_total").value == 3
        assert dst.metrics.get("serve_pages_imported_total").value == 3
        # a chain the peer never saw: clean no-op, never an error
        other = _prompt(2 * PS, salt=500)
        assert migrate.fetch_chain(dst, srv.host, srv.port, other) == \
            {"pages": 0, "chain_len": 0, "torn": 0}
    finally:
        srv.stop()
        src.stop()
        dst.stop()


# ---------------------------------------------------------------------------
# the disaggregated tier end to end (router orchestration)
# ---------------------------------------------------------------------------

def _tier(model, n, rdv, pausable=False):
    """n engines behind ReplicaServers, each with a heartbeat thread
    (paused while its event is set, when ``pausable``)."""
    from dtf_tpu_torch.obs.watchdog import Heartbeat, heartbeat_path
    engines, servers, stops, pauses = [], [], [], []
    for rid in range(n):
        eng = make_engine(model)
        srv = ReplicaServer(eng, rid, rdv).start()
        stop, pause = threading.Event(), threading.Event()
        hb = Heartbeat(heartbeat_path(rdv, rid), interval_s=0.04)

        def beat(stop=stop, pause=pause, hb=hb):
            while not stop.wait(0.04):
                if not pause.is_set():
                    hb.beat(step=0)

        threading.Thread(target=beat, daemon=True).start()
        engines.append(eng)
        servers.append(srv)
        stops.append(stop)
        pauses.append(pause)
    return engines, servers, stops, pauses


def _stop_tier(router, engines, servers, stops):
    router.stop(drain=False)
    for s in stops:
        s.set()
    for s in servers:
        s.stop()
    for e in engines:
        e.stop()


def test_router_disagg_migrates_and_rehomes(model):
    """prefill_replicas=1 over real engines: a cold paged prompt
    prefills in the prefill pool, its chain migrates to the decode
    pool, and the repeat prompt decodes THERE on warm pages -- token-
    exact against the first answer at every step."""
    from dtf_tpu_torch.serve.router import Router

    rdv = tempfile.mkdtemp()
    engines, servers, stops, _ = _tier(model, 2, rdv)
    router = Router(2, rdv, probe_interval_s=0.05,
                    health_timeout_s=0.5, deadline_s=30.0,
                    replica_inflight=32, page_size=PS,
                    prefill_replicas=1, migrate_timeout_s=10.0)
    router.start(wait_s=10)
    try:
        prompt = _prompt(3 * PS + 7)
        r1 = router.generate(prompt, max_new_tokens=8)
        assert r1.replica == 0                   # cold -> prefill pool
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            ms = router.migration_stats()
            if ms["migrated"]:
                break
            time.sleep(0.05)
        assert ms == {"migrated": 1, "failed": 0, "pending": 0}
        r2 = router.generate(prompt, max_new_tokens=8)
        assert r2.tokens == r1.tokens            # token-exact re-home
        assert r2.replica == 1                   # ...in the decode pool
        hits = engines[1].metrics.get(
            "serve_prefix_hit_pages_total").value
        assert hits >= 3
        assert engines[1].metrics.get(
            "serve_pages_imported_total").value == 3
        assert engines[0].metrics.get(
            "serve_migration_holds").value == 0
    finally:
        _stop_tier(router, engines, servers, stops)


def test_prefetch_on_heal_warms_replica_token_exact(model):
    """A healed replica gets the hottest tracked prompt chain
    prefetched from its owner -- counted by router_prefetch_pages_total
    -- and decode on the prefetched pages is token-exact against the
    original answer."""
    from dtf_tpu_torch.serve.router import Router

    rdv = tempfile.mkdtemp()
    engines, servers, stops, hbs = _tier(model, 2, rdv)
    router = Router(2, rdv, probe_interval_s=0.05,
                    health_timeout_s=0.5, deadline_s=30.0,
                    replica_inflight=32, page_size=PS,
                    migrate_timeout_s=10.0)
    router.start(wait_s=10)
    try:
        # heat a paged chain on its affinity home
        prompt = _prompt(3 * PS + 7, salt=29)
        r1 = router.generate(prompt, max_new_tokens=8)
        for _ in range(2):
            assert router.generate(
                prompt, max_new_tokens=8).tokens == r1.tokens
        home = r1.replica
        other = 1 - home
        # the OTHER replica blips (heartbeat pause past the timeout)...
        hbs[other].set()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and router.replica_healthy(other):
            time.sleep(0.02)
        assert not router.replica_healthy(other)
        # ...and heals: the heal handoff prefetches the hot chain
        hbs[other].clear()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if (router.replica_healthy(other)
                    and router.migration_stats()["migrated"] >= 1):
                break
            time.sleep(0.05)
        assert router.migration_stats()["migrated"] >= 1
        pages = router.metrics.get("router_prefetch_pages_total").value
        assert pages >= 3
        # force traffic onto the healed replica: the chain's owner goes
        # down, affinity re-homes, and decode runs on PREFETCHED pages
        hbs[home].set()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and router.replica_healthy(home):
            time.sleep(0.02)
        r2 = router.generate(prompt, max_new_tokens=8)
        assert r2.replica == other
        assert r2.tokens == r1.tokens            # token-exact on warm pages
        hits = engines[other].metrics.get(
            "serve_prefix_hit_pages_total").value
        assert hits >= 3
    finally:
        _stop_tier(router, engines, servers, stops)


# ---------------------------------------------------------------------------
# across the packages, at 12 layers
# ---------------------------------------------------------------------------

def test_wire_leaf_order_is_the_jax_tree_order():
    """The port's leaf order is jax.tree_util.tree_leaves' over the JAX
    paged cache's key structure: block0, block1, block10, ..."""
    tree = {f"block{i}": {"attn": {"paged_key": ("k", i),
                                   "paged_value": ("v", i)}}
            for i in range(12)}
    want = [(i, "paged_key" if kv == "k" else "paged_value")
            for kv, i in jax.tree_util.tree_leaves(
                tree, is_leaf=lambda x: isinstance(x, tuple))]
    assert wire_leaf_order(12) == want
    assert [i for i, _ in wire_leaf_order(12)[::2]] == [
        0, 1, 10, 11, 2, 3, 4, 5, 6, 7, 8, 9]


@pytest.fixture(scope="module")
def pair12():
    """A JAX and a port 12-layer engine on the same weights (float32)."""
    jmodel = JaxLM(**DIMS12)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, SEQ), jnp.int32))["params"]
    tmodel = TransformerLM(**DIMS12)
    tmodel.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tmodel))
    jeng = JaxEngine(jmodel, params, **_engine_kw({}))
    peng = ServeEngine(tmodel.eval(), **_engine_kw({}))
    yield jeng, peng
    jeng.stop()
    peng.stop()


def _count_flash(monkeypatch):
    """Count the port model's flash-forward (K1) calls."""
    calls = {"n": 0}
    real = transformer_mod.flash_attention

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(transformer_mod, "flash_attention", counted)
    return calls


def test_jax_chain_imports_into_port_token_exact(pair12, monkeypatch):
    """A JAX engine's chain, encoded by the JAX wire, decodes and
    imports into the port; the port then serves the prompt from the
    migrated pages -- a prefix hit over the whole chain and no K1 call
    -- with the JAX colocated engine's greedy tokens."""
    jeng, peng = pair12
    calls = _count_flash(monkeypatch)
    prompt = _prompt(3 * PS + 7, salt=7)
    want = jeng.generate(prompt, max_new_tokens=8).tokens
    wire = _wire(jeng, prompt, jax_migrate)
    payloads = [migrate.decode_page(w) for w in wire]
    for w, p in zip(wire, payloads):
        assert migrate.payload_digest(p) == w["digest"]
        assert [leaf.shape for leaf in p] == [(PS, 2, 16)] * 24
    hits0 = peng.metrics.get("serve_prefix_hit_pages_total").value
    assert peng.import_chain(prompt, payloads) == 3
    got = peng.generate(prompt, max_new_tokens=8).tokens
    assert got == want
    assert peng.metrics.get(
        "serve_prefix_hit_pages_total").value - hits0 == 3
    assert calls["n"] == 0, "K1 ran for a migrated depth"
    # the count sees K1: a cold prompt's first chunk calls it per layer
    peng.generate(_prompt(2 * PS + 3, salt=40), max_new_tokens=2)
    assert calls["n"] == 12


def test_port_pages_decode_in_jax(pair12):
    """The port's encoded pages parse in the JAX package with the same
    tags, shapes and leaf order as the JAX engine's own pages of the
    same prompt, and the JAX engine imports them and serves the prompt
    from them with the port's greedy tokens."""
    jeng, peng = pair12
    prompt = _prompt(3 * PS + 5, salt=17)
    want = peng.generate(prompt, max_new_tokens=8).tokens
    wire = _wire(peng, prompt, migrate)
    decoded = [jax_migrate.decode_page(w) for w in wire]
    # same prompt prefilled by the JAX engine: leaf by leaf, the
    # port's pages agree in order (layer 10's KV is not layer 2's)
    jeng.generate(prompt, max_new_tokens=1)
    own = [jax_migrate.decode_page(w)
           for w in _wire(jeng, prompt, jax_migrate)]
    for pw, jw in zip(wire, _wire(jeng, prompt, jax_migrate)):
        assert [(l["dtype"], l["shape"]) for l in pw["leaves"]] == [
            (l["dtype"], l["shape"]) for l in jw["leaves"]]
    for port_page, jax_page in zip(decoded, own):
        for a, b in zip(port_page, jax_page):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # the JAX engine serves a prompt it never prefilled from the
    # port's pages
    other = _prompt(3 * PS + 5, salt=18)
    want = peng.generate(other, max_new_tokens=8).tokens
    payloads = [jax_migrate.decode_page(w)
                for w in _wire(peng, other, migrate)]
    assert jeng.import_chain(other, payloads) == 3
    hits0 = jeng.metrics.get("serve_prefix_hit_pages_total").value
    assert jeng.generate(other, max_new_tokens=8).tokens == want
    assert jeng.metrics.get(
        "serve_prefix_hit_pages_total").value - hits0 == 3


# the port's half of the bfloat16 round trip, run in its own process:
# decode the JAX wire, import into a bf16 port engine, export, encode
_BF16_SCRIPT = r"""
import importlib.abc, json, sys

HIDE = sys.argv[2] == "hidden"


class Hide(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("ml_dtypes", "jax", "jaxlib", "dtf_tpu"):
            raise ImportError(f"{name} is hidden")
        return None


if HIDE:
    sys.meta_path.insert(0, Hide())
else:
    import ml_dtypes  # noqa: F401  numpy then knows bfloat16
import numpy as np
import torch

torch.set_num_threads(1)
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.serve import ServeEngine, migrate

with open(sys.argv[1]) as f:
    job = json.load(f)
if HIDE:
    assert "ml_dtypes" not in sys.modules
    try:
        np.dtype("bfloat16")
        raise SystemExit("numpy knows bfloat16 without ml_dtypes")
    except TypeError:
        pass
model = TransformerLM(**job["dims"], dtype=torch.bfloat16).eval()
eng = ServeEngine(model, **job["engine"])
try:
    prompt = np.asarray(job["prompt"], np.int32)
    payloads = [migrate.decode_page(w) for w in job["wire"]]
    assert eng.import_chain(prompt, payloads) == len(payloads)
    pages, _ = eng.export_chain_begin(prompt)
    leaves = eng.export_chain_read(pages, 0, len(pages))
    eng.export_chain_end(pages)
    out = [migrate.encode_page(l) for l in leaves]
    digests = [migrate.payload_digest(p) for p in payloads]
finally:
    eng.stop()
print("RESULT=" + json.dumps({"wire": out, "digests": digests,
                              "ml_dtypes": "ml_dtypes" in sys.modules}))
"""


@pytest.fixture(scope="module")
def jax_bf16_wire():
    """A 3-page bfloat16 chain from a 12-layer JAX engine, as its wire."""
    jmodel = JaxLM(**DIMS12, dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.key(1),
                         jnp.zeros((1, SEQ), jnp.int32))["params"]
    jeng = JaxEngine(jmodel, params, **_engine_kw({}))
    try:
        prompt = _prompt(3 * PS + 2, salt=33)
        jeng.generate(prompt, max_new_tokens=2)
        return prompt, _wire(jeng, prompt, jax_migrate)
    finally:
        jeng.stop()


@pytest.mark.parametrize("ml_dtypes_seen", ["visible", "hidden"])
def test_bf16_wire_payload_byte_equal_to_jax(jax_bf16_wire, tmp_path,
                                             ml_dtypes_seen):
    """bfloat16 pages from the JAX engine, imported into the port and
    exported again, are the JAX payload byte for byte (tags, shapes,
    base64 data) with an equal payload_digest -- with ml_dtypes
    importable, and with it hidden as on a machine without jax."""
    prompt, wire = jax_bf16_wire
    assert {l["dtype"] for w in wire for l in w["leaves"]} == {"bfloat16"}
    job = tmp_path / "job.json"
    job.write_text(json.dumps({
        "dims": DIMS12, "engine": _engine_kw({}),
        "prompt": [int(t) for t in prompt], "wire": wire}))
    proc = subprocess.run(
        [sys.executable, "-c", _BF16_SCRIPT, str(job), ml_dtypes_seen],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT=")][-1]
    got = json.loads(line[len("RESULT="):])
    assert got["ml_dtypes"] == (ml_dtypes_seen == "visible")
    assert got["wire"] == wire
    assert got["digests"] == [w["digest"] for w in wire]
    # and the JAX package decodes the port's bytes to the same arrays
    for w in got["wire"]:
        assert jax_migrate.payload_digest(jax_migrate.decode_page(w)) \
            == w["digest"]
