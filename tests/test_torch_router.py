"""The port's serving replica tier (``dtf_tpu_torch/serve/router.py``
over ``serve/replica.py``): placement, deadlines, retry/failover,
backpressure, hedging, cancellation, re-homing, the disaggregated
split and the distributed chaos kinds -- the cases of
tests/test_router.py, here over the port's modules.

The replicas are REAL port ``ReplicaServer``s (the full wire protocol)
over a copy of that file's deterministic fake engine, in process: a
replica's death is a server teardown, not a subprocess SIGKILL.  Then
the JAX ``Router`` + ``ReplicaServer`` and the port's run one scripted
scenario over the same fake engine and must resolve every request
alike: the same tokens, the same kind (tokens, Backpressure or
DeadlineExceeded) and, under affinity, the same replica per prompt
family.  Last, the real subprocess path (slow): ``router_main --device
cpu`` spawns two ``replica_main`` processes, one is chaos-killed
mid-burst and respawned, and every request resolves token-exact.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dtf_tpu_torch import chaos
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.watchdog import Heartbeat, heartbeat_path
from dtf_tpu_torch.serve.engine import Backpressure
from dtf_tpu_torch.serve.replica import ReplicaServer, read_announce
from dtf_tpu_torch.serve.router import (PLACEMENTS, DeadlineExceeded, Router)

torch.set_num_threads(1)

# the modules a tier is built from, per package
PORT = dict(Router=Router, ReplicaServer=ReplicaServer,
            Heartbeat=Heartbeat, heartbeat_path=heartbeat_path,
            Backpressure=Backpressure, DeadlineExceeded=DeadlineExceeded)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    yield
    chaos.disable()


def oracle(prompt, n, seed=0, temperature=0.0, salt=0):
    """The fake engine's deterministic decode: token i of a prompt is a
    pure function of (prompt, i) — replica-interchangeable, like greedy
    decode over identical params.  ``temperature > 0`` mixes in the
    per-request ``seed`` (the wire-carried sampling identity: same
    seed → same tokens, like the real engine's fold_in(key(seed),
    pos)); ``salt`` models a DIFFERENT CHECKPOINT (rollout tests: a
    new model answers differently)."""
    s = int(np.asarray(prompt, np.int64).sum()) % 97
    out = []
    for i in range(n):
        t = (s * 31 + i * 7 + salt) % 97
        if temperature > 0:
            t = (t + (int(seed) * 13 + i * (int(seed) % 7 + 1))) % 97
        out.append(t)
    return out


class _FakeHandle:
    def __init__(self):
        self._ev = threading.Event()
        self._res = None
        self._cancel = threading.Event()

    def cancel(self):
        self._cancel.set()

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise TimeoutError("fake engine request not finished")
        return self._res


class _FakeResult:
    def __init__(self, tokens, plen):
        self.tokens = tokens
        self.cancelled = False
        self.prompt_len = plen
        self.latency_s = 0.01


class FakeEngine:
    """ServeEngine's wire-facing surface (submit/begin_drain/
    outstanding/cancel-able handles) over the oracle, with a per-token
    delay so kills can land mid-request.  ``salt`` models the
    checkpoint identity (rollout tests)."""

    def __init__(self, tok_delay=0.004, queue_limit=64, salt=0,
                 bp_cls=Backpressure):
        self.tok_delay = tok_delay
        # the Backpressure class its replica server catches (the JAX
        # package's in the parity scenario)
        self.bp_cls = bp_cls
        self.queue_limit = queue_limit
        self.salt = salt
        self._n = 0
        self.submitted = 0
        self.cancelled_count = 0
        self._mu = threading.Lock()
        self.draining = False
        self.dead = False
        # (trace_id, trace_parent) per submit, in order — the
        # propagation tests assert the router's span context crossed
        # the real wire intact (failover replay included)
        self.trace_ids = []
        # rng_seed per submit, in order — the sampled-replay tests
        # assert the SAME seed crossed the wire on every attempt
        self.rng_seeds = []

    @property
    def outstanding(self):
        return self._n

    def begin_drain(self):
        self.draining = True

    def submit(self, prompt, max_new_tokens=32, temperature=0.0,
               eos_id=None, on_token=None, trace_id=None,
               trace_parent=None, rng_seed=None):
        with self._mu:
            self.trace_ids.append((trace_id, trace_parent))
            self.rng_seeds.append(rng_seed)
            if self.draining or self._n >= self.queue_limit:
                raise self.bp_cls(0.3)
            self._n += 1
            self.submitted += 1
        handle = _FakeHandle()
        toks = oracle(prompt, max_new_tokens, seed=rng_seed or 0,
                      temperature=temperature, salt=self.salt)

        def run():
            for t in toks:
                if self.dead:
                    return      # a killed replica never answers
                if handle._cancel.is_set():
                    # engine-level cancellation: stop decoding, free
                    # the (fake) slot — the wire CANCEL's effect
                    with self._mu:
                        self._n -= 1
                        self.cancelled_count += 1
                    return
                time.sleep(self.tok_delay)
                if on_token:
                    on_token(t)
            handle._res = _FakeResult(toks, len(prompt))
            handle._ev.set()
            with self._mu:
                self._n -= 1

        threading.Thread(target=run, daemon=True).start()
        return handle


class FakeReplica:
    """ReplicaServer + FakeEngine + a heartbeat thread — everything a
    replica process provides, minus the process.  ``pkg`` holds the
    ReplicaServer, Heartbeat and heartbeat_path to use (the port's by
    default, the JAX package's in the parity scenario)."""

    def __init__(self, rid, rdir, host="127.0.0.1", pkg=None,
                 **engine_kw):
        self.rid, self.rdir, self.engine_kw = rid, rdir, engine_kw
        self.host = host
        self.pkg = pkg or PORT
        self.engine = None
        self.server = None
        self._hb_stop = None

    def start(self):
        pkg = self.pkg
        self.engine = FakeEngine(bp_cls=pkg["Backpressure"],
                                 **self.engine_kw)
        self.server = pkg["ReplicaServer"](self.engine, self.rid,
                                           self.rdir, host=self.host).start()
        self._hb_stop = threading.Event()
        hb = pkg["Heartbeat"](pkg["heartbeat_path"](self.rdir, self.rid),
                              interval_s=0.04)
        stop, eng = self._hb_stop, self.engine

        def beat():
            while not stop.wait(0.04):
                hb.beat(step=eng.submitted)

        threading.Thread(target=beat, daemon=True).start()
        return self

    def kill(self):
        """Abrupt death: tokens stop, heartbeat stops, socket drops."""
        self.engine.dead = True
        self._hb_stop.set()
        self.server.stop()


def make_tier(tmp_path, n=2, router_kw=None, engine_kw=None, pkg=None):
    pkg = pkg or PORT
    rdir = str(tmp_path / "rdv")
    os.makedirs(rdir, exist_ok=True)
    reps = [FakeReplica(i, rdir, pkg=pkg, **(engine_kw or {})).start()
            for i in range(n)]
    kw = dict(probe_interval_s=0.05, health_timeout_s=0.3,
              deadline_s=30.0, replica_inflight=32, page_size=8,
              kill_hook=lambda rid: reps[rid].kill())
    kw.update(router_kw or {})
    router = pkg["Router"](n, rdir, **kw)
    router.start(wait_s=10)
    return router, reps


def stop_tier(router, reps):
    router.stop(drain=False)
    for r in reps:
        try:
            r.kill()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# basics: routing, exactness, placement
# ---------------------------------------------------------------------------

def test_router_roundtrip_token_exact_and_spread(tmp_path):
    """A burst of varied prompts completes token-exact vs the oracle,
    and least-loaded placement uses BOTH replicas."""
    router, reps = make_tier(tmp_path, 2,
                             router_kw=dict(placement="least_loaded"))
    try:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 97, (int(rng.integers(3, 30)),))
                   .astype(np.int32) for _ in range(10)]
        handles = [router.submit(p, max_new_tokens=6) for p in prompts]
        results = [h.result(timeout=20) for h in handles]
        for r, p in zip(results, prompts):
            assert r.tokens == oracle(p, 6)
            assert r.redispatches == 0 and not r.diverged
        assert all(reps[i].engine.submitted > 0 for i in range(2)), (
            "least-loaded placement left a replica idle under a burst")
        assert router.metrics.get("router_completed_total").value == 10
    finally:
        stop_tier(router, reps)


def test_router_prefix_affinity_routes_shared_prompts_together(tmp_path):
    """Two groups sharing distinct system prompts: once each group's
    first request lands, prefix-affine placement sends every sibling
    to the SAME replica (warm-registry routing), and the affinity-hit
    counter proves it was the digest chain, not luck."""
    router, reps = make_tier(tmp_path, 2, engine_kw=dict(tok_delay=0.01))
    try:
        ps = router.page_size
        rng = np.random.default_rng(1)
        groups = [rng.integers(0, 97, (2 * ps,)).astype(np.int32)
                  for _ in range(2)]
        # concurrent warmers: group A occupies one replica so group B's
        # least-loaded fallback picks the other — ownership splits
        warm = [router.submit(g, max_new_tokens=4) for g in groups]
        for h in warm:
            h.result(timeout=10)
        owners = []
        for g in groups:
            counts0 = [r.engine.submitted for r in reps]
            hs = [router.submit(
                np.concatenate([g, rng.integers(0, 97, (3,))
                                .astype(np.int32)]), max_new_tokens=4)
                for _ in range(4)]
            for h in hs:
                h.result(timeout=10)
            deltas = [r.engine.submitted - c
                      for r, c in zip(reps, counts0)]
            assert sorted(deltas) == [0, 4], (
                f"group traffic split {deltas} across replicas — "
                f"prefix affinity should pin it to the owner")
            owners.append(deltas.index(4))
        assert router.metrics.get("router_affinity_hits_total").value >= 8
    finally:
        stop_tier(router, reps)


def test_rollout_raises_naming_its_subsystem(tmp_path):
    """``Router.rollout`` runs the rollout controller (serve/rollout.py):
    a 1-replica tier is refused by the controller's own rule, named in
    its ``RolloutError``; a 2-replica tier rolls onto an identical
    checkpoint through the op and ends DONE, token-exact."""
    from dtf_tpu_torch.serve.rollout import RolloutError
    router = Router(1, str(tmp_path / "one"))
    with pytest.raises(RolloutError, match="1-replica"):
        router.rollout("/some/checkpoint")

    router, reps = make_tier(tmp_path, 2)

    def hook(rid, ckpt):
        reps[rid].kill()
        reps[rid] = FakeReplica(rid, router.rendezvous_dir).start()

    stop = threading.Event()

    def pump():     # live greedy traffic: the canary gate's mirror
        while not stop.wait(0.03):
            router.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)

    traffic = threading.Thread(target=pump, daemon=True)
    traffic.start()
    try:
        state = router.rollout(
            "ckpt_new", old_checkpoint="ckpt_old", canary_requests=1,
            restart_hook=hook, warm_timeout_s=8.0, gate_timeout_s=20.0,
            poll_s=0.02, state_path=str(tmp_path / "state.json"))
        stop.set()
        traffic.join(timeout=5)
        assert state.phase == "DONE" and sorted(state.rolled) == [0, 1]
        p = np.arange(5, dtype=np.int32)
        assert router.generate(p, max_new_tokens=4).tokens == oracle(p, 4)
    finally:
        stop.set()
        stop_tier(router, reps)


def test_placement_literal_parity_with_config():
    """config/flags.py validates router_placement against a LITERAL
    copy of PLACEMENTS (Config must not import the serve stack) —
    keep them identical, and the JAX package's."""
    from dtf_tpu.serve.router import PLACEMENTS as JAX_PLACEMENTS
    from dtf_tpu_torch.config.flags import ROUTER_PLACEMENTS
    assert PLACEMENTS == ("affinity", "least_loaded", "random")
    assert ROUTER_PLACEMENTS == PLACEMENTS == JAX_PLACEMENTS


# ---------------------------------------------------------------------------
# degrade, never hang
# ---------------------------------------------------------------------------

def test_router_queue_wait_histogram_first_dispatch_only(tmp_path):
    """router_queue_wait_s records submit → FIRST dispatch for every
    dispatched request exactly once — the queueing-delay distribution
    the capacity simulator calibrates against."""
    router, reps = make_tier(tmp_path, 2)
    try:
        handles = [router.submit(np.arange(4, dtype=np.int32) + i,
                                 max_new_tokens=4) for i in range(6)]
        results = [h.result(timeout=20) for h in handles]
        hist = router.metrics.get("router_queue_wait_s")
        assert hist.count == 6, (
            f"expected one queue-wait sample per request, got "
            f"{hist.count}")
        snap = hist.snapshot()
        assert snap["min"] >= 0.0
        # queue wait is bounded by the full latency of the slowest
        # request — it is a PREFIX of the lifecycle, not the whole
        assert snap["max"] <= max(r.latency_s for r in results) + 0.5
    finally:
        stop_tier(router, reps)


def test_router_admission_bound_sheds_immediately(tmp_path):
    """Outstanding at the admission limit: the NEXT submit raises
    Backpressure synchronously — shed at the door, not queued into a
    hang."""
    router, reps = make_tier(
        tmp_path, 1, router_kw=dict(admission_limit=2),
        engine_kw=dict(tok_delay=0.2))
    try:
        p = np.arange(4, dtype=np.int32)
        h1 = router.submit(p, max_new_tokens=50)
        h2 = router.submit(p + 1, max_new_tokens=50)
        t0 = time.monotonic()
        with pytest.raises(Backpressure) as ei:
            router.submit(p + 2, max_new_tokens=4)
        assert time.monotonic() - t0 < 0.5
        assert ei.value.retry_after > 0
        assert router.metrics.get("router_shed_total").value == 1
        del h1, h2
    finally:
        stop_tier(router, reps)


def test_router_backpressure_propagates_not_retried(tmp_path):
    """Every live replica sheds the request: the Backpressure reaches
    the CLIENT (bounded time), instead of the router retry-storming
    the saturated tier."""
    router, reps = make_tier(tmp_path, 2)
    try:
        for r in reps:
            r.engine.draining = True   # every submit sheds retry_after
        t0 = time.monotonic()
        h = router.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
        with pytest.raises(Backpressure) as ei:
            h.result(timeout=5)
        assert time.monotonic() - t0 < 2.0, (
            "all-replicas-saturated Backpressure took unbounded time")
        assert ei.value.retry_after > 0
        assert router.metrics.get(
            "router_backpressure_relayed_total").value == 1
        # and the stream view raises too — a shed is never a short answer
        with pytest.raises(Backpressure):
            list(h.stream(timeout=1))
    finally:
        stop_tier(router, reps)


def test_router_deadline_exceeded_resolves_in_time(tmp_path):
    """A replica too slow for the deadline: the request resolves with
    DeadlineExceeded AT the deadline (not at the slow replica's
    pace) — every accepted request resolves within its deadline."""
    router, reps = make_tier(tmp_path, 1,
                             engine_kw=dict(tok_delay=0.5))
    try:
        t0 = time.monotonic()
        h = router.submit(np.arange(5, dtype=np.int32),
                          max_new_tokens=50, deadline_s=0.4)
        with pytest.raises(DeadlineExceeded):
            h.result(timeout=5)
        assert time.monotonic() - t0 < 1.5
        assert router.metrics.get(
            "router_deadline_exceeded_total").value == 1
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# failover: death, re-dispatch exactness, re-registration
# ---------------------------------------------------------------------------

def test_router_failover_token_exact_stream_dedupes(tmp_path):
    """Kill a replica mid-decode: its in-flight requests re-dispatch
    to the sibling and finish with the EXACT oracle tokens — and a
    streaming consumer sees every token exactly once (the re-
    dispatched attempt's replay is verified, not re-emitted)."""
    router, reps = make_tier(tmp_path, 2, engine_kw=dict(tok_delay=0.02))
    try:
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, 97, (6,)).astype(np.int32)
                   for _ in range(4)]
        handles = [router.submit(p, max_new_tokens=30) for p in prompts]
        streams = [[] for _ in handles]
        threads = [threading.Thread(
            target=lambda h=h, out=out: out.extend(h.stream(timeout=30)),
            daemon=True) for h, out in zip(handles, streams)]
        for t in threads:
            t.start()
        time.sleep(0.15)            # several tokens in on both replicas
        reps[0].kill()
        results = [h.result(timeout=30) for h in handles]
        for t in threads:
            t.join(timeout=30)
        assert router.metrics.get("router_failover_total").value >= 1
        redispatched = 0
        for r, p, s in zip(results, prompts, streams):
            want = oracle(p, 30)
            assert r.tokens == want
            assert s == want, "stream must dedupe the failover replay"
            assert not r.diverged
            redispatched += r.redispatches
        assert redispatched >= 1, "the kill should have stranded work"
    finally:
        stop_tier(router, reps)


def test_router_dead_replica_reregisters_and_serves(tmp_path):
    """A replica that died and came back (new port, same announce
    file) is folded back in by the prober and takes traffic again."""
    router, reps = make_tier(tmp_path, 2)
    try:
        reps[0].kill()
        t0 = time.monotonic()
        while router.replica_healthy(0) and time.monotonic() - t0 < 5:
            time.sleep(0.02)
        assert not router.replica_healthy(0)
        old_port = read_announce(reps[0].rdir, 0)["port"]
        reps[0] = FakeReplica(0, reps[0].rdir).start()
        assert read_announce(reps[0].rdir, 0)["port"] != old_port
        t0 = time.monotonic()
        while not router.replica_healthy(0) and time.monotonic() - t0 < 5:
            time.sleep(0.02)
        assert router.replica_healthy(0), "respawned replica never " \
            "re-registered"
        before = reps[0].engine.submitted
        # least-loaded on an idle tier prefers the lowest id: replica 0
        h = router.submit(np.arange(7, dtype=np.int32), max_new_tokens=4)
        assert h.result(timeout=10).tokens == oracle(
            np.arange(7, dtype=np.int32), 4)
        assert reps[0].engine.submitted + reps[1].engine.submitted > 0
    finally:
        stop_tier(router, reps)


def test_router_hedge_covers_a_stalled_replica(tmp_path):
    """hedge_s: a dispatched request with no progress gets a second,
    token-identical attempt on a sibling; first done wins."""
    router, reps = make_tier(
        tmp_path, 2, router_kw=dict(hedge_s=0.15,
                                    placement="least_loaded"),
        engine_kw=dict(tok_delay=0.004))
    try:
        reps[0].engine.tok_delay = 1.0   # replica 0 stalls, stays alive
        p = np.arange(9, dtype=np.int32)
        t0 = time.monotonic()
        h = router.submit(p, max_new_tokens=8)
        r = h.result(timeout=10)
        assert r.tokens == oracle(p, 8)
        assert time.monotonic() - t0 < 2.0, "hedge should beat the stall"
        assert router.metrics.get("router_hedge_total").value == 1
        assert r.replica == 1
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# chaos: the distributed fault kinds
# ---------------------------------------------------------------------------

def test_chaos_replica_kill_mid_traffic_token_exact(tmp_path):
    """replica_kill@req:N through the router's dispatch probe: the
    target dies holding work, everything still completes token-exact,
    zero lost requests."""
    chaos.configure("replica_kill@req:2", rank=0)
    router, reps = make_tier(tmp_path, 2, engine_kw=dict(tok_delay=0.02))
    try:
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, 97, (5,)).astype(np.int32)
                   for _ in range(6)]
        handles = [router.submit(p, max_new_tokens=20) for p in prompts]
        results = [h.result(timeout=30) for h in handles]
        for r, p in zip(results, prompts):
            assert r.tokens == oracle(p, 20)
        assert router.metrics.get("router_failover_total").value >= 1
        assert sum(r.engine.dead for r in reps) == 1
    finally:
        stop_tier(router, reps)


def test_chaos_net_partition_timeouts_then_heals(tmp_path):
    """net_partition@replica<K>:<ticks>: the router sees probe
    SILENCE (not a clean exit), declares the replica lost, re-routes;
    when the partition heals the replica re-registers — its process
    never died — and serves again."""
    # 12 ticks x 0.05s probe = 0.6s partition vs 0.3s health timeout
    chaos.configure("net_partition@replica1:12", rank=0)
    router, reps = make_tier(tmp_path, 2, engine_kw=dict(tok_delay=0.01))
    try:
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 97, (8,)).astype(np.int32)
                   for _ in range(8)]
        handles = [router.submit(p, max_new_tokens=12) for p in prompts]
        # traffic starts -> partition starts -> replica 1 goes unhealthy
        t0 = time.monotonic()
        saw_down = False
        while time.monotonic() - t0 < 3:
            if not router.replica_healthy(1):
                saw_down = True
                break
            time.sleep(0.02)
        assert saw_down, "partitioned replica never declared lost"
        results = [h.result(timeout=30) for h in handles]
        for r, p in zip(results, prompts):
            assert r.tokens == oracle(p, 12)
        # partition heals -> re-register (the process never died)
        t0 = time.monotonic()
        while not router.replica_healthy(1) and time.monotonic() - t0 < 5:
            time.sleep(0.02)
        assert router.replica_healthy(1), "replica did not re-register " \
            "after the partition healed"
        assert not reps[1].engine.dead
        before = reps[1].engine.submitted
        # FRESH prompts (no affinity owner): least-loaded fallback
        # spreads the concurrent burst over both replicas again
        hs = [router.submit(rng.integers(0, 97, (8,)).astype(np.int32),
                            max_new_tokens=4) for _ in range(8)]
        for h in hs:
            h.result(timeout=10)
        assert reps[1].engine.submitted > before, (
            "healed replica took no traffic")
    finally:
        stop_tier(router, reps)


def test_chaos_slow_replica_spec_reaches_engine(monkeypatch):
    """slow_replica@replica<K>:<F> latches only in the process whose
    rank == K, returns its factor, and records once."""
    chaos.configure("slow_replica@replica1:3", rank=1)
    assert chaos.slow_replica() == 3.0
    assert chaos.slow_replica() == 3.0     # latched, not one-shot
    chaos.configure("slow_replica@replica1:3", rank=0)
    assert chaos.slow_replica() == 0.0     # wrong replica: untouched


def test_router_replica_stats_roundtrip(tmp_path):
    router, reps = make_tier(tmp_path, 2)
    try:
        router.generate(np.arange(4, dtype=np.int32), max_new_tokens=3)
        stats = router.replica_stats(0, timeout=5)
        assert stats is not None and stats["replica"] == 0
        assert "outstanding" in stats
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# request-scoped distributed tracing over the wire
# ---------------------------------------------------------------------------

def test_trace_id_propagates_over_wire_and_failover(tmp_path):
    """The router mints one trace id per request, ships it over the
    REAL replica wire, and a failover's re-dispatch ships the SAME id
    to the sibling — so one request's whole cross-process life shares
    one id.  Token dedup across the replay is preserved (the client
    stream sees every token once), and the router's trace stream
    records the full lifecycle: submit → dispatch(attempt 1) →
    replica_lost/requeue → dispatch(attempt 2) → complete."""
    tdir = tmp_path / "trace"
    os.makedirs(tdir, exist_ok=True)
    trace.configure(str(tdir), stream="router")
    router, reps = make_tier(tmp_path, 2, engine_kw=dict(tok_delay=0.02))
    try:
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, 97, (6,)).astype(np.int32)
                   for _ in range(4)]
        handles = [router.submit(p, max_new_tokens=25) for p in prompts]
        streams = [[] for _ in handles]
        threads = [threading.Thread(
            target=lambda h=h, out=out: out.extend(h.stream(timeout=30)),
            daemon=True) for h, out in zip(handles, streams)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        reps[0].kill()
        results = [h.result(timeout=30) for h in handles]
        for t in threads:
            t.join(timeout=30)
        # every result exposes its trace id; all distinct
        tids = [r.trace_id for r in results]
        assert all(tids) and len(set(tids)) == len(tids)
        # an explicit caller-provided id round-trips
        h = router.submit(prompts[0], max_new_tokens=3,
                          trace_id="caller-tid")
        assert h.result(timeout=30).trace_id == "caller-tid"
        # the wire carried each id verbatim to the engines
        seen = [t for rep in reps for (t, _) in rep.engine.trace_ids]
        for tid in tids:
            assert tid in seen
        # a failed-over request's id reached BOTH replicas, replay
        # deduped (stream == result tokens == oracle, exactly once)
        victims = [(r, s, p) for r, s, p in
                   zip(results, streams, prompts) if r.redispatches]
        assert victims, "the kill should have stranded work"
        for r, s, p in victims:
            per_rep = [[t for (t, _) in rep.engine.trace_ids]
                       for rep in reps]
            assert all(r.trace_id in ts for ts in per_rep), (
                "the replayed request's trace id did not reach both "
                "replicas")
            want = oracle(p, 25)
            assert r.tokens == want and s == want
        # router-side lifecycle records, all under the one trace id
        trace.flush()
        recs = trace.read_records(str(tdir / "trace_router.jsonl"))
        victim = victims[0][0]
        mine = [r for r in recs if r.get("trace") == victim.trace_id]
        names = [r["name"] for r in mine]
        for needed in ("router_submit", "router_dispatch",
                       "router_requeue", "router_complete"):
            assert needed in names, f"missing {needed}: {names}"
        attempts = [r["attempt"] for r in mine
                    if r["name"] == "router_dispatch"]
        assert max(attempts) >= 2, "failover re-dispatch not recorded"
        # replica_lost carries the stranded requests' trace ids
        lost = [r for r in recs if r.get("name") == "replica_lost"]
        assert lost and victim.trace_id in lost[0].get("traces", [])
        # parent_span on the wire: the engines saw the router span id
        subs = [r for r in mine if r["name"] == "router_submit"]
        span = subs[0]["span_id"]
        parents = [pp for rep in reps
                   for (t, pp) in rep.engine.trace_ids
                   if t == victim.trace_id]
        assert parents and all(pp == span for pp in parents)
    finally:
        stop_tier(router, reps)
        trace.disable()


# ---------------------------------------------------------------------------
# per-request RNG seeds: sampled requests replay token-exactly
# ---------------------------------------------------------------------------

def test_sampled_failover_replays_token_exact(tmp_path):
    """SAMPLED (temperature > 0) requests carry a router-minted
    rng_seed on the wire; a failover re-dispatch ships the SAME seed,
    so the replay is token-exact — greedy's failover contract,
    extended to sampling."""
    router, reps = make_tier(tmp_path, 2, engine_kw=dict(tok_delay=0.02))
    try:
        rng = np.random.default_rng(9)
        prompts = [rng.integers(0, 97, (6,)).astype(np.int32)
                   for _ in range(4)]
        handles = [router.submit(p, max_new_tokens=25, temperature=1.0)
                   for p in prompts]
        streams = [[] for _ in handles]
        threads = [threading.Thread(
            target=lambda h=h, out=out: out.extend(h.stream(timeout=30)),
            daemon=True) for h, out in zip(handles, streams)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        reps[0].kill()
        results = [h.result(timeout=30) for h in handles]
        for t in threads:
            t.join(timeout=30)
        victims = [(r, s, p) for r, s, p in
                   zip(results, streams, prompts) if r.redispatches]
        assert victims, "the kill should have stranded work"
        all_seeds = [s for rep in reps for s in rep.engine.rng_seeds]
        assert all(s is not None for s in all_seeds), (
            "every wire submit must carry a rng_seed")
        for r, s, p in victims:
            # both replicas saw the SAME seed for this request, and
            # the final tokens are the seeded oracle's — i.e. the
            # replay reproduced the original sampling exactly
            seeds = {rep.engine.rng_seeds[i]
                     for rep in reps
                     for i, (t, _) in enumerate(rep.engine.trace_ids)
                     if t == r.trace_id}
            assert len(seeds) == 1, f"seed changed across failover: {seeds}"
            (seed,) = seeds
            want = oracle(p, 25, seed=seed, temperature=1.0)
            assert r.tokens == want
            assert s == want, "stream must dedupe the seeded replay"
            assert not r.diverged, (
                "a seeded sampled replay must not diverge")
        assert router.metrics.get(
            "router_redispatch_divergence_total").value == 0
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# CANCEL: stale attempts stop decoding
# ---------------------------------------------------------------------------

def test_cancel_on_deadline_frees_engine(tmp_path):
    """A deadline-exceeded request's in-flight attempt gets a wire
    CANCEL: the (fake) engine stops decoding and frees its slot
    instead of burning the full budget on a stale answer."""
    router, reps = make_tier(tmp_path, 1,
                             engine_kw=dict(tok_delay=0.2))
    try:
        h = router.submit(np.arange(5, dtype=np.int32),
                          max_new_tokens=50, deadline_s=0.4)
        with pytest.raises(DeadlineExceeded):
            h.result(timeout=5)
        assert router.metrics.get("router_cancel_sent_total").value >= 1
        t0 = time.monotonic()
        while (reps[0].engine.cancelled_count < 1
               and time.monotonic() - t0 < 5):
            time.sleep(0.02)
        assert reps[0].engine.cancelled_count == 1, (
            "the engine never acted on the CANCEL")
        assert reps[0].engine.outstanding == 0, (
            "the cancelled request still occupies the engine")
    finally:
        stop_tier(router, reps)


def test_cancel_on_losing_hedge(tmp_path):
    """First-done-wins hedging: the LOSING attempt is cancelled, not
    left to decode its full budget as a stale discard."""
    router, reps = make_tier(
        tmp_path, 2, router_kw=dict(hedge_s=0.15,
                                    placement="least_loaded"),
        engine_kw=dict(tok_delay=0.004))
    try:
        reps[0].engine.tok_delay = 1.0   # replica 0 stalls, stays alive
        p = np.arange(9, dtype=np.int32)
        r = router.submit(p, max_new_tokens=8).result(timeout=10)
        assert r.replica == 1
        assert router.metrics.get("router_cancel_sent_total").value >= 1
        t0 = time.monotonic()
        while (reps[0].engine.cancelled_count < 1
               and time.monotonic() - t0 < 5):
            time.sleep(0.02)
        assert reps[0].engine.cancelled_count == 1
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# prefix owner-map handoff
# ---------------------------------------------------------------------------

def test_prefix_owner_rehomes_to_warm_sibling(tmp_path):
    """When a replica dies, its chained-digest owner entries re-home
    to ONE warm sibling instead of dropping cold: the group's next
    requests all land together (one re-prefill, then warm), and the
    rehome counter + owner count prove it was the handoff."""
    router, reps = make_tier(tmp_path, 2, engine_kw=dict(tok_delay=0.01))
    try:
        ps = router.page_size
        rng = np.random.default_rng(21)
        group = rng.integers(0, 97, (2 * ps,)).astype(np.int32)
        # warm the group onto some replica
        router.submit(group, max_new_tokens=4).result(timeout=10)
        owner = next(i for i in range(2)
                     if router.prefix_owner_count(i) > 0)
        other = 1 - owner
        reps[owner].kill()
        t0 = time.monotonic()
        while router.replica_healthy(owner) and time.monotonic() - t0 < 5:
            time.sleep(0.02)
        assert router.metrics.get(
            "router_prefix_rehomed_total").value >= 1
        assert router.prefix_owner_count(owner) == 0
        assert router.prefix_owner_count(other) >= 1, (
            "the dead owner's digests were dropped, not re-homed")
        # the group's traffic now routes to the sibling as AFFINITY
        # hits (the owner map still answers), all to one replica
        hits0 = router.metrics.get("router_affinity_hits_total").value
        before = reps[other].engine.submitted
        hs = [router.submit(
            np.concatenate([group,
                            rng.integers(0, 97, (3,)).astype(np.int32)]),
            max_new_tokens=4) for _ in range(4)]
        for h in hs:
            h.result(timeout=10)
        assert reps[other].engine.submitted - before == 4
        assert router.metrics.get(
            "router_affinity_hits_total").value - hits0 >= 4
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# cross-host rendezvous: host:port announce
# ---------------------------------------------------------------------------

def test_cross_host_rendezvous_second_address(tmp_path):
    """A replica bound to a second address (127.0.0.2 — standing in
    for another host) announces host:port; the router dials the
    ANNOUNCED host, not a hardcoded loopback — the cross-host fabric
    contract, exercised without needing two machines."""
    rdir = str(tmp_path / "rdv")
    os.makedirs(rdir, exist_ok=True)
    reps = [FakeReplica(0, rdir, host="127.0.0.2").start(),
            FakeReplica(1, rdir).start()]
    ann = read_announce(rdir, 0)
    assert ann["host"] == "127.0.0.2", (
        "the announce must carry the replica's dialable host")
    router = Router(2, rdir, probe_interval_s=0.05,
                    health_timeout_s=0.3, deadline_s=30.0,
                    replica_inflight=32, page_size=8,
                    kill_hook=lambda rid: reps[rid].kill())
    router.start(wait_s=10)
    try:
        # force traffic onto the cross-host replica: drain the local
        # one so placement has exactly one choice
        reps[1].engine.draining = True
        p = np.arange(5, dtype=np.int32)
        r = router.submit(p, max_new_tokens=6).result(timeout=10)
        assert r.tokens == oracle(p, 6)
        assert r.replica == 0
        assert reps[0].engine.submitted >= 1
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# model-version affinity (the rollout's no-mixed-stream invariant)
# ---------------------------------------------------------------------------

def test_version_affinity_pins_failover_to_same_model(tmp_path):
    """A request latched to model version A never fails over to a
    version-B replica: it waits (deadline-bounded) until an A replica
    returns, then completes token-exact — a client stream is NEVER a
    mix of two checkpoints."""
    router, reps = make_tier(tmp_path, 2, engine_kw=dict(tok_delay=0.05))
    try:
        router.set_replica_version(0, "old")
        router.set_replica_version(1, "new")
        # force the request onto replica 0 ("old")
        router.set_shadow(1, True)
        p = np.arange(7, dtype=np.int32)
        h = router.submit(p, max_new_tokens=30)
        time.sleep(0.15)           # a few tokens in on replica 0
        router.set_shadow(1, False)
        reps[0].kill()
        # replica 1 is healthy but serves "new" — the request must NOT
        # land there; it waits for an "old" replica
        time.sleep(1.0)
        assert not h.done(), (
            "the version-latched request ran on the wrong model")
        before = reps[1].engine.submitted
        reps[0] = FakeReplica(0, reps[0].rdir,
                              tok_delay=0.05).start()
        r = h.result(timeout=15)
        assert r.tokens == oracle(p, 30)
        assert reps[1].engine.submitted == before, (
            "the new-version replica served an old-version request")
        assert router.metrics.get("router_mixed_model_total").value == 0
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# disaggregation (pool roles + chain migration orchestration)
# ---------------------------------------------------------------------------

def test_disagg_validation():
    with pytest.raises(ValueError, match="decode replica"):
        Router(2, "/tmp/x", prefill_replicas=2)
    with pytest.raises(ValueError, match="affinity"):
        Router(3, "/tmp/x", prefill_replicas=1,
               placement="least_loaded")


def test_disagg_cold_prompts_route_to_prefill_pool(tmp_path):
    """With a 1+1 split, cold paged prompts land in the prefill pool
    even when the decode replica is less loaded."""
    router, reps = make_tier(tmp_path, 2,
                             router_kw=dict(prefill_replicas=1))
    try:
        for salt in range(3):
            p = (np.arange(1, 17, dtype=np.int32) + 11 * salt) % 97
            r = router.generate(p, max_new_tokens=4)
            assert r.tokens == oracle(p, 4)
            assert r.replica == 0, (
                "cold paged prompt left the prefill pool")
    finally:
        stop_tier(router, reps)


def test_disagg_migration_failure_never_loses_a_request(tmp_path):
    """FakeEngine has no migration surface, so every migrate_in is
    refused (ok=false) — the router must count the failure and keep
    serving token-exactly: migration failure is an efficiency loss,
    never a correctness event."""
    router, reps = make_tier(tmp_path, 2,
                             router_kw=dict(prefill_replicas=1))
    try:
        p = np.arange(1, 17, dtype=np.int32)     # 2 full pages @ ps=8
        r1 = router.generate(p, max_new_tokens=6)
        assert r1.tokens == oracle(p, 6) and r1.replica == 0
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            ms = router.migration_stats()
            if ms["failed"]:
                break
            time.sleep(0.05)
        assert ms["failed"] >= 1 and ms["migrated"] == 0
        assert ms["pending"] == 0
        # the chain stays affinity-homed at the source; traffic flows
        r2 = router.generate(p, max_new_tokens=6)
        assert r2.tokens == oracle(p, 6) and r2.replica == 0
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# the JAX router and the port's, one scripted scenario
# ---------------------------------------------------------------------------

def _jax_pkg():
    from dtf_tpu.obs.watchdog import Heartbeat as JaxHeartbeat
    from dtf_tpu.obs.watchdog import heartbeat_path as jax_heartbeat_path
    from dtf_tpu.serve.engine import Backpressure as JaxBackpressure
    from dtf_tpu.serve.replica import ReplicaServer as JaxReplicaServer
    from dtf_tpu.serve.router import DeadlineExceeded as JaxDeadline
    from dtf_tpu.serve.router import Router as JaxRouter
    return dict(Router=JaxRouter, ReplicaServer=JaxReplicaServer,
                Heartbeat=JaxHeartbeat, heartbeat_path=jax_heartbeat_path,
                Backpressure=JaxBackpressure, DeadlineExceeded=JaxDeadline)


def _resolve(pkg, handle):
    """(kind, tokens, replica) of one request's resolution."""
    try:
        r = handle.result(timeout=20)
    except pkg["Backpressure"]:
        return ("Backpressure", None, None)
    except pkg["DeadlineExceeded"]:
        return ("DeadlineExceeded", None, None)
    return ("tokens", r.tokens, r.replica)


def _scenario(pkg, tmp_path, placement):
    """Three prompt families (a 2-page system prompt each): the heads
    warm concurrently, then a burst of siblings and extras runs into
    the admission bound, then one request overruns its deadline.
    Returns each request's (family, kind, tokens, replica)."""
    router, reps = make_tier(
        tmp_path, 2, pkg=pkg, engine_kw=dict(tok_delay=0.01),
        router_kw=dict(placement=placement, admission_limit=8))
    rng = np.random.default_rng(21)
    fams = [rng.integers(0, 97, (16,)).astype(np.int32) for _ in range(3)]

    def prompt(f):
        return np.concatenate([fams[f], rng.integers(0, 97, (3,))
                               .astype(np.int32)])

    out = []

    def submit_all(plan, n_new):
        handles = []
        for f in plan:
            try:
                handles.append((f, router.submit(prompt(f),
                                                 max_new_tokens=n_new)))
            except pkg["Backpressure"]:
                handles.append((f, None))     # shed at the door
        for f, h in handles:
            out.append((f,) + (_resolve(pkg, h) if h is not None
                               else ("Backpressure", None, None)))

    try:
        submit_all([0, 1, 2], 6)                    # warm the heads
        submit_all([0, 1, 2] * 2 + [0, 1, 2, 0], 6)  # 10 vs admission 8
        h = router.submit(prompt(1), max_new_tokens=40, deadline_s=0.05)
        out.append((1,) + _resolve(pkg, h))
    finally:
        stop_tier(router, reps)
    return out


@pytest.mark.parametrize("placement", ["affinity", "least_loaded"])
def test_scenario_parity_with_jax_router(tmp_path, placement):
    """The JAX Router + ReplicaServer and the port's, over the same fake
    engine and script, resolve every request alike: the same tokens,
    the same kind, and under affinity the same replica per family."""
    got = _scenario(PORT, tmp_path / "port", placement)
    want = _scenario(_jax_pkg(), tmp_path / "jax", placement)
    assert [g[:3] for g in got] == [w[:3] for w in want]
    kinds = [g[1] for g in got]
    assert kinds.count("Backpressure") == 2
    assert kinds[-1] == "DeadlineExceeded"
    assert kinds.count("tokens") == len(got) - 3
    if placement == "affinity":
        assert [g[3] for g in got] == [w[3] for w in want]
        homes = {}
        for fam, kind, _, rep in got:
            if kind == "tokens":
                assert homes.setdefault(fam, rep) == rep, (
                    f"family {fam} left its replica")
        assert set(homes.values()) == {0, 1}


# ---------------------------------------------------------------------------
# the real subprocess path: router_main's replicas as processes
# ---------------------------------------------------------------------------

ROUTER_ARGV = ["--serve_random_init", "--device", "cpu",
               "--model", "transformer_small", "--num_classes", "256",
               "--router_replicas", "2", "--serve_max_new_tokens", "8",
               "--heartbeat_secs", "0.5", "--router_health_timeout_s", "10"]


@pytest.mark.slow
def test_router_main_subprocess_replicas_kill_respawn(tmp_path):
    """``router_main --device cpu`` spawns two ``replica_main``
    processes; a ``replica_kill`` mid-burst SIGKILLs one, every request
    resolves, and the router respawns the replica.  The same spawn
    path (``replica_command`` + ``replica_spawner``) under an in-process
    Router returns the tokens, which equal one in-process engine's."""
    from dtf_tpu_torch.cli import router_main
    from dtf_tpu_torch.cli.serve_main import build_serving_engine
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.serve.router import replica_spawner

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    rdv = str(tmp_path / "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.cli.router_main",
         *ROUTER_ARGV, "--serve_requests", "8", "--rendezvous_dir", rdv,
         "--fault", "replica_kill@replica0:req:4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = [ln for ln in proc.stderr.splitlines() if "Router stats:" in ln]
    assert stats, proc.stderr[-3000:]
    import ast
    stats = ast.literal_eval(stats[-1].split("Router stats:", 1)[1].strip())
    assert stats["completed"] == 8 and stats["failovers"] >= 1
    assert stats["respawns"] >= 1
    assert os.path.exists(os.path.join(rdv, "replica0.retry1.log"))

    # the same spawn path, driven from here: tokens against one engine
    cfg = parse_flags(ROUTER_ARGV[1:], defaults=router_main.ROUTER_DEFAULTS)
    rdv = str(tmp_path / "lib")
    cfg = cfg.replace(rendezvous_dir=rdv)
    spawn = replica_spawner(router_main.replica_command(cfg, True), rdv,
                            env_extra={"OMP_NUM_THREADS": "1"})
    router = Router(2, rdv, spawn=spawn, page_size=cfg.kv_page_size,
                    probe_interval_s=0.5, health_timeout_s=10.0,
                    deadline_s=300.0)
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(0, 256, (32,)).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, rng.integers(
        0, 256, (int(rng.integers(1, 9)),)).astype(np.int32)])
        for _ in range(8)]
    chaos.configure("replica_kill@req:4", rank=0)
    router.start(wait_s=300)
    try:
        results = [h.result(timeout=300) for h in
                   [router.submit(p, max_new_tokens=8) for p in prompts]]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not all(
                router.replica_healthy(i) for i in range(2)):
            time.sleep(0.1)
        assert all(router.replica_healthy(i) for i in range(2))
        assert router.metrics.get("router_replica_respawns_total").value == 1
        assert router.metrics.get("router_failover_total").value >= 1
        again = router.generate(prompts[0], max_new_tokens=8)
    finally:
        chaos.disable()
        router.stop(drain=True)
    _, engine = build_serving_engine(cfg, random_init=True)
    try:
        want = [engine.generate(p, max_new_tokens=8).tokens for p in prompts]
    finally:
        engine.stop()
    assert [r.tokens for r in results] == want
    assert again.tokens == want[0]
    assert all(r.redispatches == 0 or not r.diverged for r in results)



# ---------------------------------------------------------------------------
# an adopted replica on another host: the epoch-fenced stop op
# ---------------------------------------------------------------------------

def test_adopted_replica_on_another_host_is_stopped_by_epoch(tmp_path):
    """A ``replica_main`` process announcing a routable ``--serve_host``
    (127.0.0.2: dialable here, not a loopback name, so its pid means
    nothing to a router) is adopted by an epoch-3 router that owns the
    tier.  A stop carrying a stale epoch is refused and the process
    lives; the router's terminate sends its own epoch's stop, and the
    process drains and exits 0.  The JAX router only disconnects it."""
    import json
    import socket

    rdv = str(tmp_path / "rdv")
    os.makedirs(rdv)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dtf_tpu_torch.cli.replica_main",
         "--serve_random_init", "--device", "cpu", "--model",
         "transformer_small", "--num_classes", "64",
         "--serve_max_seq_len", "64", "--heartbeat_secs", "0.2",
         "--rendezvous_dir", rdv, "--replica_id", "0",
         "--serve_host", "127.0.0.2"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    router = None
    try:
        deadline = time.monotonic() + 120
        while read_announce(rdv, 0) is None and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        ann = read_announce(rdv, 0)
        assert ann is not None and ann["host"] == "127.0.0.2", ann
        # the tier's epoch is 3 (an earlier controller's op); a stop
        # from epoch 2 is stale
        with socket.create_connection(("127.0.0.2", ann["port"]),
                                      timeout=10) as conn:
            rfile = conn.makefile("r")
            conn.sendall(b'{"op": "stats", "epoch": 3}\n')
            assert json.loads(rfile.readline())["op"] == "stats"
            conn.sendall(b'{"op": "stop", "epoch": 2}\n')
            reply = json.loads(rfile.readline())
            assert reply["op"] == "stale_epoch" and reply["current"] == 3
        time.sleep(0.5)
        assert proc.poll() is None, "a stale-epoch stop ended the replica"

        def no_spawn(rid, gen):
            raise AssertionError("the adopted tier must not be respawned")

        router = Router(1, rdv, spawn=no_spawn, epoch=3,
                        probe_interval_s=0.05, health_timeout_s=5.0,
                        deadline_s=30.0)
        router.start(wait_s=30, adopt=True)
        router.hold_replica(0)
        router.terminate_replica(0, timeout=1.0)
        assert proc.wait(timeout=60) == 0
    finally:
        if router is not None:
            router.stop(drain=False)
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


class _Sink:
    """A replica connection's write side that keeps what it was sent."""

    def __init__(self):
        self.sent = []

    def write(self, data):
        self.sent.append(json.loads(data))

    def flush(self):
        pass


@pytest.mark.parametrize("held", [False, True])
def test_heal_prefetch_skips_a_held_replica(tmp_path, held):
    """The heal-time prefetch pulls the hottest chain into a replica
    that comes back -- but not into one a rollout holds (its
    replacement or canary, draining until released): the controller
    may stop it mid-pull, failing a migration with no replica lost
    (seen on the card in the HA/rollout phase)."""
    router = Router(2, str(tmp_path / "r"))
    try:
        digests = ["d0", "d1"]
        with router._mu:
            owner, back = router._replicas[1], router._replicas[0]
            owner.healthy, owner.port = True, 1234
            back.healthy, back.wfile = True, _Sink()
            back.draining = held
            router._prefix_owner["d1"] = 1
            router._chain_heat["d1"] = (5, digests, [1, 2, 3])
            router._maybe_prefetch_locked(back)
            migrations = dict(router._migrations)
        assert bool(migrations) == (not held)
        assert [m["op"] for m in back.wfile.sent] == (
            [] if held else ["migrate_in"])
    finally:
        router.stop(drain=False)
