"""The port's router high availability (``dtf_tpu_torch/serve/ha.py``
over ``serve/journal.py`` and ``serve/router.py``): the request journal,
the fenced leader lease and crash-exact takeover with in-flight
re-adoption -- the cases of tests/test_router_ha.py, here over the
port's modules.

The replicas are real port ``ReplicaServer``s over the deterministic
fake engine of tests/test_torch_router.py, in process; a router's
"crash" freezes it the way a SIGKILL leaves it (loops stopped, sockets
severed, nothing resolved, the journal's tail as it is).  Then the two
packages against each other: a lease written by either package's
``LeaderLease`` is read, expired and fenced alike by the other's, and
a journal and a live tier left by either package's router are taken
over by the other's.  Last, the real processes (slow): ``router_main
--router_ha`` killed by ``router_kill`` with a ``--router_standby``
process taking over and rolling the tier onto an export of JAX params.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dtf_tpu import chaos as jax_chaos
from dtf_tpu.serve import ha as jax_ha
from dtf_tpu_torch import chaos
from dtf_tpu_torch.serve import ha
from dtf_tpu_torch.serve import journal as journal_mod
from dtf_tpu_torch.serve.router import Router
from test_torch_router import PORT, FakeReplica, _jax_pkg, oracle

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    yield
    chaos.disable()
    jax_chaos.disable()


# ---------------------------------------------------------------------------
# journal: replay semantics under the failure modes appends create
# ---------------------------------------------------------------------------

def _jpath(tmp_path):
    return journal_mod.journal_path(str(tmp_path))


def test_journal_roundtrip_and_unresolved(tmp_path):
    j = journal_mod.RequestJournal(_jpath(tmp_path))
    j.submit("1", prompt=[5, 6], max_new_tokens=8, temperature=0.0,
             eos_id=None, rng_seed=42, trace="t1")
    j.dispatch("1", 0, 1)
    j.first_token("1")
    j.watermark("1", 4)
    j.complete("1", ok=True)
    j.submit("2", prompt=[7], max_new_tokens=8, temperature=0.5,
             eos_id=3, rng_seed=7, trace="t2")
    j.dispatch("2", 0, 0)
    j.dispatch("2", 1, 1)          # failover re-dispatch
    j.close()
    state = journal_mod.replay(_jpath(tmp_path))
    assert state["1"]["complete"]["ok"] is True
    assert state["1"]["first_token"] and state["1"]["watermark"] == 4
    left = journal_mod.unresolved(state)
    assert list(left) == ["2"]
    # everything a successor needs to re-dispatch bit-identically
    sub = left["2"]["submit"]
    assert sub["prompt"] == [7] and sub["rng_seed"] == 7
    assert sub["eos_id"] == 3 and sub["temperature"] == 0.5
    # last dispatch wins as the reattach target
    assert left["2"]["dispatches"][-1]["replica"] == 1


def test_journal_torn_tail_dropped(tmp_path):
    j = journal_mod.RequestJournal(_jpath(tmp_path))
    j.submit("1", prompt=[5], max_new_tokens=4, temperature=0.0,
             eos_id=None, rng_seed=1, trace="t")
    j.dispatch("1", 0, 0)
    j.close()
    # the signature of a router killed mid-append: a final line with
    # no newline and truncated JSON
    with open(_jpath(tmp_path), "a", encoding="utf-8") as f:
        f.write('{"t":"complete","id":"1","ok":tr')
    state = journal_mod.replay(_jpath(tmp_path))
    # the torn complete is DROPPED — request 1 is still unresolved,
    # which is the safe direction (a successor finishes it; finishing
    # a finished request is dedupe's job, losing one is forever)
    assert state["1"]["complete"] is None
    assert "1" in journal_mod.unresolved(state)


def test_journal_duplicates_idempotent(tmp_path):
    p = _jpath(tmp_path)
    with open(p, "w", encoding="utf-8") as f:
        for rec in [
            {"t": "submit", "id": "1", "prompt": [5], "max_new_tokens": 4,
             "temperature": 0.0, "eos_id": None, "rng_seed": 1,
             "trace": "a", "ts": 0},
            {"t": "submit", "id": "1", "prompt": [9], "max_new_tokens": 4,
             "temperature": 0.0, "eos_id": None, "rng_seed": 2,
             "trace": "b", "ts": 1},            # duplicate: first wins
            {"t": "watermark", "id": "1", "n": 8, "ts": 2},
            {"t": "watermark", "id": "1", "n": 3, "ts": 3},  # max wins
            {"t": "complete", "id": "1", "ok": True, "ts": 4},
            {"t": "complete", "id": "1", "ok": False, "ts": 5},  # dup
            {"t": "dispatch", "id": "1", "attempt": 9, "replica": 0,
             "ts": 6},                          # post-complete: ignored
            {"t": "complete", "id": "ghost", "ok": True, "ts": 7},
        ]:
            f.write(json.dumps(rec) + "\n")
    state = journal_mod.replay(p)
    st = state["1"]
    assert st["submit"]["prompt"] == [5] and st["submit"]["rng_seed"] == 1
    assert st["watermark"] == 8
    assert st["complete"]["ok"] is True        # first complete wins
    assert st["dispatches"] == []              # none before completion
    assert "ghost" not in state                # complete without submit
    assert journal_mod.unresolved(state) == {}


# ---------------------------------------------------------------------------
# leader lease: mutual exclusion, fencing, stalls
# ---------------------------------------------------------------------------

def test_lease_mutual_exclusion_and_fencing(tmp_path):
    rdir = str(tmp_path)
    a = ha.LeaderLease(rdir, ttl_s=0.3, holder="a")
    b = ha.LeaderLease(rdir, ttl_s=0.3, holder="b")
    assert a.acquire() == 1
    assert b.acquire() is None          # live holder protects the lease
    assert a.renew() is True
    time.sleep(0.45)                    # a stops renewing: lease ages out
    assert b.acquire() == 2             # monotonic epoch bump
    assert a.renew() is False           # the FENCED verdict, latched
    assert a.fenced
    assert a.renew() is False
    b.release()
    assert ha.read_lease(rdir) is None  # clean release frees the lease


def test_lease_stall_chaos_lets_standby_take_over(tmp_path):
    """lease_stall@2 drops exactly two renewal writes — the
    deterministic GC-pause/storage-brownout stand-in — so the lease
    ages out under a perfectly live leader and the standby fences it."""
    rdir = str(tmp_path)
    a = ha.LeaderLease(rdir, ttl_s=0.3, holder="a")
    assert a.acquire() == 1
    ts0 = ha.read_lease(rdir)["ts"]
    chaos.configure("lease_stall@2", rank=0)
    assert a.renew() is True            # tick happens, write doesn't
    assert a.renew() is True
    assert ha.read_lease(rdir)["ts"] == ts0
    time.sleep(0.35)
    b = ha.LeaderLease(rdir, ttl_s=0.3, holder="b")
    epoch = ha.wait_for_takeover(b, poll_s=0.02, timeout_s=5.0)
    assert epoch == 2
    assert a.renew() is False and a.fenced


def test_lease_keeper_fences_router(tmp_path):
    """LeaseKeeper renews in the background and fences its router the
    moment a usurper's epoch appears — /healthz flips out of ok."""
    rdir = str(tmp_path / "rdv")
    rep = FakeReplica(0, rdir).start()
    lease = ha.LeaderLease(rdir, ttl_s=0.2, holder="a")
    assert lease.acquire() == 1
    router = Router(1, rdir, probe_interval_s=0.05, health_timeout_s=0.5,
                    epoch=1)
    router.start(wait_s=10)
    keeper = ha.LeaseKeeper(lease, on_fenced=router.fence).start()
    try:
        h = router.health()
        assert h["ok"] and h["role"] == "leader" and h["epoch"] == 1
        assert h["fenced"] is False
        # a usurper takes the lease by force (operator override path)
        ha.LeaderLease(rdir, ttl_s=0.2, holder="b").acquire(force=True)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not router.health()["fenced"]:
            time.sleep(0.02)
        h = router.health()
        assert h["fenced"] and not h["ok"]
        with pytest.raises(RuntimeError, match="fenced"):
            router.submit([5, 6, 7])
    finally:
        keeper.stop()
        router.stop(drain=False)
        rep.kill()


def test_standby_health_payload(tmp_path):
    lease = ha.LeaderLease(str(tmp_path), ttl_s=0.5, holder="s")
    h = ha.standby_health(lease)
    assert h["ok"] and h["role"] == "standby" and h["epoch"] == 0
    assert h["lease_expired"] is True
    ha.LeaderLease(str(tmp_path), ttl_s=0.5, holder="l").acquire()
    h = ha.standby_health(lease)
    assert h["epoch"] == 1 and h["lease_expired"] is False


# ---------------------------------------------------------------------------
# chaos grammar
# ---------------------------------------------------------------------------

def test_chaos_grammar_router_ha_kinds():
    specs = chaos.parse_spec("router_kill@req:2, lease_stall@3")
    assert [str(s) for s in specs] == ["router_kill@req:2",
                                      "lease_stall@ticks:3"]
    with pytest.raises(ValueError, match="lease_stall"):
        chaos.parse_spec("lease_stall@ticks:0")
    with pytest.raises(ValueError, match="router_kill"):
        chaos.parse_spec("router_kill@latest")


def test_chaos_router_kill_fires_crash_hook(tmp_path):
    """router_kill@req:N crashes the router at its Nth dispatch — in
    process, via the crash hook (the smoke uses the real os._exit)."""
    rdir = str(tmp_path / "rdv")
    rep = FakeReplica(0, rdir, tok_delay=0.001).start()
    crashed = threading.Event()
    router = Router(1, rdir, probe_interval_s=0.05, health_timeout_s=0.5,
                    crash_hook=crashed.set)
    router.start(wait_s=10)
    try:
        chaos.configure("router_kill@req:1", rank=0)
        assert router.generate(
            [5, 6], max_new_tokens=4).tokens == oracle([5, 6], 4)
        router.submit([7, 8], max_new_tokens=4)
        assert crashed.wait(5.0)
    finally:
        router.stop(drain=False)
        rep.kill()


# ---------------------------------------------------------------------------
# takeover: crash-exact re-adoption of in-flight requests
# ---------------------------------------------------------------------------

def _freeze(router):
    """Simulate router death in-process: loops stop, sockets drop,
    NOTHING resolves — the successor recovers from exactly what a
    SIGKILL leaves behind (the replicas keep decoding into their
    retained tails; the journal keeps its unsynced-but-flushed tail)."""
    with router._mu:
        router._stopping = True
        router._mu.notify_all()
    for rep in router._replicas:
        conn = rep.conn
        if conn is not None:
            try:
                # shutdown, not just close: the reader thread holds the
                # socket open through its makefile() wrapper — a real
                # SIGKILL severs the TCP stream, so must this
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        router._close_conn(rep)


def _ha_tier(tmp_path, n=2, tok_delay=0.01, pkg=None):
    """A journaling epoch-1 router over ``n`` fake replicas, of the
    port's package or (``pkg``) the JAX package's."""
    pkg = pkg or PORT
    rdir = str(tmp_path / "rdv")
    os.makedirs(rdir, exist_ok=True)
    reps = [FakeReplica(i, rdir, pkg=pkg, tok_delay=tok_delay).start()
            for i in range(n)]
    router = pkg["Router"](n, rdir, probe_interval_s=0.05,
                           health_timeout_s=0.5, deadline_s=30.0,
                           page_size=8,
                           journal_path=journal_mod.journal_path(rdir),
                           epoch=1)
    router.start(wait_s=10)
    return router, reps, rdir


def _collect(handle, out, timeout=0.8):
    """Client-side stream consumer: drains tokens until the request
    resolves or the stream goes silent (= the router died)."""

    def run():
        try:
            for t in handle.stream(timeout=timeout):
                out.append(t)
        except (TimeoutError, RuntimeError):
            pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_takeover_reattach_exactly_once(tmp_path):
    """Leader dies mid-stream with live replicas: the successor replays
    the journal, REATTACHES each request where its engine kept decoding,
    and with the client-echoed delivered prefix every stream sees each
    token exactly once — full sequence token-exact vs the oracle."""
    router1, reps, rdir = _ha_tier(tmp_path)
    prompts = [[5, 6, 7], [11, 12], [3, 1, 4, 1, 5]]
    n_tok = 48
    try:
        handles = [router1.submit(p, max_new_tokens=n_tok)
                   for p in prompts]
        got = [[] for _ in prompts]
        threads = [_collect(h, g) for h, g in zip(handles, got)]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and not all(len(g) >= 4 for g in got):
            time.sleep(0.01)
        assert all(len(g) >= 4 for g in got), "streams never started"
        _freeze(router1)
        for t in threads:
            t.join(timeout=5.0)        # drain everything pre-crash
        delivered = {h.request.id: list(g)
                     for h, g in zip(handles, got)}
        assert all(len(v) < n_tok for v in delivered.values())

        router2 = Router(len(reps), rdir, probe_interval_s=0.05,
                         health_timeout_s=0.5, deadline_s=30.0,
                         page_size=8,
                         journal_path=journal_mod.journal_path(rdir),
                         epoch=2, role="leader")
        router2.start(wait_s=10, adopt=True)
        try:
            summary = ha.take_over(router2, delivered=delivered,
                                   resume_rollout=False)
            # every request found its engine still decoding
            assert summary["readopted"] == len(prompts)
            assert summary["redispatched"] == 0
            for h, p, pre in zip(handles, prompts, got):
                nh = summary["handles"][h.request.id]
                tail = list(nh.stream(timeout=10.0))
                want = oracle(p, n_tok)
                # exactly-once across the death: the resumed stream
                # starts right after the acknowledged prefix
                assert list(pre) + tail == want
                res = nh.result(timeout=10)
                assert res.tokens == want and not res.diverged
        finally:
            router2.stop(drain=False)
    finally:
        router1.stop(drain=False)
        for r in reps:
            r.kill()


def test_takeover_watermark_sentinels_without_client_echo(tmp_path):
    """No client echo on reconnect: the journal's delivery watermark
    seeds -1 sentinels, the reattach replay FILLS them (verify, not
    re-emit), and at most one watermark-cadence of tail re-emits —
    the final token sequence is still exact and undiverged."""
    router1, reps, rdir = _ha_tier(tmp_path)
    prompt, n_tok = [9, 9, 8], 40
    try:
        h = router1.submit(prompt, max_new_tokens=n_tok)
        got = []
        th = _collect(h, got)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(got) < 20:
            time.sleep(0.01)
        assert len(got) >= 20
        _freeze(router1)
        th.join(timeout=5.0)
        # the journal recorded a watermark at the 16-token cadence
        state = journal_mod.replay(journal_mod.journal_path(rdir))
        assert state[str(h.request.id)]["watermark"] >= 16

        router2 = Router(len(reps), rdir, probe_interval_s=0.05,
                         health_timeout_s=0.5, deadline_s=30.0,
                         page_size=8,
                         journal_path=journal_mod.journal_path(rdir),
                         epoch=2)
        router2.start(wait_s=10, adopt=True)
        try:
            summary = ha.take_over(router2, resume_rollout=False)
            assert summary["readopted"] == 1
            nh = summary["handles"][h.request.id]
            res = nh.result(timeout=10)
            assert res.tokens == oracle(prompt, n_tok)
            assert not res.diverged
        finally:
            router2.stop(drain=False)
    finally:
        router1.stop(drain=False)
        for r in reps:
            r.kill()


def test_takeover_dead_replica_falls_to_redispatch(tmp_path):
    """The replica died DURING the router outage: no reattach target,
    so the successor re-dispatches through ordinary budgeted failover —
    the journaled rng_seed replays the stream token-exactly and the
    client-echoed prefix keeps it exactly-once."""
    router1, reps, rdir = _ha_tier(tmp_path)
    prompt, n_tok = [2, 7, 1, 8], 32
    try:
        h = router1.submit(prompt, max_new_tokens=n_tok)
        got = []
        th = _collect(h, got)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(got) < 4:
            time.sleep(0.01)
        assert len(got) >= 4
        _freeze(router1)
        th.join(timeout=5.0)
        # the replica that held it dies during the outage
        state = journal_mod.replay(journal_mod.journal_path(rdir))
        holder = state[str(h.request.id)]["dispatches"][-1]["replica"]
        reps[holder].kill()

        router2 = Router(len(reps), rdir, probe_interval_s=0.05,
                         health_timeout_s=0.5, deadline_s=30.0,
                         page_size=8,
                         journal_path=journal_mod.journal_path(rdir),
                         epoch=2)
        router2.start(wait_s=0, adopt=True)   # can't wait: one is dead
        try:
            survivor = 1 - holder
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline \
                    and not router2.replica_healthy(survivor):
                time.sleep(0.02)
            assert router2.replica_healthy(survivor)
            summary = ha.take_over(
                router2, delivered={h.request.id: list(got)},
                resume_rollout=False)
            assert summary["redispatched"] == 1
            nh = summary["handles"][h.request.id]
            tail = list(nh.stream(timeout=15.0))
            want = oracle(prompt, n_tok)
            assert list(got) + tail == want
            res = nh.result(timeout=10)
            assert res.tokens == want and not res.diverged
            assert res.replica == survivor
        finally:
            router2.stop(drain=False)
    finally:
        router1.stop(drain=False)
        for r in reps:
            try:
                r.kill()
            except Exception:
                pass


def test_takeover_respawned_replica_nacks_then_redispatches(tmp_path):
    """The replica RESTARTED during the outage (healthy, but its
    retained tails died with the old process): reattach gets a nack
    and the request falls to budgeted failover re-dispatch."""
    router1, reps, rdir = _ha_tier(tmp_path)
    prompt, n_tok = [6, 6, 6], 32
    try:
        h = router1.submit(prompt, max_new_tokens=n_tok)
        got = []
        th = _collect(h, got)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(got) < 4:
            time.sleep(0.01)
        assert len(got) >= 4
        _freeze(router1)
        th.join(timeout=5.0)
        state = journal_mod.replay(journal_mod.journal_path(rdir))
        holder = state[str(h.request.id)]["dispatches"][-1]["replica"]
        reps[holder].kill()
        # a fresh process takes the same slot: announces anew, retains
        # nothing
        reps[holder] = FakeReplica(holder, rdir,
                                   tok_delay=0.01).start()

        router2 = Router(len(reps), rdir, probe_interval_s=0.05,
                         health_timeout_s=0.5, deadline_s=30.0,
                         page_size=8,
                         journal_path=journal_mod.journal_path(rdir),
                         epoch=2)
        router2.start(wait_s=10, adopt=True)
        try:
            summary = ha.take_over(
                router2, delivered={h.request.id: list(got)},
                resume_rollout=False)
            # the reattach was SENT (replica looks alive) — the nack
            # converts it to a re-dispatch asynchronously
            nh = summary["handles"][h.request.id]
            tail = list(nh.stream(timeout=15.0))
            want = oracle(prompt, n_tok)
            assert list(got) + tail == want
            res = nh.result(timeout=10)
            assert res.tokens == want and not res.diverged
        finally:
            router2.stop(drain=False)
    finally:
        router1.stop(drain=False)
        for r in reps:
            try:
                r.kill()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# split-brain: the deposed leader is fenced out at the replicas
# ---------------------------------------------------------------------------

def test_stale_epoch_fences_deposed_router(tmp_path):
    """A deposed leader that never noticed (GC pause) keeps driving the
    tier — every replica rejects its epoch-1 ops the moment epoch 2
    appears, the old router latches fenced, and its clients get a
    RuntimeError instead of a possibly-doubled stream."""
    rdir = str(tmp_path / "rdv")
    rep = FakeReplica(0, rdir, tok_delay=0.002).start()
    router1 = Router(1, rdir, probe_interval_s=0.05,
                     health_timeout_s=0.5, epoch=1)
    router1.start(wait_s=10)
    router2 = None
    try:
        assert router1.generate(
            [4, 2], max_new_tokens=4).tokens == oracle([4, 2], 4)
        router2 = Router(1, rdir, probe_interval_s=0.05,
                         health_timeout_s=0.5, epoch=2)
        router2.start(wait_s=10, adopt=True)
        # the successor's first op teaches the replica epoch 2
        assert router2.generate(
            [4, 3], max_new_tokens=4).tokens == oracle([4, 3], 4)
        # the deposed router's next op is rejected → fenced, latched
        with pytest.raises(RuntimeError):
            router1.submit([4, 4], max_new_tokens=4).result(timeout=10)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline \
                and not router1.health()["fenced"]:
            time.sleep(0.02)
        h = router1.health()
        assert h["fenced"] and not h["ok"]
        with pytest.raises(RuntimeError, match="fenced"):
            router1.submit([4, 5], max_new_tokens=4)
        # the real leader is untouched by the split-brain attempt
        assert router2.generate(
            [4, 6], max_new_tokens=4).tokens == oracle([4, 6], 4)
        assert router2.health()["ok"]
    finally:
        if router2 is not None:
            router2.stop(drain=False)
        router1.stop(drain=False)
        rep.kill()


def test_takeover_resumes_mid_rollout(tmp_path):
    """The leader dies mid-ROLLING with requests in flight: takeover
    re-adopts the streams AND drives the persisted rollout state
    machine forward to DONE (serve/rollout.py resume semantics) —
    deterministically, from the durable state alone."""
    from dtf_tpu_torch.serve import rollout as rollout_mod
    router1, reps, rdir = _ha_tier(tmp_path)
    n_tok = 48

    def hook(rid, ckpt):
        hook_calls.append((rid, ckpt))
        try:
            reps[rid].kill()
        except Exception:
            pass
        # both checkpoints answer identically (salt 0): a re-exported
        # identical model — the token-exact rollout
        reps[rid] = FakeReplica(rid, rdir, tok_delay=0.01).start()

    hook_calls = []
    router2 = None
    try:
        # replica 0 already rolled, as the persisted state claims
        hook(0, "ckpt_new")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline \
                and not router1.replica_healthy(0):
            time.sleep(0.02)
        state_path = rollout_mod.default_state_path(rdir)
        state = rollout_mod.RolloutState(
            phase="ROLLING", new_checkpoint="ckpt_new",
            old_checkpoint="ckpt_old", canary=0, order=[0, 1],
            rolled=[0])
        with open(state_path, "w") as f:
            json.dump({k: getattr(state, k)
                       for k in state.__dataclass_fields__}, f)

        prompts = [[9, 8, 7], [2, 4, 6]]
        handles = [router1.submit(p, max_new_tokens=n_tok)
                   for p in prompts]
        got = [[] for _ in prompts]
        threads = [_collect(h, g) for h, g in zip(handles, got)]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and not all(len(g) >= 4 for g in got):
            time.sleep(0.01)
        assert all(len(g) >= 4 for g in got), "streams never started"
        _freeze(router1)
        for t in threads:
            t.join(timeout=5.0)
        delivered = {h.request.id: list(g)
                     for h, g in zip(handles, got)}

        router2 = Router(len(reps), rdir, probe_interval_s=0.05,
                         health_timeout_s=0.5, deadline_s=30.0,
                         page_size=8,
                         journal_path=journal_mod.journal_path(rdir),
                         epoch=2, role="leader")
        router2.start(wait_s=10, adopt=True)
        summary = ha.take_over(router2, delivered=delivered,
                               restart_hook=hook)
        # the rollout finished forward: replica 1 rolled, phase DONE
        assert summary["rollout_resumed"] == "DONE"
        assert (1, "ckpt_new") in hook_calls, "replica 1 never rolled"
        final = rollout_mod.RolloutState.load(state_path)
        assert final.phase == "DONE" and sorted(final.rolled) == [0, 1]
        # ... and the adopted streams stayed exactly-once token-exact
        assert summary["readopted"] + summary["redispatched"] \
            == len(prompts)
        for h, p, pre in zip(handles, prompts, got):
            nh = summary["handles"][h.request.id]
            tail = list(nh.stream(timeout=20.0))
            assert list(pre) + tail == oracle(p, n_tok)
            res = nh.result(timeout=10)
            assert res.tokens == oracle(p, n_tok) and not res.diverged
    finally:
        if router2 is not None:
            router2.stop(drain=False)
        router1.stop(drain=False)
        for r in reps:
            r.kill()


# ---------------------------------------------------------------------------
# the JAX package and the port against each other
# ---------------------------------------------------------------------------

HA_MODS = {"jax": jax_ha, "port": ha}


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_lease_read_expired_and_fenced_across_packages(tmp_path, writer,
                                                       reader):
    """One package's lease is the other's: the reader sees the writer's
    live lease (no acquire, the same standby payload), takes the next
    epoch once it expires, and the writer's holder renews into the
    fenced verdict."""
    rdir = str(tmp_path)
    w, r = HA_MODS[writer], HA_MODS[reader]
    held = w.LeaderLease(rdir, ttl_s=0.3, holder="a")
    standby = r.LeaderLease(rdir, ttl_s=0.3, holder="b")
    assert held.acquire() == 1
    assert r.read_lease(rdir) == w.read_lease(rdir)
    assert r.read_lease(rdir)["holder"] == "a"
    assert not standby.expired() and standby.acquire() is None
    assert r.standby_health(standby) == w.standby_health(held) == {
        "ok": True, "role": "standby", "epoch": 1, "lease_expired": False}
    assert held.renew() is True
    time.sleep(0.45)
    assert standby.expired() and held.expired()
    assert r.wait_for_takeover(standby, poll_s=0.02, timeout_s=5.0) == 2
    assert held.renew() is False and held.fenced
    standby.release()
    assert w.read_lease(rdir) is None


@pytest.mark.parametrize("first,second", [("jax", "port"),
                                          ("port", "jax")])
def test_takeover_across_packages(tmp_path, first, second):
    """A journal and a live tier left by one package's dead router are
    taken over by the other's: every request re-attached where its
    replica kept decoding, each stream exactly once and token-exact."""
    pkgs = {"jax": _jax_pkg(), "port": PORT}
    router1, reps, rdir = _ha_tier(tmp_path, pkg=pkgs[first])
    prompts = [[5, 6, 7], [11, 12], [3, 1, 4, 1, 5]]
    n_tok = 48
    try:
        handles = [router1.submit(p, max_new_tokens=n_tok)
                   for p in prompts]
        got = [[] for _ in prompts]
        threads = [_collect(h, g) for h, g in zip(handles, got)]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and not all(len(g) >= 4 for g in got):
            time.sleep(0.01)
        assert all(len(g) >= 4 for g in got), "streams never started"
        _freeze(router1)
        for t in threads:
            t.join(timeout=5.0)
        delivered = {h.request.id: list(g) for h, g in zip(handles, got)}
        router2 = pkgs[second]["Router"](
            len(reps), rdir, probe_interval_s=0.05, health_timeout_s=0.5,
            deadline_s=30.0, page_size=8,
            journal_path=journal_mod.journal_path(rdir), epoch=2)
        router2.start(wait_s=10, adopt=True)
        try:
            summary = HA_MODS[second].take_over(
                router2, delivered=delivered, resume_rollout=False)
            assert summary["readopted"] == len(prompts)
            assert summary["redispatched"] == 0
            for h, p, pre in zip(handles, prompts, got):
                nh = summary["handles"][h.request.id]
                tail = list(nh.stream(timeout=10.0))
                assert list(pre) + tail == oracle(p, n_tok)
                assert nh.result(timeout=10).tokens == oracle(p, n_tok)
        finally:
            router2.stop(drain=False)
    finally:
        router1.stop(drain=False)
        for r in reps:
            r.kill()


def _untimed(obj):
    """``obj`` without its wall-clock stamps (``ts`` keys)."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def test_journal_replay_alike_across_packages(tmp_path):
    """The same appends through either package's journal replay to the
    same state under both packages' ``replay``/``unresolved``."""
    from dtf_tpu.serve import journal as jax_journal
    states = []
    for name, mod in (("jax", jax_journal), ("port", journal_mod)):
        path = str(tmp_path / f"{name}.jsonl")
        j = mod.RequestJournal(path)
        j.submit("1", prompt=[5, 6], max_new_tokens=8, temperature=0.0,
                 eos_id=None, rng_seed=42, trace="t1")
        j.dispatch("1", 0, 1)
        j.watermark("1", 16)
        j.submit("2", prompt=[7], max_new_tokens=4, temperature=0.5,
                 eos_id=3, rng_seed=7, trace="t2")
        j.dispatch("2", 1, 1)
        j.complete("2", ok=True)
        j.close()
        for reader in (jax_journal, journal_mod):
            states.append(_untimed(reader.unresolved(reader.replay(path))))
    assert all(s == states[0] for s in states), states
    assert list(states[0]) == ["1"]
    assert states[0]["1"]["watermark"] == 16


# ---------------------------------------------------------------------------
# the real processes: router_main's HA pair, a rollout onto JAX params
# ---------------------------------------------------------------------------

HA_ARGV = ["--device", "cpu", "--model", "transformer_small",
           "--num_classes", "256", "--router_replicas", "2",
           "--serve_max_new_tokens", "8", "--heartbeat_secs", "0.5",
           "--router_health_timeout_s", "10", "--router_lease_ttl_s", "1"]


def _jax_params_export(tmp_path):
    """JAX ``transformer_small`` params, and the port's export of them
    through ``convert.from_flax_params``."""
    import jax
    import jax.numpy as jnp

    from dtf_tpu.models import build_model as jax_build_model
    from dtf_tpu_torch import convert
    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.train.checkpoint import export_model
    jmodel, _ = jax_build_model("transformer_small", num_classes=256)
    params = jmodel.init(jax.random.key(7),
                         jnp.zeros((1, 16), jnp.int32))["params"]
    model, _ = build_model("transformer_small", num_classes=256)
    model.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), model))
    export_model(str(tmp_path / "exp"), model)
    return jmodel, params, str(tmp_path / "exp")


def _running(pid: int) -> bool:
    """True while ``pid`` runs.  The dead leader's replicas were
    re-parented: one that exited may stay a zombie until its new parent
    reaps it, and a zombie has stopped running."""
    try:
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except OSError:
        return False


def _router_stats(stderr: str) -> dict:
    import ast
    lines = [ln for ln in stderr.splitlines() if "Router stats:" in ln]
    assert lines, stderr[-3000:]
    return ast.literal_eval(lines[-1].split("Router stats:", 1)[1].strip())


@pytest.mark.slow
def test_router_main_ha_pair_and_rollout_onto_jax_params(tmp_path):
    """``router_main --router_ha`` dies at its third dispatch
    (``router_kill``, a real ``os._exit``; its replicas live on); a
    ``--router_standby`` process takes epoch 2, re-adopts the burst
    without respawning a replica, then rolls the tier onto an export of
    JAX params under live traffic.  The same rollout in process, from a
    tier started on another model's npz, serves the JAX engine's greedy
    tokens on those params."""
    from dtf_tpu.serve.engine import ServeEngine as JaxEngine
    from dtf_tpu_torch.cli import router_main
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.serve.replica import read_announce
    from dtf_tpu_torch.serve.router import replica_spawner

    jmodel, params, exp = _jax_params_export(tmp_path)
    rdv = str(tmp_path / "tier")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "dtf_tpu_torch.cli.router_main",
            "--serve_random_init", *HA_ARGV, "--rendezvous_dir", rdv]
    leader = subprocess.Popen(
        base + ["--router_ha", "--serve_requests", "8", "--fault",
                "router_kill@req:3"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 300
    while ha.read_lease(rdv) is None and time.monotonic() < deadline:
        time.sleep(0.1)
    standby = subprocess.Popen(
        base + ["--router_standby", "--serve_requests", "4",
                "--rollout_checkpoint", exp, "--rollout_canary_requests",
                "2", "--rollout_max_divergence", "1.0"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, lerr = leader.communicate(timeout=600)
        pids = {r: read_announce(rdv, r)["pid"] for r in (0, 1)}
        _, serr = standby.communicate(timeout=900)
    finally:
        for proc in (leader, standby):
            if proc.poll() is None:
                proc.kill()
    assert leader.returncode == chaos.EXIT_INJECTED_CRASH, lerr[-3000:]
    assert standby.returncode == 0, serr[-3000:]
    stats = _router_stats(serr)
    assert stats["takeover_epoch"] == 2
    assert stats["readopted"] + stats["redispatched"] >= 1
    assert stats["respawns"] == 0
    assert stats["rollout_phase"] == "DONE"
    assert stats["canary_compared"] >= 2
    assert stats["backpressure"] == stats["deadline_exceeded"] == 0
    # the standby owned the tier at the end: the adopted processes it
    # did not replace were stopped with it
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and any(
            _running(p) for p in pids.values()):
        time.sleep(0.2)
    assert not any(_running(p) for p in pids.values())

    # in process: a tier on another model's npz rolled onto the export
    other = {k: np.asarray(v) for k, v in _flat(jmodel.init(
        __import__("jax").random.key(8),
        np.zeros((1, 16), np.int32))["params"]).items()}
    np.savez(tmp_path / "other.npz", **other)
    cfg = parse_flags(HA_ARGV + ["--serve_params_npz",
                                 str(tmp_path / "other.npz"),
                                 "--rendezvous_dir", str(tmp_path / "lib")],
                      defaults=router_main.ROUTER_DEFAULTS)
    ckpt_map: dict = {}
    spawn = replica_spawner(router_main.replica_command(cfg, False),
                            cfg.rendezvous_dir,
                            env_extra={"OMP_NUM_THREADS": "1"},
                            checkpoint_map=ckpt_map)
    router = Router(2, cfg.rendezvous_dir, spawn=spawn, page_size=16,
                    checkpoint_map=ckpt_map, probe_interval_s=0.5,
                    health_timeout_s=10.0, deadline_s=300.0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, (int(n),)).astype(np.int32)
               for n in (5, 17, 33, 40)]
    router.start(wait_s=300)
    stop = threading.Event()

    def traffic():
        while not stop.wait(0.2):
            router.generate(prompts[0], max_new_tokens=8)

    th = threading.Thread(target=traffic, daemon=True)
    th.start()
    try:
        state = router.rollout(exp, max_divergence=1.0, canary_requests=2,
                               warm_timeout_s=300.0, gate_timeout_s=300.0)
        stop.set()
        th.join(timeout=60)
        assert state.phase == "DONE"
        got = [router.generate(p, max_new_tokens=8).tokens for p in prompts]
    finally:
        stop.set()
        router.stop(drain=True)
    jeng = JaxEngine(jmodel, params, max_batch=2, max_seq_len=64)
    try:
        want = [jeng.generate(p, max_new_tokens=8).tokens for p in prompts]
    finally:
        jeng.stop()
    assert got == want


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
