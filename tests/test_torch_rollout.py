"""The port's zero-downtime rollout (``dtf_tpu_torch/serve/rollout.py``
over ``serve/router.py``): the state machine, the canary's token-exact
gate, drain/replace, resume from the persisted state and the rollout
chaos -- the cases of tests/test_rollout.py, here over the port's
modules and the fake replica tier of tests/test_torch_router.py, which
models a checkpoint as an oracle SALT: ``ckpt_old`` and
``ckpt_new_same`` answer identically (a re-exported identical
checkpoint), ``ckpt_new_div`` differently (a different model the gate
must catch), ``ckpt_bad`` cannot start at all (a truncated artifact).

Then the two packages against each other: a persisted rollout state
written by either is resumed by the other's controller, and one
scripted rollout (A->B, B->C, ``rollout_kill@phase:canary``) ends alike
on the JAX router and on the port's.  Last, the replica's checkpoint
override: ``DTF_SERVE_CHECKPOINT`` wins over ``--serve_params_npz``.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from dtf_tpu import chaos as jax_chaos
from dtf_tpu_torch import chaos
from dtf_tpu_torch.serve.rollout import (RolloutController, RolloutError,
                                         RolloutState, _truncate_checkpoint)
from dtf_tpu_torch.serve.router import Router
from test_torch_router import PORT, FakeReplica, _jax_pkg, oracle, stop_tier

torch.set_num_threads(1)

OLD = "ckpt_old"
NEW_SAME = "ckpt_new_same"
NEW_DIV = "ckpt_new_div"
BAD = "ckpt_bad"
SALTS = {OLD: 0, NEW_SAME: 0, NEW_DIV: 7, "": 0}


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    yield
    chaos.disable()
    jax_chaos.disable()


def make_rollout_tier(tmp_path, n=2, pkg=None, tok_delay=0.004):
    """Fake tier + a restart_hook that swaps a replica's engine for
    one serving the named checkpoint's salt (BAD starts nothing —
    the unserveable-artifact case).  The port's modules, or (``pkg``)
    the JAX package's."""
    pkg = pkg or PORT
    rdir = str(tmp_path / "rdv")
    os.makedirs(rdir, exist_ok=True)
    reps = [FakeReplica(i, rdir, pkg=pkg, tok_delay=tok_delay).start()
            for i in range(n)]
    router = pkg["Router"](n, rdir, probe_interval_s=0.05,
                           health_timeout_s=0.4, deadline_s=30.0,
                           replica_inflight=32, page_size=8,
                           kill_hook=lambda rid: reps[rid].kill())
    router.start(wait_s=10)
    hook_calls = []

    def hook(rid, ckpt):
        hook_calls.append((rid, ckpt))
        try:
            reps[rid].kill()
        except Exception:
            pass
        if ckpt == BAD:
            return          # the new checkpoint cannot even start
        reps[rid] = FakeReplica(rid, rdir, pkg=pkg, tok_delay=tok_delay,
                                salt=SALTS[ckpt]).start()

    return router, reps, hook, hook_calls


def restart(router, hook, rid, ckpt):
    """Replica ``rid`` restarted onto ``ckpt`` as the controller
    restarts one: the transport closed first (a killed fake's server
    keeps its established connection, and the router would go on
    driving the old one until its next send found it dead)."""
    router.terminate_replica(rid)
    hook(rid, ckpt)
    router.allow_reconnect(rid)


def on_new_server(router, reps, rid) -> bool:
    return (router.replica_healthy(rid)
            and router._replicas[rid].port == reps[rid].server.port)


def controller(router, hook, ckpt, tmp_path, cls=None, **kw):
    args = dict(old_checkpoint=OLD, canary_requests=2,
                mirror_fraction=1.0, warm_timeout_s=8.0,
                drain_timeout_s=15.0, gate_timeout_s=20.0,
                restart_hook=hook, poll_s=0.02,
                state_path=str(tmp_path / "rollout_state.json"))
    args.update(kw)
    return (cls or RolloutController)(router, ckpt, **args)


class Pump:
    """Continuous greedy traffic during a rollout: submits on a
    cadence, resolves everything at stop — the zero-lost ledger."""

    def __init__(self, router, interval=0.03, budget=6):
        self.router = router
        self.interval = interval
        self.budget = budget
        rng = np.random.default_rng(17)
        self.prompts = [rng.integers(0, 97, (5 + i % 4,))
                        .astype(np.int32) for i in range(6)]
        self._handles = []
        self._shed = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        from dtf_tpu_torch.serve.engine import Backpressure
        i = 0
        while not self._stop.wait(self.interval):
            p = self.prompts[i % len(self.prompts)]
            try:
                self._handles.append(
                    (p, self.router.submit(p,
                                           max_new_tokens=self.budget)))
            except Backpressure:
                self._shed += 1
            i += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)

    def assert_zero_lost_token_exact(self, salt=0):
        assert self._shed == 0, f"{self._shed} requests shed mid-rollout"
        assert self._handles, "the pump never submitted"
        for p, h in self._handles:
            r = h.result(timeout=60)   # lost = the one forbidden outcome
            assert r.tokens == oracle(p, self.budget, salt=salt), (
                f"request diverged from the salt-{salt} model "
                f"(replica {r.replica}, version {r.version})")


# ---------------------------------------------------------------------------
# state machine
# ---------------------------------------------------------------------------

def test_state_machine_legal_transitions(tmp_path):
    s = RolloutState()
    assert s.phase == "IDLE"
    s.advance("CANARY")
    s.advance("ROLLING")
    s.advance("DONE")
    s2 = RolloutState()
    s2.advance("CANARY")
    s2.advance("ROLLED_BACK", reason="canary_divergence")
    assert s2.reason == "canary_divergence"
    s3 = RolloutState()
    s3.advance("CANARY")
    s3.advance("ROLLING")
    s3.advance("ROLLED_BACK", reason="replica_lost")
    assert s3.phase == "ROLLED_BACK"


@pytest.mark.parametrize("chain,bad", [
    ((), "ROLLING"),                      # IDLE cannot skip the canary
    ((), "DONE"),
    ((), "ROLLED_BACK"),
    (("CANARY",), "DONE"),                # the gate cannot be skipped
    (("CANARY", "ROLLING"), "CANARY"),    # no going back
    (("CANARY", "ROLLED_BACK"), "ROLLING"),   # terminal
    (("CANARY", "ROLLING", "DONE"), "ROLLED_BACK"),  # terminal
])
def test_state_machine_illegal_transitions(chain, bad):
    s = RolloutState()
    for phase in chain:
        s.advance(phase)
    with pytest.raises(RolloutError):
        s.advance(bad)


def test_state_persist_roundtrip(tmp_path):
    path = str(tmp_path / "state.json")
    s = RolloutState(new_checkpoint="/n", old_checkpoint="/o",
                     canary=0, order=[0, 1, 2], rolled=[0, 1],
                     compared=5, diverged=1, first_divergence_pos=3)
    s.advance("CANARY")
    s.save(path)
    back = RolloutState.load(path)
    assert back == s
    # atomic write: no tmp litter
    assert [f for f in os.listdir(tmp_path)] == ["state.json"]


def test_truncate_checkpoint_halves_largest_file(tmp_path):
    big = tmp_path / "ckpt" / "payload.bin"
    small = tmp_path / "ckpt" / "meta.json"
    os.makedirs(tmp_path / "ckpt")
    big.write_bytes(b"x" * 1000)
    small.write_bytes(b"y" * 10)
    _truncate_checkpoint(str(tmp_path / "ckpt"))
    assert big.stat().st_size == 500
    assert small.stat().st_size == 10


# ---------------------------------------------------------------------------
# the rollout itself (fake tier)
# ---------------------------------------------------------------------------

def test_rollout_identical_checkpoint_completes_zero_lost(tmp_path):
    """A mid-traffic rollout to an identical checkpoint: DONE, zero
    shed/lost, every request token-exact, no mixed-model streams,
    whole fleet on the new version."""
    router, reps, hook, _ = make_rollout_tier(tmp_path)
    try:
        with Pump(router) as pump:
            time.sleep(0.2)     # traffic flowing before the rollout
            state = controller(router, hook, NEW_SAME, tmp_path).run()
            time.sleep(0.2)     # and after it
        assert state.phase == "DONE"
        assert state.compared >= 2 and state.diverged == 0
        pump.assert_zero_lost_token_exact(salt=0)
        assert router.metrics.get("router_mixed_model_total").value == 0
        for rid in range(2):
            assert router.replica_version(rid) == NEW_SAME
            assert router.replica_healthy(rid)
        # durable state says DONE too (the resume contract's ground)
        persisted = RolloutState.load(str(tmp_path /
                                          "rollout_state.json"))
        assert persisted.phase == "DONE"
        assert sorted(persisted.rolled) == [0, 1]
    finally:
        stop_tier(router, reps)


def test_rollout_divergent_checkpoint_gated_rollback(tmp_path):
    """A genuinely different model: the token-exact canary gate fires
    on live mirrored traffic and the rollout auto-rolls-back — fleet
    token-exact on the OLD model, zero lost."""
    router, reps, hook, _ = make_rollout_tier(tmp_path)
    try:
        with Pump(router) as pump:
            time.sleep(0.2)
            state = controller(router, hook, NEW_DIV, tmp_path).run()
            time.sleep(0.2)
        assert state.phase == "ROLLED_BACK"
        assert state.reason.startswith("canary_divergence")
        assert state.diverged >= 1
        assert state.first_divergence_pos >= 0
        assert state.rolled == [], "rollback left replicas on the new model"
        pump.assert_zero_lost_token_exact(salt=0)
        for rid in range(2):
            assert router.replica_version(rid) == OLD
            assert router.replica_healthy(rid)
        # the canary's divergent tokens were SHADOWS — never delivered
        assert router.metrics.get("router_mixed_model_total").value == 0
    finally:
        stop_tier(router, reps)


def test_rollout_unserveable_checkpoint_rolls_back(tmp_path):
    """A new checkpoint that cannot even start a replica (truncated /
    corrupt artifact): the canary never re-registers, the rollout
    rolls back, the fleet stands on the old model."""
    router, reps, hook, hook_calls = make_rollout_tier(tmp_path)
    try:
        with Pump(router) as pump:
            state = controller(router, hook, BAD, tmp_path,
                               warm_timeout_s=1.5).run()
        assert state.phase == "ROLLED_BACK"
        assert state.reason == "canary_start_failed"
        pump.assert_zero_lost_token_exact(salt=0)
        # the rollback re-ran the hook with the OLD checkpoint
        assert (0, OLD) in hook_calls
        for rid in range(2):
            assert router.replica_healthy(rid)
            assert router.replica_version(rid) == OLD
    finally:
        stop_tier(router, reps)


def test_rollout_gate_timeout_rolls_back(tmp_path):
    """No traffic → no comparisons → the gate cannot pass; it times
    out into a rollback rather than promoting an unproven model."""
    router, reps, hook, _ = make_rollout_tier(tmp_path)
    try:
        state = controller(router, hook, NEW_SAME, tmp_path,
                           gate_timeout_s=0.8).run()
        assert state.phase == "ROLLED_BACK"
        assert state.reason.startswith("canary_timeout")
        for rid in range(2):
            assert router.replica_version(rid) == OLD
    finally:
        stop_tier(router, reps)


def test_rollout_kill_canary_phase_rolls_back(tmp_path):
    """rollout_kill@phase:canary: the canary dies mid-gate; the
    rollout detects the instability and rolls back — zero lost,
    fleet on the old model."""
    chaos.configure("rollout_kill@phase:canary", rank=0)
    router, reps, hook, _ = make_rollout_tier(tmp_path)
    try:
        with Pump(router) as pump:
            state = controller(router, hook, NEW_SAME, tmp_path).run()
        assert state.phase == "ROLLED_BACK"
        pump.assert_zero_lost_token_exact(salt=0)
        for rid in range(2):
            assert router.replica_healthy(rid)
            assert router.replica_version(rid) == OLD
    finally:
        stop_tier(router, reps)


def test_rollout_kill_rolling_phase_rolls_back(tmp_path):
    """rollout_kill@phase:rolling: a serving replica dies after the
    gate passed; policy is abort — the canary (already on the new
    model) re-drains back onto the old checkpoint."""
    chaos.configure("rollout_kill@phase:rolling", rank=0)
    router, reps, hook, _ = make_rollout_tier(tmp_path)
    try:
        with Pump(router) as pump:
            state = controller(router, hook, NEW_SAME, tmp_path).run()
        assert state.phase == "ROLLED_BACK"
        assert state.compared >= 2 and state.diverged == 0, (
            "the gate should have PASSED before the rolling kill")
        pump.assert_zero_lost_token_exact(salt=0)
        for rid in range(2):
            assert router.replica_healthy(rid)
            assert router.replica_version(rid) == OLD
        assert router.metrics.get("router_mixed_model_total").value == 0
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# resume from persisted state (the router-restart-mid-rollout case)
# ---------------------------------------------------------------------------

def _write_state(tmp_path, **kw):
    path = str(tmp_path / "rollout_state.json")
    state = RolloutState(**kw)
    with open(path, "w") as f:
        json.dump(
            {k: getattr(state, k) for k in state.__dataclass_fields__},
            f)
    return path


def test_resume_mid_rolling_finishes_forward(tmp_path):
    """Persisted ROLLING + a rolled canary: a fresh router resumes
    FORWARD — the remaining replica rolls, phase reaches DONE."""
    router, reps, hook, hook_calls = make_rollout_tier(tmp_path)
    try:
        # replica 0 already on the new checkpoint, as the state claims
        restart(router, hook, 0, NEW_SAME)
        path = _write_state(tmp_path, phase="ROLLING",
                            new_checkpoint=NEW_SAME, old_checkpoint=OLD,
                            canary=0, order=[0, 1], rolled=[0])
        # the restarted replica 0 must stand before the resume: the
        # router healthy on the NEW server, so a slow start under load
        # fails HERE, as what it is, not later as an unstable fleet
        t0 = time.monotonic()
        while (not on_new_server(router, reps, 0)
               and time.monotonic() - t0 < 60):
            time.sleep(0.02)
        assert on_new_server(router, reps, 0), (
            "replica 0 not healthy 60 s after its restart")
        with Pump(router) as pump:
            state = RolloutController.resume(
                router, path, restart_hook=hook, warm_timeout_s=8.0,
                drain_timeout_s=15.0, poll_s=0.02)
        assert state.phase == "DONE"
        assert sorted(state.rolled) == [0, 1]
        assert (1, NEW_SAME) in hook_calls, "replica 1 never rolled"
        pump.assert_zero_lost_token_exact(salt=0)
        for rid in range(2):
            assert router.replica_version(rid) == NEW_SAME
    finally:
        stop_tier(router, reps)


def test_resume_mid_canary_rolls_back(tmp_path):
    """Persisted CANARY: an interrupted canary proved nothing — the
    deterministic resume verdict is ROLLBACK, canary restored onto
    the old checkpoint."""
    router, reps, hook, hook_calls = make_rollout_tier(tmp_path)
    try:
        # the canary the dead router had replaced
        restart(router, hook, 0, NEW_SAME)
        path = _write_state(tmp_path, phase="CANARY",
                            new_checkpoint=NEW_SAME, old_checkpoint=OLD,
                            canary=0, order=[0, 1], rolled=[0])
        t0 = time.monotonic()
        while not router.replica_healthy(0) and time.monotonic() - t0 < 5:
            time.sleep(0.02)
        state = RolloutController.resume(
            router, path, restart_hook=hook, warm_timeout_s=8.0,
            drain_timeout_s=15.0, poll_s=0.02)
        assert state.phase == "ROLLED_BACK"
        assert state.reason == "resumed_mid_canary"
        assert state.rolled == []
        assert (0, OLD) in hook_calls
        for rid in range(2):
            assert router.replica_version(rid) == OLD
    finally:
        stop_tier(router, reps)


def test_resume_rolled_back_finishes_rollback(tmp_path):
    """Persisted ROLLED_BACK with a replica still on the new model
    (the controller died mid-rollback): resume finishes the rollback."""
    router, reps, hook, hook_calls = make_rollout_tier(tmp_path)
    try:
        restart(router, hook, 1, NEW_SAME)
        path = _write_state(tmp_path, phase="ROLLED_BACK",
                            new_checkpoint=NEW_SAME, old_checkpoint=OLD,
                            canary=0, order=[0, 1], rolled=[1],
                            reason="canary_divergence")
        t0 = time.monotonic()
        while not router.replica_healthy(1) and time.monotonic() - t0 < 5:
            time.sleep(0.02)
        state = RolloutController.resume(
            router, path, restart_hook=hook, warm_timeout_s=8.0,
            drain_timeout_s=15.0, poll_s=0.02)
        assert state.phase == "ROLLED_BACK"
        assert state.rolled == []
        assert (1, OLD) in hook_calls
        for rid in range(2):
            assert router.replica_version(rid) == OLD
    finally:
        stop_tier(router, reps)


def test_resume_done_is_noop(tmp_path):
    router, reps, hook, hook_calls = make_rollout_tier(tmp_path)
    try:
        path = _write_state(tmp_path, phase="DONE",
                            new_checkpoint=NEW_SAME, old_checkpoint=OLD,
                            canary=0, order=[0, 1], rolled=[0, 1])
        state = RolloutController.resume(router, path,
                                         restart_hook=hook)
        assert state.phase == "DONE"
        assert hook_calls == []
    finally:
        stop_tier(router, reps)


def test_rollout_refuses_wrong_old_checkpoint(tmp_path):
    """The old_checkpoint contract is enforced: a second rollout that
    names an old checkpoint the fleet does not actually serve is
    refused up front — 'rolling back' to it would split the tier
    across two models while reporting success."""
    router, reps, hook, _ = make_rollout_tier(tmp_path)
    try:
        with Pump(router):
            state = controller(router, hook, NEW_SAME, tmp_path).run()
        assert state.phase == "DONE"
        with pytest.raises(RolloutError, match="old checkpoint"):
            # fleet serves NEW_SAME now; declaring OLD is a lie
            controller(router, hook, NEW_DIV, tmp_path,
                       old_checkpoint=OLD).run()
        # the honest declaration is accepted (and gets gated normally)
        with Pump(router) as pump:
            state = controller(router, hook, NEW_DIV, tmp_path,
                               old_checkpoint=NEW_SAME).run()
        assert state.phase == "ROLLED_BACK"
        pump.assert_zero_lost_token_exact(salt=0)
    finally:
        stop_tier(router, reps)


def test_rollout_refuses_single_replica_tier(tmp_path):
    """A 1-replica tier cannot roll: the shadow-only canary would be
    the only replica — every request would queue into its deadline
    and the traffic-fed gate could never complete.  Refused up
    front."""
    router, reps, hook, _ = make_rollout_tier(tmp_path, n=1)
    try:
        with pytest.raises(RolloutError, match="1-replica"):
            controller(router, hook, NEW_SAME, tmp_path).run()
    finally:
        stop_tier(router, reps)


def test_rollout_refuses_unstable_fleet(tmp_path):
    """A rollout is a planned maneuver: it refuses to START on a fleet
    with a dead replica (recover first, then roll)."""
    router, reps, hook, _ = make_rollout_tier(tmp_path)
    try:
        reps[1].kill()
        t0 = time.monotonic()
        while router.replica_healthy(1) and time.monotonic() - t0 < 5:
            time.sleep(0.02)
        with pytest.raises(RolloutError, match="unhealthy"):
            controller(router, hook, NEW_SAME, tmp_path).run()
    finally:
        stop_tier(router, reps)


# ---------------------------------------------------------------------------
# the JAX package and the port against each other
# ---------------------------------------------------------------------------

def _jax_rollout():
    from dtf_tpu.serve import rollout as jax_rollout
    return jax_rollout


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_rollout_state_resumed_across_packages(tmp_path, writer, reader):
    """A persisted ROLLING state written by one package is loaded and
    resumed forward by the other's controller over its own tier; the
    writer's package reads the final state back alike."""
    from dtf_tpu_torch.serve import rollout as port_rollout
    mods = {"jax": _jax_rollout(), "port": port_rollout}
    pkg = {"jax": _jax_pkg(), "port": PORT}[reader]
    path = str(tmp_path / "rollout_state.json")
    mods[writer].RolloutState(
        phase="ROLLING", new_checkpoint=NEW_SAME, old_checkpoint=OLD,
        canary=0, order=[0, 1], rolled=[0], compared=2).save(path)
    router, reps, hook, hook_calls = make_rollout_tier(tmp_path, pkg=pkg)
    try:
        restart(router, hook, 0, NEW_SAME)
        t0 = time.monotonic()
        while (not on_new_server(router, reps, 0)
               and time.monotonic() - t0 < 60):
            time.sleep(0.02)
        assert on_new_server(router, reps, 0)
        state = mods[reader].RolloutController.resume(
            router, path, restart_hook=hook, warm_timeout_s=8.0,
            drain_timeout_s=15.0, poll_s=0.02)
        assert state.phase == "DONE" and sorted(state.rolled) == [0, 1]
        assert (1, NEW_SAME) in hook_calls
        back = mods[writer].RolloutState.load(path)
        assert (back.phase, back.rolled, back.compared) == (
            state.phase, state.rolled, state.compared)
    finally:
        stop_tier(router, reps)


def _scripted(pkg, ctrl_cls, chaos_mod, tmp_path):
    """A->B (identical), B->C (divergent), then rollout_kill@phase:canary
    on one tier, each rollout under sequential greedy traffic (one
    request at a time, each awaited).  Returns, per rollout, its phase,
    reason, rolled list, divergences and the tokens of each prompt."""
    router, reps, hook, _ = make_rollout_tier(tmp_path, pkg=pkg,
                                              tok_delay=0.02)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, 97, (5 + i,)).astype(np.int32)
               for i in range(4)]
    out = []
    try:
        for new, old, fault in ((NEW_SAME, OLD, ""),
                                (NEW_DIV, NEW_SAME, ""),
                                (NEW_SAME, NEW_SAME,
                                 "rollout_kill@phase:canary")):
            if fault:
                chaos_mod.configure(fault, rank=0)
            box = {}
            ctrl = controller(router, hook, new, tmp_path, cls=ctrl_cls,
                              old_checkpoint=old)
            th = threading.Thread(target=lambda: box.update(s=ctrl.run()),
                                  daemon=True)
            th.start()
            tokens, i = {}, 0
            deadline = time.monotonic() + 300
            while th.is_alive():
                assert time.monotonic() < deadline, \
                    "the rollout still running after 300 s"
                r = router.generate(prompts[i % 4], max_new_tokens=6)
                tokens.setdefault(i % 4, r.tokens)
                assert r.tokens == tokens[i % 4]
                i += 1
            th.join(timeout=10)
            chaos_mod.disable()
            s = box["s"]
            out.append((s.phase, s.reason, sorted(s.rolled), s.diverged,
                        tokens))
    finally:
        stop_tier(router, reps)
    return out, prompts


def test_scripted_rollout_parity_with_jax_router(tmp_path):
    """The JAX router + controller and the port's, over the same fakes
    and prompts: the same phase, reason, rolled list and divergence
    count for each rollout, and the same tokens for each prompt."""
    got, prompts = _scripted(PORT, RolloutController, chaos,
                             tmp_path / "port")
    want, _ = _scripted(_jax_pkg(), _jax_rollout().RolloutController,
                        jax_chaos, tmp_path / "jax")
    assert [g[:4] for g in got] == [w[:4] for w in want]
    assert [g[0] for g in got] == ["DONE", "ROLLED_BACK", "ROLLED_BACK"]
    assert got[1][1].startswith("canary_divergence") and got[1][3] == 1
    for (*_, g), (*_, w) in zip(got, want):
        for i in set(g) & set(w):
            assert g[i] == w[i] == oracle(prompts[i], 6)


# ---------------------------------------------------------------------------
# the replica's checkpoint override
# ---------------------------------------------------------------------------

class _Built(Exception):
    pass


def test_checkpoint_override_beats_serve_params_npz(tmp_path, monkeypatch):
    """A replica started with ``--serve_params_npz`` (params P) and the
    rollout's ``DTF_SERVE_CHECKPOINT`` (an export of params Q) builds its
    engine on Q: the bridge reads an npz first, so the override must
    clear it, or a rollout onto Q would silently serve P."""
    from dtf_tpu_torch import convert
    from dtf_tpu_torch.cli import replica_main, serve_main
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.serve import bridge
    from dtf_tpu_torch.train.checkpoint import export_model

    def model(seed):
        return bridge.random_init(build_model(
            "transformer_small", num_classes=64)[0], seed)

    p, q = model(1), model(2)
    np.savez(tmp_path / "p.npz", **{
        k: np.asarray(v) for k, v in convert.flatten(
            convert.to_flax_params(p)).items()})
    export_model(str(tmp_path / "q"), q)
    monkeypatch.setenv("DTF_SERVE_CHECKPOINT", str(tmp_path / "q"))
    built = {}
    real = serve_main.build_serving_engine

    def spy(cfg, **kw):
        built["model"], engine = real(cfg, **kw)
        engine.stop(drain=False)
        raise _Built()

    monkeypatch.setattr(serve_main, "build_serving_engine", spy)
    cfg = parse_flags(["--device", "cpu", "--model", "transformer_small",
                       "--num_classes", "64", "--serve_max_seq_len", "32",
                       "--serve_params_npz", str(tmp_path / "p.npz"),
                       "--rendezvous_dir", str(tmp_path / "rdv")],
                      defaults=replica_main.REPLICA_DEFAULTS)
    with pytest.raises(_Built):
        replica_main.run_replica(cfg)
    got = built["model"].state_dict()
    for name, want in q.state_dict().items():
        assert torch.equal(got[name], want), name
    assert not torch.equal(got["embed.weight"], p.state_dict()["embed.weight"])


# ---------------------------------------------------------------------------
# a resumed ROLLING must not start a second process for one replica
# ---------------------------------------------------------------------------

_ENV_LOCK = threading.Lock()


class _SpawnedFake:
    """A Popen-like handle over a fake replica that announces ``delay``
    seconds after its spawn, with the generation and checkpoint a
    spawned ``replica_main`` would announce."""

    def __init__(self, rid, rdir, generation, checkpoint, delay):
        self.pid = os.getpid()
        self.returncode = None
        self.rep = None
        self._dead = threading.Event()

        def come_up():
            if self._dead.wait(delay):
                return
            with _ENV_LOCK:
                saved = {k: os.environ.get(k) for k in (
                    "DTF_RESTART_GENERATION", "DTF_SERVE_CHECKPOINT")}
                os.environ["DTF_RESTART_GENERATION"] = str(generation)
                os.environ["DTF_SERVE_CHECKPOINT"] = checkpoint
                try:
                    self.rep = FakeReplica(rid, rdir).start()
                finally:
                    for k, v in saved.items():
                        if v is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = v

        self._thread = threading.Thread(target=come_up, daemon=True)
        self._thread.start()

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        self.kill()
        return self.returncode

    def terminate(self):
        self.kill()

    def kill(self):
        self._dead.set()
        self._thread.join(timeout=10)
        if self.rep is not None:
            self.rep.kill()
        self.returncode = -9


def test_resume_waits_for_the_spawned_replacement(tmp_path):
    """The dead router's controller had persisted ROLLING with replica 1
    rolled and spawned its replacement (generation 1), which has not
    announced when the successor resumes.  The successor waits for that
    generation's announce and spawns nothing: one process a replica.
    (The JAX controller, and the port's before the repair, started a
    second process for replica 1.)"""
    rdir = str(tmp_path / "rdv")
    os.makedirs(rdir)
    procs = [_SpawnedFake(0, rdir, 1, NEW_SAME, 0.0),
             _SpawnedFake(1, rdir, 1, NEW_SAME, 1.5)]
    spawned = []
    router = None

    def spawn(rid, gen):
        spawned.append((rid, gen))
        procs.append(_SpawnedFake(rid, rdir, gen, router.replica_checkpoints
                                  .get(rid, ""), 0.2))
        return procs[-1]

    path = str(tmp_path / "rollout_state.json")
    with open(path, "w") as f:
        json.dump({"phase": "ROLLING", "new_checkpoint": NEW_SAME,
                   "old_checkpoint": OLD, "canary": 0, "order": [0, 1],
                   "rolled": [0, 1],
                   "replacing": {"replica": 1, "generation": 1}}, f)
    try:
        router = Router(2, rdir, spawn=spawn, epoch=2,
                        probe_interval_s=0.05, health_timeout_s=0.4,
                        deadline_s=30.0, replica_inflight=32, page_size=8)
        router.start(adopt=True)
        t0 = time.monotonic()
        while not router.replica_healthy(0) and time.monotonic() - t0 < 30:
            time.sleep(0.02)
        assert router.replica_healthy(0)
        state = RolloutController.resume(router, path, warm_timeout_s=8.0,
                                         drain_timeout_s=5.0, poll_s=0.02)
        assert state.phase == "DONE" and sorted(state.rolled) == [0, 1]
        assert spawned == [], f"second processes spawned: {spawned}"
        assert router.replica_healthy(1)
        assert RolloutState.load(path).replacing == {}
    finally:
        if router is not None:
            router.stop(drain=False)
        for p in procs:
            p.kill()
