"""Zero-downtime model rollout over the serving replica tier.  A copy
of ``dtf_tpu/serve/rollout.py``: the state machine drives the router's
control surface and nothing else, so it is the JAX package's but for
the three changes below; ``ckpt_truncate`` halves a file of the port's
export.

The train → export → fleet loop closes here: a running router/replica
tier moves onto a NEW checkpoint without shedding a request, mixing a
client stream across model versions, or losing the ability to return
to the old model instantly.  The mechanism is the tier's own fault
machinery pointed at a planned event: drain one replica at a time
(serve/router.py ``drain_replica`` — the same begin_drain contract
SIGTERM uses), restart it onto the new checkpoint (the spawner's
``checkpoint_map`` → DTF_SERVE_CHECKPOINT), let it warm and re-register
through the ordinary rendezvous, and advance.

State machine (persisted after every mutation, atomic tmp+rename)::

    IDLE ──► CANARY ──► ROLLING ──► DONE
               │            │
               └────────────┴─────► ROLLED_BACK

  CANARY   — the first replica is drained and restarted onto the new
      checkpoint as a SHADOW: it takes no client traffic, only
      mirrored copies of live greedy requests (router.start_mirror).
      Greedy determinism makes old-vs-new divergence a measurable,
      gateable quantity: the canary's answer is compared token-by-
      token against the old model's, and the gate passes only after
      ``canary_requests`` comparisons with the divergence rate inside
      ``max_divergence`` (default 0.0 — token-exact: identical
      checkpoints must compare EQUAL, so any mismatch is a model
      difference, never noise).
  ROLLING  — the canary joins service (new version), then each
      remaining replica drains → restarts → warms → re-registers, one
      at a time; version-affine placement guarantees in-flight and
      failed-over requests only ever continue on their own model
      version.
  DONE     — the fleet serves the new checkpoint.  The old checkpoint
      was never touched on disk (instant rollback needs it); DONE is
      the point an operator may GC it.
  ROLLED_BACK — any breach (canary divergence, a replica that cannot
      come up on the new checkpoint — truncated/corrupt files
      included, unexpected replica death mid-rollout) re-drains every
      new-version replica back onto the RETAINED old checkpoint.  The
      persisted ``rolled`` list shrinks as replicas return, so a
      controller death mid-rollback resumes deterministically.

A router restart mid-rollout resumes from the persisted state
(:meth:`RolloutController.resume`): CANARY resumes as a rollback (an
interrupted canary proved nothing), ROLLING resumes forward from the
persisted ``rolled`` set, ROLLED_BACK finishes the rollback.  Both
directions are deterministic — no state is reconstructed by guessing.

Four changes from the JAX controller: a controller whose router has
stopped (or died) writes no more state and stops — the persisted state
belongs to the successor that resumes it; a resumed ROLLING replaces a
``rolled`` replica whose announce names another checkpoint than the
new one (the predecessor died between recording it rolled and
restarting it: the old process stands, drained), not only one that is
down; and a rollback judges a dead replica outside ``rolled`` after
the rolled ones are home, so the prober's respawn of it is kept, not
replaced a second time; and a replacement is persisted
(``RolloutState.replacing``) before it is spawned, so a resumed ROLLING
waits up to the warm timeout for that generation's announce instead of
starting a second process for the replica.

Chaos composes: ``rollout_kill@phase:<canary|rolling>`` SIGKILLs a
replica while the rollout works in that phase, and ``ckpt_truncate``
fires against the NEW checkpoint before the canary restart; both must
end in ROLLED_BACK with the fleet token-exact on the old model and
zero lost requests (tests/test_torch_rollout.py pins it, and
``chip_smoke.py`` phase 14 on the card).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, List, Optional

from dtf_tpu_torch import chaos
from dtf_tpu_torch.obs import trace

log = logging.getLogger("dtf_tpu_torch")

PHASES = ("IDLE", "CANARY", "ROLLING", "DONE", "ROLLED_BACK")
_TRANSITIONS = {
    "IDLE": ("CANARY",),
    "CANARY": ("ROLLING", "ROLLED_BACK"),
    "ROLLING": ("DONE", "ROLLED_BACK"),
    "DONE": (),
    "ROLLED_BACK": (),
}


class RolloutError(RuntimeError):
    pass


@dataclasses.dataclass
class RolloutState:
    """The rollout's durable truth.  Everything a restarted router
    needs to resume or roll back deterministically lives here —
    nothing is inferred from the fleet."""

    phase: str = "IDLE"
    new_checkpoint: str = ""
    old_checkpoint: str = ""        # "" = the tier's flag-configured one
    canary: int = -1
    order: List[int] = dataclasses.field(default_factory=list)
    rolled: List[int] = dataclasses.field(default_factory=list)
    reason: str = ""
    compared: int = 0
    diverged: int = 0
    first_divergence_pos: int = -1
    updated_ts: float = 0.0
    # the port's own field (a loader drops what it does not know, both
    # ways): the replacement spawned and not yet seen standing,
    # {"replica": R, "generation": G}, persisted BEFORE the spawn so a
    # successor resuming the rollout waits for that generation's
    # announce instead of starting a second process for R
    replacing: dict = dataclasses.field(default_factory=dict)

    def advance(self, phase: str, reason: str = "") -> None:
        """Validated phase transition — an illegal edge is a bug in the
        controller, raised loudly, never silently written to disk."""
        if phase not in PHASES:
            raise RolloutError(f"unknown rollout phase {phase!r}")
        if phase not in _TRANSITIONS[self.phase]:
            raise RolloutError(
                f"illegal rollout transition {self.phase} -> {phase}")
        self.phase = phase
        if reason:
            self.reason = reason

    def save(self, path: str) -> None:
        self.updated_ts = time.time()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)
        os.replace(tmp, path)   # atomic: a resume never reads torn state

    @classmethod
    def load(cls, path: str) -> "RolloutState":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


def default_state_path(rendezvous_dir: str) -> str:
    return os.path.join(os.path.abspath(rendezvous_dir),
                        "rollout_state.json")


def _truncate_checkpoint(path: str) -> None:
    """The ckpt_truncate chaos payload, aimed at the NEW checkpoint —
    the torn-upload / bad-copy failure a rollout must survive by
    rolling back, not by serving garbage.  The walk-and-halve action
    itself is the train-side fault's (one payload, two aims)."""
    from dtf_tpu_torch.train.checkpoint import truncate_largest_file

    if truncate_largest_file(path) is None:
        raise RolloutError(f"ckpt_truncate: nothing to truncate under "
                           f"{path!r}")


class RolloutController:
    """Drives one rollout of ``router``'s whole tier onto
    ``new_checkpoint``.

    ``router`` — a started serve/router.py Router (proc mode, or any
        tier when ``restart_hook`` is given).
    ``restart_hook(replica_id, checkpoint)`` — test seam for proc-less
        tiers: kill the in-process replica and start its successor
        serving ``checkpoint``.  Proc mode uses the router's
        terminate/spawn + the spawner's checkpoint_map.
    ``canary_requests`` — completed old-vs-new comparisons the gate
        needs; ``mirror_fraction`` — the slice of live greedy traffic
        mirrored; ``max_divergence`` — gate threshold on the diverged/
        compared rate (0.0 = token-exact, the default).

    LOCK DISCIPLINE: the controller reaches into the router's replica
    state (fleet-stability checks); every such touch happens under the
    ROUTER's ``_mu`` — declared here, as the router declares its
    own, so the cross-object contract is written down (the
    with-block's base may be any alias of the router: ``with r._mu``
    / ``with self.router._mu`` both satisfy it).
    """

    _GUARDED_BY = {"_replicas": "_mu"}

    def __init__(self, router, new_checkpoint: str, *,
                 old_checkpoint: str = "",
                 state_path: str = "",
                 canary_requests: int = 4,
                 mirror_fraction: float = 1.0,
                 max_divergence: float = 0.0,
                 warm_timeout_s: float = 600.0,
                 drain_timeout_s: float = 120.0,
                 gate_timeout_s: float = 600.0,
                 restart_hook: Optional[Callable] = None,
                 poll_s: float = 0.05):
        if not new_checkpoint:
            raise ValueError("new_checkpoint is required")
        if canary_requests < 1:
            raise ValueError(f"canary_requests must be >= 1, got "
                             f"{canary_requests}")
        if not 0.0 <= max_divergence <= 1.0:
            raise ValueError(f"max_divergence must be in [0, 1], got "
                             f"{max_divergence}")
        self.router = router
        self.state = RolloutState(
            new_checkpoint=str(new_checkpoint),
            old_checkpoint=str(old_checkpoint),
            order=[r.id for r in router._replicas])
        self.state_path = state_path or default_state_path(
            router.rendezvous_dir)
        self.canary_requests = int(canary_requests)
        self.mirror_fraction = float(mirror_fraction)
        self.max_divergence = float(max_divergence)
        self.warm_timeout_s = float(warm_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.gate_timeout_s = float(gate_timeout_s)
        self.restart_hook = restart_hook
        self.poll_s = float(poll_s)
        self._respawns0 = 0

    # -- labels ---------------------------------------------------------
    @property
    def old_version(self) -> str:
        return self.state.old_checkpoint or "base"

    @property
    def new_version(self) -> str:
        return self.state.new_checkpoint

    # -- persistence ----------------------------------------------------
    def _persist(self, phase: Optional[str] = None,
                 reason: str = "") -> None:
        if self.router.stopped:
            raise RolloutError(
                f"router stopped mid-rollout ({self.state.phase}): the "
                f"persisted state stands for a successor to resume")
        if phase is not None:
            self.state.advance(phase, reason=reason)
            trace.event("rollout_phase", phase=self.state.phase,
                        rolled=list(self.state.rolled),
                        reason=self.state.reason)
            log.warning("rollout: phase %s%s", self.state.phase,
                        f" ({reason})" if reason else "")
        self.state.save(self.state_path)

    # -- fleet observation ----------------------------------------------
    def _snapshot_respawns(self) -> None:
        self._respawns0 = self.router.metrics.get(
            "router_replica_respawns_total").value

    def _disturbed(self) -> str:
        """Unexpected fleet instability mid-rollout: any UNPLANNED
        respawn, give-up, or a non-held replica down.  A rollout is a
        planned maneuver — instability during one means the safest
        model is the proven old one, so the policy is abort + roll
        back (the respawn machinery restores processes; this restores
        the MODEL)."""
        delta = (self.router.metrics.get(
            "router_replica_respawns_total").value - self._respawns0)
        if delta > 0:
            return f"unplanned_respawn(+{delta})"
        with self.router._mu:
            for r in self.router._replicas:
                if r.gave_up:
                    return f"replica{r.id}_gave_up"
                if not r.healthy and not r.hold_respawn:
                    return f"replica{r.id}_lost"
        return ""

    def _wait_healthy(self, rid: int, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self.router.stopped:
            if self.router.replica_healthy(rid):
                return True
            code = self.router.replica_exit_code(rid)
            if code is not None and code != 0:
                # the new process could not even start (bad/truncated
                # checkpoint, import error): fail FAST — waiting out
                # the warm timeout on a corpse helps nobody
                log.error("rollout: replica %d exited %s during "
                          "restart", rid, code)
                return False
            time.sleep(self.poll_s)
        return False

    # -- the one mechanical move ----------------------------------------
    def _replace(self, rid: int, checkpoint: str, version: str,
                 shadow: bool = False) -> bool:
        """Drain replica ``rid`` and restart it serving ``checkpoint``.
        True on healthy re-registration within the warm timeout."""
        r = self.router
        r.hold_replica(rid)
        drained = r.drain_replica(rid, timeout=self.drain_timeout_s)
        if not drained:
            log.error("rollout: replica %d did not drain in %.0fs — "
                      "its stragglers will fail over", rid,
                      self.drain_timeout_s)
        if self.restart_hook is not None:
            r.terminate_replica(rid)
            r.set_replica_version(rid, version)
            self.restart_hook(rid, checkpoint)
            r.allow_reconnect(rid)
        else:
            r.terminate_replica(rid)
            if checkpoint:
                r.replica_checkpoints[rid] = checkpoint
            else:
                r.replica_checkpoints.pop(rid, None)
            r.set_replica_version(rid, version)
            self.state.replacing = {"replica": rid,
                                    "generation": self._generation(rid) + 1}
            self._persist()
            r.spawn_replica(rid)
        ok = self._wait_healthy(rid, self.warm_timeout_s)
        if ok:
            self.state.replacing = {}
            r.release_replica(rid, shadow=shadow)
        return ok

    def _generation(self, rid: int) -> int:
        with self.router._mu:
            return self.router._replicas[rid].generation

    def _await_replacement(self, rid: int) -> bool:
        """Resume: when the dead controller had spawned ``rid``'s
        replacement (``state.replacing``), wait up to the warm timeout
        for that generation's announce to stand on the new checkpoint.
        True when it does: no second process is started."""
        pending = self.state.replacing
        if self.restart_hook is not None or pending.get("replica") != rid:
            return False
        gen = int(pending.get("generation", 0))
        log.warning("rollout: awaiting replica %d's generation %d, "
                    "spawned before the resume", rid, gen)
        deadline = time.monotonic() + self.warm_timeout_s
        while time.monotonic() < deadline and not self.router.stopped:
            if self._stands_on_new(rid) and self._generation(rid) >= gen:
                self.state.replacing = {}
                self._persist()
                return True
            time.sleep(self.poll_s)
        return False

    # -- rollback -------------------------------------------------------
    def _rollback(self, reason: str) -> RolloutState:
        trace.anomaly("rollout_rollback", reason=reason,
                      rolled=list(self.state.rolled),
                      compared=self.state.compared,
                      diverged=self.state.diverged)
        self.router.stop_mirror()
        self._persist("ROLLED_BACK", reason=reason)
        return self._finish_rollback()

    def _finish_rollback(self) -> RolloutState:
        """Return every new-version (or dead) replica to the retained
        old checkpoint.  ``rolled`` shrinks as replicas come home, so
        a death mid-rollback resumes exactly here."""
        r = self.router

        def restore(rid):
            ok = self._replace(rid, self.state.old_checkpoint,
                               self.old_version, shadow=False)
            if not ok:
                # rollback onto the PROVEN checkpoint failing is as
                # loud as it gets; keep restoring the others
                trace.anomaly("rollout_rollback_failed", replica=rid)
                log.error("rollout: replica %d failed to restore onto "
                          "the old checkpoint", rid)
                return
            if rid in self.state.rolled:
                self.state.rolled.remove(rid)
            self._persist()

        for rid in list(self.state.rolled):
            restore(rid)
        # a replica the chaos killed may not be in rolled — it still
        # must be standing on the old model before we call it done.
        # Judged only now: the prober respawns a replica it owns on its
        # old checkpoint while the rolled ones come home, and one that
        # stands (or is still starting and then stands) needs nothing
        with r._mu:
            down = [(rep.id, rep.proc is not None and rep.proc.poll() is None)
                    for rep in r._replicas
                    if not rep.healthy and not rep.gave_up]
        for rid, starting in down:
            if not (starting and self._wait_healthy(rid,
                                                    self.warm_timeout_s)):
                restore(rid)
        log.warning("rollout: ROLLED_BACK (%s) — fleet on the old "
                    "checkpoint", self.state.reason)
        return self.state

    # -- canary gate ----------------------------------------------------
    def _gate(self) -> str:
        """'' when the gate passes; a breach reason otherwise.  The
        comparisons come from LIVE traffic the router mirrors — the
        gate measures the models under the requests users actually
        send, not a synthetic probe set."""
        deadline = time.monotonic() + self.gate_timeout_s
        # the registry counters are CUMULATIVE across the router's
        # life — a second rollout's gate must judge only ITS OWN
        # comparisons, so everything below is a delta from here
        base = self.router.canary_stats()
        while time.monotonic() < deadline and not self.router.stopped:
            stats = self.router.canary_stats()
            self.state.compared = int(stats["compared"]
                                      - base["compared"])
            self.state.diverged = int(stats["diverged"]
                                      - base["diverged"])
            self.state.first_divergence_pos = int(
                stats["first_divergence_pos"])
            if self.state.diverged and self.max_divergence == 0.0:
                # token-exact gate: ONE divergence is a verdict (an
                # identical model compares equal, so any mismatch is
                # signal)
                return (f"canary_divergence(first_pos="
                        f"{self.state.first_divergence_pos})")
            if self.state.compared >= self.canary_requests:
                rate = self.state.diverged / self.state.compared
                if rate > self.max_divergence:
                    return (f"canary_divergence(rate={rate:.3f}>"
                            f"{self.max_divergence})")
                return ""
            why = self._disturbed()
            if why:
                return why
            if not self.router.replica_healthy(self.state.canary):
                return "canary_lost"
            time.sleep(self.poll_s)
        return (f"canary_timeout({self.state.compared}/"
                f"{self.canary_requests} comparisons)")

    # -- the rollout ----------------------------------------------------
    def run(self) -> RolloutState:
        """Execute the full rollout.  Returns the final state (phase
        DONE or ROLLED_BACK) — never raises for a gated/rolled-back
        outcome; rollback IS the designed answer to a bad checkpoint."""
        r = self.router
        if len(self.state.order) < 2:
            raise RolloutError(
                "rollout refused: a 1-replica tier has no capacity to "
                "roll — the shadow-only canary would be the ONLY "
                "replica, every live request would queue into its "
                "deadline, and the gate (fed by mirrored live traffic) "
                "could never complete")
        with r._mu:
            unhealthy = [rep.id for rep in r._replicas if not rep.healthy]
        if unhealthy:
            raise RolloutError(
                f"rollout refused: replicas {unhealthy} unhealthy — a "
                f"rollout starts from a stable fleet")
        # label the incumbent fleet (and the requests already latched
        # to its unlabeled version) so version-affine placement has a
        # ground truth from the first drained replica onward.  The
        # contract: ``old_checkpoint`` names what the fleet serves NOW
        # — a second rollout passes the first one's new checkpoint —
        # and it is ENFORCED: rolling back to a checkpoint the fleet
        # never served would end with the tier split across two models
        # while reporting success
        r.relabel_version("", self.old_version)
        wrong = [rid for rid in self.state.order
                 if r.replica_version(rid) != self.old_version]
        if wrong:
            raise RolloutError(
                f"rollout refused: replicas {wrong} serve "
                f"{[r.replica_version(i) for i in wrong]!r}, not the "
                f"declared old checkpoint {self.old_version!r} — pass "
                f"old_checkpoint= naming what the fleet serves NOW "
                f"(after a completed rollout, that is its new "
                f"checkpoint)")
        self._snapshot_respawns()
        self.state.canary = self.state.order[0]
        self._persist("CANARY")

        # chaos: the torn-upload case — the NEW checkpoint loses a
        # payload file before any replica tries to serve it
        if chaos.ckpt_truncate():
            _truncate_checkpoint(self.state.new_checkpoint)

        # the canary is on the new checkpoint from here: record it as
        # rolled BEFORE the restart, so a controller death inside the
        # restart window still knows to restore it
        self.state.rolled.append(self.state.canary)
        self._persist()
        if not self._replace(self.state.canary, self.state.new_checkpoint,
                             self.new_version, shadow=True):
            return self._rollback("canary_start_failed")

        r.start_mirror(self.state.canary, self.mirror_fraction)
        target = chaos.rollout_kill("canary", self.state.canary)
        if target is not None:
            r.kill_replica(target)
        breach = self._gate()
        r.stop_mirror()
        self._persist()   # gate counters into the durable state
        if breach:
            return self._rollback(breach)

        # gate passed: the canary joins service on the new model
        r.set_shadow(self.state.canary, False)
        self._persist("ROLLING")
        for rid in self.state.order:
            if rid in self.state.rolled:
                continue
            target = chaos.rollout_kill("rolling", rid)
            if target is not None:
                r.kill_replica(target)
                # the death registers through the ordinary detection
                # path (probe tick / conn EOF) — give it time to,
                # or the check below would race the prober and the
                # rollout would sail past its own chaos
                deadline = time.monotonic() + max(
                    2.0, 6 * r.probe_interval_s)
                while (time.monotonic() < deadline
                       and not self._disturbed()):
                    time.sleep(self.poll_s)
            why = self._disturbed()
            if why:
                return self._rollback(why)
            self.state.rolled.append(rid)
            self._persist()
            if not self._replace(rid, self.state.new_checkpoint,
                                 self.new_version, shadow=False):
                return self._rollback(f"replica{rid}_start_failed")
            why = self._disturbed()
            if why:
                return self._rollback(why)
        self._persist("DONE")
        log.warning("rollout: DONE — fleet on %s (old checkpoint "
                    "retained at %r)", self.state.new_checkpoint,
                    self.state.old_checkpoint or "<flag-configured>")
        return self.state

    def _stands_on_new(self, rid: int) -> bool:
        """Replica ``rid`` is up on the new checkpoint: healthy, and (in
        proc mode, when its announce says) serving it."""
        if not self.router.replica_healthy(rid):
            return False
        if self.restart_hook is not None:
            return True
        served = self.router.replica_announced_checkpoint(rid)
        return served is None or served == self.state.new_checkpoint

    # -- resume ---------------------------------------------------------
    @classmethod
    def resume(cls, router, state_path: str = "",
               restart_hook: Optional[Callable] = None,
               **kw) -> RolloutState:
        """Continue a rollout a dead router left mid-flight, from its
        persisted state alone.  CANARY resumes as a ROLLBACK (an
        interrupted canary proved nothing — the deterministic, safe
        verdict); ROLLING resumes FORWARD from the persisted rolled
        set; ROLLED_BACK finishes the rollback; DONE/IDLE are no-ops."""
        state_path = state_path or default_state_path(
            router.rendezvous_dir)
        state = RolloutState.load(state_path)
        self = cls(router, state.new_checkpoint or "-",
                   old_checkpoint=state.old_checkpoint,
                   state_path=state_path, restart_hook=restart_hook,
                   **kw)
        self.state = state
        self._snapshot_respawns()
        # the restarted router knows nothing about versions or
        # checkpoint overrides — rebuild BOTH from the durable state
        for rid in self.state.order:
            on_new = rid in self.state.rolled
            router.set_replica_version(
                rid, self.new_version if on_new else self.old_version)
            if self.restart_hook is None:
                if on_new and self.state.new_checkpoint:
                    router.replica_checkpoints[rid] = \
                        self.state.new_checkpoint
                else:
                    router.replica_checkpoints.pop(rid, None)
        log.warning("rollout: resuming from persisted phase %s "
                    "(rolled=%s)", state.phase, state.rolled)
        if state.phase in ("DONE", "IDLE"):
            return state
        if state.phase == "CANARY":
            return self._rollback("resumed_mid_canary")
        if state.phase == "ROLLED_BACK":
            return self._finish_rollback()
        # ROLLING: finish the roll forward
        for rid in self.state.order:
            if rid in self.state.rolled:
                # already targeted at the new checkpoint — make sure it
                # actually stands (the death may have struck mid-restart,
                # or before the restart, leaving the old process drained)
                if not (self._stands_on_new(rid)
                        or self._await_replacement(rid)):
                    if not self._replace(rid, self.state.new_checkpoint,
                                         self.new_version):
                        return self._rollback(
                            f"replica{rid}_resume_failed")
                continue
            self.state.rolled.append(rid)
            self._persist()
            if not self._replace(rid, self.state.new_checkpoint,
                                 self.new_version):
                return self._rollback(f"replica{rid}_start_failed")
            why = self._disturbed()
            if why:
                return self._rollback(why)
        self._persist("DONE")
        return self.state
