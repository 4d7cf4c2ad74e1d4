"""Deterministic fault injection -- the chaos layer, the PyTorch
counterpart of ``dtf_tpu/chaos/__init__.py``.

A recovery story that is never exercised is a recovery story that does
not work.  A fault spec names exactly which failure fires, on which
rank, at which point of the run, and the tests replay it
deterministically.  Shaped like ``obs/trace``: a module-level injector
that is ``None`` unless configured, so every probe is one attribute
read and compare when chaos is off.  Standard library only: the
launcher imports the exit codes from here.

Spec grammar (``--fault`` flag or the ``DTF_FAULT`` env var the
launcher forwards; comma-separated specs compose), the JAX package's::

    spec  := kind "@" [ selector ":" ] point
    selector := "rank" INT | "replica" INT
    point := "step" ":" INT | "version" ":" INT | "batch" ":" INT
             | "req" ":" INT | "latest" | INT-or-FLOAT

Kinds that fire here, their observation points being ported:

  crash@step:N            hard process death (``os._exit``) at the train
                          step-N boundary, after the interval checkpoint
                          of that boundary is sealed.  EXACT match, so a
                          run resumed at or past N does not re-die -- and
                          one resumed below N reaches N and dies again:
                          crash on a checkpoint boundary.  Exit code
                          EXIT_INJECTED_CRASH (77): a budgeted crash.
  sigterm@step:N          SIGTERM to the process itself at the step-N
                          boundary (exact match): the preemption path --
                          emergency checkpoint, EXIT_PREEMPTED (75), an
                          unbudgeted restart.
  heartbeat_stall@step:N  from step N on, heartbeat files silently stop
                          being written (latched): the deadlocked-but-
                          alive signature the supervisor's heartbeat
                          watchdog catches.
  ckpt_truncate@latest    halves the largest payload file of the NEWEST
                          checkpoint step before the next restore
                          (one-shot): the integrity manifest's fallback
                          to the previous verified step.
  host_loss@[rankK:]step:N  the rank SIGKILLs itself at the step-N
                          boundary (exact match): the rank-exit pattern
                          of a vanished host, which the supervisor
                          classifies as host loss.
  reader_crash@batch:N    SIGKILLs the data-service shard worker that
                          owns merged batch N, as the consumer reaches
                          that batch (exact match, one-shot): the
                          service's supervisor respawns the worker at
                          its recorded per-shard positions and the
                          merged stream is unchanged (data/service).
  ps_drop@version:N       an async parameter-server client severs its
                          connection once the store version it observed
                          reaches N (one-shot): its next op exercises
                          the real reconnect and backoff (parallel/ps.py).

The other kinds of the grammar (``NOT_PORTED``: device_loss and the
serving fleet's replica_kill, net_partition,
slow_replica, page_fetch_stall, router_kill, lease_stall, rollout_kill)
parse, but :func:`configure` raises naming the subsystem that is not
ported yet.

Every fired fault emits a structured ``injected_fault`` anomaly record
through ``obs.trace``, flushed before the process dies, so
``trace_main --check --allow injected_fault`` can assert a chaos run
contained the injected fault and nothing else.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
from typing import List, Optional

log = logging.getLogger("dtf_tpu_torch")

# Exit-code contract with the cli/launch.py supervisor, which imports
# these (this package is standard library only) -- the JAX package's
# values.
EXIT_PREEMPTED = 75        # EX_TEMPFAIL: graceful preemption checkpoint
EXIT_DEVICE_LOST = 76      # accelerators gone, host alive: the elastic
                           # supervisor reshards instead of budgeting it
                           # as a crash
EXIT_INJECTED_CRASH = 77   # injected hard crash (budgeted restart)

KINDS = ("crash", "sigterm", "heartbeat_stall", "ps_drop", "ckpt_truncate",
         "reader_crash", "replica_kill", "net_partition", "slow_replica",
         "rollout_kill", "device_loss", "host_loss", "page_fetch_stall",
         "router_kill", "lease_stall")
_POINTS = {
    "crash": "step",
    "sigterm": "step",
    "device_loss": "step",
    "host_loss": "step",
    "heartbeat_stall": "step",
    "ps_drop": "version",
    "ckpt_truncate": "latest",
    "reader_crash": "batch",
    "replica_kill": "req",
    "net_partition": "ticks",
    "slow_replica": "factor",
    "rollout_kill": "phase",
    "page_fetch_stall": "seconds",
    "router_kill": "req",
    "lease_stall": "ticks",
}
# rollout_kill's point value is a PHASE NAME, not a number
ROLLOUT_PHASES = ("canary", "rolling")
# distributed kinds whose point accepts the bare-value shorthand
# (net_partition@replica1:6) and which require/allow a replica target
_REPLICA_REQUIRED = ("net_partition", "slow_replica", "page_fetch_stall")
_BARE_POINT = ("net_partition", "slow_replica", "page_fetch_stall",
               "lease_stall")
# kinds whose point value is a float (everything else is an int)
_FLOAT_POINT = ("slow_replica", "page_fetch_stall")

# kinds that parse but whose observation point lies in a subsystem the
# port does not have yet: configure() refuses them, naming it
NOT_PORTED = {
    "device_loss": "elastic training (train/elastic.py)",
    **{kind: "the serving fleet (serve/router.py, serve/ha.py, "
             "serve/rollout.py, serve/migrate.py)"
       for kind in ("replica_kill", "net_partition", "slow_replica",
                    "page_fetch_stall", "router_kill", "lease_stall",
                    "rollout_kill")},
}

_injector: Optional["Injector"] = None
_lock = threading.Lock()


@dataclasses.dataclass
class FaultSpec:
    kind: str
    rank: Optional[int]     # None = every rank
    value: Optional[float]  # None for point "latest"; float only for
                            # slow_replica's factor, int otherwise
    replica: Optional[int] = None  # distributed kinds: target replica
    label: Optional[str] = None    # rollout_kill: the phase name
    fired: bool = False

    @property
    def point(self) -> str:
        return _POINTS[self.kind]

    def __str__(self) -> str:
        sel = ""
        if self.rank is not None:
            sel = f"rank{self.rank}:"
        elif self.replica is not None:
            sel = f"replica{self.replica}:"
        if self.label is not None:
            p = f"{self.point}:{self.label}"
        elif self.value is None:
            p = "latest"
        else:
            v = (self.value if self.kind in _FLOAT_POINT
                 else int(self.value))
            p = f"{self.point}:{v}"
        return f"{self.kind}@{sel}{p}"


def parse_spec(text: str) -> List[FaultSpec]:
    """Parse a comma-separated fault spec string; raises ValueError with
    the offending token on any grammar violation (a typo'd fault that
    silently never fires would invalidate the whole experiment)."""
    out: List[FaultSpec] = []
    for tok in (t.strip() for t in text.split(",")):
        if not tok:
            continue
        if "@" not in tok:
            raise ValueError(f"fault spec {tok!r}: expected kind@point")
        kind, _, point = tok.partition("@")
        if kind not in KINDS:
            raise ValueError(
                f"fault spec {tok!r}: unknown kind {kind!r} "
                f"(choose from {KINDS})")
        rank: Optional[int] = None
        replica: Optional[int] = None
        if point.startswith("rank"):
            rtok, _, point = point.partition(":")
            try:
                rank = int(rtok[4:])
            except ValueError:
                raise ValueError(
                    f"fault spec {tok!r}: bad rank selector {rtok!r}")
        elif point.startswith("replica"):
            rtok, _, point = point.partition(":")
            try:
                replica = int(rtok[7:])
            except ValueError:
                raise ValueError(
                    f"fault spec {tok!r}: bad replica selector {rtok!r}")
        if kind in _REPLICA_REQUIRED and replica is None:
            raise ValueError(
                f"fault spec {tok!r}: {kind} needs a replica<K> selector "
                f"(which replica to target)")
        want = _POINTS[kind]
        if want == "latest":
            if point != "latest":
                raise ValueError(
                    f"fault spec {tok!r}: {kind} takes the point 'latest'")
            out.append(FaultSpec(kind, rank, None, replica=replica))
            continue
        if want == "phase":
            sel, _, val = point.partition(":")
            if sel != "phase" or val not in ROLLOUT_PHASES:
                raise ValueError(
                    f"fault spec {tok!r}: {kind} takes "
                    f"'phase:<{'|'.join(ROLLOUT_PHASES)}>'")
            out.append(FaultSpec(kind, rank, None, replica=replica,
                                 label=val))
            continue
        sel, _, val = point.partition(":")
        if not val and kind in _BARE_POINT:
            # bare-value shorthand: net_partition@replica1:6
            sel, val = want, sel
        if sel != want or not val:
            hint = (f"'{want}:<value>' or a bare value"
                    if kind in _BARE_POINT else f"'{want}:<int>'")
            raise ValueError(f"fault spec {tok!r}: {kind} takes {hint}")
        try:
            value = (float(val) if kind in _FLOAT_POINT else int(val))
        except ValueError:
            raise ValueError(f"fault spec {tok!r}: {val!r} is not a number")
        if kind == "slow_replica":
            if value <= 1.0:
                raise ValueError(
                    f"fault spec {tok!r}: slow-down factor must be > 1")
        elif kind == "page_fetch_stall":
            if value <= 0.0:
                raise ValueError(
                    f"fault spec {tok!r}: stall needs > 0 seconds")
        elif kind == "net_partition":
            if value < 1:
                raise ValueError(
                    f"fault spec {tok!r}: partition needs >= 1 probe tick")
        elif kind == "lease_stall":
            if value < 1:
                raise ValueError(
                    f"fault spec {tok!r}: lease stall needs >= 1 "
                    f"renewal tick")
        elif value < 0:
            raise ValueError(f"fault spec {tok!r}: value must be >= 0")
        out.append(FaultSpec(kind, rank, value, replica=replica))
    return out


class Injector:
    """Holds the armed fault specs for THIS rank and fires them at the
    probe points.  Each spec fires at most once per process."""

    def __init__(self, specs: List[FaultSpec], rank: int = 0):
        self.rank = int(rank)
        self.specs = [s for s in specs
                      if s.rank is None or s.rank == self.rank]
        self._mu = threading.Lock()

    def _armed(self, kind: str):
        return [s for s in self.specs if s.kind == kind and not s.fired]

    def _record(self, spec: FaultSpec, **attrs) -> None:
        # lazy import: chaos stays standard library only for the
        # launcher
        from dtf_tpu_torch.obs import trace
        spec.fired = True
        log.error("chaos: firing injected fault %s %s", spec, attrs)
        # "fault_kind", not "kind": the record's own "kind" field is the
        # span/event/anomaly discriminator and must not be clobbered
        trace.anomaly("injected_fault", fault=str(spec),
                      fault_kind=spec.kind, **attrs)
        trace.flush()

    # -- probe points ---------------------------------------------------
    def step(self, step: int) -> None:
        """Train step-boundary probe.  EXACT-match semantics: a resumed
        run whose restored step is at or past the fault value must not
        re-fire it (or a deterministic fault would crash-loop the
        supervisor's whole restart budget away)."""
        step = int(step)
        with self._mu:
            for spec in self._armed("crash"):
                if step == spec.value:
                    self._record(spec, step=step)
                    # hard death: no atexit, no finally blocks -- what a
                    # segfault or OOM kill looks like to the supervisor
                    # (minus this distinct exit code)
                    os._exit(EXIT_INJECTED_CRASH)
            for spec in self._armed("sigterm"):
                if step == spec.value:
                    self._record(spec, step=step)
                    # the preemption signal, delivered for real so the
                    # production handler path runs
                    os.kill(os.getpid(), signal.SIGTERM)
            for spec in self._armed("host_loss"):
                if step == spec.value:
                    self._record(spec, step=step)
                    # the whole host vanishes: death by SIGKILL, which
                    # the supervisor reads as an unprompted kill
                    os.kill(os.getpid(), signal.SIGKILL)

    def heartbeat_stalled(self, step: Optional[int]) -> bool:
        """True once a heartbeat_stall fault latched (permanent: a
        deadlocked rank does not recover by itself)."""
        with self._mu:
            for spec in self.specs:
                if spec.kind != "heartbeat_stall":
                    continue
                if spec.fired:
                    return True
                if step is not None and int(step) >= spec.value:
                    self._record(spec, step=int(step))
                    return True
        return False

    def ps_drop(self, version: int) -> bool:
        """One-shot: True when the PS client should drop its connection
        (observed store version reached the spec value)."""
        with self._mu:
            for spec in self._armed("ps_drop"):
                if int(version) >= spec.value:
                    self._record(spec, version=int(version))
                    return True
        return False

    def reader_crash(self, batch: int) -> bool:
        """One-shot, EXACT-match: True when the data-service consumer
        reaching merged batch `batch` should kill the owning shard
        worker.  Exact match for the same reason as step(): a resumed
        run positioned at/past the batch must not re-fire."""
        with self._mu:
            for spec in self._armed("reader_crash"):
                if int(batch) == spec.value:
                    self._record(spec, batch=int(batch))
                    return True
        return False

    def ckpt_truncate(self) -> bool:
        """One-shot: True when the next restore should first truncate
        the newest checkpoint step (the torn-write simulation)."""
        with self._mu:
            for spec in self._armed("ckpt_truncate"):
                self._record(spec)
                return True
        return False


# ---------------------------------------------------------------------------
# Module-level API (what instrumented code calls) -- every probe is a
# None check when chaos is off.
# ---------------------------------------------------------------------------

def configure(spec: str, rank: Optional[int] = None) -> Injector:
    """Arm the process-global injector; reconfiguring replaces it.
    Raises ValueError on a grammar violation and on a kind whose
    subsystem is not ported (``NOT_PORTED``)."""
    global _injector
    if rank is None:
        rank = int(os.environ.get("DTF_PROCESS_ID", "0"))
    specs = parse_spec(spec)
    for s in specs:
        if s.kind in NOT_PORTED:
            raise ValueError(
                f"fault {s}: {s.kind} fires in {NOT_PORTED[s.kind]}, "
                f"which is not ported to dtf_tpu_torch yet")
    with _lock:
        _injector = Injector(specs, rank=rank)
    if specs:
        log.warning("chaos armed (rank %d): %s", rank,
                    ", ".join(str(s) for s in _injector.specs) or
                    "(no spec targets this rank)")
    return _injector


def maybe_configure(cfg=None) -> Optional[Injector]:
    """Arm from ``cfg.fault`` or the ``DTF_FAULT`` env var.  When
    neither is set chaos is DISARMED (not merely left alone): a fault
    armed by a previous run in the same process must never leak into a
    run that did not ask for one.  Explicit config wins over env."""
    spec = (getattr(cfg, "fault", "") or os.environ.get("DTF_FAULT", ""))
    if not spec:
        disable()
        return None
    rank = getattr(cfg, "process_id", None) if cfg is not None else None
    return configure(spec, rank=rank)


def get() -> Optional[Injector]:
    return _injector


def enabled() -> bool:
    return _injector is not None


def disable() -> None:
    """Disarm (tests)."""
    global _injector
    with _lock:
        _injector = None


def step(step_value: int) -> None:
    inj = _injector
    if inj is None:
        return
    inj.step(step_value)


def heartbeat_stalled(step_value: Optional[int]) -> bool:
    inj = _injector
    if inj is None:
        return False
    return inj.heartbeat_stalled(step_value)


def ps_drop(version: int) -> bool:
    inj = _injector
    if inj is None:
        return False
    return inj.ps_drop(version)


def ckpt_truncate() -> bool:
    inj = _injector
    if inj is None:
        return False
    return inj.ckpt_truncate()


def reader_crash(batch: int) -> bool:
    inj = _injector
    if inj is None:
        return False
    return inj.reader_crash(batch)
