"""Serving replica tier: a health-checked router over N replica serve
processes.  A copy of ``dtf_tpu/serve/router.py``: the router is
framework-free (numpy, sockets, threads), so its placement, failover
and migration orchestration are the JAX package's, line for line.

Heavy traffic needs many serving PROCESSES, several of them on one card
or one host.  This module is the front-end
that owns the client-facing queue and fans requests out to N replicas
(each a full ServeEngine behind serve/replica.py's wire protocol),
with failure handling as first-class contracts rather than an operator
reading ``log7.log``:

  placement — PREFIX-AFFINE by default: requests are routed by the
      chained prefix digest of their full prompt pages (the same
      digest chain the engine's PrefixRegistry keys on), so traffic
      sharing a system prompt lands on the replica whose registry is
      already warm — a prefix hit there costs zero prefill pages,
      while scattering the same traffic re-prefills the prompt once
      per replica.  Fallback (and tie-break) is least-loaded; a
      ``random`` policy exists for A/B comparisons.
  health — per-replica liveness comes from the obs heartbeat files
      (``heartbeat_rank{K}.json``) the replica's ENGINE LOOP rewrites,
      read by a prober at a fixed tick — never from the socket, so a
      wedged replica with a healthy TCP stack still reads as dead, and
      a network partition (probes dropped, process fine) reads exactly
      like a stall: silence.  The announce file (``replica_rank{K}
      .json``, ephemeral port + pid) is the re-registration channel: a
      respawned or healed replica re-registers by rewriting it.
  deadlines — every request carries one; a scan at dispatch-loop
      cadence fails overdue requests with :class:`DeadlineExceeded`.
      Degrade, never hang: every accepted request resolves — tokens,
      Backpressure, or DeadlineExceeded — within its deadline.
  retry / failover — a dead or unreachable replica's in-flight
      requests re-dispatch transparently with exponential backoff.
      Decode is deterministic (greedy), so a re-dispatched request
      reproduces its token stream exactly; the router dedupes by token
      index (already-delivered tokens are verified, not re-emitted) so
      a client stream sees each token once.  A divergence (sampled
      requests re-dispatch with a different engine RNG) is counted and
      flagged, never silently mixed.
  backpressure — a replica's ``Backpressure(retry_after)`` marks it
      saturated until retry_after and the request tries its siblings
      ONCE each; when every live replica has shed it, the Backpressure
      propagates to the client instead of becoming a router retry
      storm.  A router-level admission bound sheds new submits loudly
      (``router_shed`` anomaly) when the outstanding count hits it.
  respawn — when the router owns the replica processes, a dead one
      respawns under the launcher supervisor's discipline: a sliding-window
      budget with exponential backoff, then loud give-up.  The fresh
      process re-announces (new port, same file) and the prober folds
      it back in.

  disaggregation — ``prefill_replicas=P`` splits the tier into a
      prefill pool (replicas 0..P-1) and a decode pool (the rest).
      Cold prompts (affinity miss) route to the prefill pool; when a
      prefill-pool replica finishes a request whose prompt has full
      KV pages, the router RE-HOMES the chain: it commands the
      least-loaded decode replica to pull the pages over the wire
      (serve/migrate.py — ``migrate_in`` → ``page_fetch`` against the
      prefill replica's own server socket) and, on the ``migrated``
      ack, moves the prefix-owner entries so sibling traffic decodes
      in the decode pool with near-zero prefill.  Migration failure
      is an EFFICIENCY loss, never a correctness event: the chain
      just stays where it is and the next miss re-prefills —
      ``migration_failed`` is counted + flagged, no request is
      touched.  ``prefill_replicas=0`` (default) is the colocated
      tier, byte-identical to the pre-disaggregation router.

  high availability — the router itself is no longer a single point
      of failure.  Every request's lifecycle is journaled to an
      append-only WAL in the rendezvous dir (serve/journal.py) so a
      SUCCESSOR router — a restart, or a warm standby holding the
      shared-storage leader lease (serve/ha.py) — replays it and
      RE-ADOPTS the in-flight requests: a new ``reattach`` wire op
      rebinds each one to the replica still decoding it (engines never
      stopped — a router death is an efficiency blip, not an outage)
      and the replica replays its retained token tail through the SAME
      token-index verify+dedupe that makes replica failover
      exactly-once.  Split-brain is fenced by a monotonic epoch: every
      controller wire op carries it, replicas reject ops from a
      superseded epoch (``stale_epoch``), and a fenced router sheds
      instead of double-driving the tier.

Chaos composes (dtf_tpu_torch/chaos): ``replica_kill@req:N`` SIGKILLs a
replica at the Nth dispatch, ``net_partition@replica<K>:<ticks>``
drops K's health probes for that many prober ticks (timeouts, not
clean exits), ``slow_replica@replica<K>:<factor>`` stretches K's
decode steps, ``page_fetch_stall@replica<K>:<s>`` stalls K's
migration client before each page-fetch window.
tests/test_torch_router.py drives them over in-process replicas and
pins token-exactness and zero lost requests, against the JAX router
too.  ``router_kill@req:N`` kills the router itself at its Nth
dispatch and ``lease_stall@<ticks>`` drops its lease renewals
(serve/ha.py, tests/test_torch_ha.py); ``rollout_kill@phase:P``
kills a replica mid-rollout (serve/rollout.py,
tests/test_torch_rollout.py).

Beyond the JAX router, a router that can spawn replicas (proc mode)
also stops, kills and replaces the replicas it ADOPTED from a
predecessor (``start(adopt=True)``: no process handle here) by the pid
their announce names, on this host, and continues their restart
generation, so a standby that takes over mid-rollout can finish it;
and once the router has stopped (or died: a crash hook's freeze sets
the same flag) its replica-moving control ops refuse, so a rollout
controller that outlives its router cannot act on the tier its
successor now drives.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import queue as queue_mod
import signal
import socket
import struct
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from dtf_tpu_torch import chaos
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.registry import MetricsRegistry
from dtf_tpu_torch.obs.watchdog import heartbeat_path, read_heartbeat
from dtf_tpu_torch.serve import journal as journal_mod
from dtf_tpu_torch.serve.engine import Backpressure, _page_digest
from dtf_tpu_torch.serve.replica import read_announce, send_msg

log = logging.getLogger("dtf_tpu_torch")

PLACEMENTS = ("affinity", "least_loaded", "random")

# announce hosts whose pid names a process of THIS host
_LOCAL_HOSTS = ("127.0.0.1", "localhost", "::1")


class DeadlineExceeded(RuntimeError):
    """The request did not finish inside its deadline.  The router
    resolves it LOUDLY at the deadline instead of letting the client
    wait on a promise nobody is working on."""

    def __init__(self, request_id: int, deadline_s: float, detail: str = ""):
        super().__init__(
            f"request {request_id} exceeded its {deadline_s:.1f}s "
            f"deadline{': ' + detail if detail else ''}")
        self.request_id = request_id
        self.deadline_s = deadline_s


@dataclasses.dataclass
class RouterResult:
    request_id: int
    tokens: List[int]
    prompt_len: int
    latency_s: float
    replica: int                 # replica that completed it
    redispatches: int            # failover count this request survived
    diverged: bool               # re-dispatched tokens mismatched the
                                 # already-delivered prefix (sampled
                                 # requests only; greedy never)
    submit_time: float = 0.0
    finish_time: float = 0.0
    # the router-minted distributed-trace id: every record this request
    # produced — router events, replica spans, failover replays —
    # carries it; `trace_main --request <id>` renders the timeline
    trace_id: Optional[str] = None
    # the model-version label of the replica(s) that served it — ONE
    # label by construction (version-affine placement); "" outside a
    # rollout
    version: str = ""


class RouterHandle:
    """Future-lite for one routed request: ``result()`` blocks (raising
    Backpressure/DeadlineExceeded when that's how it resolved);
    ``stream()`` yields tokens as replicas deliver them, each exactly
    once across failovers."""

    def __init__(self, req: "_Request"):
        self.request = req
        self._event = threading.Event()
        self._result: Optional[RouterResult] = None
        self._exc: Optional[BaseException] = None
        self._q: "queue_mod.Queue" = queue_mod.Queue()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> RouterResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not resolved in {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def stream(self, timeout: Optional[float] = None):
        """Iterator over tokens; ends when the request resolves.  A
        request that resolved in failure raises its exception here
        too, so a streaming consumer cannot mistake a shed request
        for a short answer."""
        while True:
            try:
                kind, payload = self._q.get(timeout=timeout)
            except queue_mod.Empty:
                raise TimeoutError(
                    f"request {self.request.id}: no token in {timeout}s"
                ) from None
            if kind == "done":
                if self._exc is not None:
                    raise self._exc
                return
            yield payload

    # router-side delivery (under the router lock)
    def _emit(self, token: int) -> None:
        self._q.put(("token", int(token)))

    def _deliver(self, result: RouterResult) -> None:
        self._result = result
        self._event.set()
        self._q.put(("done", None))

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()
        self._q.put(("done", None))


class _Request:
    __slots__ = ("id", "prompt", "max_new_tokens", "temperature",
                 "eos_id", "deadline", "deadline_s", "digests", "handle",
                 "delivered", "attempt", "next_try", "active",
                 "bp_replicas", "redispatches", "diverged", "done",
                 "submit_time", "last_dispatch", "last_progress",
                 "trace", "span", "queue_wait", "rng_seed", "version")

    def __init__(self, rid: int, prompt: np.ndarray, max_new_tokens: int,
                 temperature: float, eos_id, deadline_s: float,
                 digests: List[str], trace_id: Optional[str] = None,
                 rng_seed: Optional[int] = None):
        self.id = rid
        # distributed span context: one trace id for the request's
        # whole cross-process life, one router-side span id the
        # replica-side records link back to (parent_span)
        self.trace = trace_id or trace.new_trace_id()
        self.span = trace.new_span_id()
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.deadline_s = deadline_s
        self.submit_time = time.time()
        self.deadline = time.monotonic() + deadline_s
        self.digests = digests
        self.handle = RouterHandle(self)
        self.delivered: List[int] = []
        self.attempt = 0
        self.next_try = 0.0
        self.active: Dict[str, int] = {}   # wire_id -> replica id
        self.bp_replicas: set = set()
        self.redispatches = 0
        self.diverged = False
        self.done = False
        self.last_dispatch = 0.0
        self.last_progress = 0.0
        self.queue_wait: Optional[float] = None
        # wire-carried sampling identity: every dispatch (failover
        # replays included) ships the SAME seed, so sampled requests
        # replay token-exactly like greedy ones
        self.rng_seed = rng_seed
        # model-version affinity: latched to the FIRST dispatch's
        # replica version — during a rollout, a failover may only
        # land on a replica serving the same model, so a client
        # stream is never a mix of two checkpoints
        self.version: Optional[str] = None


class _Shadow:
    """Canary-mirror bookkeeping for one mirrored request: the shadow
    copy runs on the new-checkpoint canary, its tokens are COMPARED
    against the primary's (old model), never delivered."""

    __slots__ = ("req", "wire_id", "replica", "tokens", "shadow_done",
                 "primary", "created")

    def __init__(self, req: _Request, wire_id: str, replica: int):
        self.req = req
        self.wire_id = wire_id
        self.replica = replica
        self.tokens: Optional[List[int]] = None   # canary's answer
        self.shadow_done = False
        self.primary: Optional[List[int]] = None  # old model's answer
        self.created = time.monotonic()


class _Replica:
    """Router-side state for one replica."""

    def __init__(self, rid: int, rendezvous_dir: str):
        self.id = rid
        self.rendezvous_dir = rendezvous_dir
        self.proc: Optional[subprocess.Popen] = None
        self.generation = 0
        self.host: str = "127.0.0.1"
        self.port: Optional[int] = None
        self.announced_pid: Optional[int] = None
        # the checkpoint the announce says the process serves (its
        # DTF_SERVE_CHECKPOINT, "" = the flag-configured one); None =
        # the announce does not say
        self.announced_checkpoint: Optional[str] = None
        self.conn: Optional[socket.socket] = None
        self.wfile = None
        self.wlock = threading.Lock()
        self.healthy = False
        self.gave_up = False
        self.inflight: Dict[str, _Request] = {}
        self.saturated_until = 0.0
        self.last_beat_mono = time.monotonic()
        self.last_beat_ts = None
        self.hb_mtime = None
        self.respawn_times: collections.deque = collections.deque()
        self.respawn_at: Optional[float] = None
        self.completed = 0
        self.last_stats: Dict[str, dict] = {}   # tag -> stats msg
        # rollout surface (serve/rollout.py): a draining replica takes
        # no new placements; a shadow-only replica (the canary) takes
        # ONLY mirrored traffic; hold_respawn parks the prober's
        # auto-respawn while the rollout controller owns the process;
        # version is the model-identity label version-affine placement
        # matches against (all-"" outside a rollout → no constraint)
        self.draining = False
        self.shadow_only = False
        self.hold_respawn = False
        self.reconnect_block = False
        self.version: str = ""
        # disaggregation pool role: "both" (colocated default),
        # "prefill" or "decode" when the router splits the tier
        self.role: str = "both"


class Router:
    """The replica-tier front-end.  See the module docstring.

    ``spawn`` is a callable ``(replica_id, generation) -> Popen`` that
    starts one replica process (see :func:`replica_spawner`); None
    means the replicas are managed externally (tests, or an operator
    supervising them separately) — the router then only connects,
    probes, and fails over, and ``kill_hook`` (tests) stands in for
    SIGKILL when chaos wants a replica dead.

    LOCK DISCIPLINE: ``_mu`` guards every piece of routing state the
    dispatcher, prober, reader threads and client callers share —
    declared below in ``_GUARDED_BY``: no guarded attribute is
    touched outside ``with self._mu`` or a ``*_locked`` method (which
    its caller enters holding the lock).  NOT guarded,
    deliberately: ``_replicas`` (the list itself is fixed at
    construction; per-replica fields mutate under ``_mu`` through the
    ``*_locked`` paths), ``_stopping``/``_started``/``_draining``-free
    latches read by the loops (``_stopping`` is a monotonic bool whose
    racy read only costs one extra loop tick), and the metrics objects
    (internally consistent counters)."""

    _GUARDED_BY = {
        "_queue": "_mu", "_live": "_mu", "_outstanding": "_mu",
        "_ids": "_mu", "_dispatch_seq": "_mu", "_prefix_owner": "_mu",
        "_shadows": "_mu", "_shadow_by_req": "_mu", "_mirror": "_mu",
        "_mirror_acc": "_mu", "_stats_events": "_mu",
        "_draining": "_mu", "_ewma_latency": "_mu",
        "_migrations": "_mu", "_fenced": "_mu", "_chain_heat": "_mu",
    }

    def __init__(self, num_replicas: int, rendezvous_dir: str, *,
                 spawn: Optional[Callable] = None,
                 page_size: int = 16,
                 placement: str = "affinity",
                 deadline_s: float = 120.0,
                 admission_limit: int = 128,
                 probe_interval_s: float = 0.25,
                 health_timeout_s: float = 15.0,
                 replica_inflight: int = 16,
                 retry_backoff_s: float = 0.05,
                 max_retry_backoff_s: float = 2.0,
                 max_respawns: int = 8,
                 respawn_window_s: float = 300.0,
                 respawn_backoff_s: float = 0.5,
                 hedge_s: float = 0.0,
                 kill_hook: Optional[Callable] = None,
                 checkpoint_map: Optional[Dict[int, str]] = None,
                 prefill_replicas: int = 0,
                 migrate_timeout_s: float = 60.0,
                 seed: int = 0,
                 journal_path: Optional[str] = None,
                 journal_fsync_s: float = 0.05,
                 epoch: int = 0,
                 role: str = "leader",
                 crash_hook: Optional[Callable] = None):
        if num_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {num_replicas}")
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}; choose "
                             f"from {PLACEMENTS}")
        prefill_replicas = int(prefill_replicas)
        if prefill_replicas < 0 or prefill_replicas >= num_replicas:
            if prefill_replicas != 0:
                raise ValueError(
                    f"prefill_replicas ({prefill_replicas}) must leave "
                    f"at least one decode replica (num_replicas="
                    f"{num_replicas})")
        if prefill_replicas and placement != "affinity":
            raise ValueError(
                "disaggregation (prefill_replicas > 0) needs "
                "placement='affinity' — pool re-homing rides the "
                "prefix-owner map")
        if probe_interval_s >= health_timeout_s:
            raise ValueError(
                f"probe_interval_s ({probe_interval_s}) must be < "
                f"health_timeout_s ({health_timeout_s}) — a health "
                f"verdict needs multiple probe ticks")
        self.rendezvous_dir = os.path.abspath(rendezvous_dir)
        os.makedirs(self.rendezvous_dir, exist_ok=True)
        self._spawn = spawn
        self.page_size = int(page_size)
        self.placement = placement
        self.deadline_s = float(deadline_s)
        self.admission_limit = int(admission_limit)
        self.probe_interval_s = float(probe_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self.replica_inflight = int(replica_inflight)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_retry_backoff_s = float(max_retry_backoff_s)
        self.max_respawns = int(max_respawns)
        self.respawn_window_s = float(respawn_window_s)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.hedge_s = float(hedge_s)
        self._kill_hook = kill_hook
        self._rng = np.random.default_rng(seed)
        # HA identity: the fencing epoch this router controls the tier
        # under (0 = HA off / first leader), stamped on every
        # controller wire op; role is reporting-only (health/healthz)
        self.epoch = int(epoch)
        self.role = str(role)
        self._fenced = False
        self._crash_hook = crash_hook

        self._mu = threading.Condition()
        self._replicas = [_Replica(i, self.rendezvous_dir)
                          for i in range(int(num_replicas))]
        self.prefill_replicas = prefill_replicas
        self.migrate_timeout_s = float(migrate_timeout_s)
        if prefill_replicas:
            for r in self._replicas:
                r.role = ("prefill" if r.id < prefill_replicas
                          else "decode")
        # in-flight chain migrations: xfer id -> bookkeeping (digests
        # to re-home, source/target ids, start time, trace id)
        self._migrations: Dict[str, dict] = {}
        self._queue: List[_Request] = []
        self._live: Dict[int, _Request] = {}
        self._outstanding = 0
        self._ids = 0
        self._dispatch_seq = 0
        self._draining = False
        self._stopping = False
        self._ewma_latency = 0.5
        # digest -> replica id, insertion-ordered and BOUNDED: routing
        # state must not grow with total traffic (the replica-side
        # registry it mirrors is bounded by pool pages; stale owners
        # only cost a least-loaded fallback)
        self._prefix_owner: Dict[str, int] = {}
        self._prefix_owner_cap = 65536
        self._stats_events: Dict[str, threading.Event] = {}
        # per-replica checkpoint overrides, consulted by the spawner at
        # spawn time (replica_spawner's checkpoint_map) — the rollout
        # controller points a replica at the NEW checkpoint here before
        # respawning it.  Shared BY REFERENCE with the spawner closure.
        self.replica_checkpoints: Dict[int, str] = (
            checkpoint_map if checkpoint_map is not None else {})
        # canary mirroring: (replica id, fraction) while a rollout's
        # canary arm is comparing; shadows keyed by shadow wire id +
        # by primary request id (the comparison needs both answers)
        self._mirror: Optional[tuple] = None
        self._mirror_acc = 0.0
        self._shadows: Dict[str, _Shadow] = {}
        self._shadow_by_req: Dict[int, _Shadow] = {}
        # hot-chain tracker for the heal-time KV prefetch: deepest
        # digest -> (dispatch count, full digest chain, prompt tokens).
        # BOUNDED like the owner map — insertion-ordered, oldest out
        self._chain_heat: Dict[str, tuple] = {}
        self._chain_heat_cap = 64

        # obs registry: the router's operational vocabulary
        self.metrics = MetricsRegistry()
        m = self.metrics
        self._m_queue_depth = m.gauge("router_queue_depth", unit="requests")
        self._m_inflight = m.gauge("router_inflight", unit="requests")
        self._m_dispatch = m.counter("router_dispatch_total",
                                     unit="requests")
        self._m_completed = m.counter("router_completed_total",
                                      unit="requests")
        self._m_shed = m.counter("router_shed_total", unit="requests")
        self._m_bp_relayed = m.counter("router_backpressure_relayed_total",
                                       unit="requests")
        self._m_failover = m.counter("router_failover_total",
                                     unit="requests")
        self._m_hedge = m.counter("router_hedge_total", unit="requests")
        self._m_deadline = m.counter("router_deadline_exceeded_total",
                                     unit="requests")
        self._m_affinity_hit = m.counter("router_affinity_hits_total",
                                         unit="requests")
        self._m_affinity_miss = m.counter("router_affinity_miss_total",
                                          unit="requests")
        self._m_stale = m.counter("router_stale_msgs_total", unit="msgs")
        self._m_diverged = m.counter("router_redispatch_divergence_total",
                                     unit="requests")
        self._m_respawns = m.counter("router_replica_respawns_total",
                                     unit="replicas")
        self._m_latency = m.histogram("router_latency_s", unit="s")
        # CANCEL fan-out: stale attempts (deadline-exceeded, losing
        # hedge, resolved-elsewhere) told to stop decoding — reclaimed
        # replica capacity, not just discarded answers
        self._m_cancel = m.counter("router_cancel_sent_total",
                                   unit="requests")
        # prefix owner-map handoff: digests re-homed to the warmest
        # sibling when their owner is drained/replaced/lost
        self._m_rehomed = m.counter("router_prefix_rehomed_total",
                                    unit="digests")
        # canary arm (rollout): mirrored shadow traffic and its
        # token-by-token verdicts against the old model
        self._m_mirrored = m.counter("router_canary_mirrored_total",
                                     unit="requests")
        self._m_compared = m.counter("router_canary_compared_total",
                                     unit="requests")
        self._m_canary_div = m.counter("router_canary_diverged_total",
                                       unit="requests")
        self._m_first_div = m.gauge("router_canary_first_divergence_pos",
                                    unit="position")
        self._m_first_div.set(-1)
        # must stay 0: a client stream mixing two model versions
        self._m_mixed = m.counter("router_mixed_model_total",
                                  unit="requests")
        # planned (rollout) replica replacements — NOT failures, so
        # they are counted apart from router_replica_respawns_total
        self._m_replaced = m.counter("router_replica_replacements_total",
                                     unit="replicas")
        # submit → first dispatch: the router-side queueing delay the
        # capacity simulator's queueing model calibrates against
        # (serve_stream_lag_s's missing sibling)
        self._m_queue_wait = m.histogram("router_queue_wait_s", unit="s")
        # disaggregation: chains re-homed prefill pool -> decode pool
        # over the wire, and the migrations that didn't make it (an
        # efficiency loss, never a lost request)
        self._m_migrations = m.counter("router_migrations_total",
                                       unit="chains")
        self._m_mig_failed = m.counter("router_migration_failed_total",
                                       unit="chains")
        self._m_health = [m.gauge(f"router_replica{i}_healthy",
                                  unit="bool")
                          for i in range(int(num_replicas))]
        # HA vocabulary: the fencing epoch this router drives the tier
        # under, takeovers performed, requests recovered across a
        # router death (re-attached to a live engine vs re-dispatched
        # from scratch), stale-epoch rejections observed (any > 0 =
        # a superseded controller tried to drive the tier), journal
        # append→fsync lag (the bound on what a host crash can lose),
        # and KV pages pulled by the heal-time prefetch
        self._m_epoch = m.gauge("router_ha_epoch", unit="epoch")
        self._m_epoch.set(self.epoch)
        self._m_takeover = m.counter("router_takeover_total",
                                     unit="takeovers")
        self._m_readopted = m.counter("router_readopted_total",
                                      unit="requests")
        self._m_redispatched = m.counter("router_redispatched_total",
                                         unit="requests")
        self._m_stale_epoch = m.counter("router_stale_epoch_total",
                                        unit="msgs")
        self._m_jlag = m.histogram("router_journal_lag_s", unit="s")
        self._m_prefetch = m.counter("router_prefetch_pages_total",
                                     unit="pages")
        # the crash-recovery WAL (None = HA off, zero overhead):
        # created AFTER the metrics so fsync lag lands in the histogram
        self._journal: Optional[journal_mod.RequestJournal] = None
        if journal_path:
            self._journal = journal_mod.RequestJournal(
                journal_path, fsync_interval_s=journal_fsync_s,
                lag_observe=self._m_jlag.observe)

        self._threads: List[threading.Thread] = []
        self._started = False

    # -- lifecycle -----------------------------------------------------
    def start(self, wait_s: float = 0.0,
              adopt: bool = False) -> "Router":
        """Spawn replicas (proc mode), start the dispatcher + prober.
        ``wait_s`` > 0 blocks until every replica is healthy (raises
        on timeout) — the smoke posture; 0 returns immediately
        and traffic queues until replicas register.

        ``adopt=True`` is the TAKEOVER posture (serve/ha.py): the tier
        is already running under a dead predecessor — do NOT unlink
        its announce/heartbeat files or spawn fresh processes, just
        discover the live replicas through the rendezvous and connect.
        A takeover that respawned the tier would turn a router blip
        into N replica cold-starts."""
        if self._started:
            raise RuntimeError("router already started")
        self._started = True
        if self._spawn is not None and not adopt:
            from dtf_tpu_torch.serve.replica import announce_path
            for r in self._replicas:
                # a heartbeat/announce surviving a previous run must not
                # masquerade as this generation's registration
                for path in (heartbeat_path(self.rendezvous_dir, r.id),
                             announce_path(self.rendezvous_dir, r.id)):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                r.proc = self._spawn(r.id, r.generation)
        for name, fn in (("router-dispatch", self._dispatch_loop),
                         ("router-probe", self._probe_loop)):
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        if wait_s > 0:
            deadline = time.monotonic() + wait_s
            while time.monotonic() < deadline:
                with self._mu:
                    if all(r.healthy for r in self._replicas):
                        return self
                time.sleep(0.05)
            with self._mu:
                unhealthy = [r.id for r in self._replicas if not r.healthy]
            # a failed start must not leak the tier it spawned: N
            # serve processes surviving a TimeoutError would starve the
            # host for whatever runs next
            self.stop(drain=False)
            raise TimeoutError(
                f"replicas {unhealthy} not healthy after {wait_s:.0f}s "
                f"(no heartbeat/announce under {self.rendezvous_dir})")
        return self

    def begin_drain(self) -> None:
        """Stop admitting; queued + in-flight traffic still resolves."""
        with self._mu:
            self._draining = True

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        if drain:
            self.begin_drain()
            deadline = time.monotonic() + timeout
            with self._mu:
                while self._outstanding > 0 and time.monotonic() < deadline:
                    self._mu.wait(timeout=0.1)
        with self._mu:
            self._stopping = True
            stranded = list(self._live.values())
            self._queue.clear()
            self._live.clear()
            for req in stranded:
                if not req.done:
                    req.done = True
                    req.handle._fail(RuntimeError("router stopped"))
            self._outstanding = 0
            self._mu.notify_all()
        with self._mu:
            fenced = self._fenced
            if not fenced:
                for r in self._replicas:
                    self._stop_unsignalable_locked(r)
        for r in self._replicas:
            self._close_conn(r)
            if r.proc is not None and r.proc.poll() is None:
                r.proc.terminate()   # SIGTERM: replicas drain + exit 0
            elif r.proc is None and not fenced:
                # adopted from a dead predecessor, this router owns the
                # tier now (a fenced one never touches it again)
                self._signal_adopted(r, signal.SIGTERM, timeout=10.0)
        for r in self._replicas:
            if r.proc is not None:
                try:
                    r.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    r.proc.kill()
                    r.proc.wait()
        if self._journal is not None:
            self._journal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=False)

    # -- client side ---------------------------------------------------
    @property
    def outstanding(self) -> int:
        with self._mu:
            return self._outstanding

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> RouterHandle:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        deadline_s = float(deadline_s if deadline_s is not None
                           else self.deadline_s)
        if deadline_s <= 0:
            raise ValueError(f"deadline must be positive, got {deadline_s}")
        # the request's distributed-trace id is minted HERE (or carried
        # in from an upstream caller) — before admission, so even a
        # shed is attributable to the request that suffered it
        trace_id = trace_id or trace.new_trace_id()
        digests = self._digest_chain(prompt)
        with self._mu:
            if self._stopping:
                raise RuntimeError("router is stopped")
            if self._fenced:
                # a successor holds the lease: this router must not
                # drive the tier (the replicas would reject it anyway)
                raise RuntimeError(
                    f"router fenced (epoch {self.epoch} superseded) — "
                    f"submit to the current leader")
            if self._draining or self._outstanding >= self.admission_limit:
                self._m_shed.inc()
                retry = max(0.05, self._ewma_latency
                            * (1 + self._outstanding
                               / max(1, self.admission_limit)))
                reason = ("draining" if self._draining else
                          f"admission limit {self.admission_limit}")
                log.error("router: shedding request (%s; %d outstanding; "
                          "retry_after=%.2fs)", reason, self._outstanding,
                          retry)
                trace.anomaly("router_shed", reason=reason,
                              outstanding=self._outstanding,
                              retry_after=retry, trace=trace_id)
                raise Backpressure(retry)
            self._ids += 1
            # the request's sampling identity is minted HERE, once —
            # every dispatch (attempt N, hedge twin, failover replay)
            # ships the same seed, so SAMPLED requests replay
            # token-exactly on any same-version replica
            req = _Request(self._ids, prompt, int(max_new_tokens),
                           float(temperature), eos_id, deadline_s, digests,
                           trace_id=trace_id,
                           rng_seed=int(self._rng.integers(0, 2**31 - 1)))
            self._queue.append(req)
            self._live[req.id] = req
            self._outstanding += 1
            self._m_queue_depth.set(len(self._queue))
            if self._journal is not None:
                # journal AFTER admission (a shed is not recovery
                # state) and BEFORE the handle is returned: once the
                # client owns a handle, a successor can always finish
                # the request
                self._journal.submit(
                    str(req.id), prompt=req.prompt,
                    max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, eos_id=req.eos_id,
                    rng_seed=req.rng_seed, trace=req.trace)
            trace.event("router_submit", request=req.id, trace=req.trace,
                        span_id=req.span, prompt_len=int(prompt.size),
                        deadline_s=deadline_s,
                        queue_depth=len(self._queue))
            self._mu.notify_all()
        return req.handle

    def generate(self, prompt, **kw) -> RouterResult:
        return self.submit(prompt, **kw).result(timeout=600)

    # -- takeover (serve/ha.py drives this) ----------------------------
    def adopt_requests(self, state: dict,
                       delivered: Optional[dict] = None) -> dict:
        """Adopt a dead predecessor's unresolved requests — the
        journal-replay half of a router takeover (``state`` is
        ``journal.unresolved(journal.replay(...))``).

        Each request is rebuilt BIT-IDENTICALLY from its journaled
        submit record (prompt, budget, eos, and above all the minted
        ``rng_seed`` — the sampling identity that makes any replay
        token-exact) and, when its last journaled dispatch points at a
        replica that is still up, RE-ATTACHED there: the ``reattach``
        op makes the replica replay its retained token tail through
        the ordinary verify+dedupe path, so the engine's uninterrupted
        decode is simply picked back up.  A nack (the replica died
        too, or never got it) falls through to ordinary budgeted
        failover re-dispatch.

        Exactly-once across the router death: ``delivered`` maps
        request id -> the token list the CLIENT acknowledges having
        received (the re-connecting client echoes it); those tokens
        are verified, never re-emitted.  Without it, the journal's
        delivery watermark seeds sentinel entries — a lower bound, so
        at most ``watermark cadence - 1`` trailing tokens re-emit to a
        client that can't say what it saw.

        Deadlines restart at takeover (the journal records budgets,
        not wall-clock promises).  Returns ``{"readopted",
        "redispatched", "handles": {id: RouterHandle}}`` — the handles
        are how re-connecting clients resume their streams."""
        readopted = redispatched = 0
        handles: Dict[int, RouterHandle] = {}
        with self._mu:
            self._m_takeover.inc()
            for rid_key in sorted(state, key=lambda k: int(k)):
                st = state[rid_key]
                rid = int(rid_key)
                if rid in self._live:
                    handles[rid] = self._live[rid].handle
                    continue   # idempotent: already adopted
                sub = st["submit"]
                prompt = np.asarray(sub["prompt"], np.int32)
                req = _Request(rid, prompt,
                               int(sub["max_new_tokens"]),
                               float(sub["temperature"]),
                               sub.get("eos_id"), self.deadline_s,
                               self._digest_chain(prompt),
                               trace_id=sub.get("trace"),
                               rng_seed=sub.get("rng_seed"))
                if sub.get("version"):
                    req.version = sub["version"]
                acked = None
                if delivered is not None:
                    acked = delivered.get(rid, delivered.get(str(rid)))
                if acked is not None:
                    req.delivered = [int(t) for t in acked]
                else:
                    req.delivered = [-1] * int(st.get("watermark", 0))
                # the id counter must clear every adopted id, or a new
                # submit would collide with a live adopted request
                self._ids = max(self._ids, rid)
                self._live[rid] = req
                self._outstanding += 1
                handles[rid] = req.handle
                rep = None
                last = st["dispatches"][-1] if st["dispatches"] else None
                if last is not None:
                    k = int(last["replica"])
                    if 0 <= k < len(self._replicas):
                        cand = self._replicas[k]
                        if cand.healthy and cand.wfile is not None:
                            rep = cand
                if rep is not None:
                    # reattach under the PREDECESSOR'S wire id — the
                    # replica's retained tail is keyed by it
                    req.attempt = int(last["attempt"])
                    wire_id = f"{rid}.{req.attempt}"
                    try:
                        send_msg(rep.wfile, rep.wlock,
                                 {"op": "reattach", "id": wire_id,
                                  "epoch": self.epoch})
                    except (OSError, ValueError):
                        rep = None
                    else:
                        req.active[wire_id] = rep.id
                        rep.inflight[wire_id] = req
                        req.last_dispatch = time.monotonic()
                        readopted += 1
                if rep is None:
                    redispatched += 1
                    self._m_redispatched.inc()
                    self._queue.append(req)
            self._m_queue_depth.set(len(self._queue))
            self._mu.notify_all()
        return {"readopted": readopted, "redispatched": redispatched,
                "handles": handles}

    # -- placement -----------------------------------------------------
    def _digest_chain(self, prompt: np.ndarray) -> List[str]:
        """Chained digests of the prompt's FULL pages — the same chain
        the replica-side PrefixRegistry keys on, so routing by it is
        routing to warm registry entries."""
        ps = self.page_size
        out: List[str] = []
        digest = ""
        for d in range(int(prompt.size) // ps):
            digest = _page_digest(
                digest, np.ascontiguousarray(prompt[d * ps:(d + 1) * ps],
                                             np.int32))
            out.append(digest)
        return out

    def _eligible_locked(self, req: _Request, now: float) -> List[_Replica]:
        return [r for r in self._replicas
                if not r.gave_up and r.healthy and r.conn is not None
                and not r.draining and not r.shadow_only
                and (req.version is None or r.version == req.version)
                and r.saturated_until <= now
                and r.id not in req.bp_replicas
                and len(r.inflight) < self.replica_inflight]

    def _place_locked(self, req: _Request,
                      now: float) -> Optional[_Replica]:
        eligible = self._eligible_locked(req, now)
        if not eligible:
            return None
        if self.placement == "random":
            return eligible[int(self._rng.integers(len(eligible)))]
        if self.placement == "affinity" and req.digests:
            # deepest registered digest wins: the replica whose
            # registry holds the longest chain of this prompt
            for digest in reversed(req.digests):
                owner = self._prefix_owner.get(digest)
                if owner is not None:
                    rep = self._replicas[owner]
                    if rep in eligible:
                        self._m_affinity_hit.inc()
                        return rep
            self._m_affinity_miss.inc()
            if self.prefill_replicas:
                # disaggregation: a COLD paged prompt is prefill work —
                # keep it in the prefill pool (the chain re-homes to
                # the decode pool once prefill completes).  Fallback
                # to the full eligible set when the pool is out:
                # availability beats pool purity.
                pool = [r for r in eligible if r.role != "decode"]
                if pool:
                    eligible = pool
        return min(eligible, key=lambda r: (len(r.inflight), r.id))

    # -- dispatcher ----------------------------------------------------
    def _dispatch_loop(self) -> None:
        while not self._stopping:
            with self._mu:
                self._mu.wait(timeout=0.02)
                if self._stopping:
                    return
                now = time.monotonic()
                self._check_deadlines_locked(now)
                for req in list(self._queue):
                    if req.done or req.next_try > now:
                        continue
                    rep = self._place_locked(req, now)
                    if rep is None:
                        self._maybe_shed_locked(req, now)
                        continue
                    self._queue.remove(req)
                    self._dispatch_locked(req, rep)
                if self.hedge_s > 0:
                    self._maybe_hedge_locked(now)
                self._m_queue_depth.set(len(self._queue))
                self._m_inflight.set(sum(len(r.inflight)
                                         for r in self._replicas))

    def _check_deadlines_locked(self, now: float) -> None:
        # canary shadows outlive nothing: one that hasn't completed
        # within its primary's deadline will never gate anything —
        # drop it so the gate's pending count drains
        for sh in [s for s in self._shadows.values()
                   if now - s.created > s.req.deadline_s]:
            self._drop_shadow_locked(sh, "shadow_timeout")
        # migrations that never acked: a wedged transfer must not pin
        # its bookkeeping (or block this chain's next migration) forever
        for xfer in [x for x, m in self._migrations.items()
                     if now - m["t0"] > self.migrate_timeout_s]:
            self._fail_migration_locked(
                xfer, self._migrations.pop(xfer), "timeout")
        for req in list(self._live.values()):
            if req.done or now <= req.deadline:
                continue
            self._m_deadline.inc()
            trace.anomaly("router_deadline", request=req.id,
                          trace=req.trace, deadline_s=req.deadline_s,
                          delivered=len(req.delivered),
                          redispatches=req.redispatches)
            self._resolve_locked(
                req, exc=DeadlineExceeded(
                    req.id, req.deadline_s,
                    detail=f"{len(req.delivered)} tokens delivered, "
                           f"{req.redispatches} re-dispatches"))

    def _maybe_shed_locked(self, req: _Request, now: float) -> None:
        """A queued request no replica can take right now: if every
        candidate is LIVE and has shed it (or is marked saturated),
        propagate Backpressure — waiting would be a retry storm, not a
        queue.  A candidate that is merely dead/partitioned keeps the
        request queued: recovery or the deadline resolves it."""
        alive = [r for r in self._replicas if not r.gave_up]
        # candidates = replicas that could EVER take this request:
        # version-compatible, not shadow-only.  A draining or
        # version-mismatched replica set is a TRANSIENT rollout state,
        # not saturation — the request stays queued (the rollout's
        # drain/rollback restores capacity; the deadline bounds it)
        candidates = [r for r in alive
                      if not r.shadow_only
                      and (req.version is None
                           or r.version == req.version)]
        if not alive:
            retry = max(0.5, self.respawn_backoff_s)
        elif candidates and all(
                r.healthy and not r.draining
                and (r.id in req.bp_replicas
                     or r.saturated_until > now)
                for r in candidates):
            retry = max(0.05, max(r.saturated_until for r in candidates)
                        - now) + self._ewma_latency
        else:
            return
        self._m_bp_relayed.inc()
        trace.anomaly("router_shed", reason="all_replicas_saturated",
                      request=req.id, trace=req.trace, retry_after=retry)
        self._resolve_locked(req, exc=Backpressure(retry))

    def _dispatch_locked(self, req: _Request, rep: _Replica) -> None:
        req.attempt += 1
        wire_id = f"{req.id}.{req.attempt}"
        req.active[wire_id] = rep.id
        rep.inflight[wire_id] = req
        req.last_dispatch = time.monotonic()
        if req.queue_wait is None:
            # queue wait = submit → FIRST dispatch attempt (a
            # failover's later attempts are service disruption, not
            # queueing).  Latched BEFORE the send: a dead replica at
            # first dispatch must not erase the sample — attempt 1
            # never comes again
            req.queue_wait = max(0.0, time.time() - req.submit_time)
            self._m_queue_wait.observe(req.queue_wait)
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        self._m_dispatch.inc()
        # span context + sampling identity ride the wire: the replica
        # tags its per-request records with the SAME trace id and
        # samples with the SAME rng_seed (attempt 2 after a failover
        # included — the replay keeps the request's identity, token
        # stream included)
        msg = {"op": "submit", "id": wire_id,
               "prompt": [int(t) for t in req.prompt],
               "max_new_tokens": req.max_new_tokens,
               "temperature": req.temperature, "eos_id": req.eos_id,
               "rng_seed": req.rng_seed,
               "trace": req.trace, "pspan": req.span,
               "epoch": self.epoch}
        try:
            send_msg(rep.wfile, rep.wlock, msg)
        except (OSError, ValueError, AttributeError):
            self._replica_down_locked(rep, "send_failed")
            return
        if self._journal is not None:
            # a successor reads the LAST dispatch to know which replica
            # may hold this request's retained token tail
            self._journal.dispatch(str(req.id), req.attempt, rep.id)
        # model-version affinity latches at the FIRST successful
        # dispatch: from here on this request only ever runs on
        # replicas serving the same model version (rollout invariant:
        # no client stream mixes checkpoints)
        if req.version is None:
            req.version = rep.version
        # every dispatch record carries the latched first-attempt wait,
        # so the trace keeps the queueing ground truth even when the
        # attempt-1 send itself failed (no attempt-1 record exists)
        trace.event("router_dispatch", request=req.id, trace=req.trace,
                    span_id=req.span, replica=rep.id,
                    attempt=req.attempt,
                    queue_wait_s=round(req.queue_wait, 6))
        # prefix ownership: this replica's registry will hold these
        # pages once the prefill completes — route siblings here
        for digest in req.digests:
            self._prefix_owner.pop(digest, None)   # re-insert at tail
            self._prefix_owner[digest] = rep.id
        while len(self._prefix_owner) > self._prefix_owner_cap:
            self._prefix_owner.pop(next(iter(self._prefix_owner)))
        # hot-chain heat for the heal-time prefetch: remember the
        # paged prompts traffic keeps landing on (and what to replay
        # into migrate_in to pull them)
        if req.digests:
            deepest = req.digests[-1]
            heat = self._chain_heat.pop(deepest, (0, None, None))[0]
            self._chain_heat[deepest] = (
                heat + 1, list(req.digests),
                [int(t) for t in req.prompt])
            while len(self._chain_heat) > self._chain_heat_cap:
                self._chain_heat.pop(next(iter(self._chain_heat)))
        # canary mirroring: a slice of greedy attempt-1 traffic ALSO
        # runs on the new-checkpoint canary, compare-only
        if (self._mirror is not None and req.attempt == 1
                and req.temperature == 0.0):
            self._maybe_mirror_locked(req)
        # chaos replica_kill@req:N — fire AFTER the dispatch so the
        # killed replica holds in-flight work (the case under test)
        target = chaos.replica_kill(seq, rep.id)
        if target is not None:
            self._kill_replica(target)
        # chaos router_kill@req:N — the ROUTER dies at the Nth
        # dispatch, mid-burst, journal un-synced past the fsync
        # cadence: the takeover case router_ha_smoke pins
        if chaos.router_kill(seq):
            self._crash()

    def _maybe_hedge_locked(self, now: float) -> None:
        for req in self._live.values():
            if (req.done or not req.active or len(req.active) != 1
                    or now - max(req.last_dispatch,
                                 req.last_progress) < self.hedge_s):
                continue
            current = next(iter(req.active.values()))
            eligible = [r for r in self._eligible_locked(req, now)
                        if r.id != current]
            if not eligible:
                continue
            rep = min(eligible, key=lambda r: (len(r.inflight), r.id))
            self._m_hedge.inc()
            trace.event("router_hedge", request=req.id, trace=req.trace,
                        slow_replica=current, hedge_replica=rep.id)
            self._dispatch_locked(req, rep)

    # -- canary mirroring (the rollout's token-exact gate arm) ----------
    def start_mirror(self, replica_id: int, fraction: float = 1.0) -> None:
        """Mirror ``fraction`` of greedy attempt-1 traffic to replica
        ``replica_id`` (the new-checkpoint canary) as compare-only
        shadows: the canary's tokens are verified token-by-token
        against the old model's answer and NEVER delivered to a
        client.  Greedy determinism makes any mismatch a model
        difference, not noise — the measurable, gateable quantity the
        rollout's canary gate rides on."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"mirror fraction must be in (0, 1], got "
                             f"{fraction}")
        with self._mu:
            self._refuse_if_stopped("start_mirror")
            self._mirror = (int(replica_id), float(fraction))
            self._mirror_acc = 0.0
            # per-session gauge: a previous rollout's first-divergence
            # position must not masquerade as this canary's
            self._m_first_div.set(-1)

    def stop_mirror(self) -> None:
        with self._mu:
            self._mirror = None
            self._drop_shadows_locked("mirror_stopped")

    def canary_stats(self) -> dict:
        """The canary gate's inputs: comparisons completed, divergences
        observed, and the first divergence position (-1 = none)."""
        with self._mu:
            return {
                "mirrored": self._m_mirrored.value,
                "compared": self._m_compared.value,
                "diverged": self._m_canary_div.value,
                "first_divergence_pos": self._m_first_div.value,
                "pending": len(self._shadows),
            }

    def _maybe_mirror_locked(self, req: _Request) -> None:
        rid, fraction = self._mirror
        rep = self._replicas[rid]
        if rep.wfile is None or not rep.healthy:
            return
        # deterministic fractional selection: an accumulator, not a
        # coin flip — "mirror 1 in k" means exactly that
        self._mirror_acc += fraction
        if self._mirror_acc < 1.0:
            return
        self._mirror_acc -= 1.0
        wire_id = f"s{req.id}"
        sh = _Shadow(req, wire_id, rid)
        try:
            send_msg(rep.wfile, rep.wlock,
                     {"op": "submit", "id": wire_id,
                      "prompt": [int(t) for t in req.prompt],
                      "max_new_tokens": req.max_new_tokens,
                      "temperature": req.temperature,
                      "eos_id": req.eos_id, "rng_seed": req.rng_seed,
                      "trace": req.trace, "pspan": req.span,
                      "epoch": self.epoch})
        except (OSError, ValueError):
            return
        self._shadows[wire_id] = sh
        self._shadow_by_req[req.id] = sh
        self._m_mirrored.inc()
        trace.event("canary_mirror", request=req.id, trace=req.trace,
                    replica=rid)

    def _on_shadow_msg_locked(self, sh: _Shadow, msg: dict) -> None:
        op = msg.get("op")
        if op == "done":
            sh.tokens = [int(t) for t in msg.get("tokens", [])]
            sh.shadow_done = True
            self._compare_shadow_locked(sh)
        elif op in ("backpressure", "error"):
            # the canary refused the shadow: not a comparison, not a
            # divergence — drop it (the gate counts COMPLETED compares)
            self._drop_shadow_locked(sh, f"shadow_{op}")
        # token msgs are ignored: the comparison runs on the final
        # answer (greedy: the prefix property makes them equivalent)

    def _compare_shadow_locked(self, sh: _Shadow) -> None:
        if sh.tokens is None or sh.primary is None:
            return   # the other half hasn't answered yet
        self._shadows.pop(sh.wire_id, None)
        self._shadow_by_req.pop(sh.req.id, None)
        self._m_compared.inc()
        first_div = -1
        if sh.tokens != sh.primary:
            n = min(len(sh.tokens), len(sh.primary))
            first_div = next(
                (i for i in range(n) if sh.tokens[i] != sh.primary[i]),
                n)
            self._m_canary_div.inc()
            if (self._m_first_div.value < 0
                    or first_div < self._m_first_div.value):
                self._m_first_div.set(first_div)
            trace.anomaly("canary_divergence", request=sh.req.id,
                          trace=sh.req.trace, first_divergence=first_div,
                          old=sh.primary[:8], new=sh.tokens[:8])
        trace.event("canary_compare", request=sh.req.id,
                    trace=sh.req.trace, diverged=first_div >= 0,
                    first_divergence=first_div)

    def _drop_shadow_locked(self, sh: _Shadow, reason: str) -> None:
        """Abandon one shadow: forget it AND tell the canary to stop
        decoding it — a dropped comparison must not keep burning the
        canary capacity the remaining comparisons are waiting on."""
        self._shadows.pop(sh.wire_id, None)
        self._shadow_by_req.pop(sh.req.id, None)
        if not sh.shadow_done:
            rep = self._replicas[sh.replica]
            if rep.wfile is not None:
                try:
                    send_msg(rep.wfile, rep.wlock,
                             {"op": "cancel", "id": sh.wire_id,
                              "epoch": self.epoch})
                    self._m_cancel.inc()
                except (OSError, ValueError):
                    pass
        trace.event("canary_drop", request=sh.req.id, trace=sh.req.trace,
                    reason=reason)

    def _drop_shadows_locked(self, reason: str) -> None:
        for sh in list(self._shadows.values()):
            self._drop_shadow_locked(sh, reason)

    def kill_replica(self, replica_id: int) -> None:
        """SIGKILL a replica (chaos drills, a kill-under-load
        scenario).  The death is then DETECTED like any other — probe/
        conn-EOF/proc-poll — so the full failover + respawn machinery
        runs; nothing is short-circuited."""
        self._refuse_if_stopped("kill_replica")
        self._kill_replica(int(replica_id))

    def _kill_replica(self, target: int) -> None:
        rep = self._replicas[target]
        if rep.proc is not None:
            rep.proc.kill()
        elif self._kill_hook is not None:
            self._kill_hook(target)
        elif not self._signal_adopted(rep, signal.SIGKILL):
            log.error("router: chaos wants replica %d killed but the "
                      "router neither owns its process nor has a "
                      "kill_hook", target)

    def _crash(self) -> None:
        """Die NOW, uncleanly — chaos router_kill.  No drain, no
        journal sync, no request resolution: the successor must
        recover from exactly what a SIGKILL leaves behind.  In-process
        tiers (tests) substitute ``crash_hook``, which must freeze
        this router the same way (close transports, stop loops,
        resolve nothing)."""
        if self._crash_hook is not None:
            self._crash_hook()
            return
        log.error("router: chaos router_kill — dying uncleanly")
        os._exit(chaos.EXIT_INJECTED_CRASH)

    # -- replica message handling --------------------------------------
    def _on_msg(self, rep: _Replica, msg: dict) -> None:
        op = msg.get("op")
        if op == "stale_epoch":
            # a replica refused one of our ops: a successor holds a
            # higher fencing epoch.  LATCH fenced — this router must
            # stop driving the tier entirely (shed new submits, stop
            # resolving), because anything it delivered from here on
            # could double what the real leader delivers.
            with self._mu:
                self._m_stale_epoch.inc()
                if not self._fenced:
                    self._fenced = True
                    log.error(
                        "router: FENCED — replica %d rejected epoch %d "
                        "(current %s); a successor has taken over",
                        rep.id, self.epoch, msg.get("current"))
                    trace.anomaly("router_fenced", epoch=self.epoch,
                                  current=msg.get("current"),
                                  replica=rep.id)
                req = rep.inflight.pop(msg.get("id"), None)
                if req is not None and not req.done:
                    req.active.pop(msg.get("id"), None)
                    self._resolve_locked(req, exc=RuntimeError(
                        f"request {req.id} fenced: router epoch "
                        f"{self.epoch} superseded by "
                        f"{msg.get('current')} — the new leader "
                        f"re-adopted it"))
            return
        if op == "stats":
            tag = msg.get("tag", "")
            with self._mu:
                ev = self._stats_events.pop((rep.id, tag), None)
                if ev is not None:
                    # only a live waiter stores the snapshot (and pops
                    # it on read): an operator polling stats every few
                    # seconds must not grow this dict for the router's
                    # lifetime
                    rep.last_stats[tag] = msg
                    ev.set()
            return
        if op == "migrated":
            with self._mu:
                self._finish_migration_locked(
                    str(msg.get("xfer", "")), rep,
                    ok=bool(msg.get("ok")),
                    pages=int(msg.get("pages", 0)),
                    error=msg.get("error"))
            return
        with self._mu:
            wire_id = msg.get("id")
            sh = self._shadows.get(wire_id)
            if sh is not None and rep.id == sh.replica:
                # canary shadow traffic: compared, never delivered
                self._on_shadow_msg_locked(sh, msg)
                return
            req = rep.inflight.get(wire_id)
            if req is None or req.done:
                self._m_stale.inc()
                return
            if op == "reattached":
                # the replica still held this request's retained tail:
                # re-adoption confirmed.  The tail itself arrives as
                # ordinary token/done msgs (replayed from i=0) and runs
                # the SAME verify+dedupe as a failover replay — nothing
                # else to do here but say so.
                self._m_readopted.inc()
                trace.event("router_readopt", request=req.id,
                            trace=req.trace, replica=rep.id,
                            retained=int(msg.get("n", 0)),
                            engine_done=bool(msg.get("done")))
                return
            if op == "reattach_nack":
                # the request died WITH the replica during the outage
                # (respawn, or the tail was pruned): fall through to
                # ordinary budgeted failover — the journaled rng_seed
                # makes the re-dispatch token-exact anyway
                rep.inflight.pop(wire_id, None)
                req.active.pop(wire_id, None)
                self._m_redispatched.inc()
                self._requeue_locked(req, reason="reattach_nack")
                return
            if op == "token":
                i = int(msg["i"])
                tok = int(msg["token"])
                if i < len(req.delivered):
                    # re-dispatched attempt replaying delivered ground:
                    # verify, don't re-emit (greedy decode makes this an
                    # equality by construction).  A -1 is a takeover
                    # WATERMARK SENTINEL — the journal said the dead
                    # router delivered this index but not its value:
                    # fill it in, still don't re-emit.
                    if req.delivered[i] == -1:
                        req.delivered[i] = tok
                    elif req.delivered[i] != tok and not req.diverged:
                        req.diverged = True
                        self._m_diverged.inc()
                        trace.anomaly("redispatch_divergence",
                                      request=req.id, trace=req.trace,
                                      index=i,
                                      expected=req.delivered[i], got=tok)
                elif i == len(req.delivered):
                    if not req.delivered:
                        # once per request across failovers (a replay's
                        # token 0 lands in the verify branch above):
                        # the stream-delivery milestone of the timeline
                        trace.event("router_first_token", request=req.id,
                                    trace=req.trace, replica=rep.id)
                        if self._journal is not None:
                            self._journal.first_token(str(req.id))
                    req.delivered.append(tok)
                    req.last_progress = time.monotonic()
                    req.handle._emit(tok)
                    if (self._journal is not None
                            and len(req.delivered) % 16 == 0):
                        # bounded-cadence watermark: a successor seeds
                        # its dedupe index at >= this, so re-adoption
                        # VERIFIES the delivered prefix instead of
                        # re-emitting it.  Every 16 tokens, not every
                        # token — the journal stays O(1)-ish per
                        # request, and the watermark only has to be a
                        # LOWER bound (the sentinel fill covers the gap)
                        self._journal.watermark(str(req.id),
                                                len(req.delivered))
                else:
                    self._m_stale.inc()
            elif op == "done":
                rep.inflight.pop(wire_id, None)
                req.active.pop(wire_id, None)
                if msg.get("cancelled"):
                    # the replica cancelled it (unclean shutdown path):
                    # that is a failover, not an answer
                    self._requeue_locked(req, reason="cancelled")
                    return
                tokens = [int(t) for t in msg["tokens"]]
                for i in range(len(req.delivered), len(tokens)):
                    req.handle._emit(tokens[i])
                # -1s are takeover watermark sentinels (value unknown,
                # delivery known) — they verify against anything
                if ((len(req.delivered) > len(tokens)
                     or any(d != -1 and d != t
                            for d, t in zip(req.delivered, tokens)))
                        and not req.diverged):
                    req.diverged = True
                    self._m_diverged.inc()
                    trace.anomaly("redispatch_divergence", request=req.id,
                                  trace=req.trace)
                if req.version is not None and rep.version != req.version:
                    # must be unreachable: version-affine placement
                    # forbids it.  Counted + flagged so a regression
                    # is an alarm, not a silent mixed-model answer
                    self._m_mixed.inc()
                    trace.anomaly("mixed_model", request=req.id,
                                  trace=req.trace,
                                  latched=req.version,
                                  served=rep.version)
                # the canary comparison's old-model half, if this
                # request was mirrored
                csh = self._shadow_by_req.get(req.id)
                if csh is not None:
                    csh.primary = tokens
                    self._compare_shadow_locked(csh)
                # disaggregation: a prefill-pool replica finished a
                # paged prompt — re-home its KV chain to the decode
                # pool so sibling traffic decodes there prefill-free
                if (self.prefill_replicas and rep.role == "prefill"
                        and req.digests):
                    self._maybe_migrate_locked(req, rep)
                rep.completed += 1
                finish = time.time()
                latency = finish - req.submit_time
                self._ewma_latency = (0.8 * self._ewma_latency
                                      + 0.2 * latency)
                self._m_completed.inc()
                self._m_latency.observe(latency)
                trace.event("router_complete", request=req.id,
                            trace=req.trace, span_id=req.span,
                            replica=rep.id, tokens=len(tokens),
                            redispatches=req.redispatches,
                            latency_s=latency)
                self._resolve_locked(req, result=RouterResult(
                    request_id=req.id, tokens=tokens,
                    prompt_len=int(req.prompt.size), latency_s=latency,
                    replica=rep.id, redispatches=req.redispatches,
                    diverged=req.diverged, submit_time=req.submit_time,
                    finish_time=finish, trace_id=req.trace,
                    version=req.version or rep.version))
            elif op == "backpressure":
                rep.inflight.pop(wire_id, None)
                req.active.pop(wire_id, None)
                retry = float(msg.get("retry_after", 0.5))
                rep.saturated_until = time.monotonic() + retry
                req.bp_replicas.add(rep.id)
                self._requeue_locked(req, reason="backpressure",
                                     backoff=False)
            elif op == "error":
                rep.inflight.pop(wire_id, None)
                self._resolve_locked(
                    req, exc=RuntimeError(
                        f"replica {rep.id} rejected request {req.id}: "
                        f"{msg.get('error')}"))

    def _requeue_locked(self, req: _Request, reason: str,
                        backoff: bool = True) -> None:
        if req.done or req.active:
            return   # a hedged twin is still running it
        if backoff:
            req.redispatches += 1
            self._m_failover.inc()
            req.next_try = time.monotonic() + min(
                self.retry_backoff_s * (2.0 ** (req.redispatches - 1)),
                self.max_retry_backoff_s)
        else:
            req.next_try = 0.0
        # the failover leg of the request timeline: same trace id, next
        # dispatch will carry attempt N+1
        trace.event("router_requeue", request=req.id, trace=req.trace,
                    reason=reason, redispatches=req.redispatches,
                    delivered=len(req.delivered))
        if req not in self._queue:
            self._queue.append(req)
        self._mu.notify_all()

    # -- chain migration (disaggregation's re-home path) ----------------
    def _maybe_migrate_locked(self, req: _Request,
                              source: _Replica) -> None:
        """Command a decode replica to PULL ``req``'s KV-page chain
        from ``source`` (a prefill-pool replica that just completed
        it).  Skips quietly when the chain is already decode-homed,
        already in flight, or no decode replica can take it — the
        colocated fallback is always correct, just warmer-pool-less."""
        deepest = req.digests[-1]
        owner = self._prefix_owner.get(deepest)
        if (owner is not None
                and self._replicas[owner].role == "decode"):
            return
        if any(m["digests"] and m["digests"][-1] == deepest
               for m in self._migrations.values()):
            return   # this chain is already migrating
        targets = [r for r in self._replicas
                   if r.role == "decode" and r.healthy
                   and not r.gave_up and not r.draining
                   and not r.shadow_only and r.wfile is not None
                   and (req.version is None or r.version == req.version)]
        if not targets:
            return
        target = min(targets, key=lambda r: (len(r.inflight), r.id))
        xfer = f"m{req.id}.{source.id}.{target.id}"
        try:
            send_msg(target.wfile, target.wlock,
                     {"op": "migrate_in", "xfer": xfer,
                      "host": source.host, "port": source.port,
                      "prompt": [int(t) for t in req.prompt],
                      "epoch": self.epoch})
        except (OSError, ValueError):
            return
        self._migrations[xfer] = {
            "digests": list(req.digests), "source": source.id,
            "target": target.id, "t0": time.monotonic(),
            "trace": req.trace}
        trace.event("chain_migrate", request=req.id, trace=req.trace,
                    xfer=xfer, source=source.id, target=target.id,
                    pages=len(req.digests))

    def _finish_migration_locked(self, xfer: str, rep: _Replica,
                                 ok: bool, pages: int,
                                 error=None) -> None:
        mig = self._migrations.pop(xfer, None)
        if mig is None or rep.id != mig["target"]:
            self._m_stale.inc()
            return
        if ok:
            # re-home the owner map: sibling traffic now finds its
            # warm chain in the decode pool (insertion at tail keeps
            # the bounded map's LRU-ish eviction honest)
            for d in mig["digests"]:
                self._prefix_owner.pop(d, None)
                self._prefix_owner[d] = rep.id
            self._m_migrations.inc()
            if mig.get("prefetch"):
                # heal-time prefetch: these pages were pulled to warm
                # a healed/respawned replica instead of re-prefilling
                self._m_prefetch.inc(pages)
            trace.event("chain_migrated", xfer=xfer, trace=mig["trace"],
                        source=mig["source"], target=rep.id,
                        pages=pages)
        else:
            self._fail_migration_locked(xfer, mig,
                                        str(error or "unknown"))

    def _fail_migration_locked(self, xfer: str, mig: dict,
                               error: str) -> None:
        """A migration that didn't make it: counted + flagged, owner
        map untouched (the chain is still warm at the source) — an
        efficiency loss, never a correctness event."""
        self._m_mig_failed.inc()
        trace.anomaly("migration_failed", xfer=xfer, trace=mig["trace"],
                      source=mig["source"], target=mig["target"],
                      error=error)

    def migration_stats(self) -> dict:
        """The disaggregated tier's gate inputs."""
        with self._mu:
            return {"migrated": self._m_migrations.value,
                    "failed": self._m_mig_failed.value,
                    "pending": len(self._migrations)}

    def _resolve_locked(self, req: _Request, result=None,
                        exc=None) -> None:
        if req.done:
            return
        req.done = True
        if self._journal is not None:
            # terminal either way — a failed request needs nothing
            # from a successor any more than a completed one does
            self._journal.complete(str(req.id), ok=exc is None)
        self._live.pop(req.id, None)
        if req in self._queue:
            self._queue.remove(req)
        for wid, rid in list(req.active.items()):
            rep = self._replicas[rid]
            rep.inflight.pop(wid, None)
            # CANCEL the attempts nobody is waiting on anymore (a
            # deadline-exceeded request, a losing hedge twin): the
            # replica frees the slot + pages at its next engine
            # iteration instead of decoding the full budget into the
            # stale-discard bin — exactly the capacity an overloaded
            # or mid-rollout tier is short of.  Best-effort: a dead
            # replica's conn is gone, and that's fine (so is it).
            if rep.wfile is not None:
                try:
                    send_msg(rep.wfile, rep.wlock,
                             {"op": "cancel", "id": wid,
                              "epoch": self.epoch})
                    self._m_cancel.inc()
                except (OSError, ValueError):
                    pass
        req.active.clear()
        if exc is not None:
            # a request that resolved in failure has no old-model
            # answer to compare — drop (and cancel) its shadow too
            csh = self._shadow_by_req.get(req.id)
            if csh is not None:
                self._drop_shadow_locked(csh, "primary_failed")
        self._outstanding -= 1
        if exc is not None:
            req.handle._fail(exc)
        else:
            req.handle._deliver(result)
        self._mu.notify_all()

    # -- health / failover / respawn -----------------------------------
    def _connect_locked(self, rep: _Replica) -> bool:
        ann = read_announce(self.rendezvous_dir, rep.id)
        if ann is None:
            return False
        if rep.proc is not None and rep.proc.poll() is None \
                and ann.get("pid") != rep.proc.pid:
            return False   # stale announce from the previous generation
        try:
            # the announce carries the replica's own host:port — a
            # replica on ANOTHER HOST (shared rendezvous storage,
            # --serve_host a routable address) registers identically
            # to a local one; "host" missing = a pre-fabric announce,
            # loopback by construction
            conn = socket.create_connection(
                (str(ann.get("host", "127.0.0.1")), int(ann["port"])),
                timeout=2.0)
            if conn.getsockname() == conn.getpeername():
                # TCP self-connect: dialing a DEAD replica's ephemeral
                # port can succeed via simultaneous open when the
                # kernel picks the same source port — the router would
                # be talking to itself and reading its own submits
                # back.  A real replica's accept socket can never have
                # sockname == peername.
                conn.close()
                return False
            # the connect timeout must NOT linger as the socket's i/o
            # timeout: an idle tier has no wire traffic, and a reader
            # whose blocking read times out after 2 quiet seconds reads
            # as a dead connection — a reconnect flap every idle gap
            conn.settimeout(None)
            # …but SENDS must stay bounded: dispatch writes under the
            # router lock, and a wedged-but-alive replica that stops
            # draining its socket would otherwise block sendall()
            # forever with _mu held — freezing admission, deadlines,
            # and the prober (the component built to survive wedged
            # replicas wedged by one).  SO_SNDTIMEO bounds send only;
            # the reader's blocking recv is untouched.
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", 5, 0))
        except OSError:
            return False
        self._close_conn(rep)
        rep.conn = conn
        rep.wfile = conn.makefile("wb")
        rep.host = str(ann.get("host", "127.0.0.1"))
        rep.port = int(ann["port"])
        rep.announced_pid = ann.get("pid")
        rep.announced_checkpoint = ann.get("checkpoint")
        if rep.proc is None:
            # an adopted replica: its next generation follows the one
            # it announces, not this router's count from zero
            rep.generation = max(rep.generation,
                                 int(ann.get("generation", 0) or 0))
        # reader threads are daemons that exit with their connection —
        # NOT retained (a long-lived router reconnects on every heal/
        # respawn, and a list of dead Thread objects is a slow leak)
        threading.Thread(target=self._reader, args=(rep, conn),
                         daemon=True, name=f"router-read{rep.id}").start()
        return True

    def _close_conn(self, rep: _Replica) -> None:
        conn, rep.conn, rep.wfile = rep.conn, None, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _reader(self, rep: _Replica, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        try:
            for line in rfile:
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                self._on_msg(rep, msg)
        except (OSError, ValueError):
            pass
        finally:
            with self._mu:
                if not self._stopping and rep.conn is conn:
                    self._replica_down_locked(rep, "conn_lost")

    def _replica_down_locked(self, rep: _Replica, reason: str) -> None:
        """The router's verdict that a replica is gone (heartbeat
        silence, dead socket, process exit).  Close the transport,
        re-dispatch everything it held, and say so — loudly when it
        was healthy a moment ago."""
        was_healthy = rep.healthy
        rep.healthy = False
        self._m_health[rep.id].set(0)
        self._close_conn(rep)
        stranded = list(rep.inflight.values())
        rep.inflight.clear()
        for req in stranded:
            for wid in [w for w, rid in req.active.items()
                        if rid == rep.id]:
                req.active.pop(wid, None)
            self._requeue_locked(req, reason=reason)
        # shadows running on a lost canary can never complete —
        # drop them (the gate counts completed comparisons only)
        for sh in [s for s in self._shadows.values()
                   if s.replica == rep.id]:
            self._drop_shadow_locked(sh, reason)
        # migrations with a dead endpoint can never complete either
        for xfer in [x for x, m in self._migrations.items()
                     if rep.id in (m["source"], m["target"])]:
            self._fail_migration_locked(
                xfer, self._migrations.pop(xfer), f"replica_lost:{reason}")
        # prefix owner-map HANDOFF: this replica's chained-digest
        # entries re-home to the warmest sibling instead of going
        # affinity-cold — the group re-prefills ONCE there and stays
        # warm, instead of scattering across the tier
        self._rehome_owners_locked(rep.id)
        if was_healthy:
            log.error("router: replica %d lost (%s) — %d in-flight "
                      "request(s) re-dispatched", rep.id, reason,
                      len(stranded))
            # the stranded requests' trace ids make the loss part of
            # each request's timeline, not just the replica's
            trace.anomaly("replica_lost", replica=rep.id, reason=reason,
                          redispatched=len(stranded),
                          traces=[r.trace for r in stranded])

    def _rehome_owners_locked(self, from_id: int) -> None:
        """Re-home ``from_id``'s prefix-owner entries to the WARMEST
        eligible sibling — the one already owning the most digests
        (registry-warmth proxy), ties to the least loaded.  With no
        eligible sibling the entries drop (stale owners only cost a
        least-loaded fallback, but a wrong owner would pin traffic to
        a cold replica forever)."""
        owned = [d for d, o in self._prefix_owner.items()
                 if o == from_id]
        if not owned:
            return
        cands = [r for r in self._replicas
                 if r.id != from_id and r.healthy and not r.gave_up
                 and not r.draining and not r.shadow_only]
        if not cands:
            for d in owned:
                self._prefix_owner.pop(d, None)
            return
        counts = collections.Counter(self._prefix_owner.values())
        target = max(cands, key=lambda r: (counts.get(r.id, 0),
                                           -len(r.inflight), -r.id))
        for d in owned:
            self._prefix_owner[d] = target.id
        self._m_rehomed.inc(len(owned))
        trace.event("prefix_rehome", from_replica=from_id,
                    to_replica=target.id, digests=len(owned))

    def _probe_loop(self) -> None:
        while not self._stopping:
            time.sleep(self.probe_interval_s)
            if self._stopping:
                return
            now = time.monotonic()
            with self._mu:
                traffic = self._dispatch_seq > 0
                for rep in self._replicas:
                    if rep.gave_up:
                        continue
                    self._probe_one_locked(rep, now, traffic)

    def _probe_one_locked(self, rep: _Replica, now: float,
                          traffic: bool) -> None:
        # process supervision (proc mode): exits schedule a respawn
        # under the sliding-window budget.  hold_respawn parks this
        # machinery while the rollout controller owns the process —
        # a PLANNED drain-restart must not eat the crash budget (and
        # a crash-looping NEW checkpoint must not burn it either; the
        # controller detects that failure and rolls back)
        if (rep.proc is not None and rep.proc.poll() is not None
                and rep.respawn_at is None and not rep.hold_respawn):
            code = rep.proc.returncode
            self._replica_down_locked(rep, f"exit:{code}")
            while (rep.respawn_times and now - rep.respawn_times[0]
                    > self.respawn_window_s):
                rep.respawn_times.popleft()
            if len(rep.respawn_times) >= self.max_respawns:
                rep.gave_up = True
                log.error("router: replica %d gave up (%d respawns in "
                          "window)", rep.id, len(rep.respawn_times))
                trace.anomaly("replica_give_up", replica=rep.id,
                              respawns=len(rep.respawn_times),
                              window_s=self.respawn_window_s)
                return
            rep.respawn_times.append(now)
            backoff = (self.respawn_backoff_s
                       * (2.0 ** (len(rep.respawn_times) - 1)))
            rep.respawn_at = now + backoff
            trace.event("replica_respawn", replica=rep.id, code=code,
                        backoff_s=backoff,
                        respawns=len(rep.respawn_times),
                        budget=self.max_respawns)
        if (rep.respawn_at is not None and now >= rep.respawn_at
                and not rep.hold_respawn):
            rep.respawn_at = None
            rep.generation += 1
            self._m_respawns.inc()
            rep.proc = self._spawn(rep.id, rep.generation)
            rep.last_beat_mono = now   # fresh startup grace
            log.warning("router: respawned replica %d (generation %d)",
                        rep.id, rep.generation)

        # chaos net_partition: drop this probe — the router sees
        # SILENCE, exactly what a partition or stalled host looks like
        partitioned = chaos.net_partition(rep.id, traffic)
        if not partitioned:
            try:
                mt = os.stat(heartbeat_path(self.rendezvous_dir,
                                            rep.id)).st_mtime
            except OSError:
                mt = rep.hb_mtime
            if mt != rep.hb_mtime:
                rep.hb_mtime = mt
                hb = read_heartbeat(heartbeat_path(self.rendezvous_dir,
                                                   rep.id))
                if hb is not None and hb.get("ts") != rep.last_beat_ts:
                    rep.last_beat_ts = hb.get("ts")
                    rep.last_beat_mono = now

        fresh = (now - rep.last_beat_mono) <= self.health_timeout_s
        if rep.healthy:
            if partitioned or not fresh:
                self._replica_down_locked(
                    rep, "net_partition_or_stall" if partitioned
                    else "heartbeat_timeout")
        elif fresh and not partitioned and not rep.reconnect_block:
            # beats are fresh again: (re)connect and fold it back in
            if rep.conn is None and not self._connect_locked(rep):
                return
            rep.healthy = True
            self._m_health[rep.id].set(1)
            trace.event("replica_registered", replica=rep.id,
                        port=rep.port, pid=rep.announced_pid)
            log.info("router: replica %d registered (port %s, pid %s)",
                     rep.id, rep.port, rep.announced_pid)
            self._maybe_prefetch_locked(rep)
            self._mu.notify_all()

    def _maybe_prefetch_locked(self, rep: _Replica) -> None:
        """Warm a just-healed/respawned replica: pull the HOTTEST
        tracked prompt chain from its current owner over the existing
        ``migrate_in`` wire pull, so the first affinity-miss burst the
        prober routes here decodes against warm pages instead of
        re-prefilling the system prompt.  Pure efficiency — every
        skip condition just means the next miss re-prefills, exactly
        the pre-prefetch behavior.  A held replica (draining: a
        rollout's replacement or canary, which the controller may stop
        at any moment) is not warmed: a pull into it can fail with no
        replica lost."""
        if self.prefill_replicas and rep.role != "decode":
            return   # the prefill pool re-prefills by design
        if rep.draining or rep.shadow_only:
            return
        for deepest, (heat, digests, prompt) in sorted(
                self._chain_heat.items(), key=lambda kv: -kv[1][0]):
            owner = self._prefix_owner.get(deepest)
            if owner is None or owner == rep.id:
                continue
            src = self._replicas[owner]
            if (not src.healthy or src.port is None
                    or src.version != rep.version):
                continue
            if any(m["digests"] and m["digests"][-1] == deepest
                   for m in self._migrations.values()):
                continue
            xfer = f"p{rep.id}.{rep.generation}.{deepest[:8]}"
            try:
                send_msg(rep.wfile, rep.wlock,
                         {"op": "migrate_in", "xfer": xfer,
                          "host": src.host, "port": src.port,
                          "prompt": list(prompt),
                          "epoch": self.epoch})
            except (OSError, ValueError):
                return
            self._migrations[xfer] = {
                "digests": list(digests), "source": src.id,
                "target": rep.id, "t0": time.monotonic(),
                "trace": trace.new_trace_id(), "prefetch": True}
            trace.event("chain_migrate", trace=self._migrations[
                            xfer]["trace"], xfer=xfer, source=src.id,
                        target=rep.id, pages=len(digests),
                        prefetch=True, heat=heat)
            return   # one chain per heal: warmth, not a transfer storm

    # -- rollout control surface (serve/rollout.py drives these) --------
    @property
    def stopped(self) -> bool:
        """True once the router stopped, or died: a crash hook's freeze
        sets the same latch.  A rollout controller driving this router
        stops with it and leaves the persisted state to a successor."""
        return self._stopping

    def _refuse_if_stopped(self, what: str) -> None:
        if self._stopping:
            raise RuntimeError(f"router is stopped: {what} refused")

    def _stop_unsignalable_locked(self, rep: _Replica) -> None:
        """An ADOPTED replica this router owns (it can spawn the
        successor) but cannot signal -- its announce names another
        host, so its pid means nothing here -- gets the port's
        epoch-fenced ``{"op": "stop"}`` on its connection: it drains and
        exits, as SIGTERM makes it.  The JAX router only disconnects
        such a replica, which then serves on beside its successor."""
        if (self._spawn is None or rep.proc is not None
                or rep.host in _LOCAL_HOSTS or rep.wfile is None):
            return
        try:
            send_msg(rep.wfile, rep.wlock, {"op": "stop",
                                            "epoch": self.epoch})
        except (OSError, ValueError):
            return
        log.warning("router: stop sent to adopted replica %d on %s "
                    "(epoch %d)", rep.id, rep.host, self.epoch)
        trace.event("replica_stop_sent", replica=rep.id, host=rep.host,
                    epoch=self.epoch)

    def _signal_adopted(self, rep: _Replica, sig: int,
                        timeout: float = 0.0) -> bool:
        """Signal a replica this router ADOPTED (a predecessor spawned
        it: no process handle here) by the pid its announce names, when
        this router can spawn its successor, the replica runs on this
        host and the announce still names that pid (a later generation
        rewrites it: a stale pid is never signalled); wait up to
        ``timeout`` for it to stop, then SIGKILL.  False when it cannot
        be reached that way."""
        pid = rep.announced_pid
        if (self._spawn is None or not pid or int(pid) == os.getpid()
                or rep.host not in _LOCAL_HOSTS
                or (read_announce(self.rendezvous_dir, rep.id)
                    or {}).get("pid") != pid):
            return False
        try:
            os.kill(int(pid), sig)
        except OSError:
            return True     # already gone
        deadline = time.monotonic() + timeout
        while timeout > 0:
            try:
                os.kill(int(pid), 0)
            except OSError:
                break       # exited (and reaped by its parent)
            if time.monotonic() > deadline:
                try:
                    os.kill(int(pid), signal.SIGKILL)
                except OSError:
                    pass
                break
            time.sleep(0.05)
        return True

    def set_replica_version(self, replica_id: int, version: str) -> None:
        """Label the model version replica ``replica_id`` serves.
        Version-affine placement matches requests to it (all replicas
        at the same label → no constraint, the steady state)."""
        with self._mu:
            self._replicas[replica_id].version = str(version)

    def replica_version(self, replica_id: int) -> str:
        with self._mu:
            return self._replicas[replica_id].version

    def relabel_version(self, old_label: str, new_label: str) -> None:
        """Rename a model-version label fleet-wide: replicas AND the
        live requests latched to it move together (a rollout baselines
        the unlabeled incumbent fleet this way — in-flight requests
        latched to the old label must not read as mixed-model when
        their replica is relabeled under them)."""
        with self._mu:
            for rep in self._replicas:
                if rep.version == old_label:
                    rep.version = str(new_label)
            for req in self._live.values():
                if req.version == old_label:
                    req.version = str(new_label)

    def set_shadow(self, replica_id: int, shadow: bool) -> None:
        """Shadow-only: the replica takes NO client placements, only
        mirrored canary traffic — a new-checkpoint canary must never
        answer a real client until the gate passes."""
        with self._mu:
            self._refuse_if_stopped("set_shadow")
            self._replicas[replica_id].shadow_only = bool(shadow)

    def hold_replica(self, replica_id: int) -> None:
        """Take operational ownership of one replica for a planned
        replacement: placement stops (draining), the prober's
        auto-respawn parks (hold_respawn), and its prefix-owner
        entries re-home to the warmest sibling."""
        with self._mu:
            self._refuse_if_stopped("hold_replica")
            rep = self._replicas[replica_id]
            rep.draining = True
            rep.hold_respawn = True
            self._rehome_owners_locked(replica_id)
            self._mu.notify_all()

    def release_replica(self, replica_id: int,
                        shadow: bool = False) -> None:
        """Return a held replica to service (``shadow=True`` = canary
        posture: healthy and heartbeating but shadow-only)."""
        with self._mu:
            self._refuse_if_stopped("release_replica")
            rep = self._replicas[replica_id]
            rep.draining = False
            rep.hold_respawn = False
            rep.shadow_only = bool(shadow)
            self._mu.notify_all()

    def drain_replica(self, replica_id: int,
                      timeout: float = 120.0) -> bool:
        """Drain one replica: no new placements (the caller held it),
        the replica engine sheds its own direct admissions, in-flight
        work finishes.  True when its in-flight map emptied inside
        ``timeout``."""
        rep = self._replicas[replica_id]
        with self._mu:
            if rep.wfile is not None:
                try:
                    send_msg(rep.wfile, rep.wlock,
                             {"op": "drain", "epoch": self.epoch})
                except (OSError, ValueError):
                    pass
            trace.event("replica_drain", replica=replica_id,
                        inflight=len(rep.inflight))
            deadline = time.monotonic() + timeout
            while (rep.inflight and not self._stopping
                   and time.monotonic() < deadline):
                self._mu.wait(timeout=0.05)
            return not rep.inflight

    def terminate_replica(self, replica_id: int,
                          timeout: float = 30.0) -> None:
        """Stop a held replica's process for a planned replacement:
        mark it down QUIETLY (no replica_lost anomaly — a drained
        planned exit is not a casualty), SIGTERM, reap.  Proc-less
        tiers (tests) just close the transport."""
        rep = self._replicas[replica_id]
        with self._mu:
            self._refuse_if_stopped("terminate_replica")
            rep.healthy = False
            # park the prober's reconnect too: between this terminate
            # and the successor's announce, the OLD endpoint (or its
            # stale-but-fresh heartbeat) must not be folded back in.
            # spawn_replica / allow_reconnect lifts it.
            rep.reconnect_block = True
            self._m_health[rep.id].set(0)
            self._stop_unsignalable_locked(rep)
            self._close_conn(rep)
            # anything still in flight (drain timed out) fails over
            stranded = list(rep.inflight.values())
            rep.inflight.clear()
            for req in stranded:
                for wid in [w for w, rid in req.active.items()
                            if rid == rep.id]:
                    req.active.pop(wid, None)
                self._requeue_locked(req, reason="planned_restart")
        if rep.proc is not None:
            if rep.proc.poll() is None:
                rep.proc.terminate()
                try:
                    rep.proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    rep.proc.kill()
                    rep.proc.wait()
        else:
            self._signal_adopted(rep, signal.SIGTERM, timeout)

    def spawn_replica(self, replica_id: int) -> None:
        """Spawn a held replica's next generation (proc mode).  The
        spawner consults ``replica_checkpoints[replica_id]`` — set it
        first to point the new process at a different checkpoint.
        Counted as a REPLACEMENT, not a respawn: planned restarts
        must not look like crashes on any dashboard."""
        if self._spawn is None:
            raise RuntimeError(
                "router does not own replica processes (no spawner) — "
                "pass restart_hook to the rollout controller instead")
        from dtf_tpu_torch.serve.replica import announce_path
        rep = self._replicas[replica_id]
        with self._mu:
            self._refuse_if_stopped("spawn_replica")
            for path in (heartbeat_path(self.rendezvous_dir, rep.id),
                         announce_path(self.rendezvous_dir, rep.id)):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            rep.generation += 1
            rep.respawn_at = None
            rep.hb_mtime = None
            rep.last_beat_ts = None
            rep.last_beat_mono = time.monotonic()   # startup grace
            rep.saturated_until = 0.0
            rep.reconnect_block = False
            gen = rep.generation
        self._m_replaced.inc()
        rep.proc = self._spawn(rep.id, gen)
        trace.event("replica_replaced", replica=rep.id, generation=gen,
                    checkpoint=self.replica_checkpoints.get(rep.id, ""))

    def allow_reconnect(self, replica_id: int) -> None:
        """Lift the terminate-window reconnect block (proc-less tiers:
        the restart_hook's successor replica has announced)."""
        with self._mu:
            rep = self._replicas[replica_id]
            rep.reconnect_block = False
            rep.last_beat_mono = time.monotonic()   # startup grace

    def replica_exit_code(self, replica_id: int) -> Optional[int]:
        """The replica process's exit code, or None while it runs (and
        in proc-less tiers) — the rollout controller's fast-fail
        signal for a new checkpoint that cannot even start."""
        proc = self._replicas[replica_id].proc
        return None if proc is None else proc.poll()

    def replica_announced_checkpoint(self,
                                     replica_id: int) -> Optional[str]:
        """The checkpoint replica ``replica_id``'s announce says it
        serves ("" = the flag-configured one; None = not said)."""
        with self._mu:
            return self._replicas[replica_id].announced_checkpoint

    def replica_draining(self, replica_id: int) -> bool:
        with self._mu:
            return self._replicas[replica_id].draining

    def prefix_owner_count(self, replica_id: int) -> int:
        """How many prefix digests currently route to this replica
        (the owner-map-handoff observability hook)."""
        with self._mu:
            return sum(1 for o in self._prefix_owner.values()
                       if o == replica_id)

    def rollout(self, new_checkpoint: str, **kw):
        """The router's rollout control-surface op: run a zero-downtime
        rolling rollout of the whole tier onto ``new_checkpoint`` (see
        serve/rollout.py for the state machine).  Returns the final
        RolloutState."""
        from dtf_tpu_torch.serve.rollout import RolloutController
        return RolloutController(self, new_checkpoint, **kw).run()

    def fence(self) -> None:
        """Mark this router superseded (serve/ha.py LeaseKeeper's
        ``on_fenced``: the lease shows a higher epoch).  Latched — a
        fenced router sheds every new submit and never drives the tier
        again; the replicas' stale-epoch rejections enforce the same
        verdict at the wire for anything already in flight."""
        with self._mu:
            if self._fenced:
                return
            self._fenced = True
            log.error("router: FENCED (epoch %d) — lease lost to a "
                      "successor", self.epoch)
            trace.anomaly("router_fenced", epoch=self.epoch,
                          source="lease")

    # -- introspection -------------------------------------------------
    def health(self) -> dict:
        """The /healthz payload (obs/prom.py MetricsServer health_fn):
        ``ok`` while the router can still place work — at least one
        replica healthy and not draining/stopping."""
        with self._mu:
            healthy = [r.healthy for r in self._replicas]
            return {
                "ok": any(healthy) and not self._stopping
                      and not self._draining and not self._fenced,
                "draining": self._draining,
                "replicas_healthy": healthy,
                "outstanding": self._outstanding,
                # HA posture for external probes: which role this
                # process plays, under which fencing epoch, and
                # whether a successor has fenced it off
                "role": self.role,
                "epoch": self.epoch,
                "fenced": self._fenced,
            }

    def replica_healthy(self, replica_id: int) -> bool:
        with self._mu:
            return self._replicas[replica_id].healthy

    def replica_completed(self, replica_id: int) -> int:
        """Requests this replica finished (router-side count — survives
        replica respawns, unlike the replica's own counter)."""
        with self._mu:
            return self._replicas[replica_id].completed

    def replica_stats(self, replica_id: int,
                      timeout: float = 5.0) -> Optional[dict]:
        """Round-trip a stats snapshot from a replica's engine (the
        prefix-registry hit counters are read through this)."""
        rep = self._replicas[replica_id]
        tag = f"s{time.monotonic_ns()}"
        ev = threading.Event()
        with self._mu:
            if rep.wfile is None:
                return None
            self._stats_events[(rep.id, tag)] = ev
            try:
                send_msg(rep.wfile, rep.wlock,
                         {"op": "stats", "tag": tag,
                          "epoch": self.epoch})
            except (OSError, ValueError):
                self._stats_events.pop((rep.id, tag), None)
                return None
        if not ev.wait(timeout):
            with self._mu:
                self._stats_events.pop((rep.id, tag), None)
                # the reply may have raced the timeout: _on_msg popped
                # the event and stored the snapshot before this lock
                # acquisition — drop it, or every timed-out poll
                # leaves one permanent last_stats entry (tags are
                # unique per call)
                rep.last_stats.pop(tag, None)
            return None
        return rep.last_stats.pop(tag, None)

    def reset_replica_measurement(self, replica_id: int) -> bool:
        """Zero a replica engine's decode-gap/peak measurement state
        over the wire (fire-and-forget ``reset_measurement`` op).
        Benches call this after warmup so compile stalls don't
        masquerade as serving gaps in the replica's distributions."""
        rep = self._replicas[replica_id]
        with self._mu:
            if rep.wfile is None:
                return False
            try:
                send_msg(rep.wfile, rep.wlock,
                         {"op": "reset_measurement",
                          "epoch": self.epoch})
            except (OSError, ValueError):
                return False
        return True


def replica_spawner(cmd: List[str], rendezvous_dir: str,
                    log_dir: Optional[str] = None,
                    env_extra: Optional[dict] = None,
                    cwd: Optional[str] = None,
                    extra_flags: Optional[Callable] = None,
                    checkpoint_map: Optional[Dict[int, str]] = None
                    ) -> Callable:
    """Standard spawn callable for :class:`Router`: runs ``cmd`` with
    the replica-tier environment contract — DTF_PROCESS_ID = replica
    id (announce/heartbeat/trace rank identity), DTF_HEARTBEAT_DIR =
    the rendezvous dir, DTF_RESTART_GENERATION = respawn generation
    (the launcher's restart-tagging contract) — logging each replica to
    ``replica{K}.log`` (``.retry{G}`` suffixed on respawn, keeping the
    first failure's log like the launcher does).  ``extra_flags``
    (``replica_id -> [flag, ...]``) appends PER-REPLICA flags — the
    metrics-port fan-out (router_main gives replica K port base+1+K so
    one ``--metrics_port`` makes the whole tier scrapable).
    ``checkpoint_map`` (shared BY REFERENCE with
    ``Router.replica_checkpoints``) is consulted at SPAWN time: a
    non-empty entry exports DTF_SERVE_CHECKPOINT, which replica_main
    serves instead of its flag-configured checkpoint — the mechanism a
    rollout uses to restart one replica at a time onto a new
    checkpoint without touching the other replicas' command line."""
    rendezvous_dir = os.path.abspath(rendezvous_dir)
    log_dir = os.path.abspath(log_dir or rendezvous_dir)
    # the replica must import dtf_tpu_torch no matter where the ROUTER was
    # launched from — or what ``cwd`` the caller picked: the repo root
    # goes on PYTHONPATH unconditionally (a spawn that only imports
    # from one directory is a crash-loop that eats the whole respawn
    # budget before anyone reads replica0.log)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cwd = os.path.abspath(cwd) if cwd else repo_root

    def spawn(replica_id: int, generation: int) -> subprocess.Popen:
        env = dict(os.environ)
        env["DTF_PROCESS_ID"] = str(replica_id)
        env["DTF_HEARTBEAT_DIR"] = rendezvous_dir
        env["DTF_RESTART_GENERATION"] = str(generation)
        env["PYTHONPATH"] = (repo_root + os.pathsep
                             + env.get("PYTHONPATH", ""))
        env.update(env_extra or {})
        ckpt = (checkpoint_map or {}).get(replica_id, "")
        if ckpt:
            env["DTF_SERVE_CHECKPOINT"] = ckpt
        os.makedirs(log_dir, exist_ok=True)
        suffix = f".retry{generation}" if generation else ""
        logf = open(os.path.join(
            log_dir, f"replica{replica_id}{suffix}.log"), "wb")
        full = cmd + ["--replica_id", str(replica_id)]
        if extra_flags is not None:
            full += [str(f) for f in (extra_flags(replica_id) or [])]
        try:
            return subprocess.Popen(full, env=env, cwd=cwd, stdout=logf,
                                    stderr=subprocess.STDOUT)
        finally:
            logf.close()

    return spawn
