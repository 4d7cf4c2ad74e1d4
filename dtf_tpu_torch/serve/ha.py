"""Router high availability: fenced leader lease + warm-standby
takeover.  A copy of ``dtf_tpu/serve/ha.py``: the lease, the standby
and the takeover are framework-free (files, threads, the router's own
surface), so they are the JAX package's, line for line.

The replica tier survives replica SIGKILL, partitions and slow
replicas token-exactly (serve/router.py), but the router itself is a
single point of failure: its death strands every queued and in-flight
request.  This module closes that hole with three shared-storage
artifacts — all in the rendezvous directory, the tier's ONE shared-
storage requirement, all written with the same atomic tmp+``os.replace``
discipline as ``replica_rank{K}.json`` and ``rollout_state.json``:

  ``router_lease.json``    the leader lease.  One holder at a time;
                           every acquisition bumps a MONOTONIC fencing
                           epoch.  Every controller wire op carries the
                           holder's epoch and replicas reject ops with
                           an epoch below the highest they have seen —
                           a deposed leader that never noticed (GC
                           pause, partition) is fenced out at the
                           replicas, so split-brain cannot corrupt a
                           client stream no matter how the lease race
                           resolves.
  ``router_journal.jsonl`` the request journal (serve/journal.py): the
                           successor's re-adoption worklist.
  ``rollout_state.json``   the rollout state machine (serve/rollout.py)
                           — a takeover mid-rollout resumes it through
                           ``RolloutController.resume``.

Why takeover is CRASH-EXACT: replicas keep decoding while the router
socket is down (a dead pipe drops deliveries, not engine work — and
the replica retains each request's token tail, serve/replica.py
``reattach``), and the determinism contract (greedy decode + the
per-request ``rng_seed`` minted once at submit and persisted in the
journal's submit record) means any re-dispatch replays the identical
token stream.  So the standby re-attaches where tails survive and
re-dispatches where they don't, the router's token-index verify+dedupe
de-duplicates the overlap, and the client sees each token exactly
once — the router's death is an efficiency loss (one takeover gap),
never a correctness event.

Lease acquisition is serialized with an ``O_EXCL`` lock file (broken
when stale: a holder that died mid-acquire must not wedge the tier),
and the lease content itself is read/written atomically.  Renewals
that stop (the ``lease_stall@<ticks>`` chaos kind drops them
deterministically) let the lease expire: the standby acquires at
epoch+1 and the old leader — if it is somehow still alive — discovers
the fence on its next renewal or at the replicas' ``stale_epoch``
rejections, whichever comes first.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

from dtf_tpu_torch import chaos
from dtf_tpu_torch.obs import trace

log = logging.getLogger("dtf_tpu_torch")

LEASE_NAME = "router_lease.json"


def lease_path(rendezvous_dir: str) -> str:
    return os.path.join(rendezvous_dir, LEASE_NAME)


def read_lease(rendezvous_dir: str) -> Optional[dict]:
    """Parse the lease file; None when missing/torn (an atomic writer
    means torn = mid-replace on a non-atomic filesystem — treated as
    'no lease', the safe direction for an acquirer)."""
    try:
        with open(lease_path(rendezvous_dir), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class LeaderLease:
    """One contender's view of the shared leader lease.

    ``acquire()`` takes the lease (epoch = highest seen + 1) when it is
    free or expired; ``renew()`` extends it and returns False the
    moment another holder's epoch appears — the FENCED verdict.  The
    epoch this object holds is what the owning router stamps on every
    wire op."""

    def __init__(self, rendezvous_dir: str, *, ttl_s: float = 2.0,
                 holder: str = ""):
        self.rendezvous_dir = os.path.abspath(rendezvous_dir)
        os.makedirs(self.rendezvous_dir, exist_ok=True)
        self.ttl_s = float(ttl_s)
        self.holder = holder or f"pid{os.getpid()}"
        self.path = lease_path(self.rendezvous_dir)
        self._lock_path = self.path + ".lock"
        self.epoch = 0          # the epoch THIS contender holds; 0 = none
        self.fenced = False

    # -- the shared file -----------------------------------------------
    def read(self) -> Optional[dict]:
        return read_lease(self.rendezvous_dir)

    def expired(self, lease: Optional[dict] = None) -> bool:
        """True when the current lease no longer protects its holder
        (missing, torn, or past ts + ttl in shared wall time)."""
        lease = lease if lease is not None else self.read()
        if lease is None:
            return True
        return time.time() > float(lease.get("ts", 0)) + float(
            lease.get("ttl_s", self.ttl_s))

    def _write(self, payload: dict) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)   # atomic: readers never see a torn lease

    def _with_acquire_lock(self, fn: Callable, timeout_s: float = 5.0):
        """Serialize lease MUTATION across contenders with an O_EXCL
        lock file.  A lock older than 5×ttl is stale (its taker died
        mid-acquire) and is broken — one dead contender must not wedge
        every future takeover."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                fd = os.open(self._lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                try:
                    age = time.time() - os.stat(self._lock_path).st_mtime
                    if age > 5.0 * self.ttl_s:
                        os.unlink(self._lock_path)
                        continue
                except OSError:
                    continue    # raced another breaker/releaser
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"lease lock {self._lock_path} held too long")
                time.sleep(0.01)
        try:
            return fn()
        finally:
            os.close(fd)
            try:
                os.unlink(self._lock_path)
            except OSError:
                pass

    # -- contender API -------------------------------------------------
    def acquire(self, force: bool = False) -> Optional[int]:
        """Try to take the lease: returns the NEW fencing epoch, or
        None while a live holder's lease protects it.  ``force`` takes
        it regardless (operator override) — still at epoch+1, so the
        deposed holder is fenced, not raced."""

        def attempt():
            cur = self.read()
            if cur is not None and not self.expired(cur) and not force \
                    and cur.get("holder") != self.holder:
                return None
            epoch = int(cur.get("epoch", 0) if cur else 0) + 1
            self._write({"epoch": epoch, "holder": self.holder,
                         "ts": time.time(), "ttl_s": self.ttl_s})
            self.epoch = epoch
            self.fenced = False
            log.warning("ha: %s acquired leader lease (epoch %d)",
                        self.holder, epoch)
            return epoch

        return self._with_acquire_lock(attempt)

    def renew(self) -> bool:
        """Extend the held lease.  Returns False — the FENCED verdict,
        latched — when another holder's epoch has appeared: this
        contender must stop acting as leader NOW (its wire ops are
        already being rejected by replicas).  A chaos ``lease_stall``
        drops the renewal write (the renewal tick happens, the file
        write doesn't) — the deterministic stand-in for a GC pause or
        a shared-storage brownout."""
        if self.epoch == 0:
            return False
        cur = self.read()
        if cur is not None and int(cur.get("epoch", 0)) > self.epoch:
            if not self.fenced:
                self.fenced = True
                log.error("ha: %s FENCED (held epoch %d, current %d)",
                          self.holder, self.epoch,
                          int(cur.get("epoch", 0)))
            return False
        if chaos.lease_stall():
            return True     # stalled, not fenced — the lease just ages
        self._write({"epoch": self.epoch, "holder": self.holder,
                     "ts": time.time(), "ttl_s": self.ttl_s})
        return True

    def release(self) -> None:
        """Drop the lease on clean shutdown so the standby takes over
        at the next poll instead of waiting out the ttl."""
        if self.epoch == 0:
            return

        def attempt():
            cur = self.read()
            if cur is not None and int(cur.get("epoch", 0)) == self.epoch:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
            return None

        try:
            self._with_acquire_lock(attempt)
        except (OSError, TimeoutError):
            pass
        self.epoch = 0


class LeaseKeeper:
    """The leader's renewal heartbeat: a thread that renews at ttl/3
    cadence and calls ``on_fenced`` (once) the moment renew() returns
    the fenced verdict."""

    def __init__(self, lease: LeaderLease,
                 on_fenced: Optional[Callable] = None):
        self.lease = lease
        self._on_fenced = on_fenced
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LeaseKeeper":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ha-lease-keeper")
        self._thread.start()
        return self

    def _run(self) -> None:
        interval = max(0.05, self.lease.ttl_s / 3.0)
        while not self._stop.wait(interval):
            try:
                if not self.lease.renew():
                    if self._on_fenced is not None:
                        self._on_fenced()
                    return
            except OSError as e:
                # shared storage hiccup: keep trying — the lease ages
                # like a stall, and the standby's takeover fences us
                # if it ages out
                log.warning("ha: lease renewal failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def standby_health(lease: LeaderLease) -> dict:
    """The warm standby's /healthz payload while it waits: role,
    the epoch it watches, and ok (a standby that can read the lease
    is doing its whole job)."""
    cur = lease.read()
    return {"ok": True, "role": "standby",
            "epoch": int(cur.get("epoch", 0)) if cur else 0,
            "lease_expired": lease.expired(cur)}


def wait_for_takeover(lease: LeaderLease, poll_s: float = 0.1,
                      timeout_s: float = 0.0,
                      stop: Optional[threading.Event] = None
                      ) -> Optional[int]:
    """Standby loop: poll the lease until it expires, then acquire.
    Returns the new fencing epoch, or None on timeout/stop.  Polling
    beats watching: the lease lives on shared storage where inotify
    does not travel."""
    deadline = (time.monotonic() + timeout_s) if timeout_s else None
    while True:
        if stop is not None and stop.is_set():
            return None
        if lease.expired():
            epoch = lease.acquire()
            if epoch is not None:
                return epoch
        if deadline is not None and time.monotonic() > deadline:
            return None
        time.sleep(poll_s)


def take_over(router, *, delivered: Optional[dict] = None,
              resume_rollout: bool = True,
              rollout_state_path: str = "",
              restart_hook: Optional[Callable] = None) -> dict:
    """Run the whole takeover sequence on a freshly-built successor
    ``router`` (constructed with the NEW fencing epoch and the shared
    journal path, ``start(adopt=True)`` already done — replicas
    adopted, not respawned):

      1. replay the journal and re-adopt/re-dispatch every unresolved
         request (``Router.adopt_requests`` — reattach where the
         replica retained the tail, ordinary budgeted failover where
         it didn't);
      2. resume a mid-flight rollout state machine, if
         ``rollout_state.json`` shows one (CANARY → rollback, ROLLING
         → forward: serve/rollout.py ``resume`` semantics).

    ``delivered`` maps request id → the token prefix the CLIENT
    acknowledges on reconnect; with it the re-adopted stream is
    exactly-once (tokens the client has are verified, not re-emitted).
    Returns the adoption summary dict."""
    from dtf_tpu_torch.serve import journal as journal_mod
    from dtf_tpu_torch.serve import rollout as rollout_mod

    state = journal_mod.unresolved(journal_mod.replay(
        journal_mod.journal_path(router.rendezvous_dir)))
    summary = router.adopt_requests(state, delivered=delivered)
    if resume_rollout:
        state_path = rollout_state_path or rollout_mod.default_state_path(
            router.rendezvous_dir)
        try:
            rstate = rollout_mod.RolloutState.load(state_path)
        except (OSError, ValueError):
            rstate = None
        if rstate is not None and rstate.phase not in ("IDLE", "DONE"):
            log.warning("ha: takeover found rollout mid-flight (%s) — "
                        "resuming", rstate.phase)
            final = rollout_mod.RolloutController.resume(
                router, state_path=state_path, restart_hook=restart_hook)
            summary["rollout_resumed"] = final.phase
    trace.event("router_takeover", epoch=router.epoch,
                readopted=summary.get("readopted", 0),
                redispatched=summary.get("redispatched", 0),
                unresolved=len(state))
    trace.flush()
    return summary
