"""Append-only request journal: the router's crash-recovery WAL.  A
copy of ``dtf_tpu/serve/journal.py`` (the router writes it; a successor
router replays it through ``serve/ha.py``'s ``take_over``).

The router journals every request's life as newline-delimited JSON in
``router_journal.jsonl`` inside the rendezvous directory (the tier's
one shared-storage requirement — same place the replica announces and
the rollout state machine already live):

    {"t":"submit","id":R,"prompt":[...],"max_new_tokens":N,
     "temperature":T,"eos_id":E,"rng_seed":S,"trace":TID,
     "version":V,"ts":...}             request accepted (admission
                                       passed); carries EVERYTHING a
                                       successor router needs to
                                       re-dispatch it bit-identically —
                                       most importantly the minted
                                       rng_seed, which pins the
                                       sampling identity so a replay
                                       is token-exact (the router's
                                       failover contract)
    {"t":"dispatch","id":R,"attempt":A,"replica":K,"ts":...}
                                       attempt A sent to replica K —
                                       the successor knows WHERE to
                                       look for a retained tail
    {"t":"first_token","id":R,"ts":...}   the client stream started
    {"t":"watermark","id":R,"n":N,"ts":...}  N tokens delivered to the
                                       client (bounded cadence, not
                                       per-token) — the successor seeds
                                       the dedupe index at >= N so a
                                       re-adopted stream VERIFIES the
                                       prefix instead of re-emitting it
    {"t":"complete","id":R,"ok":B,"ts":...}  resolved (result OR
                                       terminal failure) — the request
                                       needs nothing from a successor

Durability follows data/service/cache.py's WAL discipline, adapted to
a single append stream: every record is flushed to the OS immediately
(a torn PROCESS loses nothing), and fsync'd at a bounded cadence (a
torn HOST loses at most ``fsync_interval_s`` of tail).  Replay
tolerates exactly the failure modes appends create:

  * a torn final line (killed mid-write) is DROPPED, never an error;
  * duplicate records are idempotent (last dispatch wins, first
    complete wins — a complete is terminal);
  * records for unknown ids (a complete whose submit was lost to an
    fsync gap) are ignored.

The journal answers one question for a successor: *which requests were
accepted but not resolved, and where were they last dispatched?*
Everything else — the tokens themselves — lives in the replicas'
retained per-request tails (serve/replica.py ``reattach``), because
the journal must stay CHEAP: O(1) writes per request lifecycle event,
never per token.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

JOURNAL_NAME = "router_journal.jsonl"


def journal_path(rendezvous_dir: str) -> str:
    return os.path.join(rendezvous_dir, JOURNAL_NAME)


class RequestJournal:
    """Thread-safe append stream of request-lifecycle records.

    Writers (router submit path, dispatch path, delivery path) append
    concurrently; ``_lock`` serializes the file writes and the fsync
    bookkeeping.  ``lag_observe`` (optional) receives the append→fsync
    delay in seconds whenever a sync retires queued records — the
    ``router_journal_lag_s`` histogram, the operator's bound on how
    much tail a host crash can cost."""

    _GUARDED_BY = {
        "_file": "_lock",
        "_pending_since": "_lock",
        "_last_fsync": "_lock",
        "_records": "_lock",
    }

    def __init__(self, path: str, fsync_interval_s: float = 0.05,
                 lag_observe: Optional[Callable[[float], None]] = None):
        self.path = path
        self.fsync_interval_s = float(fsync_interval_s)
        self._lag_observe = lag_observe
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # append mode: a successor taking over the SAME journal keeps
        # extending it — replay tolerates the dead leader's tail
        self._file = open(path, "a", encoding="utf-8")
        self._pending_since: float = 0.0   # oldest unfsynced append (0 = none)
        self._last_fsync: float = time.monotonic()
        self._records = 0

    # -- write side ----------------------------------------------------
    def append(self, record: dict) -> None:
        """Append one record: flushed always, fsync'd at bounded
        cadence.  Raises OSError only if the journal file itself is
        gone — the CALLER decides whether that is fatal."""
        line = json.dumps(record, separators=(",", ":")) + "\n"
        with self._lock:
            now = time.monotonic()
            self._file.write(line)
            self._file.flush()
            self._records += 1
            if not self._pending_since:
                self._pending_since = now
            if now - self._last_fsync >= self.fsync_interval_s:
                self._fsync_locked(now)

    def sync(self) -> None:
        """Force-fsync any pending appends (takeover/teardown path)."""
        with self._lock:
            if self._pending_since:
                self._fsync_locked(time.monotonic())

    def _fsync_locked(self, now: float) -> None:
        os.fsync(self._file.fileno())
        if self._lag_observe is not None and self._pending_since:
            self._lag_observe(now - self._pending_since)
        self._pending_since = 0.0
        self._last_fsync = now

    @property
    def records(self) -> int:
        with self._lock:
            return self._records

    def close(self) -> None:
        with self._lock:
            try:
                if self._pending_since:
                    self._fsync_locked(time.monotonic())
            except (OSError, ValueError):
                pass
            try:
                self._file.close()
            except (OSError, ValueError):
                pass

    # -- lifecycle-record helpers (the router's write vocabulary) ------
    def submit(self, req_id: str, *, prompt, max_new_tokens: int,
               temperature: float, eos_id, rng_seed: int, trace: str,
               version: str = "") -> None:
        self.append({"t": "submit", "id": req_id,
                     "prompt": [int(t) for t in prompt],
                     "max_new_tokens": int(max_new_tokens),
                     "temperature": float(temperature),
                     "eos_id": eos_id, "rng_seed": int(rng_seed),
                     "trace": trace, "version": version,
                     "ts": time.time()})

    def dispatch(self, req_id: str, attempt: int, replica: int) -> None:
        self.append({"t": "dispatch", "id": req_id,
                     "attempt": int(attempt), "replica": int(replica),
                     "ts": time.time()})

    def first_token(self, req_id: str) -> None:
        self.append({"t": "first_token", "id": req_id, "ts": time.time()})

    def watermark(self, req_id: str, n: int) -> None:
        self.append({"t": "watermark", "id": req_id, "n": int(n),
                     "ts": time.time()})

    def complete(self, req_id: str, ok: bool) -> None:
        self.append({"t": "complete", "id": req_id, "ok": bool(ok),
                     "ts": time.time()})


def replay(path: str) -> dict:
    """Parse a journal into per-request recovery state.

    Returns ``{req_id: state}`` where state is a dict with:

      * ``submit``      the submit record (None if lost — such a
                        request is unrecoverable and is EXCLUDED)
      * ``dispatches``  list of dispatch records, wire order
      * ``first_token`` True if the stream ever started
      * ``watermark``   highest client-delivered token count seen
      * ``complete``    the FIRST complete record (duplicates are
                        idempotent), or None while in-flight

    The torn final line — the signature of a router killed mid-append —
    is dropped silently; a torn line anywhere ELSE means external
    corruption and still only costs that line (each record is
    self-contained).  Missing file = empty journal (cold start)."""
    state: dict = {}
    try:
        with open(path, encoding="utf-8") as f:
            raw = f.read()
    except OSError:
        return state
    lines = raw.split("\n")
    for k, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            # torn tail (no trailing newline written) is expected;
            # anything else is tolerated the same way — one record lost
            continue
        t = rec.get("t")
        rid = rec.get("id")
        if not rid:
            continue
        if t == "submit":
            st = state.setdefault(rid, _fresh())
            if st["submit"] is None:     # duplicate submits: first wins
                st["submit"] = rec
        elif t == "dispatch":
            st = state.get(rid)
            if st is not None and st["complete"] is None:
                st["dispatches"].append(rec)
        elif t == "first_token":
            st = state.get(rid)
            if st is not None:
                st["first_token"] = True
        elif t == "watermark":
            st = state.get(rid)
            if st is not None:
                st["watermark"] = max(st["watermark"],
                                      int(rec.get("n", 0)))
        elif t == "complete":
            st = state.get(rid)
            if st is not None and st["complete"] is None:
                st["complete"] = rec     # duplicates idempotent
    return state


def _fresh() -> dict:
    return {"submit": None, "dispatches": [], "first_token": False,
            "watermark": 0, "complete": None}


def unresolved(state: dict) -> dict:
    """Filter replay() output to the requests a successor must finish:
    submitted, never completed."""
    return {rid: st for rid, st in state.items()
            if st["submit"] is not None and st["complete"] is None}
