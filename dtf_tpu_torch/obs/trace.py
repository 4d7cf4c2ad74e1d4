"""Structured JSONL tracing -- a copy of ``dtf_tpu/obs/trace.py`` (the
port imports nothing of dtf_tpu).

One record per line, one file per rank (``trace_rank{N}.jsonl``), three
record kinds:

  span    — a timed region: {"kind":"span","name":...,"ts":<start>,
            "dur_s":...,"rank":...,"parent":...,  ...attrs}
            (written when the region EXITS, so a crash mid-span leaves
            the enclosing spans visible up to the crash point)
  event   — a point-in-time marker: {"kind":"event","name":...,
            "ts":..., ...attrs} (e.g. "heartbeat")
  anomaly — an event that means the run is unhealthy: same shape with
            kind="anomaly" ("nan_loss", "step_time_regression", ...).
            `trace_main --check` exits nonzero when any is present.

Design constraints, in order:

  1. disabled == free: every public entry point hits a module-level
     None check and returns a shared no-op object.  No locks, no
     allocation, no time syscalls.
  2. enabled but off the step critical path: records are appended to an
     in-memory list and flushed to disk every ``flush_every`` records
     (and at close/atexit), so a per-step span costs two clock reads,
     one small dict, and an amortized write.
  3. crash-robust enough to debug the crash: the flush interval bounds
     the loss window, and abort paths (watchdog) flush explicitly.

The tracer is configured once per process — from ``--trace_dir`` via
:func:`maybe_configure`, or from the ``DTF_TRACE_DIR`` environment
variable that the launcher forwards to every rank.  Rank identity comes
from config/env (``DTF_PROCESS_ID``), never from torch.distributed —
importing this module must not touch a device or a process group.

SPAN CONTEXT (request-scoped distributed tracing): every record can
carry a ``trace`` id that survives process boundaries, so one request's
life — router queue, dispatch, replica prefill/decode, failover,
completion — is reconstructable across N trace files
(``trace_main --request <id>``).  Three propagation layers:

  - explicit attrs win: ``trace.event("x", trace=tid)`` — the serving
    tier tags per-request records this way (one engine iteration
    serves MANY requests, so ambient context can't express it; batch
    spans carry a ``traces`` list instead).
  - thread-local :func:`context` — ``with trace.context(tid, parent):``
    stamps every record emitted under it.
  - process-wide :func:`set_default_trace` — the RUN-scoped id the
    launcher mints once (``DTF_TRACE_ID``) and every rank inherits, so
    train steps, checkpoint saves, eval and data-service records join
    one timeline without per-call plumbing.

Spans additionally get a process-unique ``span_id`` (rank-qualified
counter — no syscalls) and a ``parent_span`` id when nested; a parent
id crossing a process boundary (the router's per-request span id,
carried over the replica wire) lands via ``parent_span`` too, which is
what makes the context *propagatable* rather than merely ambient.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_tracer: Optional["Tracer"] = None
_lock = threading.Lock()
_local = threading.local()
_default_trace: Optional[str] = None


def new_trace_id() -> str:
    """A fresh 16-hex trace id (collision-safe across processes)."""
    return os.urandom(8).hex()


def new_span_id() -> str:
    """A fresh 8-hex span id for callers that need one BEFORE any span
    opens (the router mints one per request and sends it over the wire
    as the replica-side records' ``parent_span``)."""
    return os.urandom(4).hex()


def set_default_trace(trace_id: Optional[str]) -> None:
    """Install the process-wide run-scoped trace id (None clears it).
    Stamped on every record that carries no explicit/contextual
    trace — the train-side 'everything in this run joins up' layer."""
    global _default_trace
    _default_trace = trace_id or None


def default_trace() -> Optional[str]:
    return _default_trace


@contextlib.contextmanager
def context(trace_id: Optional[str], parent: Optional[str] = None):
    """Thread-local span context: records emitted under it default
    their ``trace`` (and ``parent_span``) to these ids.  Nests; inner
    contexts shadow outer ones; explicit attrs always win."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = (trace_id, parent)
    try:
        yield
    finally:
        _local.ctx = prev


def current_context():
    """(trace_id, parent_span) of the active :func:`context`, or
    None."""
    return getattr(_local, "ctx", None)


class _NullSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "t0", "span_id")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.span_id = self._tracer._next_span_id()
        self._tracer._stack().append((self.name, self.span_id))
        self.t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.time() - self.t0
        stack = self._tracer._stack()
        stack.pop()
        rec = {"kind": "span", "name": self.name, "ts": self.t0,
               "dur_s": dur, "span_id": self.span_id}
        if stack:
            # parent name kept for the summarizer's nesting view;
            # parent_span is the id link the request timeline follows
            rec["parent"] = stack[-1][0]
            rec["parent_span"] = stack[-1][1]
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec.update(self.attrs)
        self._tracer.emit(rec)
        return False


class Tracer:
    """Buffered JSONL writer; thread-safe; one instance per process."""

    def __init__(self, path: str, rank=0, flush_every: int = 256):
        self.path = os.path.abspath(path)
        # rank is an int for launcher ranks; NAMED streams (the serving
        # router) tag records with their stream name instead, so a
        # merged timeline reads "router" next to 0..N-1
        self.rank = rank if isinstance(rank, str) else int(rank)
        self.flush_every = max(int(flush_every), 1)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._file = open(self.path, "a", buffering=1024 * 64)
        self._buf: List[str] = []
        self._mu = threading.Lock()
        self._local = threading.local()
        self._span_ids = itertools.count(1)
        self.emit({"kind": "event", "name": "trace_start", "ts": time.time(),
                   "pid": os.getpid()})

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_span_id(self) -> str:
        # rank-qualified counter: unique across a run's processes with
        # no per-span syscall (os.urandom per step would be real cost)
        return f"{self.rank}.{next(self._span_ids)}"

    # -- record emission ----------------------------------------------
    def emit(self, record: Dict[str, Any]) -> None:
        record.setdefault("rank", self.rank)
        # span context: explicit attrs > thread-local context() >
        # process default (the run-scoped trace id) — setdefault keeps
        # the precedence without ever overwriting a caller's tag
        ctx = getattr(_local, "ctx", None)
        if ctx is not None:
            if ctx[0] is not None:
                record.setdefault("trace", ctx[0])
            if ctx[1] is not None:
                record.setdefault("parent_span", ctx[1])
        elif _default_trace is not None:
            record.setdefault("trace", _default_trace)
        line = json.dumps(record, default=str)
        with self._mu:
            self._buf.append(line)
            if len(self._buf) >= self.flush_every:
                self._flush_locked()

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        rec = {"kind": "event", "name": name, "ts": time.time()}
        rec.update(attrs)
        self.emit(rec)

    def anomaly(self, name: str, **attrs) -> None:
        rec = {"kind": "anomaly", "name": name, "ts": time.time()}
        rec.update(attrs)
        self.emit(rec)
        self.flush()  # anomalies must survive the crash they predict

    # -- lifecycle -----------------------------------------------------
    def _flush_locked(self) -> None:
        if self._buf and not self._file.closed:
            self._file.write("\n".join(self._buf) + "\n")
            self._file.flush()
        self._buf.clear()

    def flush(self) -> None:
        with self._mu:
            self._flush_locked()

    def close(self) -> None:
        with self._mu:
            self._flush_locked()
            if not self._file.closed:
                self._file.close()


# ---------------------------------------------------------------------------
# Module-level API (what instrumented code calls)
# ---------------------------------------------------------------------------

def configure(trace_dir: str, rank: Optional[int] = None,
              flush_every: int = 256,
              stream: Optional[str] = None) -> Tracer:
    """Install the process-global tracer writing under ``trace_dir``.
    Idempotent per (dir, rank): reconfiguring replaces the tracer.

    ``stream`` names a NON-RANK stream: the file becomes
    ``trace_<stream>.jsonl`` and records are tagged with the stream
    name — the serving router writes ``trace_router.jsonl`` next to
    its replicas' ``trace_rank{K}.jsonl`` so ``trace_main --merge``
    interleaves the tiers into one timeline."""
    global _tracer
    if stream is not None:
        path = os.path.join(trace_dir, f"trace_{stream}.jsonl")
        rank = stream
    else:
        if rank is None:
            rank = int(os.environ.get("DTF_PROCESS_ID", "0"))
        path = os.path.join(trace_dir, f"trace_rank{rank}.jsonl")
    with _lock:
        if _tracer is not None:
            if _tracer.path == os.path.abspath(path):
                return _tracer  # same destination — keep the live tracer
            _tracer.close()
        _tracer = Tracer(path, rank=rank, flush_every=flush_every)
    return _tracer


def maybe_configure(cfg=None) -> Optional[Tracer]:
    """Configure from ``cfg.trace_dir`` or the ``DTF_TRACE_DIR`` env var
    (launcher ranks inherit the env).  Returns the tracer, or None when
    tracing stays off.  Explicit config wins over env."""
    trace_dir = (getattr(cfg, "trace_dir", "") or
                 os.environ.get("DTF_TRACE_DIR", ""))
    if not trace_dir:
        return None
    rank = getattr(cfg, "process_id", None) if cfg is not None else None
    return configure(trace_dir, rank=rank)


def get() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


def disable() -> None:
    """Close and uninstall the global tracer (tests).  Also clears the
    process default trace id so one test's run id never leaks into the
    next run's records."""
    global _tracer
    with _lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = None
    set_default_trace(None)


def span(name: str, **attrs):
    """``with trace.span("step", step=n): ...`` — no-op when disabled."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


def event(name: str, **attrs) -> None:
    t = _tracer
    if t is not None:
        t.event(name, **attrs)


def span_completed(name: str, dur_s: float, **attrs) -> None:
    """Emit a span record for a region timed by the caller (used when
    the duration comes from the caller's own clock — e.g. the train
    loop's log-window wall time, measured across an explicit device
    sync — rather than a with-block)."""
    t = _tracer
    if t is None:
        return
    rec = {"kind": "span", "name": name, "ts": time.time() - dur_s,
           "dur_s": float(dur_s)}
    rec.update(attrs)
    t.emit(rec)


def anomaly(name: str, **attrs) -> None:
    t = _tracer
    if t is not None:
        t.anomaly(name, **attrs)


def flush() -> None:
    t = _tracer
    if t is not None:
        t.flush()


@atexit.register
def _close_at_exit() -> None:
    t = _tracer
    if t is not None:
        t.close()


# ---------------------------------------------------------------------------
# Reading (trace_main + tests)
# ---------------------------------------------------------------------------

def read_records(path: str) -> List[Dict[str, Any]]:
    """Parse one JSONL trace file; tolerates a torn final line (the
    process may have died mid-write)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line from a crash — skip, keep rest
    return out
