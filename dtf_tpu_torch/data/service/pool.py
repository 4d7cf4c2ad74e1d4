"""Multi-process shard worker pool + deterministic merged stream (a
copy of ``dtf_tpu/data/service/pool.py``).

The host-side data service: ``num_shards`` ShardReaders served by
``num_workers`` SPAWNED processes (processes, not threads — the Amdahl
serial fraction bench_input.py measures is GIL-held Python, so thread
pools stop scaling at one core's worth of Python), merged into one
stream whose order is a pure function of position:

    merged batch n  ==  shard (n % num_shards), shard-local batch
                        (n // num_shards)

Round-robin interleave over a static shard->worker assignment
(``shards[w::num_workers]``) makes the merged stream invariant to the
WORKER count: workers only decide who computes a batch, never what the
batch is (ShardReader.batch is pure in position).  ``start_step=n``
therefore replays the exact mid-epoch suffix of the stream — the piece
that makes killed-at-K resume bit-exact on imagenet.

Supervision: the pool owns its workers.  A worker that dies (chaos
``reader_crash@batch:N``, a real OOM-kill) is respawned at its recorded
per-shard positions with a fresh queue; determinism guarantees the
respawned worker recomputes exactly the batches the dead one would
have produced, so the merged stream is unchanged.  Respawns are
budgeted (a deterministically-crashing reader must fail loudly, not
spin), counted on the obs registry, and traced.

Observability: ``data_reader_lag_s`` (time the consumer blocked waiting
for the next batch) and ``data_cache_hit_ratio`` land on the default
obs registry every batch, and a report-only ReaderLagWatchdog emits a
structured ``reader_lag`` anomaly when the lag regresses — the
input-stall signal the watchdogs exist to surface.
"""

from __future__ import annotations

import atexit
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from dtf_tpu_torch import chaos
from dtf_tpu_torch.obs import trace

log = logging.getLogger("dtf_tpu_torch")
# the spawned readers' environment: no card, and one thread each for
# the libraries that would otherwise start a pool per process
_WORKER_ENV = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
_env_lock = threading.Lock()

# queue item tags (first tuple element is the shard id for batches)
_ERROR = "__error__"


def _supervisor_event(event: str, **attrs) -> None:
    """Append one record to the launcher's ``supervisor_events.jsonl``
    (via cli/launch.py SupervisorEventLog — ONE schema for every
    supervision record) when this rank runs under the launcher —
    post-mortems then see reader-restart decisions WITH their data
    positions next to the supervisor's own rank-restart records.  The
    launcher exports its log dir as DTF_HEARTBEAT_DIR; standalone runs
    (no env) skip silently, and SupervisorEventLog already swallows a
    full disk."""
    sup_dir = os.environ.get("DTF_HEARTBEAT_DIR")
    if not sup_dir:
        return
    from dtf_tpu_torch.cli.launch import SupervisorEventLog
    SupervisorEventLog(sup_dir).emit(
        event, rank=int(os.environ.get("DTF_PROCESS_ID", "0")), **attrs)


def shard_positions(step: int, num_shards: int) -> List[int]:
    """Per-shard next-batch positions after ``step`` merged batches —
    the host_state payload a checkpoint carries so the resume contract
    is explicit in the manifest (the positions are also derivable from
    the step alone; carrying them makes the manifest self-describing
    and lets a reader of the manifest audit the math)."""
    step = int(step)
    num_shards = int(num_shards)
    return [step // num_shards + (1 if s < step % num_shards else 0)
            for s in range(num_shards)]


def _put(out_q, item, parent: int) -> None:
    """``out_q.put(item)``, ending this process once its parent is gone:
    a parent that died without closing the stream (a crash, an
    ``os._exit``, a SIGKILL) leaves no reader waiting on a full queue."""
    while True:
        try:
            out_q.put(item, timeout=1.0)
            return
        except queue_mod.Full:
            if os.getppid() != parent:
                os._exit(0)


def _worker_main(payload: dict, out_q) -> None:
    """Shard-worker process body: build this worker's ShardReaders and
    produce batches round-robin over its shards, ascending k per shard,
    forever (training streams are infinite).  Every item carries its
    (shard, k) tag plus cumulative cache counters; backpressure is the
    bounded queue."""
    # the readers are numpy, PIL and libjpeg only; the child was started
    # with CUDA_VISIBLE_DEVICES="" (ServiceStream._spawn), so nothing
    # in it can take card memory
    parent = os.getppid()
    try:
        from dtf_tpu_torch.data.service.reader import make_reader
        readers = {}
        for s in payload["shards"]:
            readers[s] = make_reader(
                payload["data_dir"], s, payload["num_shards"],
                payload["batch_size"], seed=payload["seed"],
                process_id=payload["process_id"],
                process_count=payload["process_count"],
                wire=payload["wire"], cache_dir=payload["cache_dir"],
                cache_limit_bytes=payload["cache_limit_bytes"])
        ks = dict(payload["start_ks"])
        while True:
            for s in payload["shards"]:
                images, labels = readers[s].batch(ks[s])
                hits, lookups = readers[s].cache_stats()
                _put(out_q, (s, ks[s], images, labels, hits, lookups),
                     parent)
                ks[s] += 1
    except Exception as e:  # noqa: BLE001 — surfaced in the parent
        import traceback
        try:
            out_q.put((_ERROR, repr(e), traceback.format_exc()))
        except Exception:  # noqa: BLE001 — queue torn down under us
            pass


class ServiceStream:
    """The merged deterministic stream (iterator of (images, labels)).

    ``num_workers == 0`` runs every ShardReader inline (no subprocess):
    same stream, no spawn cost — the right default for tests and
    single-core hosts.  ``num_workers >= 1`` spawns worker processes,
    each owning the static shard slice ``shards[w::num_workers]``.

    LOCK DISCIPLINE: the stream has ONE consumer thread by contract
    (positions/buffers are unguarded single-thread state), but
    ``close()`` is re-entrant from elsewhere — the atexit hook, a
    supervisor's teardown racing the consumer — so the closed latch is
    guarded by ``_close_lock`` (declared below, enforced by
    the JAX package's lock-guard lint): the close-once check-and-set must not
    race a second closer into double-terminating workers mid-join.
    """

    _GUARDED_BY = {"_closed": "_close_lock"}

    MAX_RESPAWNS = 8
    GET_TIMEOUT_S = 0.5

    def __init__(self, data_dir: str, batch_size: int, *, seed: int = 0,
                 num_shards: int = 1, num_workers: int = 0,
                 process_id: int = 0, process_count: int = 1,
                 wire: str = "uint8", cache_dir: str = "",
                 cache_limit_bytes: int = 0, start_step: int = 0,
                 registry=None, lag_watchdog=None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if start_step < 0:
            raise ValueError(f"start_step must be >= 0, got {start_step}")
        self.num_shards = int(num_shards)
        if num_workers < 0:
            # auto (the flag default): one worker per host core, capped
            # by the shard count — inline on a single-core host, where
            # a lone worker only adds spawn + pickle overhead.  Safe to
            # auto-size (and to differ across a resume) because worker
            # count never changes the stream.
            cores = os.cpu_count() or 1
            num_workers = 0 if cores < 2 else cores
        self.num_workers = min(int(num_workers), self.num_shards)
        self._n = int(start_step)  # next merged batch position
        # next shard-local batch each shard owes the merged stream
        self._need: Dict[int, int] = dict(
            enumerate(shard_positions(start_step, num_shards)))
        self._payload_base = dict(
            data_dir=data_dir, num_shards=self.num_shards,
            batch_size=int(batch_size), seed=int(seed),
            process_id=int(process_id), process_count=int(process_count),
            wire=wire, cache_dir=cache_dir,
            cache_limit_bytes=int(cache_limit_bytes))
        self._close_lock = threading.Lock()
        self._closed = False
        self.respawns = 0
        # obs wiring (default registry unless a bench injects its own)
        if registry is None:
            from dtf_tpu_torch.obs.registry import default_registry
            registry = default_registry()
        self._lag_gauge = registry.gauge("data_reader_lag_s", unit="s")
        self._hit_gauge = registry.gauge("data_cache_hit_ratio")
        self._respawn_counter = registry.counter("data_reader_respawns")
        if lag_watchdog is None:
            from dtf_tpu_torch.obs.watchdog import ReaderLagWatchdog
            lag_watchdog = ReaderLagWatchdog()
        self._lag_watchdog = lag_watchdog
        # (hits, lookups) high-water per shard — cumulative counters
        # ride every queue item; the ratio aggregates across shards
        self._cache_stats: Dict[int, Tuple[int, int]] = {}

        if self.num_workers == 0:
            from dtf_tpu_torch.data.service.reader import make_reader
            self._readers = {
                s: make_reader(data_dir, s, self.num_shards,
                               int(batch_size), seed=int(seed),
                               process_id=int(process_id),
                               process_count=int(process_count),
                               wire=wire, cache_dir=cache_dir,
                               cache_limit_bytes=int(cache_limit_bytes))
                for s in range(self.num_shards)}
        else:
            # a missing file set fails here, as FileNotFoundError, not
            # as a worker's error report after the spawns
            from dtf_tpu_torch.data.imagenet import get_filenames
            get_filenames(True, data_dir)
            self._ctx = mp.get_context("spawn")
            self._owner = {s: s % self.num_workers
                           for s in range(self.num_shards)}
            self._procs: List[Optional[mp.process.BaseProcess]] = \
                [None] * self.num_workers
            self._queues: List[Optional[object]] = [None] * self.num_workers
            # parent-side reorder buffer: {(shard, k): (images, labels)}
            self._buf: Dict[Tuple[int, int], Tuple[np.ndarray,
                                                   np.ndarray]] = {}
            for w in range(self.num_workers):
                self._spawn(w)
            atexit.register(self.close)

    # -- worker lifecycle ----------------------------------------------
    def _worker_shards(self, w: int) -> List[int]:
        return [s for s in range(self.num_shards) if self._owner[s] == w]

    def _spawn(self, w: int) -> None:
        shards = self._worker_shards(w)
        payload = dict(self._payload_base, shards=shards,
                       start_ks={s: self._need[s] for s in shards})
        q = self._ctx.Queue(maxsize=2 * len(shards) + 2)
        p = self._ctx.Process(target=_worker_main, args=(payload, q),
                              daemon=True, name=f"dtf-data-worker-{w}")
        # a spawned child takes its environment from os.environ at
        # start: set the readers' own for the start only, so the child
        # never sees a card, even while it imports the parent's main
        # module (which may import torch)
        with _env_lock:
            saved = {k: os.environ.get(k) for k in _WORKER_ENV}
            os.environ.update(_WORKER_ENV)
            try:
                p.start()
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        # the parent only reads: with its copy of the pipe's write end
        # closed, a reader killed half-way through writing a batch ends
        # the parent's read with EOFError (and a respawn) instead of
        # leaving it waiting forever for the rest of the message
        q._writer.close()
        self._procs[w] = p
        self._queues[w] = q

    def _respawn(self, w: int, reason: str) -> None:
        self.respawns += 1
        self._respawn_counter.inc()
        if self.respawns > self.MAX_RESPAWNS:
            raise RuntimeError(
                f"data-service worker {w} died {self.respawns} times "
                f"(last: {reason}) — exceeding the respawn budget; the "
                f"reader is failing deterministically")
        p = self._procs[w]
        exitcode = getattr(p, "exitcode", None)
        shards = self._worker_shards(w)
        # drop the dead worker's buffered batches: the respawned worker
        # recomputes them identically from its recorded positions, and
        # a half-delivered queue must not leave gaps behind kept items
        for key in [key for key in self._buf if key[0] in shards]:
            del self._buf[key]
        try:
            p.kill()
        except Exception:  # noqa: BLE001 — already dead
            pass
        p.join(timeout=5.0)
        q = self._queues[w]
        try:
            q.close()
            q.cancel_join_thread()
        except Exception:  # noqa: BLE001
            pass
        log.warning("data service: worker %d died (%s, exit %s) — "
                    "respawning at positions %s", w, reason, exitcode,
                    {s: self._need[s] for s in shards})
        trace.event("reader_respawn", worker=w, exitcode=exitcode,
                    reason=reason, positions=[self._need[s]
                                              for s in shards])
        # the restart decision, with its data positions, lands in the
        # launcher's supervisor_events.jsonl: the post-mortem view of
        # "worker 2 died at shard 3 batch 17" next to the supervisor's
        # rank-level restart records
        _supervisor_event(
            "reader_crash", worker=w, exitcode=exitcode, reason=reason,
            respawns=self.respawns,
            shard_positions={str(s): int(self._need[s]) for s in shards})
        self._spawn(w)

    # -- merged stream --------------------------------------------------
    def _fetch_pooled(self, s: int, k: int):
        w = self._owner[s]
        while True:
            # dtflint: disable=lock-guard (the monotonic latch, as in
            # __next__): a close() from another thread -- the runner's,
            # while a prefetch thread waits here -- ends the wait
            # instead of respawning the workers it terminated
            if self._closed:
                raise StopIteration
            item = self._buf.pop((s, k), None)
            if item is not None:
                return item
            try:
                got = self._queues[w].get(timeout=self.GET_TIMEOUT_S)
            except queue_mod.Empty:
                p = self._procs[w]
                # dtflint: disable=lock-guard (the monotonic latch)
                if not p.is_alive() and not self._closed:
                    self._respawn(w, "worker process dead")
                continue
            except Exception as e:  # noqa: BLE001 — torn pickle mid-kill
                # dtflint: disable=lock-guard (the monotonic latch)
                if not self._closed:
                    self._respawn(w, f"queue read failed: {e!r}")
                continue
            if got[0] == _ERROR:
                # a reader exception is deterministic (corrupt shard,
                # bad config) — respawning would fail identically
                raise RuntimeError(
                    f"data-service worker {w} failed: {got[1]}\n{got[2]}")
            gs, gk, images, labels, hits, lookups = got
            self._cache_stats[gs] = (hits, lookups)
            if gk < self._need[gs]:
                continue  # stale duplicate from a pre-respawn overlap
            self._buf[(gs, gk)] = (images, labels)

    def __iter__(self):
        return self

    def __next__(self):
        # dtflint: disable=lock-guard (monotonic latch: a racy read
        # costs at most one extra batch before StopIteration; taking
        # _close_lock per batch would put a lock on the data hot path)
        if self._closed:
            raise StopIteration
        n = self._n
        s = n % self.num_shards
        k = n // self.num_shards
        if chaos.reader_crash(n):
            # kill the owning shard worker AS the consumer reaches this
            # batch — the supervisor respawn above must make the fault
            # invisible to the stream
            if self.num_workers:
                self._procs[self._owner[s]].kill()
            else:
                log.warning("chaos reader_crash@batch:%d ignored: the "
                            "inline reader has no worker process", n)
        t0 = time.perf_counter()
        if self.num_workers == 0:
            images, labels = self._readers[s].batch(k)
            self._cache_stats[s] = self._readers[s].cache_stats()
        else:
            images, labels = self._fetch_pooled(s, k)
        lag = time.perf_counter() - t0
        self._lag_gauge.set(lag)
        self._lag_watchdog.observe(n, lag)
        hits = sum(h for h, _ in self._cache_stats.values())
        lookups = sum(lk for _, lk in self._cache_stats.values())
        if lookups:
            self._hit_gauge.set(hits / lookups)
        self._n = n + 1
        self._need[s] = k + 1
        return images, labels

    @property
    def position(self) -> int:
        """Next merged batch index (== the global step the next batch
        feeds, for a stream built with input_fn(start_step=step))."""
        return self._n

    def cache_stats(self) -> Tuple[int, int]:
        """Cumulative (hits, lookups) across every shard since the
        stream was built — snapshot before/after a window to get a
        windowed ratio (the bench does)."""
        return (sum(h for h, _ in self._cache_stats.values()),
                sum(lk for _, lk in self._cache_stats.values()))

    def cache_hit_ratio(self) -> float:
        """Lifetime hit ratio (the ``data_cache_hit_ratio`` gauge):
        cold-start misses included, so a warm steady state converges
        toward 1.0 from below."""
        hits, lookups = self.cache_stats()
        return hits / lookups if lookups else 0.0

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        if self.num_workers == 0:
            for r in self._readers.values():
                r.close()
        else:
            for p in self._procs:
                if p is not None:
                    try:
                        p.terminate()
                    except Exception:  # noqa: BLE001
                        pass
            for p in self._procs:
                if p is not None:
                    p.join(timeout=5.0)
                    if p.is_alive():
                        p.kill()
                        p.join(timeout=5.0)
            for q in self._queues:
                if q is not None:
                    try:
                        q.close()
                        q.cancel_join_thread()
                    except Exception:  # noqa: BLE001
                        pass
            atexit.unregister(self.close)


def service_input_fn(data_dir: str, batch_size: int, *, seed: int = 0,
                     num_shards: int = 1, num_workers: int = 0,
                     process_id: int = 0, process_count: int = 1,
                     wire: str = "uint8", cache_dir: str = "",
                     cache_limit_mb: int = 0,
                     start_step: int = 0) -> ServiceStream:
    """The data-service TRAIN input_fn (imagenet): a ServiceStream
    yielding (images, labels) host batches, position-deterministic and
    resumable via ``start_step`` (bit-exact).  Eval stays on
    data/imagenet.py — it is one ordered pass
    with no augmentation, so there is nothing to make deterministic."""
    return ServiceStream(
        data_dir, batch_size, seed=seed, num_shards=num_shards,
        num_workers=num_workers, process_id=process_id,
        process_count=process_count, wire=wire, cache_dir=cache_dir,
        cache_limit_bytes=int(cache_limit_mb) << 20,
        start_step=start_step)
