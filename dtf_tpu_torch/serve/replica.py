"""Replica-side serve server: one ServeEngine behind a TCP socket.  A
copy of ``dtf_tpu/serve/replica.py``: the wire, the announce file and
the fencing epoch are the JAX package's, byte for byte, so a router of
either package drives a replica of either.

The serving replica tier (serve/router.py) is N of these processes
behind a router.  Each replica owns a full :class:`ServeEngine`
(optionally TP-sharded — the engine doesn't know it's a replica) and
speaks a newline-delimited-JSON wire protocol over TCP:

  router → replica
    {"op":"submit","id":W,"prompt":[...],"max_new_tokens":N,
     "temperature":T,"eos_id":E,"rng_seed":S,
     "trace":TID,"pspan":SID}           dispatch one request; "trace"
                                        is the router-minted
                                        distributed-trace id and
                                        "pspan" the router-side
                                        request span id — the engine
                                        tags every per-request record
                                        with them, so one request's
                                        life is reconstructable across
                                        processes (trace_main
                                        --request TID); "rng_seed"
                                        pins the request's SAMPLING
                                        identity (a re-dispatch ships
                                        the same seed, so sampled
                                        requests replay token-exactly
                                        — greedy's failover contract,
                                        extended)
    {"op":"cancel","id":W}              stop working on request W: the
                                        engine frees its slot + pages
                                        at the next iteration instead
                                        of decoding an answer the
                                        router already stopped wanting
                                        (deadline, failover, losing
                                        hedge)
    {"op":"drain"}                      stop admissions, finish in-flight
    {"op":"stop","epoch":E}             the port's own op: drain and exit
                                        (a replica_main process), sent
                                        only by a router that adopted
                                        this replica and cannot signal
                                        it (another host); refused
                                        without an epoch, and fenced
                                        like every controller op
    {"op":"stats"}                      request a stats snapshot
    {"op":"reset_measurement"}          zero decode-gap/peak stats
                                        (warmup exclusion)
    {"op":"migrate_in","xfer":X,"host":H,"port":P,"prompt":[...]}
                                        pull this prompt's KV page
                                        chain from the replica at H:P
                                        and import it locally (the
                                        router re-homing a finished
                                        chain onto a decode replica —
                                        serve/migrate.py)
    {"op":"reattach","id":W}            a SUCCESSOR router re-adopting
                                        request W across a router
                                        death: the replica replays W's
                                        retained token tail (i=0..)
                                        and its done record on THIS
                                        connection — the engine never
                                        stopped decoding while the old
                                        router's socket was down.
                                        Unknown W → ``reattach_nack``
                                        (the request died with this
                                        replica; the router falls back
                                        to ordinary budgeted failover)

  Every CONTROLLER op may carry ``"epoch": E`` — the sender's fencing
  epoch from the shared leader lease (serve/ha.py).  The replica
  tracks the highest epoch it has seen and REJECTS ops from below it
  with ``{"op":"stale_epoch",...}``: a deposed router that never
  noticed losing the lease (GC pause, partition) is fenced out here,
  at the only place split-brain could corrupt a client stream.  Ops
  without an epoch (peer page_fetch, pre-HA routers) skip the check.

  peer replica (or router) → replica           KV-page migration
    {"op":"page_fetch","xfer":X,"prompt":[...],"lo":L,"n":N}
                                        serve window [L, L+N) of the
                                        prompt's page chain; the first
                                        fetch takes a migration hold
                                        on the whole chain
    {"op":"page_fetch","xfer":X,"release":true}   drop the hold

  replica → router
    {"op":"token","id":W,"token":T,"i":I}   token I of request W retired
    {"op":"done","id":W,"tokens":[...],...} request W finished
    {"op":"backpressure","id":W,"retry_after":S}  engine shed it
    {"op":"error","id":W,"error":MSG}       engine rejected it
    {"op":"stats",...}                      stats snapshot
    {"op":"migrated","xfer":X,"ok":B,"pages":N,...}  migrate_in result

  replica → peer replica
    {"op":"page_push","xfer":X,"depth":D,"digest":C,"tokens":[...],
     "payload":{...},"chain_len":L}     one chain page (+ end-of-
                                        window / error markers —
                                        serve/migrate.py has the full
                                        grammar and the verification
                                        contract)

RENDEZVOUS is file-based, deliberately: the replica binds an EPHEMERAL
port (no port-allocation coordination, no TOCTOU between picking and
binding) and atomically writes ``replica_rank{K}.json`` — {"host",
"port", "pid", "generation", "ts"} — into the shared rendezvous
directory.  The router polls that file to (re)connect, so a RESPAWNED
replica re-registers by construction: new process, new port, new
announce content, same path.  The rendezvous directory is the tier's
only shared-state requirement: put it on shared storage (NFS/GCS-fuse)
and bind replicas to a routable address (``--serve_host``), and
replicas on OTHER HOSTS register, heartbeat, and heal identically to
local ones — the announce carries ``host:port``, and the wire is
already plain TCP.  Liveness travels separately, through the obs
heartbeat files (``heartbeat_rank{K}.json``) the engine rewrites every
iteration — the router's health probe reads those, never the socket,
so a wedged replica with a healthy TCP stack still reads as dead.

The engine is duck-typed (``submit``/``begin_drain``/``outstanding``):
tests drive the full wire protocol against a deterministic fake engine
with no model in the process, and the subprocess entry
(cli/replica_main.py) passes the real thing.
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
import socket
import threading
import time
from typing import Callable, Optional

import numpy as np

from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.serve import migrate
from dtf_tpu_torch.serve.engine import Backpressure

log = logging.getLogger("dtf_tpu_torch")

# retained per-request tails kept after their request finished: enough
# for a takeover-window's worth of re-adoptions, bounded so a
# long-lived replica's memory does not grow with total traffic
RETAIN_DONE_CAP = 256


def announce_path(rendezvous_dir: str, replica_id: int) -> str:
    return os.path.join(rendezvous_dir, f"replica_rank{replica_id}.json")


def read_announce(rendezvous_dir: str, replica_id: int) -> Optional[dict]:
    """Parse a replica's announce file; None when missing/torn (the
    router treats that as 'not yet registered', not as an error)."""
    try:
        with open(announce_path(rendezvous_dir, replica_id)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def send_msg(wfile, lock: threading.Lock, obj: dict) -> None:
    """One JSON line, atomically w.r.t. other senders on this socket."""
    data = (json.dumps(obj) + "\n").encode()
    with lock:
        wfile.write(data)
        wfile.flush()


class ReplicaServer:
    """Serve one engine over a loopback socket + announce file.

    ``engine`` needs ``submit(prompt, max_new_tokens, temperature,
    eos_id, on_token, trace_id, trace_parent) -> handle`` (handle:
    ``result(timeout)`` → object with ``.tokens``/``.cancelled``),
    ``begin_drain()`` and ``outstanding``;
    :class:`~dtf_tpu_torch.serve.engine.ServeEngine` satisfies it, and
    the router tests use a model-free fake.

    LOCK DISCIPLINE: ``_conns`` is shared by the accept loop, every
    per-connection thread's teardown, and ``stop()`` — guarded by
    ``_lock`` (declared in ``_GUARDED_BY`` below):
    an unguarded ``list.remove`` racing another teardown throws
    ValueError into the connection thread's finally block.  The same
    lock guards ``_retained`` (the per-request token tails a successor
    router re-adopts — written by engine on_token callbacks, rebound
    by ``reattach`` on a DIFFERENT connection's wire thread) and
    ``_max_epoch`` (the fencing high-water mark every controller wire
    thread checks)."""

    _GUARDED_BY = {"_conns": "_lock", "_retained": "_lock",
                   "_max_epoch": "_lock"}

    def __init__(self, engine, replica_id: int, rendezvous_dir: str,
                 host: str = "127.0.0.1", port: int = 0,
                 result_timeout_s: float = 600.0,
                 announce_host: Optional[str] = None,
                 on_stop: Optional[Callable[[], None]] = None):
        self.engine = engine
        # what an epoch-fenced {"op": "stop"} does (replica_main: what
        # its SIGTERM does); None refuses the op
        self.on_stop = on_stop
        self.replica_id = int(replica_id)
        self.rendezvous_dir = os.path.abspath(rendezvous_dir)
        self.result_timeout_s = float(result_timeout_s)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(8)
        self.port = self._listener.getsockname()[1]
        # the endpoint the ROUTER dials: the bind address, unless that
        # is a wildcard (0.0.0.0 accepts from anywhere but is not
        # dialable) — then the caller must name the routable address
        self.host = announce_host or (
            "127.0.0.1" if host in ("", "0.0.0.0") else host)
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._conns: list = []
        # wire id -> {"tokens": [...], "done": msg|None, "outq": q|None}
        # — the request's retained tail.  Survives the CONNECTION (a
        # router death must not lose tokens the engine keeps retiring);
        # ``reattach`` rebinds "outq" to the successor's connection.
        # Done entries are pruned beyond RETAIN_DONE_CAP, oldest first.
        self._retained: dict = {}
        # fencing epoch high-water mark (serve/ha.py): controller ops
        # carrying an epoch below this are rejected as stale
        self._max_epoch = 0

    # -- rendezvous ----------------------------------------------------
    def _announce(self) -> None:
        os.makedirs(self.rendezvous_dir, exist_ok=True)
        payload = {
            "host": self.host,
            "port": self.port,
            "pid": os.getpid(),
            "generation": int(os.environ.get("DTF_RESTART_GENERATION",
                                             "0")),
            # the rollout's checkpoint override this process serves
            # ("" = the flag-configured one): a successor router that
            # resumes a rollout tells a replica already on the new
            # checkpoint from one its dead predecessor only drained
            "checkpoint": os.environ.get("DTF_SERVE_CHECKPOINT", ""),
            "ts": time.time(),
        }
        path = announce_path(self.rendezvous_dir, self.replica_id)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)   # atomic: the router never reads a torn file

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ReplicaServer":
        self._announce()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"replica{self.replica_id}-accept")
        self._accept_thread.start()
        log.info("replica %d: serving on %s:%d (rendezvous %s)",
                 self.replica_id, self.host, self.port,
                 self.rendezvous_dir)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # shutdown BEFORE close: close() alone does not unblock a
            # thread sitting in accept(2) — the syscall keeps the
            # kernel socket referenced, so the "closed" listener keeps
            # accepting and a router dialing a dead in-process replica
            # reaches a ghost.  shutdown() aborts the accept.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- connection handling -------------------------------------------
    def _accept_loop(self) -> None:
        # multiple concurrent connections are allowed: after a
        # partition the router reconnects while its old (half-dead)
        # connection may still exist — responses go to the connection
        # their submit arrived on, and writes to a closed one are
        # dropped (the router re-dispatched those requests anyway)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name=f"replica{self.replica_id}-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        wfile = conn.makefile("wb")
        outq: "queue_mod.Queue" = queue_mod.Queue()
        dead = threading.Event()
        wlock = threading.Lock()

        def writer():
            while True:
                item = outq.get()
                if item is None:
                    return
                try:
                    send_msg(wfile, wlock, item)
                except (OSError, ValueError):
                    # router gone (or going): stop queuing work for a
                    # dead pipe; in-flight engine work keeps running —
                    # the router re-dispatches what it still wants
                    dead.set()
                    return

        wthread = threading.Thread(
            target=writer, daemon=True,
            name=f"replica{self.replica_id}-writer")
        wthread.start()
        # wire id -> engine handle, for CANCEL routing (per connection:
        # a reconnected router's cancels can only name work it
        # dispatched on THIS connection; entries die with the request)
        handles: dict = {}
        # xfer id -> in-flight chain export (pages under migration
        # hold).  Per connection, so a client that vanishes releases
        # its holds in the finally below — a dead peer cannot pin
        # pages forever
        exports: dict = {}
        try:
            for line in rfile:
                if self._stop.is_set():
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    log.warning("replica %d: bad wire line %r",
                                self.replica_id, line[:80])
                    continue
                op = msg.get("op")
                ep = msg.get("epoch")
                if ep is not None:
                    ep = int(ep)
                    with self._lock:
                        cur = self._max_epoch
                        if ep >= cur:
                            self._max_epoch = ep
                    if ep < cur:
                        # fenced controller: a deposed router that
                        # never noticed losing the lease.  Reject the
                        # op LOUDLY — obeying it is exactly the
                        # split-brain a fencing epoch exists to stop.
                        log.error("replica %d: rejecting stale-epoch "
                                  "op %r (epoch %d < %d)",
                                  self.replica_id, op, ep, cur)
                        trace.anomaly("stale_epoch", op=op, epoch=ep,
                                      current=cur,
                                      wire_id=msg.get("id"))
                        outq.put({"op": "stale_epoch",
                                  "id": msg.get("id"), "epoch": ep,
                                  "current": cur})
                        continue
                if op == "submit":
                    self._handle_submit(msg, outq, dead, handles)
                elif op == "reattach":
                    self._handle_reattach(msg, outq)
                elif op == "cancel":
                    h = handles.pop(msg.get("id"), None)
                    if h is not None and hasattr(h, "cancel"):
                        h.cancel()
                elif op == "drain":
                    self.engine.begin_drain()
                elif op == "stop":
                    self._handle_stop(ep, outq)
                elif op == "stats":
                    stats = self._stats()
                    stats["tag"] = msg.get("tag", "")
                    outq.put(stats)
                elif op == "reset_measurement":
                    if hasattr(self.engine, "reset_measurement"):
                        self.engine.reset_measurement()
                elif op == "page_fetch":
                    self._handle_page_fetch(msg, outq, exports)
                elif op == "migrate_in":
                    # own thread: fetch_chain blocks on the peer's
                    # socket + engine jobs, and this wire loop must
                    # keep serving submits/cancels meanwhile
                    threading.Thread(
                        target=self._handle_migrate_in,
                        args=(msg, outq), daemon=True,
                        name=f"replica{self.replica_id}-migrate").start()
                else:
                    log.warning("replica %d: unknown op %r",
                                self.replica_id, op)
        except OSError:
            pass
        finally:
            for st in exports.values():
                # the peer vanished mid-transfer: its migration holds
                # die with the connection
                try:
                    self.engine.export_chain_end(st["pages"])
                except Exception:  # noqa: BLE001 — teardown must not
                    # raise into the accept machinery
                    log.exception("replica %d: export-hold release "
                                  "failed", self.replica_id)
            dead.set()
            outq.put(None)
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                # unbind this connection's queue from the retained
                # tails: the engine keeps decoding (and retaining) —
                # deliveries resume when a successor reattaches
                for rec in self._retained.values():
                    if rec["outq"] is outq:
                        rec["outq"] = None

    def _stats(self) -> dict:
        out = {"op": "stats", "replica": self.replica_id,
               "outstanding": int(getattr(self.engine, "outstanding", 0)),
               "pid": os.getpid()}
        metrics = getattr(self.engine, "metrics", None)
        if metrics is not None:
            for name in ("serve_completed_total", "serve_shed_total",
                         "serve_prefix_hit_pages_total",
                         "serve_prefix_cow_total",
                         "serve_pages_exported_total",
                         "serve_pages_imported_total",
                         "serve_migration_torn_total",
                         "serve_prefill_chunks_total"):
                m = metrics.get(name)
                if m is not None:
                    out[name] = m.value
            gap = metrics.get("serve_decode_gap_s")
            if gap is not None:
                # per-replica decode-gap tail: the pool-role
                # comparison number (a disaggregated-vs-colocated
                # comparison reads it over the wire)
                out["serve_decode_gap_p99"] = gap.percentile(99.0)
                out["serve_decode_gap_count"] = gap.count
        return out

    # -- KV-page migration (serve/migrate.py) --------------------------
    def _handle_stop(self, epoch: Optional[int], outq) -> None:
        """An adopting router's stop (its epoch already passed the
        fence): drain and exit, as SIGTERM does.  Without an epoch, or
        with no stop action here, it is refused."""
        if epoch is None or self.on_stop is None:
            log.error("replica %d: refusing stop (epoch %s, %s)",
                      self.replica_id, epoch,
                      "no stop action" if self.on_stop is None
                      else "unfenced")
            outq.put({"op": "error", "id": None,
                      "error": "stop refused: it needs a fencing epoch "
                               "and a replica process to end"})
            return
        log.warning("replica %d: stop from the router of epoch %d",
                    self.replica_id, epoch)
        trace.event("replica_stop", replica=self.replica_id, epoch=epoch)
        self.on_stop()

    def _handle_page_fetch(self, msg: dict, outq, exports: dict) -> None:
        """Serve one window of a chain export — or release the hold.
        Runs on the wire thread; the engine methods marshal their pool/
        cache work onto the engine thread internally."""
        xfer = msg.get("xfer")
        if msg.get("release"):
            st = exports.pop(xfer, None)
            if st is not None:
                try:
                    self.engine.export_chain_end(st["pages"])
                except Exception as e:  # noqa: BLE001 — a release race
                    # with engine stop is the peer's teardown, not ours
                    log.warning("replica %d: export release failed: %s",
                                self.replica_id, e)
            return
        if not hasattr(self.engine, "export_chain_begin"):
            outq.put({"op": "page_push", "xfer": xfer,
                      "error": "replica does not serve page migration"})
            return
        st = exports.get(xfer)
        if st is None:
            prompt = np.asarray(msg.get("prompt", ()), np.int32)
            try:
                pages, digests = self.engine.export_chain_begin(prompt)
            except Exception as e:  # noqa: BLE001 — the peer gets the
                # failure, the wire loop keeps serving
                outq.put({"op": "page_push", "xfer": xfer,
                          "error": str(e)})
                return
            st = exports[xfer] = {"pages": pages, "digests": digests,
                                  "prompt": prompt}
        lo = max(0, int(msg.get("lo", 0)))
        n = max(0, int(msg.get("n", migrate.DEFAULT_WINDOW)))
        chain_len = len(st["pages"])
        hi = min(lo + n, chain_len)
        try:
            windows = (self.engine.export_chain_read(st["pages"], lo,
                                                     hi - lo)
                       if hi > lo else [])
        except Exception as e:  # noqa: BLE001
            outq.put({"op": "page_push", "xfer": xfer, "error": str(e)})
            return
        ps = int(getattr(self.engine, "page_size", 0) or 0)
        for k, leaves in enumerate(windows):
            d = lo + k
            outq.put({
                "op": "page_push", "xfer": xfer, "depth": d,
                "digest": st["digests"][d],
                "tokens": [int(t) for t in
                           st["prompt"][d * ps:(d + 1) * ps]],
                "payload": migrate.encode_page(leaves),
                "chain_len": chain_len,
            })
        outq.put({"op": "page_push", "xfer": xfer, "end": True,
                  "lo": lo, "sent": hi - lo, "chain_len": chain_len})

    def _handle_migrate_in(self, msg: dict, outq) -> None:
        """Pull a chain from a peer replica and import it (the decode-
        replica side of a router-commanded re-homing)."""
        xfer = msg.get("xfer")
        if not hasattr(self.engine, "import_chain"):
            outq.put({"op": "migrated", "xfer": xfer, "ok": False,
                      "pages": 0,
                      "error": "replica does not import pages"})
            return
        try:
            stats = migrate.fetch_chain(
                self.engine, msg["host"], int(msg["port"]),
                np.asarray(msg.get("prompt", ()), np.int32))
        except Exception as e:  # noqa: BLE001 — migration failure is
            # an efficiency loss, never a correctness event: the
            # router keeps routing this prefix wherever it lives
            log.error("replica %d: migrate_in failed: %s",
                      self.replica_id, e)
            outq.put({"op": "migrated", "xfer": xfer, "ok": False,
                      "pages": 0, "error": str(e)})
            return
        outq.put({"op": "migrated", "xfer": xfer, "ok": True, **stats})

    def _handle_submit(self, msg: dict, outq, dead: threading.Event,
                       handles: dict):
        wire_id = msg["id"]
        with self._lock:
            # the request's retained tail: tokens append here FIRST
            # (under the lock reattach replays under), then go to
            # whatever connection the record is currently bound to —
            # a router death loses the pipe, never the tokens
            rec = self._retained[wire_id] = {
                "tokens": [], "done": None, "outq": outq,
                "ts": time.time()}

        def on_token(tok: int) -> None:
            # engine thread: per-request tokens retire sequentially;
            # the lock orders each append against any concurrent
            # reattach replay, so indices never interleave on the wire
            with self._lock:
                rec["tokens"].append(int(tok))
                i = len(rec["tokens"]) - 1
                q = rec["outq"]
            if q is not None and not (q is outq and dead.is_set()):
                q.put({"op": "token", "id": wire_id, "token": int(tok),
                       "i": i})

        try:
            handle = self.engine.submit(
                np.asarray(msg["prompt"], np.int32),
                max_new_tokens=int(msg.get("max_new_tokens", 32)),
                temperature=float(msg.get("temperature", 0.0)),
                eos_id=msg.get("eos_id"),
                on_token=on_token,
                # distributed span context: the router's trace id and
                # request span id ride the wire so this replica's
                # records join the request's cross-process timeline —
                # including a failover replay, which arrives with the
                # SAME trace id on a sibling
                trace_id=msg.get("trace"),
                trace_parent=msg.get("pspan"),
                # the request's wire-carried sampling identity: a
                # failover replay with the same seed samples the same
                # tokens (serve/decode.py position_key)
                rng_seed=msg.get("rng_seed"))
        except Backpressure as bp:
            # never admitted: nothing to retain — a successor must
            # re-dispatch, not reattach to a shed request
            with self._lock:
                self._retained.pop(wire_id, None)
            outq.put({"op": "backpressure", "id": wire_id,
                      "retry_after": float(bp.retry_after)})
            return
        except Exception as e:  # noqa: BLE001 — a malformed request
            # must fail ITS caller, never the wire loop
            with self._lock:
                self._retained.pop(wire_id, None)
            outq.put({"op": "error", "id": wire_id, "error": str(e)})
            return
        handles[wire_id] = handle

        def waiter():
            try:
                r = handle.result(timeout=self.result_timeout_s)
            except Exception as e:  # noqa: BLE001
                handles.pop(wire_id, None)
                with self._lock:
                    self._retained.pop(wire_id, None)
                outq.put({"op": "error", "id": wire_id, "error": str(e)})
                return
            handles.pop(wire_id, None)
            done = {"op": "done", "id": wire_id,
                    "tokens": [int(t) for t in r.tokens],
                    "cancelled": bool(r.cancelled),
                    "prompt_len": int(r.prompt_len),
                    "latency_s": float(r.latency_s)}
            with self._lock:
                rec["done"] = done
                q = rec["outq"]
                self._prune_retained_locked()
            if q is not None and not (q is outq and dead.is_set()):
                q.put(done)

        threading.Thread(target=waiter, daemon=True,
                         name=f"replica{self.replica_id}-wait").start()

    def _prune_retained_locked(self) -> None:
        """Bound the retained-tail store: finished requests beyond
        RETAIN_DONE_CAP drop, oldest first (unfinished ones are live
        engine work and stay — they are the re-adoption payload)."""
        done = [(rec["ts"], wid) for wid, rec in self._retained.items()
                if rec["done"] is not None]
        if len(done) <= RETAIN_DONE_CAP:
            return
        done.sort()
        for _, wid in done[:len(done) - RETAIN_DONE_CAP]:
            self._retained.pop(wid, None)

    def _handle_reattach(self, msg: dict, outq) -> None:
        """A successor router re-adopting one request (router HA,
        serve/ha.py): rebind the retained record to THIS connection
        and replay its buffered tail — ack, every token from i=0 (the
        router's token-index dedupe verifies what its client already
        has and emits only the rest), then the done record if the
        engine already finished.  All under the lock on_token appends
        under, so replayed and live indices never interleave."""
        wire_id = msg.get("id")
        with self._lock:
            rec = self._retained.get(wire_id)
            if rec is not None:
                outq.put({"op": "reattached", "id": wire_id,
                          "n": len(rec["tokens"]),
                          "done": rec["done"] is not None})
                for i, t in enumerate(rec["tokens"]):
                    outq.put({"op": "token", "id": wire_id,
                              "token": int(t), "i": i})
                if rec["done"] is not None:
                    outq.put(dict(rec["done"]))
                rec["outq"] = outq
        if rec is None:
            # the request died WITH this replica (it was respawned, or
            # never held it): the router falls back to ordinary
            # budgeted failover re-dispatch
            outq.put({"op": "reattach_nack", "id": wire_id})
