"""Asynchronous parameter-server training (``--distribution_strategy
parameter_server --ps_mode async``): the port of
``dtf_tpu/parallel/ps.py``.

The reference's PS path (SURVEY §3.4): rank 0 hosts the variables and
serves push/pull forever; N workers each run an independent
``model.fit`` with ``steps_per_epoch = train_steps // N``, pulling
parameters and pushing gradients every step with **no inter-worker
synchronization**.  Here, as in the JAX package, a parameter store
(``native/ps_store.cpp``, bound by ``native/ps.py``; the Python store
below where it cannot be built) holds the flat parameter vector and the
Keras-SGD momentum (``v = m·v − lr·g; p += v``, f32), and each worker
process runs its own forward and backward on its own card, exchanging
flat f32 (or bf16-wire) buffers with the store over TCP.

Everything but :func:`_worker` is the JAX module's framework-free code
with its imports pointed at the port: the wire protocol and both stores,
the bf16 wire rule, the snapshot format with its done-count footer and
restart-generation sidecar, the client's reconnects and reseed guard,
and :func:`run_async`'s role dispatch.  The stores, snapshots and
clients of the two packages interoperate: the flat vector is the JAX
package's ``ravel_pytree(params)[0]`` (``convert.py`` ``to_wire``).
The port's library is built from its own hash-named source, so the JAX
package's degraded paths for a stale ``libdtf_native.so`` have no
counterpart here.  Two additions: ``PsClient.pull(out=...)`` receives
into a caller's buffer (a pinned host tensor on CUDA) and ``push``
sends a buffer without joining it to its header, so a float32 step
costs one host copy each way; and the PS rank beats the launcher's
heartbeat while it serves (the JAX PS rank never beats, so a
``--heartbeat_timeout`` supervisor judges it hung once its log stops
growing).

Rank mapping matches the reference deployment: process_id 0 is the PS,
1..N are workers 0..N-1.  The PS rank never touches CUDA.
"""

from __future__ import annotations

import ctypes
import logging
import os
import socket
import struct
import threading
import time
from typing import Optional, Tuple

import numpy as np

from dtf_tpu_torch import chaos
from dtf_tpu_torch.native import ps as native_ps
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.registry import default_registry

log = logging.getLogger("dtf_tpu_torch")

(OP_INIT, OP_PULL, OP_PUSH, OP_INFO, OP_DONE, OP_SHUTDOWN,
 OP_PULL16, OP_PUSH16) = 1, 2, 3, 4, 5, 6, 7, 8

_U16P = ctypes.POINTER(ctypes.c_uint16)
_F32P = ctypes.POINTER(ctypes.c_float)


def _f32_to_bf16(a: np.ndarray, out: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 as u16.  NaNs are preserved
    explicitly (truncate + force the quiet bit): the RNE add can carry
    a low-mantissa NaN payload into Inf or even wrap to zero, silently
    masking a diverged gradient.  One native pass when the store's
    library is built; the numpy form below is bit-identical."""
    a = np.ascontiguousarray(a, np.float32)
    lib = native_ps.load()
    if lib is None:
        r = f32_to_bf16_plain(a)
        if out is None:
            return r
        out[...] = r
        return out
    if out is None:
        out = np.empty(a.shape, np.uint16)
    lib.dtf_f32_to_bf16(a.ctypes.data_as(_F32P),
                        out.ctypes.data_as(_U16P), a.size)
    return out


def f32_to_bf16_plain(a: np.ndarray) -> np.ndarray:
    """The bf16 wire rule in numpy, as the JAX package writes it (the
    plain version the native conversion is held to)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
         >> np.uint32(16)).astype(np.uint16)
    is_nan = ((u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)) \
        & ((u & np.uint32(0x007FFFFF)) != 0)
    nan_out = ((u >> np.uint32(16)).astype(np.uint16)
               | np.uint16(0x0040))
    return np.where(is_nan, nan_out, r).astype(np.uint16)


def _bf16_to_f32(src: np.ndarray, out: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """u16 bf16 -> f32 (exact: the bits shifted up)."""
    lib = native_ps.load()
    if out is None:
        out = np.empty(src.shape, np.float32)
    if lib is not None:
        src = np.ascontiguousarray(src, np.uint16)
        lib.dtf_bf16_to_f32(src.ctypes.data_as(_U16P),
                            out.ctypes.data_as(_F32P), src.size)
        return out
    out.view(np.uint32)[...] = src.astype(np.uint32) << np.uint32(16)
    return out


def _f32_to_bf16_bytes(a: np.ndarray) -> bytes:
    """The bf16 wire encoding of ``a``, as raw u16 little-endian."""
    return _f32_to_bf16(a).tobytes()


def _bf16_bytes_to_f32(b: bytes) -> np.ndarray:
    return _bf16_to_f32(np.frombuffer(b, np.uint16))


# Matches the C++ store's kMaxParams: a client-supplied count above this
# is a corrupt/hostile request, not a real model (4B f32 = 16 GiB).
MAX_PARAMS = 1 << 32


class ConnectionClosed(OSError):
    """The peer vanished mid-message — retryable, unlike a protocol
    rejection (ValueError), which is deterministic and must fail fast."""


# Snapshot file format (little-endian), byte-identical between the C++
# and Python stores (and the JAX package's): 8-byte magic, u64 version,
# u64 n, f32 params[n], f32 velocity[n], then an OPTIONAL footer —
# 8-byte footer magic + u64 done_count.  Written atomically (tmp +
# rename).  The footer carries the DONE tally so a PS restart after a
# worker has delivered DONE and exited cannot hang wait(num_workers) one
# short; restore accepts footer-less snapshots with done_count = 0.
SNAP_MAGIC = b"DTFPSNP1"
SNAP_FOOTER_MAGIC = b"DTFPSDN1"

# Restart-generation tag for the snapshot's done_count footer.  The
# done_count persistence exists for a PS-only crash (workers survive,
# reconnect, and their already-delivered DONEs must still count on the
# restarted store).  A WHOLE-JOB supervisor restart is different: every
# worker re-runs from the top and will deliver DONE again, so a
# restored tally from the previous attempt double-counts — the PS
# rank's wait(num_workers) returns early while re-run workers still
# push.  cli/launch.py exports DTF_RESTART_GENERATION (its attempt
# counter) to every rank; the snapshot loop tags each dump with the
# generation it was taken under (a sidecar next to the snapshot — the
# snapshot payload itself stays byte-compatible with both store
# builds), and a restore under a NEWER generation strips the done_count
# footer before handing the file to the store: params/velocity/version
# survive, the stale generation's DONE tally does not.
GENERATION_ENV = "DTF_RESTART_GENERATION"


def current_generation() -> int:
    """This process's restart generation (supervisor attempt number);
    0 when unsupervised or on the first attempt."""
    try:
        return int(os.environ.get(GENERATION_ENV, "0"))
    except ValueError:
        return 0


def _generation_sidecar(snap_path: str) -> str:
    return snap_path + ".gen"


def read_snapshot_generation(snap_path: str) -> int:
    """Generation a snapshot was taken under; 0 for sidecar-less
    snapshots (legacy semantics)."""
    try:
        with open(_generation_sidecar(snap_path)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0


def write_snapshot_generation(snap_path: str, generation: int) -> bool:
    """Atomically record the generation claim.  Returns False on a
    write failure — the caller must then SKIP the snapshot dump: a
    fresh snapshot under a stale sidecar is exactly the state a
    same-generation restore would wrongly strip."""
    path = _generation_sidecar(snap_path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write(str(int(generation)))
        os.replace(tmp, path)
    except OSError as e:
        log.warning("PS snapshot generation sidecar write failed: %s", e)
        return False
    return True


def strip_done_footer(snap_path: str) -> bool:
    """Rewrite a snapshot WITHOUT its done_count footer (both stores
    restore footer-less files with the tally at 0).  In place, atomic.
    Returns True when a footer was present and stripped; a malformed
    file is left untouched (restore will quarantine it)."""
    try:
        with open(snap_path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    if len(data) < 24 or data[:8] != SNAP_MAGIC:
        return False
    (n,) = struct.unpack("<Q", data[16:24])
    base = 24 + 8 * n
    if (len(data) != base + 16
            or data[base:base + 8] != SNAP_FOOTER_MAGIC):
        return False
    tmp = f"{snap_path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data[:base])
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, snap_path)
    except OSError as e:
        # a write failure (read-only dir, disk full) must not crash the
        # restarting PS rank — restore proceeds with the stale tally,
        # loudly (the lesser evil: early wait() return vs a crash loop)
        log.warning("PS snapshot: could not strip stale done_count "
                    "footer (%s) — restoring WITH the stale tally", e)
        return False
    return True


# Reconnect-reseed guard floor (see PsClient): with fewer than this
# many versions seen, a reconnecting worker may still re-seed an
# uninitialized restarted store — the legitimate pre-first-snapshot
# crash window is ~1 s of cluster pushes (the fast first dump), which
# this bounds generously.  Beyond it the tolerance scales with the
# versions actually seen, so a short run cannot silently discard its
# whole history just because it stayed under the static tolerance.
RESEED_ABS_FLOOR = 64

# The ONE copy of the reseed-guard default (config/flags.py keeps the
# same literal for --ps_reseed_tolerance, pinned by a test): how many
# store versions a restarted PS may trail what a worker already saw
# before the worker refuses to continue.  Size >= cluster pushes/sec x
# ps_snapshot_secs + margin.
DEFAULT_RESEED_TOLERANCE = 10_000


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class PsServer:
    """The native C++ parameter store.  Falls back to the pure-Python
    threaded store when the library cannot be built — same wire
    protocol, so clients can't tell."""

    def __init__(self, port: int = 0, momentum: float = 0.9,
                 defer_accept: bool = False):
        """``defer_accept``: bind + listen but queue connections in the
        listen backlog until begin_accept() — the restore-before-serve
        window that keeps a restarted PS's snapshot restore from racing
        early worker INITs."""
        lib = native_ps.load()
        self._native = None
        self._py: Optional[_PyPsServer] = None
        self._accepting = not defer_accept
        if lib is not None:
            start = (lib.dtf_ps_start_paused if defer_accept
                     else lib.dtf_ps_start)
            handle = start(port, momentum)
            if not handle:
                raise OSError(f"parameter store: cannot bind port {port}")
            self._native = (lib, handle)
            self.port = lib.dtf_ps_port(handle)
        else:
            self._py = _PyPsServer(port, momentum,
                                   defer_accept=defer_accept)
            self.port = self._py.port
        log.info("parameter store %s on port %d (ps_store: %s)",
                 "serving" if self._accepting else "bound (paused)",
                 self.port, self.store)

    @property
    def store(self) -> str:
        """``"native"`` or ``"python"``: which store serves."""
        return "native" if self._native else "python"

    def begin_accept(self) -> None:
        """Start serving queued + future connections (defer_accept)."""
        if self._accepting:
            return
        self._accepting = True
        if self._native:
            lib, handle = self._native
            lib.dtf_ps_begin_accept(handle)
        else:
            self._py.begin_accept()
        log.info("parameter store serving on port %d", self.port)

    def wait(self, n_done: int) -> None:
        """Block until n_done workers reported DONE (or SHUTDOWN)."""
        if self._native:
            lib, handle = self._native
            lib.dtf_ps_wait(handle, n_done)
        else:
            self._py.wait(n_done)

    def snapshot(self, path: str) -> None:
        """Atomic dump of params+velocity+version (the store's whole
        mutable state — the reference's PS held it in memory only and
        told users 'Workers will need to restart training' on a crash,
        ps_server/log1.log).  Raises on failure; ValueError when the
        store is not yet initialized."""
        if self._native:
            lib, handle = self._native
            rc = lib.dtf_ps_snapshot(handle, path.encode())
            if rc == -1:
                raise ValueError("snapshot: store not initialized")
            if rc != 0:
                raise OSError(f"snapshot to {path!r} failed (rc={rc})")
        else:
            self._py.snapshot(path)

    def restore(self, path: str) -> None:
        """Load a snapshot (marks the store initialized: workers'
        INITs then get already-initialized and pull the restored
        state instead of re-proposing)."""
        if self._native:
            lib, handle = self._native
            rc = lib.dtf_ps_restore(handle, path.encode())
            if rc == -1:
                raise FileNotFoundError(path)
            if rc != 0:
                raise OSError(f"restore from {path!r} failed: corrupt or "
                              f"truncated snapshot (rc={rc})")
        else:
            self._py.restore(path)

    def quiesce(self) -> None:
        """Stop taking pushes: no new connection, every live one shut
        down and its thread joined.  Every push acknowledged before it
        returns is in the state, which stays readable for a final
        :meth:`snapshot`; a push after it is refused, not acknowledged
        (the worker's reconnect path handles it)."""
        if self._native:
            lib, handle = self._native
            lib.dtf_ps_quiesce(handle)
        elif self._py:
            self._py.stop()

    def stop(self) -> None:
        if self._native:
            lib, handle = self._native
            lib.dtf_ps_stop(handle)
            self._native = None
        elif self._py:
            self._py.stop()
            self._py = None


class _PyPsServer:
    """Protocol-compatible fallback store (used when the C++ library is
    not built; also documents the protocol in Python)."""

    def __init__(self, port: int, momentum: float,
                 defer_accept: bool = False):
        self.momentum = momentum
        self.params: Optional[np.ndarray] = None
        self.velocity: Optional[np.ndarray] = None
        self.version = 0
        self.mu = threading.Lock()
        self.state = threading.Condition()
        self.done_count = 0
        self.stopping = False
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("0.0.0.0", port))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self._threads = []
        self._conns = []
        self._conns_mu = threading.Lock()
        self._accept = threading.Thread(target=self._accept_loop, daemon=True)
        if not defer_accept:
            self._accept.start()

    def begin_accept(self):
        self._accept.start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            with self._conns_mu:
                self._conns.append(conn)
                self._threads.append(t)
            t.start()

    def _apply(self, lr: float, g: np.ndarray) -> None:
        """Keras SGD under self.mu: v = m·v − lr·g; p += v."""
        self.velocity *= self.momentum
        self.velocity -= lr * g
        self.params += self.velocity
        self.version += 1

    def _serve(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                op = _recvn(conn, 1)
                if not op:
                    return
                op = op[0]
                if op == OP_INIT:
                    (n,) = struct.unpack("<Q", _recvn(conn, 8))
                    if n == 0 or n > MAX_PARAMS:
                        return
                    buf = np.frombuffer(_recvn(conn, 4 * n), np.float32)
                    with self.mu:
                        if self.params is None:
                            self.params = buf.copy()
                            self.velocity = np.zeros_like(self.params)
                            st = 0
                        else:
                            st = 1
                        conn.sendall(struct.pack("<BQQ", st, self.params.size,
                                                 self.version))
                elif op in (OP_PULL, OP_PULL16):
                    with self.mu:
                        if self.params is None:
                            conn.sendall(b"\x02")
                            continue
                        snap = (_f32_to_bf16_bytes(self.params)
                                if op == OP_PULL16 else self.params.tobytes())
                        hdr = struct.pack("<BQQ", 0, self.params.size,
                                          self.version)
                    conn.sendall(hdr + snap)
                elif op in (OP_PUSH, OP_PUSH16):
                    lr, n = struct.unpack("<fQ", _recvn(conn, 12))
                    if n == 0 or n > MAX_PARAMS:
                        return
                    if op == OP_PUSH16:
                        g = _bf16_bytes_to_f32(_recvn(conn, 2 * n))
                    else:
                        g = np.frombuffer(_recvn(conn, 4 * n), np.float32)
                    with self.mu:
                        if self.params is None or self.params.size != n:
                            conn.sendall(struct.pack("<BQ", 2, 0))
                            continue
                        self._apply(lr, g)
                        conn.sendall(struct.pack("<BQ", 0, self.version))
                elif op == OP_INFO:
                    with self.mu:
                        n = 0 if self.params is None else self.params.size
                        st = 2 if self.params is None else 0
                        conn.sendall(struct.pack("<BQQ", st, n, self.version))
                elif op == OP_DONE:
                    # ack before notifying: wait() returning triggers
                    # stop(), which tears down this connection
                    conn.sendall(b"\x00")
                    with self.state:
                        self.done_count += 1
                        self.state.notify_all()
                elif op == OP_SHUTDOWN:
                    with self.state:
                        self.stopping = True
                        self.state.notify_all()
                    conn.sendall(b"\x00")
                    return
                else:
                    return
        except (OSError, ValueError):
            return
        finally:
            with self._conns_mu:
                if conn in self._conns:
                    self._conns.remove(conn)
            conn.close()

    def wait(self, n_done: int):
        with self.state:
            self.state.wait_for(
                lambda: self.stopping or self.done_count >= n_done)

    def snapshot(self, path: str):
        """Same atomic dump + file format as dtf_ps_snapshot (the C++
        store) — either build restores the other's snapshot."""
        # done_count is read BEFORE the params copy: a DONE is only sent
        # after the worker's last push was acked, so any DONE counted
        # here is already reflected in the params we then copy — the
        # reverse order could persist a "done" worker whose final pushes
        # are missing from the saved state
        with self.state:
            done_count = self.done_count
        with self.mu:
            if self.params is None:
                raise ValueError("snapshot: store not initialized")
            params = self.params.copy()
            velocity = self.velocity.copy()
            version = self.version
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(SNAP_MAGIC)
            f.write(struct.pack("<QQ", version, params.size))
            f.write(params.astype("<f4", copy=False).tobytes())
            f.write(velocity.astype("<f4", copy=False).tobytes())
            f.write(SNAP_FOOTER_MAGIC)
            f.write(struct.pack("<Q", done_count))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def restore(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < 24 or data[:8] != SNAP_MAGIC:
            raise OSError(f"restore from {path!r} failed: bad magic")
        version, n = struct.unpack("<QQ", data[8:24])
        base = 24 + 8 * n
        if n == 0 or n > MAX_PARAMS or len(data) not in (base, base + 16):
            raise OSError(f"restore from {path!r} failed: corrupt or "
                          f"truncated snapshot")
        done_count = 0  # footer-less snapshots restore as 0
        if len(data) == base + 16:
            if data[base:base + 8] != SNAP_FOOTER_MAGIC:
                raise OSError(f"restore from {path!r} failed: corrupt "
                              f"footer")
            (done_count,) = struct.unpack("<Q", data[base + 8:base + 16])
        params = np.frombuffer(data, "<f4", count=n, offset=24).copy()
        velocity = np.frombuffer(data, "<f4", count=n,
                                 offset=24 + 4 * n).copy()
        with self.mu:
            self.params = params
            self.velocity = velocity
            self.version = version
        with self.state:
            self.done_count = int(done_count)
            self.state.notify_all()

    def stop(self):
        """Mirror the native dtf_ps_stop: stop accepting, tear down live
        connections, join serve threads — no push can land after stop."""
        with self.state:
            self.stopping = True
            self.state.notify_all()
        # shutdown() before close(): on Linux a thread blocked in
        # accept() is NOT woken by close() alone
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self._accept.ident is not None:  # may never have started
            self._accept.join(timeout=10)
        with self._conns_mu:
            conns = list(self._conns)
            threads = list(self._threads)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in threads:
            t.join(timeout=10)


def _recvn(conn: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = conn.recv(n)
        if not b:
            # OSError subclass: existing (ValueError, OSError) handlers
            # keep working, and PsClient._retrying can distinguish a
            # dead peer (retry) from a protocol rejection (fail fast)
            raise ConnectionClosed("connection closed mid-message")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_into(conn: socket.socket, buf: np.ndarray) -> None:
    """Fill ``buf`` (a contiguous array) from the socket, in place: the
    kernel copies straight into it."""
    view = memoryview(buf).cast("B")
    got = 0
    while got < len(view):
        k = conn.recv_into(view[got:])
        if not k:
            raise ConnectionClosed("connection closed mid-message")
        got += k


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class PsClient:
    """Worker-side connection to the parameter store.

    ``reconnect_timeout`` > 0 makes pull/push survive a PS crash: on a
    dead connection the client reconnects with exponential backoff
    until the deadline, then retries the whole operation against the
    restarted (snapshot-restored) store.  A push that died mid-flight
    may have already been applied, so a retried push can land twice —
    the usual HogWild/async-SGD consistency (duplicate gradient at a
    stale version), which this mode already accepts by design.  0
    disables (one failure raises).

    A restarted store may legitimately trail the versions this client
    saw by up to one snapshot interval of CLUSTER-WIDE pushes (the lost
    tail).  Beyond the tolerance (``--ps_reseed_tolerance``), the store
    has effectively LOST the run's state — continuing silently would
    train a mid-schedule LR against near-initial params, so the client
    raises instead."""

    def __init__(self, address: str, connect_timeout: float = 60.0,
                 reconnect_timeout: float = 0.0,
                 reseed_tolerance: int = DEFAULT_RESEED_TOLERANCE):
        host, _, port = address.rpartition(":")
        self.address = (host or "127.0.0.1", int(port))
        self.reconnect_timeout = reconnect_timeout
        self.reseed_tolerance = reseed_tolerance
        self._init_msg: Optional[bytes] = None
        self._last_version = 0  # highest store version this client saw
        self._u16: Optional[np.ndarray] = None  # bf16 wire scratch
        reg = default_registry()
        self._m_pulls = reg.counter("ps_client_pulls", unit="ops")
        self._m_pushes = reg.counter("ps_client_pushes", unit="ops")
        self._m_reconnects = reg.counter("ps_client_reconnects", unit="ops")
        self._m_pull_bytes = reg.counter("ps_client_pull_bytes", unit="bytes")
        self._m_push_bytes = reg.counter("ps_client_push_bytes", unit="bytes")
        self._connect(connect_timeout)

    def counters(self) -> dict:
        """The wire counters of the default registry, by name."""
        return {m.name: m.value for m in (
            self._m_pulls, self._m_pushes, self._m_reconnects,
            self._m_pull_bytes, self._m_push_bytes)}

    def _chaos_drop(self) -> None:
        """ps_drop@version:N probe: once the observed store version
        reaches N, sever this client's connection (one-shot) — the next
        op fails with OSError and exercises the real reconnect+backoff
        machinery, not a mock of it."""
        if chaos.ps_drop(self._last_version):
            try:
                self.sock.close()
            except OSError:
                pass

    def _connect(self, timeout: float):
        deadline = time.time() + timeout
        delay = 0.2
        while True:
            try:
                self.sock = socket.create_connection(self.address, timeout=300)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(delay)  # PS rank may still be starting
                delay = min(delay * 1.5, 5.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _retrying(self, op_name: str, fn):
        """Runs fn(); on a DEAD CONNECTION (OSError, incl. the
        ConnectionClosed that a short read raises mid-message),
        reconnects with backoff and retries until reconnect_timeout is
        spent.  Protocol rejections (ValueError) are deterministic —
        they propagate immediately."""
        if not self.reconnect_timeout:
            return fn()
        deadline = time.time() + self.reconnect_timeout
        while True:
            try:
                return fn()
            except OSError:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise
                log.warning("ps %s failed; reconnecting to %s "
                            "(%.0fs left)", op_name, self.address,
                            remaining)
                self._m_reconnects.inc()
                trace.event("ps_reconnect", op=op_name,
                            address=f"{self.address[0]}:{self.address[1]}")
                try:
                    self.sock.close()
                except OSError:
                    pass
                self._connect(remaining)
                # re-propose our init against the restarted store:
                # idempotent (first-wins) — it loses (st=1) against a
                # snapshot-restored store, but re-seeds a store that
                # restarted with NO snapshot (the pre-first-dump crash
                # window), so workers stay alive instead of dying on
                # status-2 pushes.  GUARDED against the silent step-0
                # reset: if this client has already seen a version far
                # beyond what a lost snapshot tail explains, the
                # restarted store has LOST the run — die loudly.
                if self._init_msg is not None and op_name != "init":
                    try:
                        # probe with the NON-MUTATING INFO first: a
                        # store that lost the run must be refused
                        # WITHOUT seeding it (a seeded lost store would
                        # look plausibly-initialized to a freshly
                        # restarted worker)
                        self.sock.sendall(bytes([OP_INFO]))
                        st, _, ver = struct.unpack(
                            "<BQQ", _recvn(self.sock, 17))
                        lost = self._last_version - ver
                        # the tolerance scales with the history this
                        # client saw: only losses plausible for the
                        # pre-first-snapshot window (RESEED_ABS_FLOOR)
                        # or a bounded fraction of the seen history pass
                        effective = min(
                            self.reseed_tolerance,
                            max(RESEED_ABS_FLOOR, self._last_version // 2))
                        if lost > effective:
                            raise RuntimeError(
                                f"restarted parameter store is at "
                                f"version {ver} but this worker already "
                                f"saw {self._last_version} (effective "
                                f"reseed tolerance {effective}) — the "
                                f"store lost the run's state (missing/"
                                f"corrupt snapshot?).  Refusing to "
                                f"continue mid-schedule from "
                                f"near-initial params; restart the job")
                        if st == 2:
                            # uninitialized AND within tolerance: the
                            # pre-first-dump crash window — re-seed
                            if self._last_version > 0:
                                log.error(
                                    "ps reconnect: re-seeding a "
                                    "restarted store from init params "
                                    "(last seen version %d) — the "
                                    "pre-snapshot crash window",
                                    self._last_version)
                            self.sock.sendall(self._init_msg)
                            _recvn(self.sock, 17)
                    except (OSError, ValueError):
                        # the socket may still be alive but DESYNCED
                        # (late INIT reply bytes would be parsed as the
                        # next op's response) — close it so the next
                        # iteration's failure path truly reconnects
                        try:
                            self.sock.close()
                        except OSError:
                            pass
                        continue

    def init(self, params: np.ndarray) -> Tuple[int, int]:
        """Propose initial params; first worker wins (the
        BroadcastGlobalVariablesCallback(0) equivalent).  Returns
        (status, version).  Under reconnect_timeout a crash during
        startup retries like pull/push — a re-sent INIT is idempotent
        (it wins at most once)."""
        params = np.ascontiguousarray(params, np.float32)
        msg = (bytes([OP_INIT]) + struct.pack("<Q", params.size) +
               params.tobytes())
        if self.reconnect_timeout:
            # replayed on reconnect (see _retrying); without reconnect
            # the replay is unreachable — don't pin ~4·N bytes forever
            self._init_msg = msg

        def once():
            self.sock.sendall(msg)
            st, n, ver = struct.unpack("<BQQ", _recvn(self.sock, 17))
            if st not in (0, 1) or n != params.size:
                raise ValueError(f"ps init rejected: status={st} size={n}")
            self._last_version = max(self._last_version, ver)
            return st, ver

        return self._retrying("init", once)

    def _scratch16(self, n: int) -> np.ndarray:
        if self._u16 is None or self._u16.size != n:
            self._u16 = np.empty(n, np.uint16)
        return self._u16

    def _recv_flat(self, n: int, bf16: bool,
                   out: Optional[np.ndarray]) -> np.ndarray:
        """The pulled vector, received straight into ``out`` (f32) or
        into the bf16 scratch and widened into ``out``."""
        if out is None or out.size != n:
            if out is not None:
                # drain the payload so the connection stays in step
                self._recv_flat(n, bf16, None)
                raise ValueError(f"ps pull: the store holds {n} floats, "
                                 f"the buffer {out.size}")
            out = np.empty(n, np.float32)
        if bf16:
            src = self._scratch16(n)
            _recv_into(self.sock, src)
            _bf16_to_f32(src, out)
        else:
            _recv_into(self.sock, out)
        return out

    def pull(self, retry_interval: float = 0.1, timeout: float = 120.0,
             bf16: bool = False, out: Optional[np.ndarray] = None
             ) -> Tuple[int, np.ndarray]:
        """Returns (version, flat f32 params); blocks until initialized.
        ``bf16`` pulls the bfloat16 wire encoding (half the traffic);
        the returned array is expanded back to f32.  ``out``: a
        contiguous float32 array of the store's size (a pinned host
        buffer) to receive into and return."""
        deadline = time.time() + timeout

        def once():
            self.sock.sendall(bytes([OP_PULL16 if bf16 else OP_PULL]))
            (st,) = _recvn(self.sock, 1)
            if st == 0:
                n, ver = struct.unpack("<QQ", _recvn(self.sock, 16))
                flat = self._recv_flat(int(n), bf16, out)
                self._last_version = max(self._last_version, ver)
                self._m_pulls.inc()
                self._m_pull_bytes.inc((2 if bf16 else 4) * int(n))
                self._chaos_drop()
                return ver, flat
            return None

        while True:
            with trace.span("ps_pull", bf16=bf16):
                got = self._retrying("pull", once)
            if got is not None:
                return got
            if time.time() > deadline:
                raise TimeoutError("parameter store never initialized")
            time.sleep(retry_interval)

    def push(self, lr: float, grads: np.ndarray, bf16: bool = False) -> int:
        """Apply one async Keras-SGD step on the store; returns the new
        version.  ``bf16`` sends gradients as bfloat16 on the wire (the
        store's update math stays f32).  A float32 push sends ``grads``'
        own buffer after the 13-byte header: no joined copy."""
        grads = np.ascontiguousarray(grads, np.float32)
        hdr = (bytes([OP_PUSH16 if bf16 else OP_PUSH]) +
               struct.pack("<fQ", float(lr), grads.size))
        payload = (_f32_to_bf16(grads, self._scratch16(grads.size))
                   if bf16 else grads)
        body = memoryview(payload).cast("B")
        nbytes = len(hdr) + len(body)

        def once():
            self.sock.sendall(hdr)
            self.sock.sendall(body)
            st, ver = struct.unpack("<BQ", _recvn(self.sock, 9))
            if st != 0:
                raise ValueError(f"ps push rejected: status={st}")
            self._last_version = max(self._last_version, ver)
            self._m_pushes.inc()
            self._m_push_bytes.inc(nbytes)
            self._chaos_drop()
            return ver

        with trace.span("ps_push", bf16=bf16):
            return self._retrying("push", once)

    def info(self) -> Tuple[int, int, int]:
        def once():
            self.sock.sendall(bytes([OP_INFO]))
            st, n, ver = struct.unpack("<BQQ", _recvn(self.sock, 17))
            # keep the reconnect reseed guard's baseline fresh: a client
            # whose latest traffic was info() must not under-detect a
            # store that lost the run
            self._last_version = max(self._last_version, ver)
            return st, n, ver

        return self._retrying("info", once)

    def done(self) -> None:
        """DONE rides the reconnect machinery too: a worker finishing
        while the PS is down must deliver its DONE to the RESTARTED
        store, or the PS rank's wait(num_workers) hangs forever one
        short.

        The delivery cannot naively retry the DONE itself: a lost ACK
        is indistinguishable from a lost DONE, and the store may
        legitimately tear down the moment the last DONE lands.  So
        liveness is verified FIRST with a retried INFO round-trip —
        reconnecting to a restarted store if needed — and the DONE then
        goes out on that just-verified connection with ack loss
        tolerated."""
        try:
            self._retrying("info", lambda: (
                self.sock.sendall(bytes([OP_INFO])),
                _recvn(self.sock, 17)))
            self.sock.sendall(bytes([OP_DONE]))
        except (ValueError, OSError, RuntimeError) as e:
            # best-effort: never fail a FINISHED worker on DONE.  But
            # say so: an undelivered DONE leaves the PS rank's
            # wait(num_workers) hanging, and this line is the only
            # diagnostic of which worker and why.
            log.warning("ps done() not delivered (%s: %s) — the PS "
                        "rank's wait() will be one DONE short",
                        type(e).__name__, e)
            return
        try:
            _recvn(self.sock, 1)
        except (ValueError, OSError):
            # the store may tear down as soon as the last DONE lands;
            # losing the ack is fine — the DONE itself was delivered
            pass

    def shutdown_server(self) -> None:
        self.sock.sendall(bytes([OP_SHUTDOWN]))
        _recvn(self.sock, 1)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# The async training entry (role dispatch)
# ---------------------------------------------------------------------------

class _SnapshotLoop:
    """PS-rank periodic snapshotter: restore-at-start + a background
    thread dumping the store every interval + a final dump at stop.
    The snapshot path is stable (<dir>/ps_store.snap) and each write is
    atomic, so a restarted PS always finds the newest complete state.

    Construct with the server still in defer_accept — the restore runs
    before any worker INIT is served, then the caller begin_accept()s.
    A corrupt snapshot is quarantined (renamed .corrupt) and logged,
    never crash-looped on: serving fresh state with a loud error beats
    a PS that can't start at all."""

    def __init__(self, server: PsServer, snap_dir: str, interval: float):
        self.server = server
        self.path = os.path.join(snap_dir, "ps_store.snap")
        self.interval = max(interval, 0.5)
        self._stop = threading.Event()
        os.makedirs(snap_dir, exist_ok=True)
        if os.path.exists(self.path):
            gen, snap_gen = current_generation(), \
                read_snapshot_generation(self.path)
            if snap_gen != gen and strip_done_footer(self.path):
                # whole-job restart (new supervisor attempt): the
                # persisted DONE tally belongs to workers of the STALE
                # generation — they re-run and re-deliver; counting the
                # old tally would double-count and let wait(num_workers)
                # return early.  Params/velocity/version still restore.
                log.warning(
                    "PS rank: snapshot done_count is from restart "
                    "generation %d (this attempt is generation %d) — "
                    "discarded; re-run workers re-deliver their DONEs",
                    snap_gen, gen)
            try:
                server.restore(self.path)
                with open(self.path, "rb") as f:
                    (version,) = struct.unpack("<Q", f.read(16)[8:16])
                log.info("PS rank: restored snapshot %s at version %d "
                         "(generation %d)", self.path, version, gen)
            except OSError as e:
                quarantine = self.path + ".corrupt"
                log.error("PS rank: snapshot %s unusable (%s) — moved "
                          "to %s, serving fresh state", self.path, e,
                          quarantine)
                try:
                    os.replace(self.path, quarantine)
                except OSError:
                    pass
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        # poll fast only while the store is UNINITIALIZED (so the first
        # dump lands within ~1 s of the first worker INIT — a crash in
        # the initial ps_snapshot_secs window must not restart into an
        # empty store with no snapshot at all).  I/O failures back off
        # to the normal interval: a full disk must not warn at 1 Hz for
        # the rest of training.
        state = "uninit"
        while True:
            delay = (min(1.0, self.interval) if state == "uninit"
                     else self.interval)
            if self._stop.wait(delay):
                return
            state = self._snap()

    def _snap(self) -> str:
        """"saved" | "uninit" | "ioerror" (logged)."""
        try:
            # sidecar FIRST: a crash between the two writes must never
            # leave a new snapshot under-claimed by an old sidecar — a
            # same-generation restore would then strip a legitimate
            # done_count and wait(num_workers) would hang.  The inverse
            # window (new sidecar + old snapshot) is safe: any stale-
            # generation footer was already stripped in place at this
            # loop's restore, so an on-disk footer is always ours.  A
            # FAILED sidecar write skips the dump for the same reason.
            if not write_snapshot_generation(self.path,
                                             current_generation()):
                return "ioerror"
            self.server.snapshot(self.path)
            return "saved"
        except ValueError:
            return "uninit"  # not initialized yet — nothing to save
        except OSError as e:
            log.warning("PS snapshot failed: %s", e)
            return "ioerror"

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        self._snap()  # final state, so a clean stop loses nothing


def _stop_store(server: PsServer, snap) -> None:
    """The PS rank's shutdown: pushes stop first, then the final
    snapshot dump, then the store goes.  In the other order a push
    landing between the dump and the stop would be acknowledged and then
    lost on restore (the JAX package's order, a fault it keeps)."""
    server.quiesce()
    if snap:
        snap.stop()  # final dump: a clean OR preempted stop
    server.stop()


def _serve_with_snapshots(cfg, port: int):
    """PS-rank store construction with the fault-tolerance ordering:
    bind paused → restore the snapshot (no worker INIT can race it;
    early connects just queue in the listen backlog) → begin accepting.
    Without --ps_snapshot_dir this is a plain immediately-serving
    store."""
    if not cfg.ps_snapshot_dir:
        return PsServer(port=port), None
    server = PsServer(port=port, defer_accept=True)
    snap = _SnapshotLoop(server, cfg.ps_snapshot_dir, cfg.ps_snapshot_secs)
    server.begin_accept()
    return server, snap


def _store_version(port: int) -> int:
    """The store's version, read over the wire."""
    client = PsClient(f"127.0.0.1:{port}", connect_timeout=5.0)
    try:
        return client.info()[2]
    finally:
        client.close()


def run_async(cfg) -> dict:
    """Async-PS run: process 0 serves, 1..N train independently.

    With no multi-process topology configured, runs a self-contained
    single-process demo: in-process store + one worker loop.  The
    stats name the store (``ps_store``); the PS rank returns
    ``{"ps_store", "ps_version"}`` and logs both."""
    default_registry().reset()  # the wire counters are per run
    n_procs = cfg.process_count or 1
    if n_procs <= 1:
        server, snap = _serve_with_snapshots(cfg, port=0)
        try:
            stats = _worker(cfg, f"127.0.0.1:{server.port}", worker_id=0,
                            num_workers=1)
            stats["ps_store"] = server.store
            return stats
        finally:
            _stop_store(server, snap)

    if not cfg.coordinator_address or cfg.process_id is None:
        raise ValueError("async parameter_server needs coordinator_address "
                         "and process_id (the PS address doubles as the "
                         "coordinator)")
    if "://" in cfg.coordinator_address:
        raise ValueError(
            f"async parameter_server: rank 0 serves the store on the "
            f"coordinator's TCP port, so the coordinator must be "
            f"host:port, not {cfg.coordinator_address!r}")
    num_workers = n_procs - 1
    if cfg.process_id == 0:
        from dtf_tpu_torch.obs.watchdog import Heartbeat
        from dtf_tpu_torch.train import preemption
        port = int(cfg.coordinator_address.rpartition(":")[2])
        server, snap = _serve_with_snapshots(cfg, port=port)
        log.info("PS rank: serving %d workers (ps_store: %s)", num_workers,
                 server.store)
        # the launcher's supervisor judges a rank by its heartbeat: the
        # store's rank beats while it serves, or a --heartbeat_timeout
        # would kill it as hung once its log stops growing
        heartbeat = Heartbeat.from_env(interval_s=cfg.heartbeat_secs)
        version = None
        try:
            # blocks like the reference PS rank, but exits when all
            # workers finish — AND polls for preemption: preempted
            # workers deliberately skip their DONE (progress lives in
            # the store snapshot), so wait(num_workers) would never
            # return on a pod-wide SIGTERM; the PS rank must notice its
            # own latched signal, dump a final snapshot, and exit 75
            # with everyone else instead of hanging until SIGKILL
            waiter = threading.Thread(target=server.wait,
                                      args=(num_workers,), daemon=True)
            waiter.start()
            while waiter.is_alive():
                waiter.join(timeout=0.5)
                if heartbeat is not None:
                    heartbeat.beat()
                signum = preemption.triggered()
                if signum is not None:
                    raise preemption.Preempted(0, signum)
            version = _store_version(server.port)
        finally:
            store = server.store
            _stop_store(server, snap)    # loses nothing
        log.info("PS rank done: version %d (ps_store: %s)", version, store)
        return {"ps_store": store, "ps_version": version}
    return _worker(cfg, cfg.coordinator_address,
                   worker_id=cfg.process_id - 1, num_workers=num_workers)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

def _worker_device(cfg, worker_id: int):
    """The worker's card, ``cuda:{worker_id % device_count}`` (made
    current), or the CPU; CUDA asked for and missing raises."""
    import torch

    from dtf_tpu_torch.runtime.device import resolve_device

    dev = resolve_device(cfg.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", worker_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _worker_inputs(cfg, spec, batch: int, worker_id: int, num_workers: int):
    """(train stream, eval stream factory): the JAX worker's sources --
    synthetic seeded ``seed + worker_id`` (eval ``seed + 10_000``),
    else this worker's file shard of CIFAR-10 or ImageNet."""
    from dtf_tpu_torch.data import synthetic_input_fn

    if cfg.use_synthetic_data or not cfg.data_dir:
        return (synthetic_input_fn(spec, True, batch, cfg.seed + worker_id),
                lambda: synthetic_input_fn(spec, False, batch,
                                           cfg.seed + 10_000))
    if spec.name == "cifar10":
        from dtf_tpu_torch.data.cifar import cifar_input_fn
        return (cifar_input_fn(cfg.data_dir, True, batch, seed=cfg.seed,
                               process_id=worker_id,
                               process_count=num_workers,
                               wire=cfg.input_wire),
                lambda: cifar_input_fn(cfg.data_dir, False, batch,
                                       wire=cfg.input_wire))
    if spec.name == "imagenet":
        from dtf_tpu_torch.data.imagenet import imagenet_input_fn
        return (imagenet_input_fn(cfg.data_dir, True, batch, seed=cfg.seed,
                                  process_id=worker_id,
                                  process_count=num_workers,
                                  wire=cfg.input_wire),
                lambda: imagenet_input_fn(cfg.data_dir, False, batch,
                                          wire=cfg.input_wire))
    raise NotImplementedError(
        f"--data_dir {cfg.data_dir!r}: the {spec.name} input pipeline is "
        f"not ported to dtf_tpu_torch yet; pass --use_synthetic_data")


def _worker(cfg, ps_address: str, worker_id: int, num_workers: int) -> dict:
    """One async worker: the JAX ``_worker``'s loop on this process's
    card.  Each step pulls the store's parameters into the model,
    trains on this worker's batch (local BatchNorm statistics), and
    pushes the flat float32 gradient with the schedule's learning rate
    for this worker's step; worker 0 evaluates and exports the store's
    final parameters.  DONE is delivered however the worker ends, except
    on preemption (it re-runs and re-delivers)."""
    import dataclasses

    import torch

    from dtf_tpu_torch.cli.runner import build_model_for
    from dtf_tpu_torch.convert import from_wire, to_wire, wire_layout
    from dtf_tpu_torch.data import get_dataset_spec
    from dtf_tpu_torch.data.normalize import for_config
    from dtf_tpu_torch.models.registry import l2_weight_penalty
    from dtf_tpu_torch.obs.watchdog import Heartbeat, NanLossWatchdog
    from dtf_tpu_torch.train import preemption
    from dtf_tpu_torch.train import schedules as sched_lib
    from dtf_tpu_torch.train.loop import cross_entropy
    from dtf_tpu_torch.utils.logs import TimeHistory, build_stats

    spec = get_dataset_spec(cfg.dataset)
    if cfg.num_classes:
        spec = dataclasses.replace(spec, num_classes=cfg.num_classes)
    if cfg.seq_len and spec.is_sequence:
        spec = dataclasses.replace(spec, seq_len=cfg.seq_len)

    if cfg.stop_threshold is not None and worker_id == 0:
        log.warning("--stop_threshold is ignored in async PS mode: workers "
                    "evaluate once after their step budget, not per epoch")

    batch = cfg.batch_size  # per-worker, like the reference's --batch_size 192
    model_name = "trivial" if cfg.use_trivial_model else cfg.model
    if model_name.startswith(("moe_transformer", "pipeline_transformer")):
        raise ValueError(
            f"model {model_name!r} is not supported in async "
            "parameter-server mode; use --ps_mode sync (the SPMD "
            "reinterpretation) for MoE/pipeline families")
    if (cfg.shard_lm_head or cfg.model_parallelism > 1
            or cfg.seq_parallelism > 1):
        # no grid in the async loop: a silently dense head or an unused
        # model axis would contradict what the flags promise
        raise ValueError(
            "--shard_lm_head/--model_parallelism/--seq_parallelism need "
            "the SPMD path; async parameter-server workers are "
            "single-device")
    if cfg.eval_only or cfg.clip_grad_norm:
        raise ValueError(
            "--eval_only/--clip_grad_norm/--optimizer_sharding are not "
            "implemented for async parameter-server mode; use "
            "--ps_mode sync")
    dev = _worker_device(cfg, worker_id)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)  # this worker's own peak
    model, l2w = build_model_for(cfg, spec, dev)

    # steps_per_epoch = train_steps // num_workers (ps_0.py:263 semantics)
    full_steps = max(spec.num_train // batch, 1)
    steps_per_epoch = max(full_steps // num_workers, 1)
    train_epochs = cfg.train_epochs
    if cfg.train_steps:
        steps_per_epoch = min(cfg.train_steps, steps_per_epoch)
        train_epochs = 1
    # the reference's LR callback follows the keras epoch counter, and
    # each PS worker's epoch is steps // num_workers long: the schedule
    # is built on the per-worker epoch length
    schedule = sched_lib.for_dataset(spec.name, batch, steps_per_epoch,
                                     spec.num_train,
                                     use_tensor_lr=cfg.use_tensor_lr)
    train_iter, eval_iter_fn = _worker_inputs(cfg, spec, batch, worker_id,
                                              num_workers)
    norm_fn = for_config(cfg, spec)

    layout = wire_layout(model)
    n = layout[-1].offset + layout[-1].size
    # the host side of the wire: on CUDA pinned buffers, which the card
    # copies to and from directly, each allocated once
    pin = dev.type == "cuda"
    params_host = torch.empty(n, dtype=torch.float32, pin_memory=pin)
    grads_host = torch.empty(n, dtype=torch.float32, pin_memory=pin)
    grads_dev = (torch.empty(n, dtype=torch.float32, device=dev) if pin
                 else grads_host)
    params = dict(model.named_parameters())
    # with snapshots configured, workers outlive a PS crash: reconnect
    # with backoff (--ps_reconnect_secs) and resume against the
    # restored store
    client = PsClient(ps_address,
                      reconnect_timeout=cfg.ps_reconnect_secs
                      if cfg.ps_snapshot_dir else 0.0,
                      reseed_tolerance=cfg.ps_reseed_tolerance)
    st, _ = client.init(to_wire(model, layout=layout).cpu().numpy())
    log.info("worker %d/%d on %s: params %d floats (%s init)", worker_id,
             num_workers, dev, n, "won" if st == 0 else "lost")

    def pull(bf16: bool):
        """The store's parameters into the model."""
        client.pull(bf16=bf16, out=params_host.numpy())
        from_wire(params_host, model, layout=layout)

    def to_device(x):
        return torch.as_tensor(np.asarray(x)).to(dev, non_blocking=True)

    def step(images, labels):
        images, labels = to_device(images), to_device(labels)
        if norm_fn is not None:
            images = norm_fn(images)
        for p in params.values():
            p.grad = None
        logits = model(images)
        loss = cross_entropy(logits, labels) + l2_weight_penalty(model, l2w)
        loss.backward()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        to_wire(model, grads, layout=layout, out=grads_dev)
        if pin:
            grads_host.copy_(grads_dev)  # the step's one sync
        return loss.detach(), acc

    wire_bf16 = cfg.ps_wire == "bf16"
    time_cb = TimeHistory(batch, cfg.log_steps)
    acc_key = ("categorical_accuracy" if spec.one_hot
               else "sparse_categorical_accuracy")
    history: dict = {"loss": [], acc_key: []}
    # the SPMD loop's watchdog surface: NaN guard on the loss values
    # this loop syncs, heartbeat when launched under the supervisor (a
    # PS worker that deadlocks in pull() stops beating)
    nan_guard = NanLossWatchdog(enabled=cfg.nan_guard)
    heartbeat = Heartbeat.from_env(interval_s=cfg.heartbeat_secs)
    model.train()
    time_cb.on_train_begin()
    local_step = 0
    preempted = False
    loss_log: list = []        # (step, loss) at each log boundary
    step_wall_s: list = []     # pull + step + push, each step
    # the whole worker body runs under a DONE guarantee: a NaN-guard
    # abort (or any other worker death past init) must still deliver
    # this worker's DONE, or the PS rank's wait(num_workers) hangs one
    # short forever
    try:
        for epoch in range(train_epochs):
            time_cb.on_epoch_begin(epoch)
            for _ in range(steps_per_epoch):
                time_cb.on_batch_begin(local_step)
                t0 = time.perf_counter()
                pull(wire_bf16)
                images, labels = next(train_iter)
                # the gradient's copy to the host syncs every step, so
                # the span is a true step time
                with trace.span("step", step=local_step, worker=worker_id):
                    loss, acc = step(images, labels)
                # ASYNC NETWORK BOUNDARY: other workers may have
                # advanced the store meanwhile (stale gradients are
                # inherent to async PS — same as the reference)
                lr = float(schedule(local_step))
                client.push(lr, grads_host.numpy(), bf16=wire_bf16)
                step_wall_s.append(time.perf_counter() - t0)
                local_step += 1
                time_cb.on_batch_end(local_step)
                if local_step % cfg.log_steps == 0:
                    # the float's exact value: runs compare these bit
                    # for bit (the gradient's copy already synced)
                    loss_log.append((local_step, float(loss)))
                    trace.event("train_loss", step=local_step,
                                loss=loss_log[-1][1], worker=worker_id)
                if heartbeat is not None:
                    heartbeat.beat(step=local_step)
                # chaos step probe + cooperative preemption on this
                # worker's OWN latch: the store already holds every
                # pushed gradient, so a preempted worker just exits
                # EXIT_PREEMPTED — progress lives in the PS snapshot
                chaos.step(local_step)
                signum = preemption.triggered()
                if signum is not None:
                    raise preemption.Preempted(local_step, signum)
            m_loss, m_acc = float(loss), float(acc)
            nan_guard.check(local_step, m_loss)
            history["loss"].append(m_loss)
            history[acc_key].append(m_acc)
            time_cb.on_epoch_end(epoch)
            log.info("worker %d epoch %d/%d: loss=%.4f top1=%.4f", worker_id,
                     epoch + 1, train_epochs, m_loss, m_acc)
        time_cb.on_train_end()

        eval_output = None
        if not cfg.skip_eval and worker_id == 0:
            pull(False)
            model.eval()
            losses, accs = [], []
            with torch.no_grad():
                for images, labels, *_ in eval_iter_fn():
                    images, labels = to_device(images), to_device(labels)
                    if norm_fn is not None:
                        images = norm_fn(images)
                    logits = model(images)
                    losses.append(float(cross_entropy(logits, labels)))
                    accs.append(float((logits.argmax(-1) == labels)
                                      .float().mean()))
            model.train()
            if losses:
                eval_output = (float(np.mean(losses)), float(np.mean(accs)))
                log.info("worker 0 eval: loss=%.4f top1=%.4f", *eval_output)

        stats = build_stats(history, eval_output, time_cb)
        stats["ps_version"] = client._last_version
        stats["ps_client"] = client.counters()
        stats["train_loss_log"] = loss_log
        stats["step_wall_s"] = step_wall_s
        if dev.type == "cuda":
            stats["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        if worker_id == 0:
            if cfg.export_dir:
                # --export_dir: final store params + this worker's BN stats
                from dtf_tpu_torch.train.checkpoint import export_model
                pull(False)
                export_model(cfg.export_dir, model)
            if cfg.benchmark_log_dir:
                from dtf_tpu_torch.utils.benchmark_logger import (
                    BenchmarkFileLogger)
                blog = BenchmarkFileLogger(cfg.benchmark_log_dir)
                blog.log_run_info(cfg.model, cfg.dataset, cfg.to_dict(), dev,
                                  test_id=cfg.benchmark_test_id)
                for key in ("loss", "training_accuracy_top_1",
                            "accuracy_top_1", "eval_loss",
                            "avg_exp_per_second"):
                    if stats.get(key) is not None:
                        blog.log_metric(key, stats[key],
                                        global_step=local_step)
                # the PS wire counters ride the same metric.log
                blog.log_registry(default_registry(), global_step=local_step)
    except preemption.Preempted:
        # preempted, NOT finished: the supervisor restarts the whole
        # job, and this worker will run again — delivering DONE now
        # would poison the (snapshot-persisted) done_count and let the
        # restarted PS rank's wait(num_workers) return early
        preempted = True
        raise
    except BaseException:
        # dying worker: still deliver DONE (the finally below), but
        # best-effort FAST — done()'s retried INFO probe must not burn
        # another full reconnect_timeout against a store that may be
        # the very thing that just failed
        client.reconnect_timeout = min(client.reconnect_timeout or 0.0, 5.0)
        raise
    finally:
        try:
            if not preempted:
                client.done()  # swallows delivery failures (logs warning)
        finally:
            client.close()
            if hasattr(train_iter, "close"):
                train_iter.close()
    log.info("Run stats: %s",
             {k: v for k, v in stats.items() if k != "step_timestamp_log"})
    return stats
