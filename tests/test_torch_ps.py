"""The port's async parameter server (dtf_tpu_torch: parallel/ps.py,
native/ps.py with native/ps_store.cpp, convert.py's wire layout, and
their wiring in cli/runner.py and cli/launch.py) against the JAX
package's ``dtf_tpu/parallel/ps.py``, on the CPU.

The first part mirrors ``tests/test_ps.py`` case by case against the
port's ``PsServer`` and ``PsClient``, over the native store (built here
from the port's own source) and the Python one.  Then the two packages
meet: the port's wire vector is ``ravel_pytree(params)[0]`` bit for
bit; clients of either package work against the other's store; a
snapshot of either store restores in the other and dumps again byte for
byte; both stores apply the same pushes to the same bits; and a port
worker started from the JAX worker's store bytes ends within 1e-5 of
it.  Last, the port's own semantics: threads of workers, DONE on death
and not on preemption, ``ps_drop``, the refusals, the launcher and the
PS rank's heartbeat.
"""

import dataclasses
import os
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dtf_tpu_torch import chaos, convert
from dtf_tpu_torch.cli import launch
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.data import base as data_base
from dtf_tpu_torch.native import ps as native_ps
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.parallel import ps as ps_lib
from dtf_tpu_torch.train import preemption
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV

torch.set_num_threads(1)

# every gloo group this file's ranks start gives up on a dead peer within
# 120 s (runtime/mesh.py TIMEOUT_ENV), well inside the suite's limit
os.environ.setdefault(TIMEOUT_ENV, "120")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the one-worker parity gate: final losses and the stores' parameters
PARITY_TOL = 1e-5
TINY = dict(image_size=8, num_train=64, num_eval=16)


def has_native():
    return native_ps.load() is not None


@pytest.fixture(autouse=True)
def clean_state():
    yield
    chaos.disable()
    trace.disable()
    preemption.restore()


@pytest.fixture(params=["native", "python"])
def store(request, monkeypatch):
    """Which store PsServer builds: the port's library or the Python
    fallback, through the public PsServer API."""
    if request.param == "native" and not has_native():
        pytest.skip(f"native ps store not built: "
                    f"{native_ps.unavailable_reason}")
    if request.param == "python":
        monkeypatch.setattr(native_ps, "load", lambda: None)
    return request.param


@pytest.fixture
def server(store):
    srv = ps_lib.PsServer(port=0)
    assert srv.store == store
    yield srv
    srv.stop()


@pytest.fixture
def tiny_cifar(monkeypatch):
    """CIFAR-10 at 8x8 with 64 training and 16 eval images, in both
    packages' spec tables."""
    monkeypatch.setitem(data_base._SPECS, "cifar10",
                        dataclasses.replace(data_base.CIFAR10, **TINY))
    try:
        import dtf_tpu.data.base as jax_base
        monkeypatch.setitem(jax_base._SPECS, "cifar10",
                            dataclasses.replace(jax_base.CIFAR10, **TINY))
    except ImportError:
        pass


def _addr(srv):
    return f"127.0.0.1:{srv.port}"


def _async_cfg(**kw):
    base = dict(device="cpu", model="resnet20", dataset="cifar10",
                batch_size=8, train_steps=2, use_synthetic_data=True,
                skip_eval=True, skip_checkpoint=True, model_dir="",
                log_steps=1, distribution_strategy="parameter_server",
                ps_mode="async")
    base.update(kw)
    return Config(**base)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# tests/test_ps.py, case by case, on the port's stores and client
# ---------------------------------------------------------------------------

def test_init_pull_push_roundtrip(server):
    client = ps_lib.PsClient(_addr(server))
    p0 = np.arange(5, dtype=np.float32)
    st, ver = client.init(p0)
    assert st == 0 and ver == 0
    st2, _ = client.init(np.zeros(5, np.float32))
    assert st2 == 1                      # a second init loses
    ver, flat = client.pull()
    np.testing.assert_array_equal(flat, p0)
    # keras SGD: v = m*v - lr*g; p += v  (momentum 0.9)
    g = np.ones(5, np.float32)
    assert client.push(0.1, g) == 1
    _, flat1 = client.pull()
    np.testing.assert_allclose(flat1, p0 - 0.1, rtol=1e-6)
    assert client.push(0.1, g) == 2
    _, flat2 = client.pull()
    # v1 = -0.1; v2 = 0.9*(-0.1) - 0.1 = -0.19
    np.testing.assert_allclose(flat2, p0 - 0.1 - 0.19, rtol=1e-6)
    client.done()
    client.close()


def test_pull_into_a_buffer(server):
    """pull(out=...) receives into the caller's array and returns it,
    on both wires; a buffer of the wrong size raises and leaves the
    connection in step."""
    client = ps_lib.PsClient(_addr(server))
    p0 = np.linspace(-3, 3, 7).astype(np.float32)
    client.init(p0)
    buf = np.empty(7, np.float32)
    _, flat = client.pull(out=buf)
    assert flat is buf
    np.testing.assert_array_equal(buf, p0)
    _, flat = client.pull(bf16=True, out=buf)
    assert flat is buf
    np.testing.assert_array_equal(
        buf, ps_lib._bf16_bytes_to_f32(ps_lib._f32_to_bf16_bytes(p0)))
    with pytest.raises(ValueError, match="buffer"):
        client.pull(out=np.empty(3, np.float32))
    assert client.pull()[0] == 0        # still in step
    client.close()


def test_bf16_wire_roundtrip(server):
    """--ps_wire bf16: pulls return bf16-rounded params, pushes apply
    bf16-rounded grads with f32 store math -- on both stores."""
    client = ps_lib.PsClient(_addr(server))
    p0 = np.asarray([1.0, -2.5, 3.14159, 1e-3, 100.7], np.float32)
    client.init(p0)
    ver, flat = client.pull(bf16=True)
    want = ps_lib._bf16_bytes_to_f32(ps_lib._f32_to_bf16_bytes(p0))
    np.testing.assert_array_equal(flat, want)
    g = np.asarray([0.5, 0.25, -0.125, 1.0, -1.0], np.float32)
    assert client.push(0.1, g, bf16=True) == 1
    _, flat1 = client.pull()          # f32 pull shows the f32 update math
    gr = ps_lib._bf16_bytes_to_f32(ps_lib._f32_to_bf16_bytes(g))
    np.testing.assert_allclose(flat1, p0 - 0.1 * gr, rtol=1e-6)
    client.done()
    client.close()


def _bf16_probe(seed=0, n=1000, scale=10.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(0, scale, n).astype(np.float32),
        np.asarray([0.0, -0.0, 1e-38, 1e-40, -1e38, np.inf, -np.inf],
                   np.float32),
        # NaN payloads: the low-mantissa one RNE would carry into Inf,
        # the all-ones one that would wrap to 0
        np.asarray([0x7F800001, 0xFFFFFFFF, 0x7FC00000, 0xFFC00000,
                    0x7F80FFFF, 0x807FFFFF], np.uint32).view(np.float32)])


def test_bf16_conversion_matches_numpy():
    """The wire encoding is numpy/JAX's round-to-nearest-even bf16."""
    import jax.numpy as jnp
    x = _bf16_probe()[:-6]
    ours = ps_lib._bf16_bytes_to_f32(ps_lib._f32_to_bf16_bytes(x))
    jaxs = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(ours, jaxs)
    nans = _bf16_probe()[-6:]
    out = ps_lib._bf16_bytes_to_f32(ps_lib._f32_to_bf16_bytes(nans))
    assert np.isnan(out[[0, 1, 2, 3]]).all()


def test_bf16_conversion_native_matches_python_fallback(monkeypatch):
    """The native one-pass conversion is bit-identical to the numpy
    form, NaN payloads included, both directions."""
    if not has_native():
        pytest.skip("native ps store not built")
    x = _bf16_probe(1, 100_000, 100.0)
    native_push = ps_lib._f32_to_bf16_bytes(x)
    monkeypatch.setattr(native_ps, "load", lambda: None)
    fallback_push = ps_lib._f32_to_bf16_bytes(x)
    assert native_push == fallback_push
    fallback_pull = ps_lib._bf16_bytes_to_f32(fallback_push)
    monkeypatch.undo()
    native_pull = ps_lib._bf16_bytes_to_f32(native_push)
    np.testing.assert_array_equal(native_pull.view(np.uint32),
                                  fallback_pull.view(np.uint32))


def test_async_e2e_bf16_wire():
    """The single-process demo trains with --ps_wire bf16."""
    stats = ps_lib.run_async(_async_cfg(
        model="trivial", use_trivial_model=True, num_classes=10,
        train_steps=3, ps_wire="bf16"))
    assert np.isfinite(stats["loss"])
    assert stats["ps_version"] == 3
    assert stats["ps_store"] == native_ps.store_path()


def test_pull_before_init_blocks_then_succeeds(server):
    out = {}

    def puller():
        c = ps_lib.PsClient(_addr(server))
        out["flat"] = c.pull(timeout=30)[1]
        c.close()

    t = threading.Thread(target=puller)
    t.start()
    c2 = ps_lib.PsClient(_addr(server))
    c2.init(np.full(3, 7.0, np.float32))
    t.join(timeout=30)
    assert not t.is_alive()
    np.testing.assert_array_equal(out["flat"], np.full(3, 7.0, np.float32))
    c2.close()


def test_concurrent_pushes_all_applied(server):
    """N threads x K pushes each all land (the version counts them)."""
    c0 = ps_lib.PsClient(_addr(server))
    c0.init(np.zeros(4, np.float32))
    N, K = 4, 25

    def worker():
        c = ps_lib.PsClient(_addr(server))
        for _ in range(K):
            c.push(0.01, np.ones(4, np.float32))
        c.done()
        c.close()

    threads = [threading.Thread(target=worker) for _ in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert c0.info()[2] == N * K
    assert _done_arrives(server, 30, N), "the workers' DONEs never arrived"
    c0.close()


def test_wait_unblocks_on_done(server):
    c = ps_lib.PsClient(_addr(server))
    c.init(np.zeros(2, np.float32))
    done = threading.Event()
    t = threading.Thread(target=lambda: (server.wait(1), done.set()))
    t.start()
    assert not done.wait(0.2)
    c.done()
    assert done.wait(30)
    t.join(timeout=10)
    assert not t.is_alive()
    c.close()


def test_snapshot_restore_roundtrip(server, tmp_path):
    """Params+velocity+version survive a store death, and momentum
    continues exactly: the restored store gives the same params as an
    uninterrupted one for the same next push."""
    path = str(tmp_path / "ps_store.snap")
    client = ps_lib.PsClient(_addr(server))
    p0 = np.asarray([1.0, -2.0, 3.0, 0.5], np.float32)
    client.init(p0)
    g = np.asarray([0.1, -0.2, 0.3, 0.4], np.float32)
    client.push(0.1, g)
    client.push(0.1, g)
    ver_a, flat_a = client.pull()
    server.snapshot(path)
    client.push(0.1, g)
    _, flat_cont = client.pull()
    client.close()

    srv2 = ps_lib.PsServer(port=0)
    try:
        srv2.restore(path)
        c2 = ps_lib.PsClient(_addr(srv2))
        ver_b, flat_b = c2.pull()
        assert ver_b == ver_a == 2
        np.testing.assert_array_equal(flat_b, flat_a)
        st, _ = c2.init(np.zeros(4, np.float32))
        assert st == 1                 # a late INIT loses to the restore
        assert c2.push(0.1, g) == 3
        _, flat_b2 = c2.pull()
        np.testing.assert_array_equal(flat_b2, flat_cont)
        c2.close()
    finally:
        srv2.stop()


def test_snapshot_cross_build(tmp_path, monkeypatch):
    """The port's C++ and Python stores share the snapshot format: a
    native dump restores into the Python store and back."""
    if not has_native():
        pytest.skip("native ps store not built")
    path = str(tmp_path / "cross.snap")
    p0 = np.asarray([4.0, 5.0, -6.0], np.float32)
    g = np.asarray([1.0, 2.0, 3.0], np.float32)
    native_srv = ps_lib.PsServer(port=0)
    assert native_srv.store == "native"
    try:
        c = ps_lib.PsClient(_addr(native_srv))
        c.init(p0)
        c.push(0.05, g)
        _, want = c.pull()
        native_srv.snapshot(path)
        c.close()
    finally:
        native_srv.stop()
    py_srv = ps_lib._PyPsServer(0, momentum=0.9)
    try:
        py_srv.restore(path)
        c = ps_lib.PsClient(f"127.0.0.1:{py_srv.port}")
        ver, got = c.pull()
        assert ver == 1
        np.testing.assert_array_equal(got, want)
        c.close()
        py_srv.snapshot(path + "2")
    finally:
        py_srv.stop()
    native2 = ps_lib.PsServer(port=0)
    try:
        native2.restore(path + "2")
        c = ps_lib.PsClient(_addr(native2))
        ver, got = c.pull()
        assert ver == 1
        np.testing.assert_array_equal(got, want)
        c.close()
    finally:
        native2.stop()


def test_restore_rejects_corrupt_snapshot(server, tmp_path):
    bad = tmp_path / "bad.snap"
    bad.write_bytes(b"DTFPSNP1" + b"\x00" * 10)  # truncated
    with pytest.raises(OSError):
        server.restore(str(bad))
    bad.write_bytes(b"NOTMAGIC" + b"\x00" * 40)
    with pytest.raises(OSError):
        server.restore(str(bad))


def test_push_rejection_fails_fast_despite_reconnect(server):
    """A protocol rejection (size mismatch, status 2) is not retried:
    only dead connections are."""
    client = ps_lib.PsClient(_addr(server), reconnect_timeout=60.0)
    client.init(np.zeros(4, np.float32))
    t0 = time.time()
    with pytest.raises(ValueError, match="rejected"):
        client.push(0.1, np.zeros(7, np.float32))
    assert time.time() - t0 < 5.0
    client.close()


def test_deferred_accept_restores_before_serving(server, tmp_path):
    """With defer_accept, a worker INIT that connects during the
    restore queues in the backlog and is served after it: it loses and
    pulls the restored params."""
    path = str(tmp_path / "s.snap")
    c = ps_lib.PsClient(_addr(server))
    restored = np.asarray([9.0, 8.0, 7.0], np.float32)
    c.init(restored)
    server.snapshot(path)
    c.close()
    srv2 = ps_lib.PsServer(port=0, defer_accept=True)
    try:
        results = {}

        def early_init():
            cc = ps_lib.PsClient(_addr(srv2), connect_timeout=10.0)
            results["st"] = cc.init(np.zeros(3, np.float32))[0]
            results["pull"] = cc.pull()[1]
            cc.close()

        t = threading.Thread(target=early_init)
        t.start()
        time.sleep(0.5)  # connected (backlog), unserved
        srv2.restore(path)
        srv2.begin_accept()
        t.join(timeout=30)
        assert results["st"] == 1
        np.testing.assert_array_equal(results["pull"], restored)
    finally:
        srv2.stop()


def test_corrupt_snapshot_quarantined_not_crash_looped(tmp_path):
    snap_dir = tmp_path / "snaps"
    snap_dir.mkdir()
    (snap_dir / "ps_store.snap").write_bytes(b"NOTMAGIC" + b"\x00" * 64)
    srv = ps_lib.PsServer(port=0, defer_accept=True)
    try:
        loop = ps_lib._SnapshotLoop(srv, str(snap_dir), interval=3600)
        srv.begin_accept()
        assert not os.path.exists(snap_dir / "ps_store.snap")
        assert os.path.exists(snap_dir / "ps_store.snap.corrupt")
        c = ps_lib.PsClient(_addr(srv))
        assert c.init(np.ones(3, np.float32))[0] == 0   # fresh store
        c.close()
        loop.stop()
        assert os.path.exists(snap_dir / "ps_store.snap")
    finally:
        srv.stop()


def test_reseed_tolerance_default_parity():
    """Config keeps a literal default; it is the module's one constant,
    and the JAX package's."""
    from dtf_tpu.parallel import ps as jax_ps
    assert Config().ps_reseed_tolerance == ps_lib.DEFAULT_RESEED_TOLERANCE
    assert ps_lib.DEFAULT_RESEED_TOLERANCE == jax_ps.DEFAULT_RESEED_TOLERANCE
    assert ps_lib.RESEED_ABS_FLOOR == jax_ps.RESEED_ABS_FLOOR


def test_reconnect_refuses_store_that_lost_the_run():
    """A client past the reseed tolerance raises when the restarted
    store comes back empty, and does not seed it."""
    srv = ps_lib.PsServer(port=0)
    port = srv.port
    client = ps_lib.PsClient(f"127.0.0.1:{port}", reconnect_timeout=20.0,
                             reseed_tolerance=50)
    client.init(np.zeros(4, np.float32))
    g = np.ones(4, np.float32)
    for _ in range(60):
        client.push(0.01, g)
    srv.stop()
    srv2 = ps_lib.PsServer(port=port)  # restart, NO restore
    try:
        with pytest.raises(RuntimeError, match="lost the run"):
            client.push(0.01, g)
        c2 = ps_lib.PsClient(f"127.0.0.1:{port}")
        st, n, _ = c2.info()
        assert st == 2 and n == 0  # still uninitialized
        c2.close()
    finally:
        client.close()
        srv2.stop()


def test_done_survives_ps_restart(tmp_path):
    path = str(tmp_path / "s.snap")
    srv = ps_lib.PsServer(port=0)
    port = srv.port
    client = ps_lib.PsClient(f"127.0.0.1:{port}", reconnect_timeout=20.0)
    client.init(np.ones(3, np.float32))
    client.push(0.01, np.ones(3, np.float32))
    srv.snapshot(path)
    srv.stop()  # PS dies before the worker reports DONE
    srv2 = ps_lib.PsServer(port=port)
    try:
        srv2.restore(path)
        client.done()  # reconnects and lands on the new incarnation
        assert _done_arrives(srv2, 30), "the DONE never reached the restore"
        client.close()
    finally:
        srv2.stop()


def test_first_snapshot_lands_fast(tmp_path):
    snap_dir = str(tmp_path / "snaps")
    srv = ps_lib.PsServer(port=0, defer_accept=True)
    try:
        loop = ps_lib._SnapshotLoop(srv, snap_dir, interval=3600)
        srv.begin_accept()
        c = ps_lib.PsClient(_addr(srv))
        c.init(np.ones(4, np.float32))
        path = os.path.join(snap_dir, "ps_store.snap")
        deadline = time.time() + 10
        while not os.path.exists(path) and time.time() < deadline:
            time.sleep(0.2)
        assert os.path.exists(path)
        c.close()
        loop.stop()
    finally:
        srv.stop()


def _lsq_problem():
    rng = np.random.default_rng(0)
    true_w = rng.normal(size=(8,)).astype(np.float32)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    return X, X @ true_w


def _lsq_steps(client, n, r, X, y):
    """n pull / torch gradient / push steps of least squares."""
    losses = []
    for _ in range(n):
        _, w = client.pull()
        idx = r.integers(0, 64, size=16)
        wt = torch.tensor(w, requires_grad=True)
        loss = ((torch.from_numpy(X[idx]) @ wt
                 - torch.from_numpy(y[idx])) ** 2).mean()
        loss.backward()
        client.push(0.02, wt.grad.numpy())
        losses.append(float(loss.detach()))
    return losses


def test_worker_survives_ps_crash_and_restore(tmp_path):
    """Kill the PS mid-run, restart it from the snapshot on the same
    port: the worker's loss trajectory continues."""
    X, y = _lsq_problem()
    path = str(tmp_path / "ps_store.snap")
    server = ps_lib.PsServer(port=0)
    port = server.port
    client = ps_lib.PsClient(f"127.0.0.1:{port}", reconnect_timeout=30.0)
    client.init(np.zeros(8, np.float32))
    r = np.random.default_rng(1)
    losses1 = _lsq_steps(client, 60, r, X, y)
    server.snapshot(path)
    ver_before = client.info()[2]
    server.stop()  # the crash: the store dies with connections open
    server2 = ps_lib.PsServer(port=port)
    try:
        server2.restore(path)
        losses2 = _lsq_steps(client, 60, r, X, y)
        assert client.info()[2] >= ver_before + 60
        assert np.mean(losses2[:5]) < np.mean(losses1[:5]) * 0.8
        assert np.mean(losses2[-10:]) < np.mean(losses1[-10:])
        client.done()
        client.close()
    finally:
        server2.stop()


def test_run_async_snapshot_dir_e2e(tmp_path, tiny_cifar):
    """--ps_snapshot_dir through run(): run 1 leaves a restorable
    snapshot at version 2; run 2 restores it before serving and
    continues to version 4."""
    from dtf_tpu_torch.cli.runner import run
    snap_dir = str(tmp_path / "snaps")
    snap = os.path.join(snap_dir, "ps_store.snap")

    def snap_version():
        srv = ps_lib.PsServer(port=0)
        try:
            srv.restore(snap)
            c = ps_lib.PsClient(_addr(srv))
            ver, flat = c.pull()
            assert np.all(np.isfinite(flat))
            c.close()
            return ver
        finally:
            srv.stop()

    cfg = _async_cfg(ps_snapshot_dir=snap_dir)
    run(cfg)
    assert snap_version() == 2
    stats = run(cfg)
    assert stats["ps_version"] == 4
    assert snap_version() == 4


def test_final_snapshot_keeps_every_acknowledged_push(store, tmp_path,
                                                      tiny_cifar,
                                                      monkeypatch):
    """A push that arrives while the PS rank shuts down -- here right
    after its final snapshot dump -- is either acknowledged and in the
    restored store, or refused.  The JAX package's order (dump, then
    stop the store) acknowledges it and loses it on restore; the port
    stops taking pushes before the dump."""
    from dtf_tpu_torch.cli.runner import run
    snap_dir = str(tmp_path / "snaps")
    acked = []
    real_snap = ps_lib._SnapshotLoop._snap

    def snap_then_push(loop):
        out = real_snap(loop)
        if loop._stop.is_set():
            # the final dump has landed: a late worker pushes now
            try:
                c = ps_lib.PsClient(_addr(loop.server),
                                    connect_timeout=0.5)
                try:
                    n = c.info()[1]
                    acked.append(c.push(0.1, np.ones(n, np.float32)))
                finally:
                    c.close()
            except (OSError, ValueError):
                pass      # refused: not acknowledged, nothing owed
        return out

    monkeypatch.setattr(ps_lib._SnapshotLoop, "_snap", snap_then_push)
    stats = run(_async_cfg(ps_snapshot_dir=snap_dir))
    srv = ps_lib.PsServer(port=0)
    try:
        srv.restore(os.path.join(snap_dir, "ps_store.snap"))
        c = ps_lib.PsClient(_addr(srv))
        restored = c.info()[2]
        c.close()
    finally:
        srv.stop()
    assert restored == max([stats["ps_version"]] + acked), (
        f"acknowledged pushes up to version "
        f"{max([stats['ps_version']] + acked)}, restored {restored}")


def test_run_async_single_process_demo(tiny_cifar):
    from dtf_tpu_torch.cli.runner import run
    stats = run(_async_cfg(skip_eval=False))
    assert np.isfinite(stats["loss"])
    assert "accuracy_top_1" in stats and np.isfinite(stats["eval_loss"])
    assert stats["ps_version"] == 2
    assert stats["ps_client"]["ps_client_pushes"] == 2


def test_async_training_converges():
    """Two worker threads against one store drive least squares down,
    staleness and all."""
    X, y = _lsq_problem()
    server = ps_lib.PsServer(port=0)
    try:
        c0 = ps_lib.PsClient(_addr(server))
        c0.init(np.zeros(8, np.float32))

        def worker(seed):
            c = ps_lib.PsClient(_addr(server))
            _lsq_steps(c, 150, np.random.default_rng(seed), X, y)
            c.done()
            c.close()

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert _done_arrives(server, 30, 2), "the workers' DONEs never arrived"
        _, w_final = c0.pull()
        assert float(np.mean((X @ w_final - y) ** 2)) < 1e-2
        c0.close()
    finally:
        server.stop()


def _launch_env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("DTF_FAULT", None)
    return env


def test_three_process_async_ps(tmp_path):
    """1 PS + 2 workers as real processes through the port's launcher
    (``cifar_main``): every rank exits 0, the PS rank ends at version
    4 (two workers x two steps) and the workers' losses are finite."""
    import re
    port = _free_port()
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.cli.launch",
         "--num_processes", "3", "--coordinator", f"localhost:{port}",
         "--log_dir", str(tmp_path / "logs"), "--",
         sys.executable, "-m", "dtf_tpu_torch.cli.cifar_main",
         "--use_synthetic_data", "--device", "cpu", "--model", "trivial",
         "--use_trivial_model", "--batch_size", "8", "--train_steps", "2",
         "--skip_eval", "--skip_checkpoint", "--log_steps", "1",
         "--distribution_strategy", "parameter_server", "--ps_mode",
         "async"],
        cwd=REPO, timeout=120, capture_output=True, text=True,
        env=_launch_env())

    def text(i):
        p = tmp_path / "logs" / f"log{i}.log"
        return p.read_text() if p.exists() else "<no log>"

    assert proc.returncode == 0, (proc.stderr[-1000:], text(0)[-2000:],
                                  text(1)[-2000:], text(2)[-2000:])
    assert re.search(r"PS rank done: version 4 \(ps_store: (native|python)\)",
                     text(0))
    for i in (1, 2):
        m = re.search(r"'loss': ([-\d.e]+)", text(i))
        assert m and np.isfinite(float(m.group(1))), text(i)[-2000:]


def test_snapshot_persists_done_count(server, tmp_path):
    """A worker that reported DONE and exited before a PS crash still
    counts on the restored store."""
    path = str(tmp_path / "s.snap")
    client = ps_lib.PsClient(_addr(server))
    client.init(np.ones(3, np.float32))
    client.done()
    client.close()
    # the DONE landed before the snapshot
    assert _done_arrives(server, 30), "the DONE never arrived"
    server.snapshot(path)
    server.stop()
    srv2 = ps_lib.PsServer(port=0)
    try:
        srv2.restore(path)
        done = threading.Event()
        t = threading.Thread(target=lambda: (srv2.wait(1), done.set()))
        t.start()
        assert done.wait(10), "restored store lost the DONE tally"
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        srv2.stop()


def test_restore_accepts_footerless_snapshot(server, tmp_path):
    path = str(tmp_path / "old.snap")
    params = np.asarray([1.0, 2.0], np.float32)
    with open(path, "wb") as f:
        f.write(ps_lib.SNAP_MAGIC)
        f.write(struct.pack("<QQ", 5, 2))
        f.write(params.tobytes())
        f.write(np.zeros(2, np.float32).tobytes())
    server.restore(path)
    client = ps_lib.PsClient(_addr(server))
    ver, flat = client.pull()
    assert ver == 5
    np.testing.assert_array_equal(flat, params)
    client.close()


def test_info_updates_last_version(server):
    c1 = ps_lib.PsClient(_addr(server))
    c1.init(np.zeros(2, np.float32))
    for _ in range(5):
        c1.push(0.1, np.ones(2, np.float32))
    c2 = ps_lib.PsClient(_addr(server))
    assert c2._last_version == 0
    assert c2.info() == (0, 2, 5)
    assert c2._last_version == 5
    c1.close()
    c2.close()


def test_reseed_tolerance_scales_with_history():
    srv = ps_lib.PsServer(port=0)
    port = srv.port
    client = ps_lib.PsClient(f"127.0.0.1:{port}", reconnect_timeout=20.0)
    assert client.reseed_tolerance == ps_lib.DEFAULT_RESEED_TOLERANCE
    client.init(np.zeros(4, np.float32))
    g = np.ones(4, np.float32)
    for _ in range(3 * ps_lib.RESEED_ABS_FLOOR):
        client.push(0.01, g)
    srv.stop()  # crash with NO snapshot
    srv2 = ps_lib.PsServer(port=port)
    try:
        with pytest.raises(RuntimeError, match="lost the run"):
            client.push(0.01, g)
    finally:
        client.close()
        srv2.stop()


def test_reseed_still_allowed_in_early_window():
    srv = ps_lib.PsServer(port=0)
    port = srv.port
    client = ps_lib.PsClient(f"127.0.0.1:{port}", reconnect_timeout=20.0)
    client.init(np.zeros(4, np.float32))
    g = np.ones(4, np.float32)
    for _ in range(ps_lib.RESEED_ABS_FLOOR // 2):
        client.push(0.01, g)
    srv.stop()
    srv2 = ps_lib.PsServer(port=port)  # empty: no snapshot yet
    try:
        assert client.push(0.01, g) >= 1   # re-seeds, then applies
    finally:
        client.close()
        srv2.stop()


def test_generation_helpers(tmp_path, monkeypatch):
    monkeypatch.delenv(ps_lib.GENERATION_ENV, raising=False)
    assert ps_lib.current_generation() == 0
    monkeypatch.setenv(ps_lib.GENERATION_ENV, "3")
    assert ps_lib.current_generation() == 3
    monkeypatch.setenv(ps_lib.GENERATION_ENV, "junk")
    assert ps_lib.current_generation() == 0
    snap = str(tmp_path / "s.snap")
    assert ps_lib.read_snapshot_generation(snap) == 0
    ps_lib.write_snapshot_generation(snap, 2)
    assert ps_lib.read_snapshot_generation(snap) == 2


def test_snapshot_sidecar_written_before_snapshot(tmp_path, monkeypatch):
    monkeypatch.setenv(ps_lib.GENERATION_ENV, "2")
    srv = ps_lib.PsServer(port=0)
    loop = ps_lib._SnapshotLoop(srv, str(tmp_path / "snaps"),
                                interval=3600)
    try:
        assert loop._snap() == "uninit"
        assert ps_lib.read_snapshot_generation(loop.path) == 2
        assert not os.path.exists(loop.path)
    finally:
        loop.stop()
        srv.stop()


def test_generation_env_parity_with_launcher():
    """The port's launcher exports the variable the snapshot loop
    reads, to every rank, and it is the JAX package's name."""
    from dtf_tpu.parallel import ps as jax_ps
    for rank in range(3):
        env = launch.build_env(rank, 3, "127.0.0.1:1234", generation=7)
        assert env[ps_lib.GENERATION_ENV] == "7"
    assert ps_lib.GENERATION_ENV == jax_ps.GENERATION_ENV


def _snapshot_with_done(server, path):
    client = ps_lib.PsClient(_addr(server))
    client.init(np.ones(3, np.float32))
    client.done()
    client.close()
    assert _done_arrives(server, 30), "the DONE never arrived"
    server.snapshot(path)


def test_strip_done_footer_file_level(server, tmp_path):
    path = str(tmp_path / "s.snap")
    assert ps_lib.strip_done_footer(path) is False  # missing file
    junk = str(tmp_path / "junk.snap")
    with open(junk, "wb") as f:
        f.write(b"not a snapshot at all")
    assert ps_lib.strip_done_footer(junk) is False
    _snapshot_with_done(server, path)
    with_footer = os.path.getsize(path)
    assert ps_lib.strip_done_footer(path) is True
    assert os.path.getsize(path) == with_footer - 16
    assert ps_lib.strip_done_footer(path) is False
    srv2 = ps_lib.PsServer(port=0)
    try:
        srv2.restore(path)
        c = ps_lib.PsClient(_addr(srv2))
        np.testing.assert_array_equal(c.pull()[1], np.ones(3, np.float32))
        c.close()
        done = threading.Event()
        threading.Thread(target=lambda: (srv2.wait(1), done.set()),
                         daemon=True).start()
        assert not done.wait(1.2), "stripped snapshot kept the tally"
    finally:
        srv2.stop()


def test_whole_job_restart_discards_stale_done_count(tmp_path,
                                                     monkeypatch):
    """A snapshot of attempt 0 restores under attempt 1 with its DONE
    tally discarded; params and version survive."""
    snap_dir = str(tmp_path / "snaps")
    monkeypatch.setenv(ps_lib.GENERATION_ENV, "0")
    srv = ps_lib.PsServer(port=0)
    loop = ps_lib._SnapshotLoop(srv, snap_dir, interval=3600)
    _snapshot_with_done(srv, loop.path)
    loop.stop()
    srv.stop()
    assert ps_lib.read_snapshot_generation(loop.path) == 0
    monkeypatch.setenv(ps_lib.GENERATION_ENV, "1")
    srv2 = ps_lib.PsServer(port=0, defer_accept=True)
    loop2 = ps_lib._SnapshotLoop(srv2, snap_dir, interval=3600)
    srv2.begin_accept()
    try:
        c = ps_lib.PsClient(_addr(srv2))
        np.testing.assert_array_equal(c.pull()[1], np.ones(3, np.float32))
        done = threading.Event()
        threading.Thread(target=lambda: (srv2.wait(1), done.set()),
                         daemon=True).start()
        assert not done.wait(1.5), "stale done_count double-counted"
        c.done()
        assert done.wait(10)
        c.close()
    finally:
        loop2.stop()
        srv2.stop()


def test_ps_only_restart_same_generation_keeps_done_count(tmp_path,
                                                          monkeypatch):
    snap_dir = str(tmp_path / "snaps")
    monkeypatch.setenv(ps_lib.GENERATION_ENV, "1")
    srv = ps_lib.PsServer(port=0)
    loop = ps_lib._SnapshotLoop(srv, snap_dir, interval=3600)
    _snapshot_with_done(srv, loop.path)
    loop.stop()
    srv.stop()
    srv2 = ps_lib.PsServer(port=0, defer_accept=True)
    loop2 = ps_lib._SnapshotLoop(srv2, snap_dir, interval=3600)
    srv2.begin_accept()
    try:
        done = threading.Event()
        threading.Thread(target=lambda: (srv2.wait(1), done.set()),
                         daemon=True).start()
        assert done.wait(10), "same-generation restore lost the tally"
    finally:
        loop2.stop()
        srv2.stop()


# ---------------------------------------------------------------------------
# the two packages together
# ---------------------------------------------------------------------------

def _jax_variables(name, x):
    """Variables of the JAX model's tree drawn with numpy (flax's own
    init of a whole model dispatches op by op for seconds)."""
    import functools

    import jax
    from dtf_tpu.models.registry import build_model
    jmodel, _ = build_model(name, num_classes=10) if name == "resnet20" \
        else build_model(name)
    init = (functools.partial(jmodel.init, train=False)
            if name == "resnet20" else jmodel.init)
    shapes = jax.eval_shape(init, jax.random.key(0), x)
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.1, s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name", ["resnet20", "transformer_small"])
def test_wire_is_ravel_pytree(name):
    """to_wire of a model holding the JAX model's parameters is
    ravel_pytree(params)[0] bit for bit (flax leaf order, flax
    layouts); from_wire inverts it."""
    from jax.flatten_util import ravel_pytree
    from dtf_tpu_torch.models.registry import build_model
    if name == "resnet20":
        v = _jax_variables(name, np.zeros((1, 8, 8, 3), np.float32))
    else:
        v = _jax_variables(name, np.zeros((1, 16), np.int32))
    want = np.asarray(ravel_pytree(v["params"])[0])
    kw = {"num_classes": 10} if name == "resnet20" else {}
    model, _ = build_model(name, **kw)
    model.load_state_dict(convert.from_flax(
        v["params"], v.get("batch_stats", {}), model))
    got = convert.to_wire(model)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    other, _ = build_model(name, **kw)
    convert.from_wire(want.copy(), other)
    for (k, a), b in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(a, b), k


def test_wire_order_is_level_by_level():
    """jax.tree_util sorts each dict level: a leaf under "a" precedes
    one under "a-b", which a sort of "/"-joined strings would invert."""
    from jax.flatten_util import ravel_pytree

    net = torch.nn.Module()
    net.add_module("a-b", torch.nn.Conv2d(1, 1, 1, bias=False))
    net.add_module("a", torch.nn.Conv2d(2, 3, 1, bias=False))
    with torch.no_grad():
        net.get_submodule("a").weight.fill_(1.0)
        net.get_submodule("a-b").weight.fill_(2.0)
    tree = {"a": {"kernel": np.ones((1, 1, 2, 3), np.float32)},
            "a-b": {"kernel": np.full((1, 1, 1, 1), 2.0, np.float32)}}
    paths = ["a/kernel", "a-b/kernel"]
    assert sorted(paths) != paths                        # the trap
    assert [leaf.path for leaf in convert.wire_layout(net)] == paths
    np.testing.assert_array_equal(convert.to_wire(net).numpy(),
                                  np.asarray(ravel_pytree(tree)[0]))


def test_clients_work_across_packages(server):
    """A JAX client against the port's store and a port client against
    the JAX store: the same bytes and versions."""
    from dtf_tpu.parallel import ps as jax_ps
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=33).astype(np.float32)
    grads = [rng.normal(size=33).astype(np.float32) for _ in range(3)]
    jax_srv = jax_ps.PsServer(port=0)
    try:
        results = []
        for srv, cls in ((server, jax_ps.PsClient),
                         (jax_srv, ps_lib.PsClient)):
            c = cls(f"127.0.0.1:{srv.port}")
            assert c.init(p0) == (0, 0)
            vers = [c.push(0.05, g) for g in grads[:2]]
            vers.append(c.push(0.05, grads[2], bf16=True))
            ver, flat = c.pull()
            ver16, flat16 = c.pull(bf16=True)
            assert vers == [1, 2, 3] and ver == ver16 == 3
            results.append((flat.copy(), flat16.copy()))
            c.done()
            c.close()
        for a, b in zip(*results):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
    finally:
        jax_srv.stop()


def test_snapshots_restore_across_packages(server, tmp_path):
    """A snapshot of either package's store restores in the other, and
    its re-dump is byte-identical."""
    from dtf_tpu.parallel import ps as jax_ps
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=17).astype(np.float32)
    jax_srv = jax_ps.PsServer(port=0)
    try:
        for src, dst in ((server, jax_srv), (jax_srv, server)):
            path = str(tmp_path / f"{id(src)}.snap")
            c = ps_lib.PsClient(f"127.0.0.1:{src.port}")
            c.init(p0)
            c.push(0.1, rng.normal(size=17).astype(np.float32))
            c.done()
            c.close()
            assert _done_arrives(src, 30), "the DONE never arrived"
            src.snapshot(path)
            dst.restore(path)
            dst.snapshot(path + ".again")
            with open(path, "rb") as f, open(path + ".again", "rb") as g:
                assert f.read() == g.read()
    finally:
        jax_srv.stop()


def test_bf16_bytes_equal_jax_packages():
    """The port's bf16 wire bytes are the JAX package's, NaN payloads
    included, on whichever conversion each package has here."""
    from dtf_tpu.parallel import ps as jax_ps
    x = _bf16_probe(2, 10_000, 50.0)
    assert ps_lib._f32_to_bf16_bytes(x) == jax_ps._f32_to_bf16_bytes(x)
    b = ps_lib._f32_to_bf16_bytes(x)
    np.testing.assert_array_equal(
        ps_lib._bf16_bytes_to_f32(b).view(np.uint32),
        jax_ps._bf16_bytes_to_f32(b).view(np.uint32))


def test_store_update_is_bit_identical_across_stores(store):
    """The same pushes leave the same bits in the port's store (native
    or Python) and the JAX package's: the native update has no FMA
    contraction (-O3, no -march)."""
    from dtf_tpu.parallel import ps as jax_ps
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=4099).astype(np.float32)
    pushes = [(float(np.float32(rng.uniform(0.001, 0.5))),
               rng.normal(0, 3, size=4099).astype(np.float32))
              for _ in range(6)]
    out = []
    for srv in (ps_lib.PsServer(port=0), jax_ps.PsServer(port=0)):
        try:
            c = ps_lib.PsClient(f"127.0.0.1:{srv.port}")
            c.init(p0)
            for lr, g in pushes:
                c.push(lr, g)
            out.append(c.pull()[1].copy())
            c.close()
        finally:
            srv.stop()
    # and numpy's own order of roundings, the Python store's
    v, p = np.zeros_like(p0), p0.copy()
    for lr, g in pushes:
        v *= np.float32(0.9)
        v -= np.float32(lr) * g
        p += v
    for got in out:
        np.testing.assert_array_equal(got.view(np.uint32), p.view(np.uint32))


def test_one_worker_matches_jax(tiny_cifar, monkeypatch):
    """resnet20 at 8x8, f32, batch 8, 3 synthetic steps: the JAX
    _worker against a store it initializes with its model's initial
    vector, the port's against a second store holding the same bytes.
    Final losses and the stores' parameters within PARITY_TOL, the same
    version."""
    from dtf_tpu.config import Config as JaxConfig
    from dtf_tpu.parallel import ps as jax_ps
    kw = dict(model="resnet20", dataset="cifar10", batch_size=8,
              train_steps=3, use_synthetic_data=True, skip_eval=True,
              skip_checkpoint=True, model_dir="", log_steps=1,
              distribution_strategy="parameter_server", ps_mode="async")
    # the JAX worker's INIT wins an empty store with its model's
    # initial vector; the port's loses to a store holding those bytes
    proposed = []
    jax_init = jax_ps.PsClient.init
    monkeypatch.setattr(jax_ps.PsClient, "init", lambda self, params: (
        proposed.append(np.array(params, np.float32)),
        jax_init(self, params))[1])
    out = {}
    for name, worker, cfg in (
            ("jax", jax_ps._worker, JaxConfig(**kw)),
            ("port", ps_lib._worker, Config(device="cpu", **kw))):
        srv = ps_lib.PsServer(port=0)
        try:
            c = ps_lib.PsClient(_addr(srv))
            if proposed:
                c.init(proposed[0])
            stats = worker(cfg, _addr(srv), 0, 1)
            ver, flat = c.pull()
            c.close()
        finally:
            srv.stop()
        out[name] = (stats["loss"], ver, flat.copy())
    (jl, jv, jf), (tl, tv, tf) = out["jax"], out["port"]
    assert jv == tv == 3
    assert abs(jl - tl) <= PARITY_TOL * max(1.0, abs(jl))
    np.testing.assert_allclose(tf, jf, rtol=PARITY_TOL, atol=PARITY_TOL)
    assert not np.array_equal(tf, proposed[0])   # the pushes moved it


def test_two_workers_read_the_jax_workers_batches(tmp_path, monkeypatch):
    """Two workers over written CIFAR-10 files: each port worker's
    batches are the JAX worker's of the same worker_id, bit for bit."""
    import dtf_tpu.data.cifar as jax_cifar
    from dtf_tpu.config import Config as JaxConfig
    from dtf_tpu.parallel import ps as jax_ps
    from dtf_tpu_torch.data import cifar

    rng = np.random.default_rng(6)
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        cifar.write_binary_file(str(d / name),
                                rng.integers(0, 256, (24, 32, 32, 3)),
                                rng.integers(0, 10, 24))
    seen = {}

    def recording(module, key):
        fn = module.cifar_input_fn

        def wrapped(*args, **kw):
            it = fn(*args, **kw)
            if not args[1]:                  # eval: not recorded
                return it
            wid = kw.get("process_id", 0)

            def gen():
                for batch in it:
                    seen.setdefault((key, wid), []).append(
                        [np.array(x) for x in batch])
                    yield batch
            return gen()
        monkeypatch.setattr(module, "cifar_input_fn", wrapped)

    recording(jax_cifar, "jax")
    recording(cifar, "port")
    kw = dict(model="trivial", use_trivial_model=True, dataset="cifar10",
              data_dir=str(tmp_path), batch_size=8, train_steps=2,
              skip_eval=True, skip_checkpoint=True, model_dir="",
              log_steps=1, distribution_strategy="parameter_server",
              ps_mode="async")
    for wid in (0, 1):
        for worker, cfg in ((jax_ps._worker, JaxConfig(**kw)),
                            (ps_lib._worker, Config(device="cpu", **kw))):
            srv = ps_lib.PsServer(port=0)
            try:
                worker(cfg, _addr(srv), wid, 2)
            finally:
                srv.stop()
    for wid in (0, 1):
        jax_b, port_b = seen[("jax", wid)], seen[("port", wid)]
        assert len(jax_b) == len(port_b) == 2
        for jb, pb in zip(jax_b, port_b):
            for a, b in zip(jb, pb):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert not np.array_equal(seen[("port", 0)][0][0],
                              seen[("port", 1)][0][0])


# ---------------------------------------------------------------------------
# the port's own semantics
# ---------------------------------------------------------------------------

def test_two_worker_threads_apply_every_push(tiny_cifar):
    """Two port workers in threads against one store: every push lands
    (version = the sum of their steps) and both DONEs arrive."""
    srv = ps_lib.PsServer(port=0)
    try:
        results = {}

        def run(wid, steps):
            results[wid] = ps_lib._worker(_async_cfg(train_steps=steps),
                                          _addr(srv), wid, 2)

        threads = [threading.Thread(target=run, args=(w, s))
                   for w, s in ((0, 3), (1, 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert _done_arrives(srv, 30, 2), "the workers' DONEs never arrived"
        c = ps_lib.PsClient(_addr(srv))
        assert c.info()[2] == 5
        c.close()
        assert all(np.isfinite(r["loss"]) for r in results.values())
    finally:
        srv.stop()


def _done_arrives(srv, within: float, n: int = 1) -> bool:
    """True once ``n`` DONEs reached the store, within ``within`` s (the
    store's own wait has no bound: it runs in a daemon thread)."""
    done = threading.Event()
    threading.Thread(target=lambda: (srv.wait(n), done.set()),
                     daemon=True).start()
    return done.wait(within)


def test_done_is_delivered_when_a_worker_dies(tiny_cifar, monkeypatch):
    """A worker that dies mid-run (its input fails at the second batch)
    still delivers DONE, after pushing the first step."""
    real = ps_lib._worker_inputs

    def failing(*args):
        train, eval_fn = real(*args)

        def gen():
            yield next(train)
            raise RuntimeError("input died")
        return gen(), eval_fn

    monkeypatch.setattr(ps_lib, "_worker_inputs", failing)
    srv = ps_lib.PsServer(port=0)
    try:
        with pytest.raises(RuntimeError, match="input died"):
            ps_lib._worker(_async_cfg(train_steps=3), _addr(srv), 0, 1)
        assert _done_arrives(srv, 10)
        c = ps_lib.PsClient(_addr(srv))
        assert c.info()[2] == 1
        c.close()
    finally:
        srv.stop()


def test_no_done_after_preemption(tiny_cifar):
    """A preempted worker acts on its own latch after its step's push
    and leaves without DONE (it re-runs and re-delivers)."""
    preemption.install()
    preemption.latch()
    srv = ps_lib.PsServer(port=0)
    try:
        with pytest.raises(preemption.Preempted) as e:
            ps_lib._worker(_async_cfg(train_steps=3), _addr(srv), 0, 1)
        assert e.value.step == 1
        assert not _done_arrives(srv, 1.0)
        c = ps_lib.PsClient(_addr(srv))
        assert c.info()[2] == 1
        c.close()
    finally:
        srv.stop()


def test_ps_drop_fires_and_reconnects(tiny_cifar, tmp_path):
    """--fault ps_drop@version:2 arms on the port: the worker's client
    severs its connection at version 2, reconnects, and finishes every
    step; the fault is in the trace."""
    from dtf_tpu_torch.cli.runner import run
    trace_dir = str(tmp_path / "trace")
    stats = run(_async_cfg(train_steps=4, fault="ps_drop@version:2",
                           ps_snapshot_dir=str(tmp_path / "snaps"),
                           trace_dir=trace_dir))
    assert stats["ps_version"] == 4
    assert stats["ps_client"]["ps_client_reconnects"] >= 1
    trace.flush()
    records = [r for p in os.listdir(trace_dir)
               for r in trace.read_records(os.path.join(trace_dir, p))]
    assert any(r.get("fault_kind") == "ps_drop" for r in records)
    assert any(r["name"] == "ps_reconnect" for r in records)
    assert {"step", "ps_pull", "ps_push"} <= {
        r["name"] for r in records if r["kind"] == "span"}


@pytest.mark.parametrize("kw,match", [
    ({"model": "moe_transformer_small"}, "not supported in async"),
    ({"model": "pipeline_transformer_small"}, "not supported in async"),
    ({"eval_only": True}, "eval_only"),
    ({"clip_grad_norm": 1.0}, "clip_grad_norm"),
])
def test_worker_refusals(kw, match):
    """The JAX worker's refusals, raised before any connection."""
    with pytest.raises(ValueError, match=match):
        ps_lib._worker(_async_cfg(**kw), "127.0.0.1:1", 0, 1)


def test_file_coordinator_is_refused(tmp_path):
    """Rank 0 binds the coordinator's TCP port: a file:// rendezvous is
    refused by the launcher and by run_async."""
    cmd = [sys.executable, "-c", "pass", "--ps_mode", "async"]
    with pytest.raises(ValueError, match="host:port"):
        launch.launch_local(cmd, 3, f"file://{tmp_path}/rdv",
                            str(tmp_path / "logs"), timeout_s=60)
    with pytest.raises(ValueError, match="host:port"):
        ps_lib.run_async(_async_cfg(process_count=3, process_id=0,
                                    coordinator_address="file:///x"))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps_lib.run_async(_async_cfg(device="cuda"))


def test_ps_rank_beats_its_heartbeat(tmp_path, monkeypatch):
    """The PS rank beats the launcher's heartbeat while it serves (the
    JAX PS rank does not), touches no card, and returns its store and
    final version."""
    from dtf_tpu_torch.obs.watchdog import heartbeat_path, read_heartbeat
    monkeypatch.setenv("DTF_HEARTBEAT_DIR", str(tmp_path))
    monkeypatch.setenv("DTF_PROCESS_ID", "0")
    port = _free_port()
    cfg = _async_cfg(process_count=2, process_id=0, heartbeat_secs=0.2,
                     coordinator_address=f"127.0.0.1:{port}")
    out = {}
    t = threading.Thread(target=lambda: out.update(ps_lib.run_async(cfg)))
    t.start()
    path = heartbeat_path(str(tmp_path), 0)
    stamps = set()
    deadline = time.time() + 10
    while len(stamps) < 3 and time.time() < deadline:
        hb = read_heartbeat(path)
        if hb is not None:
            stamps.add(hb["ts"])
        time.sleep(0.1)
    assert len(stamps) >= 3
    c = ps_lib.PsClient(f"127.0.0.1:{port}")
    c.init(np.zeros(3, np.float32))
    c.push(0.1, np.ones(3, np.float32))
    c.done()
    c.close()
    t.join(timeout=30)
    assert out == {"ps_store": native_ps.store_path(), "ps_version": 1}
    assert not torch.cuda.is_initialized()


def test_native_library_builds_without_libjpeg():
    """libdtf_ps is its own library, linked without -ljpeg."""
    assert "-ljpeg" not in native_ps.LDLIBS
    assert os.path.basename(native_ps.lib_path()).startswith("libdtf_ps-")
    if not has_native():
        pytest.skip("no C++ compiler here")
    assert native_ps.store_path() == "native"
    if shutil.which("ldd"):
        out = subprocess.run(["ldd", native_ps.lib_path()], timeout=30,
                             capture_output=True, text=True)
        assert "libjpeg" not in out.stdout

