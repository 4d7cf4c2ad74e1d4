"""The port's data service (``dtf_tpu_torch/data/service``) on the CPU:
its contract tests, mirrored from ``tests/test_data_service.py``, and
its batches against the JAX package's on the same written shards.

The contract, stated once: merged batch ``n`` is a pure function of
``(seed, process, num_shards, n)`` -- invariant to worker count,
process lifetime and cache state -- so ``start_step=n`` replays the
exact suffix of the stream.  Against the JAX package: ``ShardReader``
batches for several positions over two epochs and the first batches of
the inline merged stream, bit-identical, with both packages decoding
through PIL (their native probes patched off) or both through their
native libraries where both load.  Shards: 64x80 JPEGs from a seed
(``testing/imagenet.py``), 8 a file.
"""

import json
import os

import numpy as np
import pytest
import torch

from dtf_tpu.data import imagenet as jimagenet
from dtf_tpu.data.service import ServiceStream as JaxServiceStream
from dtf_tpu.data.service import make_reader as jax_make_reader
from dtf_tpu_torch import chaos
from dtf_tpu_torch.data import imagenet, records
from dtf_tpu_torch.data.service import (DecodeCache, ServiceStream,
                                        ShardReader, index_tfrecord_file,
                                        make_reader, service_input_fn,
                                        shard_positions)
from dtf_tpu_torch.obs.registry import MetricsRegistry, default_registry
from dtf_tpu_torch.obs.watchdog import ReaderLagWatchdog
from dtf_tpu_torch.testing.imagenet import write_shards

torch.set_num_threads(1)

PER_FILE = 8


@pytest.fixture(autouse=True)
def clean_chaos():
    yield
    chaos.disable()


@pytest.fixture(scope="module")
def shards_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("svc_shards"))
    write_shards(root, num_train_files=3, per_train_file=PER_FILE,
                 num_val_files=0)
    return root


@pytest.fixture(params=["pil", "native"])
def decode(request, monkeypatch):
    """Pin both packages to one decode path."""
    if request.param == "pil":
        for mod in (imagenet, jimagenet):
            monkeypatch.setattr(mod, "_native_jpeg", None)
            monkeypatch.setattr(mod, "_native_probed", True)
    elif (imagenet.native_jpeg_module() is None
          or jimagenet.native_jpeg_module() is None):
        pytest.skip("a package's native decode library is not loaded")
    return request.param


def _collect(stream, n):
    out = [next(stream) for _ in range(n)]
    stream.close()
    return out


def _streams_equal(got, want):
    assert len(got) == len(want)
    for i, ((gi, gl), (wi, wl)) in enumerate(zip(got, want)):
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi), i
        assert gl.dtype == wl.dtype and np.array_equal(gl, wl), i


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["uint8", "float32"])
def test_shard_reader_batches_match_jax(shards_dir, decode, wire):
    """Shard-local batches k over two epochs (6 a shard-epoch here),
    out of order: both shards of one process, and the shard of the
    second process's file split."""
    for shard, pid, pcount in ((0, 0, 1), (1, 0, 1), (0, 1, 2)):
        kw = dict(data_dir=shards_dir, shard=shard, num_shards=2,
                  batch_size=2, seed=11, process_id=pid,
                  process_count=pcount, wire=wire)
        ours, theirs = make_reader(**kw), jax_make_reader(**kw)
        assert ours.batches_per_epoch == theirs.batches_per_epoch
        for k in (0, 5, 1, ours.batches_per_epoch + 2):
            (gi, gl), (wi, wl) = ours.batch(k), theirs.batch(k)
            assert gi.dtype == wi.dtype and np.array_equal(gi, wi), k
            assert np.array_equal(gl, wl), k
        ours.close()
        theirs.close()


def test_inline_merged_stream_matches_jax(shards_dir, decode):
    kw = dict(seed=7, num_shards=3, num_workers=0)
    _streams_equal(_collect(ServiceStream(shards_dir, 4, **kw), 7),
                   _collect(JaxServiceStream(shards_dir, 4, **kw), 7))


def test_shard_positions_match_jax():
    from dtf_tpu.data.service import shard_positions as jax_positions
    for n in range(17):
        for s in (1, 3, 4):
            assert shard_positions(n, s) == jax_positions(n, s)


# ---------------------------------------------------------------------------
# reader: indexing + position-derived batches
# ---------------------------------------------------------------------------

def test_index_tfrecord_file(shards_dir):
    path = os.path.join(shards_dir, "train-00000-of-01024")
    idx = index_tfrecord_file(path)
    assert len(idx) == PER_FILE
    raws = list(records.read_tfrecord_file(path))
    with open(path, "rb") as f:
        for (off, length), raw in zip(idx, raws):
            f.seek(off)
            assert f.read(length) == raw


def test_index_rejects_truncated(tmp_path, shards_dir):
    src = os.path.join(shards_dir, "train-00000-of-01024")
    trunc = tmp_path / "trunc"
    trunc.write_bytes(open(src, "rb").read()[:-7])
    with pytest.raises(IOError):
        index_tfrecord_file(str(trunc))


def test_shard_reader_validation(shards_dir):
    files = sorted(os.path.join(shards_dir, f)
                   for f in os.listdir(shards_dir))
    with pytest.raises(ValueError, match="outside"):
        ShardReader(files, shard=3, num_shards=3, batch_size=4)
    with pytest.raises(ValueError, match="at least one file"):
        ShardReader(files, shard=3, num_shards=4, batch_size=4)
    with pytest.raises(ValueError, match="fewer"):
        ShardReader(files, shard=1, num_shards=3, batch_size=32)
    with pytest.raises(ValueError, match="wire"):
        ShardReader(files, shard=0, num_shards=3, batch_size=4, wire="u16")


def test_batch_is_pure_function_of_position(shards_dir):
    kw = dict(data_dir=shards_dir, shard=0, num_shards=2, batch_size=4,
              seed=11)
    r1 = make_reader(**kw)
    a7, b7 = r1.batch(7)
    a3, _ = r1.batch(3)      # out-of-order access
    a7b, b7b = r1.batch(7)   # repeat
    r1.close()
    r2 = make_reader(**kw)   # a fresh lifetime
    a7c, b7c = r2.batch(7)
    r2.close()
    assert np.array_equal(a7, a7b) and np.array_equal(a7, a7c)
    assert np.array_equal(b7, b7b) and np.array_equal(b7, b7c)
    assert not np.array_equal(a7, a3)
    assert a7.dtype == np.uint8 and a7.shape == (4, 224, 224, 3)


def test_epoch_reshuffles_and_seed_rederives(shards_dir):
    r = make_reader(shards_dir, 0, 2, batch_size=4, seed=11)
    assert not np.array_equal(r.order(0), r.order(1))
    r2 = make_reader(shards_dir, 0, 2, batch_size=4, seed=12)
    assert not np.array_equal(r.order(0), r2.order(0))
    r.close()
    r2.close()


def test_shard_positions_round_robin():
    assert shard_positions(0, 3) == [0, 0, 0]
    assert shard_positions(7, 3) == [3, 2, 2]
    for n in range(17):
        pos = shard_positions(n, 4)
        assert sum(pos) == n and max(pos) - min(pos) <= 1


# ---------------------------------------------------------------------------
# merged stream: resume replay, worker invariance, chaos respawn
# ---------------------------------------------------------------------------

def test_stream_resume_replays_exact_suffix(shards_dir):
    want = _collect(ServiceStream(shards_dir, 4, seed=3, num_shards=2), 10)
    resumed = ServiceStream(shards_dir, 4, seed=3, num_shards=2,
                            start_step=6)
    assert resumed.position == 6
    _streams_equal(_collect(resumed, 4), want[6:])


def test_stream_num_shards_changes_stream(shards_dir):
    a = _collect(ServiceStream(shards_dir, 4, seed=3, num_shards=2), 4)
    b = _collect(ServiceStream(shards_dir, 4, seed=3, num_shards=3), 4)
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))


def test_auto_worker_count_resolves(shards_dir):
    s = ServiceStream(shards_dir, 4, seed=1, num_shards=2, num_workers=-1)
    cores = os.cpu_count() or 1
    try:
        assert s.num_workers == (0 if cores < 2 else min(2, cores))
    finally:
        s.close()


def test_stream_invariant_to_worker_count(shards_dir):
    """Workers decide WHO computes a batch, never WHAT it is: two spawned
    readers yield the inline stream bit for bit."""
    want = _collect(ServiceStream(shards_dir, 4, seed=7, num_shards=3,
                                  num_workers=0), 9)
    got = _collect(ServiceStream(shards_dir, 4, seed=7, num_shards=3,
                                 num_workers=2), 9)
    _streams_equal(got, want)


def test_reader_crash_respawns_with_unchanged_stream(shards_dir):
    """reader_crash@batch:N SIGKILLs the owning worker as the consumer
    reaches batch N; the respawn makes the fault invisible."""
    want = _collect(ServiceStream(shards_dir, 4, seed=7, num_shards=2), 8)
    chaos.configure("reader_crash@batch:3")
    reg = MetricsRegistry()
    s = ServiceStream(shards_dir, 4, seed=7, num_shards=2, num_workers=1,
                      registry=reg)
    _streams_equal(_collect(s, 8), want)
    assert s.respawns >= 1
    assert reg.get("data_reader_respawns").value >= 1


def test_reader_crash_writes_supervisor_event_with_positions(
        shards_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("DTF_HEARTBEAT_DIR", str(tmp_path))
    monkeypatch.setenv("DTF_PROCESS_ID", "3")
    chaos.configure("reader_crash@batch:3")
    s = ServiceStream(shards_dir, 4, seed=7, num_shards=2, num_workers=1)
    _collect(s, 8)
    assert s.respawns >= 1
    with open(tmp_path / "supervisor_events.jsonl") as f:
        recs = [json.loads(line) for line in f]
    crash = [r for r in recs if r["event"] == "reader_crash"]
    assert len(crash) == s.respawns
    r = crash[0]
    assert r["rank"] == 3 and r["worker"] == 0
    assert set(r["shard_positions"]) == {"0", "1"}
    assert all(isinstance(v, int) and v >= 1
               for v in r["shard_positions"].values())
    assert "ts" in r and r["respawns"] >= 1


def test_reader_crash_inline_is_harmless(shards_dir):
    chaos.configure("reader_crash@batch:2")
    assert len(_collect(ServiceStream(shards_dir, 4, seed=7,
                                      num_shards=2), 4)) == 4


def test_worker_error_surfaces_loudly(tmp_path):
    write_shards(str(tmp_path), num_train_files=1, per_train_file=8,
                 num_val_files=0)
    path = os.path.join(str(tmp_path), "train-00000-of-01024")
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-9])  # a torn final record
    with pytest.raises(OSError, match="truncated"):
        ServiceStream(str(tmp_path), 4, num_shards=1, num_workers=0)


def test_spawned_readers_never_see_a_card(shards_dir, monkeypatch):
    """The readers start with CUDA_VISIBLE_DEVICES="" whatever the
    parent's environment, which the start leaves as it was."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    seen = {}
    import dtf_tpu_torch.data.service.pool as pool
    start = pool.mp.get_context("spawn").Process.start

    def spy(proc):
        seen["env"] = os.environ.get("CUDA_VISIBLE_DEVICES")
        return start(proc)

    monkeypatch.setattr(pool.mp.get_context("spawn").Process, "start", spy)
    s = ServiceStream(shards_dir, 4, seed=1, num_shards=2, num_workers=1)
    try:
        next(s)
    finally:
        s.close()
    assert seen["env"] == ""
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"


def test_close_ends_a_pooled_wait(shards_dir):
    """close() from another thread ends the consumer's wait for a batch
    (the runner closes the stream while the prefetch thread waits)."""
    import threading
    s = ServiceStream(shards_dir, 4, seed=1, num_shards=2, num_workers=1)
    next(s)
    threading.Timer(0.2, s.close).start()
    with pytest.raises(StopIteration):
        for _ in range(100):
            next(s)
    assert s.respawns == 0


# ---------------------------------------------------------------------------
# decode-once cache tier
# ---------------------------------------------------------------------------

def test_cache_epoch2_bit_identical_and_served_from_cache(shards_dir,
                                                         tmp_path):
    bare = make_reader(shards_dir, 0, 2, batch_size=4, seed=5)
    bpe = bare.batches_per_epoch
    want = [bare.batch(k) for k in range(2 * bpe)]
    bare.close()
    cached = make_reader(shards_dir, 0, 2, batch_size=4, seed=5,
                         cache_dir=str(tmp_path))
    for k, (wi, wl) in enumerate(want):
        gi, gl = cached.batch(k)
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl), k
    hits, lookups = cached.cache_stats()
    assert lookups == 2 * bpe * 4
    assert hits >= bpe * 4
    cached.close()


def test_cache_survives_reopen_and_drops_torn_tail(tmp_path):
    rng = np.random.default_rng(0)
    img_a = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    img_b = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    c = DecodeCache(str(tmp_path), shard=0, limit_bytes=0)
    assert c.put(0, img_a, 17, np.array([[0.1, 0.2, 0.3, 0.4]], np.float32))
    assert c.put(1, img_b, 23, None)
    assert not c.put(1, img_b, 23, None)
    c.close()
    with open(c.data_path, "r+b") as f:
        f.truncate(img_a.nbytes + 10)
    c2 = DecodeCache(str(tmp_path), shard=0, limit_bytes=0)
    img, label, bbox = c2.get(0)
    assert np.array_equal(img, img_a) and label == 17
    assert bbox.shape == (1, 4) and abs(bbox[0][2] - 0.3) < 1e-6
    assert c2.get(1) is None
    c2.close()


def test_cache_files_are_the_jax_packages(tmp_path):
    """The same puts write the JAX cache's bytes, and each package reads
    the other's cache."""
    from dtf_tpu.data.service import DecodeCache as JaxDecodeCache
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
    box = np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)
    ours = DecodeCache(str(tmp_path / "a"), 1, 0, num_shards=2)
    theirs = JaxDecodeCache(str(tmp_path / "b"), 1, 0, num_shards=2)
    for c in (ours, theirs):
        c.put(3, img, 9, box)
        c.put(4, img[:2], 1, None)
        c.close()
    for name in (os.path.basename(ours.data_path),
                 os.path.basename(ours.idx_path)):
        assert (tmp_path / "a" / name).read_bytes() == (
            tmp_path / "b" / name).read_bytes()
    again = DecodeCache(str(tmp_path / "b"), 1, 0, num_shards=2)
    got, label, bbox = again.get(3)
    assert np.array_equal(got, img) and label == 9
    assert np.array_equal(bbox, box)
    again.close()


def test_cache_limit_stops_inserting(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3),
                                            dtype=np.uint8)
    c = DecodeCache(str(tmp_path), shard=0, limit_bytes=img.nbytes + 1)
    assert c.put(0, img, 1, None)
    assert not c.put(1, img, 2, None)
    assert c.get(0) is not None and c.get(1) is None
    c.close()


def test_cache_identity_is_in_the_filename(tmp_path):
    a = DecodeCache(str(tmp_path), 0, 0, num_shards=2)
    b = DecodeCache(str(tmp_path), 0, 0, num_shards=4)
    assert a.data_path != b.data_path
    a.put(0, np.zeros((4, 4, 3), np.uint8), 1, None)
    assert b.get(0) is None
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# observability and the input_fn
# ---------------------------------------------------------------------------

def test_stream_exports_lag_and_hit_gauges(shards_dir, tmp_path):
    reg = MetricsRegistry()
    s = ServiceStream(shards_dir, 4, seed=1, num_shards=2,
                      cache_dir=str(tmp_path), registry=reg)
    _collect(s, 4)
    assert reg.get("data_reader_lag_s").value >= 0.0
    assert "data_cache_hit_ratio" in reg.names()


def test_stream_exports_to_the_default_registry(shards_dir):
    """Without an injected registry the service's gauges and counter
    land on default_registry(), one process-global instance."""
    reg = default_registry()
    assert reg is default_registry()
    reg.reset()
    try:
        _collect(ServiceStream(shards_dir, 4, seed=1, num_shards=2), 2)
        assert reg.get("data_reader_lag_s").value >= 0.0
        assert reg.get("data_reader_respawns").value == 0
    finally:
        reg.reset()


def test_reader_lag_watchdog_flags_stall_over_floor():
    wd = ReaderLagWatchdog(factor=10.0, min_lag_s=0.5, warmup=4)
    for i in range(8):
        assert not wd.observe(i, 0.01)
    assert not wd.observe(8, 0.4)
    assert wd.observe(9, 0.9)
    assert wd.trigger_count == 1
    assert wd.observe(10, 0.9)


def test_service_input_fn_is_a_positioned_stream(shards_dir):
    s = service_input_fn(shards_dir, 4, seed=3, num_shards=2,
                         cache_limit_mb=0, start_step=5)
    try:
        assert isinstance(s, ServiceStream) and s.position == 5
        assert s.num_workers == 0
    finally:
        s.close()


def test_reader_modules_import_no_torch():
    """What a spawned reader imports -- the pool, the reader, the
    ImageNet preprocessing, the records, the native bindings, chaos and
    tracing -- loads no torch (nor JAX): the readers stay off the card."""
    import subprocess
    import sys
    code = ("import sys; "
            "import dtf_tpu_torch.data.service.pool, "
            "dtf_tpu_torch.data.service.reader, dtf_tpu_torch.native.jpeg; "
            "from dtf_tpu_torch.data.service.pool import _worker_main; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'dtf_tpu')]; assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_reader_killed_mid_message_is_respawned(shards_dir):
    """A reader SIGKILLed while its batch is half-written into the pipe
    (the consumer lagging, batches of 16 far past the pipe's buffer):
    the consumer's read ends and the reader is respawned, where it would
    otherwise wait forever on the rest of the message."""
    import threading
    import time
    want = _collect(ServiceStream(shards_dir, 16, seed=2, num_shards=1), 5)
    chaos.configure("reader_crash@batch:1")
    s = ServiceStream(shards_dir, 16, seed=2, num_shards=1, num_workers=1,
                      registry=MetricsRegistry())
    got = [next(s)]
    time.sleep(2.0)      # the reader runs ahead and blocks mid-message
    out = {}

    def rest():
        out["batches"] = [next(s) for _ in range(4)]

    t = threading.Thread(target=rest, daemon=True)
    t.start()
    t.join(timeout=120)
    s.close()
    assert not t.is_alive(), "the consumer hung on a torn message"
    _streams_equal(got + out["batches"], want)
    assert s.respawns >= 1


_DYING_PARENT = """
import os, sys
from dtf_tpu_torch.data.service import ServiceStream
if __name__ == "__main__":
    s = ServiceStream(sys.argv[1], 4, seed=1, num_shards=2, num_workers=1)
    next(s)
    print("READER=%d" % s._procs[0].pid, flush=True)
    os._exit(77)     # no close(), no atexit: a crash
"""


def test_readers_end_when_their_parent_dies(shards_dir, tmp_path):
    """A training process that dies without closing its stream (an
    injected crash is an os._exit) leaves no reader behind."""
    import re
    import subprocess
    import sys
    import time
    script = tmp_path / "dying_parent.py"
    script.write_text(_DYING_PARENT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, str(script), shards_dir],
                          cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 77, proc.stderr[-2000:]
    pid = int(re.search(r"READER=(\d+)", proc.stdout).group(1))

    def alive():
        try:
            with open(f"/proc/{pid}/status") as f:
                return "\nState:\tZ" not in f.read()
        except FileNotFoundError:
            return False

    deadline = time.time() + 60
    while alive() and time.time() < deadline:
        time.sleep(0.2)
    if alive():
        os.kill(pid, 9)
        pytest.fail("the reader outlived its parent")
