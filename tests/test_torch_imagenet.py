"""The port's ImageNet input path against the JAX package, on the CPU:
the TFRecord and Example formats (``data/records.py``), the native
decode library (``native/``), ImageNet preprocessing and the padded
eval (``data/imagenet.py``), ``all_processes_max`` over gloo, and
``imagenet_main --data_dir`` end to end.

The tests write their own shards (``testing/imagenet.py``: 64x80 JPEGs
from a seed, 6 a file), so nothing is downloaded.  Both packages run the
same decode path in each case: PIL (their module-level native probes
patched off in the test), or each package's native library where both
load (skipped otherwise: the JAX package's library is not built in a
fresh checkout).  Tolerances: records, draws, preprocessed images,
batches and masks bit-identical; ``imagenet_main``'s per-step losses
(trivial model, float32, the same initial weights through
``convert.py``) 1e-5 relative, its eval loss 1e-4; a crash-resumed run
bit-identical to its uninterrupted twin.
"""

import glob
import json
import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dtf_tpu.data import imagenet as jimagenet
from dtf_tpu.data import records as jrecords
from dtf_tpu_torch import convert, native
from dtf_tpu_torch.cli import imagenet_main, launch, runner
from dtf_tpu_torch.data import imagenet, pipeline, records
from dtf_tpu_torch.native import jpeg as native_jpeg
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.testing.imagenet import make_jpeg, write_shards
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV

torch.set_num_threads(1)

# every gloo group this file's ranks start gives up on a dead peer within
# 120 s (runtime/mesh.py TIMEOUT_ENV), well inside the suite's limit
os.environ.setdefault(TIMEOUT_ENV, "120")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_FILE = 6


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagenet_shards"))
    write_shards(root, num_train_files=2, per_train_file=PER_FILE,
                 num_val_files=3, per_val_file=5, seed=0)
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


def _raw_records(path):
    return list(records.read_tfrecord_file(path))


# ---------------------------------------------------------------------------
# records: CRC32C, TFRecord framing, Example wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data", [b"", b"a", b"123456789",
                                  bytes(range(256)) * 3])
def test_crc32c_matches_jax(data):
    assert records.crc32c(data) == jrecords.crc32c(data)
    assert records.masked_crc32c(data) == jrecords.masked_crc32c(data)
    if native.available():
        assert native.crc32c(data) == records.crc32c(data)
    assert records.crc32c(b"123456789") == 0xE3069283   # the check value


def test_example_and_tfrecord_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    feats = {"image/encoded": make_jpeg(rng, 16, 24),
             "image/class/label": [7],
             "image/object/bbox/ymin": [0.25, 0.5],
             "image/object/bbox/xmax": np.asarray([0.75, 1.0], np.float32)}
    ex = records.build_example(feats)
    assert ex == jrecords.build_example(feats)
    got, want = records.parse_example(ex), jrecords.parse_example(ex)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
    recs = [ex, b"", b"x" * 300]
    records.write_tfrecord_file(str(tmp_path / "a"), recs)
    jrecords.write_tfrecord_file(str(tmp_path / "b"), recs)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert records.count_tfrecord_records(str(tmp_path / "a")) == 3
    assert _raw_records(str(tmp_path / "a")) == recs
    assert list(jrecords.read_tfrecord_file(str(tmp_path / "a"))) == recs


def test_native_library_is_the_ports_own_build():
    """Built from dtf_tpu_torch/native into dtf_tpu_torch/_build; never
    the JAX package's library or directory."""
    if not native.available():
        pytest.skip(f"no native build here: {native.unavailable_reason}")
    lib = native.load()
    build = os.path.join(REPO, "dtf_tpu_torch", "_build")
    assert os.path.dirname(lib._name) == build
    assert lib._name == native.lib_path()
    assert "dtf_tpu/native" not in lib._name.replace(os.sep, "/")
    assert native.decode_path() == "native"


def test_native_build_failure_falls_back_to_pil_loudly(tmp_path,
                                                      monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_probed", False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "lib_path",
                        lambda: str(tmp_path / "libdtf_native-x.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        assert native.load() is None
        assert native.load() is None
    warned = [r for r in caplog.records if "PIL" in r.getMessage()]
    assert len(warned) == 1
    assert native.decode_path() == "pil" and native.unavailable_reason
    with pytest.raises(ImportError, match="unavailable"):
        native_jpeg.shape(b"\xff\xd8")
    path = str(tmp_path / "recs")
    records.write_tfrecord_file(path, [b"abc", b"de"])
    assert _raw_records(path) == [b"abc", b"de"]   # the Python reader


# ---------------------------------------------------------------------------
# preprocessing: bit-identical on either decode path
# ---------------------------------------------------------------------------

def test_filenames_and_example_records_match_jax(shards):
    for training in (True, False):
        files = imagenet.get_filenames(training, shards)
        assert files == jimagenet.get_filenames(training, shards)
    with pytest.raises(FileNotFoundError, match="no ImageNet"):
        imagenet.get_filenames(True, "/nonexistent")
    raw = _raw_records(imagenet.get_filenames(True, shards)[0])[0]
    buf, label, bbox = imagenet.parse_example_record(raw)
    jbuf, jlabel, jbbox = jimagenet.parse_example_record(raw)
    assert buf == jbuf and label == jlabel and 0 <= label < 1000
    assert np.array_equal(bbox, jbbox) and bbox.shape == (1, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_distorted_bbox_draws_match_jax(seed):
    boxes = [None, np.array([[0.2, 0.1, 0.9, 0.7]], np.float32),
             np.array([[0.45, 0.45, 0.55, 0.55]], np.float32)]
    r, jr = np.random.default_rng(seed), np.random.default_rng(seed)
    for h, w in ((64, 80), (375, 500), (7, 300)):
        for box in boxes:
            for _ in range(5):
                assert (imagenet.sample_distorted_bbox(r, h, w, box)
                        == jimagenet.sample_distorted_bbox(jr, h, w, box))


def test_decode_matches_jax(shards, decode):
    for raw in _raw_records(imagenet.get_filenames(True, shards)[1]):
        buf = imagenet.parse_example_record(raw)[0]
        got = imagenet.decode_jpeg(buf)
        assert got.dtype == np.uint8 and got.shape == (64, 80, 3)
        assert np.array_equal(got, jimagenet.decode_jpeg(buf))


@pytest.mark.parametrize("as_u8", [True, False])
def test_preprocess_train_and_eval_match_jax(shards, decode, as_u8):
    raws = _raw_records(imagenet.get_filenames(True, shards)[0])
    r, jr = np.random.default_rng(5), np.random.default_rng(5)
    for raw in raws:
        buf, _, bbox = imagenet.parse_example_record(raw)
        got = imagenet.preprocess_train(buf, bbox, r, as_u8=as_u8)
        want = jimagenet.preprocess_train(buf, bbox, jr, as_u8=as_u8)
        assert got.dtype == want.dtype == (np.uint8 if as_u8
                                           else np.float32)
        assert got.shape == (224, 224, 3) and np.array_equal(got, want)
        got = imagenet.preprocess_eval(buf, as_u8=as_u8)
        assert np.array_equal(got, jimagenet.preprocess_eval(buf,
                                                             as_u8=as_u8))


@pytest.mark.parametrize("process_id,process_count", [(0, 1), (0, 2),
                                                      (1, 2)])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_eval_batches_and_masks_match_jax(shards, decode, process_id,
                                          process_count, drop_remainder):
    """One decode thread (the eval order is the decode threads' race
    otherwise): the padded, file-sharded eval yields the JAX package's
    batches and masks, and the masks count each record once."""
    def take(mod):
        return list(mod.imagenet_input_fn(
            shards, False, 4, num_threads=1, process_id=process_id,
            process_count=process_count, drop_remainder=drop_remainder,
            wire="uint8"))

    got, want = take(imagenet), take(jimagenet)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == (2 if drop_remainder else 3)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    if not drop_remainder:
        files = imagenet.get_filenames(False, shards)[
            process_id::process_count]
        assert sum(float(b[2].sum()) for b in got) == 5 * len(files)


def test_legacy_train_pipeline(shards):
    """The threaded pipeline: refuses a mid-stream resume (its order is
    decode-timing dependent) and yields batches of the uint8 wire."""
    with pytest.raises(ValueError, match="input_service"):
        imagenet.imagenet_input_fn(shards, True, 4, start_step=3)
    it = imagenet.imagenet_input_fn(shards, True, 4, seed=0,
                                    num_threads=2, wire="uint8")
    images, labels = next(it)
    it.close()
    assert images.shape == (4, 224, 224, 3) and images.dtype == np.uint8
    assert labels.dtype == np.int32 and 0 <= labels.min()


_MAX_RANK = """
import datetime, sys
import torch.distributed as dist
from dtf_tpu_torch.data.pipeline import all_processes_max
rank, url = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=url, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
print("MAX=%d" % all_processes_max([3, 11][rank]))
dist.destroy_process_group()
"""


def test_all_processes_max_over_two_gloo_ranks(tmp_path):
    assert pipeline.all_processes_max(7) == 7   # no group: the identity
    url = f"file://{tmp_path / 'rdv'}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _MAX_RANK, str(r),
                               url], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "MAX=11" in out


# ---------------------------------------------------------------------------
# imagenet_main on written shards
# ---------------------------------------------------------------------------

MAIN_STEPS = 4


def _main_flags(shards, model_dir, trace_dir):
    return ["--data_dir", shards, "--use_trivial_model", "--batch_size", "2",
            "--train_steps", str(MAIN_STEPS), "--log_steps", "1",
            "--input_num_shards", "2", "--input_workers", "0",
            "--distribution_strategy", "off", "--dtype", "fp32",
            "--step_time_guard_factor", "0", "--nan_guard", "false",
            "--checkpoint_steps", "2", "--model_dir", model_dir,
            "--trace_dir", trace_dir, "--seed", "3"]


def _trace_losses(trace_dir):
    out = {}
    for path in glob.glob(os.path.join(trace_dir, "trace_rank*.jsonl")):
        for rec in trace.read_records(path):
            if rec.get("kind") == "event" and rec.get("name") == "train_loss":
                out.setdefault(int(rec["step"]), set()).add(rec["loss"])
    return out


def _manifest_host_state(model_dir, step):
    from dtf_tpu_torch.train.checkpoint import manifest_path
    path = manifest_path(os.path.join(model_dir, "checkpoints"), step)
    with open(path) as f:
        return json.load(f)["host_state"]


@pytest.fixture(scope="module")
def main_pair(shards, tmp_path_factory):
    """The JAX imagenet_main and the port's on the same shards, the
    port's trivial model loaded with the JAX run's initial weights; both
    decode through PIL."""
    from dtf_tpu.cli.runner import run as jax_run
    from dtf_tpu.config import parse_flags as jax_parse_flags
    from dtf_tpu.train import Trainer as JaxTrainer

    base = str(tmp_path_factory.mktemp("imagenet_main"))
    mp = pytest.MonkeyPatch()
    try:
        for mod in (imagenet, jimagenet):
            mp.setattr(mod, "_native_jpeg", None)
            mp.setattr(mod, "_native_probed", True)
        init = {}
        jinit = JaxTrainer.init_state

        def keep_init(self, *a, **kw):
            state = jinit(self, *a, **kw)
            # copied now: the train step donates the state's buffers
            init["params"] = jax.tree_util.tree_map(np.array, state.params)
            return state

        mp.setattr(JaxTrainer, "init_state", keep_init)
        from dtf_tpu.cli.imagenet_main import IMAGENET_DEFAULTS
        jdir = os.path.join(base, "jax")
        jax_stats = jax_run(jax_parse_flags(
            _main_flags(shards, jdir + "_m", jdir + "_t")
            + ["--verbose", "0"], defaults=IMAGENET_DEFAULTS))
        params = init["params"]
        build = runner.build_model_for

        def jax_weights(cfg, spec, device, bn_group=None, **kw):
            model, l2 = build(cfg, spec, device, bn_group, **kw)
            model.load_state_dict(convert.from_flax_vision(params, {},
                                                           model))
            return model, l2

        mp.setattr(runner, "build_model_for", jax_weights)
        pdir = os.path.join(base, "port")
        stats = imagenet_main.main(_main_flags(shards, pdir + "_m",
                                               pdir + "_t")
                                   + ["--device", "cpu"])
        trace.flush()
        yield {"jax": jax_stats, "port": stats,
               "jax_losses": _trace_losses(jdir + "_t"),
               "port_losses": _trace_losses(pdir + "_t"),
               "jax_host": _manifest_host_state(jdir + "_m", 2),
               "port_host": _manifest_host_state(pdir + "_m", 2)}
    finally:
        mp.undo()


def test_imagenet_main_losses_match_jax(main_pair):
    got, want = main_pair["port_losses"], main_pair["jax_losses"]
    assert sorted(got) == sorted(want) == list(range(1, MAIN_STEPS + 1))
    for step in got:
        (g,), (w,) = got[step], want[step]
        assert g == pytest.approx(w, rel=1e-5), step
    stats = main_pair["port"]
    assert stats["input_decode"] in ("native", "pil")
    # the eval counts each of the 15 validation records once
    assert stats["eval_count"] == 15
    # the mean CE of 15 images whose logits are 150,528-wide dot
    # products of raw pixels (loss ~4e3), summed in the decode threads'
    # order: 1e-4
    assert stats["eval_loss"] == pytest.approx(main_pair["jax"]["eval_loss"],
                                               rel=1e-4)


def test_service_host_state_is_the_jax_runners(main_pair):
    """The checkpoint's host state carries the service's shard count and
    per-shard positions, as the JAX runner's does."""
    got, want = main_pair["port_host"], main_pair["jax_host"]
    assert got["data"] == want["data"]
    assert got["data"]["num_shards"] == 2
    assert got["data"]["shard_positions"] == [1, 1]
    for key in ("seed", "global_step", "epoch", "step_in_epoch"):
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# crash-exact resume with another worker count (the data-service smoke)
# ---------------------------------------------------------------------------

RESUME_STEPS = 8


def _resume_cmd(shards, model_dir, trace_dir, extra=()):
    return [sys.executable, "-m", "dtf_tpu_torch.cli.imagenet_main",
            "--data_dir", shards, "--device", "cpu", "--use_trivial_model",
            "--batch_size", "2", "--train_steps", str(RESUME_STEPS),
            "--log_steps", "1", "--skip_eval", "--seed", "5",
            "--distribution_strategy", "off", "--nan_guard", "false",
            "--step_time_guard_factor", "0", "--input_num_shards", "2",
            "--input_workers", "0", "--checkpoint_steps", "2",
            "--model_dir", model_dir, "--trace_dir", trace_dir, *extra]


@pytest.fixture(scope="module")
def resumed(shards, tmp_path_factory):
    base = str(tmp_path_factory.mktemp("imagenet_resume"))
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "PYTHONPATH")}
    os.environ.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    runs = {}
    try:
        for key, extra, restarts in (
                ("base", [], 0),
                ("crash", ["--resume", "--input_workers", "2", "--fault",
                           "crash@step:4"], 1)):
            m, t = os.path.join(base, key + "_m"), os.path.join(base,
                                                              key + "_t")
            logs = os.path.join(base, key + "_logs")
            rc = launch.launch_local(
                _resume_cmd(shards, m, t, extra), 1,
                f"file://{os.path.join(base, key)}.rdv", logs,
                timeout_s=240, teardown_grace=10, max_restarts=restarts,
                restart_backoff_s=0.05)
            runs[key] = {"rc": rc, "model": m, "losses": _trace_losses(t),
                         "logs": logs}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return runs


def test_crash_resumed_with_other_workers_is_bit_identical(resumed):
    """Killed at step 4 (after its sealed checkpoint), restarted, resumed
    with two spawned readers where the uninterrupted run read inline:
    every step's loss equal as a float."""
    base, crash = resumed["base"], resumed["crash"]
    assert base["rc"] == 0 and crash["rc"] == 0
    assert sorted(base["losses"]) == list(range(1, RESUME_STEPS + 1))
    assert crash["losses"] == base["losses"]
    assert all(len(v) == 1 for v in crash["losses"].values())
    with open(os.path.join(crash["logs"], "supervisor_events.jsonl")) as f:
        events = [json.loads(line) for line in f if line.strip()]
    assert [e["classification"] for e in events
            if e["event"] == "restart"] == ["crash"]


def test_resume_refuses_another_shard_count(shards, resumed, tmp_path):
    """--input_num_shards is part of the stream's identity: resuming the
    crashed run's checkpoint with another count raises; another worker
    count does not (the test above)."""
    import shutil
    m = str(tmp_path / "m")
    shutil.copytree(resumed["crash"]["model"], m)
    argv = _resume_cmd(shards, m, str(tmp_path / "t"),
                       ["--resume", "--skip_checkpoint"])[3:]
    argv[argv.index("--input_num_shards") + 1] = "1"
    with pytest.raises(ValueError, match="input_num_shards mismatch"):
        imagenet_main.main(argv)
