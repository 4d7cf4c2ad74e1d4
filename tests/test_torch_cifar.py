"""The port's CIFAR-10 record pipeline, its on-device normalization and
the two vision entry points (cifar_main, imagenet_main) against the JAX
package, on the CPU.

The tests write their own CIFAR-10 binary files (the port's
``write_binary_file``), so nothing is downloaded.  Tolerances: batches
bit-identical; the uint8 wire normalized on the device against the
float32 wire and the JAX normalize 1e-6 (per-image reductions in
another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.data import cifar as jcifar
from dtf_tpu.data import normalize as jnormalize
from dtf_tpu.data import pipeline as jpipeline
from dtf_tpu_torch.cli import cifar_main, imagenet_main, runner
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.data import base as data_base
from dtf_tpu_torch.data import cifar, normalize, pipeline
from dtf_tpu_torch.testing.integration import run_synthetic

torch.set_num_threads(1)

TRAIN_PER_FILE, TEST_N, BATCH = 20, 30, 8


@pytest.fixture()
def cifar_dir(tmp_path):
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    rng = np.random.default_rng(0)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for name in names:
        n = TEST_N if name == "test_batch.bin" else TRAIN_PER_FILE
        cifar.write_binary_file(
            str(d / name), rng.integers(0, 256, (n, 32, 32, 3)),
            rng.integers(0, 10, n))
    return str(tmp_path)


def _same_batches(got, want):
    """Bit-identical batches; the JAX package's float32 wire yields
    float64 under NumPy 2, which the port's casts to float32."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if b.dtype == np.float64:
                b = b.astype(np.float32)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_write_binary_file_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (5, 32, 32, 3))
    labels = rng.integers(0, 10, 5)
    cifar.write_binary_file(str(tmp_path / "a.bin"), images, labels)
    jcifar.write_binary_file(str(tmp_path / "b.bin"), images, labels)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin"
                                                 ).read_bytes()
    got = cifar.load_records([str(tmp_path / "a.bin")], dtype=np.uint8)
    assert np.array_equal(got[0], images) and np.array_equal(got[1], labels)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_train_stream_is_bit_identical_to_jax(cifar_dir, wire):
    """Positions 0..7 of a stream (over the epoch boundary at 12), and
    a stream started at step 5 against positions 5 and 6."""
    def take(mod, n, start_step=0):
        it = mod.cifar_input_fn(cifar_dir, True, BATCH, seed=3,
                                process_id=0, process_count=1, wire=wire,
                                start_step=start_step)
        return [next(it) for _ in range(n)]

    ours = take(cifar, 14)
    _same_batches(ours, take(jcifar, 14))
    assert ours[0][0].dtype == (np.uint8 if wire == "uint8" else np.float32)
    _same_batches(take(cifar, 2, start_step=5), ours[5:7])
    _same_batches(take(cifar, 1, start_step=7), take(jcifar, 1,
                                                     start_step=7))


@pytest.mark.parametrize("process_id", [0, 1])
def test_process_sharded_stream_is_bit_identical_to_jax(cifar_dir,
                                                        process_id):
    def take(mod):
        it = mod.cifar_input_fn(cifar_dir, True, 4, seed=1,
                                process_id=process_id, process_count=2)
        return [next(it) for _ in range(3)]

    _same_batches(take(cifar), take(jcifar))
    files = list(range(5))
    assert (pipeline.shard_for_process(files, process_id, 2)
            == jpipeline.shard_for_process(files, process_id, 2))


@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_eval_stream_is_bit_identical_to_jax(cifar_dir, wire,
                                             drop_remainder):
    """The masked eval counts each of the 30 test examples once; with
    drop_remainder the 2-tuple batches stop before the partial one."""
    def stream(mod):
        return list(mod.cifar_input_fn(cifar_dir, False, BATCH,
                                       process_id=0, process_count=1,
                                       drop_remainder=drop_remainder,
                                       wire=wire))

    ours = stream(cifar)
    _same_batches(ours, stream(jcifar))
    if drop_remainder:
        assert len(ours) == TEST_N // BATCH and len(ours[0]) == 2
    else:
        assert sum(float(b[2].sum()) for b in ours) == TEST_N


def test_uint8_wire_normalized_on_device_matches_float32_wire(cifar_dir):
    """cifar_standardize on the uint8 batch equals the float32 wire's
    host standardization and the JAX cifar_standardize."""
    def first(wire):
        it = cifar.cifar_input_fn(cifar_dir, True, BATCH, seed=2,
                                  wire=wire)
        return next(it)[0]

    u8, f32 = first("uint8"), first("float32")
    got = normalize.cifar_standardize(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), f32, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jnormalize.cifar_standardize(
            jnp.asarray(u8))), rtol=1e-6, atol=1e-6)
    flat = np.full((1, 32, 32, 3), 7, np.uint8)   # the 1/sqrt(N) floor
    np.testing.assert_array_equal(
        normalize.cifar_standardize(torch.from_numpy(flat)).numpy(),
        np.asarray(jnormalize.cifar_standardize(jnp.asarray(flat))))


def test_imagenet_mean_subtract_matches_jax():
    x = np.random.default_rng(4).integers(0, 256, (2, 5, 5, 3)).astype(
        np.uint8)
    np.testing.assert_allclose(
        normalize.imagenet_mean_subtract(torch.from_numpy(x)).numpy(),
        np.asarray(jnormalize.imagenet_mean_subtract(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    from dtf_tpu.data.imagenet import CHANNEL_MEANS
    assert np.array_equal(normalize.CHANNEL_MEANS, CHANNEL_MEANS)


@pytest.mark.parametrize("dataset", ["cifar10", "imagenet", "lm"])
def test_normalize_for_config_is_the_jax_predicate(dataset):
    spec = data_base.get_dataset_spec(dataset)
    for wire in ("uint8", "float32"):
        for synth in (False, True):
            for data_dir in ("", "/data"):
                kw = dict(input_wire=wire, use_synthetic_data=synth,
                          data_dir=data_dir, dataset=dataset)
                got = normalize.for_config(Config(**kw), spec)
                want = jnormalize.for_config(JaxConfig(**kw), spec)
                assert (got is None) == (want is None)
                if got is not None:
                    assert got.__name__ == want.__name__
    with pytest.raises(ValueError, match="no on-device"):
        normalize.for_dataset("lm")


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.fixture()
def small_eval(monkeypatch):
    """The CIFAR and ImageNet specs with 8 eval examples, so a smoke
    run's eval pass is two batches."""
    for name in ("cifar10", "imagenet"):
        monkeypatch.setitem(data_base._SPECS, name, dataclasses.replace(
            data_base._SPECS[name], num_eval=8))


def _finite_stats(stats):
    assert np.isfinite(stats["loss"]) and stats["avg_exp_per_second"] > 0
    assert all(np.isfinite(v) for _, v in stats["train_loss_log"])


def test_cifar_main_smoke_through_run_synthetic(small_eval):
    stats = run_synthetic(runner.run, ["--model", "resnet20",
                                       "--train_steps", "1",
                                       "--batch_size", "4",
                                       "--log_steps", "1",
                                       "--device", "cpu"],
                          defaults=cifar_main.CIFAR_DEFAULTS)
    _finite_stats(stats)
    assert np.isfinite(stats["eval_loss"]) and stats["eval_count"] == 8


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_imagenet_main_trivial_model_runs(small_eval, dtype):
    stats = imagenet_main.main(["--use_synthetic_data", "--device", "cpu",
                                "--use_trivial_model", "--batch_size", "4",
                                "--train_steps", "2", "--log_steps", "1",
                                "--dtype", dtype, "--skip_checkpoint"])
    _finite_stats(stats)
    assert np.isfinite(stats["eval_loss"])


def test_cifar_main_on_written_files_covers_the_test_set(cifar_dir):
    """--data_dir on the uint8 wire: two steps, then an eval that counts
    each of the 30 test examples once (the last batch is masked)."""
    stats = cifar_main.main(["--data_dir", cifar_dir, "--device", "cpu",
                             "--model", "resnet20", "--batch_size",
                             str(BATCH), "--train_steps", "2",
                             "--log_steps", "1", "--skip_checkpoint"])
    _finite_stats(stats)
    assert stats["eval_count"] == TEST_N
    assert np.isfinite(stats["eval_loss"])
    assert 0.0 <= stats["accuracy_top_1"] <= 1.0


def test_runner_normalizes_the_uint8_wire_on_the_device(cifar_dir):
    cfg = parse_flags(["--data_dir", cifar_dir, "--device", "cpu",
                       "--model", "resnet20", "--batch_size", "4",
                       "--train_steps", "1"],
                      defaults=cifar_main.CIFAR_DEFAULTS)
    trainer, _, train_fn, _ = runner.build_training(cfg)
    assert trainer.normalize_fn is normalize.cifar_standardize
    assert next(train_fn())[0].dtype == np.uint8
    assert trainer.model.conv1.weight.is_contiguous(
        memory_format=torch.channels_last)
    cfg = cfg.replace(input_wire="float32")
    trainer, _, train_fn, _ = runner.build_training(cfg)
    assert trainer.normalize_fn is None
    assert next(train_fn())[0].dtype == np.float32


@pytest.mark.parametrize("main", [cifar_main, imagenet_main])
def test_vision_mains_raise_without_cuda(main):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the refusal needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main.main(["--use_synthetic_data", "--train_steps", "1"])


@pytest.mark.parametrize("argv,error,match", [
    (["--data_dir", "/nonexistent"], FileNotFoundError,
     "no ImageNet TFRecord shards"),
    (["--use_synthetic_data", "--remat"], NotImplementedError, "remat"),
    (["--use_synthetic_data", "--model_parallelism", "2"], ValueError,
     "not ported"),
])
def test_imagenet_main_refuses_what_is_not_ported(argv, error, match):
    if "--model_parallelism" in argv:
        # ported since (tensor parallelism): one process cannot hold a
        # model axis of 2, the JAX mesh's refusal
        match = "1 devices not divisible by model_parallelism"
    if "--remat" in argv:
        # ported since: --remat on resnet50 is the selective policy; a
        # named policy there is what both packages refuse
        argv, error = argv + ["--remat_policy", "dots"], ValueError
    with pytest.raises(error, match=match):
        imagenet_main.main(argv + ["--device", "cpu", "--batch_size", "2"])


def test_remat_on_a_cifar_resnet_raises():
    with pytest.raises(ValueError, match="remat"):
        cifar_main.main(["--use_synthetic_data", "--device", "cpu",
                         "--model", "resnet20", "--remat"])


def test_vision_flag_defaults_are_the_jax_defaults():
    cfg = parse_flags(["--data_format", "channels_first", "--input_wire",
                       "float32", "--use_trivial_model"],
                      defaults=imagenet_main.IMAGENET_DEFAULTS)
    assert (cfg.data_format, cfg.input_wire, cfg.use_trivial_model) == (
        "channels_first", "float32", True)
    jcfg = JaxConfig()
    for name in ("data_format", "input_wire", "drop_remainder",
                 "use_trivial_model"):
        assert getattr(Config(), name) == getattr(jcfg, name), name
    with pytest.raises(ValueError, match="input_wire"):
        Config(input_wire="fp16")
    with pytest.raises(ValueError, match="data_format"):
        Config(data_format="nchw")
    from dtf_tpu.cli import cifar_main as jcifar_main
    from dtf_tpu.cli import imagenet_main as jimagenet_main
    assert cifar_main.CIFAR_DEFAULTS == jcifar_main.CIFAR_DEFAULTS
    assert imagenet_main.IMAGENET_DEFAULTS == jimagenet_main.IMAGENET_DEFAULTS
