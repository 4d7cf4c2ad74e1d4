"""The reference's flags on the port, against the JAX package, on the
CPU: every field of the JAX ``Config`` parses on the port (ported, a
declared no-op, or ``NOT_PORTED`` naming its subsystem); ``--dtype
fp16`` trains the vision families under the JAX loss-scale rule and the
transformers refuse it naming their kernels; ``--use_tensor_lr``,
``--stop_threshold``, ``--enable_tensorboard`` and ``--profile_steps``
do what they do in the JAX package.

Tolerances: resnet20 in fp16, three steps of the same batch from the
same weights, per-step losses within 5e-4 relative of the JAX Trainer's
(about one fp16 step, 2^-11: fp16 activations in two convolution
libraries; 4.8e-5 measured); learning rates 1e-6 relative; the
tensorboard scalars bit-identical as floats.
"""

import dataclasses
import glob
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.config.flags import define_flags
from dtf_tpu.data import base as jdata_base
from dtf_tpu.data import records as jrecords
from dtf_tpu.models import resnet_cifar as jcifar
from dtf_tpu.runtime import initialize as jax_initialize
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import cifar_main, imagenet_main, lm_main, runner
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.config.flags import NO_OPS, NOT_PORTED
from dtf_tpu_torch.data import base as data_base
from dtf_tpu_torch.models import registry, resnet_cifar
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.train.loop import StepProfiler, Trainer
from dtf_tpu_torch.utils import tensorboard

torch.set_num_threads(1)

JAX_FIELDS = dataclasses.fields(JaxConfig)
PORT_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def _a_value(field):
    """A command-line value of ``field``'s type."""
    t = str(field.type)
    if t == "bool":
        return "true"
    if "int" in t:
        return "1"
    if "float" in t:
        return "1.5"
    return "x"


# ---------------------------------------------------------------------------
# every JAX flag: ported, a declared no-op, or not ported with its subsystem
# ---------------------------------------------------------------------------

def test_every_jax_config_field_is_accounted_for():
    seen = {"ported": 0, "no-op": 0, "not ported": 0}
    for f in JAX_FIELDS:
        if f.name in NOT_PORTED:
            assert f.name not in PORT_FIELDS, f.name
            assert NOT_PORTED[f.name], f.name
            with pytest.raises(ValueError,
                               match=f"{f.name}: .*not ported"):
                parse_flags([f"--{f.name}", _a_value(f)])
            seen["not ported"] += 1
            continue
        assert f.name in PORT_FIELDS, f"--{f.name} is unknown to the port"
        seen["no-op" if f.name in NO_OPS else "ported"] += 1
    assert len(JAX_FIELDS) == 132 and sum(seen.values()) == 132
    assert seen["no-op"] == len(NO_OPS) == 9
    # the planner was the last subsystem left: every field is ported
    assert seen["not ported"] == 0 and NOT_PORTED == {}
    assert set(NO_OPS) <= {f.name for f in JAX_FIELDS}


@pytest.mark.parametrize("subsystem,flags", [
    ("parameter server", ["ps_wire", "ps_snapshot_dir", "ps_snapshot_secs",
                          "ps_reconnect_secs", "ps_reseed_tolerance"]),
    ("model parallelism", ["shard_lm_head", "num_experts", "moe_top_k",
                           "num_microbatches", "pipeline_interleave"]),
    ("ZeRO", ["zero_wire", "zero_probe", "zero_stage"]),
    ("serving tensor parallelism", ["serve_tp"]),
    ("prefix sharing", ["serve_prefix_sharing"]),
    ("serving fleet", ["router_replicas", "rendezvous_dir", "replica_id",
                       "serve_host", "rollout_checkpoint", "router_ha"]),
    ("planner", ["plan", "plan_mesh", "plan_cache"]),
    ("obs/prom.py", ["metrics_port"]),
])
def test_unported_flags_name_their_subsystem(subsystem, flags):
    if subsystem == "parameter server":
        # ported since (parallel/ps.py): the five parse, with the JAX
        # package's defaults and validation
        _check_ps_flags(flags)
        return
    if subsystem in ("prefix sharing", "obs/prom.py"):
        # ported since (serve/engine.py, obs/prom.py): they parse, with
        # the JAX package's defaults and validation
        _check_ported_flags(flags)
        return
    if subsystem == "ZeRO":
        # ported since (train/zero.py, the Trainer's stages): they parse,
        # with the JAX package's defaults and validation
        _check_zero_flags(flags + ["optimizer_sharding"])
        return
    if subsystem in ("model parallelism", "serving tensor parallelism"):
        # ported since (tensor parallelism): --shard_lm_head,
        # --model_parallelism and --serve_tp parse, with the JAX
        # package's defaults and validation; then pipeline parallelism's
        # --num_microbatches and --pipeline_interleave likewise, then
        # expert parallelism's --num_experts and --moe_top_k
        tp = [f for f in flags if f in TP_FLAGS]
        _check_tp_flags(tp + (["model_parallelism"]
                              if subsystem == "model parallelism" else []))
        _check_pp_flags([f for f in flags if f in PP_FLAGS])
        _check_moe_flags([f for f in flags if f in MOE_FLAGS])
        assert set(flags) <= set(TP_FLAGS + PP_FLAGS + MOE_FLAGS)
        return
    if subsystem == "planner":
        # ported since (plan/, cli/plan_main.py): they parse, with the
        # JAX package's defaults and validation; --plan_mesh names the
        # port's presets
        _check_plan_flags(flags)
        return
    if subsystem == "serving fleet":
        # ported since: the router and replica flags (cli/router_main and
        # cli/replica_main), then the HA pair's (serve/ha.py) and the
        # rollout's (serve/rollout.py)
        _check_fleet_flags([f for f in flags if f not in HA_ROLLOUT_FLAGS])
        _check_ha_rollout_flags([f for f in flags if f in HA_ROLLOUT_FLAGS])
        return
    for name in flags:
        assert subsystem in NOT_PORTED[name], name
        with pytest.raises(ValueError, match=f"{subsystem}.*not ported"):
            parse_flags([f"--{name}", "1"])


FLEET_ARGV = ["--router_replicas", "3", "--router_deadline_s", "9.5",
              "--router_admission", "7", "--router_probe_s", "0.2",
              "--router_health_timeout_s", "4", "--router_replica_inflight",
              "5", "--router_max_respawns", "2", "--router_respawn_window_s",
              "60", "--router_respawn_backoff_s", "0.1", "--router_hedge_s",
              "1.5", "--router_placement", "affinity",
              "--router_prefill_replicas", "1", "--rendezvous_dir", "/tmp/r",
              "--replica_id", "2", "--serve_host", "0.0.0.0"]


def _check_fleet_flags(flags):
    from dtf_tpu.config import parse_flags as jax_parse_flags
    jax_defaults, port_defaults = JaxConfig(), Config()
    got, want = parse_flags(FLEET_ARGV), jax_parse_flags(FLEET_ARGV)
    for name in [a[2:] for a in FLEET_ARGV[::2]]:
        assert name not in NOT_PORTED, name
        assert getattr(port_defaults, name) == getattr(jax_defaults, name)
        assert getattr(got, name) == getattr(want, name), name
    assert set(flags) <= {a[2:] for a in FLEET_ARGV[::2]}
    for bad in (["--router_replicas", "0"],
                ["--router_probe_s", "20"],
                ["--router_placement", "sticky"],
                ["--router_prefill_replicas", "2"],
                ["--router_prefill_replicas", "1", "--router_placement",
                 "random"],
                ["--router_hedge_s", "-1"], ["--serve_host", ""]):
        with pytest.raises(ValueError):
            parse_flags(bad)
        with pytest.raises(ValueError):
            jax_parse_flags(bad)


HA_ROLLOUT_FLAGS = ("router_ha", "router_standby", "router_lease_ttl_s",
                    "router_journal_fsync_s", "rollout_checkpoint",
                    "rollout_canary_requests", "rollout_mirror_fraction",
                    "rollout_max_divergence", "rollout_warm_timeout_s",
                    "rollout_state")
HA_ROLLOUT_ARGV = ["--router_standby", "--router_ha", "--rendezvous_dir",
                   "/tmp/r", "--router_lease_ttl_s", "1.5",
                   "--router_journal_fsync_s", "0", "--rollout_checkpoint",
                   "/tmp/ckpt", "--rollout_canary_requests", "3",
                   "--rollout_mirror_fraction", "0.5",
                   "--rollout_max_divergence", "0.25",
                   "--rollout_warm_timeout_s", "30", "--rollout_state",
                   "/tmp/r/state.json"]


def _check_ha_rollout_flags(flags):
    """The ten HA and rollout flags parse with the JAX package's
    defaults, values and validation."""
    from dtf_tpu.config import parse_flags as jax_parse_flags
    jax_defaults, port_defaults = JaxConfig(), Config()
    got, want = parse_flags(HA_ROLLOUT_ARGV), jax_parse_flags(HA_ROLLOUT_ARGV)
    assert set(flags) <= set(HA_ROLLOUT_FLAGS)
    for name in HA_ROLLOUT_FLAGS:
        assert name not in NOT_PORTED, name
        assert getattr(port_defaults, name) == getattr(jax_defaults, name)
        assert getattr(got, name) == getattr(want, name), name
    assert (got.router_standby, got.router_lease_ttl_s,
            got.rollout_mirror_fraction) == (True, 1.5, 0.5)
    for bad in (["--router_lease_ttl_s", "0"],
                ["--router_journal_fsync_s", "-1"],
                ["--router_standby"],
                ["--rollout_canary_requests", "0"],
                ["--rollout_mirror_fraction", "0"],
                ["--rollout_max_divergence", "1.5"],
                ["--rollout_warm_timeout_s", "0"],
                ["--rollout_checkpoint", "/c", "--serve_temperature", "0.5"],
                ["--rollout_checkpoint", "/c", "--router_replicas", "1"]):
        with pytest.raises(ValueError):
            parse_flags(bad)
        with pytest.raises(ValueError):
            jax_parse_flags(bad)


def _check_ported_flags(flags):
    from dtf_tpu.config import parse_flags as jax_parse_flags
    jax_defaults, port_defaults = JaxConfig(), Config()
    for name in flags:
        assert name not in NOT_PORTED, name
        assert getattr(port_defaults, name) == getattr(jax_defaults, name)
    argv = {"serve_prefix_sharing": ["--serve_prefix_sharing", "false"],
            "metrics_port": ["--metrics_port", "9099"]}
    for name in flags:
        got, want = parse_flags(argv[name]), jax_parse_flags(argv[name])
        assert getattr(got, name) == getattr(want, name), name
    if "metrics_port" in flags:
        for bad in (["--metrics_port", "70000"], ["--metrics_port", "-1"]):
            with pytest.raises(ValueError, match="metrics_port"):
                parse_flags(bad)
            with pytest.raises(ValueError, match="metrics_port"):
                jax_parse_flags(bad)


def _check_plan_flags(flags):
    from dtf_tpu.config import parse_flags as jax_parse_flags
    jax_defaults, port_defaults = JaxConfig(), Config()
    for name in flags:
        assert name not in NOT_PORTED, name
        assert getattr(port_defaults, name) == getattr(jax_defaults, name)
    argv = ["--plan", "auto", "--plan_mesh", "cpu", "--plan_cache", "/x.json"]
    got, want = parse_flags(argv), jax_parse_flags(argv)
    for name in flags:
        assert getattr(got, name) == getattr(want, name), name
    with pytest.raises(ValueError, match="no such plan file"):
        parse_flags(["--plan", "/no/such/plan.json"])
    with pytest.raises(ValueError, match="no such plan file"):
        jax_parse_flags(["--plan", "/no/such/plan.json"])
    # the TPU presets are not carried: refused, naming the port's
    with pytest.raises(ValueError, match="unknown mesh preset 'v4-8'.*"
                                         "h100x8"):
        parse_flags(["--plan_mesh", "v4-8"])
    assert parse_flags(["--plan_mesh", "4xh100x8"]).plan_mesh == "4xh100x8"


TP_FLAGS = ("model_parallelism", "shard_lm_head", "serve_tp")


def _check_tp_flags(flags):
    from dtf_tpu.config import parse_flags as jax_parse_flags
    jax_defaults, port_defaults = JaxConfig(), Config()
    for name in flags:
        assert name not in NOT_PORTED, name
        assert getattr(port_defaults, name) == getattr(jax_defaults, name)
    argv = {"model_parallelism": ["--model_parallelism", "2"],
            "shard_lm_head": ["--shard_lm_head"],
            "serve_tp": ["--serve_tp", "2"]}
    for name in flags:
        got, want = parse_flags(argv[name]), jax_parse_flags(argv[name])
        assert getattr(got, name) == getattr(want, name), name
    if "serve_tp" in flags:
        for bad, match in ((["--serve_tp", "0"], "serve_tp must be >= 1"),
                           (["--serve_tp", "2", "--kv_page_size", "0"],
                            "paged")):
            with pytest.raises(ValueError, match=match):
                parse_flags(bad)
            with pytest.raises(ValueError, match=match):
                jax_parse_flags(bad)


PP_FLAGS = ("num_microbatches", "pipeline_interleave")


def _check_pp_flags(flags):
    from dtf_tpu.config import parse_flags as jax_parse_flags
    jax_defaults, port_defaults = JaxConfig(), Config()
    for name in flags:
        assert name not in NOT_PORTED, name
        assert getattr(port_defaults, name) == getattr(jax_defaults, name)
    for argv in (["--num_microbatches", "8"], ["--pipeline_interleave", "2"],
                 ["--num_microbatches", "4", "--pipeline_interleave", "1"]):
        got, want = parse_flags(argv), jax_parse_flags(argv)
        for name in flags:
            assert getattr(got, name) == getattr(want, name), (argv, name)
    if "pipeline_interleave" in flags:
        for bad in (["--pipeline_interleave", "3"],
                    ["--pipeline_interleave", "0"]):
            with pytest.raises(ValueError, match="pipeline_interleave must "
                               "be 1 or 2"):
                parse_flags(bad)
            with pytest.raises(ValueError, match="pipeline_interleave must "
                               "be 1 or 2"):
                jax_parse_flags(bad)


MOE_FLAGS = ("num_experts", "moe_capacity_factor", "moe_aux_weight",
             "moe_top_k")


def _check_moe_flags(flags):
    from dtf_tpu.config import parse_flags as jax_parse_flags
    jax_defaults, port_defaults = JaxConfig(), Config()
    for name in flags:
        assert name not in NOT_PORTED, name
        assert getattr(port_defaults, name) == getattr(jax_defaults, name)
    for argv in (["--num_experts", "16", "--moe_top_k", "1"],
                 ["--moe_capacity_factor", "1.5", "--moe_aux_weight",
                  "0.05", "--moe_top_k", "2"]):
        got, want = parse_flags(argv), jax_parse_flags(argv)
        for name in flags:
            assert getattr(got, name) == getattr(want, name), (argv, name)
    if "moe_top_k" in flags:
        for parse in (parse_flags, jax_parse_flags):
            with pytest.raises(ValueError, match="moe_top_k must be >= 1"):
                parse(["--moe_top_k", "0"])


def _check_zero_flags(flags):
    from dtf_tpu.config import parse_flags as jax_parse_flags
    jax_defaults, port_defaults = JaxConfig(), Config()
    for name in flags:
        assert name not in NOT_PORTED, name
        assert getattr(port_defaults, name) == getattr(jax_defaults, name)
    for argv in (["--zero_stage", "3", "--zero_wire", "bf16",
                  "--zero_probe"], ["--optimizer_sharding"],
                 ["--zero_stage", "2"]):
        got, want = parse_flags(argv), jax_parse_flags(argv)
        for name in flags + ["zero_stage_effective"]:
            assert getattr(got, name) == getattr(want, name), (argv, name)
    for bad, match in ((["--zero_stage", "4"], "zero_stage"),
                       (["--optimizer_sharding", "--zero_stage", "2"],
                        "optimizer_sharding"),
                       (["--zero_probe"], "zero_probe"),
                       (["--zero_wire", "fp8"], "zero_wire"),
                       (["--zero_wire", "bf16", "--optimizer_sharding"],
                        "zero_wire")):
        with pytest.raises(ValueError, match=match):
            parse_flags(bad)
        with pytest.raises(ValueError, match=match):
            jax_parse_flags(bad)


def _check_ps_flags(flags):
    from dtf_tpu.config import parse_flags as jax_parse_flags
    jax_defaults, port_defaults = JaxConfig(), Config()
    argv = ["--ps_wire", "bf16", "--ps_snapshot_dir", "/tmp/snaps",
            "--ps_snapshot_secs", "2.5", "--ps_reconnect_secs", "40",
            "--ps_reseed_tolerance", "77"]
    got, want = parse_flags(argv), jax_parse_flags(argv)
    for name in flags:
        assert name not in NOT_PORTED, name
        assert getattr(port_defaults, name) == getattr(jax_defaults, name)
        assert getattr(got, name) == getattr(want, name), name
    assert (got.ps_wire, got.ps_snapshot_dir, got.ps_snapshot_secs,
            got.ps_reconnect_secs, got.ps_reseed_tolerance) == (
        "bf16", "/tmp/snaps", 2.5, 40.0, 77)
    for bad in (["--ps_wire", "fp16"], ["--ps_mode", "lazy"]):
        with pytest.raises(ValueError, match=bad[0][2:]):
            parse_flags(bad)
        with pytest.raises(ValueError, match=bad[0][2:]):
            jax_parse_flags(bad)


def test_ported_and_no_op_flags_parse_with_the_jax_defaults():
    jax_defaults = define_flags()
    for name in NO_OPS + ("use_tensor_lr", "stop_threshold",
                          "enable_tensorboard", "profile_steps",
                          "input_service", "input_num_shards",
                          "input_workers", "input_cache_dir",
                          "input_cache_limit_mb", "input_fast_dct",
                          "input_scaled_decode",
                          "datasets_num_private_threads",
                          "enable_get_next_as_optional"):
        assert PORT_FIELDS[name].default == jax_defaults[name], name
    argv = ["--model", "resnet20", "--enable_xla", "false",
            "--all_reduce_alg", "nccl", "--num_packs", "2",
            "--per_gpu_thread_count", "2", "--tf_gpu_thread_mode",
            "gpu_private", "--batchnorm_spatial_persistent",
            "--image_bytes_as_serving_input", "--enable_eager",
            "--verbose", "0", "--datasets_num_private_threads", "4"]
    cfg = parse_flags(argv)
    assert (cfg.num_packs, cfg.verbose, cfg.all_reduce_alg) == (
        2, 0, "nccl")
    assert cfg.datasets_num_private_threads == 4


def test_config_checks_match_jax():
    for kw, match in [
            (dict(input_num_shards=0), "input_num_shards"),
            (dict(input_workers=-2), "input_workers"),
            (dict(input_cache_limit_mb=64), "input_cache_limit_mb"),
            (dict(input_cache_limit_mb=-1), "input_cache_limit_mb"),
            (dict(stop_threshold=0.5, report_accuracy_metrics=False),
             "stop_threshold"),
            (dict(loss_scale="huge"), "loss_scale"),
            (dict(loss_scale=-2), "loss_scale")]:
        with pytest.raises(ValueError, match=match):
            Config(**kw)
        with pytest.raises(ValueError, match=match):
            JaxConfig(**kw)
    kw = dict(input_num_shards=4, input_workers=-1, input_cache_dir="/x",
              input_cache_limit_mb=64, stop_threshold=0.7)
    Config(**kw)
    JaxConfig(**kw)
    # get_next_as_optional forces the padded eval, as in the JAX Config
    for cls in (Config, JaxConfig):
        cfg = cls(enable_get_next_as_optional=True, drop_remainder=True)
        assert cfg.drop_remainder is False


# ---------------------------------------------------------------------------
# fp16: the loss-scale rule, the transformers' refusal, resnet20 training
# ---------------------------------------------------------------------------

def test_fp16_loss_scale_rule_is_the_jax_rule():
    for kw in (dict(dtype="fp16"), dict(dtype="float16", loss_scale=256),
               dict(dtype="fp16", loss_scale="dynamic"), dict(dtype="bf16"),
               dict(dtype="fp32"), dict(dtype="fp16", loss_scale="64")):
        got = Config(model="resnet20", **kw).loss_scale_value
        assert got == JaxConfig(model="resnet20", **kw).loss_scale_value
    assert Config(model="resnet50", dtype="fp16").loss_scale_value == 128.0
    assert Config(model="resnet50", dtype="fp16").compute_dtype is \
        torch.float16


@pytest.mark.parametrize("model", ["transformer_small", "transformer_tpu"])
def test_transformers_refuse_fp16_naming_the_kernels(model):
    with pytest.raises(ValueError, match="dtype.*K1-K4"):
        Config(model=model, dtype="fp16")
    with pytest.raises(ValueError, match="K1-K4"):
        lm_main.main(["--use_synthetic_data", "--device", "cpu",
                      "--model", model, "--dtype", "float16"])
    # the input probe replaces the model: no attention kernel runs
    Config(model=model, dtype="fp16", use_trivial_model=True)


def _fp16_pair(loss_scale):
    batch = 4
    common = dict(batch_size=batch, train_steps=3, dataset="cifar10",
                  use_synthetic_data=True, skip_eval=True, optimizer="sgd",
                  dtype="fp16", loss_scale=loss_scale)
    jcfg = JaxConfig(model="resnet20", skip_checkpoint=True, model_dir="",
                     distribution_strategy="off", num_devices=1, **common)
    rt = jax_initialize(jcfg)
    jmodel = jcifar.resnet20(dtype=jcfg.compute_dtype)
    jtrainer = JaxTrainer(jcfg, rt, jmodel, registry.L2_CIFAR,
                          jdata_base.CIFAR10)
    rng = np.random.default_rng(11)
    images = (rng.normal(size=(batch, 16, 16, 3)) * 60 + 127).astype(
        np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    jstate = jtrainer.init_state(jax.random.key(0), (images, labels))
    cfg = Config(device="cpu", model="resnet20", **common)
    model = resnet_cifar.resnet20(dtype=cfg.compute_dtype)
    model.load_state_dict(convert.from_flax_vision(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats), model))
    trainer = Trainer(cfg, model.to(memory_format=torch.channels_last),
                      registry.L2_CIFAR, data_base.CIFAR10)
    return jtrainer, rt, jstate, trainer, images, labels


@pytest.mark.parametrize("loss_scale", [None, "dynamic"])
def test_resnet20_fp16_trains_like_jax(loss_scale):
    """Three Keras-SGD steps in fp16 under a static 128 (the default)
    and a dynamic scale: finite losses within 5e-4 of the JAX Trainer's,
    and the scale the JAX Trainer keeps."""
    jtrainer, rt, jstate, trainer, images, labels = _fp16_pair(loss_scale)
    state = trainer.init_state()
    assert trainer.loss_scale == (1.0 if loss_scale else 128.0)
    jl, tl = [], []
    for _ in range(3):
        jstate, m = jtrainer.train_step(jstate,
                                        *rt.shard_batch((images, labels)))
        jl.append(float(m["loss"]))
        state, tm = trainer.train_step(state, torch.from_numpy(images),
                                       torch.from_numpy(labels))
        tl.append(float(tm["loss"]))
        if loss_scale:
            assert tm["loss_scale"] == float(m["loss_scale"])
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=5e-4)


@pytest.mark.parametrize("extra", [[], ["--loss_scale", "dynamic"]])
def test_cifar_main_trains_resnet20_in_fp16(extra):
    stats = cifar_main.main(["--use_synthetic_data", "--device", "cpu",
                             "--model", "resnet20", "--dtype", "fp16",
                             "--batch_size", "4", "--train_steps", "2",
                             "--log_steps", "1", "--skip_checkpoint",
                             "--skip_eval", *extra])
    assert len(stats["train_loss_log"]) == 2
    assert all(np.isfinite(v) for _, v in stats["train_loss_log"])


# ---------------------------------------------------------------------------
# --use_tensor_lr, --stop_threshold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_tensor_lr", [False, True])
def test_use_tensor_lr_gives_the_jax_learning_rates(use_tensor_lr):
    kw = dict(model="trivial", dataset="imagenet", batch_size=1024,
              train_epochs=90, use_tensor_lr=use_tensor_lr,
              use_synthetic_data=True, optimizer="momentum")
    jcfg = JaxConfig(distribution_strategy="off", num_devices=1,
                     skip_checkpoint=True, **kw)
    rt = jax_initialize(jcfg)
    from dtf_tpu.models.trivial import TrivialModel as JaxTrivial
    jtrainer = JaxTrainer(jcfg, rt, JaxTrivial(), 0.0, jdata_base.IMAGENET)
    model, _ = registry.build_model("trivial", in_features=12)
    trainer = Trainer(Config(device="cpu", **kw), model, 0.0,
                      data_base.IMAGENET)
    spe = trainer.steps_per_epoch
    steps = [0, 1, spe - 1, 3 * spe, 5 * spe - 1, 5 * spe, 30 * spe - 3,
             30 * spe + 2, 61 * spe, 80 * spe + 7]
    got = [float(trainer.schedule(s)) for s in steps]
    want = [float(jtrainer.schedule(jax.numpy.asarray(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    other = Trainer(Config(device="cpu", **dict(
        kw, use_tensor_lr=not use_tensor_lr)), model, 0.0,
        data_base.IMAGENET)
    assert [float(other.schedule(s)) for s in steps] != got


def _epochs_run(trace_dir):
    return sorted({rec["epoch"] for path in glob.glob(
        os.path.join(trace_dir, "trace_rank*.jsonl"))
        for rec in trace.read_records(path)
        if rec.get("name") == "epoch_end"})


@pytest.mark.parametrize("threshold", [0.0, 1.01])
def test_stop_threshold_stops_at_the_jax_epoch(threshold, tmp_path,
                                               monkeypatch):
    """Three epochs of the input probe on tiny synthetic CIFAR; a
    threshold every eval reaches stops both packages after the first
    epoch, one no eval reaches runs all three."""
    from dtf_tpu.cli.runner import run as jax_run
    tiny = dict(num_train=16, num_eval=8)
    monkeypatch.setitem(data_base._SPECS, "cifar10", dataclasses.replace(
        data_base._SPECS["cifar10"], **tiny))
    monkeypatch.setitem(jdata_base._SPECS, "cifar10", dataclasses.replace(
        jdata_base._SPECS["cifar10"], **tiny))
    common = dict(model="resnet20", use_trivial_model=True,
                  dataset="cifar10", batch_size=8, train_epochs=3,
                  use_synthetic_data=True, log_steps=1, skip_checkpoint=True,
                  distribution_strategy="off", stop_threshold=threshold,
                  step_time_guard_factor=0.0, nan_guard=False)
    jax_run(JaxConfig(trace_dir=str(tmp_path / "jax"), model_dir="",
                      verbose=0, **common))
    runner.run(Config(device="cpu", trace_dir=str(tmp_path / "port"),
                      **common))
    trace.flush()
    got, want = _epochs_run(str(tmp_path / "port")), _epochs_run(
        str(tmp_path / "jax"))
    assert got == want == ([0] if threshold == 0.0 else [0, 1, 2])


# ---------------------------------------------------------------------------
# --enable_tensorboard, --profile_steps
# ---------------------------------------------------------------------------

def _scalars(path):
    """[(step, tag, value)] of an event file, read with the JAX
    package's TFRecord reader and a plain Event parse."""
    out = []
    for rec in jrecords.read_tfrecord_file(path, verify_crc=True):
        fields = {f: v for f, _, v in jrecords._iter_fields(rec)}
        if 5 not in fields:
            continue
        value = dict((f, v) for f, _, v in jrecords._iter_fields(
            dict((f, v) for f, _, v in jrecords._iter_fields(fields[5]))[1]))
        out.append((fields.get(2, 0), value[1].decode(),
                    struct.unpack("<f", value[2])[0]))
    return out


def test_tensorboard_writer_writes_the_jax_bytes(tmp_path, monkeypatch):
    from dtf_tpu.utils import tensorboard as jtensorboard
    monkeypatch.setattr("time.time", lambda: 1234.5)
    for mod, d in ((tensorboard, "a"), (jtensorboard, "b")):
        w = mod.SummaryWriter(str(tmp_path / d))
        w.scalar("epoch_loss", 2.25, 7)
        w.scalar("epoch_sparse_categorical_accuracy", 0.125, 8)
        w.close()
    (a,), (b,) = (glob.glob(str(tmp_path / d / "events.*"))
                  for d in ("a", "b"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert _scalars(a) == [(7, "epoch_loss", 2.25),
                           (8, "epoch_sparse_categorical_accuracy", 0.125)]


def test_enable_tensorboard_writes_epoch_scalars(tmp_path, monkeypatch):
    monkeypatch.setitem(data_base._SPECS, "cifar10", dataclasses.replace(
        data_base._SPECS["cifar10"], num_train=16, num_eval=8))
    stats = cifar_main.main(["--use_synthetic_data", "--device", "cpu",
                             "--use_trivial_model", "--batch_size", "8",
                             "--train_epochs", "2", "--log_steps", "1",
                             "--skip_eval", "--skip_checkpoint",
                             "--nan_guard", "false", "--enable_tensorboard",
                             "--model_dir", str(tmp_path)])
    (path,) = glob.glob(str(tmp_path / "train" / "events.out.tfevents.*"))
    got = _scalars(path)
    assert [(s, t) for s, t, _ in got] == [
        (2, "epoch_loss"), (2, "epoch_categorical_accuracy"),
        (4, "epoch_loss"), (4, "epoch_categorical_accuracy")]
    assert got[-2][2] == np.float32(stats["loss"])


def test_step_profiler_keeps_the_jax_range_contract(tmp_path):
    """Starts at the first step at or past `start` (a resumed run inside
    the range still traces the rest), stops once `stop` has run, writes
    one trace."""
    cfg = Config(profile_steps="2,3", model_dir=str(tmp_path))
    prof = StepProfiler(cfg, torch.device("cpu"))
    for step in range(3, 6):      # resumed at step 3
        prof.before_step(step)
        torch.ones(4).sum()
        prof.after_step(step + 1)
    assert prof.path.endswith("profile_rank0_steps3-3.json")
    assert os.path.exists(prof.path) and prof._prof is None
    with pytest.raises(ValueError, match="start,stop"):
        StepProfiler(Config(profile_steps="2"), torch.device("cpu"))
    with pytest.raises(ValueError, match="model_dir"):
        StepProfiler(Config(profile_steps="1,2", model_dir=""),
                     torch.device("cpu"))


def test_profile_steps_writes_a_trace_of_the_steps(tmp_path):
    stats = imagenet_main.main(["--use_synthetic_data", "--device", "cpu",
                                "--use_trivial_model", "--batch_size", "2",
                                "--train_steps", "4", "--log_steps", "1",
                                "--skip_eval", "--skip_checkpoint",
                                "--nan_guard", "false", "--profile_steps",
                                "1,2", "--model_dir", str(tmp_path)])
    path = stats["profile_trace"]
    assert path == str(tmp_path / "profile_rank0_steps1-2.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("addmm" in e.get("name", "") or "linear" in e.get(
        "name", "") for e in events)
