"""``run(cfg) -> stats`` -- the JAX package's ``cli/runner.py`` ``run``
and ``_run``: tracing, chaos and the preemption guard -> runtime ->
spec -> model -> Trainer -> checkpoint restore -> input positioned at
the restored step -> prefetcher -> fit -> export -> "Run stats".

Recovery, as the JAX runner wires it: ``--trace_dir`` (or the
launcher's ``DTF_TRACE_DIR``) and the run-scoped trace id
(``DTF_TRACE_ID``, minted here for a standalone run), ``--fault`` (or
``DTF_FAULT``), the SIGTERM/SIGINT latch and ``--preemption_poll_s``'s
poller; a preempted run exits ``EXIT_PREEMPTED`` (75).
``--metrics_port`` serves the default registry (the MFU ledger's
``train_step`` gauges among them) from rank 0 (``obs/prom.py``).  With
``--model_dir`` and no ``--skip_checkpoint`` the Trainer saves sealed
checkpoints (every ``--checkpoint_steps``, at epoch ends, on
preemption) whose manifests carry the host state (seed, step, epoch,
data position); ``--resume`` restores the newest usable step, refuses
a checkpoint written under another ``--seed`` (it would continue on
other batches), and otherwise trains from scratch when there is none
(``--eval_only --resume`` raises instead).  The input stream is built
once, positioned at the restored step (``start_step``): batch n of the
synthetic and CIFAR streams is a function of (seed, n), so a resumed
run sees exactly the batches the uninterrupted one saw.  ``--export_dir``
writes the inference variables after training.

``--distribution_strategy parameter_server --ps_mode async`` leaves
here for ``parallel/ps.py run_async`` once tracing, chaos and the
preemption guard are set up: the store's rank and its workers join no
process group.  Otherwise the runtime (``runtime/mesh.py initialize``)
comes first, before anything touches CUDA: it joins the process group
of a data-parallel run and picks the rank's card.  ``--batch_size`` is global, except
under ``horovod`` and ``parameter_server``, where it is per replica
(:func:`effective_global_batch`); each process feeds its share, the
global batch over the process count.  The synthetic stream is the JAX
package's: every rank draws the same batch from ``--seed``.  CIFAR
files are read by file shard, and the eval stride-sharded and masked.
The benchmark log and "Run stats" come from the coordinator only, and
the process group is destroyed at the end.

Both families are ported.  The vision models (ResNet-50, the CIFAR
ResNets, ``--use_trivial_model``'s probe) draw their float32 parameters
from ``--seed`` with their own flax initializers (``init_weights``) and
are laid out ``torch.channels_last`` on ``--device``; their run sets
``torch.backends.cudnn.deterministic``, so the step is as deterministic
as XLA's.  The transformer LMs draw theirs with
``serve.bridge.random_init``.  Input: the synthetic stream for every
dataset, CIFAR-10 binary files under ``--data_dir``, and ImageNet
TFRecord shards under ``--data_dir``, on the uint8 wire (normalized on
the device by the Trainer) or the float32 one; ``--data_dir`` for LM
data raises.  ImageNet trains from the data service by default
(``data/service``: batch n a pure function of (seed, process, n), so a
resumed run replays its exact stream, whatever ``--input_workers``) or,
with ``--input_service false``, the legacy threaded pipeline; its eval
is the masked, file-sharded pass of ``data/imagenet.py``.  With the
service on, a checkpoint's host state carries ``num_shards`` and the
per-shard positions, and ``--resume`` refuses a checkpoint written
under another ``--input_num_shards``.  The train stream is closed at
the end of the run; the stats name the JPEG decode path (``native`` or
``pil``, ``input_decode``).  ``--enable_tensorboard`` writes scalar
event files under ``--model_dir/train`` from the coordinator.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import shutil
import sys
from typing import Optional

import numpy as np
import torch

from dtf_tpu_torch import chaos
from dtf_tpu_torch.config import parse_flags
from dtf_tpu_torch.data import get_dataset_spec, synthetic_input_fn
from dtf_tpu_torch.data.normalize import for_config
from dtf_tpu_torch.data.pipeline import DevicePrefetcher
from dtf_tpu_torch.models.registry import build_model, is_vision
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.runtime.mesh import (LOCAL_STRATEGIES, MeshRuntime,
                                        initialize, mirrored_world)
from dtf_tpu_torch.serve.bridge import random_init
from dtf_tpu_torch.train import Trainer, preemption
from dtf_tpu_torch.train.checkpoint import CheckpointCallback, export_model
from dtf_tpu_torch.utils.logs import build_stats

log = logging.getLogger("dtf_tpu_torch")


def effective_global_batch(cfg, runtime: MeshRuntime) -> int:
    """``--batch_size`` as the global batch: as given under mirrored
    and multi_worker_mirrored (Keras-fit semantics); times the replicas
    under horovod and parameter_server, where each reference rank drove
    one GPU with its own ``--batch_size``."""
    if cfg.distribution_strategy in ("horovod", "parameter_server"):
        return cfg.batch_size * runtime.num_replicas
    return cfg.batch_size


def make_input_fns(cfg, spec, global_batch: int, runtime: MeshRuntime):
    """(train_iter_factory, eval_iter_factory) of this process's numpy
    batches: its 1/process-count share of the global batch.  The train
    factory takes ``start_step``: a resumed run's stream starts at the
    restored step's batch."""
    rank, count = runtime.rank, runtime.num_replicas
    if global_batch % count:
        raise ValueError(
            f"global batch_size {global_batch} must be divisible by the "
            f"process count ({count})")
    host_batch = global_batch // count
    if cfg.use_synthetic_data or not cfg.data_dir:
        fns = (lambda start_step=0: synthetic_input_fn(
                   spec, True, host_batch, cfg.seed, start_step=start_step),
               lambda: synthetic_input_fn(spec, False, host_batch,
                                          cfg.seed + 1))
    elif spec.name == "cifar10":
        from dtf_tpu_torch.data.cifar import cifar_input_fn
        fns = (lambda start_step=0: cifar_input_fn(
                   cfg.data_dir, True, host_batch, seed=cfg.seed,
                   process_id=rank, process_count=count,
                   wire=cfg.input_wire, start_step=start_step),
               lambda: cifar_input_fn(cfg.data_dir, False, host_batch,
                                      process_id=rank, process_count=count,
                                      drop_remainder=cfg.drop_remainder,
                                      wire=cfg.input_wire))
    elif spec.name == "imagenet":
        from dtf_tpu_torch.data.imagenet import imagenet_input_fn
        if cfg.input_service:
            # the sharded deterministic service (the default): batch n
            # is a pure function of (seed, process, n), so a resumed run
            # replays exactly, and decode runs in worker processes
            from dtf_tpu_torch.data.service import service_input_fn
            train_fn = lambda start_step=0: service_input_fn(
                cfg.data_dir, host_batch, seed=cfg.seed,
                num_shards=cfg.input_num_shards,
                num_workers=cfg.input_workers, process_id=rank,
                process_count=count, wire=cfg.input_wire,
                cache_dir=cfg.input_cache_dir,
                cache_limit_mb=cfg.input_cache_limit_mb,
                start_step=start_step)
        else:
            # the legacy threaded pipeline (fused native decode), which
            # refuses a mid-stream resume: its order is decode-timing
            # dependent
            train_fn = lambda start_step=0: imagenet_input_fn(
                cfg.data_dir, True, host_batch, seed=cfg.seed,
                num_threads=cfg.datasets_num_private_threads,
                process_id=rank, process_count=count,
                fast_dct=cfg.input_fast_dct,
                scaled_decode=cfg.input_scaled_decode,
                wire=cfg.input_wire, start_step=start_step)
        fns = (train_fn,
               lambda: imagenet_input_fn(cfg.data_dir, False, host_batch,
                                         process_id=rank,
                                         process_count=count,
                                         drop_remainder=cfg.drop_remainder,
                                         wire=cfg.input_wire))
    else:
        raise NotImplementedError(
            f"--data_dir {cfg.data_dir!r}: the {spec.name} input pipeline "
            f"is not ported to dtf_tpu_torch yet (CIFAR-10 binary files "
            f"and ImageNet TFRecords are); pass --use_synthetic_data")
    if cfg.data_format == "channels_first" and not spec.is_sequence:
        # batches flow NCHW from here on; the Trainer transposes back
        fns = tuple(_channels_first_factory(fn) for fn in fns)
    return fns


def _channels_first_factory(fn):
    def wrapped(*args, **kw):
        for batch in fn(*args, **kw):
            images = np.ascontiguousarray(
                np.asarray(batch[0]).transpose(0, 3, 1, 2))
            yield (images,) + tuple(batch[1:])
    return wrapped


def build_model_for(cfg, spec, device, bn_group=None):
    """(model on ``device`` with its seeded weights, l2 weight);
    ``bn_group`` makes a vision model's BatchNorms sync BN."""
    name = "trivial" if cfg.use_trivial_model else cfg.model
    model_kw = {}
    if is_vision(name):
        if cfg.remat:
            if name == "resnet50":
                raise NotImplementedError(
                    "--remat on resnet50 is the selective conv_out/bn_stats "
                    "policy, which is not ported to dtf_tpu_torch yet")
            raise ValueError(f"--remat is implemented for the transformer "
                             f"families and resnet50, not {name!r}")
        if name == "trivial":
            model_kw["in_features"] = math.prod(spec.image_shape)
    else:
        model_kw["remat"] = cfg.remat
    model, l2 = build_model(name, num_classes=spec.num_classes,
                            dtype=cfg.compute_dtype, bn_group=bn_group,
                            **model_kw)
    if not is_vision(name):
        return random_init(model, cfg.seed).to(device), l2
    if device.type == "cuda":
        # cuDNN's default may pick weight-gradient algorithms that add
        # with atomics, and autotuning may pick another algorithm in a
        # restarted process; the reference's step is bit-reproducible
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    model = model.init_weights(cfg.seed)
    return model.to(device, memory_format=torch.channels_last), l2


def build_training(cfg, runtime: Optional[MeshRuntime] = None):
    """(trainer, state, train_fn, eval_fn) for a Config: on the
    runtime's device and data axis (``initialize(cfg)`` when None)."""
    rt = runtime or initialize(cfg)
    spec = get_dataset_spec(cfg.dataset)
    if cfg.num_classes:
        spec = dataclasses.replace(spec, num_classes=cfg.num_classes)
    if cfg.seq_len and spec.is_sequence:
        spec = dataclasses.replace(spec, seq_len=cfg.seq_len)
    global_batch = effective_global_batch(cfg, rt)
    cfg = cfg.replace(batch_size=global_batch)
    model, l2 = build_model_for(cfg, spec, rt.device,
                                bn_group=rt.group if cfg.sync_bn else None)
    trainer = Trainer(cfg, model, l2, spec,
                      normalize_fn=for_config(cfg, spec), runtime=rt)
    train_fn, eval_fn = make_input_fns(cfg, spec, global_batch, rt)
    return trainer, trainer.init_state(), train_fn, eval_fn


def run(cfg, runtime: Optional[MeshRuntime] = None) -> dict:
    """Train per ``cfg`` and return the stats dict (logged as "Run
    stats" by the coordinator).  ``runtime``: an initialized one
    (``initialize(cfg, backend=...)``), else ``initialize(cfg)``; its
    process group is destroyed at the end either way.  A preemption
    (SIGTERM/SIGINT, or the metadata poller) ends in an emergency
    checkpoint and ``SystemExit(EXIT_PREEMPTED)``."""
    rt, poller, metrics_server = runtime, None, None
    try:
        trace.maybe_configure(cfg)
        # run-scoped trace id: the launcher mints one (DTF_TRACE_ID) so
        # every rank's and every restart's records share it
        trace.set_default_trace(os.environ.get("DTF_TRACE_ID")
                                or trace.new_trace_id())
        chaos.maybe_configure(cfg)
        preemption.install()
        if cfg.preemption_poll_s:
            poller = preemption.MetadataPoller(cfg.preemption_poll_s).start()
        if cfg.metrics_port and not (cfg.process_id or 0):
            # rank 0 only: co-hosted ranks must not race for one port.
            # The default registry: the ledger's train_step gauges, the
            # data service's reader lag, cache and respawns
            from dtf_tpu_torch.obs.prom import MetricsServer
            metrics_server = MetricsServer(cfg.metrics_port)
        if (cfg.distribution_strategy == "parameter_server"
                and cfg.ps_mode == "async"):
            # push/pull against the parameter store: no runtime, no
            # process group -- each worker steps on its own card, and
            # the PS rank touches no card at all
            from dtf_tpu_torch.parallel import ps
            return ps.run_async(cfg)
        rt = rt or initialize(cfg)
        return _run(cfg, rt)
    except preemption.Preempted as p:
        log.warning("run preempted at step %d -- emergency checkpoint (or, "
                    "async PS, the store's snapshot) written; exiting %d",
                    p.step, preemption.EXIT_PREEMPTED)
        trace.flush()
        raise SystemExit(preemption.EXIT_PREEMPTED)
    finally:
        if metrics_server is not None:
            metrics_server.shutdown()
        if poller is not None:
            poller.stop()
        preemption.restore()
        if rt is not None:
            rt.shutdown()


def service_on(cfg, spec) -> bool:
    """True when the run's train stream is the data service (the branch
    order of :func:`make_input_fns`): synthetic runs have no shards, so
    their manifests must not claim the service's host state."""
    return (spec.name == "imagenet" and cfg.input_service
            and bool(cfg.data_dir) and not cfg.use_synthetic_data)


def _checkpointing(cfg, trainer: Trainer, rt: MeshRuntime, state):
    """(CheckpointCallback or None, state, resumed step): the callback
    when ``--model_dir`` is set and saves or ``--resume`` are asked for,
    and the state ``--resume`` restored (else the fresh ``state``)."""
    if not cfg.model_dir or (cfg.skip_checkpoint and not cfg.resume):
        return None, state, 0
    spe = trainer.steps_per_epoch
    service = service_on(cfg, trainer.spec)

    def host_state_fn(step):
        data = {"scheme": "position-derived", "dataset": cfg.dataset,
                "start_step": step}
        if service:
            # the stream's identity (the merged order depends on the
            # shard count) and the per-shard next positions, which the
            # step alone derives: the manifest is self-describing
            from dtf_tpu_torch.data.service import shard_positions
            data["num_shards"] = cfg.input_num_shards
            data["shard_positions"] = shard_positions(
                step, cfg.input_num_shards)
        return {"seed": cfg.seed, "global_step": step,
                "epoch": step // spe, "step_in_epoch": step % spe,
                # which topology WROTE this step -- informational: the
                # payload is topology-free
                "topology": {"devices": rt.num_replicas,
                             "replicas": rt.num_replicas,
                             "processes": rt.num_replicas},
                "data": data}

    cb = CheckpointCallback(cfg.model_dir, trainer.checkpoint_payload,
                            every_steps=cfg.checkpoint_steps,
                            host_state_fn=host_state_fn,
                            keep=cfg.checkpoint_keep, runtime=rt)
    if not cfg.resume:
        return cb, state, 0
    payload = cb.ckpt.restore()
    if payload is None:
        if cfg.eval_only:
            # evaluating random init as if it were a checkpoint would
            # silently report garbage
            raise FileNotFoundError(
                f"--eval_only --resume: no checkpoint found under "
                f"{cfg.model_dir}/checkpoints; point --model_dir at a "
                f"trained run")
        log.warning("--resume: no checkpoint found under %s/checkpoints "
                    "-- training from scratch", cfg.model_dir)
        return cb, state, 0
    host = cb.ckpt.host_state(cb.ckpt.last_restored_step) or {}
    if host.get("seed") is not None and host["seed"] != cfg.seed:
        # another seed derives another data stream: the resumed run would
        # silently train on other batches than the run it continues
        raise ValueError(
            f"--resume seed mismatch: checkpoint was written with seed "
            f"{host['seed']}, this run has --seed {cfg.seed}; crash-exact "
            f"resume needs the same seed (pass --seed {host['seed']})")
    shards = host.get("data", {}).get("num_shards")
    if service and shards is not None and int(shards) != \
            cfg.input_num_shards:
        # the merged order (batch n = shard n % S, its batch n // S)
        # depends on the shard count: another count is another stream
        raise ValueError(
            f"--resume input_num_shards mismatch: checkpoint was written "
            f"with {shards} shard(s), this run has --input_num_shards "
            f"{cfg.input_num_shards}; the merged batch order depends on "
            f"the shard count (pass --input_num_shards {shards}).  The "
            f"worker count, by contrast, may change freely")
    state = trainer.restore_state(payload)
    return cb, state, state.step


def _run(cfg, rt: MeshRuntime) -> dict:
    if cfg.clean and cfg.model_dir and rt.is_coordinator:
        shutil.rmtree(cfg.model_dir, ignore_errors=True)
    trainer, state, train_fn, eval_fn = build_training(cfg, rt)
    cfg = trainer.cfg
    ckpt_cb, state, resumed_step = _checkpointing(cfg, trainer, rt, state)
    if cfg.eval_only:
        eval_output = trainer.evaluate(state, eval_fn())
        stats = build_stats({}, eval_output, None)
        stats["eval_count"] = trainer.eval_count
        log.info("Run stats (eval only): %s", stats)
        return stats
    callbacks = [ckpt_cb] if ckpt_cb is not None and not cfg.skip_checkpoint \
        else []
    if cfg.enable_tensorboard and cfg.model_dir and rt.is_coordinator:
        from dtf_tpu_torch.utils.tensorboard import TensorBoardCallback
        callbacks.append(TensorBoardCallback(cfg.model_dir))
    # the one stream of the run, positioned at the restored step
    stream = train_fn(start_step=resumed_step)
    prefetched = DevicePrefetcher(stream, trainer.device, buffer_size=2)
    try:
        state, stats = trainer.fit(
            state, prefetched,
            eval_iter_fn=None if cfg.skip_eval else eval_fn,
            callbacks=callbacks)
    finally:
        prefetched.close()
        if hasattr(stream, "close"):
            # the service's worker processes, the legacy pipeline's
            # threads
            stream.close()
    if trainer.spec.name == "imagenet" and cfg.data_dir \
            and not cfg.use_synthetic_data:
        from dtf_tpu_torch import native
        stats["input_decode"] = native.decode_path()
    if cfg.export_dir and rt.is_coordinator:
        export_model(cfg.export_dir, trainer.model)
    if not rt.is_coordinator:
        return stats
    if cfg.benchmark_log_dir:
        from dtf_tpu_torch.utils.benchmark_logger import BenchmarkFileLogger
        blog = BenchmarkFileLogger(cfg.benchmark_log_dir)
        blog.log_run_info(cfg.model, cfg.dataset, cfg.to_dict(),
                          trainer.device, test_id=cfg.benchmark_test_id)
        for key in ("loss", "avg_exp_per_second", "eval_loss",
                    "accuracy_top_1"):
            if key in stats:
                blog.log_metric(key, stats[key], global_step=state.step)
    log.info("Run stats: %s",
             {k: v for k, v in stats.items() if k != "step_timestamp_log"})
    return stats


def main_run(module: str, argv, defaults: dict) -> dict:
    """An entry point's body: parse ``argv`` over ``defaults`` and run.
    A ``mirrored`` (or ``tpu``) command with no named topology over more
    than one local device starts one rank a device through
    ``cli/launch.py`` (``python -m module argv`` each, logs under
    ``./ranklogs``) and returns {} once they all succeed."""
    cfg = parse_flags(argv, defaults=defaults)
    if (cfg.distribution_strategy in LOCAL_STRATEGIES
            and cfg.process_count is None and mirrored_world(cfg) > 1):
        from dtf_tpu_torch.cli.launch import free_address, launch_local
        rc = launch_local([sys.executable, "-m", module] + list(argv),
                          mirrored_world(cfg), free_address(), "./ranklogs")
        if rc:
            raise SystemExit(rc)
        return {}
    return run(cfg)
