"""``run(cfg) -> stats`` -- the single-device body of the JAX package's
``cli/runner.py`` ``_run``: spec -> model -> Trainer -> input ->
prefetcher -> fit -> "Run stats".

Both families are ported.  The vision models (ResNet-50, the CIFAR
ResNets, ``--use_trivial_model``'s probe) draw their float32 parameters
from ``--seed`` with their own flax initializers (``init_weights``) and
are laid out ``torch.channels_last`` on ``--device``; their run sets
``torch.backends.cudnn.deterministic``, so the step is as deterministic
as XLA's.  The transformer LMs draw theirs with
``serve.bridge.random_init``.  Input: the synthetic stream for every
dataset, and CIFAR-10 binary files under ``--data_dir``, on the uint8
wire (normalized on the device by the Trainer) or the float32 one;
``--data_dir`` for ImageNet or LM data raises.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from dtf_tpu_torch.data import get_dataset_spec, synthetic_input_fn
from dtf_tpu_torch.data.normalize import for_config
from dtf_tpu_torch.data.pipeline import DevicePrefetcher
from dtf_tpu_torch.models.registry import build_model, is_vision
from dtf_tpu_torch.runtime.device import resolve_device
from dtf_tpu_torch.serve.bridge import random_init
from dtf_tpu_torch.train import Trainer

log = logging.getLogger("dtf_tpu_torch")


def make_input_fns(cfg, spec, global_batch: int):
    """(train_iter_factory, eval_iter_factory) of host numpy batches."""
    if cfg.use_synthetic_data or not cfg.data_dir:
        fns = (lambda: synthetic_input_fn(spec, True, global_batch,
                                          cfg.seed),
               lambda: synthetic_input_fn(spec, False, global_batch,
                                          cfg.seed + 1))
    elif spec.name == "cifar10":
        from dtf_tpu_torch.data.cifar import cifar_input_fn
        fns = (lambda: cifar_input_fn(cfg.data_dir, True, global_batch,
                                      seed=cfg.seed, wire=cfg.input_wire),
               lambda: cifar_input_fn(cfg.data_dir, False, global_batch,
                                      drop_remainder=cfg.drop_remainder,
                                      wire=cfg.input_wire))
    else:
        raise NotImplementedError(
            f"--data_dir {cfg.data_dir!r}: the {spec.name} input pipeline "
            f"is not ported to dtf_tpu_torch yet (CIFAR-10 binary files "
            f"are); pass --use_synthetic_data")
    if cfg.data_format == "channels_first" and not spec.is_sequence:
        # batches flow NCHW from here on; the Trainer transposes back
        fns = tuple(_channels_first_factory(fn) for fn in fns)
    return fns


def _channels_first_factory(fn):
    def wrapped():
        for batch in fn():
            images = np.ascontiguousarray(
                np.asarray(batch[0]).transpose(0, 3, 1, 2))
            yield (images,) + tuple(batch[1:])
    return wrapped


def build_model_for(cfg, spec, device):
    """(model on ``device`` with its seeded weights, l2 weight)."""
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
                            dtype=cfg.compute_dtype, **model_kw)
    if not is_vision(name):
        return random_init(model, cfg.seed).to(device), l2
    if device.type == "cuda":
        # cuDNN's default may pick weight-gradient algorithms that add
        # with atomics; the reference's step is bit-reproducible
        torch.backends.cudnn.deterministic = True
    model = model.init_weights(cfg.seed)
    return model.to(device, memory_format=torch.channels_last), l2


def build_training(cfg):
    """(trainer, state, train_fn, eval_fn) for a Config, on its device."""
    device = resolve_device(cfg.device)
    spec = get_dataset_spec(cfg.dataset)
    if cfg.num_classes:
        spec = dataclasses.replace(spec, num_classes=cfg.num_classes)
    if cfg.seq_len and spec.is_sequence:
        spec = dataclasses.replace(spec, seq_len=cfg.seq_len)
    model, l2 = build_model_for(cfg, spec, device)
    trainer = Trainer(cfg, model, l2, spec,
                      normalize_fn=for_config(cfg, spec))
    train_fn, eval_fn = make_input_fns(cfg, spec, cfg.batch_size)
    return trainer, trainer.init_state(), train_fn, eval_fn


def run(cfg) -> dict:
    """Train per ``cfg`` and return the stats dict (logged as "Run
    stats")."""
    trainer, state, train_fn, eval_fn = build_training(cfg)
    prefetched = DevicePrefetcher(train_fn(), trainer.device, buffer_size=2)
    try:
        state, stats = trainer.fit(
            state, prefetched,
            eval_iter_fn=None if cfg.skip_eval else eval_fn)
    finally:
        prefetched.close()
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
