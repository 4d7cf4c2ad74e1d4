"""``run(cfg) -> stats`` -- the single-device body of the JAX package's
``cli/runner.py`` ``_run``: spec -> model -> Trainer -> synthetic input
-> prefetcher -> fit -> "Run stats".

The model's float32 parameters are drawn from ``--seed`` with flax's
default initializers (``serve.bridge.random_init``), on the CPU, then
moved to ``--device``.  Only the token (LM) datasets have a ported
model family, and only the synthetic input is ported: ``--data_dir``
without ``--use_synthetic_data`` raises.
"""

from __future__ import annotations

import dataclasses
import logging

from dtf_tpu_torch.data import get_dataset_spec, synthetic_input_fn
from dtf_tpu_torch.data.pipeline import DevicePrefetcher
from dtf_tpu_torch.models.registry import build_model
from dtf_tpu_torch.runtime.device import resolve_device
from dtf_tpu_torch.serve.bridge import random_init
from dtf_tpu_torch.train import Trainer

log = logging.getLogger("dtf_tpu_torch")


def make_input_fns(cfg, spec, global_batch: int):
    """(train_iter_factory, eval_iter_factory) of host numpy batches."""
    if cfg.data_dir and not cfg.use_synthetic_data:
        raise NotImplementedError(
            f"--data_dir {cfg.data_dir!r}: the real input pipelines are not "
            f"ported to dtf_tpu_torch yet; pass --use_synthetic_data")
    return (lambda: synthetic_input_fn(spec, True, global_batch, cfg.seed),
            lambda: synthetic_input_fn(spec, False, global_batch,
                                       cfg.seed + 1))


def build_training(cfg):
    """(trainer, state, train_fn, eval_fn) for a Config, on its device."""
    device = resolve_device(cfg.device)
    spec = get_dataset_spec(cfg.dataset)
    if cfg.num_classes:
        spec = dataclasses.replace(spec, num_classes=cfg.num_classes)
    if cfg.seq_len and spec.is_sequence:
        spec = dataclasses.replace(spec, seq_len=cfg.seq_len)
    if not spec.is_sequence:
        raise NotImplementedError(
            f"dataset {spec.name!r}: only the LM family is ported to "
            f"dtf_tpu_torch so far")
    model, l2 = build_model(cfg.model, num_classes=spec.num_classes,
                            dtype=cfg.compute_dtype, remat=cfg.remat)
    model = random_init(model, cfg.seed).to(device)
    trainer = Trainer(cfg, model, l2, spec)
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
