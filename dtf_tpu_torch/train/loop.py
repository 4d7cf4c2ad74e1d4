"""The training and eval loop -- the PyTorch counterpart of
``dtf_tpu/train/loop.py`` ``Trainer``, on one device a process, the
replicas of a data-parallel run being processes
(``runtime/mesh.py``).

``train_step`` is the JAX step's arithmetic in eager PyTorch, on this
replica's share of the global batch:
  - the inputs first: an NCHW batch (``--data_format channels_first``)
    transposed to NHWC, then the uint8 wire's normalization
    (``normalize_fn``, ``data/normalize.py``) on the device;
  - cross-entropy (the mean over positions, on float32 logits) plus the
    model's L2 term;
  - ``grad_accum_steps`` sequential micro-batches, their gradients
    summed into the float32 ``.grad`` of the float32 parameters and
    divided by the count; a BatchNorm model's running statistics are
    module buffers, moved by each micro-batch in order in train mode,
    as the JAX scan threads ``batch_stats``;
  - static loss scaling (``--loss_scale N``) or dynamic scaling with TF2
    LossScaleOptimizer semantics: a step whose gradients are not all
    finite is skipped (parameters, optimizer state and BN buffers kept)
    and the scale halved (not below 1); the scale doubles after
    ``DYNAMIC_GROWTH_INTERVAL`` finite steps in a row;
  - data parallelism, in the JAX step's order: the unscaled gradients,
    the BN running statistics and the step's loss and accuracy are
    averaged over the replicas in one all-reduce of a flat float32
    buffer (one writer, a fixed order: every rank ends the step with
    the same bits); the global norm is clipped after it; a dynamic
    scale's finite verdict is the replicas' minimum;
  - global-norm clipping (``--clip_grad_norm``);
  - the optimizer update at ``schedule(state.step)``; the metrics
    ``loss``, ``learning_rate`` and ``accuracy`` (0-d device tensors,
    read only at log cadence).
``evaluate`` runs the model in eval mode (BN on its running statistics)
and takes masked sums, so a padded last batch counts each real example
once; the replicas' sums are added.  ``fit`` runs the reference's
``TimeHistory`` cadence: it reads the loss from the device at every log
boundary -- a sync, so the logged time is the device's and not the
enqueue's -- before the BenchmarkMetric line is written.

Around each step ``fit`` does what the JAX loop does: it starts at the
state's step (a resumed run continues mid-epoch at batch step %
steps_per_epoch; its data stream is positioned by the runner), emits a
``train_loss`` event with the loss's exact float at each log step (the
crash-exactness checks compare these), ``step``/``eval`` spans and
``log_window`` spans (``obs/trace.py``), runs the NaN-loss and
step-time watchdogs and the launcher's heartbeat (``obs/watchdog.py``),
calls the chaos probe after the interval checkpoint of a boundary is
sealed, and honours the preemption latch (``train/preemption.py``):
the callbacks' ``on_preempt`` (the emergency checkpoint), a
``preempted`` event, then ``Preempted``.  Under data parallelism the
replicas must stop at the same boundary: each step's all-reduce carries
the rank's latch, and every rank acts on the previous step's reduced
flag (read one step late, so reading it never idles the device).
``checkpoint_payload`` and ``restore_state`` carry the TrainState to
and from the checkpoint's flat flax-keyed payload (``convert.py``).

Initialization is seed-synced: every replica draws the same weights from
``--seed`` (horovod's broadcast, as the JAX package does it).  Logs come
from the coordinator (rank 0) only.

``--stop_threshold`` ends training after the first eval whose top-1
reaches it, and ``--profile_steps "start,stop"`` runs ``torch.profiler``
over that range of steps (:class:`StepProfiler`).

The MFU ledger (``obs/ledger.py``) registers ``train_step`` once: the
first step of a ``fit`` runs under the FLOP counter (aten FLOPs plus
the attention kernels' own counts), and every clean log window feeds
its synced per-step wall time; the summary goes to the trace at the
end and into the stats as ``ledger``.  ``DTF_LEDGER=0`` turns it off,
as in the JAX loop.

Not ported yet: ZeRO and TP/EP/PP; the flags that ask for them raise
(``config/flags.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dtf_tpu_torch import chaos
from dtf_tpu_torch.convert import state_from_flat, state_to_flat
from dtf_tpu_torch.data.base import DatasetSpec
from dtf_tpu_torch.models.registry import l2_weight_penalty
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.ledger import Ledger, count_flops
from dtf_tpu_torch.obs.watchdog import (Heartbeat, NanLossWatchdog,
                                        StepTimeWatchdog)
from dtf_tpu_torch.parallel.collectives import (all_reduce_mean,
                                                all_reduce_sum)
from dtf_tpu_torch.runtime.mesh import MeshRuntime
from dtf_tpu_torch.train import preemption
from dtf_tpu_torch.train import schedules as sched_lib
from dtf_tpu_torch.train.optimizer import apply_updates, build_optimizer
from dtf_tpu_torch.utils.logs import TimeHistory, build_stats

log = logging.getLogger("dtf_tpu_torch")

# TF2 LossScaleOptimizer dynamic defaults (the JAX package's values)
DYNAMIC_SCALE_INIT = 2.0 ** 15
DYNAMIC_GROWTH_INTERVAL = 2000


@dataclasses.dataclass
class TrainState:
    step: int
    params: List[torch.Tensor]     # the model's own parameters, in place
    opt_state: Any
    # dynamic loss scaling only: the live scale and the count of
    # consecutive finite steps; None under static scaling
    loss_scale: Optional[float] = None
    good_steps: Optional[int] = None


def per_example_cross_entropy(logits, labels):
    """Un-reduced CE with integer labels -- one value per position."""
    return F.cross_entropy(logits.flatten(0, -2), labels.flatten().long(),
                           reduction="none").view(labels.shape)


def cross_entropy(logits, labels):
    """Mean CE with integer labels, in float32."""
    return F.cross_entropy(logits.flatten(0, -2).float(),
                           labels.flatten().long())


class Trainer:
    """Runs the training and eval steps of one model replica.

    ``runtime`` is the replica's place on the data axis (``runtime/
    mesh.py initialize``); None is world 1 on the model's device."""

    def __init__(self, cfg, model, l2_weight: float, spec: DatasetSpec,
                 schedule: Optional[Callable] = None,
                 normalize_fn: Optional[Callable] = None,
                 runtime: Optional[MeshRuntime] = None):
        self.cfg = cfg
        self.model = model
        self.rt = runtime or MeshRuntime(
            strategy=cfg.distribution_strategy,
            device=next(model.parameters()).device)
        self.l2_weight = l2_weight
        self.spec = spec
        # the uint8 wire's normalization (None: host-normalized batches)
        self.normalize_fn = normalize_fn
        self.channels_first = (cfg.data_format == "channels_first"
                               and not spec.is_sequence)
        # the global batch: the runner has already scaled a per-replica
        # --batch_size (horovod, parameter_server) by the replicas
        self.global_batch = cfg.batch_size
        replicas = self.rt.num_replicas
        if self.global_batch % replicas:
            raise ValueError(
                f"global batch_size {self.global_batch} must be divisible "
                f"by the number of data-parallel replicas ({replicas}); "
                f"pick a batch size that is a multiple, or reduce "
                f"--num_devices")
        self.grad_accum = max(int(cfg.grad_accum_steps or 1), 1)
        if (self.global_batch // replicas) % self.grad_accum:
            raise ValueError(
                f"per-replica batch {self.global_batch // replicas} must "
                f"be divisible by grad_accum_steps ({self.grad_accum})")
        self.steps_per_epoch = spec.num_train // self.global_batch
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch_size {self.global_batch} exceeds the training set "
                f"({spec.num_train} examples): zero steps per epoch")
        self.train_epochs = cfg.train_epochs
        if cfg.train_steps:
            # the reference mains: train_steps caps to 1 epoch of that length
            self.steps_per_epoch = min(cfg.train_steps, self.steps_per_epoch)
            self.train_epochs = 1
        if schedule is not None:
            self.schedule = schedule
        elif cfg.distribution_strategy == "horovod":
            # horovod's constant replica-scaled LR after a 3-epoch ramp
            self.schedule = sched_lib.horovod_schedule(
                replicas, max(self.steps_per_epoch, 1))
        else:
            self.schedule = sched_lib.for_dataset(
                spec.name, self.global_batch, max(self.steps_per_epoch, 1),
                spec.num_train, use_tensor_lr=cfg.use_tensor_lr,
                train_epochs=self.train_epochs)
        self.tx = build_optimizer(cfg.optimizer, self.schedule)
        self.dynamic_scale = cfg.loss_scale_value == "dynamic"
        self.loss_scale = (1.0 if self.dynamic_scale
                           else float(cfg.loss_scale_value))
        self.report_acc = cfg.report_accuracy_metrics
        # (step, loss) at every log boundary, and the synced per-step
        # time of every log window that covered steps only
        self.loss_log: list = []
        self.window_step_s: list = []
        # unmasked examples (tokens for sequence data) of the last eval
        self.eval_count = 0.0
        # the BN running statistics (the models' only buffers), which
        # the replicas average after each step
        self.bn_buffers = list(model.buffers())

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init_state(self) -> TrainState:
        params = list(self.model.parameters())
        return TrainState(
            step=0, params=params, opt_state=self.tx.init(params),
            loss_scale=DYNAMIC_SCALE_INIT if self.dynamic_scale else None,
            good_steps=0 if self.dynamic_scale else None)

    def checkpoint_payload(self, state: TrainState) -> dict:
        """The checkpoint payload of ``state``: the JAX TrainState's
        leaves keyed by flax path, as CPU tensors."""
        return state_to_flat(self.model, state)

    def restore_state(self, payload: dict) -> TrainState:
        """Load a checkpoint payload into the model (in place) and
        return its TrainState, the optimizer's moments on the device."""
        return state_from_flat(payload, self.model)

    # ------------------------------------------------------------------
    def _clip(self, grads):
        clip = self.cfg.clip_grad_norm
        if not clip:
            return grads
        norm = torch.stack([g.float().square().sum() for g in grads]
                           ).sum().sqrt()
        factor = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        return [g * factor for g in grads]

    def _all_reduce_step(self, grads, loss, acc):
        """The replicas' mean of the gradients, the BN running
        statistics (written back into the buffers), the step's loss and
        accuracy and the ranks' preemption latch (nonzero when any rank
        latched a signal), through one all-reduce of a flat float32
        buffer.  Returns (grads, loss, acc, preempt)."""
        latched = float(preemption.triggered() is not None)
        # a fill on the device: a scalar copied from the host would
        # synchronize the stream in the middle of the step
        tail = torch.stack([torch.as_tensor(loss, dtype=torch.float32,
                                            device=self.device),
                            torch.as_tensor(acc, dtype=torch.float32,
                                            device=self.device),
                            torch.full((), latched, dtype=torch.float32,
                                       device=self.device)])
        parts = grads + self.bn_buffers + [tail]
        flat = all_reduce_mean(
            torch.cat([t.reshape(-1).float() for t in parts]), self.rt.group)
        views = [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in parts]), parts)]
        n = len(grads)
        with torch.no_grad():
            for b, v in zip(self.bn_buffers, views[n:-1]):
                b.copy_(v)
        return views[:n], views[-1][0], views[-1][1], views[-1][2]

    def _inputs(self, images):
        """The batch as the model takes it: NHWC, normalized."""
        if self.channels_first:
            images = images.permute(0, 2, 3, 1)
        if self.normalize_fn is not None:
            images = self.normalize_fn(images)
        return images

    def train_step(self, state: TrainState, images, labels):
        """One optimizer step on the batch (images, labels) -- device
        tensors; returns (new state, metrics)."""
        model = self.model
        model.train()
        images = self._inputs(images)
        scale = state.loss_scale if self.dynamic_scale else self.loss_scale
        # a skipped step keeps the BN running statistics too
        buffers = list(model.buffers()) if self.dynamic_scale else []
        kept = [b.clone() for b in buffers]
        for p in state.params:
            p.grad = None
        loss_sum = acc_sum = 0.0
        for imgs, lbls in zip(images.chunk(self.grad_accum),
                              labels.chunk(self.grad_accum)):
            logits = model(imgs)
            loss = (cross_entropy(logits, lbls)
                    + l2_weight_penalty(model, self.l2_weight))
            (loss * scale).backward()
            loss_sum = loss_sum + loss.detach()
            if self.report_acc:
                acc_sum = acc_sum + (logits.detach().argmax(-1)
                                     == lbls).float().mean()
            del logits, loss
        step_loss = loss_sum / self.grad_accum
        step_acc = acc_sum / self.grad_accum
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else p.grad for p in state.params]
        if self.grad_accum > 1:
            grads = [g / self.grad_accum for g in grads]
        if self.dynamic_scale or scale != 1.0:
            grads = [g / scale for g in grads]
        preempt = None
        if self.rt.group is not None:
            grads, step_loss, step_acc, preempt = self._all_reduce_step(
                grads, step_loss, step_acc)
        grads = self._clip(grads)
        for p in state.params:
            p.grad = None

        new_scale, new_good = state.loss_scale, state.good_steps
        finite = True
        if self.dynamic_scale:
            # one host sync per step: the verdict decides the update;
            # every replica must reach the same one
            bad = (~torch.stack([torch.isfinite(g).all()
                                 for g in grads])).sum().float()
            finite = not bool(all_reduce_sum(bad, self.rt.group))
            grew = state.good_steps + 1 >= DYNAMIC_GROWTH_INTERVAL
            if finite:
                new_scale = scale * 2.0 if grew else scale
                new_good = 0 if grew else state.good_steps + 1
            else:
                new_scale, new_good = max(scale * 0.5, 1.0), 0
        opt_state = state.opt_state
        if finite:
            updates, opt_state = self.tx.update(grads, state.opt_state,
                                                state.params,
                                                step=state.step)
            apply_updates(state.params, updates)
        else:
            with torch.no_grad():
                for b, k in zip(buffers, kept):
                    b.copy_(k)
        metrics = {"loss": step_loss,
                   "learning_rate": float(self.schedule(state.step))}
        if self.report_acc:
            metrics["accuracy"] = step_acc
        if self.dynamic_scale:
            metrics["loss_scale"] = new_scale
        if preempt is not None:
            metrics["preempt"] = preempt
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state, loss_scale=new_scale,
                          good_steps=new_good), metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, state: TrainState, eval_iter: Iterator,
                 heartbeat: Optional[Heartbeat] = None):
        """Weighted-exact eval over batches (images, labels[, mask]); a
        missing mask means every example is real.  Returns (mean loss,
        top-1) over exactly the unmasked examples (top-1 None under
        --report_accuracy_metrics false), or None for an empty
        iterator.  Units: tokens for sequence data, examples else."""
        del state
        model = self.model
        model.eval()
        dev = self.device
        loss_sum = correct = count = 0.0
        for batch in eval_iter:
            if heartbeat is not None:
                heartbeat.beat()
            images, labels = (torch.as_tensor(np.asarray(x), device=dev)
                              for x in batch[:2])
            images = self._inputs(images)
            mask = (torch.as_tensor(np.asarray(batch[2]), device=dev,
                                    dtype=torch.float32)
                    if len(batch) > 2 else
                    torch.ones(labels.shape[0], device=dev))
            logits = model(images)
            per = per_example_cross_entropy(logits, labels)
            w = (mask[:, None] * torch.ones_like(per) if per.dim() == 2
                 else mask)
            loss_sum += float((per * w).sum())
            if self.report_acc:
                correct += float(((logits.argmax(-1) == labels).float()
                                  * w).sum())
            count += float(w.sum())
        if self.rt.group is not None:
            loss_sum, correct, count = all_reduce_sum(torch.tensor(
                [loss_sum, correct, count], dtype=torch.float64,
                device=dev), self.rt.group).tolist()
        self.eval_count = count
        if count == 0:
            return None
        return (loss_sum / count,
                correct / count if self.report_acc else None)

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, train_iter: Iterator,
            eval_iter_fn: Optional[Callable[[], Iterator]] = None,
            callbacks: Optional[list] = None):
        """Runs training from ``state.step``; returns (state, stats)
        with the stats dict key-compatible with the reference's
        build_stats, plus ``train_loss_log`` [(step, loss)] and
        ``window_step_s``."""
        cfg = self.cfg
        resumed_step = int(state.step)
        time_cb = TimeHistory(self.global_batch, cfg.log_steps,
                              initial_global_step=resumed_step)
        callbacks = [time_cb] + list(callbacks or [])
        # watchdogs (obs/watchdog.py): the NaN check reads the loss this
        # loop already syncs at log cadence; the step-time guard watches
        # the synced log windows; the heartbeat exists only when the
        # launcher exported DTF_HEARTBEAT_DIR
        nan_guard = NanLossWatchdog(enabled=cfg.nan_guard)
        step_guard = (StepTimeWatchdog(factor=cfg.step_time_guard_factor)
                      if cfg.step_time_guard_factor else None)
        heartbeat = Heartbeat.from_env(interval_s=cfg.heartbeat_secs)
        ckpt_every = cfg.checkpoint_steps or 0
        acc_key = ("categorical_accuracy" if self.spec.one_hot
                   else "sparse_categorical_accuracy")
        history: dict = {"loss": [], acc_key: []}
        # the first window covers the kernels' build and first launches,
        # and a window after an epoch boundary or an interval checkpoint
        # its eval or save: skipped
        window_skewed = True
        window_t0 = time.monotonic()
        for cb in callbacks:
            _call(cb, "on_train_begin", None)
        eval_output = None
        metrics = None
        # data parallelism: the previous step's all-reduced latch
        pending_preempt = None
        global_step = resumed_step
        spe = self.steps_per_epoch
        # crash-exact mid-epoch resume: a run restored at step K of
        # epoch E continues at batch K % spe -- neither re-training the
        # epoch's prefix nor consuming those batches
        start_epoch, start_batch = divmod(global_step, spe)
        if global_step and self.rt.is_coordinator:
            log.info("resuming at step %d (epoch %d, batch %d)",
                     global_step, start_epoch, start_batch)
        profiler = StepProfiler(cfg, self.device, self.rt.rank)
        # the MFU ledger on the default registry (what --metrics_port
        # serves): the first step counted, then each clean window
        ledger = Ledger(device=self.device)
        count_pending = os.environ.get("DTF_LEDGER", "1") != "0"
        t0 = time.time()
        try:
            for epoch in range(start_epoch, self.train_epochs):
                for cb in callbacks:
                    _call(cb, "on_epoch_begin", epoch, None)
                for batch_idx in range(start_batch if epoch == start_epoch
                                       else 0, spe):
                    for cb in callbacks:
                        _call(cb, "on_batch_begin", batch_idx, None)
                    profiler.before_step(global_step)
                    images, labels = next(train_iter)
                    with trace.span("step", step=global_step):
                        if count_pending:
                            # its wall sits in the first window, which
                            # is skipped
                            (state, metrics), count = count_flops(
                                self.train_step, state, images, labels)
                            ledger.register("train_step", flops=count.total)
                            count_pending = False
                        else:
                            state, metrics = self.train_step(state, images,
                                                             labels)
                    global_step += 1
                    if global_step % cfg.log_steps == 0:
                        # the sync: the host waits for the step's loss
                        loss_val = float(metrics["loss"])
                        nan_guard.check(global_step, loss_val)
                        # the loss trajectory record: Python floats
                        # round-trip JSON exactly, so crash-exactness
                        # checks compare these bit for bit
                        trace.event("train_loss", step=global_step,
                                    loss=loss_val)
                        self.loss_log.append((global_step, loss_val))
                        if self.rt.is_coordinator:
                            log.info("step %d: loss %.6f lr %.6g", global_step,
                                     loss_val, metrics["learning_rate"])
                        now = time.monotonic()
                        if not window_skewed:
                            window_s = now - window_t0
                            trace.span_completed(
                                "log_window", window_s, step=global_step,
                                steps=cfg.log_steps,
                                step_s=window_s / cfg.log_steps)
                            self.window_step_s.append(window_s / cfg.log_steps)
                            ledger.observe("train_step",
                                           window_s / cfg.log_steps)
                            if step_guard is not None:
                                step_guard.observe(global_step, window_s)
                        window_t0 = now
                        window_skewed = False
                    if heartbeat is not None:
                        heartbeat.beat(step=global_step)
                    profiler.after_step(global_step)
                    # interval checkpointing reads state and step from the
                    # logs dict (CheckpointCallback.every_steps)
                    for cb in callbacks:
                        _call(cb, "on_batch_end", batch_idx,
                              {"state": state, "step": global_step})
                    if ckpt_every and global_step % ckpt_every == 0:
                        # a sealed save ran inside this log window: keep its
                        # I/O out of the step-time signal
                        window_skewed = True
                    # chaos probe AFTER the interval checkpoint sealed:
                    # crash@step:K with checkpoint_steps dividing K is the
                    # deterministic kill-after-durable-save experiment
                    chaos.step(global_step)
                    signum = self._preempt_signal(pending_preempt)
                    pending_preempt = metrics.get("preempt")
                    if signum is not None:
                        # emergency checkpoint at this boundary (sealed),
                        # then the preempted exit the supervisor restarts
                        # without spending the crash budget
                        for cb in callbacks:
                            _call(cb, "on_preempt",
                                  {"state": state, "step": global_step})
                        trace.event("preempted", step=global_step,
                                    signum=int(signum))
                        trace.flush()
                        raise preemption.Preempted(global_step, signum)
                loss_val = float(metrics["loss"])
                nan_guard.check(global_step, loss_val)
                trace.event("epoch_end", epoch=epoch, step=global_step,
                            loss=loss_val)
                history["loss"].append(loss_val)
                if "accuracy" in metrics:
                    history[acc_key].append(float(metrics["accuracy"]))
                for cb in callbacks:
                    _call(cb, "on_epoch_end", epoch,
                          {"state": state, "history": history})
                if heartbeat is not None:
                    heartbeat.beat(step=global_step)
                if self.rt.is_coordinator:
                    log.info("epoch %d/%d: loss=%.4f top1=%s lr=%.5f",
                             epoch + 1, self.train_epochs, history["loss"][-1],
                             ("%.4f" % history[acc_key][-1])
                             if "accuracy" in metrics else "n/a",
                             metrics["learning_rate"])
                if (not cfg.skip_eval and eval_iter_fn is not None
                        and ((epoch + 1) % cfg.epochs_between_evals == 0
                             or epoch + 1 == self.train_epochs)):
                    with trace.span("eval", epoch=epoch, step=global_step):
                        eval_output = self.evaluate(state, eval_iter_fn(),
                                                    heartbeat=heartbeat)
                    if eval_output and self.rt.is_coordinator:
                        log.info("eval: loss=%.4f top1=%s", eval_output[0],
                                 ("%.4f" % eval_output[1])
                                 if eval_output[1] is not None else "n/a")
                    # --stop_threshold (the reference's
                    # past_stop_threshold): end training once eval
                    # top-1 reaches the threshold
                    if (eval_output and cfg.stop_threshold is not None
                            and eval_output[1] is not None
                            and eval_output[1] >= cfg.stop_threshold):
                        if self.rt.is_coordinator:
                            log.info("stop_threshold %.4f reached (top1="
                                     "%.4f) -- stopping at epoch %d",
                                     cfg.stop_threshold, eval_output[1],
                                     epoch + 1)
                        break
                window_t0 = time.monotonic()
                window_skewed = True
        finally:
            # every exit -- the end, the stop_threshold break, a
            # watchdog's abort, a preemption -- closes an open trace
            profiler.stop()
        if (start_epoch >= self.train_epochs and not cfg.skip_eval
                and eval_iter_fn is not None):
            # resumed a fully trained checkpoint: still honour the eval
            with trace.span("eval", epoch=start_epoch, step=global_step):
                eval_output = self.evaluate(state, eval_iter_fn(),
                                            heartbeat=heartbeat)
        for cb in callbacks:
            _call(cb, "on_train_end", {"state": state, "history": history})
        log.info("train wall time: %.1fs (%d steps)", time.time() - t0,
                 global_step)
        trace.event("train_end", step=global_step, wall_s=time.time() - t0)
        ledger.emit_summary()
        trace.flush()
        stats = build_stats(history, eval_output, time_cb)
        stats["train_loss_log"] = list(self.loss_log)
        stats["window_step_s"] = list(self.window_step_s)
        stats["ledger"] = ledger.summary()
        if profiler.path:
            stats["profile_trace"] = profiler.path
        if eval_output is not None:
            stats["eval_count"] = self.eval_count
        return state, stats

    def _preempt_signal(self, pending) -> Optional[int]:
        """The signal to stop on at this step boundary, or None.  One
        process: its own latch.  Data parallelism: the previous step's
        all-reduced latch, which every rank reads alike (a rank that
        latched nothing itself stops for SIGTERM)."""
        if self.rt.group is None:
            return preemption.triggered()
        if pending is None or not float(pending):
            return None
        return preemption.triggered() or int(signal.SIGTERM)


def _parse_profile_steps(profile_steps: Optional[str]):
    """--profile_steps "start,stop" (the reference's common.py)."""
    if not profile_steps:
        return None
    parts = [p.strip() for p in str(profile_steps).split(",")]
    if len(parts) != 2:
        raise ValueError("profile_steps must be 'start,stop'")
    return int(parts[0]), int(parts[1])


class StepProfiler:
    """``--profile_steps "start,stop"``: ``torch.profiler`` (the CPU,
    and the card on CUDA) over the steps numbered start..stop, the JAX
    loop's contract: the trace starts before the first step at or past
    ``start`` -- a run resumed inside the range still traces the rest
    of it -- and stops once ``stop`` has run.  One Chrome trace a run,
    ``profile_rank{R}_steps{a}-{b}.json``, in ``--trace_dir`` (or the
    launcher's ``DTF_TRACE_DIR``) else ``--model_dir``, its path in a
    ``profiler_trace`` event and the run's stats."""

    def __init__(self, cfg, device: torch.device, rank: int = 0):
        self.range = _parse_profile_steps(cfg.profile_steps)
        self.directory = (cfg.trace_dir or os.environ.get("DTF_TRACE_DIR",
                                                          "")
                          or cfg.model_dir)
        if self.range and not self.directory:
            raise ValueError("--profile_steps writes its trace under "
                             "--trace_dir or --model_dir; set one")
        self.device, self.rank = device, rank
        self.path = ""
        self._prof = None
        self._first = None

    def before_step(self, step: int) -> None:
        if (self.range is None or self._first is not None
                or not self.range[0] <= step <= self.range[1]):
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._first = step
        trace.event("profiler_trace", path=self.directory, start_step=step,
                    stop_step=self.range[1])

    def after_step(self, step: int) -> None:
        if self._prof is not None and step > self.range[1]:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(
            self.directory, f"profile_rank{self.rank}_steps{self._first}-"
                            f"{self.range[1]}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        log.info("profiler trace of steps %d-%d: %s", self._first,
                 self.range[1], self.path)


def _call(cb, name, *args):
    fn = getattr(cb, name, None)
    if fn is not None:
        fn(*args)
