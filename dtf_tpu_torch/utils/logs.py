"""BenchmarkMetric lines and run-stats normalization -- a copy of
``dtf_tpu/utils/logs.py``.

  (a) ``TimeHistory`` -- every ``log_steps`` steps, a "BenchmarkMetric:
      {'global step':N, 'time_taken': ..., 'examples_per_second': ...}"
      line, plus each epoch's wall time.  It reads the host clock: the
      trainer synchronizes with the device before each log boundary, so
      the time is the device's, not the enqueue's.
  (b) ``build_stats`` -- the final dict a run returns: loss,
      training_accuracy_top_1, accuracy_top_1, eval_loss,
      step_timestamp_log, train_finish_time, avg_exp_per_second.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

log = logging.getLogger("dtf_tpu_torch")


class BatchTimestamp:
    """A (global step, wall time) pair of the step log."""

    def __init__(self, batch_index: int, timestamp: float):
        self.batch_index = batch_index
        self.timestamp = timestamp

    def __repr__(self):
        return (f"'BatchTimestamp<batch_index: {self.batch_index}, "
                f"timestamp: {self.timestamp}>'")


class TimeHistory:
    """Step/epoch timing with the reference's log cadence."""

    def __init__(self, batch_size: int, log_steps: int,
                 initial_global_step: int = 0):
        self.batch_size = batch_size      # global batch size
        self.log_steps = log_steps
        self.global_steps = initial_global_step
        self.timestamp_log = []
        self.train_finish_time: Optional[float] = None
        self._step_start: Optional[float] = None
        self._epoch_start: Optional[float] = None

    def on_train_begin(self, logs=None):
        pass

    def on_epoch_begin(self, epoch: int, logs=None):
        self._epoch_start = time.time()

    def on_batch_begin(self, batch: int, logs=None):
        self.global_steps += 1
        if self._step_start is None:
            # the first batch of this run
            self._step_start = time.time()
            self.timestamp_log.append(
                BatchTimestamp(self.global_steps, self._step_start))

    def on_batch_end(self, batch: int, logs=None):
        if self.global_steps % self.log_steps == 0:
            now = time.time()
            elapsed = now - self._step_start
            examples_per_second = (self.batch_size * self.log_steps) / elapsed
            self.timestamp_log.append(BatchTimestamp(self.global_steps, now))
            log.info(
                "BenchmarkMetric: {'global step':%d, 'time_taken': %f,"
                "'examples_per_second': %f}",
                self.global_steps, elapsed, examples_per_second)
            self._step_start = now

    def on_epoch_end(self, epoch: int, logs=None):
        epoch_run_time = time.time() - self._epoch_start
        log.info("BenchmarkMetric: {'epoch':%d, 'time_taken': %f}",
                 epoch, epoch_run_time)

    def on_train_end(self, logs=None):
        self.train_finish_time = time.time()


def build_stats(history: dict, eval_output,
                time_callback: Optional[TimeHistory]) -> dict:
    """Normalize final results, key for key with the reference's
    common.build_stats.  ``history`` is {'loss': [...],
    'categorical_accuracy' or 'sparse_categorical_accuracy': [...]};
    ``eval_output`` is (eval_loss, accuracy_top_1) or None."""
    stats: dict = {}
    if eval_output:
        if eval_output[1] is not None:  # --report_accuracy_metrics false
            stats["accuracy_top_1"] = float(eval_output[1])
        stats["eval_loss"] = float(eval_output[0])
    if history and history.get("loss"):
        stats["loss"] = float(history["loss"][-1])
        for key in ("categorical_accuracy", "sparse_categorical_accuracy"):
            if history.get(key):
                stats["training_accuracy_top_1"] = float(history[key][-1])
                break
    if time_callback is not None:
        timestamp_log = time_callback.timestamp_log
        stats["step_timestamp_log"] = timestamp_log
        stats["train_finish_time"] = time_callback.train_finish_time
        if len(timestamp_log) > 1:
            stats["avg_exp_per_second"] = (
                time_callback.batch_size * time_callback.log_steps *
                (len(timestamp_log) - 1) /
                (timestamp_log[-1].timestamp - timestamp_log[0].timestamp))
    return stats
