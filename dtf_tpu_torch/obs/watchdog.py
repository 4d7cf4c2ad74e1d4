"""Anomaly watchdogs for the training loop + launcher heartbeat -- a
copy of ``dtf_tpu/obs/watchdog.py`` (the port imports nothing of
dtf_tpu).

Three detectors, all host-side and cadence-aligned with work the loop
already does (the NaN check reads the loss value the loop already
copies to the host at --log_steps cadence — no extra device sync is
ever introduced):

  NanLossWatchdog   — a non-finite loss is never recoverable for the
      run (dynamic loss *scaling* handles transient non-finite GRADS
      inside the step; a NaN LOSS that reached the host means
      the model state itself is poisoned).  The watchdog emits a
      structured ``nan_loss`` anomaly record, flushes the trace, and
      raises :class:`TrainingAnomaly` — a loud, attributable abort
      instead of a run that burns its remaining budget training on NaNs
      (the reference could only discover this grepping logs after the
      fact).

  StepTimeWatchdog  — flags a log-window whose wall time exceeds
      ``factor`` × the rolling median of recent windows: the signature
      of a degrading input pipeline, a thrashing host, or a slow
      straggler rank.  Reports (anomaly record + log line), does not
      abort — slowness is a page, not a poison.

  Heartbeat         — atomically rewrites a small JSON file
      (``heartbeat_rank{N}.json``) with {ts, step, pid} at a bounded
      interval.  The launcher supervisor consumes the file's content
      instead of scraping stdout log sizes — a rank that logs nothing
      for minutes (a kernel build) but beats is alive; a rank whose log
      grows from a chatty library thread while the training thread is
      deadlocked is NOT.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import time
from collections import deque
from typing import Optional

import logging

from dtf_tpu_torch.obs import trace

log = logging.getLogger("dtf_tpu_torch")

HEARTBEAT_DIR_ENV = "DTF_HEARTBEAT_DIR"


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"heartbeat_rank{rank}.json")


class TrainingAnomaly(RuntimeError):
    """Structured training abort.  ``record`` carries the same dict the
    tracer logged, so supervisors can consume the reason without
    parsing the message string."""

    def __init__(self, record: dict):
        self.record = dict(record)
        name = self.record.get("name", "anomaly")
        detail = {k: v for k, v in self.record.items()
                  if k not in ("kind", "name", "ts", "rank")}
        super().__init__(f"training anomaly: {name} {detail}")


class NanLossWatchdog:
    """Raise on the first non-finite loss that reaches the host."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def check(self, step: int, loss: float) -> None:
        if not self.enabled:
            return
        loss = float(loss)
        if math.isfinite(loss):
            return
        record = {"kind": "anomaly", "name": "nan_loss", "ts": time.time(),
                  "step": int(step), "loss": repr(loss)}
        trace.anomaly("nan_loss", step=int(step), loss=repr(loss))
        log.error("NaN watchdog: loss=%r at step %d — aborting the run "
                  "(a non-finite loss on the host means poisoned model "
                  "state, not a transient overflow)", loss, step)
        raise TrainingAnomaly(record)


class StepTimeWatchdog:
    """Rolling-median regression detector over per-window step times.

    ``observe(step, window_s)`` returns True (and emits an anomaly
    record) when ``window_s`` > factor × median of the last ``window``
    observations, once at least ``warmup`` baseline windows exist.  The
    triggering value is NOT added to the baseline — a genuine
    regression must keep triggering, not drag the median up until it
    looks normal."""

    def __init__(self, factor: float = 3.0, window: int = 32,
                 warmup: int = 5):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1.0, got {factor}")
        self.factor = float(factor)
        self.warmup = max(int(warmup), 1)
        self._history: deque = deque(maxlen=max(int(window), self.warmup))
        self.trigger_count = 0

    def observe(self, step: int, window_s: float) -> bool:
        window_s = float(window_s)
        if len(self._history) >= self.warmup:
            median = statistics.median(self._history)
            if median > 0 and window_s > self.factor * median:
                self.trigger_count += 1
                trace.anomaly("step_time_regression", step=int(step),
                              window_s=window_s, median_s=median,
                              factor=self.factor)
                log.warning(
                    "step-time watchdog: window ending at step %d took "
                    "%.3fs vs rolling median %.3fs (>%gx) — input "
                    "pipeline stall, host thrash, or straggler rank",
                    step, window_s, median, self.factor)
                return True
        self._history.append(window_s)
        return False


class ReaderLagWatchdog:
    """Report-only input-stall detector over per-batch reader lag.

    The data service (``dtf_tpu/data/service`` in the JAX package; not
    ported yet) reports how long the
    consumer blocked waiting for each merged batch; this watchdog flags
    a lag exceeding ``factor`` × the rolling median of recent batches —
    AND an absolute floor ``min_lag_s``, so microsecond-scale jitter on
    a well-fed pipeline can never page — with a structured
    ``reader_lag`` anomaly.  Reports, never aborts: a starving device
    is a provisioning problem (add input workers/cores), not a poisoned
    run.  Same shape as StepTimeWatchdog: the triggering value is not
    added to the baseline, so a genuine stall keeps triggering."""

    def __init__(self, factor: float = 10.0, min_lag_s: float = 0.5,
                 window: int = 64, warmup: int = 8):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1.0, got {factor}")
        self.factor = float(factor)
        self.min_lag_s = float(min_lag_s)
        self.warmup = max(int(warmup), 1)
        self._history: deque = deque(maxlen=max(int(window), self.warmup))
        self.trigger_count = 0

    def observe(self, batch: int, lag_s: float) -> bool:
        lag_s = float(lag_s)
        if len(self._history) >= self.warmup and lag_s > self.min_lag_s:
            median = statistics.median(self._history)
            if lag_s > self.factor * max(median, 1e-9):
                self.trigger_count += 1
                trace.anomaly("reader_lag", batch=int(batch),
                              lag_s=lag_s, median_s=median,
                              factor=self.factor)
                log.warning(
                    "reader-lag watchdog: batch %d waited %.3fs on the "
                    "input pipeline vs rolling median %.4fs (>%gx) — "
                    "the device is input-starved; add data-service "
                    "workers or host cores", batch, lag_s, median,
                    self.factor)
                return True
        self._history.append(lag_s)
        return False


class Heartbeat:
    """Liveness file the launcher supervisor watches.

    ``beat()`` is safe to call every step: it reads one monotonic clock
    and returns unless ``interval_s`` elapsed, then atomically rewrites
    the file (tmp + rename — the supervisor never sees a torn JSON)."""

    def __init__(self, path: str, interval_s: float = 5.0):
        self.path = os.path.abspath(path)
        self.interval_s = float(interval_s)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._last = 0.0
        self.beat(step=None, force=True)

    @classmethod
    def from_env(cls, rank: Optional[int] = None,
                 interval_s: float = 5.0) -> Optional["Heartbeat"]:
        """The launcher exports DTF_HEARTBEAT_DIR to every rank; a run
        started any other way gets None (no file, no cost)."""
        directory = os.environ.get(HEARTBEAT_DIR_ENV, "")
        if not directory:
            return None
        if rank is None:
            rank = int(os.environ.get("DTF_PROCESS_ID", "0"))
        return cls(heartbeat_path(directory, rank), interval_s=interval_s)

    def beat(self, step: Optional[int] = None, force: bool = False) -> bool:
        now = time.monotonic()
        if not force and now - self._last < self.interval_s:
            return False
        # chaos heartbeat_stall@step:N: silently stop writing from step
        # N on — the deadlocked-but-alive signature the supervisor's
        # heartbeat watchdog must catch.  Lazy import, as chaos imports
        # obs.trace lazily in turn.
        from dtf_tpu_torch import chaos
        if chaos.heartbeat_stalled(step):
            return False
        self._last = now
        payload = {"ts": time.time(), "step": step, "pid": os.getpid()}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError as e:
            # never crash training over liveness reporting — but be
            # loud: once a rank has beaten, the supervisor trusts ONLY
            # heartbeats (log growth stops counting, by design — the
            # chatty-deadlock case), so persistent write failures here
            # (ENOSPC, deleted log_dir) will get this rank killed after
            # heartbeat_timeout
            log.warning("heartbeat write failed (%s) — if this persists "
                        "the supervisor will judge this rank dead in "
                        "~heartbeat_timeout", e)
            return False
        trace.event("heartbeat", step=step)
        return True


def read_heartbeat(path: str) -> Optional[dict]:
    """Parse a heartbeat file; None when missing/torn (the supervisor
    treats that as 'no heartbeat signal', not as death)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
