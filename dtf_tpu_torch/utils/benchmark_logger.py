"""Benchmark run/metric file logging -- the PyTorch counterpart of
``dtf_tpu/utils/benchmark_logger.py``.

Writes two files under ``--benchmark_log_dir``:

  benchmark_run.log -- one JSON object of run metadata (model, dataset,
      run parameters, machine info, run date, test id)
  metric.log        -- one JSON line per recorded metric:
      {"name", "value", "unit", "global_step", "timestamp", "extras"}

The machine info names the device the run used (``torch.device``), so a
CPU run is never filed under the card's name.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Optional

import torch

log = logging.getLogger("dtf_tpu_torch")

_RUN_FILE = "benchmark_run.log"
_METRIC_FILE = "metric.log"


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ")


def machine_config(device: torch.device) -> dict:
    """Platform, device kind and count of the device a run used."""
    if device.type == "cuda":
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(device),
                "device_count": torch.cuda.device_count()}
    return {"platform": "cpu", "device_kind": "cpu", "device_count": 1}


class BenchmarkFileLogger:
    """Writes benchmark_run.log + metric.log under ``log_dir``."""

    def __init__(self, log_dir: str):
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self._metric_path = os.path.join(self.log_dir, _METRIC_FILE)

    def log_run_info(self, model_name: str, dataset_name: str,
                     run_params: dict, device: torch.device,
                     test_id: str = "") -> None:
        info = {
            "model_name": model_name,
            "dataset": {"name": dataset_name},
            "machine_config": machine_config(device),
            "run_date": _utcnow(),
            "torch_version": {"version": torch.__version__,
                              "cuda": torch.version.cuda},
            "run_parameters": _jsonable(run_params),
            "test_id": test_id or None,
        }
        with open(os.path.join(self.log_dir, _RUN_FILE), "w") as f:
            json.dump(info, f, indent=2)
            f.write("\n")

    def log_metric(self, name: str, value, unit: Optional[str] = None,
                   global_step: Optional[int] = None,
                   extras: Optional[dict] = None) -> None:
        try:
            value = float(value)
        except (TypeError, ValueError):
            log.warning("benchmark metric %r has non-numeric value %r -- "
                        "skipped", name, value)
            return
        record = {
            "name": name,
            "value": value,
            "unit": unit,
            "global_step": global_step,
            "timestamp": _utcnow(),
            "extras": [{"name": k, "value": str(v)}
                       for k, v in (extras or {}).items()],
        }
        with open(self._metric_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_serving_stats(self, serving_stats) -> None:
        """Record a serving run (serve.metrics.ServingStats), one line
        per latency/throughput metric."""
        for rec in serving_stats.to_metrics():
            self.log_metric(rec["name"], rec["value"], unit=rec["unit"])

    def log_registry(self, registry,
                     global_step: Optional[int] = None) -> None:
        """Record an obs MetricsRegistry: counters/gauges as themselves,
        histograms expanded to percentile scalars."""
        for rec in registry.to_benchmark_metrics():
            self.log_metric(rec["name"], rec["value"], unit=rec["unit"],
                            global_step=global_step)


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {k: _jsonable(v) for k, v in obj.items()}
        return str(obj)
