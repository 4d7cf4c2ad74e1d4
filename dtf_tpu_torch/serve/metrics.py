"""Serving metrics -- latency percentiles + throughput as BenchmarkMetric
records (``{"name", "value", "unit"}``, what utils/benchmark_logger
writes).  The PyTorch counterpart of ``dtf_tpu/serve/metrics.py``.

The percentiles are obs-registry Histogram snapshots.  The live
operational counters (queue depth, sheds, slot occupancy) are on
``ServeEngine.metrics``; this aggregate is the post-run view.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from dtf_tpu_torch.obs.registry import Histogram


@dataclasses.dataclass
class ServingStats:
    """Aggregate of one serving run (ServeEngine.completed)."""

    num_requests: int
    num_shed: int
    total_new_tokens: int
    wall_time_s: float
    tokens_per_s: float
    latency_p50_s: float
    latency_p90_s: float
    latency_p99_s: float
    ttft_p50_s: float                  # time to first token
    ttft_p99_s: float
    queue_wait_p50_s: float

    def to_metrics(self) -> List[dict]:
        """BenchmarkMetric-format records (name/value/unit)."""
        return [
            {"name": "serve_requests", "value": float(self.num_requests),
             "unit": "requests"},
            {"name": "serve_shed", "value": float(self.num_shed),
             "unit": "requests"},
            {"name": "serve_tokens_per_second",
             "value": self.tokens_per_s, "unit": "tokens/s"},
            {"name": "serve_latency_p50", "value": self.latency_p50_s,
             "unit": "s"},
            {"name": "serve_latency_p90", "value": self.latency_p90_s,
             "unit": "s"},
            {"name": "serve_latency_p99", "value": self.latency_p99_s,
             "unit": "s"},
            {"name": "serve_ttft_p50", "value": self.ttft_p50_s,
             "unit": "s"},
            {"name": "serve_ttft_p99", "value": self.ttft_p99_s,
             "unit": "s"},
            {"name": "serve_queue_wait_p50",
             "value": self.queue_wait_p50_s, "unit": "s"},
        ]


def collect_stats(results, shed_count: int = 0,
                  wall_time_s: Optional[float] = None) -> ServingStats:
    """Aggregate a list of ServeResult into :class:`ServingStats`.

    ``wall_time_s``: measured serving window; None derives it from the
    earliest submit to the latest finish (the results' absolute
    timestamps), which is exact for any traffic shape."""
    results = [r for r in results if not r.cancelled]
    if not results:
        return ServingStats(0, shed_count, 0, 0.0, 0.0,
                            0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    lat = Histogram("latency", unit="s")
    ttft = Histogram("ttft", unit="s")
    qw = Histogram("queue_wait", unit="s")
    for r in results:
        lat.observe(r.latency_s)
        ttft.observe(r.time_to_first_token_s)
        qw.observe(r.queue_wait_s)
    total_tokens = int(sum(len(r.tokens) for r in results))
    if wall_time_s is None:
        wall_time_s = (max(r.finish_time for r in results)
                       - min(r.submit_time for r in results))
    tps = total_tokens / wall_time_s if wall_time_s > 0 else 0.0
    return ServingStats(
        num_requests=len(results),
        num_shed=int(shed_count),
        total_new_tokens=total_tokens,
        wall_time_s=float(wall_time_s),
        tokens_per_s=float(tps),
        latency_p50_s=lat.percentile(50), latency_p90_s=lat.percentile(90),
        latency_p99_s=lat.percentile(99),
        ttft_p50_s=ttft.percentile(50), ttft_p99_s=ttft.percentile(99),
        queue_wait_p50_s=qw.percentile(50))
