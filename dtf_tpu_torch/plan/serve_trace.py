"""Serving-workload reconstruction — recorded traces and synthetic
arrival processes as one replayable shape.

A copy of ``dtf_tpu/plan/serve_trace.py`` with its imports re-pointed:
records are read through the port's ``cli/trace_main.py``.

The capacity simulator (plan/serve_model.py) replays an ARRIVAL
PROCESS through an analytic fleet model; this module produces that
process two ways:

  parse_workload / workload_from_records — reconstruct per-request
      records from the JSONL streams a traced serving run wrote
      (``trace_router*.jsonl`` + per-replica ``trace_rank{K}.jsonl``,
      or a bare single-engine run's stream): arrival time, prompt and
      generated token counts, prefix-share depth, queue wait, outcome
      (complete / shed / deadline), redispatch count.  Requests are
      keyed by their distributed-trace id, so a failover (requeue +
      second dispatch) folds into ONE record, and the router + replica
      views of the same request merge instead of double-counting.
      Records without a trace id cannot be joined and are counted
      (``skipped_no_trace``), never guessed at; torn JSONL tails are
      already dropped by the trace reader.

  synthetic_workload — deterministic arrival generators for
      extrapolation beyond recorded load: Poisson, square-wave BURST
      (rate × burst_factor for 1/burst_factor of each period — same
      mean rate, bursty arrivals), and shared-prefix mixes (a fraction
      of requests share one of G group prompts, the prefix-affinity /
      page-sharing traffic shape).

Field semantics the simulator relies on:

  arrival_s      — seconds relative to the workload window start.
  decode_tokens  — tokens the request generated (parsed completes) or
                   its budget (synthetic; greedy runs to budget unless
                   EOS, so budget is the honest planning number).
  prefix_group   — shared-prefix identity for registry modeling
                   (synthetic mixes).  Parsed traces cannot recover
                   group identity from records, so they carry the
                   MEASURED share depth instead:
  prefix_tokens  — shareable leading tokens.  With a group, the
                   simulator's registry model decides hits; without
                   one (parsed traces), the recorded hit is replayed
                   as-is.
  queue_wait_s / latency_s — measured values (calibration's ground
                   truth); synthetic records carry 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from dtf_tpu_torch.obs.registry import percentile

#: per-request record names the parser consumes (anything else in the
#: stream — batch spans, ledger events, health records — is ignored)
_ROUTER_KINDS = ("router_submit", "router_dispatch", "router_requeue",
                 "router_complete", "router_shed", "router_deadline")
_ENGINE_KINDS = ("serve_submit", "serve_admit", "serve_retire",
                 "serve_shed")


@dataclasses.dataclass
class RequestRecord:
    """One serving request, as the simulator replays it."""

    trace_id: str
    arrival_s: float
    prompt_tokens: int
    decode_tokens: int
    prefix_group: Optional[str] = None
    prefix_tokens: int = 0
    outcome: str = "complete"        # complete | shed | deadline | incomplete
    queue_wait_s: float = 0.0
    latency_s: float = 0.0
    redispatches: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Workload:
    """An arrival process plus its observation window."""

    requests: List[RequestRecord]
    duration_s: float
    source: str
    skipped_no_trace: int = 0

    @property
    def rate_rps(self) -> float:
        return len(self.requests) / self.duration_s \
            if self.duration_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "source": self.source,
            "requests": len(self.requests),
            "duration_s": round(self.duration_s, 3),
            "rate_rps": round(self.rate_rps, 3),
            "skipped_no_trace": self.skipped_no_trace,
        }


def parse_workload(paths: Sequence[str]) -> Workload:
    """Workload from trace dirs / files (``trace_main`` discovery
    rules: per-rank streams plus named router streams)."""
    from dtf_tpu_torch.cli.trace_main import discover, merge_records
    merged = merge_records(discover(list(paths)))
    return workload_from_records(
        merged, source="trace:" + ",".join(str(p) for p in paths))


def workload_from_records(merged: List[dict],
                          source: str = "records") -> Workload:
    """Per-request reconstruction from a time-ordered merged record
    stream (``trace_main.merge_records`` output).

    Router lifecycle records own a request's identity when present
    (arrival/queue-wait/outcome from the tier front-end); the
    replica-side engine records fill what only the engine knows
    (prefix-share depth) and stand alone for router-less runs.  One
    record per trace id no matter how many failover attempts the
    stream recorded."""
    reqs: Dict[str, dict] = {}
    skipped = 0

    def entry(tid: str) -> dict:
        return reqs.setdefault(tid, {
            "arrival": None, "engine_arrival": None, "prompt": 0,
            "decode": 0, "outcome": "incomplete", "queue_wait": None,
            "engine_queue_wait": None, "latency": 0.0, "redispatches": 0,
            "prefix_tokens": 0, "has_router": False,
        })

    for rec in merged:
        name = rec.get("name")
        if name not in _ROUTER_KINDS and name not in _ENGINE_KINDS:
            continue
        tid = rec.get("trace")
        if not tid:
            # a per-request record that cannot be joined: counted, not
            # guessed (old traces, tracing enabled mid-run, ...)
            skipped += 1
            continue
        r = entry(str(tid))
        ts = float(rec.get("ts", 0.0))
        if name == "router_submit":
            r["has_router"] = True
            r["arrival"] = ts if r["arrival"] is None \
                else min(r["arrival"], ts)
            r["prompt"] = int(rec.get("prompt_len", r["prompt"]) or 0)
        elif name == "router_dispatch":
            r["has_router"] = True
            if r["queue_wait"] is None:
                # every dispatch record carries the latched
                # first-attempt wait (a failed attempt-1 send leaves
                # no attempt-1 record — the attempt-2 record still
                # has the right number); ts − arrival is the
                # older-trace fallback, valid only for attempt 1
                if rec.get("queue_wait_s") is not None:
                    r["queue_wait"] = float(rec["queue_wait_s"])
                elif (int(rec.get("attempt", 1)) == 1
                      and r["arrival"] is not None):
                    r["queue_wait"] = max(0.0, ts - r["arrival"])
        elif name == "router_requeue":
            r["has_router"] = True
            r["redispatches"] = max(r["redispatches"],
                                    int(rec.get("redispatches", 0) or 0))
        elif name == "router_complete":
            r["has_router"] = True
            r["outcome"] = "complete"
            r["decode"] = int(rec.get("tokens", 0) or 0)
            r["latency"] = float(rec.get("latency_s", 0.0) or 0.0)
        elif name == "router_shed":
            # admission sheds never reach router_submit — the anomaly
            # IS the arrival record
            r["has_router"] = True
            r["outcome"] = "shed"
            if r["arrival"] is None:
                r["arrival"] = ts
        elif name == "router_deadline":
            r["has_router"] = True
            r["outcome"] = "deadline"
            # the tokens it streamed before failing are real demand —
            # a replay that floors them to 1 under-loads the fleet
            r["decode"] = max(r["decode"],
                              int(rec.get("delivered", 0) or 0))
        elif name == "serve_submit":
            r["engine_arrival"] = ts if r["engine_arrival"] is None \
                else min(r["engine_arrival"], ts)
            if not r["prompt"]:
                r["prompt"] = int(rec.get("prompt_len", 0) or 0)
        elif name == "serve_admit":
            if rec.get("queue_wait_s") is not None:
                r["engine_queue_wait"] = float(rec["queue_wait_s"])
            if rec.get("shared_tokens"):
                # a failover's second admission may hit deeper (the
                # first attempt registered the prefix) — keep the max
                r["prefix_tokens"] = max(r["prefix_tokens"],
                                         int(rec["shared_tokens"]))
        elif name == "serve_retire":
            if not r["has_router"]:
                r["outcome"] = "complete"
                r["decode"] = int(rec.get("tokens", 0) or 0)
                r["latency"] = float(rec.get("latency_s", 0.0) or 0.0)
        elif name == "serve_shed":
            if not r["has_router"]:
                r["outcome"] = "shed"
                if r["engine_arrival"] is None:
                    r["engine_arrival"] = ts

    # resolve: router fields win where both tiers saw the request
    resolved = []
    t_end = 0.0
    for tid, r in reqs.items():
        arrival = r["arrival"] if r["arrival"] is not None \
            else r["engine_arrival"]
        if arrival is None:
            skipped += 1    # e.g. only a serve_admit survived a crash
            continue
        wait = r["queue_wait"] if r["has_router"] \
            and r["queue_wait"] is not None else r["engine_queue_wait"]
        resolved.append((arrival, RequestRecord(
            trace_id=tid, arrival_s=arrival,
            prompt_tokens=r["prompt"], decode_tokens=r["decode"],
            prefix_tokens=r["prefix_tokens"], outcome=r["outcome"],
            queue_wait_s=float(wait or 0.0), latency_s=r["latency"],
            redispatches=r["redispatches"])))
        t_end = max(t_end, arrival + r["latency"])
    resolved.sort(key=lambda ar: (ar[0], ar[1].trace_id))
    if not resolved:
        return Workload([], 0.0, source, skipped_no_trace=skipped)
    t0 = resolved[0][0]
    requests = []
    for arrival, req in resolved:
        req.arrival_s = arrival - t0
        requests.append(req)
    return Workload(requests, max(t_end - t0, 1e-9), source,
                    skipped_no_trace=skipped)


def measured_stats(workload: Workload) -> dict:
    """Ground-truth aggregates of a PARSED workload — what the
    simulator's prediction is calibrated against.  Throughput spans
    first arrival → last completion (the same window the prediction
    reports); percentiles cover completed requests only, sheds and
    deadline failures are rates."""
    completes = [r for r in workload.requests if r.outcome == "complete"]
    sheds = sum(1 for r in workload.requests if r.outcome == "shed")
    deadlined = sum(1 for r in workload.requests
                    if r.outcome == "deadline")
    total = len(workload.requests)
    out = {
        "requests": total, "completed": len(completes), "shed": sheds,
        "deadlined": deadlined,
        "shed_rate": sheds / total if total else 0.0,
        "deadline_rate": deadlined / total if total else 0.0,
        "tokens_per_s": 0.0, "latency_p50_s": 0.0, "latency_p99_s": 0.0,
        "queue_wait_p50_s": 0.0, "queue_wait_p99_s": 0.0,
    }
    if not completes:
        return out
    span = (max(r.arrival_s + r.latency_s for r in completes)
            - min(r.arrival_s for r in completes))
    tokens = sum(r.decode_tokens for r in completes)
    lat = sorted(r.latency_s for r in completes)
    wait = sorted(r.queue_wait_s for r in completes)
    out.update(
        tokens_per_s=tokens / span if span > 0 else 0.0,
        latency_p50_s=percentile(lat, 50.0),
        latency_p99_s=percentile(lat, 99.0),
        queue_wait_p50_s=percentile(wait, 50.0),
        queue_wait_p99_s=percentile(wait, 99.0))
    return out


# ---------------------------------------------------------------------------
# synthetic arrival generation
# ---------------------------------------------------------------------------

ARRIVAL_PROCESSES = ("poisson", "burst")


def synthetic_workload(*, rate_rps: float, duration_s: float,
                       seed: int = 0, process: str = "poisson",
                       burst_factor: float = 4.0,
                       burst_period_s: Optional[float] = None,
                       prompt_tokens=(8, 64), decode_tokens: int = 32,
                       shared_fraction: float = 0.0,
                       shared_groups: int = 2,
                       shared_prefix_tokens: int = 128) -> Workload:
    """Deterministic synthetic arrival process.

    ``poisson`` draws exponential inter-arrival gaps at ``rate_rps``.
    ``burst`` is the square-wave-modulated variant: each
    ``burst_period_s`` window (default duration/8) opens with arrivals
    at ``rate_rps × burst_factor`` for 1/burst_factor of the period and
    stays silent for the rest — the MEAN rate is unchanged, the peaks
    are what capacity must absorb.

    ``shared_fraction`` of requests carry one of ``shared_groups``
    group prompts: ``shared_prefix_tokens`` shareable leading tokens
    plus a per-request tail drawn from ``prompt_tokens``; the rest
    draw their whole prompt from ``prompt_tokens``.
    """
    import numpy as np

    if process not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {process!r}; have "
                         f"{ARRIVAL_PROCESSES}")
    if rate_rps <= 0 or duration_s <= 0:
        raise ValueError("rate_rps and duration_s must be positive")
    if not 0.0 <= shared_fraction <= 1.0:
        raise ValueError(f"shared_fraction must be in [0, 1], got "
                         f"{shared_fraction}")
    rng = np.random.default_rng(seed)
    lo, hi = int(prompt_tokens[0]), int(prompt_tokens[1])
    if lo < 1 or hi < lo:
        raise ValueError(f"prompt_tokens range ({lo}, {hi}) must be "
                         f"1 <= lo <= hi")
    period = float(burst_period_s or duration_s / 8.0)
    duty = 1.0 / max(burst_factor, 1.0)

    arrivals: List[float] = []
    t = 0.0
    while True:
        if process == "poisson":
            t += float(rng.exponential(1.0 / rate_rps))
        else:
            # burst: arrivals only inside the leading duty-window of
            # each period, at burst_factor × the mean rate
            t += float(rng.exponential(1.0 / (rate_rps * burst_factor)))
            phase = math.fmod(t, period)
            if phase > period * duty:
                # silent stretch: jump to the next period's window
                # start and REDRAW the gap from there (emitting at the
                # boundary itself would put a deterministic arrival at
                # every period start)
                t += period - phase
                if t >= duration_s:
                    break
                continue
        if t >= duration_s:
            break
        arrivals.append(t)

    requests: List[RequestRecord] = []
    for i, arr in enumerate(arrivals):
        group = None
        prefix = 0
        plen = int(rng.integers(lo, hi + 1))
        if shared_fraction > 0 and rng.random() < shared_fraction:
            group = f"g{int(rng.integers(shared_groups))}"
            prefix = int(shared_prefix_tokens)
            plen += prefix
        requests.append(RequestRecord(
            trace_id=f"syn{i:06d}", arrival_s=arr, prompt_tokens=plen,
            decode_tokens=int(decode_tokens), prefix_group=group,
            prefix_tokens=prefix))
    desc = (f"synthetic:{process},rate={rate_rps:g},dur={duration_s:g},"
            f"seed={seed}"
            + (f",shared={shared_fraction:g}/{shared_groups}"
               if shared_fraction else ""))
    return Workload(requests, float(duration_s), desc)


def scale_workload(workload: Workload, target_rps: float) -> Workload:
    """Time-compress/stretch a workload to a target mean arrival rate
    (request mix, ordering, and relative burstiness preserved — the
    honest way to ask 'this traffic shape at X req/s')."""
    if target_rps <= 0:
        raise ValueError(f"target_rps must be positive, got {target_rps}")
    cur = workload.rate_rps
    if not workload.requests or cur <= 0:
        return workload
    factor = cur / target_rps
    requests = [dataclasses.replace(r, arrival_s=r.arrival_s * factor)
                for r in workload.requests]
    return Workload(requests, workload.duration_s * factor,
                    f"{workload.source}→{target_rps:g}rps",
                    skipped_no_trace=workload.skipped_no_trace)
