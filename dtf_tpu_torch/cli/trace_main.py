"""Trace summarizer -- turn per-rank JSONL traces into a step report; a
copy of ``dtf_tpu/cli/trace_main.py`` over the port's trace files and
vocabulary (``obs/trace.py``, ``obs/vocab.py``).  The MFU ledger view
(``--ledger``) is not ported: the port has no ledger yet.

Reads the ``trace_rank*.jsonl`` files a traced run wrote (any
subsystem emitting through dtf_tpu_torch.obs.trace), and prints
per-span-name timing aggregates (count, total, mean, p50/p99, max),
event counts, and every anomaly record.

Usage:
  python -m dtf_tpu_torch.cli.trace_main <trace_dir | trace.jsonl> [...]
      [--check] [--allow <kind>]... [--json] [--merge]
      [--request <trace_id>]

``--request <trace_id>`` reconstructs ONE request's (or one run's)
cross-process timeline: every record whose ``trace`` is the id — or
whose batch-span ``traces`` list contains it — from every rank and
named stream, time-ordered with relative offsets.  The view that
answers "where did request X spend its time?": router queue wait →
dispatch → replica prefill chunks → decode steps → failover
re-dispatch → stream delivery → completion, each line rank-tagged.
Composes with ``--merge`` (emit the filtered records as raw JSONL
instead of the rendered timeline).  Exits 2 when the id appears in no
record.

``--merge`` emits ONE time-ordered cross-rank stream (JSONL on stdout)
instead of the aggregate table: every record from every
``trace_rank{N}.jsonl`` — and every NAMED stream like the serving
router's ``trace_router.jsonl`` — sorted by timestamp, rank-tagged
(named streams tag their name).  The view that answers "what was rank
2 doing when rank 0 stalled?" and "what did the router see when
replica 1 died?".  Spans sort by their START time (``ts``), so a long
span appears where it began, interleaved with what ran under it.
Composes with ``--check``.

``--check`` is the CI/bench contract: exit 0 only when the trace
contains NO anomaly records (nan_loss, step_time_regression, ...), so a
bench script can assert a run was clean with one command.

``--allow <kind>`` (repeatable) declares EXPECTED anomalies: a chaos
run asserts "the injected fault fired and nothing else broke" with
``--check --allow injected_fault``.  Allowed kinds are still printed
(flagged ALLOWED) but no longer fail the check; every anomaly of any
other kind still does.

``--json`` emits the summary as one JSON object instead of the table
(machine consumers).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import Counter as CCounter
from typing import Dict, List

from dtf_tpu_torch.obs.registry import Histogram
from dtf_tpu_torch.obs.trace import read_records
# the trace vocabulary is single-sourced in obs/vocab.py: this CLI's
# --allow typo check validates against it
from dtf_tpu_torch.obs.vocab import KNOWN_ANOMALY_KINDS, allowable_kinds


def discover(paths: List[str]) -> List[str]:
    """Expand directories to their trace files: per-rank
    ``trace_rank*.jsonl`` plus named streams (``trace_router*.jsonl``,
    the serving router's tier)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            found = sorted(
                glob.glob(os.path.join(p, "trace_rank*.jsonl"))
                + glob.glob(os.path.join(p, "trace_router*.jsonl")))
            if not found:
                raise FileNotFoundError(
                    f"no trace_rank*.jsonl files under {p!r}")
            files.extend(found)
        else:
            files.append(p)
    return files


def _rank_from_path(path: str):
    # the writer's naming contract, not "any digits": a rotated
    # trace_rank2.jsonl.1 or a v4_trace_rank2.jsonl prefix must still
    # resolve rank 2; named streams resolve to their name
    base = os.path.basename(path)
    m = re.search(r"trace_rank(\d+)", base)
    if m:
        return int(m.group(1))
    m = re.search(r"trace_([A-Za-z]\w*)", base)
    return m.group(1) if m else 0


def merge_records(files: List[str]) -> List[dict]:
    """All records from all per-rank files as one stream, sorted by
    timestamp (ties broken by rank for a stable order).  Every record
    is rank-tagged — the writer stamps ``rank``; records from an older
    trace without it inherit the rank from the filename."""
    merged: List[dict] = []
    for path in files:
        fallback = _rank_from_path(path)
        for rec in read_records(path):
            rec.setdefault("rank", fallback)
            merged.append(rec)
    # ties break by rank-as-string: int ranks and named streams
    # ("router") share one timeline
    merged.sort(key=lambda r: (float(r.get("ts", 0.0)),
                               str(r.get("rank", 0))))
    return merged


def request_records(merged: List[dict], trace_id: str) -> List[dict]:
    """The subset of a merged stream belonging to one trace id —
    records tagged directly (``trace``) or via a batch span's
    ``traces`` list (one decode step serves many requests)."""
    out = []
    for rec in merged:
        if rec.get("trace") == trace_id:
            out.append(rec)
        else:
            traces = rec.get("traces")
            if traces and trace_id in traces:
                out.append(rec)
    return out


#: timeline rendering: drop the plumbing keys, keep the payload
_TIMELINE_HIDE = ("kind", "name", "ts", "rank", "trace", "traces",
                  "dur_s", "span_id", "parent_span", "parent")


def print_request_timeline(trace_id: str, recs: List[dict]) -> None:
    """One request's cross-process life, time-ordered with offsets
    relative to its first record."""
    t0 = min(float(r.get("ts", 0.0)) for r in recs)
    t1 = max(float(r.get("ts", 0.0)) + float(r.get("dur_s", 0.0))
             for r in recs)
    ranks = sorted({str(r.get("rank", "?")) for r in recs})
    print(f"trace {trace_id}: {len(recs)} records across ranks "
          f"{ranks}, {t1 - t0:.3f}s end to end")
    for r in recs:
        rel = float(r.get("ts", 0.0)) - t0
        kind = r.get("kind", "?")
        name = r.get("name", "?")
        dur = (f" ({float(r['dur_s']) * 1e3:.1f}ms)"
               if kind == "span" and "dur_s" in r else "")
        detail = {k: v for k, v in r.items() if k not in _TIMELINE_HIDE}
        tag = "ANOMALY " if kind == "anomaly" else ""
        print(f"  +{rel:8.3f}s [{str(r.get('rank', '?')):>6}] "
              f"{tag}{name}{dur} {detail if detail else ''}")


def summarize(files: List[str]) -> dict:
    spans: Dict[str, Histogram] = {}
    events: CCounter = CCounter()
    anomalies: List[dict] = []
    ranks = set()
    steps = set()
    for path in files:
        for rec in read_records(path):
            ranks.add(rec.get("rank", 0))
            kind = rec.get("kind")
            if kind == "span":
                name = rec.get("name", "?")
                h = spans.get(name)
                if h is None:
                    h = spans[name] = Histogram(name, unit="s")
                h.observe(float(rec.get("dur_s", 0.0)))
                if name == "step" and "step" in rec:
                    steps.add((rec.get("rank", 0), rec["step"]))
            elif kind == "event":
                events[rec.get("name", "?")] += 1
            elif kind == "anomaly":
                anomalies.append(rec)
    span_rows = {}
    for name, h in sorted(spans.items()):
        s = h.snapshot()
        span_rows[name] = {
            "count": s["count"], "total_s": s["count"] * s["mean"],
            "mean_s": s["mean"], "p50_s": s["p50"], "p99_s": s["p99"],
            "max_s": s["max"],
        }
    return {
        "files": files,
        "ranks": sorted(ranks, key=str),
        "step_spans": len(steps) if steps else (
            span_rows.get("step", {}).get("count", 0)),
        "spans": span_rows,
        "events": dict(sorted(events.items())),
        "anomalies": anomalies,
    }


def print_summary(summary: dict, allowed=()) -> None:
    allowed = set(allowed)
    print(f"trace files: {len(summary['files'])}  "
          f"ranks: {summary['ranks']}  "
          f"step spans: {summary['step_spans']}")
    if summary["spans"]:
        hdr = (f"{'span':<24}{'count':>8}{'total_s':>10}{'mean_s':>10}"
               f"{'p50_s':>10}{'p99_s':>10}{'max_s':>10}")
        print(hdr)
        print("-" * len(hdr))
        for name, r in summary["spans"].items():
            print(f"{name:<24}{r['count']:>8}{r['total_s']:>10.3f}"
                  f"{r['mean_s']:>10.4f}{r['p50_s']:>10.4f}"
                  f"{r['p99_s']:>10.4f}{r['max_s']:>10.4f}")
    if summary["events"]:
        print("events: " + ", ".join(f"{k}×{v}"
                                     for k, v in summary["events"].items()))
    for a in summary["anomalies"]:
        detail = {k: v for k, v in a.items()
                  if k not in ("kind", "name", "ts")}
        tag = ("ALLOWED ANOMALY" if a.get("name") in allowed
               else "ANOMALY")
        print(f"{tag}: {a.get('name', '?')} {detail}")
    if not summary["anomalies"]:
        print("anomalies: none")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dtf_tpu_torch.cli.trace_main",
        description="Summarize dtf_tpu_torch JSONL traces.")
    ap.add_argument("paths", nargs="+",
                    help="trace dir(s) or trace_rank*.jsonl file(s)")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero when any anomaly record is present")
    ap.add_argument("--allow", action="append", default=[], metavar="KIND",
                    help="anomaly kind --check tolerates (repeatable): "
                         "chaos runs pass --allow injected_fault to "
                         "assert 'only the injected fault'")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a table")
    ap.add_argument("--merge", action="store_true",
                    help="emit one time-ordered cross-rank JSONL stream "
                         "(rank-tagged records) instead of the summary")
    ap.add_argument("--request", default="", metavar="TRACE_ID",
                    help="reconstruct one trace id's cross-process "
                         "timeline (with --merge: emit its records as "
                         "raw JSONL); exits 2 when the id is unknown")
    args = ap.parse_args(argv)

    files = discover(args.paths)
    allowed = set(args.allow)
    for kind in sorted(allowed - allowable_kinds()):
        # warn, don't fail: new subsystems may emit kinds this registry
        # hasn't learned — but a typo'd --allow silently tolerating
        # nothing is exactly the bug an expected-anomaly list invites
        print(f"warning: --allow {kind!r} is not a known anomaly kind "
              f"(known: {', '.join(KNOWN_ANOMALY_KINDS)})",
              file=sys.stderr)
    if args.request:
        merged = merge_records(files)
        recs = request_records(merged, args.request)
        if not recs:
            print(f"trace id {args.request!r} appears in no record "
                  f"under {args.paths}", file=sys.stderr)
            return 2
        if args.merge:
            for rec in recs:
                print(json.dumps(rec, default=str))
        else:
            print_request_timeline(args.request, recs)
        # --check still scans the WHOLE stream: a clean request inside
        # a dirty run is not a clean run
        anomalies = [r for r in merged if r.get("kind") == "anomaly"]
    elif args.merge:
        # one pass over the files: the merged stream also feeds the
        # --check anomaly scan (no summarize — the aggregate view is
        # never printed in merge mode)
        merged = merge_records(files)
        for rec in merged:
            print(json.dumps(rec, default=str))
        anomalies = [r for r in merged if r.get("kind") == "anomaly"]
    else:
        summary = summarize(files)
        if args.json:
            print(json.dumps(summary, indent=2, default=str))
        else:
            print_summary(summary, allowed=allowed)
        anomalies = summary["anomalies"]
    if args.check:
        blocked = [a for a in anomalies
                   if a.get("name") not in allowed]
        if blocked:
            tolerated = len(anomalies) - len(blocked)
            print(f"--check: {len(blocked)} anomaly record(s)"
                  + (f" ({tolerated} allowed)" if tolerated else "")
                  + " — run was NOT clean", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
