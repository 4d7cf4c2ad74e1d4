"""Serving-capacity planner CLI — replay, rank, and calibrate fleet
configs (the serving sibling of plan_main); the PyTorch counterpart of
``dtf_tpu/cli/plan_serve_main.py``.  The what-ifs are the JAX package's
code over the port's copies of the simulator; the calibration's live
run is the port's ``ServeEngine`` on ``--device`` (default ``cuda``),
and ``--measure_tp_comm``'s tp=2 run serves through ``serve_tp`` 2
(``serve/bridge.py``: one shard a card, or both shards on the run's one
device when the host has fewer cards).

Answer capacity what-ifs from a RECORDED trace (a traced bench_serve /
router run — ``--trace`` accepts the trace dir; service times come
from the run's own ledger/span records):

  python -m dtf_tpu_torch.cli.plan_serve_main --trace /tmp/run_trace \
      --target_rps 40 --slo_p99 2.0            # replicas needed
  python -m dtf_tpu_torch.cli.plan_serve_main --trace /tmp/run_trace \
      --chips 8                                # TP vs replicas split
  python -m dtf_tpu_torch.cli.plan_serve_main --trace /tmp/run_trace \
      --pool_sweep 32,64,128,256               # pool size vs shed rate

or from a SYNTHETIC arrival process (extrapolation beyond recorded
load; service times then come from ``--decode_step_ms`` /
``--prefill_chunk_ms`` or a ``--trace`` given purely as the profile
source):

  python -m dtf_tpu_torch.cli.plan_serve_main --rate 80 --duration 60 \
      --process burst --decode_step_ms 12 --prefill_chunk_ms 9 \
      --chips 16

Calibration: record a LIVE traced engine run, reconstruct the workload and
service profile from that trace alone, replay it through the
simulator, and compare predicted tokens/s and p99 latency against the
measured run — gauges (plan_serve_tokens_ratio, plan_serve_p99_ratio)
land in the obs registry (exported to metric.log with
``--benchmark_log_dir``), and the exit is nonzero outside
``--calibrate_tolerance`` (default 2×):

  python -m dtf_tpu_torch.cli.plan_serve_main --calibrate
  python -m dtf_tpu_torch.cli.plan_serve_main --calibrate --device cpu

``--out FILE`` writes everything the run computed (workload summary,
profile, predictions, what-if answers) as one JSON artifact.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import tempfile
import time

log = logging.getLogger("dtf_tpu_torch")


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dtf_tpu_torch.cli.plan_serve_main",
        description="Trace-driven serving-capacity simulator: replay "
                    "recorded or synthetic traffic through an analytic "
                    "fleet model; rank configs; calibrate vs a live run.")
    # workload
    ap.add_argument("--trace", nargs="*", default=[],
                    help="trace dir(s)/file(s) of a recorded serving "
                         "run (workload + service profile source)")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="synthetic arrival rate, req/s")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="synthetic window, seconds")
    ap.add_argument("--process", default="poisson",
                    choices=("poisson", "burst"))
    ap.add_argument("--burst_factor", type=float, default=4.0)
    ap.add_argument("--prompt_tokens", default="8:64",
                    help="synthetic prompt-length range lo:hi")
    ap.add_argument("--decode_tokens", type=int, default=32)
    ap.add_argument("--shared_fraction", type=float, default=0.0)
    ap.add_argument("--shared_groups", type=int, default=2)
    ap.add_argument("--shared_prefix_tokens", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    # service profile (overrides; required when no --trace carries them)
    ap.add_argument("--decode_step_ms", type=float, default=0.0,
                    help="decode-step service time (overrides the "
                         "trace's measured median)")
    ap.add_argument("--prefill_chunk_ms", type=float, default=0.0)
    ap.add_argument("--chunk_tokens", type=int, default=0)
    ap.add_argument("--page_size", type=int, default=16)
    ap.add_argument("--tp_comm_frac", type=float, default=0.15,
                    help="non-scaling fraction of a step under TP "
                         "(Amdahl split; documented default)")
    # fleet base config
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--pool_pages", type=int, default=128,
                    help="usable KV pages per replica at tp=1")
    ap.add_argument("--queue_size", type=int, default=64)
    ap.add_argument("--admission_limit", type=int, default=128)
    ap.add_argument("--deadline_s", type=float, default=120.0)
    ap.add_argument("--replica_inflight", type=int, default=16)
    ap.add_argument("--placement", default="affinity",
                    choices=("affinity", "least_loaded"))
    # what-ifs
    ap.add_argument("--target_rps", type=float, default=0.0,
                    help="with --slo_p99: replicas needed for this rate")
    ap.add_argument("--slo_p99", type=float, default=0.0,
                    help="p99 latency SLO, seconds")
    ap.add_argument("--max_replicas", type=int, default=64)
    ap.add_argument("--chips", type=int, default=0,
                    help="rank tp × replicas splits of this chip budget")
    ap.add_argument("--pool_sweep", default="",
                    help="comma-separated usable pool sizes to sweep "
                         "against shed rate")
    ap.add_argument("--loss_bar", type=float, default=0.01,
                    help="max shed+deadline fraction a config may lose")
    ap.add_argument("--chip_cost_per_hour", type=float, default=0.0,
                    help="with --chips and --slo_p99: rank the tp × "
                         "replicas splits by $/Mtoken AT the SLO "
                         "(fleet rate = chips × this, throughput from "
                         "the simulator); 0 = off")
    ap.add_argument("--pool_split", action="store_true",
                    help="with --chips: rank prefill:decode replica "
                         "splits against colocated — the decode pool "
                         "pays KV-page migration over the wire "
                         "instead of prefill (see --migrate_*)")
    ap.add_argument("--migrate_page_bytes", type=int, default=1 << 20,
                    help="wire bytes per migrated KV page")
    ap.add_argument("--migrate_wire_gbps", type=float, default=10.0,
                    help="fabric bandwidth for KV-page migration, "
                         "decimal Gbit/s")
    ap.add_argument("--migrate_latency_ms", type=float, default=2.0,
                    help="per-window round-trip latency of the "
                         "page_fetch migration protocol, ms")
    # calibration
    ap.add_argument("--calibrate", action="store_true",
                    help="record a live traced engine run, replay it, "
                         "compare predicted vs measured (nonzero exit "
                         "outside the tolerance)")
    ap.add_argument("--measure_tp_comm", action="store_true",
                    help="measure tp_comm_frac from two live traced "
                         "runs (tp=1 vs serve_tp=2) instead of trusting "
                         "the "
                         "--tp_comm_frac default; exports the "
                         "plan_serve_tp_comm_frac gauge and feeds the "
                         "measured value to every what-if in this run")
    ap.add_argument("--calibrate_tolerance", type=float, default=2.0)
    ap.add_argument("--calibrate_requests", type=int, default=12)
    ap.add_argument("--calibrate_budget", type=int, default=24,
                    help="max_new_tokens per calibration request")
    ap.add_argument("--model", default="transformer_small",
                    help="calibration model (registry name)")
    ap.add_argument("--seq", type=int, default=128,
                    help="calibration engine max_seq_len")
    ap.add_argument("--calibrate_slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="the calibration engine's device (cuda | cpu)")
    ap.add_argument("--benchmark_log_dir", default="",
                    help="export the calibration gauges to metric.log "
                         "here (BenchmarkFileLogger.log_registry)")
    ap.add_argument("--out", default="",
                    help="write the full result artifact (JSON)")
    return ap


def _profile_overrides(args) -> dict:
    over = {"page_size": int(args.page_size),
            "tp_comm_frac": float(args.tp_comm_frac)}
    if args.decode_step_ms > 0:
        over["decode_step_s"] = args.decode_step_ms / 1e3
    if args.prefill_chunk_ms > 0:
        over["prefill_chunk_s"] = args.prefill_chunk_ms / 1e3
    if args.chunk_tokens > 0:
        over["chunk_tokens"] = int(args.chunk_tokens)
    return over


def _fleet_config(args):
    from dtf_tpu_torch.plan.serve_model import FleetConfig
    return FleetConfig(
        replicas=args.replicas, tp=args.tp, slots=args.slots,
        pool_pages=args.pool_pages, queue_size=args.queue_size,
        admission_limit=args.admission_limit, deadline_s=args.deadline_s,
        replica_inflight=args.replica_inflight, placement=args.placement)


def _fmt_pred(pred) -> str:
    return (f"{pred.tokens_per_s:8.1f} tok/s  "
            f"p50 {pred.latency_p50_s * 1e3:7.1f} ms  "
            f"p99 {pred.latency_p99_s * 1e3:7.1f} ms  "
            f"loss {pred.loss_rate:5.1%}  "
            f"util {pred.replica_utilization:5.1%}")


def _whatifs(args, workload, profile, base, artifact) -> None:
    """The three documented capacity questions, each gated on its own
    flags; results printed and folded into the artifact."""
    from dtf_tpu_torch.plan import serve_model as sm

    if args.target_rps > 0 and args.slo_p99 > 0:
        n, evaluated = sm.replicas_for(
            workload, profile, base, args.target_rps, args.slo_p99,
            max_replicas=args.max_replicas, loss_bar=args.loss_bar)
        print(f"\nwhat-if: replicas for {args.target_rps:g} req/s at "
              f"p99 <= {args.slo_p99:g}s (loss <= {args.loss_bar:.0%})")
        for r, pred in evaluated:
            mark = " <-- first to meet the SLO" if r == n else ""
            print(f"  {r:>3} replica(s): {_fmt_pred(pred)}{mark}")
        if n is None:
            print(f"  NO config up to {args.max_replicas} replicas "
                  f"meets the SLO — the workload needs a different "
                  f"lever (TP, pool, chunking)")
        artifact["replicas_for"] = {
            "target_rps": args.target_rps, "slo_p99_s": args.slo_p99,
            "answer": n,
            "evaluated": [{"replicas": r, **p.to_dict()}
                          for r, p in evaluated]}

    tp_ranked = None
    if args.chips > 0:
        ranked = sm.rank_tp_vs_replicas(workload, profile, base,
                                        args.chips,
                                        loss_bar=args.loss_bar)
        tp_ranked = ranked
        print(f"\nwhat-if: tp × replicas at {args.chips} chips")
        for i, (cfg, pred) in enumerate(ranked, start=1):
            print(f"  #{i} {cfg.describe():<40} {_fmt_pred(pred)}")
        artifact["tp_vs_replicas"] = {
            "chips": args.chips,
            "ranked": [{"config": c.to_dict(), **p.to_dict()}
                       for c, p in ranked]}

    if args.chip_cost_per_hour > 0:
        if not (args.chips > 0 and args.slo_p99 > 0):
            raise SystemExit(
                "--chip_cost_per_hour needs --chips (the budget to "
                "split) and --slo_p99 (the SLO the $/token ranking "
                "holds configs to)")
        # reuse the tp × replicas simulations above — same splits,
        # no second trace replay
        rows = sm.rank_cost_per_token(
            workload, profile, base, args.chips,
            args.chip_cost_per_hour, args.slo_p99,
            loss_bar=args.loss_bar, evaluated=tp_ranked)
        print(f"\nwhat-if: $/Mtoken at {args.chips} chips × "
              f"${args.chip_cost_per_hour:g}/chip-hr, p99 <= "
              f"{args.slo_p99:g}s")
        for i, row in enumerate(rows, start=1):
            verdict = ("ok" if row.meets_slo else "MISSES SLO")
            cost = ("inf" if row.usd_per_mtoken == float("inf")
                    else f"{row.usd_per_mtoken:8.2f}")
            print(f"  #{i} {row.config.describe():<40} "
                  f"${cost}/Mtok  {_fmt_pred(row.prediction)}  "
                  f"[{verdict}]")
        artifact["cost_per_token"] = {
            "chips": args.chips,
            "chip_cost_per_hour": args.chip_cost_per_hour,
            "slo_p99_s": args.slo_p99,
            "ranked": [r.to_dict() for r in rows]}

    if args.pool_split:
        if not args.chips > 0:
            raise SystemExit("--pool_split needs --chips (the budget "
                             "the prefill:decode split carves up)")
        best, rows = sm.pool_split(
            workload, profile, base, args.chips,
            page_bytes=args.migrate_page_bytes,
            wire_gbps=args.migrate_wire_gbps,
            wire_latency_s=args.migrate_latency_ms / 1e3,
            loss_bar=args.loss_bar)
        print(f"\nwhat-if: prefill:decode split at {args.chips} chips "
              f"(page {args.migrate_page_bytes}B over "
              f"{args.migrate_wire_gbps:g} Gbit/s + "
              f"{args.migrate_latency_ms:g} ms/window)")
        for row in rows:
            mark = ""
            if best is not None and row is best:
                mark = " <-- best split (beats colocated p99)"
            pre = ("" if row.prefill is None
                   else f"  [prefill pool: {_fmt_pred(row.prefill)}]")
            print(f"  {row.describe():<24} {_fmt_pred(row.decode)}"
                  f"{mark}{pre}")
        if best is None:
            print("  colocated wins at this budget — migration wire "
                  "cost eats the split's head-of-line win")
        artifact["pool_split"] = {
            "chips": args.chips,
            "page_bytes": args.migrate_page_bytes,
            "wire_gbps": args.migrate_wire_gbps,
            "wire_latency_s": args.migrate_latency_ms / 1e3,
            "answer": (best.to_dict() if best is not None else None),
            "rows": [r.to_dict() for r in rows]}

    if args.pool_sweep:
        sizes = [int(s) for s in args.pool_sweep.split(",") if s.strip()]
        best, rows = sm.pool_vs_shed(workload, profile, base, sizes,
                                     loss_bar=args.loss_bar)
        print(f"\nwhat-if: page-pool size vs shed rate "
              f"(loss bar {args.loss_bar:.0%})")
        for pages, pred in rows:
            mark = " <-- smallest under the bar" if pages == best else ""
            print(f"  {pages:>6} pages: {_fmt_pred(pred)}{mark}")
        if best is None:
            print("  NO swept pool size stays under the loss bar")
        artifact["pool_vs_shed"] = {
            "sizes": sizes, "answer": best,
            "rows": [{"pool_pages": pg, **p.to_dict()}
                     for pg, p in rows]}


# ---------------------------------------------------------------------------
# calibration: record a live run, replay it, compare
# ---------------------------------------------------------------------------

def _record_calibration_run(args, trace_dir: str, *, tp: int = 1
                            ) -> dict:
    """A short traced in-process engine run on ``args.device`` — the
    measured side of the calibration.  Returns the engine geometry the
    simulator must mirror.  Prompts are sized to ONE chunk shape so
    warmup loads every kernel route the measured burst runs.  ``tp`` >
    1 serves the same burst tensor-parallel (``serve_tp``; the
    --measure_tp_comm pair): one shard a card, or every shard on the
    run's device when the host has fewer cards."""
    import numpy as np
    import torch

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.obs import trace
    from dtf_tpu_torch.runtime.device import resolve_device
    from dtf_tpu_torch.serve import bridge
    from dtf_tpu_torch.serve.engine import ServeEngine

    ps = int(args.page_size)
    chunk = int(args.chunk_tokens) if args.chunk_tokens > 0 else 4 * ps
    slots = int(args.calibrate_slots)
    budget = int(args.calibrate_budget)
    # pool sized to the contiguous-equivalent reservation: calibration
    # measures the MODEL, not page starvation (pool what-ifs are the
    # simulator's job once calibrated)
    pool_usable = slots * (-(-int(args.seq) // ps))
    dev = resolve_device(args.device)
    devices = [dev]
    if tp > 1:
        devices = (bridge.serving_devices(tp, device=dev)
                   if dev.type == "cuda" and torch.cuda.device_count() >= tp
                   else [dev] * tp)
    trace.configure(trace_dir, rank=0)
    model, _ = build_model(args.model, dtype=torch.bfloat16)
    bridge.random_init(model, 0)
    model = bridge.place_for_serving(model, devices, tp).eval()
    eng = ServeEngine(model, max_batch=slots,
                      max_seq_len=int(args.seq), max_delay_s=0.0,
                      queue_size=max(64, 4 * args.calibrate_requests),
                      kv_page_size=ps, kv_pool_pages=pool_usable + 1,
                      prefill_chunk=chunk)
    rng = np.random.default_rng(args.seed)

    def prompt():
        return rng.integers(0, model.vocab_size,
                            (int(rng.integers(4, ps + 1)),)).astype(
            np.int32)

    # warmup: the (single) prefill-chunk shape + decode step — the
    # parsed workload drops these two requests below
    warm = [eng.submit(prompt(), max_new_tokens=2) for _ in range(2)]
    for h in warm:
        h.result(timeout=600)
    # measured burst: half up front, the rest trickling in — queueing
    # AND steady-state decode both appear in the record
    handles = []
    n = int(args.calibrate_requests)
    for i in range(n):
        handles.append(eng.submit(prompt(), max_new_tokens=budget))
        if i >= n // 2:
            time.sleep(0.05)
    for h in handles:
        h.result(timeout=600)
    eng.stop()          # flushes the ledger summary into the trace
    trace.flush()
    trace.disable()     # close the file so the parser reads it all
    return {"slots": slots, "pool_usable": pool_usable, "page_size": ps,
            "chunk_tokens": chunk, "queue_size": max(
                64, 4 * args.calibrate_requests),
            "warmup_requests": 2}


def _measure_tp_comm(args, artifact) -> float:
    """Satellite of the Amdahl TP model: measure ``tp_comm_frac``
    instead of trusting the documented 0.15 default.  Two identical
    traced bursts — tp=1 and tp=2 — give two median decode-step times;
    the Amdahl split solves for the non-scaling fraction
    (:func:`~dtf_tpu_torch.plan.serve_model.measured_tp_comm_frac`).  The
    result lands in the ``plan_serve_tp_comm_frac`` gauge and replaces
    ``--tp_comm_frac`` for every what-if in this run."""
    import dtf_tpu_torch.plan.serve_model as sm
    from dtf_tpu_torch.cli.trace_main import discover, merge_records
    from dtf_tpu_torch.obs.registry import default_registry, percentile

    medians = {}
    for tp in (1, 2):
        with tempfile.TemporaryDirectory(
                prefix=f"dtf_tpcomm{tp}_") as tmp:
            _record_calibration_run(args, tmp, tp=tp)
            merged = merge_records(discover([tmp]))
        durs = sorted(float(r.get("dur_s", 0.0)) for r in merged
                      if r.get("kind") == "span"
                      and r.get("name") == "serve_decode")
        # drop the warm-up-tainted head the same way from_records
        # does: medians, not means
        if not durs:
            raise SystemExit(f"measure_tp_comm: the tp={tp} run traced "
                             f"no serve_decode spans — nothing to "
                             f"solve the Amdahl split from")
        medians[tp] = percentile(durs, 50.0)
    frac = sm.measured_tp_comm_frac(medians[1], medians[2])
    default_registry().gauge("plan_serve_tp_comm_frac").set(frac)
    print(f"measured tp_comm_frac: {frac:.3f}  (decode step "
          f"{medians[1] * 1e3:.2f} ms @ tp=1 -> "
          f"{medians[2] * 1e3:.2f} ms @ tp=2; "
          f"--tp_comm_frac {args.tp_comm_frac:g} overridden)")
    artifact["tp_comm_measurement"] = {
        "decode_step_s_tp1": medians[1],
        "decode_step_s_tp2": medians[2],
        "tp_comm_frac": frac,
        "default_overridden": float(args.tp_comm_frac)}
    return frac


def _calibrate(args, artifact) -> int:
    import dtf_tpu_torch.plan.serve_model as sm
    from dtf_tpu_torch.obs.registry import default_registry
    from dtf_tpu_torch.plan.serve_trace import (Workload, measured_stats,
                                          parse_workload)

    with tempfile.TemporaryDirectory(prefix="dtf_plan_serve_") as tmp:
        geom = _record_calibration_run(args, tmp)
        workload = parse_workload([tmp])
        from dtf_tpu_torch.cli.trace_main import discover, merge_records
        merged = merge_records(discover([tmp]))
    # drop the warmup requests (their latency is kernel loading and
    # first-call set-up, not serving) and rebase the window to the
    # measured burst
    reqs = workload.requests[geom["warmup_requests"]:]
    if not reqs:
        print("calibrate: the recorded run produced no measurable "
              "requests", file=sys.stderr)
        return 1
    t0 = min(r.arrival_s for r in reqs)
    reqs = [dataclasses.replace(r, arrival_s=r.arrival_s - t0)
            for r in reqs]
    workload = Workload(
        reqs, max(r.arrival_s + r.latency_s for r in reqs) + 1e-9,
        workload.source, workload.skipped_no_trace)

    profile = sm.ServeProfile.from_records(
        merged, page_size=geom["page_size"],
        chunk_tokens=geom["chunk_tokens"],
        tp_comm_frac=float(args.tp_comm_frac))
    config = sm.FleetConfig(
        replicas=1, tp=1, slots=geom["slots"],
        pool_pages=geom["pool_usable"], queue_size=geom["queue_size"],
        admission_limit=max(128, 4 * len(reqs)),
        deadline_s=600.0, replica_inflight=max(64, 4 * len(reqs)),
        placement="least_loaded")
    measured = measured_stats(workload)
    pred = sm.simulate(workload, profile, config)
    ratios = sm.calibration_ratios(measured, pred)

    print(f"calibration ({len(reqs)} measured requests, decode step "
          f"{profile.decode_step_s * 1e3:.2f} ms, chunk "
          f"{profile.prefill_chunk_s * 1e3:.2f} ms):")
    print(f"  tokens/s: predicted {pred.tokens_per_s:.1f}, measured "
          f"{measured['tokens_per_s']:.1f}  "
          f"(ratio {ratios['tokens_ratio']:.2f})")
    print(f"  p99 latency: predicted {pred.latency_p99_s * 1e3:.1f} ms, "
          f"measured {measured['latency_p99_s'] * 1e3:.1f} ms  "
          f"(ratio {ratios['p99_ratio']:.2f})")
    artifact["calibration"] = {
        "profile": profile.to_dict(), "config": config.to_dict(),
        "measured": measured, "predicted": pred.to_dict(),
        "ratios": ratios, "tolerance": args.calibrate_tolerance}
    if args.benchmark_log_dir:
        from dtf_tpu_torch.utils.benchmark_logger import BenchmarkFileLogger
        blog = BenchmarkFileLogger(args.benchmark_log_dir)
        blog.log_registry(default_registry())
        print(f"  registry exported to "
              f"{args.benchmark_log_dir}/metric.log")
    if not sm.ratios_within(ratios, args.calibrate_tolerance):
        tol = args.calibrate_tolerance
        print(f"calibrate: ratio(s) outside [{1 / tol:.2f}, {tol:.2f}] "
              f"— the fleet model is off for this workload/box "
              f"({ratios})", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    args = _build_parser().parse_args(argv)
    artifact: dict = {"argv": list(sys.argv[1:] if argv is None
                                   else argv)}
    rc = 0
    if args.measure_tp_comm:
        args.tp_comm_frac = _measure_tp_comm(args, artifact)
    if args.calibrate:
        rc = _calibrate(args, artifact)
    else:
        from dtf_tpu_torch.plan import serve_model as sm
        from dtf_tpu_torch.plan.serve_trace import (measured_stats,
                                              parse_workload,
                                              synthetic_workload)
        overrides = _profile_overrides(args)
        if args.trace:
            try:
                workload = parse_workload(args.trace)
            except FileNotFoundError as e:
                print(f"plan_serve: {e}", file=sys.stderr)
                return 2
            from dtf_tpu_torch.cli.trace_main import discover, merge_records
            merged = merge_records(discover(list(args.trace)))
            try:
                profile = sm.ServeProfile.from_records(merged,
                                                       **overrides)
            except ValueError as e:
                print(f"plan_serve: {e}", file=sys.stderr)
                return 2
            if not workload.requests:
                print(f"plan_serve: no per-request records under "
                      f"{args.trace} (need a traced serving run)",
                      file=sys.stderr)
                return 2
            artifact["measured"] = measured_stats(workload)
        else:
            lo, _, hi = args.prompt_tokens.partition(":")
            try:
                workload = synthetic_workload(
                    rate_rps=args.rate, duration_s=args.duration,
                    seed=args.seed, process=args.process,
                    burst_factor=args.burst_factor,
                    prompt_tokens=(int(lo), int(hi or lo)),
                    decode_tokens=args.decode_tokens,
                    shared_fraction=args.shared_fraction,
                    shared_groups=args.shared_groups,
                    shared_prefix_tokens=args.shared_prefix_tokens)
                profile = sm.ServeProfile(**overrides)
            except (TypeError, ValueError) as e:
                print(f"plan_serve: {e} (synthetic workloads need "
                      f"--decode_step_ms and --prefill_chunk_ms, or a "
                      f"--trace to profile from)", file=sys.stderr)
                return 2
        base = _fleet_config(args)
        print(f"workload: {workload.summary()}")
        print(f"profile: decode step "
              f"{profile.decode_step_s * 1e3:.2f} ms, chunk "
              f"{profile.prefill_chunk_s * 1e3:.2f} ms × "
              f"{profile.chunk_tokens} tok, page {profile.page_size}")
        baseline = sm.simulate(workload, profile, base)
        print(f"baseline {base.describe()}: {_fmt_pred(baseline)}")
        artifact.update(workload=workload.summary(),
                        profile=profile.to_dict(),
                        base_config=base.to_dict(),
                        baseline=baseline.to_dict())
        _whatifs(args, workload, profile, base, artifact)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1, default=str)
            f.write("\n")
        print(f"artifact written to {args.out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
