"""Parallelism-planner CLI -- rank, check, and calibrate plans; the
PyTorch counterpart of ``dtf_tpu/cli/plan_main.py``.

Rank the feasible plan lattice for a workload on a (possibly simulated)
mesh -- plans for four 8-card H100 hosts are computed on a CPU box:

  python -m dtf_tpu_torch.cli.plan_main --model transformer_tpu \\
      --dataset lm --seq_len 2048 --batch_size 256 --dtype bf16 \\
      --optimizer adamw --plan_mesh 4xh100x8 --top 10 --out plans.json

Verify that every plan the ranker calls feasible actually trains (one
smoke step per plan, each of its devices a rank started through
``cli/launch.py``: gloo on the CPU; on CUDA one rank a card, or gloo
ranks sharing the cards when a plan has more ranks than the host has
cards).  ``--devices N`` is how many ranks a check may start (default:
the host's cards, or 1 on the CPU); a larger plan is reported as a
failure, never skipped:

  python -m dtf_tpu_torch.cli.plan_main --devices 8 --device cpu \\
      --model transformer_small --dataset lm --seq_len 64 \\
      --batch_size 8 --check --check_top 3

Calibration: run a short MEASURED smoke on ``--device`` and record
predicted-vs-measured step time and live bytes into the obs registry
(and, with ``--benchmark_log_dir``, into metric.log); exits nonzero
when the ratio leaves ``--calibrate_tolerance``:

  python -m dtf_tpu_torch.cli.plan_main --model transformer_small \\
      --dataset lm --use_synthetic_data --seq_len 64 --batch_size 4 \\
      --optimizer adamw --calibrate

The FLOP/s probe the prediction divides by is the JAX package's
(``--calibrate_probe small``: ``transformer_small`` f32 at batch 2, seq
64).  ``--calibrate_probe run`` times the workload's own LM at its seq
length, compute dtype and per-replica microbatch instead: on a card the
small probe is launch-bound, so its rate says little of a full-width
step.

``--plan <file>`` evaluates that one plan instead of searching;
memory-infeasible plans are rejected loudly (exit 2).

All ordinary flags (--model/--dataset/--batch_size/--seq_len/--dtype/
--optimizer/--device/--plan_mesh/...) are accepted; the planner-only
options are --devices/--top/--out/--check/--check_top/--calibrate/
--calibrate_steps/--calibrate_tolerance/--calibrate_probe/--overlap_frac.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import os
import sys
import tempfile

from dtf_tpu_torch.config import parse_flags

log = logging.getLogger("dtf_tpu_torch")

_OWN_FLAGS = {
    # name: (takes_value, default)
    "devices": (True, None),
    "top": (True, 10),
    "out": (True, ""),
    "check": (False, False),
    "check_top": (True, 3),
    "calibrate": (False, False),
    "calibrate_steps": (True, 8),
    "calibrate_tolerance": (True, 2.0),
    # the FLOP/s probe: "small" (the JAX package's) or "run" (the
    # workload's own LM at its shapes and dtype)
    "calibrate_probe": (True, "small"),
    # ZeRO-2/3 compute/comm overlap fraction the cost model credits.
    # Unset = AUTO: a prior --calibrate's measured fraction persisted
    # in --plan_cache for this (workload, mesh), else
    # cost_model.DEFAULT_OVERLAP_FRAC; an explicit value always wins
    "overlap_frac": (True, None),
    # one rank of a launched smoke: the config's JSON (internal)
    "rank_config": (True, ""),
}

_FLOAT_FLAGS = ("calibrate_tolerance", "overlap_frac")
_STR_FLAGS = ("out", "rank_config", "calibrate_probe")
PROBES = ("small", "run")
# how long the ranks of one launched smoke may take
RANK_TIMEOUT_S = 900.0
# what rank 0 of a launched smoke writes beside its config
RESULT_FILE = "result.json"


def _split_args(argv):
    """Extract plan_main-only options; the rest is ordinary flags."""
    own = {k: v[1] for k, v in _OWN_FLAGS.items()}
    rest = []
    i = 0
    while i < len(argv):
        name = argv[i].lstrip("-")
        if argv[i].startswith("-") and name in _OWN_FLAGS:
            takes_value = _OWN_FLAGS[name][0]
            if takes_value:
                raw = argv[i + 1]
                own[name] = (float(raw) if name in _FLOAT_FLAGS
                             else raw if name in _STR_FLAGS else int(raw))
                i += 2
            else:
                own[name] = True
                i += 1
        else:
            rest.append(argv[i])
            i += 1
    return own, rest


def _smoke_config(cfg, train_steps: int, model_dir: str):
    """A measured/compile smoke derived from the workload config: tiny
    step count, synthetic-friendly, no checkpoint/eval side effects."""
    return cfg.replace(
        train_steps=train_steps, train_epochs=1, log_steps=1,
        model_dir=model_dir, skip_checkpoint=True, skip_eval=True,
        clean=False, resume=False, benchmark_log_dir="")


def _measured(stats: dict) -> dict:
    """What a smoke measured: its stats' throughput and the Trainer's
    two calibration gauges (``train/loop.py``)."""
    from dtf_tpu_torch.obs.registry import default_registry
    reg = default_registry()
    out = {"avg_exp_per_second": stats.get("avg_exp_per_second")}
    for name in ("train_step_s", "train_live_bytes"):
        g = reg.get(name)
        out[name] = float(g.value) if g is not None else 0.0
    return out


def _run_smoke(smoke, ranks: int) -> dict:
    """Train ``smoke`` on ``ranks`` ranks and return :func:`_measured`
    of rank 0: in this process at one rank, else through
    ``cli/launch.py`` (each rank this module with ``--rank_config``)."""
    from dtf_tpu_torch.cli import runner
    from dtf_tpu_torch.obs.registry import default_registry

    if ranks == 1:
        # this run's gauges, not an earlier run's in this process
        reg = default_registry()
        reg.gauge("train_step_s", unit="s").set(0.0)
        reg.gauge("train_live_bytes", unit="bytes").set(0.0)
        return _measured(runner.run(smoke))
    from dtf_tpu_torch.cli.launch import launch_local
    with tempfile.TemporaryDirectory(prefix="dtf_plan_ranks_") as tmp:
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(smoke), f)
        rc = launch_local(
            [sys.executable, "-m", "dtf_tpu_torch.cli.plan_main",
             "--rank_config", path], ranks, f"file://{tmp}/rdv", tmp,
            timeout_s=RANK_TIMEOUT_S)
        if rc:
            logs = sorted(n for n in os.listdir(tmp) if n.startswith("log"))
            tail = ""
            if logs:
                with open(os.path.join(tmp, logs[0])) as f:
                    tail = f.read()[-2000:]
            raise RuntimeError(f"{ranks} ranks exited {rc}: {tail}")
        with open(os.path.join(tmp, RESULT_FILE)) as f:
            return json.load(f)


def _rank_main(path: str) -> int:
    """One rank of a launched smoke: the config from ``path``, its place
    from the launcher's environment; rank 0 writes what it measured
    beside the config.  Ranks that outnumber the cards share them over
    gloo (NCCL refuses two ranks on one card)."""
    import torch

    from dtf_tpu_torch.cli import runner
    from dtf_tpu_torch.config import Config
    from dtf_tpu_torch.config.flags import apply_env_topology
    from dtf_tpu_torch.runtime.mesh import initialize

    with open(path) as f:
        cfg = apply_env_topology(Config(**json.load(f)))
    shared = (torch.device(cfg.device).type == "cuda"
              and cfg.process_count > torch.cuda.device_count())
    rt = initialize(cfg, backend="gloo" if shared else None)
    out = _measured(runner.run(cfg, rt))
    if cfg.process_id == 0:
        with open(os.path.join(os.path.dirname(path), RESULT_FILE),
                  "w") as f:
            json.dump(out, f)
    return 0


def _check(cfg, ranked, check_top: int, live: int) -> int:
    """One smoke train step for each feasible-marked plan (top
    ``check_top``) on its own ranks; nonzero exit when any of them
    fails -- a plan the model calls feasible MUST train, that is the
    contract.  ``live``: the ranks a check may start."""
    from dtf_tpu_torch.plan import apply_plan

    failures = 0
    # cap BEFORE the rank-count test: checking a simulated mesh larger
    # than this box must report check_top clear failures, not one
    # "cannot check" line per feasible plan in the lattice
    to_check = [r for r in ranked if r.feasible][:check_top]
    for r in to_check:
        if r.plan.num_devices > live:
            print(f"plan {r.plan.describe()}: needs {r.plan.num_devices} "
                  f"devices, {live} attached — cannot check on this box",
                  file=sys.stderr)
            failures += 1
            continue
        with tempfile.TemporaryDirectory() as tmp:
            try:
                # apply_plan inside the guard: a hand-set plan-owned
                # flag reports per-plan FAILED lines, not one traceback
                smoke = _smoke_config(apply_plan(cfg, r.plan), 1, tmp)
                _run_smoke(smoke, r.plan.num_devices)
                print(f"check {r.plan.describe()}: OK")
            except Exception as e:  # noqa: BLE001 -- report, keep checking
                failures += 1
                print(f"check {r.plan.describe()}: FAILED "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
    if not to_check:
        print("check: no feasible plan to check", file=sys.stderr)
        return 1
    return 1 if failures else 0


def _probe_flops(cfg, stats, plan, probe: str) -> float:
    """The measured FLOP/s the prediction uses, on ``--device``:
    ``probe`` "small" is the JAX package's probe, "run" the workload's
    LM at its seq length, compute dtype and per-replica microbatch (the
    whole model on one device: a tensor or pipeline plan's shard shapes
    are not what it times)."""
    # the module, through importlib: the package re-binds the name
    # ``mesh_spec`` to the function
    mesh_spec_mod = importlib.import_module("dtf_tpu_torch.plan.mesh_spec")
    if probe == "small":
        return mesh_spec_mod.calibrate_device_flops(cfg.device)
    batch = max(cfg.batch_size // (plan.data * plan.microbatch), 1)
    return mesh_spec_mod.calibrate_device_flops(
        cfg.device, model=stats.model, batch=batch, seq_len=stats.seq_len,
        num_classes=cfg.num_classes or None, dtype=cfg.compute_dtype)


def _calibrate(cfg, stats, mesh, plan, steps: int, tolerance: float,
               overlap_frac: float, probe: str = "small") -> int:
    """Measured smoke vs prediction.  Records, per the obs-registry
    contract: plan_predicted_step_s, plan_measured_step_s,
    plan_step_time_ratio, plan_predicted_peak_bytes,
    plan_measured_live_bytes, plan_live_bytes_ratio -- exported through
    BenchmarkFileLogger.log_registry when --benchmark_log_dir is set."""
    from dtf_tpu_torch.obs.registry import default_registry
    from dtf_tpu_torch.plan import apply_plan, predict
    from dtf_tpu_torch.plan.compile import PLAN_OWNED_FLAGS

    # measured achievable FLOP/s replaces the preset's guess: the ratio
    # then compares the MODEL (traffic/FLOP accounting), not whether
    # the preset knew this device's matmul speed
    measured_flops = _probe_flops(cfg, stats, plan, probe)
    cost = predict(plan, stats, mesh, cfg.batch_size,
                   optimizer=cfg.optimizer, device_flops=measured_flops,
                   overlap_frac=overlap_frac)
    # calibrating a hand-flagged config: the plan was DERIVED from the
    # plan-owned flags (plan_from_config), so reset them to defaults
    # before apply_plan writes them back -- otherwise its hand-set-flag
    # conflict guard rejects the very flags the plan encodes
    run_cfg = cfg.replace(plan="", **PLAN_OWNED_FLAGS)
    run_cfg = apply_plan(run_cfg, plan)
    benchmark_dir = cfg.benchmark_log_dir
    with tempfile.TemporaryDirectory() as tmp:
        got = _run_smoke(_smoke_config(run_cfg, steps, tmp),
                         plan.num_devices)
    reg = default_registry()
    if got["train_step_s"] > 0:
        measured_step = got["train_step_s"]
    elif got.get("avg_exp_per_second"):
        measured_step = cfg.batch_size / got["avg_exp_per_second"]
    else:
        print("calibrate: the smoke produced no step-time measurement "
              "(too few steps?)", file=sys.stderr)
        return 1
    measured_live = got["train_live_bytes"]

    ratio = cost.step_time_s / measured_step
    reg.gauge("plan_predicted_step_s", unit="s").set(cost.step_time_s)
    reg.gauge("plan_measured_step_s", unit="s").set(measured_step)
    reg.gauge("plan_step_time_ratio").set(ratio)
    if plan.zero >= 2:
        # invert the overlap term against the measurement: the
        # overlap_frac that makes the model meet the measured step.
        # predict() defines hidden = min(t_grad, frac · compute), so
        # the implied fraction is measured-hidden / COMPUTE
        t_grad = cost.breakdown.get("grad_sync_s", 0.0)
        hidden_pred = cost.breakdown.get("hidden_comm_s", 0.0)
        other = cost.comm_s - (t_grad - hidden_pred)
        if t_grad > 0 and cost.compute_s > 0:
            measured_exposed = max(0.0, measured_step - cost.compute_s
                                   - other)
            hidden_meas = min(max(t_grad - measured_exposed, 0.0),
                              t_grad)
            implied = min(hidden_meas / cost.compute_s, 1.0)
            reg.gauge("plan_overlap_frac_implied").set(implied)
            print(f"  overlap: modeled frac "
                  f"{cost.breakdown.get('overlap_frac', 0.0):.2f}, "
                  f"measured-implied {implied:.2f}")
            if cfg.plan_cache:
                # close the loop: later --plan auto resolves and
                # rankings against this cache use the measured fraction
                from dtf_tpu_torch.plan.cache import store_calibration
                store_calibration(cfg.plan_cache, stats, mesh, implied)
                print(f"  overlap: persisted to {cfg.plan_cache} — "
                      f"auto-applied by later rankings/resolves")
    reg.gauge("plan_predicted_peak_bytes", unit="bytes").set(
        cost.peak_bytes)
    if measured_live:
        reg.gauge("plan_measured_live_bytes", unit="bytes").set(
            measured_live)
        reg.gauge("plan_live_bytes_ratio").set(
            cost.peak_bytes / measured_live)
    reg.gauge("plan_probe_flops").set(measured_flops)
    print(f"calibration ({plan.describe()}, device_flops "
          f"{measured_flops:.3g}, {probe} probe):")
    print(f"  step time: predicted {cost.step_time_s * 1e3:.2f} ms, "
          f"measured {measured_step * 1e3:.2f} ms  "
          f"(ratio {ratio:.2f})")
    if measured_live:
        print(f"  memory: predicted peak {cost.peak_bytes / 2**20:.1f} "
              f"MiB, measured live {measured_live / 2**20:.1f} MiB")
    if benchmark_dir:
        from dtf_tpu_torch.utils.benchmark_logger import BenchmarkFileLogger
        blog = BenchmarkFileLogger(benchmark_dir)
        blog.log_registry(reg)
        print(f"  registry exported to {benchmark_dir}/metric.log")
    if not (1.0 / tolerance <= ratio <= tolerance):
        print(f"calibrate: predicted/measured step-time ratio {ratio:.2f} "
              f"outside [{1 / tolerance:.2f}, {tolerance:.2f}] — the "
              f"cost model is off for this workload/box", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    own, rest = _split_args(list(sys.argv[1:] if argv is None else argv))
    if own["rank_config"]:
        return _rank_main(own["rank_config"])
    cfg = parse_flags(rest)
    if own["calibrate_probe"] not in PROBES:
        print(f"--calibrate_probe must be one of {PROBES}, got "
              f"{own['calibrate_probe']!r}", file=sys.stderr)
        return 2
    if not cfg.model or not cfg.dataset:
        print("plan_main needs --model and --dataset (the workload to "
              "plan)", file=sys.stderr)
        return 2

    from dtf_tpu_torch.plan import (check_plan, load_plan_file,
                                    plan_from_config, predict, search)
    from dtf_tpu_torch.plan.compile import stats_for_config
    from dtf_tpu_torch.plan.cost_model import DEFAULT_OVERLAP_FRAC
    from dtf_tpu_torch.plan.mesh_spec import mesh_spec
    from dtf_tpu_torch.plan.search import RankedPlan, ranked_artifact
    from dtf_tpu_torch.runtime.mesh import local_device_count

    stats = stats_for_config(cfg)
    # the live mesh: the ranks --devices allows (a --check may start
    # that many), else the run's own
    mesh = mesh_spec(cfg.plan_mesh, live_devices=own["devices"], cfg=cfg)
    live = own["devices"] or local_device_count(cfg.device.split(":")[0])
    # effective overlap fraction: an explicit --overlap_frac wins; else
    # the plan cache's persisted --calibrate measurement for this
    # (workload, mesh); else the model default
    overlap = (None if own["overlap_frac"] is None
               else float(own["overlap_frac"]))
    if overlap is None and cfg.plan_cache:
        from dtf_tpu_torch.plan.cache import load_calibration
        overlap = load_calibration(cfg.plan_cache, stats, mesh)
        if overlap is not None:
            print(f"plan cache: using MEASURED overlap_frac "
                  f"{overlap:.2f} from a prior --calibrate "
                  f"(--overlap_frac overrides)")
    if overlap is None:
        overlap = DEFAULT_OVERLAP_FRAC

    if cfg.plan and cfg.plan != "auto":
        # evaluate ONE explicit plan (still printed as a 1-row ranking)
        plan = load_plan_file(cfg.plan)
        violations = tuple(check_plan(plan, stats, mesh, cfg.batch_size))
        cost = predict(plan, stats, mesh, cfg.batch_size,
                       optimizer=cfg.optimizer, overlap_frac=overlap)
        ranked = [RankedPlan(plan, cost, violations)]
    elif cfg.plan_cache:
        from dtf_tpu_torch.plan.cache import cached_search
        ranked, hit = cached_search(cfg.plan_cache, stats, mesh,
                                    cfg.batch_size,
                                    optimizer=cfg.optimizer,
                                    overlap_frac=overlap)
        print(f"plan cache: {'HIT — search skipped' if hit else 'miss'} "
              f"({cfg.plan_cache})")
    else:
        ranked = search(stats, mesh, cfg.batch_size,
                        optimizer=cfg.optimizer, overlap_frac=overlap)

    feasible = sum(1 for r in ranked if r.feasible)
    print(f"{stats.model} ({stats.params / 1e6:.1f}M params"
          + (f", seq {stats.seq_len}" if stats.seq_len else "")
          + f") × batch {cfg.batch_size} on {mesh.name} "
          f"({mesh.num_hosts}×{mesh.devices_per_host} devices, "
          f"{mesh.hbm_bytes / 2**30:.0f} GiB HBM): "
          f"{feasible}/{len(ranked)} plans feasible")
    hdr = (f"{'rank':>4} {'plan':<34} {'step_ms':>9} {'peak_GiB':>9} "
           f"{'verdict':<10}")
    print(hdr)
    print("-" * len(hdr))
    for i, r in enumerate(ranked[:own["top"]], start=1):
        verdict = ("ok" if r.feasible
                   else ("invalid" if r.violations else "over-mem"))
        print(f"{i:>4} {r.plan.describe():<34} "
              f"{r.cost.step_time_s * 1e3:>9.2f} "
              f"{r.cost.peak_bytes / 2**30:>9.3f} {verdict:<10}")
        for v in r.violations:
            print(f"       ! {v}")

    if own["out"]:
        artifact = ranked_artifact(stats, mesh, cfg.batch_size, ranked,
                                   top=own["top"])
        with open(own["out"], "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
        print(f"ranked artifact written to {own['out']}")

    rc = 0
    if cfg.plan == "auto" and not feasible:
        # the runner's best_plan rejects this loudly; the CLI must not
        # exit 0 on an all-infeasible lattice -- and --calibrate below
        # must never pick (and run!) the least-over-budget plan
        near = min(ranked, key=lambda r: r.cost.peak_bytes, default=None)
        print(f"plan auto REJECTED: no feasible plan"
              + (f" — smallest predicted peak "
                 f"{near.cost.peak_bytes / 2**30:.2f} GiB "
                 f"({near.plan.describe()}) vs budget "
                 f"{near.cost.hbm_budget_bytes / 2**30:.2f} GiB"
                 if near else ""), file=sys.stderr)
        return 2
    if cfg.plan and cfg.plan != "auto":
        r = ranked[0]
        if r.violations:
            print(f"plan REJECTED (invalid): {'; '.join(r.violations)}",
                  file=sys.stderr)
            return 2
        if not r.cost.feasible:
            print(f"plan REJECTED (memory-infeasible): predicted peak "
                  f"{r.cost.peak_bytes / 2**30:.2f} GiB/device exceeds "
                  f"budget {r.cost.hbm_budget_bytes / 2**30:.2f} GiB",
                  file=sys.stderr)
            return 2
    if own["check"]:
        rc = rc or _check(cfg.replace(plan=""), ranked, own["check_top"],
                          live)
    if own["calibrate"]:
        plan = (ranked[0].plan if cfg.plan
                else plan_from_config(cfg, mesh.num_devices))
        rc = rc or _calibrate(cfg, stats, mesh, plan,
                              own["calibrate_steps"],
                              own["calibrate_tolerance"], overlap,
                              own["calibrate_probe"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
