"""Plan → config compilation: resolve ``--plan auto|<file>`` into the
EXISTING parallelism flags.

The planner deliberately owns no runtime of its own — a chosen
:class:`Plan` compiles down to exactly the flags an operator would have
typed (`--model_parallelism`, `--seq_parallelism`,
`--optimizer_sharding`, `--grad_accum_steps` / `--num_microbatches`,
`--remat`, `--num_devices`), so a plan-selected run is bit-identical to
the same configuration set by hand (tests/test_plan.py asserts this).
The flags a plan owns must be at their defaults when ``--plan`` is
given: a hand-set `--model_parallelism 4` silently overridden by a plan
(or vice versa) is exactly the folklore-vs-model ambiguity this
subsystem exists to remove.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from dtf_tpu_torch.models.registry import auto_num_microbatches, is_pipeline
from dtf_tpu_torch.plan.cost_model import Plan, check_plan, predict
from dtf_tpu_torch.plan.mesh_spec import MeshSpec, mesh_spec
from dtf_tpu_torch.plan.model_stats import ModelStats, characterize
from dtf_tpu_torch.plan.search import best_plan

log = logging.getLogger("dtf_tpu_torch")

# Flags a plan compiles into, with the defaults they must still hold
# when --plan is given (conflict = loud error, never silent override)
PLAN_OWNED_FLAGS = {
    "model_parallelism": 1,
    "seq_parallelism": 1,
    "optimizer_sharding": False,
    "zero_stage": 0,
    "grad_accum_steps": 1,
    "num_microbatches": None,
    "remat": False,
    "remat_policy": None,
}


def dtype_bytes_of(cfg) -> int:
    return 2 if cfg.dtype in ("bf16", "bfloat16", "fp16", "float16") else 4


def stats_for_config(cfg) -> ModelStats:
    """Characterize the model a config would build, at the config's
    shapes (seq_len override, num_classes override, compute dtype)."""
    from dtf_tpu_torch.data import get_dataset_spec

    model_name = "trivial" if cfg.use_trivial_model else cfg.model
    seq_len = None
    if cfg.dataset:
        spec = get_dataset_spec(cfg.dataset)
        if spec.is_sequence:
            seq_len = cfg.seq_len or spec.seq_len
    return characterize(model_name, seq_len=seq_len,
                        num_classes=cfg.num_classes,
                        dtype_bytes=dtype_bytes_of(cfg))


def apply_plan(cfg, plan: Plan):
    """Compile a plan into config flags.  Raises when a plan-owned flag
    was hand-set (ambiguous intent) or when an explicit --num_devices
    contradicts the plan's device count.  The returned config has
    ``plan=""`` — it IS the hand-flag form."""
    conflicts = [k for k, default in PLAN_OWNED_FLAGS.items()
                 if getattr(cfg, k) != default]
    if conflicts:
        raise ValueError(
            f"--plan conflicts with hand-set flags {conflicts}: a plan "
            f"compiles into exactly these flags — drop them or drop "
            f"--plan")
    if cfg.num_devices is not None and cfg.num_devices != plan.num_devices:
        raise ValueError(
            f"--num_devices {cfg.num_devices} contradicts the plan's "
            f"{plan.num_devices} devices ({plan.describe()})")
    kw = dict(
        plan="",
        num_devices=plan.num_devices,
        model_parallelism=plan.model_axis_size,
        seq_parallelism=plan.seq,
        # stage 1 keeps compiling into the historical shorthand flag;
        # stages 2/3 into --zero_stage (the two are mutually exclusive
        # by Config validation)
        optimizer_sharding=plan.zero == 1,
        zero_stage=plan.zero if plan.zero >= 2 else 0,
        remat=plan.remat,
    )
    if is_pipeline(cfg.model):
        kw["num_microbatches"] = plan.microbatch
    elif plan.microbatch > 1:
        kw["grad_accum_steps"] = plan.microbatch
    return cfg.replace(**kw)


def plan_from_config(cfg, num_devices: int) -> Plan:
    """The plan a hand-flagged config already describes (the inverse of
    apply_plan) — what the calibration loop predicts for a run
    configured without --plan.

    A pipeline config with ``num_microbatches`` unset takes the
    runner's auto-pick (``registry.auto_num_microbatches``), and one
    deliberate approximation: ``--remat_policy dots`` maps to plain
    ``remat=True`` (the cost model has no selective-remat point; it
    over-counts dots' recompute and under-counts its saved bytes)."""
    maxis = max(cfg.model_parallelism, 1)
    pipelined = is_pipeline(cfg.model)
    sp = max(cfg.seq_parallelism, 1)
    if num_devices % (maxis * sp):
        raise ValueError(
            f"{num_devices} devices not divisible by "
            f"model_parallelism×seq_parallelism = {maxis * sp}")
    if pipelined and cfg.num_microbatches is None:
        per_shard = cfg.batch_size // max(num_devices // (maxis * sp), 1)
        micro = auto_num_microbatches(maxis, per_shard)
    else:
        micro = (cfg.num_microbatches if pipelined
                 else cfg.grad_accum_steps) or 1
    return Plan(data=num_devices // (maxis * sp),
                model=1 if pipelined else maxis,
                pipeline=maxis if pipelined else 1,
                seq=sp, zero=cfg.zero_stage_effective,
                microbatch=max(int(micro), 1),
                remat=bool(cfg.remat or cfg.remat_policy))


def load_plan_file(path: str) -> Plan:
    """A plan from a JSON file: a bare plan object, a ``{"plan": …}``
    wrapper, or a ranked artifact (``{"plans": [...]}`` — the first
    feasible entry wins)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "plans" in doc:
        for entry in doc["plans"]:
            if entry.get("feasible", True):
                return Plan.from_dict(entry["plan"])
        raise ValueError(f"ranked plan artifact {path!r} contains no "
                         f"feasible plan")
    if isinstance(doc, dict) and "plan" in doc:
        doc = doc["plan"]
    if not isinstance(doc, dict):
        raise ValueError(f"plan file {path!r}: expected a JSON object, "
                         f"got {type(doc).__name__}")
    return Plan.from_dict(doc)


def resolve_plan(cfg, mesh: Optional[MeshSpec] = None):
    """Resolve ``cfg.plan`` ("auto" or a plan-file path) into concrete
    config flags.  No-op when the flag is empty.  Infeasible or invalid
    plans are rejected loudly — a plan that would OOM must die here,
    not twenty minutes into compilation on a pod."""
    if not cfg.plan:
        return cfg
    if cfg.distribution_strategy in ("horovod", "parameter_server"):
        raise ValueError(
            f"--plan targets the SPMD strategies (batch_size is the "
            f"global batch); --distribution_strategy "
            f"{cfg.distribution_strategy} scales batch per replica — "
            f"set the parallelism flags by hand")
    stats = stats_for_config(cfg)
    # an explicit --num_devices bounds the LIVE mesh (planning a subset
    # of the attached chips); explicit presets/descriptors ignore it —
    # apply_plan's contradiction check still fires for those
    mesh = mesh or mesh_spec(cfg.plan_mesh, live_devices=cfg.num_devices,
                             cfg=cfg)
    if not cfg.plan_mesh and cfg.num_devices is not None \
            and mesh.num_hosts > 1:
        raise ValueError(
            "--plan with --num_devices on a multi-host run is ambiguous "
            "(num_devices means per-process local chips under mirrored, "
            "a global truncation otherwise) — pass an explicit "
            "--plan_mesh descriptor instead")
    if cfg.plan == "auto":
        if cfg.plan_cache:
            # memoized lattice: launcher restarts and repeated resolves
            # skip the search; the pick + loud-failure logic is shared.
            # overlap_frac defaults to AUTO here: a prior `plan_main
            # --calibrate` against this cache persisted the MEASURED
            # overlap fraction for (workload, mesh), and resolution
            # uses it without an operator in the loop (plan/cache.py)
            from dtf_tpu_torch.plan.cache import cached_search
            from dtf_tpu_torch.plan.search import best_from_ranked
            ranked_list, _ = cached_search(
                cfg.plan_cache, stats, mesh, cfg.batch_size,
                optimizer=cfg.optimizer)
            ranked = best_from_ranked(ranked_list, stats, mesh,
                                      cfg.batch_size)
        else:
            ranked = best_plan(stats, mesh, cfg.batch_size,
                               optimizer=cfg.optimizer)
        plan, cost = ranked.plan, ranked.cost
        log.info(
            "plan auto (%s, %d devices): %s — predicted %.1f ms/step, "
            "peak %.2f GiB/device (budget %.2f)", mesh.name,
            mesh.num_devices, plan.describe(), cost.step_time_s * 1e3,
            cost.peak_bytes / 2 ** 30, cost.hbm_budget_bytes / 2 ** 30)
    else:
        plan = load_plan_file(cfg.plan)
        violations = check_plan(plan, stats, mesh, cfg.batch_size)
        if violations:
            raise ValueError(
                f"plan {plan.describe()} from {cfg.plan!r} is invalid "
                f"for {stats.model} on {mesh.name}: "
                f"{'; '.join(violations)}")
        cost = predict(plan, stats, mesh, cfg.batch_size,
                       optimizer=cfg.optimizer)
        if not cost.feasible:
            raise ValueError(
                f"plan {plan.describe()} from {cfg.plan!r} is "
                f"memory-INFEASIBLE on {mesh.name}: predicted peak "
                f"{cost.peak_bytes / 2**30:.2f} GiB/device exceeds the "
                f"budget {cost.hbm_budget_bytes / 2**30:.2f} GiB "
                f"({mesh.hbm_bytes / 2**30:.0f} GiB HBM × "
                f"{cost.hbm_budget_bytes / mesh.hbm_bytes:.0%})")
        log.info(
            "plan %s from %s: predicted %.1f ms/step, peak %.2f "
            "GiB/device", plan.describe(), cfg.plan,
            cost.step_time_s * 1e3, cost.peak_bytes / 2 ** 30)
    from dtf_tpu_torch.runtime.mesh import run_world, topology
    attached = run_world(cfg)
    topology(cfg)           # on CUDA: raises when there is no card
    if plan.num_devices > attached:
        # without this the run would execute a DIFFERENT parallelization
        # than the one planned -- the opposite of "plans die loudly"
        raise ValueError(
            f"plan {plan.describe()} targets {plan.num_devices} devices "
            f"({mesh.name} mesh) but only {attached} are attached (the "
            f"ranks this run has) -- a plan for a larger simulated mesh "
            f"can be ranked with plan_main, not run here")
    if plan.num_devices < attached and cfg.process_count:
        # a launched world cannot shrink to the plan: its ranks exist
        raise ValueError(
            f"plan {plan.describe()} targets {plan.num_devices} devices "
            f"but this run has {attached} ranks -- launch "
            f"{plan.num_devices} (the launcher's --num_processes)")
    return apply_plan(cfg, plan)
