"""Parallelism planner -- the port of ``dtf_tpu/plan``: an analytic
cost/memory model over the strategy space, feasible-plan search,
plan->config compilation, and the serving-capacity simulator.

An analytic cost+memory model over the plan lattice (AMP,
arXiv:2210.07297; DistIR, arXiv:2111.05426) picks near-optimal plans
without touching the accelerators: plans for four 8-card H100 hosts
are ranked on a CPU box in milliseconds.

Layers (each module the JAX package's, its imports re-pointed, except
where noted):
  mesh_spec   -- MeshSpec: devices, HBM, achievable FLOP/s, intra/inter
                 host bandwidth; the port's presets (cpu, h100x8,
                 4xh100x8), the live mesh of the run's ranks, and a
                 torch FLOP/s calibration probe (the port's own)
  model_stats -- per-layer param counts, forward FLOPs and activation
                 bytes from the port's registry (transformer + resnet
                 families; MoE is refused, as in the JAX package)
  cost_model  -- Plan (data/model/seq x zero x pipeline x microbatch x
                 remat) -> predicted step time + peak memory
  search      -- enumerate the feasible lattice under the memory
                 budget, rank by predicted step time, emit a ranked
                 JSON artifact
  cache       -- the ranked lattice memoized in a JSON sidecar, with
                 the measured overlap fraction fed back
  compile     -- Plan <-> the config flags (``--plan auto|<file>``);
                 the live mesh and the size guard count the run's ranks
  serve_trace -- serving workloads: per-request reconstruction from the
                 port's recorded traces, synthetic arrival generators
  serve_model -- the serving-capacity simulator and its what-ifs

CLIs: ``python -m dtf_tpu_torch.cli.plan_main`` (rank / --check /
--calibrate) and ``python -m dtf_tpu_torch.cli.plan_serve_main``
(serving what-ifs / --calibrate).
"""

from dtf_tpu_torch.plan.cost_model import Plan, PlanCost, predict, check_plan
from dtf_tpu_torch.plan.mesh_spec import MeshSpec, mesh_spec
from dtf_tpu_torch.plan.model_stats import ModelStats, characterize
from dtf_tpu_torch.plan.search import search, ranked_artifact
from dtf_tpu_torch.plan.compile import (apply_plan, load_plan_file,
                                  plan_from_config, resolve_plan)
from dtf_tpu_torch.plan.serve_trace import (RequestRecord, Workload,
                                      measured_stats, parse_workload,
                                      scale_workload,
                                      synthetic_workload,
                                      workload_from_records)
from dtf_tpu_torch.plan.serve_model import (FleetConfig, FleetPrediction,
                                      ServeProfile, pool_vs_shed,
                                      rank_tp_vs_replicas,
                                      replicas_for, simulate)

__all__ = [
    "Plan", "PlanCost", "predict", "check_plan",
    "MeshSpec", "mesh_spec",
    "ModelStats", "characterize",
    "search", "ranked_artifact",
    "apply_plan", "load_plan_file", "plan_from_config", "resolve_plan",
    "RequestRecord", "Workload", "measured_stats", "parse_workload",
    "scale_workload", "synthetic_workload", "workload_from_records",
    "FleetConfig", "FleetPrediction", "ServeProfile", "pool_vs_shed",
    "rank_tp_vs_replicas", "replicas_for", "simulate",
]
