"""Feasible-plan search: enumerate the strategy lattice, keep what
passes the hard constraints, rank what fits the HBM budget by predicted
step time, and emit a ranked JSON artifact.

A copy of ``dtf_tpu/plan/search.py`` with its imports re-pointed.

The lattice is small by construction — axis sizes are factorizations of
the device count, microbatch counts are powers of two dividing the
per-replica batch — so exhaustive enumeration beats anything cleverer:
a 4-host × 4-device pod's full lattice is a few hundred plans and ranks
in milliseconds on a laptop.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List, Optional, Tuple

from dtf_tpu_torch.plan.cost_model import (DEFAULT_OVERLAP_FRAC, HBM_FRACTION,
                                     Plan, PlanCost, check_plan, predict)
from dtf_tpu_torch.plan.mesh_spec import MeshSpec
from dtf_tpu_torch.plan.model_stats import ModelStats

MAX_MICROBATCH = 64


@dataclasses.dataclass(frozen=True)
class RankedPlan:
    plan: Plan
    cost: PlanCost
    violations: Tuple[str, ...] = ()

    @property
    def feasible(self) -> bool:
        return not self.violations and self.cost.feasible

    def to_dict(self) -> dict:
        return {"plan": self.plan.to_dict(), "predicted": self.cost.to_dict(),
                "feasible": self.feasible,
                "violations": list(self.violations)}


def _factorizations(n: int, ways: int) -> Iterator[Tuple[int, ...]]:
    """All ordered tuples of `ways` positive ints whose product is n."""
    if ways == 1:
        yield (n,)
        return
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _factorizations(n // d, ways - 1):
                yield (d,) + rest


def enumerate_plans(stats: ModelStats, mesh: MeshSpec, global_batch: int
                    ) -> Iterator[Plan]:
    """Every plan in the lattice that passes the hard constraints
    (devices, divisibility, family capabilities).  Memory feasibility
    is NOT filtered here — search() ranks and tags it, so the artifact
    can show near-miss plans with their predicted overage."""
    n = mesh.num_devices
    micro_opts = [m for m in
                  itertools.takewhile(lambda m: m <= MAX_MICROBATCH,
                                      (2 ** i for i in range(32)))
                  if m <= max(global_batch, 1)]
    seen = set()
    for data, seq, maxis in _factorizations(n, 3):
        # the 'model' mesh axis carries EITHER tensor ways OR pipeline
        # stages (runner.py maps pipeline families onto the same axis)
        axis_roles = [(maxis, 1)]
        if maxis > 1 and stats.supports_pipeline:
            axis_roles = [(1, maxis)]
        for model, pipeline in axis_roles:
            for zero, micro, remat in itertools.product(
                    (0, 1, 2, 3), micro_opts,
                    (False, True) if stats.supports_remat else (False,)):
                try:
                    plan = Plan(data=data, model=model, seq=seq,
                                pipeline=pipeline, zero=zero,
                                microbatch=micro, remat=remat)
                except ValueError:
                    continue
                if plan in seen:
                    continue
                seen.add(plan)
                if not check_plan(plan, stats, mesh, global_batch):
                    yield plan


def search(stats: ModelStats, mesh: MeshSpec, global_batch: int,
           optimizer: str = "sgd", hbm_fraction: float = HBM_FRACTION,
           device_flops: Optional[float] = None,
           overlap_frac: float = DEFAULT_OVERLAP_FRAC) -> List[RankedPlan]:
    """Rank the whole valid lattice: feasible plans first by predicted
    step time, then infeasible ones by how far over budget they are
    (the artifact keeps them so an operator can see WHY a tempting
    plan was rejected)."""
    ranked = [RankedPlan(plan, predict(plan, stats, mesh, global_batch,
                                       optimizer=optimizer,
                                       hbm_fraction=hbm_fraction,
                                       device_flops=device_flops,
                                       overlap_frac=overlap_frac))
              for plan in enumerate_plans(stats, mesh, global_batch)]
    # feasible first by predicted step time; the analytic times
    # quantize so ties are common — break them toward the FEWEST
    # microbatches (accumulation/pipelining chunks carry unmodeled
    # per-chunk dispatch overhead, so at equal predicted time deeper
    # splitting is pure downside), then toward the lower predicted
    # peak (memory headroom is free insurance)
    return sorted(ranked, key=lambda r: (not r.feasible,
                                         (r.cost.step_time_s,
                                          r.plan.microbatch,
                                          r.cost.peak_bytes)
                                         if r.feasible
                                         else (r.cost.peak_bytes, 0, 0.0)))


def best_plan(stats: ModelStats, mesh: MeshSpec, global_batch: int,
              optimizer: str = "sgd") -> RankedPlan:
    """The `--plan auto` resolution: the fastest feasible plan, or a
    loud error naming the smallest predicted overage when nothing
    fits."""
    return best_from_ranked(search(stats, mesh, global_batch,
                                   optimizer=optimizer),
                            stats, mesh, global_batch)


def best_from_ranked(ranked: List[RankedPlan], stats: ModelStats,
                     mesh: MeshSpec, global_batch: int) -> RankedPlan:
    """best_plan over an already-ranked lattice (the plan-cache path
    feeds memoized rankings through the same pick + loud-failure
    logic)."""
    for r in ranked:
        if r.feasible:
            return r
    if not ranked:
        raise ValueError(
            f"no valid plan for {stats.model} on {mesh.name} "
            f"({mesh.num_devices} devices) at global batch "
            f"{global_batch}: every lattice point violates a hard "
            f"constraint (divisibility/capability)")
    near = min(ranked, key=lambda r: r.cost.peak_bytes)
    raise ValueError(
        f"no plan for {stats.model} on {mesh.name} fits the HBM budget "
        f"({near.cost.hbm_budget_bytes / 2**30:.2f} GiB/device): the "
        f"smallest predicted peak is {near.cost.peak_bytes / 2**30:.2f} "
        f"GiB ({near.plan.describe()}) — shrink the batch, grow the "
        f"mesh, or raise the budget")


def ranked_artifact(stats: ModelStats, mesh: MeshSpec, global_batch: int,
                    ranked: List[RankedPlan], top: int = 0) -> dict:
    """The ranked-plan JSON artifact (plan_main --out / bench_plan.py):
    workload + mesh + every (or top-N) ranked plan with its predicted
    cost, feasible plans first."""
    plans = ranked[:top] if top else ranked
    return {
        "model": stats.model,
        "family": stats.family,
        "seq_len": stats.seq_len,
        "params": stats.params,
        "global_batch": global_batch,
        "mesh": mesh.to_dict(),
        "feasible_count": sum(1 for r in ranked if r.feasible),
        "plan_count": len(ranked),
        "plans": [r.to_dict() for r in plans],
    }
