"""Analytic cost + memory model over the parallelism strategy space.

A copy of ``dtf_tpu/plan/cost_model.py`` with its imports re-pointed:
the arithmetic is the same, operation for operation, so both packages
rank a lattice alike (``tests/test_torch_plan.py`` holds the two).

Predicted step time and predicted peak per-device memory as PURE
FUNCTIONS of a :class:`Plan` (the point in the strategy lattice), a
:class:`ModelStats` (the workload) and a :class:`MeshSpec` (the
hardware) — the AMP/DistIR idea (arXiv:2210.07297, arXiv:2111.05426):
rank the lattice analytically, touch the accelerators only to run the
winner.

Step-time model:

    t_step = t_compute · bubble(pipeline) + exposed(grad sync)
             + t_tp_psum + t_seq_ring + t_pipe_xfer

    t_compute    = 3 · F_fwd (+ remat refwd) · B_global / D / flops_dev
                   (backward ≈ 2× forward MACs)
    grad sync    = data-axis (and 'seq') weight collectives, staged:
                     zero ∈ {0,1}: one ring allreduce — 2·(n-1)/n ·
                       grad_bytes_local / bw; ZeRO-1's reduce-scatter
                       + all-gather moves the SAME volume (its win is
                       memory + update FLOPs, not wire bytes)
                     zero ∈ {2,3}: (m + 1) half-collectives — one
                       reduce-scatter per microbatch (grads shard as
                       the backward produces them) + one param
                       all-gather (stage 2: post-update; stage 3:
                       pre-compute), each (n-1)/n · bytes / bw.  At
                       m=1 the volume equals the allreduce.
    overlap      = stages 2/3 schedule their collectives per leaf /
                   per microbatch, so part of them hides behind
                   fwd/bwd compute: hidden = min(t_grad,
                   overlap_frac · t_compute), exposed = t_grad −
                   hidden.  ``overlap_frac`` defaults to
                   DEFAULT_OVERLAP_FRAC and is calibrated against the
                   measured --zero_probe gauges (plan_main
                   --calibrate emits the run's implied fraction).
                   Stages 0/1 do ONE monolithic end-of-step sync in
                   this repo — no overlap credit.
    TP psums     = 4 per block (2 fwd + 2 bwd) of the [B_loc, S_loc, d]
                   residual stream over 'model'
    seq ring     = (sp-1) K/V neighbor hops per block (ring attention)
    pipeline     = bubble factor (M + pp - 1)/M on compute, plus the
                   microbatch boundary ppermute traffic over 'model'

Memory model (per device, bytes):

    params (f32) / TP·PP sharding; ZeRO-3 holds the persistent copy
    sliced (÷ dp) but still materializes the gathered working copy
    during fwd/bwd — counted in full, honestly: the saving over the
    replicated stages is the OTHER buffers
  + gradients (f32, same sharding): zero < 2 pays the full buffer (×2
    under grad accumulation — the scan carry holds the accumulator
    while a chunk's grads materialize); zero ∈ {2,3} holds a 1/dp
    sliced accumulator plus one layer's transient full grad (each
    leaf's psum_scatter consumes it as the backward produces it)
  + optimizer state (slots × params; ÷ dp under any ZeRO stage)
  + BN running stats
  + activations of ONE microbatch (÷ seq ways; the TP-shardable
    portion ÷ model ways; remat keeps only block inputs + one live
    block's working set; a pipeline stage stashes every in-flight
    microbatch's boundary activation)
  + a fixed runtime overhead (compiled executables, collective
    scratch) — FIXED_OVERHEAD_BYTES, deliberately small so the model
    under-promises on tiny smoke configs rather than hiding headroom
    on real ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from dtf_tpu_torch.plan.mesh_spec import MeshSpec, MiB
from dtf_tpu_torch.plan.model_stats import ModelStats

# Optimizer-state slots per parameter (train/optimizer.py: keras_sgd
# keeps one velocity; adamw keeps mu+nu)
OPTIMIZER_SLOTS = {"sgd": 1, "momentum": 1, "adamw": 2}

# Fraction of HBM a plan may claim: the allocator needs headroom for
# collective scratch and temporaries beyond the model's own live set
HBM_FRACTION = 0.9

FIXED_OVERHEAD_BYTES = 64 * MiB

# Fraction of compute the ZeRO-2/3 per-leaf collectives can hide
# behind.  Deliberately conservative;
# calibrate against the measured --zero_probe exposed-comm gauges and
# override via predict(..., overlap_frac=) / plan_main --overlap_frac.
DEFAULT_OVERLAP_FRAC = 0.5


@dataclasses.dataclass(frozen=True)
class Plan:
    """One point in the strategy lattice.

    ``model`` (tensor-parallel ways) and ``pipeline`` (GPipe stages)
    both ride the runtime's 'model' mesh axis, so at most one of them
    may exceed 1; ``microbatch`` is sequential gradient-accumulation
    chunks for the dense families and the GPipe microbatch count for
    the pipeline family; ``zero`` is the ZeRO stage 0-3 (1 = sharded
    optimizer state, 2 = + sharded gradients, 3 = + sharded params —
    train/zero.py)."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipeline: int = 1
    zero: int = 0
    microbatch: int = 1
    remat: bool = False

    def __post_init__(self):
        for f in ("data", "model", "seq", "pipeline", "microbatch"):
            if getattr(self, f) < 1:
                raise ValueError(f"plan.{f} must be >= 1, got "
                                 f"{getattr(self, f)}")
        if self.zero not in (0, 1, 2, 3):
            raise ValueError(f"plan.zero must be a ZeRO stage in "
                             f"0..3, got {self.zero}")
        if self.model > 1 and self.pipeline > 1:
            raise ValueError(
                "plan.model and plan.pipeline both ride the 'model' mesh "
                "axis — at most one may exceed 1")

    @property
    def model_axis_size(self) -> int:
        """Size of the runtime's 'model' mesh axis (tensor ways or
        pipeline stages — one of the two is 1)."""
        return self.model * self.pipeline

    @property
    def num_devices(self) -> int:
        return self.data * self.seq * self.model_axis_size

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown plan fields {sorted(unknown)}; "
                             f"have {sorted(known)}")
        return cls(**d)

    def describe(self) -> str:
        parts = [f"dp={self.data}"]
        if self.model > 1:
            parts.append(f"tp={self.model}")
        if self.seq > 1:
            parts.append(f"sp={self.seq}")
        if self.pipeline > 1:
            parts.append(f"pp={self.pipeline}")
        if self.zero:
            parts.append(f"zero{self.zero}")
        if self.microbatch > 1:
            parts.append(f"micro={self.microbatch}")
        if self.remat:
            parts.append("remat")
        return "×".join(parts[:1]) + ("," + ",".join(parts[1:])
                                      if parts[1:] else "")


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Prediction for one plan: seconds per step, peak per-device
    bytes, feasibility against the HBM budget, and the breakdown the
    CLI prints."""

    step_time_s: float
    peak_bytes: int
    hbm_budget_bytes: int
    compute_s: float
    comm_s: float
    breakdown: Dict[str, float]

    @property
    def feasible(self) -> bool:
        return self.peak_bytes <= self.hbm_budget_bytes

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["feasible"] = self.feasible
        return d


def check_plan(plan: Plan, stats: ModelStats, mesh: MeshSpec,
               global_batch: int) -> List[str]:
    """Hard-constraint violations of a plan for this workload/mesh —
    divisibility and capability rules mirroring what cli/runner.py and
    train/loop.py enforce at run construction.  Empty list = the plan
    compiles (memory feasibility is predict()'s separate verdict)."""
    v: List[str] = []
    if plan.num_devices != mesh.num_devices:
        v.append(f"plan uses {plan.num_devices} devices, mesh has "
                 f"{mesh.num_devices}")
    if plan.model > 1:
        if not stats.supports_tp:
            v.append(f"{stats.model}: tensor parallelism needs the plain "
                     f"transformer family")
        else:
            if stats.num_heads % plan.model:
                v.append(f"num_heads {stats.num_heads} % tp {plan.model}")
            if stats.d_ff % plan.model:
                v.append(f"d_ff {stats.d_ff} % tp {plan.model}")
    if plan.seq > 1:
        if not stats.supports_seq:
            v.append(f"{stats.model}: sequence parallelism needs the "
                     f"transformer family on token data")
        elif stats.seq_len % plan.seq:
            v.append(f"seq_len {stats.seq_len} % sp {plan.seq}")
    if plan.pipeline > 1:
        if not stats.supports_pipeline:
            v.append(f"{stats.model}: pipeline stages need the "
                     f"pipeline_transformer family")
        elif stats.num_layers % plan.pipeline:
            v.append(f"num_layers {stats.num_layers} % pp {plan.pipeline}")
    if plan.remat and not stats.supports_remat:
        v.append(f"{stats.model}: no remat policy for this family")
    if global_batch % plan.data:
        v.append(f"global batch {global_batch} % dp {plan.data}")
    else:
        per_replica = global_batch // plan.data
        if per_replica % plan.microbatch:
            v.append(f"per-replica batch {per_replica} % microbatch "
                     f"{plan.microbatch}")
    return v


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def _axis_bw(mesh: MeshSpec, plan: Plan, axis: str) -> float:
    """Ring bandwidth for one mesh axis under the runtime's row-major
    ('data','seq','model') layout: 'model' is innermost (stride 1),
    'seq' strides over it, 'data' is outermost."""
    m = plan.model_axis_size
    stride, size = {
        "model": (1, m),
        "seq": (m, plan.seq),
        "data": (m * plan.seq, plan.data),
    }[axis]
    return mesh.axis_bandwidth(stride, size)


def _ring_s(bytes_: float, ways: int, bw: float) -> float:
    """Ring allreduce wall time: 2·(n-1)/n of the buffer crosses each
    device's link (reduce-scatter + all-gather halves)."""
    if ways <= 1 or bytes_ <= 0:
        return 0.0
    return 2.0 * (ways - 1) / ways * bytes_ / bw


def predict(plan: Plan, stats: ModelStats, mesh: MeshSpec,
            global_batch: int, optimizer: str = "sgd",
            hbm_fraction: float = HBM_FRACTION,
            device_flops: Optional[float] = None,
            overlap_frac: float = DEFAULT_OVERLAP_FRAC) -> PlanCost:
    """Predicted (step time, peak memory) for a valid plan.

    ``device_flops`` overrides the mesh's achievable-FLOP/s estimate —
    the calibration loop passes the measured probe here.
    ``overlap_frac`` is the fraction of compute the ZeRO-2/3 per-leaf
    collectives may hide behind (stages 0/1 sync monolithically and
    get no credit).  Call :func:`check_plan` first; predicting an
    invalid plan still returns numbers, they just describe a run the
    framework would refuse."""
    if not 0.0 <= overlap_frac <= 1.0:
        raise ValueError(f"overlap_frac must be in [0, 1], got "
                         f"{overlap_frac}")
    flops_dev = device_flops or mesh.device_flops
    slots = OPTIMIZER_SLOTS.get(optimizer)
    if slots is None:
        raise ValueError(f"unknown optimizer {optimizer!r}; have "
                         f"{sorted(OPTIMIZER_SLOTS)}")
    mp, pp, sp, dp = plan.model, plan.pipeline, plan.seq, plan.data
    micro_examples = max(global_batch // (dp * plan.microbatch), 1)

    # ---- parameters / gradients / optimizer state (f32) --------------
    param_local = 0.0
    max_layer_param = 0.0  # largest single layer's local params
    fwd_flops = 0.0       # per example, whole model
    remat_refwd = 0.0     # extra forward FLOPs per example under remat
    act_local = 0.0       # per-device activation bytes, one microbatch
    max_block_act = 0.0   # live working set of the block being remat'd
    boundary_bytes = stats.seq_len * stats.d_model * stats.dtype_bytes \
        if stats.seq_len else 0
    for layer in stats.layers:
        p = float(layer.params)
        if layer.tp and mp > 1:
            p /= mp
        if layer.stage and pp > 1:
            p /= pp
        param_local += p
        max_layer_param = max(max_layer_param, p)
        fwd_flops += layer.flops
        la = float(layer.act_bytes)
        if mp > 1 and layer.act_tp_bytes:
            la -= layer.act_tp_bytes * (1.0 - 1.0 / mp)
        if plan.remat and layer.stage:
            remat_refwd += layer.flops
            la = float(layer.remat_act_bytes)
        if layer.stage and pp > 1:
            # this stage holds 1/pp of the stacked blocks...
            la /= pp
        la /= max(sp, 1)
        act_local += la
        if layer.stage:
            max_block_act = max(max_block_act,
                                float(layer.act_bytes) / max(sp, 1))
    param_bytes = param_local * 4
    # stage >= 2's sharded gradient ACCUMULATOR only exists when the
    # outer grad-accumulation scan runs (microbatch > 1, dense
    # families — the pipeline family's GPipe scan accumulates a full
    # grad tree internally): sliced 1/dp carry + one layer's transient
    # full grad (each leaf's reduce-scatter consumes it as the
    # backward emits it).  At microbatch=1 the emitted program
    # materializes the full grad tree exactly like stages 0/1 do, so
    # it is priced identically — two identical programs must not get
    # different predictions.
    if plan.zero >= 2 and plan.microbatch > 1 and pp == 1:
        grad_bytes = param_bytes / dp + max_layer_param * 4
    else:
        grad_bytes = param_bytes * (2 if plan.microbatch > 1 else 1)
    opt_bytes = slots * param_bytes / (dp if plan.zero else 1)
    if plan.zero == 3:
        # persistent copy sliced; the gathered working copy still
        # counted IN FULL — the per-leaf gathers live through the
        # backward in the emitted program (honest accounting: ZeRO-3's
        # win here is the grads + optimizer terms, and the sliced
        # persistent set between steps)
        param_term = param_bytes / dp + param_bytes
    else:
        param_term = param_bytes
    state_bytes = stats.state * 4

    act_bytes = act_local * micro_examples
    if plan.remat:
        # one block's full working set is live while it recomputes
        act_bytes += max_block_act * micro_examples
    if pp > 1:
        # GPipe stashes every in-flight microbatch's stage-boundary
        # activation for the backward pass
        act_bytes += (plan.microbatch * micro_examples
                      * boundary_bytes / max(sp, 1))

    peak = int(param_term + grad_bytes + opt_bytes + state_bytes
               + act_bytes + FIXED_OVERHEAD_BYTES)
    budget = int(mesh.hbm_bytes * hbm_fraction)

    # ---- compute ------------------------------------------------------
    # fwd + backward(≈2× MACs) + remat re-forward, ideal scaling over
    # every mesh axis (TP/SP/PP all divide the per-example work)
    flops_step = (3.0 * fwd_flops
                  + (remat_refwd if plan.remat else 0.0)) * global_batch
    compute_s = flops_step / plan.num_devices / flops_dev
    bubble = ((plan.microbatch + pp - 1) / plan.microbatch if pp > 1
              else 1.0)
    compute_s *= bubble

    # ---- collectives --------------------------------------------------
    breakdown: Dict[str, float] = {}
    if plan.zero >= 2:
        # one reduce-scatter per microbatch (the pipeline family's
        # grads arrive once from the GPipe scan, so it scatters once)
        # + one param all-gather, each a HALF allreduce; at m=1 the
        # volume equals the stage-0/1 ring allreduce
        scatters = plan.microbatch if pp == 1 else 1
        halves = (scatters + 1) / 2.0
        t_grad = halves * _ring_s(param_local * 4, dp,
                                  _axis_bw(mesh, plan, "data"))
        t_grad += halves * _ring_s(param_local * 4, sp,
                                   _axis_bw(mesh, plan, "seq"))
    else:
        t_grad = _ring_s(param_local * 4, dp, _axis_bw(mesh, plan, "data"))
        t_grad += _ring_s(param_local * 4, sp, _axis_bw(mesh, plan, "seq"))
    breakdown["grad_sync_s"] = t_grad
    # compute/comm overlap: credit only the collectives whose SCHEDULE
    # differs from the monolithic end-of-step sync.  Of stage >= 2's
    # (scatters + 1) half-collectives, the per-microbatch scatters
    # EXCEPT THE LAST interleave with the following chunk's compute,
    # and stage 3's pre-compute param gather interleaves with the
    # forward; the final scatter (and stage 2's post-update gather)
    # stay exposed.  At m=1 stage 2 therefore earns NO credit — it
    # emits the same program as stage 1 and must be priced like it.
    hidden = 0.0
    ov_share = 0.0
    if plan.zero >= 2:
        scatters = plan.microbatch if pp == 1 else 1
        ov_halves = (scatters - 1) + (1 if plan.zero == 3 else 0)
        ov_share = ov_halves / (scatters + 1)
    if ov_share > 0 and overlap_frac > 0:
        hidden = min(ov_share * t_grad, overlap_frac * compute_s)
    t_grad_exposed = t_grad - hidden
    breakdown["hidden_comm_s"] = hidden
    breakdown["overlap_frac"] = overlap_frac if ov_share > 0 else 0.0

    t_tp = 0.0
    if mp > 1:
        stream = (global_batch // dp) * (stats.seq_len / max(sp, 1)) \
            * stats.d_model * stats.dtype_bytes
        n_blocks = sum(1 for l in stats.layers if l.stage)
        t_tp = _ring_s(4.0 * n_blocks * stream, mp,
                       _axis_bw(mesh, plan, "model"))
    breakdown["tp_psum_s"] = t_tp

    t_ring = 0.0
    if sp > 1:
        # ring attention: (sp-1) neighbor hops of the local K+V per
        # block, forward and backward
        n_blocks = sum(1 for l in stats.layers if l.stage)
        kv_local = 2.0 * (stats.seq_len / sp) * stats.d_model \
            * stats.dtype_bytes * (global_batch // dp)
        t_ring = (2.0 * n_blocks * (sp - 1) * kv_local
                  / _axis_bw(mesh, plan, "seq"))
    breakdown["seq_ring_s"] = t_ring

    t_pipe = 0.0
    if pp > 1:
        t_pipe = (2.0 * plan.microbatch * micro_examples * boundary_bytes
                  / _axis_bw(mesh, plan, "model"))
    breakdown["pipeline_xfer_s"] = t_pipe

    comm_s = t_grad_exposed + t_tp + t_ring + t_pipe
    breakdown.update(
        compute_s=compute_s, bubble_factor=bubble,
        exposed_comm_s=comm_s,
        param_bytes=param_bytes, param_term_bytes=param_term,
        grad_bytes=grad_bytes,
        opt_bytes=opt_bytes, act_bytes=act_bytes)
    return PlanCost(step_time_s=compute_s + comm_s, peak_bytes=peak,
                    hbm_budget_bytes=budget, compute_s=compute_s,
                    comm_s=comm_s, breakdown=breakdown)
