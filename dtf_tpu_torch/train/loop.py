"""The training and eval loop -- the PyTorch counterpart of
``dtf_tpu/train/loop.py`` ``Trainer``, on one device a process, the
replicas of a data-parallel run being processes
(``runtime/mesh.py``).

``train_step`` is the JAX step's arithmetic in eager PyTorch, on this
replica's share of the global batch:
  - the inputs first: an NCHW batch (``--data_format channels_first``)
    transposed to NHWC, then the uint8 wire's normalization
    (``normalize_fn``, ``data/normalize.py``) on the device;
  - cross-entropy (the mean over positions, on float32 logits) plus the
    model's L2 term;
  - ``grad_accum_steps`` sequential micro-batches, their gradients
    summed into the float32 ``.grad`` of the float32 parameters and
    divided by the count; a BatchNorm model's running statistics are
    module buffers, moved by each micro-batch in order in train mode,
    as the JAX scan threads ``batch_stats``;
  - static loss scaling (``--loss_scale N``) or dynamic scaling with TF2
    LossScaleOptimizer semantics: a step whose gradients are not all
    finite is skipped (parameters, optimizer state and BN buffers kept)
    and the scale halved (not below 1); the scale doubles after
    ``DYNAMIC_GROWTH_INTERVAL`` finite steps in a row;
  - data parallelism, in the JAX step's order: the unscaled gradients,
    the BN running statistics and the step's loss and accuracy are
    averaged over the replicas in one all-reduce of a flat float32
    buffer (one writer, a fixed order: every rank ends the step with
    the same bits); the global norm is clipped after it; a dynamic
    scale's finite verdict is the replicas' minimum;
  - global-norm clipping (``--clip_grad_norm``);
  - the optimizer update at ``schedule(state.step)``; the metrics
    ``loss``, ``learning_rate`` and ``accuracy`` (0-d device tensors,
    read only at log cadence).
``evaluate`` runs the model in eval mode (BN on its running statistics)
and takes masked sums, so a padded last batch counts each real example
once; the replicas' sums are added.  ``fit`` runs the reference's
``TimeHistory`` cadence: it reads the loss from the device at every log
boundary -- a sync, so the logged time is the device's and not the
enqueue's -- before the BenchmarkMetric line is written.

Around each step ``fit`` does what the JAX loop does: it starts at the
state's step (a resumed run continues mid-epoch at batch step %
steps_per_epoch; its data stream is positioned by the runner), emits a
``train_loss`` event with the loss's exact float at each log step (the
crash-exactness checks compare these), ``step``/``eval`` spans and
``log_window`` spans (``obs/trace.py``), runs the NaN-loss and
step-time watchdogs and the launcher's heartbeat (``obs/watchdog.py``),
calls the chaos probe after the interval checkpoint of a boundary is
sealed, and honours the preemption latch (``train/preemption.py``):
the callbacks' ``on_preempt`` (the emergency checkpoint), a
``preempted`` event, then ``Preempted``.  Under data parallelism the
replicas must stop at the same boundary: each step's all-reduce carries
the rank's latch, and every rank acts on the previous step's reduced
flag (read one step late, so reading it never idles the device).
``checkpoint_payload`` and ``restore_state`` carry the TrainState to
and from the checkpoint's flat flax-keyed payload (``convert.py``).

Initialization is seed-synced: every replica draws the same weights from
``--seed`` (horovod's broadcast, as the JAX package does it).  Logs come
from the coordinator (rank 0) only.

``--stop_threshold`` ends training after the first eval whose top-1
reaches it, and ``--profile_steps "start,stop"`` runs ``torch.profiler``
over that range of steps (:class:`StepProfiler`).

The MFU ledger (``obs/ledger.py``) registers ``train_step`` once: the
first step of a ``fit`` runs under the FLOP counter (aten FLOPs plus
the attention kernels' own counts), and every clean log window feeds
its synced per-step wall time; the summary goes to the trace at the
end and into the stats as ``ledger``.  ``DTF_LEDGER=0`` turns it off,
as in the JAX loop.

ZeRO (``--zero_stage``, ``--optimizer_sharding``; ``train/zero.py``
has the layout) shards the weight update over the data axis, each
parameter leaf cut into nd padded flat slices, rank r holding slice r:
  - stage 1 keeps the flat all-reduce above, then updates this rank's
    slices of the parameters with its slices of the optimizer state and
    all-gathers the parameters back;
  - stage 2 reduce-scatters each micro-batch's gradients into float32
    slices (``--zero_wire bf16``: the wire and its sum in bf16) and
    accumulates them in slices; the BN buffers, loss, accuracy and latch
    still ride one flat all-reduce;
  - stage 3 also keeps the parameters as slices: it all-gathers them
    into the model at the start of each step (and of an eval) and frees
    the full tensors once the gradients are in slices, before the
    update.
Clipping's global norm sums the slices' squares over the group; a
dynamic scale's finite verdict counts non-finite slices over the group.
The padding stays zero under AdamW and the Keras SGD.  Checkpoints
always hold the stage-0 payload (:meth:`Trainer.canonical_state`), and a
restore re-slices it into the run's own stage and world
(:meth:`Trainer.staged_state`), so a checkpoint holds no topology.
``--zero_probe`` times, after training and on copies of the state, the
step and its twin with the ZeRO collectives stubbed out, in turns: the
step minus its twin is the exposed communication.  Each step records
what the rank holds at its update -- the parameters, the gradient the
update reads and the optimizer state, and on the card the allocator's
count (:meth:`Trainer.zero_resident_bytes`).  At two ranks each stage's
losses are stage 0's bit for bit: a sum of two values does not depend
on their order.

Tensor parallelism (``--model_parallelism``; ``runtime/mesh.py`` has
the grid): the model is this rank's shard (``models/transformer.py``),
and the step reduces over the right axis of each thing:
  - gradients, BN buffers, loss and accuracy average over the data
    group only (a replicated leaf's gradient is the same on every model
    rank, thanks to ``tp_region``; a sharded one must not be averaged
    with another shard's);
  - the preemption latch, after riding the data all-reduce, is spread
    over the model group, and a dynamic scale's finite verdict is
    counted over every rank, so the shards of a replica stop, skip or
    step together -- one left waiting in a ``tp_psum`` would hang;
  - clipping's global norm sums the sharded leaves' squares over the
    model group and counts each replicated leaf once (the L2 term
    likewise, ``models/registry.py``);
  - ``--shard_lm_head``: the logits are a vocabulary shard and the loss
    is the collective softmax cross-entropy
    (:func:`sharded_cross_entropy`), the accuracy the sharded argmax.
ZeRO composes: each rank slices its *local* shard over the data group
(the JAX layout: each (data, model) coordinate owns one slice of its
model shard).  The checkpoint's canonical payload is the full model's:
gathered over the data group, then over the model group through the
partition rule, so a step restores at another mp, stage or world and
serves at any ``--serve_tp``.

Sequence parallelism (``--seq_parallelism``; ``runtime/mesh.py``'s
seq axis): a sequence model's attention is ring attention over the seq
group (``models/transformer.py set_seq_group``), and each seq rank
trains on its columns of the replica's batch (``cli/runner.py``).  The
batch is split over data x seq, so gradients, BN buffers, the loss, the
accuracy and the latch average over ``reduce_group`` (the JAX
``reduce_axes``), and the eval sums too; the latch then spreads over the
model group, so it reaches the whole grid.  Parameters and ZeRO slices
are replicated over seq: the slices are cut over the data group alone,
a stage-2/3 gradient is reduce-scattered over it and then averaged over
the seq group (``train/zero.py``), and the global norm of slices sums
over ``slice_group`` (data x model), so no seq rank's copy counts twice.

Pipeline parallelism (the pipeline_transformer family at
``--model_parallelism`` pp > 1; ``models/pipeline_lm.py``) rides the
same model axis: the model is the rank's pipeline stage, its
``split`` names the stacked leaves' layer dimension, and the machinery
above applies unchanged.  The replicated leaves (embedding, positions,
final norm, head) get the same gradient on every stage by construction
and reduce over the data (x seq) group alone; clipping's global norm
sums the stacked leaves' squares over the model group; ZeRO slices each
stage-local stack over the data group; eval runs the pipeline's forward
under no_grad; the checkpoint gathers the stacks to the full [L, ...]
leaves, so a step resumes at another pp.

Expert parallelism (the moe_transformer family, ``models/moe.py``):
the training objective adds the MoE layers' load-balance terms of the
step's forward (``model.aux_loss()``; the JAX package's sown
``aux_loss`` collection), and the reported loss carries them.  Under
``--model_parallelism`` the experts ride the model axis and the tensor
parallelism above carries them unchanged.  Otherwise they ride the data
axis, each data rank holding E / dp of them (``self.ep``), and their
leaves are reduced as the JAX Trainer reduces a leaf sharded over a
batch axis:
  - their gradients stay out of the flat mean: reverse-mode all_to_all
    has already summed each one over the data group, so it is averaged
    over the seq group (under sequence parallelism) and divided by dp;
  - clipping's global norm sums their squares over the data group;
  - ZeRO keeps them at their local shape at every stage
    (``train/zero.py``): neither sliced nor gathered, divided rather
    than reduce-scattered;
  - the checkpoint gathers them over the data group into the full
    [E, ...] leaves, so a step resumes at another dp (a dp the experts
    do not divide is refused naming each leaf, ``cli/runner.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import signal
import time
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dtf_tpu_torch import chaos
from dtf_tpu_torch.convert import state_from_flat, state_to_flat
from dtf_tpu_torch.data.base import DatasetSpec
from dtf_tpu_torch.models.registry import l2_weight_penalty
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.ledger import Ledger, count_flops
from dtf_tpu_torch.obs.watchdog import (Heartbeat, NanLossWatchdog,
                                        StepTimeWatchdog)
from dtf_tpu_torch.models import partition
from dtf_tpu_torch.parallel.collectives import (all_max, all_reduce_mean,
                                                all_reduce_sum, gather_dim,
                                                tp_psum)
from dtf_tpu_torch.runtime.mesh import MeshRuntime
from dtf_tpu_torch.train import elastic, preemption
from dtf_tpu_torch.train import zero as zero_lib
from dtf_tpu_torch.train import schedules as sched_lib
from dtf_tpu_torch.train.optimizer import (AdamWState, KerasSGDState,
                                           apply_updates, build_optimizer)
from dtf_tpu_torch.utils.logs import TimeHistory, build_stats

log = logging.getLogger("dtf_tpu_torch")

# TF2 LossScaleOptimizer dynamic defaults (the JAX package's values)
DYNAMIC_SCALE_INIT = 2.0 ** 15
DYNAMIC_GROWTH_INTERVAL = 2000


def _set_storage(p: torch.Tensor, t: torch.Tensor) -> None:
    """``p.data = t``, and the compute-dtype copy that
    ``models/transformer.py cast`` keeps on ``p`` dropped: a swap of
    ``.data`` keeps ``p``'s version counter, and the allocator may give
    the new storage the old one's address, so the copy's key would not
    see the change."""
    p.data = t
    p.__dict__.pop("_compute_copy", None)


@dataclasses.dataclass
class TrainState:
    step: int
    params: List[torch.Tensor]     # the model's own parameters, in place
    opt_state: Any
    # dynamic loss scaling only: the live scale and the count of
    # consecutive finite steps; None under static scaling
    loss_scale: Optional[float] = None
    good_steps: Optional[int] = None


def per_example_cross_entropy(logits, labels):
    """Un-reduced CE with integer labels -- one value per position."""
    return F.cross_entropy(logits.flatten(0, -2), labels.flatten().long(),
                           reduction="none").view(labels.shape)


def cross_entropy(logits, labels):
    """Mean CE with integer labels, in float32."""
    return F.cross_entropy(logits.flatten(0, -2).float(),
                           labels.flatten().long())


def sharded_per_example_cross_entropy(local_logits, labels, group):
    """Un-reduced CE over vocabulary-sharded logits (Megatron's
    vocab-parallel softmax): a collective logsumexp over the model
    group, the full vocabulary never on one rank.  The two sums are
    ``tp_psum`` (sum forward, identity backward), which gives exactly
    one loss replica's gradient; the max carries no gradient (it
    cancels)."""
    vloc = local_logits.shape[-1]
    offset = dist.get_rank(group) * vloc
    m = all_max(local_logits.detach().amax(-1).contiguous(), group)
    sumexp = tp_psum(torch.exp(local_logits - m[..., None]).sum(-1), group)
    lse = torch.log(sumexp) + m
    local = labels.long() - offset
    in_range = (local >= 0) & (local < vloc)
    picked = local_logits.gather(
        -1, local.clamp(0, vloc - 1)[..., None])[..., 0]
    correct = tp_psum(torch.where(in_range, picked,
                                  torch.zeros_like(picked)), group)
    return lse - correct


def sharded_cross_entropy(local_logits, labels, group):
    """Mean CE over vocabulary-sharded logits."""
    return sharded_per_example_cross_entropy(local_logits, labels,
                                             group).mean()


def sharded_argmax(local_logits, group):
    """The global argmax over vocabulary-sharded logits (metrics only,
    no gradient).  Ties go to the lowest global index, as an argmax of
    the whole logits picks: within a shard argmax picks the first, and
    across shards the minimum of the candidates does."""
    local_logits = local_logits.detach()
    vloc = local_logits.shape[-1]
    offset = dist.get_rank(group) * vloc
    local_max, local_arg = local_logits.max(-1)
    best = all_max(local_max.clone(), group)
    cand = torch.where(local_max == best, local_arg + offset,
                       torch.full_like(local_arg, torch.iinfo(
                           local_arg.dtype).max))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    return cand


class Trainer:
    """Runs the training and eval steps of one model replica.

    ``runtime`` is the replica's place on the data axis (``runtime/
    mesh.py initialize``); None is world 1 on the model's device."""

    def __init__(self, cfg, model, l2_weight: float, spec: DatasetSpec,
                 schedule: Optional[Callable] = None,
                 normalize_fn: Optional[Callable] = None,
                 runtime: Optional[MeshRuntime] = None):
        self.cfg = cfg
        self.model = model
        # what the card's allocator held before this run: its count now
        # less the model this run built (train_live_bytes is this
        # run's, whatever an earlier run in the process left allocated)
        self._alloc_base = self._allocated()
        if self._alloc_base is not None:
            self._alloc_base -= _allocator_bytes(model)
        self.rt = runtime or MeshRuntime(
            strategy=cfg.distribution_strategy,
            device=next(model.parameters()).device)
        self.l2_weight = l2_weight
        self.spec = spec
        # the uint8 wire's normalization (None: host-normalized batches)
        self.normalize_fn = normalize_fn
        self.channels_first = (cfg.data_format == "channels_first"
                               and not spec.is_sequence)
        # the global batch: the runner has already scaled a per-replica
        # --batch_size (horovod, parameter_server) by the replicas
        self.global_batch = cfg.batch_size
        replicas = self.rt.num_replicas
        if self.global_batch % replicas:
            raise ValueError(
                f"global batch_size {self.global_batch} must be divisible "
                f"by the number of data-parallel replicas ({replicas}); "
                f"pick a batch size that is a multiple, or reduce "
                f"--num_devices")
        self.grad_accum = max(int(cfg.grad_accum_steps or 1), 1)
        if (self.global_batch // replicas) % self.grad_accum:
            raise ValueError(
                f"per-replica batch {self.global_batch // replicas} must "
                f"be divisible by grad_accum_steps ({self.grad_accum})")
        sp = self.rt.seq_parallelism
        if spec.is_sequence and spec.seq_len % sp:
            raise ValueError(
                f"seq_len {spec.seq_len} must be divisible by "
                f"seq_parallelism ({sp})")
        self.steps_per_epoch = spec.num_train // self.global_batch
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch_size {self.global_batch} exceeds the training set "
                f"({spec.num_train} examples): zero steps per epoch")
        self.train_epochs = cfg.train_epochs
        if cfg.train_steps:
            # the reference mains: train_steps caps to 1 epoch of that length
            self.steps_per_epoch = min(cfg.train_steps, self.steps_per_epoch)
            self.train_epochs = 1
        if schedule is not None:
            self.schedule = schedule
        elif cfg.distribution_strategy == "horovod":
            # horovod's constant replica-scaled LR after a 3-epoch ramp
            self.schedule = sched_lib.horovod_schedule(
                replicas, max(self.steps_per_epoch, 1))
        else:
            self.schedule = sched_lib.for_dataset(
                spec.name, self.global_batch, max(self.steps_per_epoch, 1),
                spec.num_train, use_tensor_lr=cfg.use_tensor_lr,
                train_epochs=self.train_epochs)
        self.tx = build_optimizer(cfg.optimizer, self.schedule)
        self.dynamic_scale = cfg.loss_scale_value == "dynamic"
        self.loss_scale = (1.0 if self.dynamic_scale
                           else float(cfg.loss_scale_value))
        self.report_acc = cfg.report_accuracy_metrics
        # (step, loss) at every log boundary, and the synced per-step
        # time of every log window that covered steps only
        self.loss_log: list = []
        self.window_step_s: list = []
        # unmasked examples (tokens for sequence data) of the last eval
        self.eval_count = 0.0
        # the BN running statistics (the models' only buffers), which
        # the replicas average after each step
        self.bn_buffers = list(model.buffers())
        # the model's parameters, in place (stage 3 swaps their storage)
        self.params = list(model.parameters())
        # ZeRO (train/zero.py): the stage, the slice grid and this
        # rank's place on it, the reduce-scatter's wire
        self.zero_stage = cfg.zero_stage_effective
        self.zero = self.zero_stage >= 1
        self.zero_wire = zero_lib.wire_dtype(cfg.zero_wire)
        self.nd, self.idx = replicas, self.rt.data_index
        # tensor parallelism: the model axis, and each parameter's split
        # under the partition rule (None: replicated).  A model that is
        # not sharded (a vision model) is replicated over the model
        # axis, as in the JAX package
        mp = getattr(model, "model_parallelism", 1)
        if mp > 1 and mp != self.rt.model_parallelism:
            raise ValueError(
                f"the model is a shard of {mp}, the runtime's model axis "
                f"{self.rt.model_parallelism}")
        self.tp = mp > 1
        self.tp_group = self.rt.model_group if self.tp else None
        if self.tp:
            model.set_model_group(self.tp_group)
        self.vocab_group = (self.tp_group
                            if getattr(model, "shard_vocab", False) else None)
        # sequence parallelism: a sequence model's attention rides the
        # seq ring (a vision model's batch is replicated over seq)
        if spec.is_sequence and self.rt.seq_group is not None:
            model.set_seq_group(self.rt.seq_group)
        self._splits = [model.split(n) if self.tp else None
                        for n, _ in model.named_parameters()]
        # expert parallelism on the data axis: each data rank holds
        # distinct experts of the expert leaves (self._expert)
        if getattr(model, "expert_axis", None) == "data":
            if model.expert_parallelism != replicas:
                raise ValueError(
                    f"the model holds experts for {model.expert_parallelism}"
                    f" data ranks, the runtime's data axis {replicas}")
            model.set_expert_group(self.rt.data_group)
        self.ep = (getattr(model, "expert_axis", None) == "data"
                   and model.expert_parallelism > 1)
        self._expert = [self.ep and model.split(n) is not None
                        for n, _ in model.named_parameters()]
        # the MoE load-balance terms of a training forward
        self._aux_loss = getattr(model, "aux_loss", None)
        self._shapes = [tuple(p.shape) for p in self.params]
        self._channels_last = [
            p.dim() == 4 and not p.is_contiguous()
            and p.is_contiguous(memory_format=torch.channels_last)
            for p in self.params]
        # stage 3: whether the model holds its full parameters now
        self._materialized = True
        # --zero_probe's measurements, once taken
        self.zero_probe_result: Optional[dict] = None
        # what the last step held at its update (zero_resident_bytes)
        self._held: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init_state(self) -> TrainState:
        params = self.params
        scale = dict(
            loss_scale=DYNAMIC_SCALE_INIT if self.dynamic_scale else None,
            good_steps=0 if self.dynamic_scale else None)
        if not self.zero:
            return TrainState(step=0, params=params,
                              opt_state=self.tx.init(params), **scale)
        # the optimizer's state over this rank's slices, from zeros
        opt_state = self.tx.init([zero_lib.slice_zeros(p, self.nd, e)
                                  for p, e in zip(params, self._expert)])
        return self.staged_state(TrainState(step=0, params=params,
                                            opt_state=opt_state, **scale),
                                 sliced_opt=True)

    # ------------------------------------------------------------------
    # ZeRO's layouts.  A checkpoint always holds the stage-0 form --
    # full parameters and optimizer state -- so a checkpoint saved at any
    # stage restores into any other stage and world, and serves through
    # the bridge.  The conversions are per-leaf gathers and slices; the
    # padding is zeros in every supported optimizer's state, so dropping
    # it on save and re-creating it on restore is exact.
    # ------------------------------------------------------------------
    def _gather_params(self, slices, comm_off: bool = False) -> None:
        """Stage 3: the model's parameters from their slices."""
        group = self.rt.data_group
        with torch.no_grad():
            for p, s, shape, cl, e in zip(self.params, slices,
                                          self._shapes, self._channels_last,
                                          self._expert):
                full = zero_lib.gather_leaf(s, shape, s.dtype, self.nd,
                                            group, comm_off, e)
                if cl:
                    full = full.contiguous(memory_format=torch.channels_last)
                _set_storage(p, full)
        self._materialized = True

    def _free_params(self) -> None:
        """Stage 3: drop the model's full parameters (the slices in the
        TrainState are the parameters between steps)."""
        for p in self.params:
            _set_storage(p, p.data.new_empty((0,)))
        self._materialized = False

    def materialize(self, state: TrainState) -> None:
        """Stage 3: put the full parameters back into the model (every
        rank; a collective).  A no-op at other stages."""
        if self.zero_stage == 3 and not self._materialized:
            self._gather_params(state.params)

    @staticmethod
    def _opt_map(opt, fn):
        """``opt`` with ``fn(i, t)`` applied to each moment of leaf i."""
        if isinstance(opt, AdamWState):
            return AdamWState(count=opt.count,
                              mu=[fn(i, t) for i, t in enumerate(opt.mu)],
                              nu=[fn(i, t) for i, t in enumerate(opt.nu)])
        if isinstance(opt, KerasSGDState):
            return KerasSGDState(velocity=[fn(i, t) for i, t in
                                           enumerate(opt.velocity)])
        raise ValueError(f"no ZeRO layout for optimizer state "
                         f"{type(opt).__name__}")

    @staticmethod
    def moments(opt) -> List[torch.Tensor]:
        """The optimizer state's per-leaf tensors (AdamW's mu and nu, the
        Keras SGD velocity)."""
        if isinstance(opt, AdamWState):
            return list(opt.mu) + list(opt.nu)
        return list(opt.velocity)

    @property
    def collective_state(self) -> bool:
        """True when the checkpoint's canonical form is gathered from
        other ranks (ZeRO, tensor parallelism, experts on the data
        axis): every rank takes part in a save."""
        return self.zero or self.tp or self.ep

    def canonical_state(self, state: TrainState) -> TrainState:
        """The stage-0 (checkpoint) form of a live TrainState: full
        parameters and optimizer state -- gathered over the data group
        (ZeRO), then over the model group (tensor parallelism) or, for
        an expert leaf on the data axis, the data group, where the
        parameters are no longer the model's.  Identity without any of
        these; a collective under them, which every rank calls."""
        if not self.collective_state:
            return state
        group = self.rt.data_group

        def gather(i, s):
            if self.zero:
                s = zero_lib.gather_leaf(s, self._shapes[i], s.dtype,
                                         self.nd, group,
                                         expert=self._expert[i])
            return self._gather_model(i, s)

        if self.zero_stage == 3:
            params = [gather(i, s) for i, s in enumerate(state.params)]
        else:
            params = [self._gather_model(i, p.detach())
                      for i, p in enumerate(self.params)]
        return dataclasses.replace(
            state, params=params,
            opt_state=self._opt_map(state.opt_state, gather))

    def _gather_model(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of leaf ``i`` from the model group's shards
        (the partition rule's split), or an expert leaf's from the data
        group's experts; ``t`` itself when replicated."""
        if self._expert[i]:
            return gather_dim(t, 0, self.rt.data_group)
        split = self._splits[i]
        if split is None:
            return t
        parts = gather_dim(t.unsqueeze(0), 0, self.tp_group)
        return partition.unshard(list(parts), split)

    def _full_shape(self, i: int) -> tuple:
        """The full model's shape of leaf ``i`` (this rank holds a model
        shard of a split leaf)."""
        shape = list(self._shapes[i])
        split = self._splits[i]
        if split is not None:
            shape[split.dim] *= self.rt.model_parallelism
        return tuple(shape)

    def staged_state(self, canonical: TrainState,
                     sliced_opt: bool = False) -> TrainState:
        """A canonical TrainState (whose parameters are the model's,
        loaded) placed into this run's stage: the optimizer state cut
        into this rank's slices (unless ``sliced_opt``), and at stage 3
        the parameters too, the model's full tensors freed.  A world the
        model cannot shard onto (an elastic resume's) is refused first,
        naming the leaves."""
        names = [n for n, _ in self.model.named_parameters()]
        mp = self.rt.model_parallelism if self.tp else 1
        problems = elastic.check_reshardable(
            dict(zip(names, self._splits)),
            {n: self._full_shape(i) for i, n in enumerate(names)},
            {"data": self.nd, "model": mp})
        if problems:
            raise ValueError(
                "model cannot shard onto this world (an elastic resume "
                "must refuse, not garble): " + "; ".join(problems))
        if not self.zero:
            return canonical
        opt = canonical.opt_state
        if not sliced_opt:
            opt = self._opt_map(opt, lambda i, t: zero_lib.slice_leaf(
                t, self.nd, self.idx, self._expert[i]))
        params = canonical.params
        if self.zero_stage == 3:
            params = [zero_lib.slice_leaf(p.detach(), self.nd, self.idx, e)
                      for p, e in zip(self.params, self._expert)]
            self._free_params()
        return dataclasses.replace(canonical, params=params, opt_state=opt)

    def checkpoint_payload(self, state: TrainState) -> dict:
        """The checkpoint payload of ``state``: the JAX TrainState's
        leaves keyed by flax path, as CPU tensors, in the stage-0 layout
        of the full model whatever the run's ZeRO stage and model
        parallelism (a collective under either)."""
        return state_to_flat(self.model, self.canonical_state(state))

    def inference_flat(self, state: TrainState) -> dict:
        """The full model's inference variables (``--export_dir``), flat
        and flax-keyed (a collective under ZeRO-3 or tensor
        parallelism)."""
        flat = self.checkpoint_payload(state)
        return {k: v for k, v in flat.items()
                if k.split("/")[0] in ("params", "batch_stats")}

    def restore_state(self, payload: dict) -> TrainState:
        """Load a checkpoint payload into the model (in place) and
        return its TrainState, the optimizer's moments on the device,
        placed into this run's ZeRO stage."""
        if not self.zero:
            return state_from_flat(payload, self.model)
        self._check_canonical(payload)
        if not self._materialized:
            with torch.no_grad():
                for p, shape in zip(self.params, self._shapes):
                    _set_storage(p, p.data.new_empty(shape))
            self._materialized = True
        return self.staged_state(state_from_flat(payload, self.model))

    def _check_canonical(self, payload: dict) -> None:
        """A payload that verified but cannot be placed into this run's
        layout (another optimizer's state) raises."""
        want = ("opt_state/adam/count" if self.cfg.optimizer == "adamw"
                else "opt_state/velocity/")
        if not any(k.startswith(want) for k in payload):
            have = sorted({k.split("/")[1] for k in payload
                           if k.startswith("opt_state/")})
            raise ValueError(
                f"checkpoint does not fit the canonical ZeRO checkpoint "
                f"layout of this run: optimizer {self.cfg.optimizer!r} "
                f"needs {want!r}, the payload holds opt_state {have}")

    # ------------------------------------------------------------------
    def _clip(self, grads):
        clip = self.cfg.clip_grad_norm
        if not clip:
            return grads
        norm = self._sumsq(grads, self.tp_group).sqrt()
        factor = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        return [g * factor for g in grads]

    def _sumsq(self, tensors, sharded_group, replicated_group=None):
        """The global sum of squares of per-leaf tensors: the sharded
        leaves' summed over ``sharded_group``, the replicated leaves'
        over ``replicated_group`` (None: this rank's alone), and the
        expert leaves on the data axis over the data group."""
        parts = {"replicated": [], "sharded": [], "expert": []}
        for t, split, e in zip(tensors, self._splits, self._expert):
            kind = ("expert" if e else "sharded" if split is not None
                    else "replicated")
            parts[kind].append(t.float().square().sum())
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for kind, group in (("replicated", replicated_group),
                            ("sharded", sharded_group),
                            ("expert", self.rt.data_group)):
            if parts[kind]:
                ss = torch.stack(parts[kind]).sum()
                total = total + all_reduce_sum(ss, group)
        return total

    def _all_reduce_step(self, grads, loss, acc):
        """The replicas' mean of the gradients, the BN running
        statistics (written back into the buffers), the step's loss and
        accuracy and the ranks' preemption latch (nonzero when any rank
        latched a signal), through one all-reduce of a flat float32
        buffer.  Returns (grads, loss, acc, preempt)."""
        latched = float(preemption.triggered() is not None)
        # a fill on the device: a scalar copied from the host would
        # synchronize the stream in the middle of the step
        tail = torch.stack([torch.as_tensor(loss, dtype=torch.float32,
                                            device=self.device),
                            torch.as_tensor(acc, dtype=torch.float32,
                                            device=self.device),
                            torch.full((), latched, dtype=torch.float32,
                                       device=self.device)])
        # an expert leaf on the data axis stays out of the mean (the
        # module's docstring): averaged over the seq group, divided by dp
        experts = [all_reduce_mean(g, self.rt.seq_group) / self.nd
                   for g, e in zip(grads, self._expert) if e]
        grads = [g for g, e in zip(grads, self._expert) if not e]
        parts = grads + self.bn_buffers + [tail]
        flat = all_reduce_mean(
            torch.cat([t.reshape(-1).float() for t in parts]),
            self.rt.reduce_group)
        views = [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in parts]), parts)]
        n = len(grads)
        with torch.no_grad():
            for b, v in zip(self.bn_buffers, views[n:-1]):
                b.copy_(v)
        # the tail copied out: a view would keep the whole flat buffer
        # alive for as long as the step's metrics are
        tail = views[-1].clone()
        # the latch reaches the other model ranks too: the whole grid,
        # set (1) when any rank latched, as the JAX psum's bool
        latch = all_max((tail[2:] > 0).float(), self.rt.model_group)[0]
        reduced, views = views[:n], iter(views[:n])
        if experts:
            experts = iter(experts)
            reduced = [next(experts) if e else next(views)
                       for e in self._expert]
        return reduced, tail[0], tail[1], latch

    def _inputs(self, images):
        """The batch as the model takes it: NHWC, normalized."""
        if self.channels_first:
            images = images.permute(0, 2, 3, 1)
        if self.normalize_fn is not None:
            images = self.normalize_fn(images)
        return images

    def _grads(self):
        return [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                else p.grad for p in self.params]

    def _scatter(self, grads, comm_off: bool):
        return [zero_lib.scatter_leaf(g, self.nd, self.rt.data_group,
                                      comm_off, self.idx, self.zero_wire,
                                      self.rt.seq_group, e)
                for g, e in zip(grads, self._expert)]

    def _clip_slices(self, slices):
        """Clipping to the global norm of the gradient held in slices:
        the slices' squares summed over the data group, and a sharded
        leaf's over the model group too (the slice group: a seq rank's
        slices are its ring peers')."""
        clip = self.cfg.clip_grad_norm
        if not clip:
            return slices
        norm = self._sumsq(slices, self.rt.slice_group,
                           self.rt.data_group).sqrt()
        factor = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        return [s * factor for s in slices]

    def train_step(self, state: TrainState, images, labels,
                   comm_off: bool = False):
        """One optimizer step on the batch (images, labels) -- device
        tensors; returns (new state, metrics).  ``comm_off``: the
        ``--zero_probe`` twin, its ZeRO collectives stubbed (garbage
        results, never state)."""
        model = self.model
        model.train()
        images = self._inputs(images)
        scale = state.loss_scale if self.dynamic_scale else self.loss_scale
        unscale = self.dynamic_scale or scale != 1.0
        stage = self.zero_stage
        # what the rank holds between steps: the state alone
        between = self._allocated()
        if stage == 3:
            self._gather_params(state.params, comm_off)
        params = self.params
        # a skipped step keeps the BN running statistics too
        buffers = list(model.buffers()) if self.dynamic_scale else []
        kept = [b.clone() for b in buffers]
        for p in params:
            p.grad = None
        loss_sum = acc_sum = 0.0
        # stages 2-3 with micro-batches: each one's gradients scattered
        # into the float32 slices of the accumulation carry
        carry = None
        per_chunk = stage >= 2 and self.grad_accum > 1
        for imgs, lbls in zip(images.chunk(self.grad_accum),
                              labels.chunk(self.grad_accum)):
            logits = model(imgs)
            loss = (self._cross_entropy(logits, lbls)
                    + l2_weight_penalty(model, self.l2_weight))
            if self._aux_loss is not None:
                loss = loss + self._aux_loss()
            (loss * scale).backward()
            loss_sum = loss_sum + loss.detach()
            if self.report_acc:
                acc_sum = acc_sum + (self._argmax(logits)
                                     == lbls).float().mean()
            del logits, loss
            if per_chunk:
                part = self._scatter(self._grads(), comm_off)
                carry = part if carry is None else [
                    a + b for a, b in zip(carry, part)]
                for p in params:
                    p.grad = None
        step_loss = loss_sum / self.grad_accum
        step_acc = acc_sum / self.grad_accum
        slices = None
        if per_chunk:
            slices = [s / self.grad_accum for s in carry]
            if unscale:
                slices = [s / scale for s in slices]
            grads = []
        else:
            grads = self._grads()
            if self.grad_accum > 1:
                grads = [g / self.grad_accum for g in grads]
            if unscale:
                grads = [g / scale for g in grads]
            if stage >= 2:
                slices, grads = self._scatter(grads, comm_off), []
        for p in params:
            p.grad = None
        if stage == 3:
            # the update reads the slices alone
            self._free_params()
        preempt = None
        if self.rt.group is not None:
            # stages 2-3: the BN buffers, loss, accuracy and latch alone
            grads, step_loss, step_acc, preempt = self._all_reduce_step(
                grads, step_loss, step_acc)
        # the gradient this rank holds at its update: at stage 1 the
        # replicas' full mean, which its slices view
        held_grads = slices if stage >= 2 else grads
        if stage == 1:
            slices = [zero_lib.slice_view(g, self.nd, self.idx, e)
                      for g, e in zip(grads, self._expert)]
        if self.zero:
            grads = slices = self._clip_slices(slices)
        else:
            grads = self._clip(grads)

        new_scale, new_good = state.loss_scale, state.good_steps
        finite = True
        if self.dynamic_scale:
            # one host sync per step: the verdict decides the update;
            # every replica must reach the same one
            bad = (~torch.stack([torch.isfinite(g).all()
                                 for g in grads])).sum().float()
            finite = not bool(all_reduce_sum(bad, self.rt.group))
            grew = state.good_steps + 1 >= DYNAMIC_GROWTH_INTERVAL
            if finite:
                new_scale = scale * 2.0 if grew else scale
                new_good = 0 if grew else state.good_steps + 1
            else:
                new_scale, new_good = max(scale * 0.5, 1.0), 0
        opt_state = state.opt_state
        self._held = dict(self._held_bytes(state, held_grads),
                          allocated_between_steps=between)
        if finite and not self.zero:
            updates, opt_state = self.tx.update(grads, state.opt_state,
                                                state.params,
                                                step=state.step)
            apply_updates(state.params, updates)
        elif finite:
            # this rank's slices updated with its slices of the state
            p_slices = (state.params if stage == 3 else
                        [zero_lib.slice_leaf(p.detach(), self.nd, self.idx, e)
                         for p, e in zip(params, self._expert)])
            updates, opt_state = self.tx.update(slices, state.opt_state,
                                                p_slices, step=state.step)
            apply_updates(p_slices, updates)
            if stage < 3:
                with torch.no_grad():
                    for p, s, e in zip(params, p_slices, self._expert):
                        p.copy_(zero_lib.gather_leaf(
                            s, p.shape, p.dtype, self.nd,
                            self.rt.data_group, comm_off, e))
        else:
            with torch.no_grad():
                for b, k in zip(buffers, kept):
                    b.copy_(k)
        metrics = {"loss": step_loss,
                   "learning_rate": float(self.schedule(state.step))}
        if self.report_acc:
            metrics["accuracy"] = step_acc
        if self.dynamic_scale:
            metrics["loss_scale"] = new_scale
        if preempt is not None:
            metrics["preempt"] = preempt
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state, loss_scale=new_scale,
                          good_steps=new_good), metrics

    def _cross_entropy(self, logits, labels):
        if self.vocab_group is not None:
            return sharded_cross_entropy(logits, labels, self.vocab_group)
        return cross_entropy(logits, labels)

    def _per_example_cross_entropy(self, logits, labels):
        if self.vocab_group is not None:
            return sharded_per_example_cross_entropy(logits, labels,
                                                     self.vocab_group)
        return per_example_cross_entropy(logits, labels)

    def _argmax(self, logits):
        if self.vocab_group is not None:
            return sharded_argmax(logits, self.vocab_group)
        return logits.detach().argmax(-1)

    def _allocated(self) -> Optional[int]:
        """The CUDA allocator's bytes in use on this rank's card (None
        on the CPU)."""
        dev = self.device
        if dev.type != "cuda":
            return None
        return torch.cuda.memory_allocated(dev)

    def _held_bytes(self, state: TrainState, grads) -> dict:
        """What the rank holds at the update, counted from the tensors:
        its parameters (full in the model, and stage 3's slices), the
        gradient ``grads`` the update reads, and the optimizer state;
        on the card the allocator's count beside."""
        params = zero_lib.nbytes(self.params)
        if self.zero_stage == 3:
            params += zero_lib.nbytes(state.params)
        return {"param_bytes": params, "grad_bytes": zero_lib.nbytes(grads),
                "optimizer_bytes": zero_lib.nbytes(
                    self.moments(state.opt_state)),
                "allocated_at_update": self._allocated()}

    def zero_resident_bytes(self, state: TrainState) -> dict:
        """A rank's training state in bytes, as the last step held it at
        its update (``_held_bytes``) with the allocator's count as that
        step began (between steps), and ``n``, the parameter count.
        Before any step, the parameters and optimizer state of ``state``
        and no gradient."""
        numels = [int(np.prod(s)) for s in self._shapes]
        held = self._held or dict(self._held_bytes(state, []),
                                  allocated_between_steps=self._allocated())
        total = (held["param_bytes"] + held["grad_bytes"]
                 + held["optimizer_bytes"])
        return {"stage": self.zero_stage, "replicas": self.nd,
                "n": sum(numels), **held, "total_bytes": total}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, state: TrainState, eval_iter: Iterator,
                 heartbeat: Optional[Heartbeat] = None):
        """Weighted-exact eval over batches (images, labels[, mask]); a
        missing mask means every example is real.  Returns (mean loss,
        top-1) over exactly the unmasked examples (top-1 None under
        --report_accuracy_metrics false), or None for an empty
        iterator.  Units: tokens for sequence data, examples else."""
        freed = self.zero_stage == 3 and not self._materialized
        if freed:
            self._gather_params(state.params)
        try:
            return self._evaluate(eval_iter, heartbeat)
        finally:
            if freed:
                self._free_params()

    def _evaluate(self, eval_iter: Iterator, heartbeat):
        model = self.model
        model.eval()
        dev = self.device
        loss_sum = correct = count = 0.0
        for batch in eval_iter:
            if heartbeat is not None:
                heartbeat.beat()
            images, labels = (torch.as_tensor(np.asarray(x), device=dev)
                              for x in batch[:2])
            images = self._inputs(images)
            mask = (torch.as_tensor(np.asarray(batch[2]), device=dev,
                                    dtype=torch.float32)
                    if len(batch) > 2 else
                    torch.ones(labels.shape[0], device=dev))
            logits = model(images)
            per = self._per_example_cross_entropy(logits, labels)
            w = (mask[:, None] * torch.ones_like(per) if per.dim() == 2
                 else mask)
            loss_sum += float((per * w).sum())
            if self.report_acc:
                correct += float(((self._argmax(logits) == labels).float()
                                  * w).sum())
            count += float(w.sum())
        if self.rt.group is not None:
            loss_sum, correct, count = all_reduce_sum(torch.tensor(
                [loss_sum, correct, count], dtype=torch.float64,
                device=dev), self.rt.reduce_group).tolist()
        self.eval_count = count
        if count == 0:
            return None
        return (loss_sum / count,
                correct / count if self.report_acc else None)

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, train_iter: Iterator,
            eval_iter_fn: Optional[Callable[[], Iterator]] = None,
            callbacks: Optional[list] = None):
        """Runs training from ``state.step``; returns (state, stats)
        with the stats dict key-compatible with the reference's
        build_stats, plus ``train_loss_log`` [(step, loss)] and
        ``window_step_s``."""
        cfg = self.cfg
        resumed_step = int(state.step)
        time_cb = TimeHistory(self.global_batch, cfg.log_steps,
                              initial_global_step=resumed_step)
        callbacks = [time_cb] + list(callbacks or [])
        # watchdogs (obs/watchdog.py): the NaN check reads the loss this
        # loop already syncs at log cadence; the step-time guard watches
        # the synced log windows; the heartbeat exists only when the
        # launcher exported DTF_HEARTBEAT_DIR
        nan_guard = NanLossWatchdog(enabled=cfg.nan_guard)
        step_guard = (StepTimeWatchdog(factor=cfg.step_time_guard_factor)
                      if cfg.step_time_guard_factor else None)
        heartbeat = Heartbeat.from_env(interval_s=cfg.heartbeat_secs)
        ckpt_every = cfg.checkpoint_steps or 0
        acc_key = ("categorical_accuracy" if self.spec.one_hot
                   else "sparse_categorical_accuracy")
        history: dict = {"loss": [], acc_key: []}
        # the first window covers the kernels' build and first launches,
        # and a window after an epoch boundary or an interval checkpoint
        # its eval or save: skipped
        window_skewed = True
        window_t0 = time.monotonic()
        for cb in callbacks:
            _call(cb, "on_train_begin", None)
        eval_output = None
        metrics = None
        last_batch = None
        # data parallelism: the previous step's all-reduced latch
        pending_preempt = None
        global_step = resumed_step
        spe = self.steps_per_epoch
        # crash-exact mid-epoch resume: a run restored at step K of
        # epoch E continues at batch K % spe -- neither re-training the
        # epoch's prefix nor consuming those batches
        start_epoch, start_batch = divmod(global_step, spe)
        if global_step and self.rt.is_coordinator:
            log.info("resuming at step %d (epoch %d, batch %d)",
                     global_step, start_epoch, start_batch)
        profiler = StepProfiler(cfg, self.device, self.rt.rank)
        # the MFU ledger on the default registry (what --metrics_port
        # serves): the first step counted, then each clean window
        ledger = Ledger(device=self.device)
        count_pending = os.environ.get("DTF_LEDGER", "1") != "0"
        t0 = time.time()
        try:
            for epoch in range(start_epoch, self.train_epochs):
                for cb in callbacks:
                    _call(cb, "on_epoch_begin", epoch, None)
                for batch_idx in range(start_batch if epoch == start_epoch
                                       else 0, spe):
                    for cb in callbacks:
                        _call(cb, "on_batch_begin", batch_idx, None)
                    profiler.before_step(global_step)
                    images, labels = next(train_iter)
                    last_batch = (images, labels)
                    with device_loss_guard(global_step), \
                            trace.span("step", step=global_step):
                        if count_pending:
                            # its wall sits in the first window, which
                            # is skipped
                            (state, metrics), count = count_flops(
                                self.train_step, state, images, labels)
                            ledger.register("train_step", flops=count.total)
                            count_pending = False
                        else:
                            state, metrics = self.train_step(state, images,
                                                             labels)
                    global_step += 1
                    if global_step % cfg.log_steps == 0:
                        # the sync: the host waits for the step's loss
                        # (where an asynchronous device error surfaces)
                        with device_loss_guard(global_step - 1):
                            loss_val = float(metrics["loss"])
                        nan_guard.check(global_step, loss_val)
                        # the loss trajectory record: Python floats
                        # round-trip JSON exactly, so crash-exactness
                        # checks compare these bit for bit
                        trace.event("train_loss", step=global_step,
                                    loss=loss_val)
                        self.loss_log.append((global_step, loss_val))
                        if self.rt.is_coordinator:
                            log.info("step %d: loss %.6f lr %.6g", global_step,
                                     loss_val, metrics["learning_rate"])
                        now = time.monotonic()
                        if not window_skewed:
                            window_s = now - window_t0
                            trace.span_completed(
                                "log_window", window_s, step=global_step,
                                steps=cfg.log_steps,
                                step_s=window_s / cfg.log_steps)
                            self.window_step_s.append(window_s / cfg.log_steps)
                            ledger.observe("train_step",
                                           window_s / cfg.log_steps)
                            if step_guard is not None:
                                step_guard.observe(global_step, window_s)
                        window_t0 = now
                        window_skewed = False
                    if heartbeat is not None:
                        heartbeat.beat(step=global_step)
                    profiler.after_step(global_step)
                    # interval checkpointing reads state and step from the
                    # logs dict (CheckpointCallback.every_steps)
                    for cb in callbacks:
                        _call(cb, "on_batch_end", batch_idx,
                              {"state": state, "step": global_step})
                    if ckpt_every and global_step % ckpt_every == 0:
                        # a sealed save ran inside this log window: keep its
                        # I/O out of the step-time signal
                        window_skewed = True
                    # chaos probe AFTER the interval checkpoint sealed:
                    # crash@step:K with checkpoint_steps dividing K is the
                    # deterministic kill-after-durable-save experiment
                    chaos.step(global_step)
                    signum = self._preempt_signal(pending_preempt)
                    pending_preempt = metrics.get("preempt")
                    if signum is not None:
                        # emergency checkpoint at this boundary (sealed),
                        # then the preempted exit the supervisor restarts
                        # without spending the crash budget
                        for cb in callbacks:
                            _call(cb, "on_preempt",
                                  {"state": state, "step": global_step})
                        trace.event("preempted", step=global_step,
                                    signum=int(signum))
                        trace.flush()
                        raise preemption.Preempted(global_step, signum)
                loss_val = float(metrics["loss"])
                nan_guard.check(global_step, loss_val)
                trace.event("epoch_end", epoch=epoch, step=global_step,
                            loss=loss_val)
                history["loss"].append(loss_val)
                if "accuracy" in metrics:
                    history[acc_key].append(float(metrics["accuracy"]))
                for cb in callbacks:
                    _call(cb, "on_epoch_end", epoch,
                          {"state": state, "history": history})
                if heartbeat is not None:
                    heartbeat.beat(step=global_step)
                if self.rt.is_coordinator:
                    log.info("epoch %d/%d: loss=%.4f top1=%s lr=%.5f",
                             epoch + 1, self.train_epochs, history["loss"][-1],
                             ("%.4f" % history[acc_key][-1])
                             if "accuracy" in metrics else "n/a",
                             metrics["learning_rate"])
                if (not cfg.skip_eval and eval_iter_fn is not None
                        and ((epoch + 1) % cfg.epochs_between_evals == 0
                             or epoch + 1 == self.train_epochs)):
                    with trace.span("eval", epoch=epoch, step=global_step):
                        eval_output = self.evaluate(state, eval_iter_fn(),
                                                    heartbeat=heartbeat)
                    if eval_output and self.rt.is_coordinator:
                        log.info("eval: loss=%.4f top1=%s", eval_output[0],
                                 ("%.4f" % eval_output[1])
                                 if eval_output[1] is not None else "n/a")
                    # --stop_threshold (the reference's
                    # past_stop_threshold): end training once eval
                    # top-1 reaches the threshold
                    if (eval_output and cfg.stop_threshold is not None
                            and eval_output[1] is not None
                            and eval_output[1] >= cfg.stop_threshold):
                        if self.rt.is_coordinator:
                            log.info("stop_threshold %.4f reached (top1="
                                     "%.4f) -- stopping at epoch %d",
                                     cfg.stop_threshold, eval_output[1],
                                     epoch + 1)
                        break
                window_t0 = time.monotonic()
                window_skewed = True
        finally:
            # every exit -- the end, the stop_threshold break, a
            # watchdog's abort, a preemption -- closes an open trace
            profiler.stop()
        if (start_epoch >= self.train_epochs and not cfg.skip_eval
                and eval_iter_fn is not None):
            # resumed a fully trained checkpoint: still honour the eval
            with trace.span("eval", epoch=start_epoch, step=global_step):
                eval_output = self.evaluate(state, eval_iter_fn(),
                                            heartbeat=heartbeat)
        for cb in callbacks:
            _call(cb, "on_train_end", {"state": state, "history": history})
        log.info("train wall time: %.1fs (%d steps)", time.time() - t0,
                 global_step)
        trace.event("train_end", step=global_step, wall_s=time.time() - t0)
        if (self.zero_stage >= 2 and cfg.zero_probe
                and last_batch is not None):
            self.zero_probe_result = self._zero_probe(state, last_batch,
                                                      ledger)
        # the caller gets the trained weights in the model
        self.materialize(state)
        ledger.emit_summary()
        trace.flush()
        resident = self.zero_resident_bytes(state)
        self._publish_calibration_gauges(resident)
        stats = build_stats(history, eval_output, time_cb)
        stats["train_loss_log"] = list(self.loss_log)
        stats["window_step_s"] = list(self.window_step_s)
        stats["ledger"] = ledger.summary()
        if profiler.path:
            stats["profile_trace"] = profiler.path
        if eval_output is not None:
            stats["eval_count"] = self.eval_count
        if self.zero_probe_result is not None:
            stats["zero_probe"] = dict(self.zero_probe_result)
        stats["resident_bytes"] = resident
        return state, stats

    def _publish_calibration_gauges(self, resident: dict) -> None:
        """The two gauges ``plan_main --calibrate`` reads after a
        measured run, as the JAX Trainer publishes them at the end of a
        fit: ``train_step_s``, the median clean-window step time (the
        JAX package's median, the upper one of an even count), and
        ``train_live_bytes``, what this rank holds -- on CUDA the
        allocator's count on its card, on the CPU its parameters,
        optimizer state and gradients (ZeRO's local slices counted as
        held).  On CUDA the count is this run's: what the allocator held
        before the Trainer, less its model, is taken off."""
        from dtf_tpu_torch.obs.registry import default_registry
        reg = default_registry()
        if self.window_step_s:
            window = sorted(self.window_step_s)
            reg.gauge("train_step_s", unit="s").set(window[len(window) // 2])
        live = self._allocated()
        if live is None:
            live = resident["total_bytes"]
        else:
            live -= self._alloc_base
        if live:
            reg.gauge("train_live_bytes", unit="bytes").set(live)

    def _zero_probe(self, state: TrainState, batch, ledger) -> dict:
        """--zero_probe: the ZeRO-2/3 communication as measured numbers,
        after training.  The serialized wall of one reduce-scatter and
        one all-gather of the parameter-shaped tree (median of 3, after
        a warm-up), and the step and its twin with those collectives
        stubbed, both on copies of the state (their results are
        garbage), timed in turns under the same conditions (median of 3
        each, after one warm-up each): exposed = max(0, step - twin).
        ``noise_s`` is the sum of the timed series' spreads (max - min).
        Every rank runs it (the collectives are the group's)."""
        dev = self.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def wall(fn) -> float:
            sync()
            t0 = time.monotonic()
            fn()
            sync()
            return time.monotonic() - t0

        def median(walls) -> float:
            return sorted(walls)[len(walls) // 2]

        full = [torch.zeros(shape, device=dev) for shape in self._shapes]
        group = self.rt.data_group
        slices = self._scatter(full, False)
        scatters, gathers = ([wall(fn) for _ in range(4)][1:] for fn in (
            lambda: self._scatter(full, False),
            lambda: [zero_lib.gather_leaf(s, shape, s.dtype, self.nd, group,
                                          expert=e)
                     for s, shape, e in zip(slices, self._shapes,
                                            self._expert)]))
        del full, slices
        # the step and its twin run on copies: the live state, the
        # model's parameters (stage 2 writes them) and buffers are put
        # back
        saved = [b.clone() for b in self.model.buffers()]
        if self.zero_stage == 2:
            saved += [p.detach().clone() for p in self.params]
        copy = dataclasses.replace(
            state, params=[p.clone() for p in state.params],
            opt_state=self._opt_map(state.opt_state,
                                    lambda i, t: t.clone()))
        runs = {off: (lambda off=off: float(self.train_step(
            copy, *batch, comm_off=off)[1]["loss"])) for off in (False, True)}
        steps = {False: [], True: []}
        for r in range(4):
            for off, fn in runs.items():
                w = wall(fn)
                if r:
                    steps[off].append(w)
        with torch.no_grad():
            for t, v in zip(list(self.model.buffers()) + (
                    self.params if self.zero_stage == 2 else []), saved):
                t.copy_(v)
        scatter_s, gather_s = median(scatters), median(gathers)
        step_s, nocomm_s = median(steps[False]), median(steps[True])
        serialized_s = self.grad_accum * scatter_s + gather_s
        exposed_s = max(0.0, step_s - nocomm_s)
        spread = lambda w: max(w) - min(w)
        noise_s = (spread(steps[False]) + spread(steps[True])
                   + self.grad_accum * spread(scatters) + spread(gathers))
        param_bytes = 4 * sum(int(np.prod(s)) for s in self._shapes)
        for name, w in (("zero_scatter", scatter_s),
                        ("zero_gather", gather_s)):
            ledger.register(name, flops=0.0, bytes_accessed=param_bytes)
            ledger.observe(name, w)
        out = {"zero_stage": self.zero_stage, "scatter_wall_s": scatter_s,
               "gather_wall_s": gather_s, "serialized_s": serialized_s,
               "step_s": step_s, "nocomm_step_s": nocomm_s,
               "exposed_s": exposed_s, "noise_s": noise_s,
               "exposed_frac": (exposed_s / serialized_s
                                if serialized_s > 0 else 0.0),
               "window_step_s": (median(self.window_step_s)
                                 if self.window_step_s else None)}
        trace.event("zero_overlap", **out)
        if self.rt.is_coordinator:
            log.info("zero_probe: step %.2f ms, comm-off twin %.2f ms, "
                     "exposed comm %.2f ms vs %.2f ms serialized "
                     "(noise %.2f ms)", step_s * 1e3, nocomm_s * 1e3,
                     exposed_s * 1e3, serialized_s * 1e3, noise_s * 1e3)
        return out

    def _preempt_signal(self, pending) -> Optional[int]:
        """The signal to stop on at this step boundary, or None.  One
        process: its own latch.  Data parallelism: the previous step's
        all-reduced latch, which every rank reads alike (a rank that
        latched nothing itself stops for SIGTERM)."""
        if self.rt.group is None:
            return preemption.triggered()
        if pending is None or not float(pending):
            return None
        return preemption.triggered() or int(signal.SIGTERM)


def _allocator_bytes(model) -> int:
    """The CUDA allocator's bytes for the model's parameters and
    buffers: each storage once, rounded up to the allocator's 512-byte
    blocks."""
    seen = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        if t.device.type == "cuda":
            st = t.untyped_storage()
            seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
    return sum(seen.values())


@contextlib.contextmanager
def device_loss_guard(step: int):
    """Classify, never swallow: an exception that ``elastic.is_device_loss``
    recognises becomes a ``device_lost`` anomaly and ``DeviceLost``
    (the runner then exits ``EXIT_DEVICE_LOST`` touching nothing on the
    card); any other is re-raised untouched, down its ordinary crash
    path."""
    try:
        yield
    except Exception as e:  # noqa: BLE001 -- re-raised below
        if elastic.is_device_loss(e):
            trace.anomaly("device_lost", step=step,
                          error=f"{type(e).__name__}: {e}")
            raise elastic.DeviceLost(step, e) from e
        raise


def _parse_profile_steps(profile_steps: Optional[str]):
    """--profile_steps "start,stop" (the reference's common.py)."""
    if not profile_steps:
        return None
    parts = [p.strip() for p in str(profile_steps).split(",")]
    if len(parts) != 2:
        raise ValueError("profile_steps must be 'start,stop'")
    return int(parts[0]), int(parts[1])


class StepProfiler:
    """``--profile_steps "start,stop"``: ``torch.profiler`` (the CPU,
    and the card on CUDA) over the steps numbered start..stop, the JAX
    loop's contract: the trace starts before the first step at or past
    ``start`` -- a run resumed inside the range still traces the rest
    of it -- and stops once ``stop`` has run.  One Chrome trace a run,
    ``profile_rank{R}_steps{a}-{b}.json``, in ``--trace_dir`` (or the
    launcher's ``DTF_TRACE_DIR``) else ``--model_dir``, its path in a
    ``profiler_trace`` event and the run's stats."""

    def __init__(self, cfg, device: torch.device, rank: int = 0):
        self.range = _parse_profile_steps(cfg.profile_steps)
        self.directory = (cfg.trace_dir or os.environ.get("DTF_TRACE_DIR",
                                                          "")
                          or cfg.model_dir)
        if self.range and not self.directory:
            raise ValueError("--profile_steps writes its trace under "
                             "--trace_dir or --model_dir; set one")
        self.device, self.rank = device, rank
        self.path = ""
        self._prof = None
        self._first = None

    def before_step(self, step: int) -> None:
        if (self.range is None or self._first is not None
                or not self.range[0] <= step <= self.range[1]):
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._first = step
        trace.event("profiler_trace", path=self.directory, start_step=step,
                    stop_step=self.range[1])

    def after_step(self, step: int) -> None:
        if self._prof is not None and step > self.range[1]:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(
            self.directory, f"profile_rank{self.rank}_steps{self._first}-"
                            f"{self.range[1]}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        log.info("profiler trace of steps %d-%d: %s", self._first,
                 self.range[1], self.path)


def _call(cb, name, *args):
    fn = getattr(cb, name, None)
    if fn is not None:
        fn(*args)
