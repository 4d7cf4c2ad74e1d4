"""Typed configuration + CLI flags for the port's entry points.

The PyTorch counterpart of ``dtf_tpu/config/flags.py``.  Every field of
the JAX ``Config`` is one of three things here: a field the port reads,
a declared no-op (``NO_OPS``: reference-compat flags the JAX package
also accepts and ignores), or a key of ``NOT_PORTED`` (empty now),
whose message would name a subsystem not ported yet.

The fields the ported paths read: the model and its dtype (fp16 for
the vision families only -- the transformer, pipeline and MoE
families run the attention kernels -- behind the JAX loss-scale rule),
the seed,
the device, the training fields of ``cli/lm_main.py``,
``cli/cifar_main.py`` and ``cli/imagenet_main.py`` (dataset, input wire
and layout, batch, steps, optimizer, loss scaling, accumulation,
clipping, logging, remat and ``remat_policy``, ZeRO (``zero_stage``,
``optimizer_sharding``, ``zero_wire``, ``zero_probe``),
``use_tensor_lr``, ``stop_threshold``,
``enable_tensorboard``, ``profile_steps``), the ImageNet input flags
(``input_service``, ``input_num_shards``, ``input_workers``, the
decode cache, ``input_fast_dct``, ``input_scaled_decode``,
``datasets_num_private_threads``),
the ``serve_*`` and ``kv_*`` knobs of ``cli/serve_main.py`` (prefix
sharing and the contiguous cache, ``kv_page_size 0``, included),
``metrics_port`` (``obs/prom.py``), the serving fleet's
(``cli/router_main.py`` and ``cli/replica_main.py``: ``router_*``
with the HA pair's, ``rendezvous_dir``, ``replica_id``,
``serve_host``, the rollout's ``rollout_*``), the benchmark log, and the
topology of a data-parallel run (``distribution_strategy``, ``num_devices``, ``ps_mode``, the
coordinator, process id and count, ``worker_hosts``/``task_index`` and
``sync_bn``) and the async parameter server's (``ps_wire``,
``ps_snapshot_dir``, ``ps_snapshot_secs``, ``ps_reconnect_secs``,
``ps_reseed_tolerance``), the topology filled from the ``DTF_*``
environment or the reference's ``TF_CONFIG`` by
:func:`apply_env_topology`.  Names and defaults are the JAX package's.
Parsing is the same absl style: ``--name value``, ``--name=value``,
``-name value`` and bare boolean flags (``--use_synthetic_data``).

Recovery's fields are the JAX package's too: checkpoints
(``model_dir``, ``resume``, ``checkpoint_steps``, ``checkpoint_keep``,
``skip_checkpoint``, ``eval_only``, ``clean``, ``export_dir``),
tracing and watchdogs (``trace_dir``, ``nan_guard``,
``step_time_guard_factor``, ``heartbeat_secs``), preemption
(``preemption_poll_s``) and fault injection (``fault``); the default
``model_dir`` is the port's own, so the two packages never share one.

Two fields are new: ``device`` (``cuda`` or ``cpu``; the port never
picks the CPU on its own) and ``serve_params_npz`` (flax params saved
as an ``.npz``, see ``serve/bridge.py``).  Tensor parallelism's
fields (``model_parallelism``, ``shard_lm_head``, ``serve_tp``) and
sequence parallelism's (``seq_parallelism``: ring attention over the
'seq' axis), pipeline parallelism's (``num_microbatches``,
``pipeline_interleave``), expert parallelism's (``num_experts``,
``moe_capacity_factor``, ``moe_aux_weight``, ``moe_top_k``) and the
planner's (``plan``, ``plan_mesh``, ``plan_cache``) are the JAX
package's, with its validation; ``plan_mesh`` names the port's presets.
``NOT_PORTED`` is empty: every field of the JAX ``Config`` is ported or
a declared no-op.  An unknown flag raises.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Optional

import torch

DTYPES = {"fp32": torch.float32, "float32": torch.float32,
          "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
          "fp16": torch.float16, "float16": torch.float16}
# the attention kernels (K1-K4) have float32 and bfloat16 routes only,
# so fp16 trains the vision families (cuDNN convolutions) alone
_FP16 = ("fp16", "float16")
# the model families that run the attention kernels
_ATTENTION_FAMILIES = ("transformer", "pipeline_transformer",
                       "moe_transformer")

# reference-compat flags the JAX Config declares and ignores; the port
# accepts and ignores them too
NO_OPS = ("enable_xla", "all_reduce_alg", "num_packs",
          "per_gpu_thread_count", "tf_gpu_thread_mode",
          "batchnorm_spatial_persistent", "image_bytes_as_serving_input",
          "enable_eager", "verbose")

# flags of the JAX package whose features the port does not have yet:
# none is left
NOT_PORTED: dict = {}

# literal copy of serve/router.py PLACEMENTS: Config imports without the
# serving stack (a test pins the two)
ROUTER_PLACEMENTS = ("affinity", "least_loaded", "random")

# --distribution_strategy names, the JAX package's (cli/runner.py and
# runtime/mesh.py say what each means here)
STRATEGIES = ("off", "one_device", "mirrored", "multi_worker_mirrored",
              "horovod", "parameter_server", "tpu")


@dataclasses.dataclass
class Config:
    """Every knob of a run."""

    model: str = "transformer_small"
    num_classes: Optional[int] = None   # vocabulary; None = the model's
    dtype: str = "fp32"                 # fp32 | bf16 | fp16 (vision only)
    seed: int = 0
    device: str = "cuda"                # cuda | cpu; never a silent fallback
    benchmark_log_dir: str = ""         # writes metric.log when set
    benchmark_test_id: str = ""

    # --- distribution / topology (runtime/mesh.py: one process a device) ---
    distribution_strategy: str = "mirrored"
    ps_mode: str = "sync"               # parameter_server: sync | async
    # --- the async parameter server (parallel/ps.py) ---
    ps_wire: str = "fp32"               # fp32 | bf16 (halves pull/push
                                        # traffic; store math stays fp32)
    # the PS rank restores <dir>/ps_store.snap at start when present and
    # snapshots params+velocity+version there every ps_snapshot_secs;
    # workers then reconnect with backoff for ps_reconnect_secs instead
    # of dying with the store.  None: the reference's in-memory store
    ps_snapshot_dir: Optional[str] = None
    ps_snapshot_secs: float = 30.0
    ps_reconnect_secs: float = 300.0
    # how many store versions a restarted PS may trail what a worker saw
    # before the worker refuses to continue; the literal is
    # parallel/ps.py DEFAULT_RESEED_TOLERANCE (Config imports without
    # that module; a test pins the two)
    ps_reseed_tolerance: int = 10_000
    num_devices: Optional[int] = None   # mirrored: local devices to use
    worker_hosts: Optional[str] = None  # "h1:p,h2:p" (with task_index)
    task_index: int = -1
    # the rendezvous: "host:port" (tcp) or a URL such as file:///path
    coordinator_address: Optional[str] = None
    process_id: Optional[int] = None
    process_count: Optional[int] = None
    sync_bn: bool = False               # cross-replica BatchNorm statistics
    # tensor parallelism (runtime/mesh.py): ranks per model replica, the
    # 'model' axis of a data x model grid of ranks
    model_parallelism: int = 1
    # sequence parallelism (parallel/ring_attention.py): ranks per
    # replica's ring, the 'seq' axis of a data x seq x model grid
    seq_parallelism: int = 1
    # column-parallel lm_head over 'model' (Megatron's vocab-parallel
    # softmax): local logits and the collective cross-entropy
    shard_lm_head: bool = False
    # pipeline parallelism (parallel/pipeline.py; the pipeline_transformer
    # family's stages ride the model axis): GPipe microbatches per step
    # (None: the runner's auto 4 * pp, halved until it divides the
    # per-replica batch), and 2 for two virtual stages a rank
    num_microbatches: Optional[int] = None
    pipeline_interleave: int = 1
    # mixture of experts (the moe_transformer family, models/moe.py;
    # experts over the data axis, or the model axis under
    # --model_parallelism).  None: the model preset's own value
    num_experts: Optional[int] = None
    moe_capacity_factor: Optional[float] = None
    moe_aux_weight: Optional[float] = None
    moe_top_k: Optional[int] = None     # router choices: 1 Switch, 2 GShard

    # --- training (cli/lm_main.py -> cli/runner.py -> train/loop.py) ---
    dataset: str = ""                   # lm | cifar10 | imagenet
    data_dir: str = ""                  # CIFAR-10 files, ImageNet TFRecords
    use_synthetic_data: bool = False    # one random batch, repeated
    use_trivial_model: bool = False     # the input probe in place of --model
    # uint8: raw pixels over the wire, normalized on the device first
    # thing in the step (data/normalize.py); float32: host-normalized
    input_wire: str = "uint8"
    # channels_first: NCHW batches, transposed to NHWC in the step
    data_format: str = "channels_last"
    drop_remainder: bool = False        # eval: False = masked full coverage
    batch_size: int = 128               # global batch size
    train_epochs: int = 182
    train_steps: Optional[int] = None   # caps training to one epoch of N
    epochs_between_evals: int = 1
    seq_len: Optional[int] = None       # override the LM dataset's length
    optimizer: str = "sgd"              # sgd | momentum | adamw
    # a number (static scale) or "dynamic" (TF2 LossScaleOptimizer)
    loss_scale: Optional[Any] = None
    grad_accum_steps: int = 1           # sequential micro-batches per step
    clip_grad_norm: Optional[float] = None  # global-norm clip threshold
    log_steps: int = 100                # BenchmarkMetric cadence (and sync)
    skip_eval: bool = False
    report_accuracy_metrics: bool = True
    remat: bool = False                 # recompute each block in backward
    # selective remat (implies --remat): "dots" saves the matmul and
    # attention outputs and recomputes the elementwise ops
    remat_policy: Optional[str] = None
    # ZeRO on the data axis (train/zero.py, train/loop.py): 1 shards the
    # optimizer state, 2 the gradients too, 3 the parameters too;
    # --optimizer_sharding is the stage-1 shorthand
    zero_stage: int = 0
    optimizer_sharding: bool = False
    # the stage-2/3 gradient reduce-scatter's wire: fp32 | bf16 (the
    # wire and its sum in bf16; the slices stay float32)
    zero_wire: str = "fp32"
    # after training, time the step's twin without its ZeRO collectives
    # (stages 2-3): the exposed communication
    zero_probe: bool = False
    use_tensor_lr: bool = False         # PiecewiseConstantDecayWithWarmup
    stop_threshold: Optional[float] = None  # stop once eval top-1 >= it
    enable_tensorboard: bool = False    # scalar event files in model_dir
    profile_steps: Optional[str] = None  # "start,stop": torch.profiler
    # True forces drop_remainder=False (eval covers the partial batch)
    enable_get_next_as_optional: bool = False

    # --- ImageNet input (data/imagenet.py, data/service) ---
    # train batches from the sharded deterministic data service (batch n
    # a pure function of (seed, process, n)); False = the legacy
    # threaded pipeline, which refuses a mid-stream resume
    input_service: bool = True
    input_num_shards: int = 16          # part of the stream's identity
    input_workers: int = -1             # -1 auto, 0 inline, N processes
    input_cache_dir: str = ""           # decode-once cache ("" = off)
    input_cache_limit_mb: int = 0       # per-shard bound; 0 = unbounded
    input_fast_dct: bool = False        # legacy pipeline: JDCT_IFAST
    input_scaled_decode: bool = False   # legacy pipeline: DCT scaling
    datasets_num_private_threads: Optional[int] = None  # legacy threads

    # --- reference-compat no-ops (NO_OPS), the JAX defaults ---
    enable_xla: bool = True
    all_reduce_alg: Optional[str] = None
    num_packs: int = 1
    per_gpu_thread_count: int = 0
    tf_gpu_thread_mode: Optional[str] = None
    batchnorm_spatial_persistent: bool = False
    image_bytes_as_serving_input: bool = False
    enable_eager: bool = False
    verbose: int = 2

    # --- checkpoints and recovery (train/checkpoint.py, cli/runner.py) ---
    model_dir: str = "/tmp/dtf_tpu_torch"   # checkpoints/, checkpoints.meta/
    clean: bool = False                 # delete model_dir before the run
    export_dir: str = ""                # inference variables after training
    eval_only: bool = False             # evaluate a restored checkpoint, exit
    skip_checkpoint: bool = False       # no saves (a --resume still restores)
    resume: bool = False                # restore the newest usable step
    checkpoint_steps: int = 0           # sealed saves every N steps (0: epochs)
    checkpoint_keep: int = 0            # after training keep N verified steps
    # --- observability (obs/) and fault injection (chaos/) ---
    trace_dir: str = ""                 # trace_rank{N}.jsonl ("" = off, or
                                        # DTF_TRACE_DIR)
    nan_guard: bool = True              # abort on a non-finite logged loss
    step_time_guard_factor: float = 3.0  # flag windows > factor x median
    heartbeat_secs: float = 5.0         # launcher heartbeat file interval
    preemption_poll_s: float = 0.0      # metadata preemption poll (0 = off)
    fault: str = ""                     # chaos specs ("" = off, or DTF_FAULT)

    # --- serving (cli/serve_main.py over dtf_tpu_torch/serve) ---
    serve_max_batch: int = 8            # decode slots = max concurrent sequences
    serve_max_delay_ms: float = 5.0     # batch-fill window after first arrival
    serve_queue_size: int = 64          # bounded admission queue (backpressure)
    serve_max_seq_len: Optional[int] = None  # cache capacity; None = model max
    serve_max_new_tokens: int = 32      # per-request generation budget (demo)
    serve_temperature: float = 0.0      # 0 = greedy
    serve_requests: int = 16            # synthetic-traffic demo request count
    serve_prompt_len: int = 8           # synthetic prompt length (max; varied)
    # chunked-prefill unit in tokens (multiple of kv_page_size); 0 =
    # whole-prompt single chunk; None = 4 pages
    serve_prefill_chunk: Optional[int] = None
    serve_params_npz: str = ""          # flax params as .npz ("" = none)
    # tensor-parallel serving: shards of one engine, one device each
    # (serve/bridge.py serving_devices); needs the paged cache
    serve_tp: int = 1
    # paged KV cache: tokens per page (0 = the contiguous per-slot
    # layout) and total pool pages incl. the scratch page (0 = the full
    # reservation, 1 + slots x pages-per-slot)
    kv_page_size: int = 16
    kv_pool_pages: int = 0
    # share full prompt-prefix pages across requests (paged cache):
    # refcounted pages, copy-on-write, eviction under pool pressure
    serve_prefix_sharing: bool = True
    # Prometheus text + /healthz on this port ("" = 0 = off): the
    # serving engine's registry, or rank 0's default registry in training
    metrics_port: int = 0

    # --- serving replica tier (serve/router.py over cli/replica_main) ---
    # replica serve processes behind the router (cli/router_main.py),
    # each a full ServeEngine
    router_replicas: int = 2
    # default per-request deadline: the router resolves every accepted
    # request -- tokens, Backpressure, or DeadlineExceeded -- within it
    router_deadline_s: float = 120.0
    # outstanding (queued + in-flight) requests beyond this shed loudly
    # with Backpressure(retry_after)
    router_admission: int = 128
    # health-probe cadence (reads each replica's heartbeat_rank{K}.json)
    router_probe_s: float = 0.5
    # heartbeat silence past this = the replica is declared lost (its
    # in-flight re-dispatches; must be comfortably > --heartbeat_secs)
    router_health_timeout_s: float = 15.0
    # per-replica in-flight dispatch cap; 0 = auto (serve_queue_size)
    router_replica_inflight: int = 0
    # replica respawn budget: at most this many respawns per sliding
    # window, exponential backoff between them, then a loud give-up
    router_max_respawns: int = 8
    router_respawn_window_s: float = 300.0
    router_respawn_backoff_s: float = 0.5
    # hedge: re-dispatch a request to a second replica when its first
    # makes no progress for this long (first done wins).  0 = off
    router_hedge_s: float = 0.0
    # placement policy: prefix-affine (route by chained prompt-page
    # digest to the replica whose PrefixRegistry is warm, least-loaded
    # fallback) | least_loaded | random
    router_placement: str = "affinity"
    # disaggregation: replicas 0..N-1 prefill, the rest decode; cold
    # prompts prefill in the first pool and their KV-page chains
    # migrate (serve/migrate.py) to the second.  Needs
    # router_placement=affinity.  0 = colocated
    router_prefill_replicas: int = 0
    # rendezvous directory for announce + heartbeat files (router +
    # cli/replica_main); "" = router_main picks a temp dir.  On shared
    # storage, with a routable --serve_host, the tier goes cross-host
    rendezvous_dir: str = ""
    # replica identity for cli/replica_main; -1 = from DTF_PROCESS_ID
    replica_id: int = -1
    # address a replica binds AND announces (replica_rank{K}.json)
    serve_host: str = "127.0.0.1"
    # --- router high availability (serve/journal.py + serve/ha.py) ---
    # journal every request to router_journal.jsonl in the rendezvous
    # dir and take the shared-storage leader lease: a successor router
    # (a restart or the warm standby) replays the journal and re-adopts
    # in-flight requests exactly once.  Off by default
    router_ha: bool = False
    # run router_main as the warm standby: wait out the leader's lease,
    # then take over under the next fencing epoch, adopting the live
    # tier (implies router_ha)
    router_standby: bool = False
    # leader-lease time to live: the standby takes over after the
    # leader misses about one TTL of renewals (renewals every TTL/3)
    router_lease_ttl_s: float = 2.0
    # journal fsync cadence: a host crash loses at most this much
    # journal tail (a process crash loses nothing: every append is
    # flushed)
    router_journal_fsync_s: float = 0.05
    # --- zero-downtime rollout (serve/rollout.py over the router) ---
    # roll the tier onto this checkpoint (an export_dir or model_dir)
    # mid-traffic: one replica at a time, the first a canary gated
    # token by token against the old model, rolled back on a breach.
    # "" = no rollout
    rollout_checkpoint: str = ""
    # completed old-against-new comparisons the canary gate needs
    rollout_canary_requests: int = 4
    # share of live greedy traffic mirrored to the canary, (0, 1]
    rollout_mirror_fraction: float = 1.0
    # gate threshold on diverged/compared; 0.0 = token-exact
    rollout_max_divergence: float = 0.0
    # how long a restarted replica gets to warm and re-register before
    # the rollout rolls back
    rollout_warm_timeout_s: float = 600.0
    # the persisted rollout state; "" = <rendezvous>/rollout_state.json
    rollout_state: str = ""

    # --- the parallelism planner (plan/) ---
    # "" = off (hand-set flags rule); "auto" = search the feasible plan
    # lattice on --plan_mesh and compile the fastest predicted plan into
    # the parallelism flags; <path> = a plan JSON (plan_main --out
    # artifact, a {"plan": ...} wrapper, or a bare plan object).  A
    # plan-selected run is bit-identical to the same flags set by hand;
    # plan-owned flags (--model_parallelism & co.) must stay at their
    # defaults when --plan is given -- conflicts are loud errors
    plan: str = ""
    # the mesh the planner costs against: "" = the live run (its ranks,
    # on their cards), a preset (cpu | h100x8 | 4xh100x8), or a
    # "hosts=4,devices=8,hbm=79g,flops=494t,intra=450g,inter=50g"
    # descriptor
    plan_mesh: str = ""
    # ranked-lattice memoization sidecar (plan/cache.py): a JSON file
    # keyed by (workload, mesh descriptor, batch); "" = off
    plan_cache: str = ""

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; choose from "
                             f"{sorted(DTYPES)}")
        if (self.dtype in _FP16
                and self.model.startswith(_ATTENTION_FAMILIES)
                and not self.use_trivial_model):
            raise ValueError(
                f"--dtype {self.dtype} is for the vision families: "
                f"{self.model} runs the attention kernels K1-K4 "
                f"(ops/flash_attention.py, ops/paged_attention.py), which "
                f"have float32 and bfloat16 routes only")
        if self.enable_get_next_as_optional and self.drop_remainder:
            # the reference's get_next_as_optional exists to handle the
            # partial final batch; dropping it would contradict it
            self.drop_remainder = False
        if self.loss_scale is not None and \
                str(self.loss_scale).lower() != "dynamic":
            try:
                val = float(self.loss_scale)
            except (TypeError, ValueError):
                raise ValueError(f"loss_scale must be a number or "
                                 f"'dynamic', got {self.loss_scale!r}"
                                 ) from None
            if not math.isfinite(val) or val <= 0:
                raise ValueError(f"loss_scale must be a positive finite "
                                 f"number, got {val}")
        if self.stop_threshold is not None and \
                not self.report_accuracy_metrics:
            raise ValueError(
                "--stop_threshold needs eval top-1, which "
                "--report_accuracy_metrics false disables -- early "
                "stopping would silently never fire")
        if self.input_num_shards < 1:
            raise ValueError(f"input_num_shards must be >= 1, got "
                             f"{self.input_num_shards}")
        if self.input_workers < -1:
            raise ValueError(f"input_workers must be >= -1 (-1 = auto, "
                             f"0 = inline), got {self.input_workers}")
        if self.input_cache_limit_mb < 0:
            raise ValueError(f"input_cache_limit_mb must be >= 0 (0 = "
                             f"unbounded), got {self.input_cache_limit_mb}")
        if self.input_cache_limit_mb and not self.input_cache_dir:
            raise ValueError(
                "input_cache_limit_mb needs --input_cache_dir (the "
                "decode-once cache is off without a directory)")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}; use cuda "
                             f"or cpu")
        if self.serve_max_batch < 1 or self.serve_queue_size < 1:
            raise ValueError(
                "serve_max_batch and serve_queue_size must be >= 1")
        if self.kv_page_size < 0 or self.kv_pool_pages < 0 or (
                self.serve_prefill_chunk is not None
                and self.serve_prefill_chunk < 0):
            raise ValueError(
                "kv_page_size, kv_pool_pages and serve_prefill_chunk "
                "must be >= 0 (0 disables each)")
        if (self.kv_page_size and self.serve_prefill_chunk
                and self.serve_prefill_chunk % self.kv_page_size):
            raise ValueError(
                f"serve_prefill_chunk ({self.serve_prefill_chunk}) must be "
                f"a multiple of kv_page_size ({self.kv_page_size})")
        if not self.kv_page_size and (
                self.kv_pool_pages or self.serve_prefill_chunk is not None):
            raise ValueError(
                "kv_pool_pages / serve_prefill_chunk need the paged "
                "cache (kv_page_size > 0)")
        if self.serve_tp < 1:
            raise ValueError(f"serve_tp must be >= 1, got {self.serve_tp}")
        if self.serve_tp > 1 and not self.kv_page_size:
            raise ValueError(
                "serve_tp > 1 (tensor-parallel serving) needs the paged "
                "KV cache (kv_page_size > 0) -- the page pool is the "
                "layout that shards")
        if self.model_parallelism < 1:
            raise ValueError(f"model_parallelism must be >= 1, got "
                             f"{self.model_parallelism}")
        if self.seq_parallelism < 1:
            raise ValueError(f"seq_parallelism must be >= 1, got "
                             f"{self.seq_parallelism}")
        if self.moe_top_k is not None and self.moe_top_k < 1:
            raise ValueError(f"moe_top_k must be >= 1, got {self.moe_top_k}")
        if self.pipeline_interleave not in (1, 2):
            raise ValueError(
                f"pipeline_interleave must be 1 or 2, got "
                f"{self.pipeline_interleave}")
        if not 0 <= self.metrics_port <= 65535:
            raise ValueError(
                f"metrics_port must be in [0, 65535] (0 = off), got "
                f"{self.metrics_port}")
        if self.router_replicas < 1:
            raise ValueError(
                f"router_replicas must be >= 1, got {self.router_replicas}")
        if self.router_deadline_s <= 0 or self.router_admission < 1:
            raise ValueError(
                "router_deadline_s must be > 0 and router_admission >= 1")
        if self.router_probe_s <= 0 or (
                self.router_probe_s >= self.router_health_timeout_s):
            raise ValueError(
                f"router_probe_s ({self.router_probe_s}) must be > 0 and "
                f"< router_health_timeout_s "
                f"({self.router_health_timeout_s}) -- a health verdict "
                f"needs multiple probe ticks")
        if self.router_health_timeout_s <= 0:
            raise ValueError(
                f"router_health_timeout_s must be > 0, got "
                f"{self.router_health_timeout_s}")
        # health_timeout vs heartbeat_secs is checked in
        # cli/router_main.py: a training run raising --heartbeat_secs is
        # not refused over router defaults it never uses
        if self.router_placement not in ROUTER_PLACEMENTS:
            raise ValueError(
                f"unknown router_placement {self.router_placement!r}; "
                f"choose from {ROUTER_PLACEMENTS}")
        if self.router_prefill_replicas < 0 or (
                self.router_prefill_replicas >= self.router_replicas
                and self.router_prefill_replicas > 0):
            raise ValueError(
                f"router_prefill_replicas "
                f"({self.router_prefill_replicas}) must leave at least "
                f"one decode replica (router_replicas="
                f"{self.router_replicas})")
        if (self.router_prefill_replicas
                and self.router_placement != "affinity"):
            raise ValueError(
                "router_prefill_replicas needs router_placement="
                "affinity (pool re-homing rides the prefix-owner map)")
        if (self.router_replica_inflight < 0 or self.router_max_respawns
                < 0 or self.router_respawn_backoff_s < 0
                or self.router_hedge_s < 0):
            raise ValueError(
                "router_replica_inflight/router_max_respawns/"
                "router_respawn_backoff_s/router_hedge_s must be >= 0")
        if not self.serve_host:
            raise ValueError(
                "serve_host must be a bindable address (127.0.0.1 for "
                "single-host)")
        if self.router_lease_ttl_s <= 0:
            raise ValueError(
                f"router_lease_ttl_s must be > 0, got "
                f"{self.router_lease_ttl_s}")
        if self.router_journal_fsync_s < 0:
            raise ValueError(
                f"router_journal_fsync_s must be >= 0, got "
                f"{self.router_journal_fsync_s}")
        if self.router_standby and not self.rendezvous_dir:
            raise ValueError(
                "router_standby needs an explicit --rendezvous_dir: the "
                "standby finds the leader's lease, journal and replicas "
                "there")
        if self.rollout_canary_requests < 1:
            raise ValueError(
                f"rollout_canary_requests must be >= 1, got "
                f"{self.rollout_canary_requests}")
        if not 0.0 < self.rollout_mirror_fraction <= 1.0:
            raise ValueError(
                f"rollout_mirror_fraction must be in (0, 1], got "
                f"{self.rollout_mirror_fraction}")
        if not 0.0 <= self.rollout_max_divergence <= 1.0:
            raise ValueError(
                f"rollout_max_divergence must be in [0, 1], got "
                f"{self.rollout_max_divergence}")
        if self.rollout_warm_timeout_s <= 0:
            raise ValueError(
                f"rollout_warm_timeout_s must be > 0, got "
                f"{self.rollout_warm_timeout_s}")
        if self.rollout_checkpoint and self.serve_temperature > 0:
            raise ValueError(
                "rollout_checkpoint needs greedy traffic "
                "(--serve_temperature 0): the canary gate compares "
                "mirrored greedy requests token by token, and sampled "
                "traffic is never mirrored")
        if self.rollout_checkpoint and self.router_replicas < 2:
            raise ValueError(
                "rollout_checkpoint needs >= 2 router_replicas: the "
                "shadow-only canary must not be the tier's only replica")

        if self.input_wire not in ("uint8", "float32"):
            raise ValueError(f"unknown input_wire {self.input_wire!r}; "
                             f"choose uint8 or float32")
        if self.data_format not in ("channels_last", "channels_first"):
            raise ValueError(f"unknown data_format {self.data_format!r}; "
                             f"choose channels_last or channels_first")
        if self.optimizer not in ("sgd", "momentum", "adamw"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.batch_size < 1 or self.log_steps < 1:
            raise ValueError("batch_size and log_steps must be >= 1")
        if self.distribution_strategy not in STRATEGIES:
            raise ValueError(
                f"unknown distribution_strategy "
                f"{self.distribution_strategy!r}; choose from {STRATEGIES}")
        if self.ps_wire not in ("fp32", "bf16"):
            raise ValueError(
                f"unknown ps_wire {self.ps_wire!r}; choose fp32 or bf16")
        if self.ps_mode not in ("sync", "async"):
            raise ValueError(
                f"unknown ps_mode {self.ps_mode!r}; choose sync or async")
        if self.eval_only and self.skip_eval:
            raise ValueError("--eval_only contradicts --skip_eval")
        if self.checkpoint_steps < 0 or self.checkpoint_keep < 0:
            raise ValueError(
                f"checkpoint_steps and checkpoint_keep must be >= 0, got "
                f"{self.checkpoint_steps} and {self.checkpoint_keep}")
        if self.step_time_guard_factor and self.step_time_guard_factor <= 1.0:
            raise ValueError(
                f"step_time_guard_factor must be > 1.0 (or 0 to disable), "
                f"got {self.step_time_guard_factor}")
        if self.heartbeat_secs <= 0 or self.preemption_poll_s < 0:
            raise ValueError(
                f"heartbeat_secs must be > 0 and preemption_poll_s >= 0, "
                f"got {self.heartbeat_secs} and {self.preemption_poll_s}")
        if self.plan and self.plan != "auto" and not os.path.exists(self.plan):
            # fail at flag-parse time, not after dataset/model setup
            raise ValueError(
                f"--plan {self.plan!r}: no such plan file (pass 'auto' "
                f"to search, or a plan_main --out JSON artifact)")
        if self.plan_mesh:
            # a typo'd preset or descriptor fails at flag-parse time
            from dtf_tpu_torch.plan.mesh_spec import mesh_spec
            mesh_spec(self.plan_mesh)
        if self.fault:
            from dtf_tpu_torch.chaos import parse_spec
            parse_spec(self.fault)              # raises on a bad spec
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(
                f"zero_stage must be 0, 1, 2 or 3, got {self.zero_stage}")
        if self.optimizer_sharding and self.zero_stage >= 2:
            raise ValueError(
                "--optimizer_sharding is the ZeRO stage-1 shorthand and "
                "contradicts --zero_stage >= 2 -- pass only --zero_stage")
        if self.zero_probe and self.zero_stage < 2:
            raise ValueError(
                "--zero_probe measures the stage-2/3 collectives; it "
                "needs --zero_stage 2 or 3")
        if self.zero_wire not in ("fp32", "bf16"):
            raise ValueError(
                f"unknown zero_wire {self.zero_wire!r}; choose fp32 "
                f"or bf16")
        if self.zero_wire == "bf16" and self.zero_stage_effective < 2:
            raise ValueError(
                "--zero_wire bf16 rides the stage-2/3 grad "
                "reduce-scatter; it needs --zero_stage 2 or 3")

    @property
    def zero_stage_effective(self) -> int:
        """The ZeRO stage a run executes: --zero_stage when set, else 1
        under the --optimizer_sharding shorthand, else 0."""
        return self.zero_stage or (1 if self.optimizer_sharding else 0)

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def loss_scale_value(self):
        """The JAX rule: ``--loss_scale dynamic`` gives "dynamic", a
        number that static scale; unset, fp16 takes a static 128 and
        bf16 and fp32 none (1.0)."""
        if self.loss_scale is not None:
            if str(self.loss_scale).lower() == "dynamic":
                return "dynamic"
            return float(self.loss_scale)
        return 128.0 if self.dtype in _FP16 else 1.0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_TRUE = ("true", "1", "yes", "t")
_BOOL_WORDS = _TRUE + ("false", "0", "no", "f")


def _coerce(field: dataclasses.Field, raw: str) -> Any:
    t = str(field.type)
    if raw.lower() in ("none", "null"):
        return None
    if t == "bool":
        return raw.lower() in _TRUE
    if "int" in t:
        return int(raw)
    if "float" in t:
        return float(raw)
    return raw


def parse_flags(argv=None, defaults: Optional[dict] = None) -> Config:
    """absl-style parsing into a :class:`Config`: ``--name value``,
    ``--name=value``, ``-name value`` and bare boolean flags.
    ``defaults`` are the entry point's own defaults (``LM_DEFAULTS``),
    which flags override."""
    names = {f.name: f for f in dataclasses.fields(Config)}
    kw = dict(defaults or {})
    argv = list(argv or [])
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-"):
            raise ValueError(f"unexpected argument {tok!r}")
        name, eq, val = tok.lstrip("-").partition("=")
        if name in NOT_PORTED:
            raise ValueError(f"--{name}: {NOT_PORTED[name]} is not ported "
                             f"to dtf_tpu_torch yet")
        if name not in names:
            raise ValueError(f"unknown flag --{name}")
        if not eq:
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            if str(names[name].type) == "bool" and (
                    nxt is None or nxt.lower() not in _BOOL_WORDS):
                val = "true"                 # a bare boolean flag
            elif nxt is None:
                raise ValueError(f"flag --{name} needs a value")
            else:
                i += 1
                val = nxt
        kw[name] = _coerce(names[name], val)
        i += 1
    return apply_env_topology(Config(**kw))


def topology_from_env() -> dict:
    """Per-process identity from the environment, the JAX package's
    two sources in its order:
      1. ``DTF_COORDINATOR`` / ``DTF_PROCESS_ID`` / ``DTF_PROCESS_COUNT``
         (what ``cli/launch.py`` sets);
      2. the reference's ``TF_CONFIG`` JSON, ``{"cluster": {"ps": [...],
         "worker": [...]}, "task": {"type", "index"}}``: ps ranks are
         numbered first, then the workers, and the first process is the
         coordinator.
    """
    out: dict = {}
    if os.environ.get("DTF_COORDINATOR"):
        out["coordinator_address"] = os.environ["DTF_COORDINATOR"]
    if os.environ.get("DTF_PROCESS_ID"):
        out["process_id"] = int(os.environ["DTF_PROCESS_ID"])
    if os.environ.get("DTF_PROCESS_COUNT"):
        out["process_count"] = int(os.environ["DTF_PROCESS_COUNT"])
    if out:
        return out
    tf_config = os.environ.get("TF_CONFIG")
    if tf_config:
        try:
            spec = json.loads(tf_config)
        except json.JSONDecodeError:
            return out
        cluster = spec.get("cluster", {})
        task = spec.get("task", {})
        workers = list(cluster.get("worker", []))
        ps = list(cluster.get("ps", []))
        all_procs = ps + workers
        if all_procs:
            out["coordinator_address"] = all_procs[0]
            out["process_count"] = len(all_procs)
            ttype, tidx = task.get("type"), int(task.get("index", 0))
            out["process_id"] = tidx if ttype == "ps" else len(ps) + tidx
    return out


def apply_env_topology(cfg: Config) -> Config:
    """Fill unset topology fields from the environment; explicit flags
    win.  ``--worker_hosts`` (with ``--task_index``) names the
    coordinator and the process count when nothing else did."""
    env = topology_from_env()
    kw = {k: v for k, v in env.items() if getattr(cfg, k) is None}
    if (cfg.worker_hosts and cfg.coordinator_address is None
            and "coordinator_address" not in kw):
        hosts = [h.strip() for h in cfg.worker_hosts.split(",")
                 if h.strip()]
        kw["coordinator_address"] = hosts[0]
        kw["process_count"] = len(hosts)
        if cfg.task_index >= 0:
            kw["process_id"] = cfg.task_index
    return cfg.replace(**kw) if kw else cfg
