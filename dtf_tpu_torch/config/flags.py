"""Typed configuration + CLI flags for the port's entry points.

The PyTorch counterpart of ``dtf_tpu/config/flags.py``.  Every field of
the JAX ``Config`` is one of three things here: a field the port reads,
a declared no-op (``NO_OPS``: reference-compat flags the JAX package
also accepts and ignores), or a key of ``NOT_PORTED``, whose message
names the subsystem not ported yet.

The fields the ported paths read: the model and its dtype (fp16 for
the vision families only, behind the JAX loss-scale rule), the seed,
the device, the training fields of ``cli/lm_main.py``,
``cli/cifar_main.py`` and ``cli/imagenet_main.py`` (dataset, input wire
and layout, batch, steps, optimizer, loss scaling, accumulation,
clipping, logging, remat, ``use_tensor_lr``, ``stop_threshold``,
``enable_tensorboard``, ``profile_steps``), the ImageNet input flags
(``input_service``, ``input_num_shards``, ``input_workers``, the
decode cache, ``input_fast_dct``, ``input_scaled_decode``,
``datasets_num_private_threads``),
the ``serve_*`` and ``kv_*`` knobs of ``cli/serve_main.py`` (prefix
sharing and the contiguous cache, ``kv_page_size 0``, included),
``metrics_port`` (``obs/prom.py``), the benchmark log, and the
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
as an ``.npz``, see ``serve/bridge.py``).  Flags of features not ported
yet (model parallelism, ZeRO, the serving fleet, ...) raise with a
message that says so; any other unknown flag raises too.
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

# reference-compat flags the JAX Config declares and ignores; the port
# accepts and ignores them too
NO_OPS = ("enable_xla", "all_reduce_alg", "num_packs",
          "per_gpu_thread_count", "tf_gpu_thread_mode",
          "batchnorm_spatial_persistent", "image_bytes_as_serving_input",
          "enable_eager", "verbose")

_MP = "model parallelism (tensor, pipeline and expert)"
_FLEET = ("the serving fleet (serve/router.py, serve/replica.py, "
          "serve/ha.py, serve/rollout.py)")
# flags of the JAX package whose features the port does not have yet
NOT_PORTED = {
    "zero_stage": "ZeRO", "optimizer_sharding": "ZeRO",
    "zero_wire": "ZeRO", "zero_probe": "ZeRO",
    "model_parallelism": "tensor/pipeline/expert parallelism",
    "seq_parallelism": "ring attention",
    "remat_policy": "selective remat (use --remat)",
    "plan": "the planner", "plan_mesh": "the planner",
    "plan_cache": "the planner",
    **{name: _MP for name in ("shard_lm_head", "num_experts",
                              "moe_capacity_factor", "moe_aux_weight",
                              "moe_top_k", "num_microbatches",
                              "pipeline_interleave")},
    "serve_tp": "serving tensor parallelism",
    **{name: _FLEET for name in (
        "router_replicas", "router_deadline_s", "router_admission",
        "router_probe_s", "router_health_timeout_s",
        "router_replica_inflight", "router_max_respawns",
        "router_respawn_window_s", "router_respawn_backoff_s",
        "router_hedge_s", "router_placement", "router_prefill_replicas",
        "router_ha", "router_standby", "router_lease_ttl_s",
        "router_journal_fsync_s", "rendezvous_dir", "replica_id",
        "serve_host", "rollout_checkpoint", "rollout_canary_requests",
        "rollout_mirror_fraction", "rollout_max_divergence",
        "rollout_warm_timeout_s", "rollout_state")},
}

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

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; choose from "
                             f"{sorted(DTYPES)}")
        if (self.dtype in _FP16 and self.model.startswith("transformer")
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
        if not 0 <= self.metrics_port <= 65535:
            raise ValueError(
                f"metrics_port must be in [0, 65535] (0 = off), got "
                f"{self.metrics_port}")

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
        if self.fault:
            from dtf_tpu_torch.chaos import parse_spec
            parse_spec(self.fault)              # raises on a bad spec

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
