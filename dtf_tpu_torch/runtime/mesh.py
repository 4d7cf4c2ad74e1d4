"""Process and device initialization for data, sequence and tensor
parallelism -- the PyTorch counterpart of ``dtf_tpu/runtime/mesh.py``.

The JAX package runs one process over all of a host's chips and builds a
``Mesh`` of axes ('data', 'seq', 'model').  PyTorch's idiom is one
process a device (Megatron's too), so here the mesh is a grid of ranks:
with ``--seq_parallelism sp`` and ``--model_parallelism mp`` over ``n``
ranks, rank r sits at data index ``r // (sp * mp)``, seq index
``(r // mp) % sp`` and model index ``r % mp`` -- the JAX mesh's
``reshape(dp, sp, mp)``, the model axis innermost.  Each axis is a
process group: ``data_group`` joins the ranks of one (seq, model) pair
(the replicas: ZeRO slices over it), ``seq_group`` the ranks of one
(data, model) pair (the ring of ring attention; None at sp 1),
``model_group`` the ranks of one (data, seq) pair (the shards of one
model: ``tp_region``/``tp_psum`` reduce over it; None at mp 1).  Two
more join two axes: ``reduce_group`` the ranks of one model index (data
x seq: the batch-splitting axes, over which gradients, the loss and the
eval sums reduce -- the JAX ``reduce_axes``), and ``slice_group`` the
ranks of one seq index (data x model: each holds distinct ZeRO slices,
so a global norm of slices sums over it).  ``group`` is every rank
(barriers, checkpoint verdicts, every all-or-nothing decision).  At mp
1 and sp 1 the data group is the world.

Strategy -> runtime (the JAX package's names):

    off, one_device        world 1, no process group
    mirrored, tpu          one rank a local device, all on one host;
                           ``--num_devices`` caps the count.  A command
                           with no ``DTF_*`` environment and one device
                           runs world 1 in-process (no group); with more
                           devices its main starts one rank a device
                           through ``cli/launch.py``
    multi_worker_mirrored  one global process group over every rank
    horovod                as multi_worker_mirrored, with the reference's
                           per-replica ``--batch_size`` and horovod's
                           learning-rate schedule (``cli/runner.py``,
                           ``train/loop.py``)
    parameter_server       ``--ps_mode sync``: as horovod's batch, over
                           one global group; ``--ps_mode async`` (the
                           C++ parameter store, ``parallel/ps.py``)
                           joins no group: ``cli/runner.py`` dispatches
                           it before initializing a runtime

A process group exists whenever the topology is named -- the launcher's
``DTF_*`` variables, ``TF_CONFIG``, ``--worker_hosts`` or the flags --
even at world 1, so a one-rank launch runs the collectives it would run
with more.  Its backend is NCCL for a CUDA device and gloo for the CPU;
a caller may ask for another through :func:`initialize`'s ``backend``
(gloo reduces CUDA tensors through the host, and lets two ranks share
one card, which NCCL refuses).  Rank-concept map (SURVEY §5.8):
``hvd.rank()`` -> :func:`process_index`, ``hvd.size()`` ->
:func:`process_count`, ``hvd.local_rank()`` -> ``MeshRuntime.local_rank``.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from dtf_tpu_torch.runtime.device import resolve_device

log = logging.getLogger("dtf_tpu_torch")

SINGLE_DEVICE = ("off", "one_device")
LOCAL_STRATEGIES = ("mirrored", "tpu")
# how long the rendezvous and each collective wait for a peer before
# raising: a dead rank fails its peers instead of hanging them.  The
# environment's TIMEOUT_ENV (seconds) overrides it for a run, so a test's
# ranks fail well inside the test's own limit
TIMEOUT_S = 300.0
TIMEOUT_ENV = "DTF_COLLECTIVE_TIMEOUT_S"


def collective_timeout_s() -> float:
    """The process group's timeout: ``TIMEOUT_ENV`` when set, else
    ``TIMEOUT_S``."""
    return float(os.environ.get(TIMEOUT_ENV) or TIMEOUT_S)


@dataclasses.dataclass
class MeshRuntime:
    """One process's place on the grid: its rank, the data axis's size
    ``num_replicas`` (the replicas of the model), its device, and the
    process groups (None at world 1 without a named topology: every
    collective is then the identity)."""

    strategy: str
    num_replicas: int = 1
    rank: int = 0
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None
    model_parallelism: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    seq_parallelism: int = 1
    seq_group: Optional[dist.ProcessGroup] = None
    reduce_group: Optional[dist.ProcessGroup] = None
    slice_group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        one_axis = self.seq_parallelism == 1
        if (self.data_group is None and self.model_parallelism == 1
                and one_axis):
            self.data_group = self.group
        if self.reduce_group is None and one_axis:
            self.reduce_group = self.data_group
        if self.slice_group is None and one_axis:
            self.slice_group = self.group

    @property
    def data_index(self) -> int:
        """This rank's replica: its input shard and its ZeRO slice."""
        return self.rank // (self.model_parallelism * self.seq_parallelism)

    @property
    def seq_index(self) -> int:
        """This rank's place on the seq ring: its columns of the
        sequence."""
        return (self.rank // self.model_parallelism) % self.seq_parallelism

    @property
    def model_index(self) -> int:
        """This rank's model shard."""
        return self.rank % self.model_parallelism

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def shutdown(self) -> None:
        """Destroy the process group (idempotent)."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = self.data_group = self.model_group = None
        self.seq_group = self.reduce_group = self.slice_group = None


def local_device_count(device_type: str) -> int:
    """Devices one host offers the mirrored strategy: its CUDA cards,
    or 1 for the CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def mirrored_world(cfg) -> int:
    """The ranks a ``mirrored`` command with no named topology would
    start: the host's devices, capped by ``--num_devices``."""
    n = local_device_count(torch.device(cfg.device).type)
    if cfg.num_devices:
        n = min(n, cfg.num_devices)
    return max(n, 1)


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(cfg, backend: Optional[str] = None) -> MeshRuntime:
    """Build the runtime for ``cfg.distribution_strategy`` on
    ``cfg.device``, joining the process group first where the topology
    is named.  Call it before anything else touches CUDA: it picks this
    rank's card (``cuda:{local_rank % device_count}``) and makes it
    current."""
    strategy = cfg.distribution_strategy
    if strategy == "parameter_server" and cfg.ps_mode == "async":
        raise ValueError(
            "--ps_mode async has no mesh runtime: cli/runner.py run "
            "dispatches it to parallel/ps.py run_async before initialize, "
            "and async workers join no process group")
    world = cfg.process_count
    if strategy in SINGLE_DEVICE:
        if world and world > 1:
            raise ValueError(
                f"--distribution_strategy {strategy} runs one process, "
                f"but the topology names {world}")
        world = None
    mp = max(int(getattr(cfg, "model_parallelism", 1) or 1), 1)
    sp = max(int(getattr(cfg, "seq_parallelism", 1) or 1), 1)
    if (world or 1) % (mp * sp):
        raise ValueError(
            f"{world or 1} devices not divisible by "
            f"model_parallelism*seq_parallelism={mp * sp}")
    if not world:
        dev = resolve_device(cfg.device)
        if strategy in LOCAL_STRATEGIES and mirrored_world(cfg) > 1:
            raise ValueError(
                f"--distribution_strategy {strategy} over "
                f"{mirrored_world(cfg)} devices needs one process a "
                f"device: start it through dtf_tpu_torch.cli.launch (the "
                f"mains do so themselves)")
        log.info("mesh initialized: strategy=%s replicas=1 device=%s",
                 strategy, dev)
        return MeshRuntime(strategy=strategy, device=dev)

    if not cfg.coordinator_address or cfg.process_id is None:
        raise ValueError(
            "a multi-process run needs coordinator_address and process_id "
            "(set the flags, the DTF_* environment or TF_CONFIG)")
    rank = cfg.process_id
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside 0..{world - 1}")
    dev = resolve_device(cfg.device)
    # the launcher's local fan-out puts every rank on one host and the
    # ssh fan-out one rank a host; either way rank % count names a card
    local_rank = rank
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=_init_method(cfg.coordinator_address),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=collective_timeout_s()), **kw)
    groups = _grid_groups(world, mp, sp, rank)
    log.info("mesh initialized: strategy=%s replicas=%d seq=%d model=%d "
             "rank=%d device=%s backend=%s", strategy, world // (mp * sp),
             sp, mp, rank, dev, backend)
    return MeshRuntime(strategy=strategy, num_replicas=world // (mp * sp),
                       rank=rank, local_rank=local_rank, device=dev,
                       group=dist.group.WORLD, backend=backend,
                       model_parallelism=mp, seq_parallelism=sp, **groups)


def grid_ranks(world: int, mp: int, sp: int = 1) -> dict:
    """The grid's process groups as rank lists, by name (``data``,
    ``seq``, ``model``, ``reduce`` = data x seq, ``slice`` = data x
    model): rank r at data index r // (sp * mp), seq index (r // mp) % sp
    and model index r % mp, each list in rank order."""
    dp = world // (mp * sp)
    at = lambda d, s, m: (d * sp + s) * mp + m
    D, S, M = range(dp), range(sp), range(mp)
    return {
        "data": [[at(d, s, m) for d in D] for s in S for m in M],
        "seq": [[at(d, s, m) for s in S] for d in D for m in M],
        "model": [[at(d, s, m) for m in M] for d in D for s in S],
        "reduce": [[at(d, s, m) for d in D for s in S] for m in M],
        "slice": [[at(d, s, m) for d in D for m in M] for s in S],
    }


def _grid_groups(world: int, mp: int, sp: int, rank: int) -> dict:
    """This rank's groups as ``MeshRuntime`` fields: the world for an
    axis group that spans it, None for an axis of size 1, else new
    groups, which every rank creates in the same order."""
    sizes = {"data": world // (mp * sp), "seq": sp, "model": mp,
             "reduce": world // mp, "slice": world // sp}
    mine = {}
    for name, axes in grid_ranks(world, mp, sp).items():
        if sizes[name] == 1 and name in ("seq", "model"):
            mine[name] = None
        elif sizes[name] == world:
            mine[name] = dist.group.WORLD
        else:
            for ranks in axes:
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[name] = g
    return {f"{name}_group": g for name, g in mine.items()}


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """The hvd-rank-0 predicate that gates logs and files."""
    return process_index() == 0


def run_world(cfg) -> int:
    """The ranks a run of ``cfg`` has, known before any process group
    exists (the planner resolves ``--plan`` from it): the named
    topology's count, else a ``mirrored`` command's local devices
    (:func:`mirrored_world`), else 1."""
    if cfg.distribution_strategy in SINGLE_DEVICE:
        return 1
    if cfg.process_count:
        return int(cfg.process_count)
    if cfg.distribution_strategy in LOCAL_STRATEGIES:
        return mirrored_world(cfg)
    return 1


def count_hosts(cfg) -> int:
    """The hosts a run of ``cfg`` spans, from its named topology: the
    distinct host names of ``TF_CONFIG``'s cluster or of
    ``--worker_hosts``; else, for the launcher's environment, one host
    when the rendezvous is local (the local fan-out: ``localhost``, a
    ``file://`` store, this host's name) and one a rank when it is not
    (``cli/launch.py --hosts`` puts one rank on each host); else one."""
    addrs = []
    if os.environ.get("TF_CONFIG"):
        try:
            cluster = json.loads(os.environ["TF_CONFIG"]).get("cluster", {})
        except (json.JSONDecodeError, AttributeError):
            cluster = {}
        addrs = list(cluster.get("ps", [])) + list(cluster.get("worker", []))
    elif cfg.worker_hosts:
        addrs = cfg.worker_hosts.split(",")
    if addrs:
        return max(len({a.strip().rsplit(":", 1)[0] for a in addrs
                        if a.strip()}), 1)
    coordinator = cfg.coordinator_address or ""
    if not cfg.process_count or not coordinator or "://" in coordinator:
        return 1
    host = coordinator.rsplit(":", 1)[0].strip("[]")
    local = ("localhost", "127.0.0.1", "::1", "0.0.0.0",
             socket.gethostname())
    return 1 if host in local else int(cfg.process_count)


def topology(cfg=None) -> dict:
    """Hosts, devices a host and the platform, as the JAX package's
    ``topology()`` reports them, for a run of ``cfg`` (the parsed flags
    and the environment; the defaults when None) before it joins a
    process group.  One rank is one device; the hosts are the named
    topology's (:func:`count_hosts`), its ranks spread over them.  On
    CUDA (which must be there: :func:`resolve_device` raises without a
    card), ``cards_per_host`` is the host's cards, ``ranks_per_device``
    how many ranks share one (``cuda:{rank % device_count}``) and
    ``device_memory`` a card's ``total_memory``."""
    if cfg is None:
        from dtf_tpu_torch.config.flags import Config, apply_env_topology
        cfg = apply_env_topology(Config(
            device="cuda" if torch.cuda.is_available() else "cpu"))
    world = run_world(cfg)
    hosts = min(count_hosts(cfg), world)
    per_host = -(-world // hosts)
    out = {"num_hosts": hosts, "devices_per_host": per_host,
           "platform": "cpu", "cards_per_host": 0, "ranks_per_device": 1,
           "device_memory": 0}
    if resolve_device(cfg.device).type == "cuda":
        cards = torch.cuda.device_count()
        out.update(platform="gpu", cards_per_host=cards,
                   ranks_per_device=-(-per_host // cards),
                   device_memory=int(torch.cuda.get_device_properties(
                       0).total_memory))
    return out
