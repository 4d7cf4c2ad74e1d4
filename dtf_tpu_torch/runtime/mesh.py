"""Process and device initialization for data parallelism -- the
PyTorch counterpart of ``dtf_tpu/runtime/mesh.py``.

The JAX package runs one process over all of a host's chips and builds a
``Mesh`` whose 'data' axis carries the replicas.  PyTorch's idiom is one
process a device, so here a replica is a process: its rank is its
position on the data axis, and the process group is the axis.  Only the
'data' axis is ported; the 'seq' and 'model' axes wait for tensor,
sequence and pipeline parallelism.

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
import logging
from typing import Optional

import torch
import torch.distributed as dist

from dtf_tpu_torch.runtime.device import resolve_device

log = logging.getLogger("dtf_tpu_torch")

SINGLE_DEVICE = ("off", "one_device")
LOCAL_STRATEGIES = ("mirrored", "tpu")
# how long the rendezvous and each collective wait for a peer before
# raising: a dead rank fails its peers instead of hanging them
TIMEOUT_S = 300.0


@dataclasses.dataclass
class MeshRuntime:
    """The data axis of one process: its rank among ``num_replicas``,
    its device, and the process group (None at world 1 without a
    named topology: every collective is then the identity)."""

    strategy: str
    num_replicas: int = 1
    rank: int = 0
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def shutdown(self) -> None:
        """Destroy the process group (idempotent)."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = None


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
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    log.info("mesh initialized: strategy=%s replicas=%d rank=%d device=%s "
             "backend=%s", strategy, world, rank, dev, backend)
    return MeshRuntime(strategy=strategy, num_replicas=world, rank=rank,
                       local_rank=local_rank, device=dev,
                       group=dist.group.WORLD, backend=backend)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """The hvd-rank-0 predicate that gates logs and files."""
    return process_index() == 0


def topology() -> dict:
    """Hosts (processes), devices a host, and the platform, as the JAX
    package's ``topology()`` reports them: one device a process here."""
    return {"num_hosts": process_count(), "devices_per_host": 1,
            "platform": "gpu" if torch.cuda.is_available() else "cpu"}
