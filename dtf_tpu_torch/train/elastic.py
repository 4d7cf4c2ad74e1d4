"""Elastic training: shrink on host or device loss, resume on the
survivors, grow back -- the PyTorch counterpart of
``dtf_tpu/train/elastic.py``.

The pieces that make resuming SMALLER safe are already in place, and
this module is the thin layer that binds them:

  - The checkpoint is canonical (``Trainer.canonical_state``: full
    parameters and optimizer state in the stage-0 layout, full-shaped
    under tensor parallelism too), so it is topology-free: restoring it
    onto the surviving world is ``Trainer.staged_state``, each leaf
    re-sliced through ``train/zero.py``'s layout (``pad_flat`` pads to
    the NEW data-parallel degree with zeros that stay zero).
  - The data stream is a function of position (``cli/runner.py``
    ``make_input_fns``'s ``start_step``): the surviving replicas read
    the same global batches with no bookkeeping.
  - The global batch is fixed by ``--batch_size``; a shrunken world
    gives each replica a larger share of it, so step semantics are
    invariant across a shrink.

The supervisor half lives in ``cli/launch.py`` (standard library only:
it keeps copies of the contracts below, pinned equal by
tests/test_torch_elastic.py): device and host loss are classified apart
from crashes, ``--elastic`` shrinks the world instead of spending the
crash budget, ``--min_devices`` refuses to resume too small,
``--max_elastic`` caps a flapping fabric, and a re-announced capacity
(``elastic_rejoin.json``) grows the job back at a checkpoint boundary.

Divergences from the JAX package, on purpose:

  - One process a device.  The JAX supervisor counts
    ``processes x devices_per_process`` and halves the local device
    count on a device loss; the port's launcher refuses
    ``--devices_per_process``, so here a device is a rank: a host loss
    and a device loss each drop one rank, and the supervisor always
    knows the device total, so ``DTF_ELASTIC_DEVICES`` is always
    exported under ``--elastic`` (the JAX launcher exports it only with
    ``--devices_per_process``).  ``--elastic`` at one rank is refused.
  - The classifier knows the CUDA runtime's device-loss statuses
    besides XLA's, and ``torch.AcceleratorError`` (a ``RuntimeError``
    whose name says nothing of it).  Kernel bugs (an illegal address,
    an unspecified launch failure) and an out-of-memory error stay
    crashes.
  - :func:`check_reshardable` reads the port's shard description: the
    partition rule's ``Split`` of each leaf (``models/partition.py``)
    and its full shape, over ``{"data": dp, "model": mp}``, with the
    axis each split rides: a MoE expert leaf names the data axis under
    that placement (its experts must divide by the new dp), the model
    axis under the other.  Nothing is sharded over the seq axis
    (parameters and ZeRO slices are replicated over it), so there is
    nothing there to check.
  - The world the supervisor sizes is dp x sp x mp
    (:func:`note_elastic_resume`).  A shrink to a world that mp x sp
    does not divide is refused by ``runtime/mesh.py initialize`` with
    the JAX message, as the JAX re-mesh refuses it
    (``dtf_tpu/runtime/mesh.py:179-182``): the rank exits as a crash,
    loudly, never training mis-sharded.
  - :func:`replan_for_surviving` is the JAX body: ``--plan auto``
    re-resolved against the surviving ranks, the global batch kept.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Dict, List, Optional, Sequence

from dtf_tpu_torch.models.partition import Split
from dtf_tpu_torch.obs import trace

log = logging.getLogger("dtf_tpu_torch")

# Exit-code, environment and rendezvous-file contracts shared with
# cli/launch.py and chaos/ (both keep standard-library copies, so the
# supervisor never imports what it supervises; the values are the JAX
# package's)
EXIT_DEVICE_LOST = 76
DEVICES_ENV = "DTF_ELASTIC_DEVICES"
REJOIN_FILE = "elastic_rejoin.json"

# Runtime error texts that mean THE ACCELERATORS ARE GONE rather than a
# bug in the step, matched case-insensitively against the exception's
# type name and message.  XLA's status vocabulary (the JAX package's
# markers), then the CUDA runtime's device-loss statuses as
# cudaGetErrorString words them: cudaErrorNoDevice,
# cudaErrorDevicesUnavailable, cudaErrorECCUncorrectable.
_DEVICE_LOSS_MARKERS = (
    "device_lost", "device lost", "data_loss",
    "failed_precondition: device", "device or resource busy",
    "tpu driver", "device is in an invalid state",
    "no cuda-capable device is detected",
    "cuda-capable device(s) is/are busy or unavailable",
    "uncorrectable ecc error encountered",
)
# the runtime-error families the markers are read in: jaxlib's
# XlaRuntimeError, RuntimeError, and torch.AcceleratorError (torch's
# CUDA error type, a RuntimeError subclass)
_DEVICE_LOSS_TYPES = ("xlaruntimeerror", "runtimeerror", "acceleratorerror")


class DeviceLost(RuntimeError):
    """A runtime failure classified as accelerator loss: the host
    survives but its card is gone.  The train loop converts the
    runtime's exception into this, and the runner exits
    ``EXIT_DEVICE_LOST`` so an ``--elastic`` supervisor resumes on the
    surviving world instead of spending the crash budget on a fault no
    restart at the same size can fix."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(
            f"device loss at step {step}: "
            f"{type(cause).__name__}: {cause}")
        self.step = int(step)
        self.cause = cause


def is_device_loss(exc: BaseException) -> bool:
    """True when ``exc`` is the runtime reporting accelerator loss.  An
    ordinary step error must keep crashing the ordinary way: shrinking a
    healthy topology on a kernel bug would shrink it forever."""
    name = type(exc).__name__.lower()
    if not any(t in name for t in _DEVICE_LOSS_TYPES):
        return False
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(m in text for m in _DEVICE_LOSS_MARKERS)


def announce_rejoin(log_dir: str, devices: int) -> str:
    """Re-announce capacity to a shrunken job's supervisor: write
    ``{"devices": N}`` atomically into its log dir (a healed host's
    agent, an operator, or a test does this).  Once the announced count
    covers the full topology, the supervisor drains the job at a
    checkpoint boundary and relaunches it at full size."""
    path = os.path.join(log_dir, REJOIN_FILE)
    fd, tmp = tempfile.mkstemp(dir=log_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump({"devices": int(devices)}, f)
    os.replace(tmp, path)
    log.info("elastic: re-announced %d device(s) at %s", devices, path)
    return path


def check_reshardable(splits: Dict[str, Optional[Split]],
                      shapes: Dict[str, Sequence[int]],
                      mesh_shape: dict,
                      axes: Optional[Dict[str, str]] = None) -> List[str]:
    """Messages naming the leaves that cannot shard onto a world of
    ``mesh_shape`` (``{"data": dp, "model": mp}``); empty when every
    leaf reshards.

    ``splits`` maps a leaf's name to its partition-rule ``Split`` (None:
    replicated) and ``shapes`` to its full shape; ``axes`` names the
    mesh axis a leaf's split rides (default "model": a tensor-parallel
    dimension or a pipeline stack; "data" for a MoE expert leaf on the
    data axis).  A ZeRO leaf is a flat slice padded to any
    data-parallel degree, and a replicated one is whole on every rank,
    so only a split dimension constrains the world: its axis must
    divide it (per group: ``Split(0, 3)``'s inner third of the rows)."""
    problems: List[str] = []
    for name, split in splits.items():
        axis = (axes or {}).get(name, "model")
        ways = int(mesh_shape.get(axis, 1))
        if split is None or ways == 1:
            continue
        n = int(shapes[name][split.dim])
        inner = n // split.groups
        if n % split.groups or inner % ways:
            problems.append(
                f"{name}: dim {split.dim} ({n}, {split.groups} group(s) "
                f"of {inner}) is not divisible by the {axis} axis "
                f"(size {ways})")
    return problems


def note_elastic_resume(runtime, resumed_step: int) -> None:
    """Under elastic supervision (``DEVICES_ENV`` exported): check that
    the world this attempt joined is the one the supervisor sized it
    for, and record the resume point in the trace, so the steps each
    world trained can be read back.  A no-op outside it."""
    want = os.environ.get(DEVICES_ENV)
    if not want:
        return
    # the grid's world: data x seq x model.  A shrink that leaves a world
    # mp * sp does not divide never gets here: runtime/mesh.py initialize
    # refuses it first with the JAX message (dtf_tpu/runtime/mesh.py
    # 179-182), as the JAX package's re-mesh on the survivors does
    have = (runtime.num_replicas * runtime.model_parallelism
            * runtime.seq_parallelism)
    if int(want) != have:
        raise RuntimeError(
            f"elastic supervisor sized this attempt for {want} "
            f"device(s) but the runtime joined a world of {have} -- the "
            f"relaunch topology does not match the supervisor's "
            f"accounting (a stale DTF_PROCESS_COUNT? another "
            f"--model_parallelism or --seq_parallelism?); refusing to train mis-sharded")
    if resumed_step:
        trace.event("elastic_resume", step=int(resumed_step),
                    devices=have, replicas=runtime.num_replicas)
        log.info("elastic resume: step %d on %d device(s) "
                 "(%d data replicas)", resumed_step, have,
                 runtime.num_replicas)


def replan_for_surviving(cfg, surviving_devices: int):
    """Re-resolve a ``--plan auto`` config against a surviving device
    count -- the reshard-time planning step a shrunken relaunch
    performs implicitly (each relaunched rank's runner resolves
    ``--plan`` against the world it joins).  A pure function, so the
    invariants are test-pinnable without relaunching anything: the
    GLOBAL batch never changes (a plan compiles parallelism flags,
    never the batch), and an infeasible surviving mesh dies loudly at
    resolve time.  A launched world (``process_count``) becomes the
    survivors'; a ``mirrored`` one is capped by the plan's devices."""
    from dtf_tpu_torch.plan import resolve_plan
    from dtf_tpu_torch.plan.mesh_spec import mesh_spec
    n = int(surviving_devices)
    survivors = cfg.replace(process_count=n) if cfg.process_count else cfg
    mesh = mesh_spec("", live_devices=n, cfg=survivors)
    out = resolve_plan(survivors, mesh=mesh)
    if out.batch_size != cfg.batch_size:
        raise AssertionError(
            f"plan re-resolution changed the global batch "
            f"({cfg.batch_size} -> {out.batch_size}) -- step semantics "
            f"would silently differ across the shrink")
    return out
