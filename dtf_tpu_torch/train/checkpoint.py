"""Checkpoint / resume with integrity verification -- the PyTorch
counterpart of ``dtf_tpu/train/checkpoint.py``, with a ``torch.save``
payload in place of orbax.

Layout, topology-free as the JAX package's:

  ``<model_dir>/checkpoints/<step>/state.pt`` -- one ``torch.save`` file
      of CPU tensors keyed by the canonical flax paths of the JAX
      ``TrainState`` (``params/...``, ``batch_stats/...``,
      ``opt_state/...``, ``step``, ``loss_scale``, ``good_steps``; see
      ``convert.state_to_flat``), each in its flax layout.  Written as
      ``<step>.tmp-<pid>/``, the file and the directory fsynced, then
      ``os.replace``d into place: a crash mid-write leaves a temp
      directory, never a half-written step.
  ``<model_dir>/checkpoints.meta/manifest_<step>.json`` -- the
      integrity manifest, written atomically after the payload: each
      file's size and sha256, and ``host_state`` (seed, global step,
      epoch, step in epoch, topology, data position), the host half of
      crash-exact resume.  Same scheme and JSON keys as the JAX
      package's.

Restore verifies the newest step against its manifest and FALLS BACK
to the next older step on corruption or an unreadable payload, with a
structured ``ckpt_integrity`` anomaly -- a torn newest checkpoint costs
one checkpoint interval, not the run.  ``torch.load(...,
weights_only=True)`` reads the payload; the caller moves it to its
device.

Every save is synchronous and sealed (payload, fsync, manifest) before
``save`` returns -- what the JAX package does for its interval and
preemption saves; its epoch-end saves are asynchronous, here they are
sealed too.  In a data-parallel run the state is replicated after the
all-reduce, so the coordinator (rank 0) writes and every rank passes a
barrier before going on; on restore, rank 0 picks the step (fallback
included) and every rank reads that same step.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from typing import Callable, List, Optional, Tuple

import torch

from dtf_tpu_torch import chaos
from dtf_tpu_torch.obs import trace

log = logging.getLogger("dtf_tpu_torch")

PAYLOAD = "state.pt"


# ---------------------------------------------------------------------------
# Integrity manifests (module-level: the serve bridge's structure-free
# loader shares them with the Checkpointer)
# ---------------------------------------------------------------------------

def meta_dir(ckpt_directory: str) -> str:
    """Manifest directory for a checkpoints root: a SIBLING of it, so
    the checkpoints root holds step directories only."""
    return ckpt_directory.rstrip("/") + ".meta"


def manifest_path(ckpt_directory: str, step: int) -> str:
    return os.path.join(meta_dir(ckpt_directory), f"manifest_{int(step)}.json")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_manifest(ckpt_directory: str, step: int,
                   host_state: Optional[dict] = None) -> str:
    """Seal a COMPLETED step directory: digest every file, write the
    manifest atomically (tmp + rename)."""
    step_dir = os.path.join(ckpt_directory, str(int(step)))
    files = {}
    for root, _, names in os.walk(step_dir):
        for name in sorted(names):
            full = os.path.join(root, name)
            rel = os.path.relpath(full, step_dir)
            files[rel] = {"size": os.path.getsize(full),
                          "sha256": _sha256(full)}
    payload = {"step": int(step), "files": files,
               "host_state": dict(host_state or {})}
    path = manifest_path(ckpt_directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_manifest(ckpt_directory: str, step: int) -> Optional[dict]:
    """The manifest dict, or None when missing/unreadable (a torn or
    corrupt manifest reads as 'unverified', not as 'corrupt payload' --
    the payload may be fine and restore is still attempted)."""
    try:
        with open(manifest_path(ckpt_directory, step)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verify_step(ckpt_directory: str, step: int) -> str:
    """Integrity verdict for one step: ``"ok"`` (manifest present, every
    file matches), ``"corrupt"`` (manifest present, a file is missing /
    resized / digest-mismatched -- truncation and bit-rot both land
    here), or ``"unverified"`` (no readable manifest: the process died
    between the payload and the seal)."""
    manifest = read_manifest(ckpt_directory, step)
    if manifest is None:
        return "unverified"
    step_dir = os.path.join(ckpt_directory, str(int(step)))
    for rel, info in manifest.get("files", {}).items():
        full = os.path.join(step_dir, rel)
        try:
            if os.path.getsize(full) != info["size"]:
                return "corrupt"
            if _sha256(full) != info["sha256"]:
                return "corrupt"
        except OSError:
            return "corrupt"
    return "ok"


def truncate_largest_file(directory: str) -> Optional[str]:
    """Halve the largest file under ``directory`` -- the payload of the
    ckpt_truncate fault (the torn write a preempted save leaves behind,
    minus the nondeterminism).  Returns the truncated path, or None
    when the tree holds no files."""
    largest: Tuple[int, Optional[str]] = (0, None)
    for root, _, names in os.walk(os.path.abspath(directory)):
        for name in names:
            full = os.path.join(root, name)
            try:
                size = os.path.getsize(full)
            except OSError:
                continue
            if size > largest[0]:
                largest = (size, full)
    size, victim = largest
    if victim is None:
        return None
    with open(victim, "r+b") as f:
        f.truncate(max(size // 2, 1))
    log.error("chaos: truncated %s (%d -> %d bytes)", victim, size,
              max(size // 2, 1))
    return victim


def step_dirs(ckpt_directory: str) -> List[int]:
    """The step directories under a checkpoints root, oldest first
    (temp directories of unfinished writes are not steps)."""
    try:
        names = os.listdir(ckpt_directory)
    except OSError:
        return []
    return sorted(int(n) for n in names if n.isdigit()
                  and os.path.isdir(os.path.join(ckpt_directory, n)))


def _load_payload(ckpt_directory: str, step: int) -> dict:
    # mmap: the tensors page in from the file as they are copied to the
    # device, with no second copy of the whole payload in host memory
    return torch.load(os.path.join(ckpt_directory, str(int(step)), PAYLOAD),
                      map_location="cpu", weights_only=True, mmap=True)


def _restore_walk(directory: str, step: Optional[int],
                  what: str = "checkpoint"):
    """(step, payload) of the newest usable step -- or of ``step``,
    which raises instead of falling back -- else None.  A step that
    fails verification or whose payload does not load is skipped with a
    ``ckpt_integrity`` anomaly."""
    explicit = step is not None
    candidates = [int(step)] if explicit else step_dirs(directory)[::-1]
    for s in candidates:
        verdict = verify_step(directory, s)
        if verdict == "corrupt":
            trace.anomaly("ckpt_integrity", step=s, verdict=verdict,
                          action="raise" if explicit else "fallback")
            log.error("%s step %d FAILED integrity verification", what, s)
            if explicit:
                raise OSError(f"checkpoint step {s} under {directory} "
                              f"failed integrity verification")
            continue
        try:
            with trace.span("checkpoint_restore", step=s,
                            verified=(verdict == "ok")):
                payload = _load_payload(directory, s)
        except Exception as e:  # noqa: BLE001 -- torch.load raises many types
            if explicit:
                raise
            trace.anomaly("ckpt_integrity", step=s, verdict="unreadable",
                          error=type(e).__name__, action="fallback")
            log.error("%s step %d unreadable (%s: %s) -- falling back",
                      what, s, type(e).__name__, e)
            continue
        if candidates and s != candidates[0]:
            log.warning("%s restore FELL BACK: step %d (newest %d failed "
                        "verification or restore) -- one checkpoint "
                        "interval of work re-trains", what, s,
                        candidates[0])
        return s, payload
    if candidates:
        trace.anomaly("ckpt_integrity", step=candidates[0],
                      verdict="none_usable", action="from_scratch")
        log.error("NO %s under %s survived verification", what, directory)
    return None


class Checkpointer:
    """Training-state save/restore under ``<model_dir>/checkpoints``,
    with digest manifests under ``<model_dir>/checkpoints.meta``.

    ``runtime`` (``runtime/mesh.py`` MeshRuntime) makes saves and
    restores collective: the coordinator writes, every rank passes a
    barrier, and a restore's step is the coordinator's choice.  None is
    one process.  ``max_to_keep`` prunes the oldest of this run's own
    saves; ``gc`` bounds the steps earlier runs left."""

    def __init__(self, model_dir: str, max_to_keep: int = 3, runtime=None):
        self.directory = os.path.abspath(os.path.join(model_dir,
                                                      "checkpoints"))
        self.group = getattr(runtime, "group", None)
        self.writer = runtime is None or runtime.is_coordinator
        if self.writer:
            os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(int(max_to_keep), 1)
        self._saved: List[int] = []
        # which step the last restore() actually used (fallbacks move it
        # below latest_step; callers reposition their data stream on it)
        self.last_restored_step: Optional[int] = None
        # the last save's and restore's seconds and bytes
        self.timings: dict = {}

    def _barrier(self) -> None:
        if self.group is not None:
            torch.distributed.barrier(group=self.group)

    def save(self, payload_fn: Callable[[], dict], step: int,
             host_state: Optional[dict] = None) -> None:
        """Write, fsync and seal step ``step``: ``payload_fn()`` (a flat
        dict of CPU tensors, called on the writer only), then the
        manifest with ``host_state``; every rank returns after the
        write is durable."""
        step = int(step)
        # every rank keeps the bookkeeping, so every rank reaches the
        # same decisions (and barriers) from it
        if step not in self._saved:
            self._saved.append(step)
        doomed = self._saved[:-self.max_to_keep]
        del self._saved[:-self.max_to_keep]
        if self.writer:
            with trace.span("checkpoint_save", step=step, sync=True):
                self._write(payload_fn, step, host_state)
            for s in doomed:
                self._delete(s)
        t0 = time.perf_counter()
        self._barrier()
        if self.writer:
            self.timings["save"]["barrier_s"] = time.perf_counter() - t0
        log.info("checkpoint saved: step %d -> %s (sealed)", step,
                 self.directory)

    def _write(self, payload_fn, step: int, host_state) -> None:
        t0 = time.perf_counter()
        payload = payload_fn()
        t1 = time.perf_counter()
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, PAYLOAD)
        with open(path, "wb") as f:
            torch.save(payload, f)
            t2 = time.perf_counter()
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        t3 = time.perf_counter()
        if os.path.isdir(final):
            # a step re-saved (a resume past a corrupt newest step): its
            # manifest goes first, so no seal ever names the new bytes
            # before they are in place
            try:
                os.unlink(manifest_path(self.directory, step))
            except OSError:
                pass
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.directory)
        write_manifest(self.directory, step, host_state)
        t4 = time.perf_counter()
        self.timings["save"] = {
            "step": step, "bytes": os.path.getsize(os.path.join(final,
                                                                PAYLOAD)),
            "state_to_host_s": t1 - t0, "payload_s": t2 - t1,
            "fsync_s": t3 - t2, "sha256_s": t4 - t3, "total_s": t4 - t0}

    def _delete(self, step: int) -> None:
        shutil.rmtree(os.path.join(self.directory, str(step)),
                      ignore_errors=True)
        try:
            os.unlink(manifest_path(self.directory, step))
        except OSError:
            pass

    def saved(self, step: int) -> bool:
        """True when this run saved ``step`` already (an interval save
        on an epoch or preemption boundary)."""
        return int(step) in self._saved

    def all_steps(self) -> List[int]:
        return step_dirs(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> str:
        return verify_step(self.directory, step)

    def verified_steps(self) -> List[int]:
        return [s for s in self.all_steps() if self.verify(s) == "ok"]

    def host_state(self, step: int) -> Optional[dict]:
        m = read_manifest(self.directory, step)
        return None if m is None else m.get("host_state") or None

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The payload (flat dict of CPU tensors) of the newest usable
        step, or of ``step`` (verification failure raises); None when
        no step survives.  ``ckpt_truncate@latest`` fires here first.
        Collective under a runtime with a group: the coordinator walks
        the candidates and every rank loads the step it chose."""
        t0 = time.perf_counter()
        chosen = None
        if self.writer:
            if chaos.ckpt_truncate():
                steps = self.all_steps()
                if steps:
                    truncate_largest_file(os.path.join(self.directory,
                                                       str(steps[-1])))
            chosen = _restore_walk(self.directory, step)
        if self.group is not None:
            box = [None if chosen is None else chosen[0]]
            torch.distributed.broadcast_object_list(box, src=0,
                                                    group=self.group)
            if not self.writer and box[0] is not None:
                # the coordinator verified it; read it as is
                chosen = (box[0], _load_payload(self.directory, box[0]))
        if chosen is None:
            return None
        s, payload = chosen
        self.last_restored_step = s
        self.timings["restore"] = {"step": s,
                                   "total_s": time.perf_counter() - t0}
        log.info("checkpoint restored: step %d from %s", s, self.directory)
        return payload

    def gc(self, keep: int) -> List[int]:
        """Cross-run GC by VERIFIED-set: delete every step except the
        newest ``keep`` sha256-verified ones (``--checkpoint_keep``).

        Safety rules (the reason this is by verified-set, not by age):
          - steps NEWER than the newest verified step are never deleted
            -- an unverified newest may be another process's in-flight
            save, and a newest-only-unverified state must keep its
            fallback chain intact;
          - with NO verified step at all, nothing is deleted (GC must
            never convert "all unverified" into "nothing left");
          - deletion enumerates the directory, so previous runs' steps
            are seen.

        Returns the deleted step numbers."""
        if keep <= 0:
            return []
        steps = self.all_steps()
        # newest first, stopping after `keep` verified steps: every step
        # older than the newest verified one is deleted unless kept, so
        # re-hashing the doomed tail changes nothing
        verified: List[int] = []
        for s in reversed(steps):
            if self.verify(s) == "ok":
                verified.append(s)
                if len(verified) == keep:
                    break
        if not verified:
            log.warning("checkpoint gc: no sha256-verified step under "
                        "%s -- nothing deleted", self.directory)
            return []
        keep_set = set(verified)
        doomed = [s for s in steps if s not in keep_set and s < verified[0]]
        for s in doomed:
            self._delete(s)
        if doomed:
            log.info("checkpoint gc: kept %d verified step(s) %s, "
                     "deleted %s", len(keep_set), sorted(keep_set), doomed)
        return doomed


def export_model(export_dir: str, model, flat: Optional[dict] = None
                 ) -> str:
    """``--export_dir``: the inference variables (``params`` and
    ``batch_stats``, no optimizer state) as one ``torch.save`` file of
    flax-keyed CPU tensors under ``<export_dir>/model/``: ``model``'s,
    or ``flat`` (a tensor-parallel run's full leaves, gathered).
    Returns the written path."""
    from dtf_tpu_torch.convert import model_to_flat

    directory = os.path.abspath(os.path.join(export_dir, "model"))
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, PAYLOAD)
    tmp = f"{path}.tmp.{os.getpid()}"
    with trace.span("checkpoint_export"):
        with open(tmp, "wb") as f:
            torch.save(model_to_flat(model) if flat is None else flat, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    log.info("model exported to %s", directory)
    return directory


def _inference(payload: dict) -> dict:
    from dtf_tpu_torch.convert import unflatten

    tree = unflatten({k: v for k, v in payload.items()
                      if k.split("/")[0] in ("params", "batch_stats")})
    return {"params": tree.get("params", {}),
            "batch_stats": tree.get("batch_stats", {})}


def load_exported_model(export_dir: str) -> dict:
    """``{"params", "batch_stats"}`` (nested dicts of CPU tensors in the
    flax layout) written by :func:`export_model`."""
    path = os.path.join(os.path.abspath(export_dir), "model", PAYLOAD)
    return _inference(torch.load(path, map_location="cpu",
                                 weights_only=True))


def load_train_checkpoint(model_dir: str, step: Optional[int] = None):
    """Load-for-inference: ``{"params", "batch_stats"}`` of a training
    checkpoint written by :class:`Checkpointer`, without knowing the
    run's optimizer or loss scaling (the optimizer state is dropped).
    Same integrity fallback as the trainer's restore: a corrupt or
    unreadable newest step (the training run may still be saving, or
    died saving) falls back to the newest usable step with a structured
    anomaly.  None when ``model_dir`` has no checkpoint."""
    directory = os.path.abspath(os.path.join(model_dir, "checkpoints"))
    if not os.path.isdir(directory):
        return None
    found = _restore_walk(directory, step, what="serve bridge: checkpoint")
    if found is None:
        return None
    used_step, payload = found
    if "step" not in payload or not any(k.startswith("params/")
                                        for k in payload):
        raise ValueError(f"checkpoint at {directory} step {used_step} is "
                         f"not a training state (keys: "
                         f"{sorted(payload)[:8]})")
    log.info("serve bridge: loaded train checkpoint step %s from %s",
             used_step, directory)
    return _inference(payload)


class CheckpointCallback:
    """Per-epoch save (the ModelCheckpoint-callback equivalent), plus:

      every_steps  -- sealed saves every N global steps (the
          preemption-granularity knob)
      on_preempt   -- the emergency save the loop triggers at the step
          boundary after SIGTERM/SIGINT, durable before the process
          exits EXIT_PREEMPTED
      host_state_fn(step) -- host-side resume payload (data position,
          seed) carried in each save's manifest
      keep         -- cross-run GC budget (--checkpoint_keep): at train
          end, delete all but the newest `keep` verified steps

    ``state_fn(state)`` turns the loop's TrainState into the payload (a
    flat dict of CPU tensors; ``Trainer.checkpoint_payload``).  With
    ``collective`` (ZeRO and tensor parallelism, whose payload is
    gathered from every rank's slices and shards) every rank calls it
    and the writer writes the result.
    """

    def __init__(self, model_dir: str, state_fn: Callable[[object], dict],
                 max_to_keep: int = 3, every_steps: int = 0,
                 host_state_fn=None, keep: int = 0, runtime=None,
                 collective: bool = False):
        self.ckpt = Checkpointer(model_dir, max_to_keep=max_to_keep,
                                 runtime=runtime)
        self.state_fn = state_fn
        self.collective = collective
        self.every_steps = int(every_steps or 0)
        self.host_state_fn = host_state_fn
        self.keep = int(keep or 0)

    def _host(self, step: int) -> dict:
        if self.host_state_fn is None:
            return {"global_step": int(step)}
        payload = dict(self.host_state_fn(int(step)) or {})
        payload.setdefault("global_step", int(step))
        return payload

    def _save(self, state, step: int) -> None:
        if self.collective:
            payload = self.state_fn(state)
            payload_fn = lambda: payload  # noqa: E731
        else:
            payload_fn = lambda: self.state_fn(state)  # noqa: E731
        self.ckpt.save(payload_fn, step=step, host_state=self._host(step))

    def on_batch_end(self, batch: int, logs=None):
        if not self.every_steps or not logs or "state" not in logs:
            return
        step = int(logs["step"])
        if step and step % self.every_steps == 0:
            self._save(logs["state"], step)

    def on_epoch_end(self, epoch: int, logs=None):
        if logs and "state" in logs:
            step = int(logs["state"].step)
            if not self.ckpt.saved(step):
                self._save(logs["state"], step)

    def on_preempt(self, logs=None):
        if not logs or "state" not in logs:
            return
        step = int(logs["step"])
        if not self.ckpt.saved(step):
            self._save(logs["state"], step)

    def on_train_end(self, logs=None):
        if self.keep and self.ckpt.writer:
            # this run's saves are sealed, so they anchor the verified
            # set the GC keeps; the writer only -- deletion is not a
            # collective
            self.ckpt.gc(self.keep)
