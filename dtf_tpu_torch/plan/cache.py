"""Ranked-lattice memoization: a JSON sidecar keyed by
(workload, mesh descriptor, batch) so repeated ``--plan auto`` resolves
skip the search.

A copy of ``dtf_tpu/plan/cache.py`` with its imports re-pointed.

The lattice for a big simulated pod is cheap but not free (hundreds of
plans × an analytic predict each), and plan resolution sits at the top
of EVERY planned run — launcher restarts included.  The cache stores
the full ranked artifact per key, so a hit reconstructs the exact
RankedPlan list the search would have produced (same objects the
ranking table, ``--out`` artifact, and ``--plan auto`` pick consume).

Key = sha1 over everything that determines the ranking: the cache
format version, the workload fingerprint (model name, family, seq_len,
EXACT param count — a registry edit that changes the model changes the
key), the full mesh descriptor dict, the global batch, the optimizer,
and the HBM fraction.  Anything else (a cost-model change) bumps
``CACHE_VERSION`` to invalidate wholesale.

Corrupt or unreadable sidecars degrade to a recompute with a warning —
a cache must never be able to fail a run.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from typing import List, Optional, Tuple

from dtf_tpu_torch.plan.cost_model import (DEFAULT_OVERLAP_FRAC, HBM_FRACTION,
                                     Plan, PlanCost)
from dtf_tpu_torch.plan.mesh_spec import MeshSpec
from dtf_tpu_torch.plan.model_stats import ModelStats
from dtf_tpu_torch.plan.search import RankedPlan, search

log = logging.getLogger("dtf_tpu_torch")

# bump when the ranking function changes (cost model, lattice, sort
# order) — stale entries must not resurrect an old ranking.
# v2: ZeRO stages 2/3 in the lattice + stage-aware wire-volume /
#     peak-bytes terms + the exposed-comm overlap term (overlap_frac
#     joins the key) — a v1 entry describes a DIFFERENT ranking
#     function and must recompute, not serve
# v3: measured-overlap calibration section — `plan_main --calibrate`
#     persists plan_overlap_frac_implied per (workload, mesh) and
#     auto-resolution (`--plan auto` with a cache, rankings without an
#     explicit --overlap_frac) reads it back, so the overlap fraction
#     an entry was ranked under may now be a measured number a v2 file
#     cannot carry — v2 entries recompute, not serve
CACHE_VERSION = 3


def cache_key(stats: ModelStats, mesh: MeshSpec, global_batch: int,
              optimizer: str, hbm_fraction: float = HBM_FRACTION,
              overlap_frac: float = DEFAULT_OVERLAP_FRAC
              ) -> Tuple[str, dict]:
    """(sha1 hex key, the human-readable payload stored beside it)."""
    payload = {
        "cache_version": CACHE_VERSION,
        "model": stats.model,
        "family": stats.family,
        "seq_len": stats.seq_len,
        "params": stats.params,
        "mesh": mesh.to_dict(),
        "global_batch": int(global_batch),
        "optimizer": optimizer,
        "hbm_fraction": hbm_fraction,
        "overlap_frac": overlap_frac,
    }
    blob = json.dumps(payload, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest(), payload


def _ranked_from_dict(d: dict) -> RankedPlan:
    pred = dict(d["predicted"])
    pred.pop("feasible", None)            # a property, not a field
    return RankedPlan(plan=Plan.from_dict(d["plan"]),
                      cost=PlanCost(**pred),
                      violations=tuple(d.get("violations", ())))


def load_ranking(path: str, key: str) -> Optional[List[RankedPlan]]:
    """The cached ranking for ``key``, or None (miss / unreadable —
    unreadable warns and recomputes, it never raises)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
        entry = doc.get("entries", {}).get(key)
        if entry is None:
            return None
        return [_ranked_from_dict(r) for r in entry["ranked"]]
    except (OSError, ValueError, KeyError, TypeError) as e:
        log.warning("plan cache %s unreadable (%s: %s) — recomputing",
                    path, type(e).__name__, e)
        return None


def _merge_into_doc(path: str, mutate) -> None:
    """Read-modify-write the sidecar atomically (tmp + rename — two
    racing writers at worst each write a complete file).  A
    version-mismatched or corrupt existing file is overwritten fresh.
    Write failures warn and continue: the result in hand is
    unaffected."""
    try:
        doc = {"cache_version": CACHE_VERSION, "entries": {}}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    existing = json.load(f)
                if existing.get("cache_version") == CACHE_VERSION:
                    doc = existing
            except (OSError, ValueError):
                pass                      # overwrite the corrupt file
        mutate(doc)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except OSError as e:
        log.warning("plan cache %s not writable (%s) — result still "
                    "used, just not memoized", path, e)


def store_ranking(path: str, key: str, payload: dict,
                  ranked: List[RankedPlan]) -> None:
    """Merge one ranking entry into the sidecar."""
    def mutate(doc):
        doc.setdefault("entries", {})[key] = {
            "workload": payload,
            "ranked": [r.to_dict() for r in ranked],
        }
    _merge_into_doc(path, mutate)


# ---------------------------------------------------------------------------
# Measured-overlap calibration (the --calibrate feedback loop).  The
# cost model's ZeRO-2/3 exposed-comm term credits an overlap fraction;
# `plan_main --calibrate` MEASURES the implied fraction on a live box
# (plan_overlap_frac_implied).  Persisting it here, keyed by (workload,
# mesh) — NOT by batch or optimizer, which don't change how well the
# scheduler hides the wire — closes the loop without an operator:
# every later `--plan auto` resolve and ranking against the same cache
# uses the measured fraction instead of DEFAULT_OVERLAP_FRAC.
# ---------------------------------------------------------------------------

def calibration_key(stats: ModelStats, mesh: MeshSpec) -> Tuple[str, dict]:
    """(sha1 hex key, human-readable payload) for one calibration
    point."""
    payload = {
        "cache_version": CACHE_VERSION,
        "model": stats.model,
        "family": stats.family,
        "seq_len": stats.seq_len,
        "params": stats.params,
        "mesh": mesh.to_dict(),
    }
    blob = json.dumps(payload, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest(), payload


def store_calibration(path: str, stats: ModelStats, mesh: MeshSpec,
                      overlap_frac_implied: float) -> None:
    """Persist a measured overlap fraction for (workload, mesh)."""
    key, payload = calibration_key(stats, mesh)
    def mutate(doc):
        doc.setdefault("calibrations", {})[key] = {
            "workload": payload,
            "overlap_frac_implied": float(overlap_frac_implied),
        }
    _merge_into_doc(path, mutate)
    log.info("plan cache: persisted measured overlap_frac %.2f for "
             "(%s, %s)", overlap_frac_implied, stats.model, mesh.name)


def load_calibration(path: str, stats: ModelStats,
                     mesh: MeshSpec) -> Optional[float]:
    """The persisted measured overlap fraction for (workload, mesh), or
    None (no calibration / unreadable / out-of-range — all degrade to
    the model default, never to an error)."""
    if not os.path.exists(path):
        return None
    key, _ = calibration_key(stats, mesh)
    try:
        with open(path) as f:
            doc = json.load(f)
        entry = doc.get("calibrations", {}).get(key)
        if entry is None:
            return None
        val = float(entry["overlap_frac_implied"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        log.warning("plan cache %s calibration unreadable (%s: %s) — "
                    "using the default overlap fraction", path,
                    type(e).__name__, e)
        return None
    return val if 0.0 <= val <= 1.0 else None


def cached_search(path: str, stats: ModelStats, mesh: MeshSpec,
                  global_batch: int, optimizer: str = "sgd",
                  overlap_frac: Optional[float] = None
                  ) -> Tuple[List[RankedPlan], bool]:
    """search() through the sidecar: (ranked, was_a_hit).

    ``overlap_frac=None`` means AUTO: use the persisted measured
    calibration for this (workload, mesh) when one exists — the
    ``--calibrate`` feedback loop closing without an operator — else
    ``DEFAULT_OVERLAP_FRAC``.  An explicit value always wins.  The
    fraction is part of the ranking key, so a fresh calibration never
    serves a stale ranking."""
    if overlap_frac is None:
        cal = load_calibration(path, stats, mesh)
        if cal is not None:
            log.info("plan cache: using calibrated overlap_frac %.2f "
                     "for (%s, %s)", cal, stats.model, mesh.name)
        overlap_frac = cal if cal is not None else DEFAULT_OVERLAP_FRAC
    key, payload = cache_key(stats, mesh, global_batch, optimizer,
                             overlap_frac=overlap_frac)
    cached = load_ranking(path, key)
    if cached is not None:
        log.info("plan cache hit (%s, %s, batch %d) — search skipped",
                 stats.model, mesh.name, global_batch)
        return cached, True
    ranked = search(stats, mesh, global_batch, optimizer=optimizer,
                    overlap_frac=overlap_frac)
    store_ranking(path, key, payload, ranked)
    return ranked, False
