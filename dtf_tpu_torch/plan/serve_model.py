"""Trace-driven serving-capacity simulator — the analytic fleet model.

A copy of ``dtf_tpu/plan/serve_model.py`` with its imports re-pointed.

The training planner (plan/cost_model.py) ranks parallelism plans by
predicting step time from an analytic model calibrated against
measurement.  This module extends that discipline from training steps
to serving FLEETS: replay an arrival process (plan/serve_trace.py —
recorded router/replica traces, or synthetic Poisson/burst/shared-
prefix mixes) through an analytic model of the serving tier and answer
capacity questions without burning hardware — the DistIR/AMP idea
(arXiv:2111.05426, arXiv:2210.07297) pointed at the replica tier.

The model is the SERVING STACK'S OWN ARCHITECTURE, miniaturized:

  router    — admission bound (shed past ``admission_limit``
              outstanding), placement (prefix-affine with least-loaded
              fallback, or pure least-loaded), per-replica inflight
              cap, Backpressure when every replica's queue is full,
              deadline verdicts.
  replica   — the engine loop, iteration-granular: each iteration runs
              at most ONE prefill chunk (round-robin across prefilling
              slots — the PR-3 scheduling contract) plus one decode
              step advancing every decoding slot by one token;
              iteration wall time is the calibrated chunk/step service
              times (plus a per-iteration overhead term).
  admission — the engine's page math: a request needs
              ⌈(prompt + budget) / page_size⌉ pages, FIFO head-of-line
              when the pool cannot cover them, registry-only prefix
              pages evicted to un-starve admission.
  prefix    — a registry model per replica: the first completed
              prefill of a group registers its full prompt pages;
              later admits of the group share them (fewer fresh pages,
              fewer prefill chunks).  Parsed traces carry measured
              share depth instead of group identity — those hits are
              replayed as recorded.

Service times come from the MFU ledger / trace spans of a real run
(``ServeProfile.from_records``): decode-step and prefill-chunk wall
times are MEDIANS of the recorded spans (medians because the stream
includes compile outliers), flops ride along for documentation.
Tensor parallelism is modeled as an Amdahl split of the measured step:
``t(tp) = t(tp_base) · (tp_comm_frac + (1 − tp_comm_frac) ·
tp_base/tp)`` — compute shards, a documented fraction (psums + host
dispatch) does not.  A TP replica's page pool scales WITH tp by
default (the KV pool is head-sharded, so k chips hold k× the pages at
equal per-chip HBM) — that coupling is exactly why TP-vs-replicas at
fixed chips is a real trade and not arithmetic.

Deadlines are post-hoc verdicts: a request whose simulated completion
exceeds its deadline counts as a deadline failure (its tokens don't
count toward throughput).  The real router frees capacity at the
deadline instead of at completion, so the simulator is conservative.
Service times are jittered from the MEASURED per-step spread when the
profile carries one (``ServeProfile.jitter`` — the recorded
``serve_decode`` span durations normalized by their median,
resampled by a seeded in-module PRNG so predictions stay
deterministic); with jitter on, ``hedge_s`` is a real policy: a
request stuck in a straggling replica's queue past the hedge bar is
re-dispatched to a strictly less-loaded sibling, the simulator's
model of the router's duplicate-dispatch race.  Without jitter
nothing straggles and the knob stays a recorded no-op.

Disaggregation is a what-if (:func:`pool_split`): at a fixed chip
budget, compare the colocated tier against every prefill:decode
replica split.  The decode pool's "prefill" is KV-page MIGRATION —
each chunk-equivalent of prompt pages crosses the fabric at a
documented wire bandwidth plus a per-window latency
(``serve/migrate.py``'s windowed ``page_fetch`` protocol,
miniaturized) — so the trade the model captures is real: a split
buys the decode pool freedom from prefill head-of-line blocking and
pays for it in wire time and a thinner decode fleet.

Calibration contract (the PR-5 ``--calibrate`` shape): predicted
tokens/s and p99 latency must land within a documented ratio bar
(default 2×) of a measured traced run — ``plan_serve_main
--calibrate`` records the run, replays it, exports
``plan_serve_tokens_ratio`` / ``plan_serve_p99_ratio`` gauges to the
obs registry, and exits nonzero outside the bar.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from dtf_tpu_torch.obs.registry import percentile
from dtf_tpu_torch.plan.serve_trace import Workload

#: default feasibility bar for the what-if answers: a config "serves"
#: a workload when sheds + deadline failures stay under this fraction
DEFAULT_LOSS_BAR = 0.01

#: jitter extraction: need at least this many decode spans for the
#: spread to mean anything, keep about this many (evenly strided
#: over the SORTED durations, so the tails survive the cap)
_JITTER_MIN_SPANS = 8
_JITTER_SAMPLES = 256


@dataclasses.dataclass(frozen=True)
class ServeProfile:
    """Calibrated per-engine service times (one replica at ``tp_base``).

    ``decode_step_s`` is one full-batch decode step (weight-bound: the
    step reads all params regardless of how many slots decode, which
    is why the simulator charges it per ITERATION, not per token);
    ``prefill_chunk_s`` is one ``chunk_tokens``-token prefill chunk.
    ``overhead_s`` is per engine iteration (host-side scheduling not
    inside either span).  ``jitter`` is the measured per-step spread:
    each recorded decode span's duration divided by the stream's
    median, sorted — the simulator resamples it per iteration so
    stragglers happen at their MEASURED frequency, not a modeled
    one.  Empty = deterministic service times (the pre-calibration
    default)."""

    decode_step_s: float
    prefill_chunk_s: float
    chunk_tokens: int = 64
    page_size: int = 16
    overhead_s: float = 0.0
    decode_flops: float = 0.0
    tp_base: int = 1
    tp_comm_frac: float = 0.15
    jitter: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.decode_step_s <= 0 or self.prefill_chunk_s <= 0:
            raise ValueError("decode_step_s and prefill_chunk_s must be "
                             "positive (a zero service time simulates "
                             "an infinitely fast fleet)")
        if self.chunk_tokens < 1 or self.page_size < 1:
            raise ValueError("chunk_tokens and page_size must be >= 1")
        if not 0.0 <= self.tp_comm_frac < 1.0:
            raise ValueError(f"tp_comm_frac must be in [0, 1), got "
                             f"{self.tp_comm_frac}")
        # lists parse out of JSON artifacts; store the canonical tuple
        object.__setattr__(self, "jitter", tuple(self.jitter))
        if any(j <= 0 for j in self.jitter):
            raise ValueError("jitter factors must be positive "
                             "(dur / median of measured spans)")

    def decode_step_for(self, tp: int) -> float:
        """Amdahl model of TP scaling around the measured base: the
        compute fraction shards over ``tp``, ``tp_comm_frac`` (psums,
        host dispatch) does not."""
        if tp == self.tp_base:
            return self.decode_step_s
        return self.decode_step_s * (
            self.tp_comm_frac
            + (1.0 - self.tp_comm_frac) * self.tp_base / tp)

    def prefill_chunk_for(self, tp: int) -> float:
        return self.prefill_chunk_s * (
            self.tp_comm_frac
            + (1.0 - self.tp_comm_frac) * self.tp_base / tp) \
            if tp != self.tp_base else self.prefill_chunk_s

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_records(cls, merged: List[dict], **overrides
                     ) -> "ServeProfile":
        """Profile from a traced serving run's own records: MEDIAN
        ``serve_decode`` / ``serve_prefill_chunk`` span wall times
        (median, not mean — the stream includes the compile-step
        outliers the ledger drops), modal chunk size from the chunk
        spans, per-step flops from the ledger, and the decode spans'
        normalized spread as the ``jitter`` distribution (capped at
        ``_JITTER_SAMPLES`` evenly-strided samples so a long trace
        doesn't bloat the profile).  ``overrides`` win over extracted
        values (and supply anything the trace lacks)."""
        decode_durs: List[float] = []
        chunk_durs: List[float] = []
        chunk_sizes: List[int] = []
        flops = 0.0
        for rec in merged:
            if rec.get("kind") == "span":
                if rec.get("name") == "serve_decode":
                    decode_durs.append(float(rec.get("dur_s", 0.0)))
                elif rec.get("name") == "serve_prefill_chunk":
                    chunk_durs.append(float(rec.get("dur_s", 0.0)))
                    if rec.get("tokens"):
                        chunk_sizes.append(int(rec["tokens"]))
            elif (rec.get("name") == "ledger_exec"
                  and rec.get("exec") == "serve_decode_step"):
                flops = float(rec.get("flops", 0.0) or 0.0)
        values: Dict[str, object] = {}
        if decode_durs:
            med = percentile(sorted(decode_durs), 50.0)
            values["decode_step_s"] = med
            if med > 0 and len(decode_durs) >= _JITTER_MIN_SPANS:
                facs = sorted(round(d / med, 6) for d in decode_durs
                              if d > 0)
                stride = max(1, len(facs) // _JITTER_SAMPLES)
                values["jitter"] = tuple(facs[::stride])
        if chunk_durs:
            values["prefill_chunk_s"] = percentile(sorted(chunk_durs),
                                                   50.0)
        if chunk_sizes:
            values["chunk_tokens"] = max(set(chunk_sizes),
                                         key=chunk_sizes.count)
        if flops:
            values["decode_flops"] = flops
        values.update(overrides)
        missing = {"decode_step_s", "prefill_chunk_s"} - set(values)
        if missing:
            raise ValueError(
                f"trace carries no {sorted(missing)} measurement "
                f"(serve_decode / serve_prefill_chunk spans) — pass "
                f"explicit values, or record a traced serving run")
        return cls(**values)  # type: ignore[arg-type]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """One point in the fleet-strategy lattice.

    ``pool_pages`` is USABLE pages per replica at tp=1 (the engine's
    pool minus its scratch page); with ``pool_scales_with_tp`` (the
    head-sharded KV layout) a tp=k replica holds k× that."""

    replicas: int = 1
    tp: int = 1
    slots: int = 8
    pool_pages: int = 128
    queue_size: int = 64
    admission_limit: int = 128
    deadline_s: float = 120.0
    replica_inflight: int = 16
    placement: str = "affinity"      # affinity | least_loaded
    hedge_s: float = 0.0             # queue-escape bar: with measured
                                     # jitter in the profile, a request
                                     # pending longer than this moves to
                                     # a strictly less-loaded replica
                                     # (the duplicate-dispatch race,
                                     # resolved in the winner's favor);
                                     # without jitter nothing straggles
                                     # and the knob is a recorded no-op
    pool_scales_with_tp: bool = True

    def __post_init__(self):
        for f in ("replicas", "tp", "slots", "pool_pages", "queue_size",
                  "admission_limit", "replica_inflight"):
            if getattr(self, f) < 1:
                raise ValueError(f"fleet.{f} must be >= 1, got "
                                 f"{getattr(self, f)}")
        if self.placement not in ("affinity", "least_loaded"):
            raise ValueError(f"unknown placement {self.placement!r}; "
                             f"the simulator models 'affinity' and "
                             f"'least_loaded'")
        if self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive")

    @property
    def chips(self) -> int:
        return self.replicas * self.tp

    @property
    def usable_pages(self) -> int:
        return self.pool_pages * (self.tp if self.pool_scales_with_tp
                                  else 1)

    def describe(self) -> str:
        parts = [f"replicas={self.replicas}"]
        if self.tp > 1:
            parts.append(f"tp={self.tp}")
        parts.append(f"slots={self.slots}")
        parts.append(f"pool={self.usable_pages}p")
        return ",".join(parts)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FleetPrediction:
    """What the simulator says a fleet does to a workload."""

    tokens_per_s: float
    latency_p50_s: float
    latency_p99_s: float
    queue_wait_p50_s: float
    queue_wait_p99_s: float
    completed: int
    shed: int
    deadlined: int
    shed_rate: float
    deadline_rate: float
    replica_utilization: float
    span_s: float
    hedged: int = 0                  # requests re-dispatched by the
                                     # hedge queue-escape (jitter runs)

    @property
    def loss_rate(self) -> float:
        return self.shed_rate + self.deadline_rate

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["loss_rate"] = self.loss_rate
        return d


class _Slot:
    __slots__ = ("req", "chunks_left", "tokens_left", "fresh_pages",
                 "reg_transfer", "group", "hit_pages")

    def __init__(self, req, chunks_left, tokens_left, fresh_pages,
                 group, hit_pages):
        self.req = req
        self.chunks_left = chunks_left
        self.tokens_left = tokens_left
        self.fresh_pages = fresh_pages
        self.reg_transfer = 0
        self.group = group
        self.hit_pages = hit_pages


class _SimReq:
    __slots__ = ("rec", "arrival", "budget", "admit_t", "finish_t",
                 "outcome", "placed_t")

    def __init__(self, rec):
        self.rec = rec
        self.arrival = rec.arrival_s
        # a parsed shed carries no token count (it never decoded) —
        # floor at 1 so the replayed fleet still pays its admission
        self.budget = max(int(rec.decode_tokens), 1)
        self.admit_t = None
        self.finish_t = None
        self.outcome = None
        self.placed_t = None        # last placed on a replica (hedge)


class _SimReplica:
    __slots__ = ("rid", "slots", "pending", "free_pages", "reg",
                 "inflight", "busy_s", "scheduled", "rr")

    def __init__(self, rid: int, pool_pages: int, slots: int):
        self.rid = rid
        self.slots: List[Optional[_Slot]] = [None] * slots
        self.pending: deque = deque()
        self.free_pages = pool_pages
        # prefix registry model: group -> {"pages": registered page
        # count (allocated, owned by the registry), "live": slots
        # currently sharing them}
        self.reg: Dict[str, dict] = {}
        self.inflight = 0
        self.busy_s = 0.0
        self.scheduled = False
        self.rr = -1


def simulate(workload: Workload, profile: ServeProfile,
             config: FleetConfig) -> FleetPrediction:
    """Replay ``workload`` through the fleet model.  Deterministic:
    same inputs, same prediction — jitter resampling runs off a fixed-
    seed in-module PRNG, not wall-clock entropy."""
    ps = profile.page_size
    step_s = profile.decode_step_for(config.tp)
    chunk_s = profile.prefill_chunk_for(config.tp)
    chunk_tokens = profile.chunk_tokens
    pool = config.usable_pages
    jit = profile.jitter
    jit_state = 0x9E3779B97F4A7C15
    hedged_n = 0

    def jitter_factor() -> float:
        # 64-bit LCG (Knuth MMIX constants) indexing the EMPIRICAL
        # distribution — same spread the trace measured, no parametric
        # assumption, and no numpy dependency to keep determinism
        # hostage to a library version
        nonlocal jit_state
        jit_state = (jit_state * 6364136223846793005
                     + 1442695040888963407) & 0xFFFFFFFFFFFFFFFF
        return jit[(jit_state >> 33) % len(jit)]

    reqs = [_SimReq(r) for r in workload.requests]
    if not reqs:
        return FleetPrediction(0.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0, 0.0,
                               0.0, 0.0, 0.0)
    reps = [_SimReplica(i, pool, config.slots)
            for i in range(config.replicas)]
    router_q: deque = deque()
    owner: Dict[str, int] = {}
    outstanding = 0
    seq = itertools.count()
    # event heap: (time, tiebreak, kind, payload) — "arr" before
    # "iter" at equal time via the monotonic tiebreak (arrivals were
    # pushed first)
    events: List[Tuple[float, int, str, object]] = []
    for sr in reqs:
        heapq.heappush(events, (sr.arrival, next(seq), "arr", sr))

    def total_pages(sr: _SimReq) -> int:
        return -(-(sr.rec.prompt_tokens + sr.budget) // ps)

    def shed(sr: _SimReq) -> None:
        sr.outcome = "shed"

    def rehedge(now: float) -> None:
        """The hedge policy, as the simulator can honor it: a request
        pending on one replica past ``hedge_s`` while a strictly
        less-loaded sibling has queue room is re-dispatched there —
        the router's duplicate-dispatch race, resolved in the winner's
        favor (optimistic: the loser's wasted work is not charged).
        Only meaningful under measured jitter; deterministic service
        never leaves a request stuck behind a straggler."""
        nonlocal hedged_n
        if config.hedge_s <= 0 or not jit:
            return
        for rep in reps:
            for sr in [s for s in rep.pending
                       if now - s.placed_t > config.hedge_s]:
                # the move must strictly improve balance (target ends
                # no more loaded than the source does) — that
                # monotonicity is what rules out hedge ping-pong
                tgt = [r2 for r2 in reps if r2 is not rep
                       and len(r2.pending) < config.queue_size
                       and r2.inflight + 2 <= rep.inflight]
                if not tgt:
                    break
                r2 = min(tgt, key=lambda r: (r.inflight, r.rid))
                rep.pending.remove(sr)
                rep.inflight -= 1
                r2.pending.append(sr)
                r2.inflight += 1
                sr.placed_t = now
                hedged_n += 1
                if sr.rec.prefix_group is not None:
                    owner[sr.rec.prefix_group] = r2.rid
                if not r2.scheduled:
                    r2.scheduled = True
                    heapq.heappush(events, (now, next(seq), "iter", r2))

    def dispatch(now: float) -> None:
        """The router's dispatch scan: place every queued request an
        eligible replica can take; shed what EVERY replica's queue has
        no room for (the Backpressure-relay contract — waiting there
        is a retry storm, not a queue)."""
        nonlocal outstanding
        rehedge(now)
        placed = []
        for sr in router_q:
            eligible = [rep for rep in reps
                        if rep.inflight < config.replica_inflight
                        and len(rep.pending) < config.queue_size]
            if not eligible:
                all_full = all(len(rep.pending) >= config.queue_size
                               for rep in reps)
                if all_full:
                    placed.append(sr)
                    shed(sr)
                    outstanding -= 1
                continue
            rep = None
            group = sr.rec.prefix_group
            if config.placement == "affinity" and group is not None:
                own = owner.get(group)
                if own is not None and reps[own] in eligible:
                    rep = reps[own]
            if rep is None:
                rep = min(eligible,
                          key=lambda r: (r.inflight, r.rid))
            if group is not None:
                owner[group] = rep.rid
            rep.pending.append(sr)
            rep.inflight += 1
            sr.placed_t = now
            placed.append(sr)
            if not rep.scheduled:
                rep.scheduled = True
                heapq.heappush(events, (now, next(seq), "iter", rep))
        for sr in placed:
            router_q.remove(sr)

    def admit(rep: _SimReplica, now: float) -> None:
        """The engine's admission: FIFO head-of-line, page math,
        prefix hits, registry eviction."""
        nonlocal outstanding
        while rep.pending:
            free_idx = next((i for i, s in enumerate(rep.slots)
                             if s is None), None)
            if free_idx is None:
                return
            sr = rep.pending[0]
            need_total = total_pages(sr)
            if need_total > pool:
                # the engine's submit guard: could never be admitted
                rep.pending.popleft()
                rep.inflight -= 1
                outstanding -= 1
                shed(sr)
                continue
            group = sr.rec.prefix_group
            prompt_pages = sr.rec.prompt_tokens // ps
            hit = 0
            if group is not None and group in rep.reg:
                hit = min(rep.reg[group]["pages"], prompt_pages)
            elif group is None and sr.rec.prefix_tokens:
                # parsed trace: replay the measured share depth
                hit = min(sr.rec.prefix_tokens // ps, prompt_pages)
            fresh = need_total - hit
            if fresh > rep.free_pages:
                # evict registry-only pages until the admit fits —
                # cached prefixes yield to live traffic, but the
                # `hit` pages this admit is sharing are HELD (the
                # engine holds shares before evicting): the admitted
                # group's chain may only be truncated BEYOND the held
                # depth.  Router-side ownership intentionally survives
                # an eviction — like the real tier, a stale owner
                # costs a registry miss + re-prefill, not a reroute.
                if group is not None:
                    e = rep.reg.get(group)
                    if e is not None and e["live"] == 0 \
                            and e["pages"] > hit:
                        rep.free_pages += e["pages"] - hit
                        e["pages"] = hit
                        if hit == 0:
                            del rep.reg[group]
                for g in [g for g, e in rep.reg.items()
                          if e["live"] == 0 and g != group]:
                    if rep.free_pages >= fresh:
                        break
                    rep.free_pages += rep.reg[g]["pages"]
                    del rep.reg[g]
                if fresh > rep.free_pages:
                    return      # head-of-line wait for a retire
            rep.pending.popleft()
            rep.free_pages -= fresh
            if hit > 0 and group is not None and group in rep.reg:
                rep.reg[group]["live"] += 1
            remaining = sr.rec.prompt_tokens - hit * ps
            chunks = -(-remaining // chunk_tokens) if remaining > 0 \
                else 0
            # the engine's last prefill chunk emits the FIRST token, so
            # a chunked request pays budget − 1 decode steps; the
            # full-prefix (COW) path has no prefill and decodes all of
            # them (its first token comes out of a decode step)
            steps = sr.budget - (1 if chunks > 0 else 0)
            rep.slots[free_idx] = _Slot(sr, chunks, steps, fresh,
                                        group, hit)
            sr.admit_t = now

    def retire(rep: _SimReplica, idx: int, now: float) -> None:
        nonlocal outstanding
        slot = rep.slots[idx]
        rep.slots[idx] = None
        rep.free_pages += slot.fresh_pages - slot.reg_transfer
        if slot.group is not None and slot.group in rep.reg \
                and slot.hit_pages:
            rep.reg[slot.group]["live"] -= 1
        rep.inflight -= 1
        outstanding -= 1
        sr = slot.req
        sr.finish_t = now
        sr.outcome = ("deadline"
                      if now - sr.arrival > config.deadline_s
                      else "complete")

    def iteration(rep: _SimReplica, now: float) -> None:
        rep.scheduled = False
        admit(rep, now)
        live = [(i, s) for i, s in enumerate(rep.slots) if s is not None]
        prefilling = [(i, s) for i, s in live if s.chunks_left > 0]
        decoding = [(i, s) for i, s in live
                    if s.chunks_left == 0 and s.tokens_left > 0]
        if not prefilling and not decoding:
            return              # idle until the next dispatch wakes it
        dt = profile.overhead_s
        if prefilling:
            dt += chunk_s * (jitter_factor() if jit else 1.0)
        if decoding:
            dt += step_s * (jitter_factor() if jit else 1.0)
        rep.busy_s += dt
        t2 = now + dt
        if prefilling:
            # ONE chunk per iteration, round-robin — the engine's
            # head-of-line-bounding schedule
            i, s = next(((i, s) for i, s in prefilling if i > rep.rr),
                        prefilling[0])
            rep.rr = i
            s.chunks_left -= 1
            if s.chunks_left == 0:
                if s.group is not None and s.group not in rep.reg:
                    # prefill complete: register the group's full
                    # prompt pages; the registry takes co-ownership
                    # (they stay allocated past this slot's retire,
                    # until evicted)
                    reg_pages = min(s.req.rec.prompt_tokens // ps,
                                    s.fresh_pages)
                    if reg_pages > 0:
                        rep.reg[s.group] = {"pages": reg_pages,
                                            "live": 1}
                        s.reg_transfer = reg_pages
                        s.hit_pages = reg_pages  # dropped at retire
                if s.tokens_left == 0:
                    # a 1-token budget finishes AT the prefill (the
                    # chunk's sampled token is the whole answer)
                    retire(rep, i, t2)
        for i, s in decoding:
            s.tokens_left -= 1
            if s.tokens_left == 0:
                retire(rep, i, t2)
        # dispatch may itself schedule THIS replica's next iteration
        # (fresh work placed on it) — check scheduled after, or a
        # double-pushed event would run two iterations at one
        # timestamp, i.e. free compute
        dispatch(t2)
        if not rep.scheduled and (rep.pending or any(
                s is not None for s in rep.slots)):
            rep.scheduled = True
            heapq.heappush(events, (t2, next(seq), "iter", rep))

    while events:
        now, _, kind, payload = heapq.heappop(events)
        if kind == "arr":
            sr = payload
            if outstanding >= config.admission_limit:
                shed(sr)
                continue
            outstanding += 1
            router_q.append(sr)
            dispatch(now)
        else:
            iteration(payload, now)

    # aggregate
    completes = [sr for sr in reqs if sr.outcome == "complete"]
    shed_n = sum(1 for sr in reqs if sr.outcome == "shed")
    dead_n = sum(1 for sr in reqs if sr.outcome == "deadline")
    total = len(reqs)
    if completes:
        span = (max(sr.finish_t for sr in completes)
                - min(sr.arrival for sr in completes))
        tokens = sum(sr.budget for sr in completes)
        lat = sorted(sr.finish_t - sr.arrival for sr in completes)
        wait = sorted(sr.admit_t - sr.arrival for sr in completes)
        full_span = (max(sr.finish_t or sr.arrival for sr in reqs)
                     - min(sr.arrival for sr in reqs))
        return FleetPrediction(
            tokens_per_s=tokens / span if span > 0 else 0.0,
            latency_p50_s=percentile(lat, 50.0),
            latency_p99_s=percentile(lat, 99.0),
            queue_wait_p50_s=percentile(wait, 50.0),
            queue_wait_p99_s=percentile(wait, 99.0),
            completed=len(completes), shed=shed_n, deadlined=dead_n,
            shed_rate=shed_n / total, deadline_rate=dead_n / total,
            replica_utilization=(sum(r.busy_s for r in reps)
                                 / (len(reps) * full_span))
            if full_span > 0 else 0.0,
            span_s=span, hedged=hedged_n)
    return FleetPrediction(0.0, 0.0, 0.0, 0.0, 0.0, 0, shed_n, dead_n,
                           shed_n / total if total else 0.0,
                           dead_n / total if total else 0.0, 0.0, 0.0,
                           hedged=hedged_n)


# ---------------------------------------------------------------------------
# what-if answers
# ---------------------------------------------------------------------------

def replicas_for(workload: Workload, profile: ServeProfile,
                 config: FleetConfig, target_rps: float,
                 slo_p99_s: float, *, max_replicas: int = 64,
                 loss_bar: float = DEFAULT_LOSS_BAR
                 ) -> Tuple[Optional[int], List[Tuple[int,
                                                      FleetPrediction]]]:
    """Smallest replica count serving the workload's SHAPE at
    ``target_rps`` with p99 latency within the SLO and loss (sheds +
    deadline failures) under ``loss_bar``.  Returns (count-or-None,
    every (replicas, prediction) evaluated)."""
    from dtf_tpu_torch.plan.serve_trace import scale_workload
    w = scale_workload(workload, target_rps)
    evaluated: List[Tuple[int, FleetPrediction]] = []
    for n in range(1, max_replicas + 1):
        pred = simulate(w, profile,
                        dataclasses.replace(config, replicas=n))
        evaluated.append((n, pred))
        if (pred.completed and pred.latency_p99_s <= slo_p99_s
                and pred.loss_rate <= loss_bar):
            return n, evaluated
    return None, evaluated


def rank_tp_vs_replicas(workload: Workload, profile: ServeProfile,
                        config: FleetConfig, chips: int, *,
                        loss_bar: float = DEFAULT_LOSS_BAR
                        ) -> List[Tuple[FleetConfig, FleetPrediction]]:
    """At a fixed chip budget, rank every tp × replicas split
    (tp ∈ powers of two dividing ``chips``): configs under the loss
    bar first, by p99 latency, then by delivered tokens/s.  The trade
    the model captures: TP cuts per-step latency (Amdahl) and grows
    the per-replica page pool, MORE REPLICAS add independent queues
    and admission capacity."""
    if chips < 1:
        raise ValueError(f"chips must be >= 1, got {chips}")
    out: List[Tuple[FleetConfig, FleetPrediction]] = []
    tp = 1
    while tp <= chips:
        if chips % tp == 0:
            cfg = dataclasses.replace(config, tp=tp,
                                      replicas=chips // tp)
            out.append((cfg, simulate(workload, profile, cfg)))
        tp *= 2
    out.sort(key=lambda cp: (cp[1].loss_rate > loss_bar,
                             cp[1].latency_p99_s,
                             -cp[1].tokens_per_s))
    return out


@dataclasses.dataclass(frozen=True)
class CostRankedConfig:
    """One row of :func:`rank_cost_per_token`."""

    config: FleetConfig
    prediction: FleetPrediction
    meets_slo: bool
    usd_per_mtoken: float
    usd_per_hour: float

    def to_dict(self) -> dict:
        finite = self.usd_per_mtoken != float("inf")
        return {"config": self.config.to_dict(),
                "prediction": self.prediction.to_dict(),
                "meets_slo": self.meets_slo,
                # None, not Infinity: the artifact stays strict JSON
                "usd_per_mtoken": (self.usd_per_mtoken if finite
                                   else None),
                "usd_per_hour": self.usd_per_hour}


def rank_cost_per_token(workload: Workload, profile: ServeProfile,
                        config: FleetConfig, chips: int,
                        chip_cost_per_hour: float, slo_p99_s: float, *,
                        loss_bar: float = DEFAULT_LOSS_BAR,
                        evaluated: Optional[
                            List[Tuple[FleetConfig,
                                       FleetPrediction]]] = None
                        ) -> List[CostRankedConfig]:
    """Rank every tp × replicas split of a chip budget by **$/token at
    the SLO** — the capacity-sim follow-on the MFU ledger enables: the
    ledger knows chips and achieved throughput, so feasibility alone
    is no longer the interesting verdict; the cheapest config that
    still meets the p99 SLO and the loss bar is.

    A fleet's dollar rate is ``chips × chip_cost_per_hour`` (every
    ranked split uses the full budget, but the rate is computed per
    config so partial splits of non-power-of-two budgets price
    honestly); delivered tokens/s comes from the simulator, so
    $/Mtoken = rate / (3600 · tokens_per_s) · 1e6.  Configs that MISS
    the SLO or the loss bar rank strictly below every config that
    meets them — a cheap config that sheds is not a bargain — ordered
    among themselves by $/Mtoken for the "what would it take" view.

    ``evaluated`` reuses :func:`rank_tp_vs_replicas`' (config,
    prediction) pairs when the caller already simulated the splits
    (the CLI runs both what-ifs on one pass); None simulates here."""
    if chips < 1:
        raise ValueError(f"chips must be >= 1, got {chips}")
    if chip_cost_per_hour <= 0:
        raise ValueError(f"chip_cost_per_hour must be positive, got "
                         f"{chip_cost_per_hour}")
    if slo_p99_s <= 0:
        raise ValueError(f"slo_p99_s must be positive, got {slo_p99_s}")
    if evaluated is None:
        evaluated = rank_tp_vs_replicas(workload, profile, config,
                                        chips, loss_bar=loss_bar)
    rows: List[CostRankedConfig] = []
    for cfg, pred in evaluated:
        meets = bool(pred.completed
                     and pred.latency_p99_s <= slo_p99_s
                     and pred.loss_rate <= loss_bar)
        rate = cfg.chips * chip_cost_per_hour
        usd_mtok = (rate / 3600.0 / pred.tokens_per_s * 1e6
                    if pred.tokens_per_s > 0 else float("inf"))
        rows.append(CostRankedConfig(cfg, pred, meets, usd_mtok, rate))
    rows.sort(key=lambda r: (not r.meets_slo, r.usd_per_mtoken,
                             r.prediction.latency_p99_s))
    return rows


def pool_vs_shed(workload: Workload, profile: ServeProfile,
                 config: FleetConfig, pool_sizes: Sequence[int], *,
                 loss_bar: float = DEFAULT_LOSS_BAR
                 ) -> Tuple[Optional[int],
                            List[Tuple[int, FleetPrediction]]]:
    """Page-pool sizing: predictions for each candidate USABLE
    per-replica pool size (at tp=1), plus the smallest one whose loss
    rate stays under the bar.  Smaller pools convert directly into
    sheds/waits through the admission math — this is the provisioning
    curve."""
    rows = [(int(p), simulate(workload, profile,
                              dataclasses.replace(config,
                                                  pool_pages=int(p))))
            for p in sorted(pool_sizes)]
    best = next((p for p, pred in rows
                 if pred.completed and pred.loss_rate <= loss_bar), None)
    return best, rows


@dataclasses.dataclass(frozen=True)
class PoolSplitRow:
    """One row of :func:`pool_split`.  ``prefill_replicas == 0`` is the
    colocated baseline: ``decode`` then holds the whole tier's
    prediction and ``prefill`` is None (no second pool exists)."""

    prefill_replicas: int
    decode_replicas: int
    migrate_chunk_s: float
    decode: FleetPrediction
    prefill: Optional[FleetPrediction] = None

    @property
    def is_colocated(self) -> bool:
        return self.prefill_replicas == 0

    @property
    def loss_rate(self) -> float:
        """A request is lost if EITHER pool loses it."""
        if self.prefill is None:
            return self.decode.loss_rate
        return max(self.decode.loss_rate, self.prefill.loss_rate)

    def describe(self) -> str:
        if self.is_colocated:
            return f"colocated ({self.decode_replicas} replicas)"
        return (f"{self.prefill_replicas}p:"
                f"{self.decode_replicas}d split")

    def to_dict(self) -> dict:
        return {"prefill_replicas": self.prefill_replicas,
                "decode_replicas": self.decode_replicas,
                "migrate_chunk_s": self.migrate_chunk_s,
                "loss_rate": self.loss_rate,
                "decode": self.decode.to_dict(),
                "prefill": (self.prefill.to_dict()
                            if self.prefill is not None else None)}


def pool_split(workload: Workload, profile: ServeProfile,
               config: FleetConfig, chips: int, *,
               page_bytes: int = 1 << 20, wire_gbps: float = 10.0,
               wire_latency_s: float = 0.002,
               loss_bar: float = DEFAULT_LOSS_BAR
               ) -> Tuple[Optional[PoolSplitRow], List[PoolSplitRow]]:
    """Disaggregation what-if: at a fixed chip budget, colocated vs
    every prefill:decode replica split (tp held at ``config.tp``).

    The split is modeled as two independent fleets fed the same
    arrival process:

      prefill pool — the workload with every decode budget cut to the
          single token prefill emits (the chain then LEAVES: finished
          prefills migrate out, so the pool's only decode work is
          first tokens).
      decode pool  — the full workload, with prefill chunks replaced
          by MIGRATION chunks: the same prompt pages arrive over the
          fabric at ``wire_gbps`` (decimal Gbit/s) plus a
          ``wire_latency_s`` window round-trip per chunk — the cost
          shape of ``serve/migrate.py``'s windowed ``page_fetch``
          protocol.  Prefix affinity still applies (a shared prefix
          migrates once, later requests hit the registry).

    End-to-end latency does not compose across the two simulations
    (each pool queues independently), so the ranking criterion is the
    DECODE pool's p99 — time-between-tokens is what disaggregation
    buys; the prefill pool only has to stay feasible under the loss
    bar.  ``best`` is the feasible split with the lowest decode p99
    that strictly beats colocated p99 at equal chips, or None when
    colocated wins (the honest verdict: migration is not free).

    Returns ``(best, rows)`` — ``rows[0]`` is the colocated
    baseline."""
    if chips < 2:
        raise ValueError(f"pool_split needs chips >= 2 (one replica "
                         f"cannot split), got {chips}")
    if chips % config.tp != 0:
        raise ValueError(f"chips ({chips}) must be a multiple of "
                         f"config.tp ({config.tp}) — the split is in "
                         f"whole replicas")
    if page_bytes < 1 or wire_gbps <= 0 or wire_latency_s < 0:
        raise ValueError("page_bytes must be >= 1, wire_gbps positive, "
                         "wire_latency_s non-negative")
    n = chips // config.tp
    if n < 2:
        raise ValueError(f"chips/tp leaves {n} replica(s) — nothing "
                         f"to split")
    # one chunk-equivalent of prompt pages over the fabric: payload
    # time at wire bandwidth plus one window round-trip
    wire_bytes_per_s = wire_gbps * 1e9 / 8.0
    mig_chunk_s = (wire_latency_s
                   + (profile.chunk_tokens / profile.page_size)
                   * page_bytes / wire_bytes_per_s)
    colocated = simulate(workload, profile,
                         dataclasses.replace(config, replicas=n))
    rows = [PoolSplitRow(0, n, 0.0, colocated)]
    prefill_w = Workload(
        [dataclasses.replace(r, decode_tokens=1)
         for r in workload.requests],
        workload.duration_s, workload.source + ":prefill_pool",
        workload.skipped_no_trace)
    decode_profile = dataclasses.replace(profile,
                                         prefill_chunk_s=mig_chunk_s)
    for p in range(1, n):
        d = n - p
        pre = simulate(prefill_w, profile,
                       dataclasses.replace(config, replicas=p))
        dec = simulate(workload, decode_profile,
                       dataclasses.replace(config, replicas=d))
        rows.append(PoolSplitRow(p, d, mig_chunk_s, dec, pre))
    feasible = [r for r in rows[1:]
                if r.decode.completed and r.loss_rate <= loss_bar
                and r.decode.latency_p99_s < colocated.latency_p99_s]
    best = min(feasible,
               key=lambda r: (r.decode.latency_p99_s,
                              -r.decode.tokens_per_s),
               default=None)
    return best, rows


def measured_tp_comm_frac(t_base: float, t_scaled: float, *,
                          tp_base: int = 1, tp_scaled: int = 2
                          ) -> float:
    """Solve the Amdahl split for ``tp_comm_frac`` from two MEASURED
    decode-step times instead of trusting the documented default:
    ``t(tp) = t(base) · (f + (1 − f) · base/tp)`` gives
    ``f = (t_scaled/t_base − base/scaled) / (1 − base/scaled)``.

    Clamped into the profile's valid domain: a super-linear speedup
    measures as 0.0 (all compute), a SLOWDOWN under TP clamps at 0.95
    rather than rejecting — the planner should still rank with the
    pessimistic number, not die on a noisy box."""
    if t_base <= 0 or t_scaled <= 0:
        raise ValueError("measured step times must be positive")
    if tp_scaled <= tp_base:
        raise ValueError(f"tp_scaled ({tp_scaled}) must exceed "
                         f"tp_base ({tp_base})")
    share = tp_base / tp_scaled
    frac = (t_scaled / t_base - share) / (1.0 - share)
    return min(max(frac, 0.0), 0.95)


# ---------------------------------------------------------------------------
# calibration (predicted vs measured, PR-5 shape)
# ---------------------------------------------------------------------------

def calibration_ratios(measured: dict, pred: FleetPrediction,
                       registry=None) -> dict:
    """Predicted/measured ratios for the two headline numbers, exported
    as gauges the way plan_main's ``plan_step_time_ratio`` is:

      plan_serve_predicted_tokens_per_s / plan_serve_measured_tokens_per_s
      plan_serve_tokens_ratio
      plan_serve_predicted_p99_s / plan_serve_measured_p99_s
      plan_serve_p99_ratio

    ``measured`` is :func:`~dtf_tpu_torch.plan.serve_trace.measured_stats`
    output.  Raises ValueError when the measured run has nothing to
    calibrate against (no completed requests)."""
    from dtf_tpu_torch.obs.registry import default_registry
    if not measured.get("completed") or not measured.get("tokens_per_s"):
        raise ValueError("measured workload has no completed requests — "
                         "nothing to calibrate against")
    if not pred.completed:
        raise ValueError("prediction completed no requests — the model "
                         "shed everything the real run served")
    reg = registry if registry is not None else default_registry()
    tokens_ratio = pred.tokens_per_s / measured["tokens_per_s"]
    p99_ratio = (pred.latency_p99_s / measured["latency_p99_s"]
                 if measured["latency_p99_s"] > 0 else float("inf"))
    reg.gauge("plan_serve_predicted_tokens_per_s",
              unit="tokens/s").set(pred.tokens_per_s)
    reg.gauge("plan_serve_measured_tokens_per_s",
              unit="tokens/s").set(measured["tokens_per_s"])
    reg.gauge("plan_serve_tokens_ratio").set(tokens_ratio)
    reg.gauge("plan_serve_predicted_p99_s",
              unit="s").set(pred.latency_p99_s)
    reg.gauge("plan_serve_measured_p99_s",
              unit="s").set(measured["latency_p99_s"])
    reg.gauge("plan_serve_p99_ratio").set(p99_ratio)
    return {"tokens_ratio": tokens_ratio, "p99_ratio": p99_ratio}


def ratios_within(ratios: dict, tolerance: float) -> bool:
    """The calibration bar: every ratio inside [1/tol, tol]."""
    return all(1.0 / tolerance <= r <= tolerance
               for r in ratios.values())
