"""Dynamic batching engine: request queue -> slot-based continuous
batching over the KV-cache decoder.  The PyTorch counterpart of
``dtf_tpu/serve/engine.py``; the host-side logic is the same:

  admission control -- ``submit`` rejects a request whose prompt +
      budget cannot fit (ValueError), instead of truncating it.
  backpressure      -- the queue is bounded; a full queue sheds with
      :class:`Backpressure` carrying ``retry_after``, and logs it.
  max-batch / max-delay -- a fresh batch waits up to ``max_delay_s``
      after the first arrival to fill; once decoding, new arrivals join
      at any step boundary.
  continuous batching -- every decode step runs all ``max_batch`` rows;
      each slot carries its own length, so sequences finish
      independently and free their slot without draining the batch.

With the PAGED KV cache (``kv_page_size``, the default):

  paged admission   -- KV memory is a shared page pool
      (:class:`PagePool`); a request is admitted when its worst-case
      page count, ceil((prompt + budget) / page_size), is free.  When
      the head of the queue cannot get pages it WAITS (FIFO: small
      requests do not slip past a starved big one).
  chunked prefill   -- prompts prefill in page-aligned chunks, ONE chunk
      per engine iteration (round-robin over prefilling slots), with a
      decode step for running slots between chunks.  Rows not decoding
      carry an all-zeros block-table row, so their garbage lands on the
      scratch page and is ignored.

With prefix sharing (on by default with the paged cache) the pool pages
are REFCOUNTED and a registry keyed by a chained hash of the token ids
maps every request's full prompt-prefix pages to their physical pages:

  prefix hits    -- an admitted prompt whose leading full pages match a
      registered prefix (verified against the stored token ids: a hash
      collision degrades to a miss, never a wrong share) SHARES those
      physical pages instead of allocating and prefilling them; its
      first chunk starts at the shared depth.  The registry OWNS one
      holder per registered page, so a warm prefix survives its
      requests; when admission starves, registry-only pages are EVICTED
      deepest-first until the admit fits.
  copy-on-write  -- shared pages are never written.  A prompt that is
      ENTIRELY a registered prefix re-decodes its last token for the
      first-token logits -- a write into the last shared page -- so
      that page is first copied onto a fresh one
      (``Decoder.copy_page``) and the write lands on the copy.  Every
      write of a decode batch lands on a page its row owns alone; rows
      read shared pages freely.
  release on retire -- refcounts drop at retire; a page returns to the
      free list (and its registry entry dies) only when its last holder
      releases it.  Pages register only when a prompt's LAST chunk has
      run: a lookup never finds a half-written page.

Lifecycle: ``handle.cancel()`` (any thread) retires a running slot with
its tokens so far and its pages freed, or resolves a queued request at
once; ``begin_drain()`` (signal-handler safe) sheds new submits with
``retry_after`` while queued and in-flight work finishes; ``stop()``
joins the engine thread and flushes the MFU ledger's summary.  A
``heartbeat`` (obs/watchdog.Heartbeat) beats once per engine iteration;
with tracing on every request's submit, admit, retire or cancel is a
trace record carrying its trace id.

One engine thread (a daemon) owns ALL device work; ``submit`` only
enqueues.  The thread's CUDA stream is its own current stream: the
kernels' wrappers and ``copy_page`` queue on it, in program order.

Not ported yet: KV-page migration (``read_page``, ``write_page``,
``export_chain_*``, ``import_chain``, ``run_on_engine``), the
``slow_replica`` chaos probe and tensor-parallel decode.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import logging
import queue as queue_mod
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.ledger import Ledger
from dtf_tpu_torch.obs.registry import MetricsRegistry
from dtf_tpu_torch.serve.decode import Decoder

log = logging.getLogger("dtf_tpu_torch")


class Backpressure(RuntimeError):
    """Request shed: the queue is full (or the engine drains).
    ``retry_after`` (seconds) is the engine's estimate of when capacity
    frees up."""

    def __init__(self, retry_after: float):
        super().__init__(
            f"serving queue full -- shed; retry after {retry_after:.2f}s")
        self.retry_after = retry_after


@dataclasses.dataclass
class ServeRequest:
    prompt: np.ndarray                  # 1-D int32 token ids
    max_new_tokens: int = 32
    temperature: float = 0.0            # 0 = greedy
    eos_id: Optional[int] = None        # stop token (included in output)
    # distributed-tracing span context: the trace id follows the
    # request; trace_parent is the upstream span id its records link to
    trace_id: Optional[str] = None
    trace_parent: Optional[str] = None
    # per-request sampling seed: sampled tokens are a pure function of
    # (rng_seed, position).  None at submit = derived from (engine seed,
    # request id)
    rng_seed: Optional[int] = None
    # filled by the engine
    id: int = -1
    submit_time: float = 0.0
    admit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0


@dataclasses.dataclass
class ServeResult:
    request_id: int
    tokens: List[int]                   # generated tokens (prompt excluded)
    prompt_len: int
    queue_wait_s: float
    time_to_first_token_s: float
    latency_s: float
    # absolute timestamps (time.time())
    submit_time: float = 0.0
    finish_time: float = 0.0
    cancelled: bool = False
    trace_id: Optional[str] = None      # the request's distributed-trace id


class _Handle:
    """Future-lite returned by submit(), plus a token stream."""

    def __init__(self, req: ServeRequest,
                 on_token: Optional[Callable] = None,
                 stream_lag_hist=None, cond=None):
        self.request = req
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None
        self._on_token = on_token
        self._lag_hist = stream_lag_hist
        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self._cancel = threading.Event()
        self._cond = cond

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def cancel(self) -> None:
        """Ask the engine to stop working on this request.  At its next
        iteration a queued request resolves (``cancelled=True``, no
        tokens) and a running slot retires with the tokens decoded so
        far, its pages freed.  Safe from any thread (non-blocking: the
        wake-up is best-effort); idempotent."""
        self._cancel.set()
        if self._cond is not None and self._cond.acquire(blocking=False):
            try:
                self._cond.notify_all()
            finally:
                self._cond.release()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not finished in {timeout}s")
        return self._result

    def stream(self, timeout: Optional[float] = None):
        """Iterator over generated tokens, yielding as each retires;
        ``timeout`` bounds the wait for EACH token.  Ends when the
        request finishes or is cancelled.  Observes the engine's
        ``serve_stream_lag_s``: engine emit to consumer receive."""
        while True:
            try:
                kind, payload = self._q.get(timeout=timeout)
            except queue_mod.Empty:
                raise TimeoutError(
                    f"request {self.request.id}: no token in {timeout}s"
                ) from None
            if kind == "done":
                return
            tok, t_emit = payload
            if self._lag_hist is not None:
                self._lag_hist.observe(max(0.0, time.time() - t_emit))
            yield tok

    def _emit(self, token: int):
        """Engine thread: one token retired."""
        self._q.put(("token", (int(token), time.time())))
        if self._on_token is not None:
            try:
                self._on_token(int(token))
            except Exception:  # noqa: BLE001 -- a client callback must
                # never take down the engine thread
                log.exception("serve: on_token callback raised")

    def _deliver(self, result: ServeResult):
        self._result = result
        self._event.set()
        self._q.put(("done", None))


class PagePool:
    """Host-side REFCOUNTED free-list allocator over the shared KV page
    pool.

    Page 0 is the SCRATCH page, never handed to a request: rows of the
    fixed-shape decode batch that are not decoding carry all-zeros
    block-table rows, so their garbage lands there.

    ``alloc`` grants fresh pages at refcount 1, ``share`` adds a holder
    to a live page, and ``free`` releases one holder -- a page returns
    to the free list only when its LAST holder releases it.
    ``high_water`` is the peak of physical pages in use."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"page pool needs >= 2 pages (page 0 is "
                             f"scratch), got {num_pages}")
        self.num_pages = int(num_pages)
        # LIFO free stack: a retired request's pages go to the next admit
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self.high_water = 0

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    @property
    def shared_refs(self) -> int:
        """Holders beyond the first across all pages: the page grants
        prefix sharing is saving right now."""
        return sum(c - 1 for c in self._ref.values() if c > 1)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None when the pool cannot
        cover them (the caller waits for a retire -- never a partial
        grant)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.high_water = max(self.high_water, self.used_pages)
        return pages

    def share(self, pages: List[int]) -> None:
        """One more holder on each (live) page: the prefix-hit grant."""
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise ValueError(
                    f"page {p} is not allocated -- sharing a freed page "
                    f"would alias a future grant")
            self._ref[p] += 1

    def free(self, pages: List[int]) -> List[int]:
        """Release one holder per page; returns the pages PHYSICALLY
        freed (their last holder left), whose registry entries the
        engine drops."""
        freed: List[int] = []
        for p in pages:
            c = self._ref.get(p, 0)
            if c < 1:
                raise ValueError(f"double free of page {p}")
            if c == 1:
                del self._ref[p]
                self._free.append(p)
                freed.append(p)
            else:
                self._ref[p] = c - 1
        return freed


def _tctx(trace_id, parent=None) -> Dict[str, str]:
    """Span-context attrs of a per-request trace record -- empty when
    the request carries no trace id."""
    if trace_id is None:
        return {}
    out = {"trace": trace_id}
    if parent is not None:
        out["parent_span"] = parent
    return out


def _page_digest(prev: str, page_tokens: np.ndarray) -> str:
    """Chained content key: the depth-d digest is sha1(depth-(d-1)
    digest + page d's int32 token bytes), so a registry walk is
    O(pages).  The registry verifies the stored tokens on every hit
    anyway (module-level so tests can force a collision)."""
    return hashlib.sha1(
        prev.encode()
        + np.ascontiguousarray(page_tokens, np.int32).tobytes()
    ).hexdigest()


class PrefixRegistry:
    """Token-id hash -> physical page, for FULL prompt-prefix pages.

    The entry at depth d maps the chained digest of
    ``prompt[: (d + 1) * page_size]`` to the page holding positions
    [d * ps, (d + 1) * ps) of that prefix -- valid because KV content
    is a pure function of (token ids, absolute positions).  Entries
    OWN one pool holder each (cache semantics).  Lookup walks depths
    0, 1, ... and stops at the first miss or the first stored-token
    mismatch (the hash-collision guard)."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        # (depth, chain digest) -> (physical page, THAT page's tokens):
        # lookup walks from depth 0, so matching each page's own tokens
        # proves the whole prefix by induction
        self._entries: Dict[Tuple[int, str], Tuple[int, bytes]] = {}
        self._by_page: Dict[int, Tuple[int, str]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: np.ndarray) -> List[int]:
        """The longest registered chain of the prompt's full pages --
        pages[d] holds positions [d * ps, (d + 1) * ps)."""
        ps = self.page_size
        pages: List[int] = []
        digest = ""
        for depth in range(int(len(prompt)) // ps):
            block = np.ascontiguousarray(
                prompt[depth * ps: (depth + 1) * ps], np.int32)
            digest = _page_digest(digest, block)
            ent = self._entries.get((depth, digest))
            if ent is None or ent[1] != block.tobytes():
                break
            pages.append(ent[0])
        return pages

    def register(self, prompt: np.ndarray, pages: List[int]) -> List[int]:
        """Record a request's full prompt pages (pages[d] = the page of
        depth d).  First writer wins per key; a page backs at most one
        entry.  Returns the NEWLY registered pages -- the engine gives
        the registry one pool holder for exactly those."""
        ps = self.page_size
        fresh: List[int] = []
        digest = ""
        for depth, page in enumerate(pages):
            block = np.ascontiguousarray(
                prompt[depth * ps: (depth + 1) * ps], np.int32)
            digest = _page_digest(digest, block)
            key = (depth, digest)
            if key in self._entries or page in self._by_page:
                continue
            self._entries[key] = (page, block.tobytes())
            self._by_page[page] = key
            fresh.append(page)
        return fresh

    def pages_by_depth_desc(self) -> List[int]:
        """Every registered page, deepest entries first: the eviction
        order (evicting depth d+1 before d keeps each surviving chain
        contiguous from depth 0, which is all lookup can use)."""
        return [page for (depth, _), (page, _) in sorted(
            self._entries.items(), key=lambda kv: -kv[0][0])]

    def drop_page(self, page: int) -> None:
        """The pool physically freed this page: its content is about to
        be someone else's."""
        key = self._by_page.pop(page, None)
        if key is not None:
            self._entries.pop(key, None)


@dataclasses.dataclass
class _Slot:
    handle: _Handle
    tokens: List[int]                   # generated so far
    last_token: int                     # next decode step's input
    index: int                          # current sequence length
    phase: str = "decode"               # "prefill" until the prompt is in
    # paged mode:
    pages: Optional[List[int]] = None   # one holder on each, freed at retire
    block_row: Optional[np.ndarray] = None  # [M] int32 page ids
    prompt_padded: Optional[np.ndarray] = None  # page-aligned prompt
    chunk_plan: Optional[List] = None   # [(start, len), ...]
    chunk_i: int = 0                    # next chunk to run


class ServeEngine:
    """Dynamic batcher over a :class:`~dtf_tpu_torch.serve.decode.Decoder`.

    ``model`` is a TransformerLM with its weights loaded, on the device
    to serve from.  ``max_seq_len`` bounds prompt + generation per
    request.  ``kv_page_size`` selects the paged cache (the default;
    0/None = the contiguous per-slot layout); ``kv_pool_pages`` total
    pool pages incl. the scratch page (0/None = the full reservation);
    ``prefill_chunk`` the chunk in tokens (a page multiple; 0 = whole
    prompts as one chunk; None = 4 pages).  ``prefix_sharing`` (paged
    mode, default on) shares full prompt-prefix pages through the
    refcounted pool and the prefix registry.  ``heartbeat``
    (obs/watchdog.Heartbeat) is beaten once per engine iteration with
    step = completed requests: a deadlocked engine thread stops beating.

    LOCK DISCIPLINE: ``_cond`` guards ``_pending``, ``_draining`` and
    ``_ewma_latency``, shared between client threads and the engine
    thread (``begin_drain`` stores ``_draining`` without it: a signal
    handler may not block).  ``_slots``, the pool, the registry and the
    cache are engine-thread state."""

    def __init__(self, model, *, max_batch: int = 8,
                 max_seq_len: Optional[int] = None,
                 max_delay_s: float = 0.005, queue_size: int = 64,
                 seed: int = 0, kv_page_size: Optional[int] = 16,
                 kv_pool_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_sharing: bool = True, heartbeat=None):
        if max_batch < 1 or queue_size < 1:
            raise ValueError("max_batch and queue_size must be >= 1")
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len or model.max_seq_len)
        self.max_delay_s = float(max_delay_s)
        self.queue_size = int(queue_size)
        self.paged = bool(kv_page_size)
        # the registry exists before the decoder: the MFU ledger exports
        # through it and the decoder registers its executables there
        self.metrics = MetricsRegistry()
        self.ledger = Ledger(self.metrics, device=model.pos_embed.device)
        if self.paged:
            self.page_size = int(kv_page_size)
            self.prefill_chunk = (4 * self.page_size if prefill_chunk
                                  is None else int(prefill_chunk))
            if self.prefill_chunk % self.page_size:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a "
                    f"multiple of kv_page_size ({self.page_size})")
            self.decoder = Decoder(model, num_slots=self.max_batch,
                                   max_seq_len=self.max_seq_len,
                                   kv_page_size=self.page_size,
                                   kv_pool_pages=kv_pool_pages or None,
                                   ledger=self.ledger)
            self.pool = PagePool(self.decoder.pool_pages)
            self.prefix_sharing = bool(prefix_sharing)
            self.registry = PrefixRegistry(self.page_size)
        else:
            # an explicit pool or chunk size with the contiguous cache
            # is a contradiction, refused whatever its value
            if kv_pool_pages or prefill_chunk is not None:
                raise ValueError("kv_pool_pages / prefill_chunk need the "
                                 "paged cache (kv_page_size > 0)")
            # sharing is a property of the page pool: none to share here
            self.prefix_sharing = False
            self.registry = None
            self.decoder = Decoder(model, num_slots=self.max_batch,
                                   max_seq_len=self.max_seq_len)
            self.pool = None
        self._cache = self.decoder.fresh_cache()
        self._seed = int(seed)

        self._cond = threading.Condition()
        self._pending: List[_Handle] = []
        self._slots: List[Optional[_Slot]] = [None] * self.max_batch
        self._stop = threading.Event()
        self._draining = False
        self._ids = itertools.count()
        self.completed: List[ServeResult] = []
        m = self.metrics
        self._m_queue_depth = m.gauge("serve_queue_depth", unit="requests")
        self._m_occupancy = m.gauge("serve_slot_occupancy", unit="fraction")
        self._m_shed = m.counter("serve_shed_total", unit="requests")
        self._m_admitted = m.counter("serve_admitted_total",
                                     unit="requests")
        self._m_completed = m.counter("serve_completed_total",
                                      unit="requests")
        self._m_latency = m.histogram("serve_latency_s", unit="s")
        self._m_queue_wait = m.histogram("serve_queue_wait_s", unit="s")
        # per-iteration samples of the same signals: a finished run
        # still has a distribution (the gauges hold the drained values)
        self._m_queue_sampled = m.histogram("serve_queue_depth_sampled",
                                            unit="requests")
        self._m_occ_sampled = m.histogram("serve_slot_occupancy_sampled",
                                          unit="fraction")
        self._m_pages_used = m.gauge("serve_kv_pages_used", unit="pages")
        self._m_pages_sampled = m.histogram("serve_kv_pages_used_sampled",
                                            unit="pages")
        self._m_prefill_chunks = m.counter("serve_prefill_chunks_total",
                                           unit="chunks")
        # wall time between consecutive decode steps while slots decode:
        # the head-of-line gap chunked prefill bounds
        self._m_decode_gap = m.histogram("serve_decode_gap_s", unit="s")
        # one decode step, host clock around work ending in the token
        # copy to the host (a device sync)
        self._m_step_time = m.histogram("serve_decode_step_s", unit="s")
        # prefix sharing: pages shared instead of allocated, COW copies,
        # evictions and the live shared-holder count
        self._m_prefix_hits = m.counter("serve_prefix_hit_pages_total",
                                        unit="pages")
        self._m_cow = m.counter("serve_prefix_cow_total", unit="pages")
        self._m_evicted = m.counter("serve_prefix_evicted_total",
                                    unit="pages")
        self._m_shared = m.gauge("serve_kv_pages_shared_refs", unit="refs")
        # streaming: engine emit -> consumer receive, per token
        self._m_stream_lag = m.histogram("serve_stream_lag_s", unit="s")
        self._m_cancelled = m.counter("serve_cancelled_total",
                                      unit="requests")
        self._heartbeat = heartbeat
        self._last_step_t: Optional[float] = None
        self._prefill_rr = -1           # round-robin cursor (chunk sched)
        self.max_concurrent = 0         # peak simultaneously-active slots
        self._ewma_latency = 0.25       # seed estimate for retry_after
        # the exception that killed the engine thread, if one did
        self.failed: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-engine")
        self._thread.start()

    @property
    def shed_count(self) -> int:
        return self._m_shed.value

    @property
    def outstanding(self) -> int:
        """Queued + in-flight requests."""
        with self._cond:
            return (len(self._pending)
                    + sum(s is not None for s in self._slots))

    def reset_measurement(self) -> int:
        """Zero the peak and distribution measurements (decode-gap
        histogram, peak concurrency, pool high-water) under the engine
        lock; returns the completed-request count -- the slice point for
        post-warmup stats."""
        with self._cond:
            self._m_decode_gap.reset()
            self._last_step_t = None
            self.max_concurrent = 0
            if self.pool is not None:
                self.pool.high_water = self.pool.used_pages
            return len(self.completed)

    # -- client side ---------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               trace_id: Optional[str] = None,
               trace_parent: Optional[str] = None,
               rng_seed: Optional[int] = None) -> _Handle:
        """Enqueue a request.  ``on_token`` is called FROM THE ENGINE
        THREAD per retired token; ``handle.stream()`` is the pull-based
        alternative.  ``trace_id``/``trace_parent`` carry the span
        context (with tracing on and no id, the engine mints one).
        ``rng_seed`` pins the request's sampling identity (None =
        derived from the engine seed and the request id)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        total = int(prompt.size) + int(max_new_tokens)
        if total > self.max_seq_len:
            raise ValueError(
                f"oversized request: prompt ({prompt.size}) + "
                f"max_new_tokens ({max_new_tokens}) = {total} exceeds "
                f"max_seq_len {self.max_seq_len}")
        if self.paged:
            need = -(-total // self.page_size)
            if need > self.pool.usable_pages:
                raise ValueError(
                    f"oversized request for the page pool: needs {need} "
                    f"pages of {self.page_size} tokens but the pool has "
                    f"{self.pool.usable_pages} usable -- it could never "
                    f"be admitted")
        if trace_id is None and trace.enabled():
            trace_id = trace.new_trace_id()
        req = ServeRequest(prompt=prompt, max_new_tokens=int(max_new_tokens),
                           temperature=float(temperature), eos_id=eos_id,
                           trace_id=trace_id, trace_parent=trace_parent,
                           rng_seed=None if rng_seed is None
                           else int(rng_seed))
        handle = _Handle(req, on_token=on_token,
                         stream_lag_hist=self._m_stream_lag,
                         cond=self._cond)
        with self._cond:
            if self._stop.is_set():
                raise RuntimeError("engine is stopped")
            if self._draining:
                # SIGTERM drain: admissions stop; queued and in-flight
                # work still finishes.  A shed, so the client retries
                # elsewhere after retry_after
                self._m_shed.inc()
                retry = max(0.05, self._ewma_latency)
                log.warning("serve: draining -- shedding request "
                            "(retry_after=%.2fs)", retry)
                trace.anomaly("serve_shed", reason="draining",
                              shed_total=self.shed_count,
                              retry_after=retry,
                              **_tctx(trace_id, trace_parent))
                raise Backpressure(retry)
            if len(self._pending) >= self.queue_size:
                self._m_shed.inc()
                retry = max(0.05, self._ewma_latency
                            * (1 + len(self._pending) / self.max_batch))
                log.error("serve: queue full (%d pending, %d slots) -- "
                          "shedding request (%d total shed); "
                          "retry_after=%.2fs", len(self._pending),
                          self.max_batch, self.shed_count, retry)
                trace.anomaly("serve_shed", pending=len(self._pending),
                              shed_total=self.shed_count,
                              retry_after=retry,
                              **_tctx(trace_id, trace_parent))
                raise Backpressure(retry)
            req.id = next(self._ids)
            req.submit_time = time.time()
            if req.rng_seed is None:
                req.rng_seed = (self._seed * 1_000_003 + req.id
                                + 12_345) & 0x7FFFFFFF
            self._pending.append(handle)
            self._m_queue_depth.set(len(self._pending))
            if trace_id is not None:
                trace.event("serve_submit", request=req.id,
                            prompt_len=int(prompt.size),
                            queue_depth=len(self._pending),
                            **_tctx(trace_id, trace_parent))
            self._cond.notify_all()
        return handle

    def generate(self, prompt, **kw) -> ServeResult:
        """Blocking convenience: submit + wait."""
        return self.submit(prompt, **kw).result(timeout=600)

    # -- engine thread -------------------------------------------------
    def _loop(self):
        try:
            self._loop_body()
        except Exception as e:
            # a dead engine thread must not strand clients blocked in
            # result(): fail loudly and deliver cancellations
            log.exception("serve engine thread died -- cancelling all "
                          "in-flight and queued requests")
            self.failed = e
            with self._cond:
                self._stop.set()
                stranded = ([s.handle for s in self._slots if s is not None]
                            + list(self._pending))
                self._slots = [None] * self.max_batch
                self._pending.clear()
            for handle in stranded:
                handle._deliver(ServeResult(
                    request_id=handle.request.id, tokens=[], prompt_len=0,
                    queue_wait_s=0.0, time_to_first_token_s=0.0,
                    latency_s=0.0, cancelled=True))

    def _loop_body(self):
        while True:
            if self._heartbeat is not None:
                # serving liveness; the interval gate is inside beat()
                self._heartbeat.beat(step=self._m_completed.value)
            with self._cond:
                # cancellation sweep, queued half: resolved before it
                # can cost an admission's pages
                cancelled_pending = [h for h in self._pending
                                     if h._cancel.is_set()]
                for handle in cancelled_pending:
                    self._pending.remove(handle)
                    self._finish_cancelled(handle)
                if cancelled_pending:
                    self._m_queue_depth.set(len(self._pending))
                active = any(s is not None for s in self._slots)
                if not self._pending and not active:
                    if self._stop.is_set():
                        return
                    # idle: the next step's gap would measure an empty
                    # queue, not head-of-line blocking
                    self._last_step_t = None
                    self._cond.wait(timeout=0.1)
                    continue
                if not active and self._pending and self.max_delay_s > 0:
                    # fresh batch: hold the door up to max_delay after
                    # the FIRST pending arrival so the batch can fill
                    first = self._pending[0].request.submit_time
                    while (len(self._pending) < self.max_batch
                           and not self._stop.is_set()):
                        remaining = first + self.max_delay_s - time.time()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                admitted = []
                for i, slot in enumerate(self._slots):
                    if slot is None and self._pending:
                        grant = None
                        if self.paged:
                            grant = self._grant(self._pending[0].request)
                            if grant is None:
                                # head-of-line FIFO wait for a retire
                                break
                        admitted.append((i, self._pending.pop(0), grant))
                pending_depth = len(self._pending)
                self._m_queue_depth.set(pending_depth)
            if self._stop.is_set() and not admitted and not any(
                    s is not None for s in self._slots):
                return
            if admitted:
                attrs = {"admitted": len(admitted)}
                if trace.enabled():
                    tids = [h.request.trace_id for _, h, _ in admitted
                            if h.request.trace_id]
                    if tids:
                        attrs["traces"] = tids
                with trace.span("serve_batch_form", **attrs):
                    for i, handle, grant in admitted:
                        self._admit(i, handle, grant)
                self._m_admitted.inc(len(admitted))
            # cancellation sweep, running half: a cancelled slot retires
            # now, its pages back to the pool
            for i, s in enumerate(self._slots):
                if s is not None and s.handle._cancel.is_set():
                    self._retire(i, cancelled=True)
            # chunked prefill: ONE chunk per iteration in total, round-
            # robin over prefilling slots, so running decodes wait at
            # most one chunk
            prefilling = [i for i, s in enumerate(self._slots)
                          if s is not None and s.phase == "prefill"]
            if prefilling:
                nxt = next((i for i in prefilling if i > self._prefill_rr),
                           prefilling[0])
                self._advance_prefill(nxt)
                self._prefill_rr = nxt
            active = sum(s is not None for s in self._slots)
            decoding = sum(s is not None and s.phase == "decode"
                           for s in self._slots)
            self.max_concurrent = max(self.max_concurrent, active)
            self._m_occupancy.set(active / self.max_batch)
            if self.paged:
                self._m_pages_used.set(self.pool.used_pages)
                self._m_shared.set(self.pool.shared_refs)
            if active:
                self._m_occ_sampled.observe(active / self.max_batch)
                self._m_queue_sampled.observe(pending_depth)
                if self.paged:
                    self._m_pages_sampled.observe(self.pool.used_pages)
            if decoding:
                self._step()
            else:
                self._last_step_t = None

    def _grant(self, req: ServeRequest):
        """(fresh pages, shared pages, cow) for the head of the queue, or
        None when the pool cannot cover it even after eviction (engine
        thread, under the lock)."""
        shared, need, cow = self._admission_plan(req)
        # hold the shared pages BEFORE any alloc or eviction: a
        # registry-only page this admit is about to share must not be
        # evicted from under it
        self.pool.share(shared)
        pages = self.pool.alloc(need)
        if pages is None:
            self._evict_for(need)
            pages = self.pool.alloc(need)
        if pages is None:
            # un-hold the speculative shares (the registry's own holder
            # keeps them warm for the retry)
            for p in self.pool.free(shared):
                self.registry.drop_page(p)
            return None
        if shared:
            self._m_prefix_hits.inc(len(shared))
        return pages, shared, cow

    def _evict_for(self, need: int):
        """Free registry-only pages (deepest entries first) until
        ``need`` pages are free or nothing evictable remains; pages a
        live slot holds (refcount > 1) are skipped."""
        if not self.prefix_sharing:
            return
        for page in self.registry.pages_by_depth_desc():
            if self.pool.free_pages >= need:
                return
            if self.pool.refcount(page) == 1:
                for p in self.pool.free([page]):
                    self.registry.drop_page(p)
                self._m_evicted.inc()

    def _pages_needed(self, req: ServeRequest) -> int:
        """Worst-case pages: prompt + full budget, reserved up front so
        a decode step can never run out of pages mid-generation."""
        total = int(req.prompt.size) + int(req.max_new_tokens)
        return -(-total // self.page_size)

    def _admission_plan(self, req: ServeRequest):
        """(shared pages, fresh pages needed, cow) for one request.

        ``shared``: the registry's longest verified chain of the
        prompt's full pages.  ``cow`` when the chain covers the WHOLE
        prompt: the slot then skips prefill and re-decodes its last
        prompt token, a write into the last shared page, which needs a
        fresh copy-on-write target (+1 page)."""
        total_pages = self._pages_needed(req)
        shared = (self.registry.lookup(req.prompt)
                  if self.prefix_sharing else [])
        cow = bool(shared) and len(shared) * self.page_size >= int(
            req.prompt.size)
        if cow and total_pages + 1 > self.pool.usable_pages:
            # a request sized to the pool would need usable + 1 pages
            # with the COW target -- never satisfiable, and its own share
            # holds the chain above eviction: degrade to prefilling the
            # chain's last page instead of livelocking
            shared = shared[:-1]
            cow = False
        need = total_pages - len(shared) + (1 if cow else 0)
        return shared, need, cow

    def _chunk_plan(self, plen: int, start: int = 0):
        """[(start, len), ...] page-aligned chunks covering [start, plen)
        (``start``, the first position not covered by shared pages, is
        page-aligned): full ``prefill_chunk`` chunks, then one final
        chunk padded to the page size (it holds the last real prompt
        token, the sampled position).  prefill_chunk == 0: one chunk for
        the remainder."""
        chunk = self.prefill_chunk or -(-(plen - start) //
                                        self.page_size) * self.page_size
        plan = []
        while plen - start > chunk:
            plan.append((start, chunk))
            start += chunk
        rem = plen - start
        plan.append((start, -(-rem // self.page_size) * self.page_size))
        return plan

    def _admit(self, slot_idx: int, handle: _Handle, grant):
        req = handle.request
        req.admit_time = time.time()
        if req.trace_id is not None:
            attrs = {}
            if grant is not None:
                # the shared depth in tokens (pages are an engine detail)
                attrs["shared_tokens"] = len(grant[1]) * self.page_size
            trace.event("serve_admit", request=req.id, slot=slot_idx,
                        queue_wait_s=req.admit_time - req.submit_time,
                        **attrs, **_tctx(req.trace_id, req.trace_parent))
        if not self.paged:
            tok, self._cache, _ = self.decoder.prefill(
                self._cache, req.prompt, slot_idx, req.temperature,
                seed=req.rng_seed)
            first = int(tok)
            req.first_token_time = time.time()
            slot = _Slot(handle=handle, tokens=[first], last_token=first,
                         index=int(req.prompt.size))
            self._slots[slot_idx] = slot
            handle._emit(first)
            if self._finished(slot):
                self._retire(slot_idx)
            return
        fresh, shared, cow = list(grant[0]), list(grant[1]), grant[2]
        plen = int(req.prompt.size)
        if cow:
            # the whole prompt is a registered prefix: the slot's only
            # compute is re-decoding its last prompt token, which WRITES
            # position plen - 1 into the last shared page -- so that
            # write goes to a fresh copy, queued on this thread's stream
            # before the step that reads it
            src = shared.pop()
            dst = fresh.pop(0)
            self._cache = self.decoder.copy_page(self._cache, src, dst)
            self._m_cow.inc()
            for p in self.pool.free([src]):   # release our share
                self.registry.drop_page(p)
            logical = shared + [dst] + fresh
        else:
            logical = shared + fresh
        k = len(shared) + (1 if cow else 0)   # depths covered pre-prefill
        block_row = np.zeros((self.decoder.pages_per_slot,), np.int32)
        block_row[:len(logical)] = logical
        if cow:
            # no prefill: straight to decode, replaying the last prompt
            # token (its KV write lands in the COW page)
            self._slots[slot_idx] = _Slot(
                handle=handle, tokens=[], last_token=int(req.prompt[-1]),
                index=plen - 1, pages=logical, block_row=block_row)
            return
        plan = self._chunk_plan(plen, start=k * self.page_size)
        prompt_padded = np.zeros((plan[-1][0] + plan[-1][1],), np.int32)
        prompt_padded[:plen] = req.prompt
        self._slots[slot_idx] = _Slot(
            handle=handle, tokens=[], last_token=0, index=0, phase="prefill",
            pages=logical, block_row=block_row, prompt_padded=prompt_padded,
            chunk_plan=plan)

    def _advance_prefill(self, slot_idx: int):
        slot = self._slots[slot_idx]
        req = slot.handle.request
        start, clen = slot.chunk_plan[slot.chunk_i]
        is_last = slot.chunk_i == len(slot.chunk_plan) - 1
        plen = int(req.prompt.size)
        sample_pos = plen - 1 - start if is_last else 0
        t0 = time.perf_counter()
        pre_counted = self.decoder.compiled_count
        with trace.span("serve_prefill_chunk", slot=slot_idx, start=start,
                        tokens=clen, last=is_last,
                        **_tctx(req.trace_id, req.trace_parent)):
            tok, self._cache, _ = self.decoder.prefill_chunk(
                self._cache, slot.prompt_padded[start:start + clen],
                slot.block_row, start, sample_pos, req.temperature,
                seed=req.rng_seed)
        self._m_prefill_chunks.inc()
        slot.chunk_i += 1
        if not is_last:
            # earlier chunks' samples are discarded unread: no host sync
            return
        first = int(tok)
        # the int(tok) sync makes the last chunk the one whose wall time
        # spans a device sync: the ledger's only honest sample of the
        # chunk executable (a counted call's wall is the counter's)
        if self.decoder.compiled_count == pre_counted:
            flops, _ = self.decoder.last_cost
            self.ledger.observe(f"serve_prefill_chunk_c{clen}",
                                time.perf_counter() - t0, flops=flops)
        req.first_token_time = time.time()
        slot.tokens = [first]
        slot.last_token = first
        slot.index = plen
        slot.phase = "decode"
        if self.prefix_sharing and plen // self.page_size:
            # the full prompt pages are now written and immutable
            # (decode writes land past the prompt): publish them.  The
            # registry takes its own holder on each newly registered page
            self.pool.share(self.registry.register(
                req.prompt,
                [int(p) for p in slot.block_row[:plen // self.page_size]]))
        slot.handle._emit(first)
        if self._finished(slot):
            self._retire(slot_idx)

    def _step(self):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._m_decode_gap.observe(now - self._last_step_t)
        tokens = np.zeros((self.max_batch,), np.int32)
        index = np.zeros((self.max_batch,), np.int32)
        temps = np.zeros((self.max_batch,), np.float32)
        seeds = np.zeros((self.max_batch,), np.int64)
        # rows not decoding keep all-zeros rows -> the scratch page
        tables = (np.zeros((self.max_batch, self.decoder.pages_per_slot),
                           np.int32) if self.paged else None)
        for i, s in enumerate(self._slots):
            if s is not None and s.phase == "decode":
                tokens[i] = s.last_token
                index[i] = s.index
                temps[i] = s.handle.request.temperature
                seeds[i] = s.handle.request.rng_seed
                if tables is not None:
                    tables[i] = s.block_row
        attrs = {}
        if trace.enabled():
            tids = [s.handle.request.trace_id for s in self._slots
                    if s is not None and s.phase == "decode"
                    and s.handle.request.trace_id]
            if tids:
                attrs["traces"] = tids
        pre_counted = self.decoder.compiled_count
        with trace.span("serve_decode", **attrs):
            out, self._cache, _ = self.decoder.decode_step(
                self._cache, tokens, index, temps, block_tables=tables,
                seeds=seeds)
            # the EOS/budget check needs the tokens on the host: this
            # copy is the step's device sync
            out = out.cpu().numpy()
        step_dt = time.perf_counter() - now
        self._m_step_time.observe(step_dt)
        if self.paged and self.decoder.compiled_count == pre_counted:
            # synced above, so this wall is the step's; a counted call's
            # is the FLOP counter's and is dropped
            flops, nbytes = self.decoder.last_cost
            self.ledger.observe("serve_decode_step", step_dt, flops=flops,
                                bytes_accessed=nbytes)
        for i, s in enumerate(self._slots):
            if s is None or s.phase != "decode":
                continue
            tok = int(out[i])
            s.tokens.append(tok)
            s.last_token = tok
            s.index += 1
            req = s.handle.request
            if req.first_token_time == 0.0:
                # the COW path skips prefill: its first token comes out
                # of this decode step
                req.first_token_time = time.time()
            s.handle._emit(tok)
            if self._finished(s):
                self._retire(i)
        self._last_step_t = time.perf_counter()

    @staticmethod
    def _finished(slot: _Slot) -> bool:
        req = slot.handle.request
        return (len(slot.tokens) >= req.max_new_tokens
                or (req.eos_id is not None
                    and slot.tokens[-1] == req.eos_id))

    def _finish_cancelled(self, handle: _Handle) -> None:
        """Resolve a cancelled request that never occupied a slot."""
        req = handle.request
        self._m_cancelled.inc()
        if req.trace_id is not None:
            trace.event("serve_cancelled", request=req.id, tokens=0,
                        queued=True, **_tctx(req.trace_id, req.trace_parent))
        handle._deliver(ServeResult(
            request_id=req.id, tokens=[], prompt_len=int(req.prompt.size),
            queue_wait_s=0.0, time_to_first_token_s=0.0, latency_s=0.0,
            submit_time=req.submit_time, finish_time=time.time(),
            cancelled=True, trace_id=req.trace_id))

    def _retire(self, slot_idx: int, cancelled: bool = False):
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        if slot.pages:
            # each page loses this slot's holder; a page whose last
            # holder left goes back to the free list, its registry entry
            # with it (the page is about to hold someone else's KV)
            for p in self.pool.free(slot.pages):
                if self.registry is not None:
                    self.registry.drop_page(p)
        req = slot.handle.request
        req.finish_time = time.time()
        result = ServeResult(
            request_id=req.id, tokens=list(slot.tokens),
            prompt_len=int(req.prompt.size),
            queue_wait_s=req.admit_time - req.submit_time,
            # a slot cancelled mid-prefill has no first token: 0.0
            time_to_first_token_s=(req.first_token_time - req.submit_time
                                   if req.first_token_time else 0.0),
            latency_s=req.finish_time - req.submit_time,
            submit_time=req.submit_time, finish_time=req.finish_time,
            cancelled=cancelled, trace_id=req.trace_id)
        if cancelled:
            # an abandoned answer: its pages are reclaimed above, but it
            # stays out of the latency and completion statistics
            self._m_cancelled.inc()
            if req.trace_id is not None:
                trace.event("serve_cancelled", request=req.id,
                            tokens=len(slot.tokens), queued=False,
                            **_tctx(req.trace_id, req.trace_parent))
            slot.handle._deliver(result)
            with self._cond:
                self._cond.notify_all()
            return
        if req.trace_id is not None:
            trace.event("serve_retire", request=req.id,
                        tokens=len(slot.tokens), latency_s=result.latency_s,
                        **_tctx(req.trace_id, req.trace_parent))
        self._m_completed.inc()
        self._m_latency.observe(result.latency_s)
        self._m_queue_wait.observe(result.queue_wait_s)
        self.completed.append(result)
        slot.handle._deliver(result)
        with self._cond:
            # under the lock: submit's retry_after estimate reads it
            self._ewma_latency = (0.8 * self._ewma_latency
                                  + 0.2 * result.latency_s)
            self._cond.notify_all()

    # -- lifecycle -----------------------------------------------------
    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    def begin_drain(self) -> None:
        """Graceful shutdown, phase 1 -- called from the SIGTERM handler,
        so it takes no blocking lock and logs nothing (the interrupted
        frame may hold either).  New submits shed with ``retry_after``;
        queued and in-flight requests decode to completion.  Follow with
        ``stop(drain=True)``, then exit 0."""
        # the store is GIL-atomic and monotonic; readers see it at their
        # next acquisition of _cond
        self._draining = True
        if self._cond.acquire(blocking=False):  # best-effort wake
            try:
                self._cond.notify_all()
            finally:
                self._cond.release()

    def stop(self, drain: bool = True, timeout: float = 60.0):
        """Stop the engine.  ``drain=True`` finishes in-flight AND queued
        work first; False cancels queued requests.  Then the MFU
        ledger's summary goes to the trace stream."""
        with self._cond:
            if not drain:
                for handle in self._pending:
                    handle._deliver(ServeResult(
                        request_id=handle.request.id, tokens=[],
                        prompt_len=0, queue_wait_s=0.0,
                        time_to_first_token_s=0.0, latency_s=0.0,
                        cancelled=True))
                self._pending.clear()
            self._stop.set()
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        self.ledger.emit_summary()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=False)
