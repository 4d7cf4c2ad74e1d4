"""Dynamic batching engine: request queue -> slot-based continuous
batching over the paged KV-cache decoder.  The PyTorch counterpart of
``dtf_tpu/serve/engine.py``; the host-side logic is the same:

  admission control -- ``submit`` rejects a request whose prompt +
      budget cannot fit (ValueError), instead of truncating it.
  backpressure      -- the queue is bounded; a full queue sheds with
      :class:`Backpressure` carrying ``retry_after``, and logs it.
  max-batch / max-delay -- a fresh batch waits up to ``max_delay_s``
      after the first arrival to fill; once decoding, new arrivals join
      at any step boundary.
  paged admission   -- KV memory is a shared page pool
      (:class:`PagePool`); a request is admitted when its worst-case
      page count, ceil((prompt + budget) / page_size), is free.  When
      the head of the queue cannot get pages it WAITS (FIFO: small
      requests do not slip past a starved big one).
  chunked prefill   -- prompts prefill in page-aligned chunks, ONE chunk
      per engine iteration (round-robin over prefilling slots), with a
      decode step for running slots between chunks.
  continuous batching -- every decode step runs all ``max_batch`` rows;
      rows not decoding carry an all-zeros block-table row, so their
      garbage lands on the scratch page and is ignored.

Tokens stream: ``handle.stream()`` yields each token as its step
retires; ``result()`` returns them all.

One engine thread (a daemon) owns ALL device work; ``submit`` only
enqueues.  The thread's CUDA stream is its own current stream: the
kernels' wrappers take the stream in the calling thread.

Not ported yet: prefix sharing with copy-on-write pages and eviction
(``prefix_sharing=True`` raises), KV-page migration, cancellation,
SIGTERM drain, heartbeats, chaos probes, tracing and the MFU ledger,
the contiguous cache and tensor-parallel decode.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue as queue_mod
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from dtf_tpu_torch.obs.registry import MetricsRegistry
from dtf_tpu_torch.serve.decode import Decoder

log = logging.getLogger("dtf_tpu_torch")


class Backpressure(RuntimeError):
    """Request shed: the queue is full.  ``retry_after`` (seconds) is
    the engine's estimate of when capacity frees up."""

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


class _Handle:
    """Future-lite returned by submit(), plus a token stream."""

    def __init__(self, req: ServeRequest,
                 on_token: Optional[Callable] = None):
        self.request = req
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None
        self._on_token = on_token
        self._q: "queue_mod.Queue" = queue_mod.Queue()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not finished in {timeout}s")
        return self._result

    def stream(self, timeout: Optional[float] = None):
        """Iterator over generated tokens, yielding as each retires;
        ``timeout`` bounds the wait for EACH token."""
        while True:
            try:
                kind, tok = self._q.get(timeout=timeout)
            except queue_mod.Empty:
                raise TimeoutError(
                    f"request {self.request.id}: no token in {timeout}s"
                ) from None
            if kind == "done":
                return
            yield tok

    def _emit(self, token: int):
        """Engine thread: one token retired."""
        self._q.put(("token", int(token)))
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
    """Host-side free-list allocator over the shared KV page pool.

    Page 0 is the SCRATCH page, never handed to a request: rows of the
    fixed-shape decode batch that are not decoding carry all-zeros
    block-table rows, so their garbage lands there.  ``high_water`` is
    the peak of pages in use."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"page pool needs >= 2 pages (page 0 is "
                             f"scratch), got {num_pages}")
        self.num_pages = int(num_pages)
        # LIFO free stack: a retired request's pages go to the next admit
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._used = set()
        self.high_water = 0

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None when the pool cannot cover them (the caller
        waits for a retire -- never a partial grant)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        self.high_water = max(self.high_water, self.used_pages)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._used:
                raise ValueError(f"double free of page {p}")
            self._used.remove(p)
            self._free.append(p)


@dataclasses.dataclass
class _Slot:
    handle: _Handle
    tokens: List[int]                   # generated so far
    last_token: int                     # next decode step's input
    index: int                          # current sequence length
    phase: str                          # "prefill" until the prompt is in
    pages: List[int]                    # pool pages owned by this slot
    block_row: np.ndarray               # [M] int32 page ids
    prompt_padded: np.ndarray           # page-aligned prompt
    chunk_plan: List                    # [(start, len), ...]
    chunk_i: int = 0                    # next chunk to run


class ServeEngine:
    """Dynamic batcher over a :class:`~dtf_tpu_torch.serve.decode.Decoder`.

    ``model`` is a TransformerLM with its weights loaded, on the device
    to serve from.  ``max_seq_len`` bounds prompt + generation per
    request.  ``kv_page_size`` tokens per page; ``kv_pool_pages`` total
    pool pages incl. the scratch page (None = the full reservation);
    ``prefill_chunk`` the chunk in tokens (a page multiple; 0 = whole
    prompts as one chunk; None = 4 pages).

    LOCK DISCIPLINE: ``_cond`` guards ``_pending`` and ``_ewma_latency``,
    shared between client threads and the engine thread.  ``_slots``,
    the pool and the cache are engine-thread state."""

    def __init__(self, model, *, max_batch: int = 8,
                 max_seq_len: Optional[int] = None,
                 max_delay_s: float = 0.005, queue_size: int = 64,
                 seed: int = 0, kv_page_size: int = 16,
                 kv_pool_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_sharing: bool = False):
        if prefix_sharing:
            raise NotImplementedError(
                "prefix sharing (refcounted pages, copy-on-write) is not "
                "ported yet")
        if not kv_page_size:
            raise NotImplementedError(
                "the contiguous KV cache is not ported; kv_page_size must "
                "be >= 1")
        if max_batch < 1 or queue_size < 1:
            raise ValueError("max_batch and queue_size must be >= 1")
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len or model.max_seq_len)
        self.max_delay_s = float(max_delay_s)
        self.queue_size = int(queue_size)
        self.page_size = int(kv_page_size)
        self.prefill_chunk = (4 * self.page_size if prefill_chunk is None
                              else int(prefill_chunk))
        if self.prefill_chunk % self.page_size:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must be a multiple "
                f"of kv_page_size ({self.page_size})")
        self.decoder = Decoder(model, num_slots=self.max_batch,
                               max_seq_len=self.max_seq_len,
                               kv_page_size=self.page_size,
                               kv_pool_pages=kv_pool_pages or None)
        self.pool = PagePool(self.decoder.pool_pages)
        self._cache = self.decoder.fresh_cache()
        self._seed = int(seed)

        self._cond = threading.Condition()
        self._pending: List[_Handle] = []
        self._slots: List[Optional[_Slot]] = [None] * self.max_batch
        self._stop = threading.Event()
        self._ids = itertools.count()
        self.completed: List[ServeResult] = []
        self.metrics = MetricsRegistry()
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
        self._m_pages_used = m.gauge("serve_kv_pages_used", unit="pages")
        self._m_prefill_chunks = m.counter("serve_prefill_chunks_total",
                                           unit="chunks")
        # wall time between consecutive decode steps while slots decode:
        # the head-of-line gap chunked prefill bounds
        self._m_decode_gap = m.histogram("serve_decode_gap_s", unit="s")
        # one decode step, host clock around work ending in the token
        # copy to the host (a device sync)
        self._m_step_time = m.histogram("serve_decode_step_s", unit="s")
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

    # -- client side ---------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               rng_seed: Optional[int] = None) -> _Handle:
        """Enqueue a request.  ``on_token`` is called FROM THE ENGINE
        THREAD per retired token; ``handle.stream()`` is the pull-based
        alternative.  ``rng_seed`` pins the request's sampling identity
        (None = derived from the engine seed and the request id)."""
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
        need = -(-total // self.page_size)
        if need > self.pool.usable_pages:
            raise ValueError(
                f"oversized request for the page pool: needs {need} pages "
                f"of {self.page_size} tokens but the pool has "
                f"{self.pool.usable_pages} usable -- it could never be "
                f"admitted")
        req = ServeRequest(prompt=prompt, max_new_tokens=int(max_new_tokens),
                           temperature=float(temperature), eos_id=eos_id,
                           rng_seed=None if rng_seed is None
                           else int(rng_seed))
        handle = _Handle(req, on_token=on_token)
        with self._cond:
            if self._stop.is_set():
                raise RuntimeError("engine is stopped")
            if len(self._pending) >= self.queue_size:
                self._m_shed.inc()
                retry = max(0.05, self._ewma_latency
                            * (1 + len(self._pending) / self.max_batch))
                log.error("serve: queue full (%d pending, %d slots) -- "
                          "shedding request (%d total shed); "
                          "retry_after=%.2fs", len(self._pending),
                          self.max_batch, self.shed_count, retry)
                raise Backpressure(retry)
            req.id = next(self._ids)
            req.submit_time = time.time()
            if req.rng_seed is None:
                req.rng_seed = (self._seed * 1_000_003 + req.id
                                + 12_345) & 0x7FFFFFFF
            self._pending.append(handle)
            self._m_queue_depth.set(len(self._pending))
            self._cond.notify_all()
        return handle

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
            with self._cond:
                active = any(s is not None for s in self._slots)
                if not self._pending and not active:
                    if self._stop.is_set():
                        return
                    # idle: the next step's gap would measure an empty
                    # queue, not head-of-line blocking
                    self._last_step_t = None
                    self._cond.wait(timeout=0.1)
                    continue
                if not active and self.max_delay_s > 0:
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
                        req = self._pending[0].request
                        pages = self.pool.alloc(self._pages_needed(req))
                        if pages is None:
                            # head-of-line FIFO wait for a retire
                            break
                        admitted.append((i, self._pending.pop(0), pages))
                self._m_queue_depth.set(len(self._pending))
            for i, handle, pages in admitted:
                self._admit(i, handle, pages)
            self._m_admitted.inc(len(admitted))
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
            self.max_concurrent = max(self.max_concurrent, active)
            self._m_occupancy.set(active / self.max_batch)
            self._m_pages_used.set(self.pool.used_pages)
            if any(s is not None and s.phase == "decode"
                   for s in self._slots):
                self._step()
            else:
                self._last_step_t = None

    def _pages_needed(self, req: ServeRequest) -> int:
        """Worst-case pages: prompt + full budget, reserved up front so
        a decode step can never run out of pages mid-generation."""
        total = int(req.prompt.size) + int(req.max_new_tokens)
        return -(-total // self.page_size)

    def _chunk_plan(self, plen: int, start: int = 0):
        """[(start, len), ...] page-aligned chunks covering [start, plen):
        full ``prefill_chunk`` chunks, then one final chunk padded to the
        page size (so it holds the last real prompt token, the sampled
        position).  prefill_chunk == 0: one chunk for the remainder."""
        chunk = self.prefill_chunk or -(-(plen - start) //
                                        self.page_size) * self.page_size
        plan = []
        while plen - start > chunk:
            plan.append((start, chunk))
            start += chunk
        rem = plen - start
        plan.append((start, -(-rem // self.page_size) * self.page_size))
        return plan

    def _admit(self, slot_idx: int, handle: _Handle, pages: List[int]):
        req = handle.request
        req.admit_time = time.time()
        plen = int(req.prompt.size)
        block_row = np.zeros((self.decoder.pages_per_slot,), np.int32)
        block_row[:len(pages)] = pages
        plan = self._chunk_plan(plen)
        prompt_padded = np.zeros((plan[-1][0] + plan[-1][1],), np.int32)
        prompt_padded[:plen] = req.prompt
        self._slots[slot_idx] = _Slot(
            handle=handle, tokens=[], last_token=0, index=0, phase="prefill",
            pages=pages, block_row=block_row, prompt_padded=prompt_padded,
            chunk_plan=plan)

    def _advance_prefill(self, slot_idx: int):
        slot = self._slots[slot_idx]
        req = slot.handle.request
        start, clen = slot.chunk_plan[slot.chunk_i]
        is_last = slot.chunk_i == len(slot.chunk_plan) - 1
        plen = int(req.prompt.size)
        sample_pos = plen - 1 - start if is_last else 0
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
        req.first_token_time = time.time()
        slot.tokens = [first]
        slot.last_token = first
        slot.index = plen
        slot.phase = "decode"
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
        tables = np.zeros((self.max_batch, self.decoder.pages_per_slot),
                          np.int32)
        for i, s in enumerate(self._slots):
            if s is not None and s.phase == "decode":
                tokens[i] = s.last_token
                index[i] = s.index
                temps[i] = s.handle.request.temperature
                seeds[i] = s.handle.request.rng_seed
                tables[i] = s.block_row
        out, self._cache, _ = self.decoder.decode_step(
            self._cache, tokens, index, temps, tables, seeds=seeds)
        # the EOS/budget check needs the tokens on the host: this copy
        # is the step's device sync
        out = out.cpu().numpy()
        self._m_step_time.observe(time.perf_counter() - now)
        for i, s in enumerate(self._slots):
            if s is None or s.phase != "decode":
                continue
            tok = int(out[i])
            s.tokens.append(tok)
            s.last_token = tok
            s.index += 1
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

    def _retire(self, slot_idx: int):
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        self.pool.free(slot.pages)
        req = slot.handle.request
        req.finish_time = time.time()
        result = ServeResult(
            request_id=req.id, tokens=list(slot.tokens),
            prompt_len=int(req.prompt.size),
            queue_wait_s=req.admit_time - req.submit_time,
            time_to_first_token_s=req.first_token_time - req.submit_time,
            latency_s=req.finish_time - req.submit_time,
            submit_time=req.submit_time, finish_time=req.finish_time)
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
    def stop(self, drain: bool = True, timeout: float = 60.0):
        """Stop the engine.  ``drain=True`` finishes in-flight AND queued
        work first; False cancels queued requests."""
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
