"""KV-cache incremental decoding for the transformer LM -- the PyTorch
counterpart of ``dtf_tpu/serve/decode.py``.

  ``Decoder.fresh_cache``   -- the zeroed cache of the layout
  ``Decoder.prefill_chunk`` -- (paged) write one page-aligned chunk of a
                               prompt into the slot's pages; the final
                               chunk's sample is the first generated token
  ``Decoder.prefill``       -- (contiguous) one whole prompt into its slot
  ``Decoder.decode_step``   -- one token for every slot of the batch
  ``Decoder.copy_page``     -- (paged) the copy-on-write primitive
  ``Decoder.read_page``     -- (paged) one pool page of every layer to
                               host arrays: the migration export
  ``Decoder.write_page``    -- (paged) such host arrays into a pool
                               page: the migration import
  ``teacher_forced_logits`` -- the training-style forward, the oracle the
                               decode path is held to token for token

Two layouts, chosen by ``Decoder(kv_page_size=...)``, as in the JAX
decoder:

  paged -- one K and one V [pool_pages, page_size, H, Dh] pool per layer
      and per-slot block tables.  The first chunk of a prompt (start 0)
      attends causally over itself through the flash forward (K1);
      later chunks and decode steps attend over the row's pages (K4 on
      CUDA, the gather on the CPU).
  contiguous (``kv_page_size`` None) -- [num_slots, max_seq_len, H, Dh]
      slabs per layer; prefill pads the prompt to max_seq_len and runs
      one dense masked pass into the slot's slab.

Either way the cache is one list of those per-layer pools a model
shard: a single list without tensor parallelism.

The cache is written in place: where the JAX decoder donated the cache
to each jitted step, PyTorch just updates the buffers, on the calling
thread's current stream -- so a ``copy_page`` is ordered before any
later launch of that thread that reads its target.  PyTorch runs
eagerly: nothing compiles.  What the JAX decoder's first call of each
executable does instead here is the MFU ledger's count
(``obs/ledger.py``): the paged decode step and each prefill chunk
length are counted once, on their first call, under the FLOP counter
(that call's wall time is dropped, as the JAX engine drops a call that
compiled), and every call then carries its own operations -- the
counted ones outside attention, plus attention's from the rows' host
lengths -- and, for the decode step, its bytes.

Sampling: greedy where the temperature is 0; otherwise Gumbel-max
sampling at ``logits / temperature`` with noise drawn on the logits'
device from a ``torch.Generator`` seeded by a hash of (request seed,
position) -- a pure function of the two on one kind of device, the
property that lets a sampled request be replayed token for token, as
the JAX decoder's ``position_key`` gives.  The CPU's and CUDA's
generators give different streams, so a replay stays on its device type.
torch does not reproduce JAX's threefry bits, so sampled tokens differ
between the two packages: their cross-package parity is greedy only.

Page payloads (``read_page``/``write_page``, carried between replicas by
``serve/migrate.py``) are the JAX decoder's: a flat list of
[page_size, H, Dh] leaves in ``jax.tree_util.tree_leaves`` order of the
JAX cache, whose dict keys sort as STRINGS -- block0, block1, block10,
block11, block2, ... -- with K before V in each layer
(:func:`wire_leaf_order`).  A bfloat16 leaf is its raw 16-bit words
(:class:`BF16Words`): numpy has no bfloat16 without ml_dtypes, which
this package does not need.  Both copies are exact: no cast, no change
of layout.

Tensor parallelism (``serve_tp``; the JAX decoder's ``mesh``): the
model is a :class:`~dtf_tpu_torch.models.transformer.TensorParallelLM`
and each shard's pools hold H/mp heads on its shard's device, so every
shard runs its own K1/K4 launches.  Paged cache only, as in the JAX decoder.  A page's payload
joins the shards' heads in order (and :meth:`Decoder.write_page`
splits them), so a page reads the same at every ``serve_tp`` and
migrates between replicas of different ``serve_tp``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from dtf_tpu_torch.obs import ledger as ledger_mod
from dtf_tpu_torch.ops.flash_attention import attention_pairs
from dtf_tpu_torch.ops.paged_attention import live_pairs

_MASK64 = (1 << 64) - 1

# the migration wire's dtype tag of each pool dtype (numpy's names, and
# the JAX wire's "bfloat16")
WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16"}


class BF16Words(np.ndarray):
    """bfloat16 values held as their raw 16-bit words (uint16 storage).
    The migration wire tags such a leaf ``"bfloat16"`` with exactly the
    bytes the JAX wire sends for an ml_dtypes bfloat16 leaf; make one
    with ``words.view(BF16Words)``."""

    wire_dtype = "bfloat16"


def wire_dtype(leaf) -> str:
    """The wire's dtype tag of a host leaf: ``"bfloat16"`` for
    :class:`BF16Words` (or an ml_dtypes bfloat16 array), else numpy's
    name of its dtype."""
    return getattr(leaf, "wire_dtype", None) or str(np.asarray(leaf).dtype)


def wire_leaf_order(num_layers: int) -> List[Tuple[int, str]]:
    """(layer, pool name) of each leaf of a page payload, in the JAX
    wire's order: ``jax.tree_util.tree_leaves`` of the cache
    ``{"block{i}": {"attn": {"paged_key", "paged_value"}}}`` sorts the
    keys as strings, so at 12 layers the order is block0, block1,
    block10, block11, block2, ..., block9, K before V in each."""
    layers = sorted(range(int(num_layers)), key=lambda i: f"block{i}")
    return [(i, name) for i in layers
            for name in ("paged_key", "paged_value")]


def position_seed(seed: int, position: int) -> int:
    """64-bit generator seed for one (request seed, position): a
    splitmix64 finalizer over the pair, so neighbouring positions get
    unrelated streams."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(position)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def sample_tokens(logits, temperature, seeds, positions):
    """logits [B, V] -> token ids [B] (int64, on logits' device).

    Row b is the argmax where temperature[b] == 0, else a categorical
    sample at logits[b] / temperature[b] whose noise depends only on
    (seeds[b], positions[b]).  temperature/seeds/positions are host
    sequences of length B."""
    toks = logits.argmax(dim=-1)
    vocab = logits.shape[-1]
    for b, t in enumerate(temperature):
        if t <= 0:
            continue
        # the noise is drawn on the logits' device: no per-token host
        # work and no host-to-device copy of a vocab-sized vector
        gen = torch.Generator(device=logits.device).manual_seed(
            position_seed(seeds[b], positions[b]))
        u = torch.rand(vocab, generator=gen, dtype=torch.float64,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        toks[b] = torch.argmax(logits[b].double() / float(t) + gumbel)
    return toks


class Decoder:
    """Prefill/decode over one TransformerLM and its weights.

    ``kv_page_size`` selects the paged cache (None = contiguous);
    ``kv_pool_pages`` TOTAL pool pages including the scratch page 0
    (None = the full reservation, 1 + num_slots * pages-per-slot).  The
    cache lives on the model's device, in its compute dtype.
    ``ledger`` (obs/ledger.Ledger, paged only, as in the JAX decoder)
    registers ``serve_decode_step`` and ``serve_prefill_chunk_c{len}``.
    A :class:`TensorParallelLM` ``model`` decodes over ``tp`` shards.
    A model trained under sequence parallelism decodes whole: its seq
    group is dropped (ring attention does not compose with the KV
    cache), as ``make_decode_model`` strips the JAX ``seq_axis``."""

    def __init__(self, model, *, num_slots: int, max_seq_len: int,
                 kv_page_size: Optional[int] = None,
                 kv_pool_pages: Optional[int] = None, ledger=None):
        if getattr(model, "seq_group", None) is not None:
            model.set_seq_group(None)
        self.model = model
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len)
        if model.max_seq_len < self.max_seq_len:
            raise ValueError(
                f"max_seq_len {max_seq_len} exceeds the model's position "
                f"table ({model.max_seq_len})")
        self.paged = kv_page_size is not None
        # the model shards (one without tensor parallelism)
        self.shards = list(getattr(model, "shards", [model]))
        self.tp = len(self.shards)
        if self.tp > 1 and not self.paged:
            raise ValueError(
                "tensor-parallel decode needs the paged KV cache "
                "(kv_page_size > 0) -- the page pool is the layout that "
                "shards")
        if self.paged:
            self.page_size = int(kv_page_size)
            if self.page_size < 1:
                raise ValueError(f"kv_page_size must be >= 1, got "
                                 f"{kv_page_size}")
            self.pages_per_slot = -(-self.max_seq_len // self.page_size)
            self.pool_pages = int(
                kv_pool_pages or 1 + self.num_slots * self.pages_per_slot)
            if self.pool_pages < 2:
                raise ValueError(
                    f"kv_pool_pages must be >= 2 (page 0 is the scratch "
                    f"page), got {self.pool_pages}")
        self.device = model.pos_embed.device
        self.ledger = ledger if self.paged else None
        # executables counted so far: key -> FLOPs outside attention
        self._execs = {}
        # (flops, bytes or None) of the last prefill_chunk / decode_step
        self.last_cost = None
        self._weights = None            # parameters a decode step reads

    @property
    def compiled_count(self) -> int:
        """Executables counted so far: a call that raised it ran under
        the FLOP counter, so the engine keeps its wall time out of the
        ledger (the JAX engine drops a call that compiled)."""
        return len(self._execs)

    def fresh_cache(self) -> List[List[dict]]:
        """One list of per-layer pools a model shard, on the shard's
        device (one shard without tensor parallelism; under it each
        shard's pools hold H/mp heads)."""
        m = self.model
        h = m.num_heads
        dh = m.d_model // h
        if self.paged:
            shape = (self.pool_pages, self.page_size, h // self.tp, dh)
            names = ("paged_key", "paged_value")
        else:
            shape = (self.num_slots, self.max_seq_len, h, dh)
            names = ("cached_key", "cached_value")
        return [[{name: torch.zeros(shape, dtype=m.dtype,
                                    device=shard.pos_embed.device)
                  for name in names} for _ in range(m.num_layers)]
                for shard in self.shards]

    def _model_cache(self, cache):
        """The cache as the model takes it: a TensorParallelLM every
        shard's layer list, a TransformerLM its one."""
        return cache if self.tp > 1 else cache[0]

    @torch.no_grad()
    def copy_page(self, cache, src: int, dst: int):
        """Copy pool page ``src`` onto ``dst`` in every layer's K and V
        pool -- one [page_size, H, Dh] row each: the engine's
        copy-on-write primitive.  Queued on this thread's current
        stream, so it completes before any later kernel of the thread
        reads ``dst``."""
        if not self.paged:
            raise RuntimeError("copy_page needs the paged cache")
        for shard in cache:
            for layer in shard:
                for pool in layer.values():
                    pool[int(dst)].copy_(pool[int(src)])
        return cache

    @torch.no_grad()
    def read_page(self, cache, page: int) -> List[np.ndarray]:
        """Host copy of pool page ``page`` from every layer's K and V
        pool -- the migration EXPORT primitive: a flat list of
        [page_size, H, Dh] leaves in :func:`wire_leaf_order`, float32
        (or float16) arrays or :class:`BF16Words`.  The bytes are what
        the device holds: one device-to-host copy on this thread's
        stream, which is synchronized before the bytes leave."""
        if not self.paged:
            raise RuntimeError("page migration needs the paged cache")
        order = wire_leaf_order(len(cache[0]))
        # each leaf's heads from every shard, in shard order
        rows = torch.stack([torch.cat(
            [c[i][name][int(page)].to(self.device) for c in cache], 1)
            for i, name in order])
        if rows.dtype == torch.bfloat16:
            rows = rows.view(torch.int16)
        host = rows.cpu()
        if host.device != rows.device:
            torch.cuda.current_stream(rows.device).synchronize()
        host = host.numpy()
        if host.dtype == np.int16:
            host = host.view(np.uint16).view(BF16Words)
        return list(host)

    @torch.no_grad()
    def write_page(self, cache, page: int, leaves):
        """Write a host page payload (:meth:`read_page`'s list, or the
        JAX decoder's) into pool page ``page`` of every layer -- the
        migration IMPORT primitive.  Each leaf must carry the pool's
        dtype (bfloat16 as :class:`BF16Words` or ml_dtypes) and the
        page's shape: nothing is cast.  One synchronous host-to-device
        copy queued on this thread's stream, so the page is written
        before any later kernel of the thread reads it, and the host
        buffer is not needed once this returns."""
        if not self.paged:
            raise RuntimeError("page migration needs the paged cache")
        order = wire_leaf_order(len(cache[0]))
        if len(leaves) != len(order):
            raise ValueError(f"page payload has {len(leaves)} leaves, the "
                             f"cache {len(order)}")
        pool0 = cache[0][0]["paged_key"]
        want = WIRE_DTYPES.get(pool0.dtype)
        local = tuple(pool0.shape[1:])
        shape = (local[0], local[1] * len(cache), local[2])
        for leaf in leaves:
            if wire_dtype(leaf) != want or tuple(np.shape(leaf)) != shape:
                raise ValueError(
                    f"page leaf {wire_dtype(leaf)} {tuple(np.shape(leaf))} "
                    f"does not match the pool's {want} {shape}: pages "
                    f"migrate between engines of one dtype and width")
        host = np.stack([np.asarray(a) for a in leaves])
        if want == "bfloat16":
            rows = torch.from_numpy(host.view(np.int16)).to(
                pool0.device).view(torch.bfloat16)
        else:
            rows = torch.from_numpy(host).to(pool0.device)
        for row, (i, name) in zip(rows, order):
            # [page_size, H, Dh]: shard k's heads to shard k's pool
            for c, part in zip(cache, row.chunk(len(cache), 1)):
                c[i][name][int(page)].copy_(part)
        return cache

    def _int32(self, x):
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    # -- the MFU ledger's counts ---------------------------------------
    def _attention_ops(self, pairs: int) -> int:
        """Operations of the attention kernels over ``pairs`` (query,
        key) pairs a head, every layer: 4 D a pair (QK and PV)."""
        m = self.model
        return 4 * m.d_model * pairs * m.num_layers

    def _decode_bytes(self, index) -> float:
        """A decode step's honest bytes: the weights read once (the
        embedding and position tables only at the batch's rows), each
        row's live KV read and its new K/V row written, every layer."""
        m = self.model
        elem = torch.finfo(m.dtype).bits // 8
        if self._weights is None:
            # the first shard alone embeds and computes the logits
            head = ("ln_f.", "lm_head.")
            self._weights = sum(
                p.numel() for k, s in enumerate(self.shards)
                for n, p in s.named_parameters()
                if n not in ("embed.weight", "pos_embed")
                and not (k and n.startswith(head)))
        weights = self._weights
        b = len(index)
        kv_row = 2 * m.num_layers * m.d_model * elem
        live = sum(int(i) + 1 for i in index)
        return (weights * elem + 2 * b * m.d_model * elem
                + kv_row * (live + b))

    def _run(self, name: str, key, attn_pairs: int, nbytes, fn):
        """Run one model call; the first call of ``key`` under the FLOP
        counter, registering ``name`` with the ledger.  Sets
        ``last_cost`` to this call's (operations, bytes)."""
        static = self._execs.get(key)
        if static is None:
            out, count = ledger_mod.count_flops(fn)
            static = self._execs[key] = count.aten
            if self.ledger is not None:
                self.ledger.register(
                    name, flops=static + self._attention_ops(attn_pairs),
                    bytes_accessed=nbytes)
        else:
            out = fn()
        self.last_cost = (static + self._attention_ops(attn_pairs), nbytes)
        return out

    # -- paged ---------------------------------------------------------
    @torch.no_grad()
    def prefill_chunk(self, cache, chunk, block_row, start: int,
                      sample_pos: int, temperature: float, seed: int = 0):
        """One page-aligned prefill chunk for one slot (paged).

        chunk: 1-D int tokens, len % page_size == 0 (engine-padded);
        block_row: [M] int32 page ids; start: the chunk's first logical
        position; sample_pos: offset in the chunk of the last real
        prompt token.  Returns (token as a 0-d device tensor, cache,
        logits [V] at sample_pos).  The sample is keyed to the global
        position start + sample_pos, so every chunking of a prompt
        samples alike."""
        if not self.paged:
            raise RuntimeError("contiguous Decoder: use prefill")
        chunk = np.asarray(chunk, np.int32).reshape(1, -1)
        clen = chunk.shape[1]
        if clen % self.page_size or start % self.page_size:
            raise ValueError(
                f"prefill chunk (len {clen}, start {start}) must "
                f"be page-aligned (kv_page_size {self.page_size}) -- "
                f"whole-page writes depend on it")
        block_row = np.asarray(block_row, np.int32).reshape(1, -1)
        # the gather path trims its window to the pages the chunk can
        # see; the CUDA kernel stops at the live length by itself
        window = (None if self.device.type == "cuda"
                  else (int(start) + clen) // self.page_size)
        first = int(start) == 0
        pairs = (attention_pairs(clen, clen, True) if first
                 else live_pairs([start], clen,
                                 block_row.shape[1] * self.page_size))

        def call():
            return self.model(
                self._int32(chunk), cache_index=self._int32([start]),
                block_table=self._int32(block_row),
                cache=self._model_cache(cache), flash_prefill=first, window_pages=window)

        # one count per chunk length: the FLOPs outside attention do not
        # depend on where the chunk starts
        logits = self._run(f"serve_prefill_chunk_c{clen}", ("chunk", clen),
                           pairs, None, call)
        last = logits[0, sample_pos]
        tok = sample_tokens(last[None], [temperature], [seed],
                            [int(start) + int(sample_pos)])[0]
        return tok, cache, last

    # -- contiguous ----------------------------------------------------
    @torch.no_grad()
    def prefill(self, cache, prompt, slot: int, temperature: float,
                seed: int = 0):
        """prompt: 1-D int (unpadded) into slot ``slot`` (contiguous).
        The prompt is padded to max_seq_len and written in one dense
        masked pass.  Returns (token as a 0-d device tensor, cache,
        logits [V] at the last prompt position); the sample is keyed to
        that position."""
        if self.paged:
            raise RuntimeError("paged Decoder: use prefill_chunk")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        length = int(prompt.shape[0])
        if length > self.max_seq_len:
            raise ValueError(f"prompt length {length} exceeds max_seq_len "
                             f"{self.max_seq_len}")
        padded = np.zeros((1, self.max_seq_len), np.int32)
        padded[0, :length] = prompt
        row = [{name: slab[slot:slot + 1] for name, slab in layer.items()}
               for layer in cache[0]]
        logits = self.model(self._int32(padded),
                            cache_index=self._int32([0]), cache=row)
        last = logits[0, length - 1]
        tok = sample_tokens(last[None], [temperature], [seed],
                            [length - 1])[0]
        return tok, cache, last

    @torch.no_grad()
    def decode_step(self, cache, tokens, index, temperature,
                    block_tables=None, seeds=None):
        """tokens [B], index [B] (each row's current length), temperature
        [B], seeds [B] per-request sampling seeds (row b samples with
        (seeds[b], index[b])); paged mode also takes block_tables [B, M]
        (all-zeros rows for slots not decoding).  Returns (tokens [B]
        device tensor, cache, logits [B, V])."""
        index = np.asarray(index, np.int32)
        temperature = np.asarray(temperature, np.float32)
        seeds = (np.zeros(len(index), np.int64) if seeds is None
                 else np.asarray(seeds, np.int64))
        tok_t = self._int32(tokens).reshape(-1, 1)
        idx_t = self._int32(index)
        if self.paged:
            if block_tables is None:
                raise ValueError("paged decode_step needs block_tables")
            tables = self._int32(block_tables)
            cap = tables.shape[1] * self.page_size
            logits = self._run(
                "serve_decode_step", ("decode",),
                live_pairs(index.tolist(), 1, cap),
                self._decode_bytes(index.tolist()),
                lambda: self.model(tok_t, cache_index=idx_t,
                                   block_table=tables,
                                   cache=self._model_cache(cache)))
        else:
            logits = self.model(tok_t, cache_index=idx_t,
                                cache=self._model_cache(cache))
        last = logits[:, -1]
        toks = sample_tokens(last, temperature.tolist(), seeds.tolist(),
                             index.tolist())
        return toks, cache, last


@torch.no_grad()
def teacher_forced_logits(model, tokens):
    """The training-style full forward -- the decode path's oracle."""
    tokens = torch.as_tensor(np.asarray(tokens, np.int64),
                             device=model.pos_embed.device)
    return model(tokens)
