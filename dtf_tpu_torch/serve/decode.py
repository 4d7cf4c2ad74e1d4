"""Paged KV-cache incremental decoding for the transformer LM -- the
PyTorch counterpart of ``dtf_tpu/serve/decode.py`` (paged mode only).

  ``Decoder.fresh_cache``   -- zeroed page pools, one K and one V
                               [pool_pages, page_size, H, Dh] per layer
  ``Decoder.prefill_chunk`` -- write one page-aligned chunk of a prompt
                               into the slot's pages; the final chunk's
                               sample is the first generated token
  ``Decoder.decode_step``   -- one token for every slot of the batch
  ``teacher_forced_logits`` -- the training-style forward, the oracle the
                               decode path is held to token for token

The first chunk of a prompt (start 0) attends causally over itself
through the flash forward; later chunks and decode steps attend over the
row's pages (the paged flash decode on CUDA, the gather on the CPU).
The pools are written in place: where the JAX decoder donated the cache
to each jitted step, PyTorch just updates the buffers.  PyTorch runs
eagerly, so there is nothing to compile per chunk shape.

Sampling: greedy where the temperature is 0; otherwise Gumbel-max
sampling at ``logits / temperature`` with noise drawn on the logits'
device from a ``torch.Generator`` seeded by a hash of (request seed,
position) -- a pure function of the two on one kind of device, the
property that lets a sampled request be replayed token for token, as
the JAX decoder's ``position_key`` gives.  The CPU's and CUDA's
generators give different streams, so a replay stays on its device type.
torch does not reproduce JAX's threefry bits, so sampled tokens differ
between the two packages: their cross-package parity is greedy only.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


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
    """Paged prefill/decode over one TransformerLM and its weights.

    ``kv_page_size`` tokens per page; ``kv_pool_pages`` TOTAL pool pages
    including the scratch page 0 (None = the full reservation,
    1 + num_slots * pages-per-slot).  The pools live on the model's
    device, in its dtype."""

    def __init__(self, model, *, num_slots: int, max_seq_len: int,
                 kv_page_size: int, kv_pool_pages: Optional[int] = None):
        self.model = model
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len)
        if model.max_seq_len < self.max_seq_len:
            raise ValueError(
                f"max_seq_len {max_seq_len} exceeds the model's position "
                f"table ({model.max_seq_len})")
        self.page_size = int(kv_page_size)
        if self.page_size < 1:
            raise ValueError(f"kv_page_size must be >= 1, got "
                             f"{kv_page_size}")
        self.pages_per_slot = -(-self.max_seq_len // self.page_size)
        self.pool_pages = int(
            kv_pool_pages or 1 + self.num_slots * self.pages_per_slot)
        if self.pool_pages < 2:
            raise ValueError(
                f"kv_pool_pages must be >= 2 (page 0 is the scratch page), "
                f"got {self.pool_pages}")
        self.device = model.pos_embed.device

    def fresh_cache(self) -> List[dict]:
        shape = (self.pool_pages, self.page_size, self.model.num_heads,
                 self.model.d_model // self.model.num_heads)
        return [{name: torch.zeros(shape, dtype=self.model.dtype,
                                   device=self.device)
                 for name in ("paged_key", "paged_value")}
                for _ in range(self.model.num_layers)]

    def _int32(self, x):
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    @torch.no_grad()
    def prefill_chunk(self, cache, chunk, block_row, start: int,
                      sample_pos: int, temperature: float, seed: int = 0):
        """One page-aligned prefill chunk for one slot.

        chunk: 1-D int tokens, len % page_size == 0 (engine-padded);
        block_row: [M] int32 page ids; start: the chunk's first logical
        position; sample_pos: offset in the chunk of the last real
        prompt token.  Returns (token as a 0-d device tensor, cache,
        logits [V] at sample_pos).  The sample is keyed to the global
        position start + sample_pos, so every chunking of a prompt
        samples alike."""
        chunk = np.asarray(chunk, np.int32).reshape(1, -1)
        if chunk.shape[1] % self.page_size or start % self.page_size:
            raise ValueError(
                f"prefill chunk (len {chunk.shape[1]}, start {start}) must "
                f"be page-aligned (kv_page_size {self.page_size}) -- "
                f"whole-page writes depend on it")
        # the gather path trims its window to the pages the chunk can
        # see; the CUDA kernel stops at the live length by itself
        window = (None if self.device.type == "cuda"
                  else (int(start) + chunk.shape[1]) // self.page_size)
        logits = self.model(
            self._int32(chunk), cache_index=self._int32([start]),
            block_table=self._int32(block_row).reshape(1, -1), cache=cache,
            flash_prefill=start == 0, window_pages=window)
        last = logits[0, sample_pos]
        tok = sample_tokens(last[None], [temperature], [seed],
                            [int(start) + int(sample_pos)])[0]
        return tok, cache, last

    @torch.no_grad()
    def decode_step(self, cache, tokens, index, temperature, block_tables,
                    seeds=None):
        """tokens [B], index [B] (each row's current length), temperature
        [B], block_tables [B, M] (all-zeros rows for slots not decoding),
        seeds [B] per-request sampling seeds (row b samples with
        (seeds[b], index[b])).  Returns (tokens [B] device tensor, cache,
        logits [B, V])."""
        index = np.asarray(index, np.int32)
        temperature = np.asarray(temperature, np.float32)
        seeds = (np.zeros(len(index), np.int64) if seeds is None
                 else np.asarray(seeds, np.int64))
        logits = self.model(
            self._int32(tokens).reshape(-1, 1),
            cache_index=self._int32(index),
            block_table=self._int32(block_tables), cache=cache)
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
