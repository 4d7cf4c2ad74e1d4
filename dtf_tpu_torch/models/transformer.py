"""Decoder-only transformer LM -- the PyTorch counterpart of
``dtf_tpu/models/transformer.py``.

Two forwards over one set of weights:

  training-style -- ``model(tokens)``: teacher-forced logits for every
      position, causal attention through ``ops.flash_attention``.  The
      oracle the decode path is held to.
  paged decode   -- ``model(tokens, cache_index=..., block_table=...,
      cache=...)``: every attention writes its chunk's K/V into its
      layer's page pools first and then attends (write-then-attend).  A
      chunk starting at position 0 (``flash_prefill``) attends causally
      over itself through the flash forward, with no gather; later
      chunks and decode steps attend over the row's pages through
      ``ops.paged_attention.paged_attention_auto`` -- the paged flash
      decode kernel on CUDA.

The cache is a list with one ``{"paged_key", "paged_value"}`` dict of
[pool_pages, page_size, H, Dh] pools per layer, owned by the caller
(``serve.decode.Decoder``) and updated in place.

Parameter names follow the flax module tree (``embed``, ``pos_embed``,
``block{i}.ln1/attn.qkv/attn.out/ln2/fc1/fc2``, ``ln_f``, ``lm_head``),
so ``convert.py`` maps one onto the other leaf by leaf.  The details a
direct translation would get wrong are pinned here and in the tests:
GELU is the tanh approximation (jax's ``nn.gelu`` default), LayerNorm
epsilon is 1e-6 (flax's default, not torch's 1e-5), and ``out`` and
``fc2`` have no bias.  Logits are float32.

Ring attention (``seq_axis``), tensor parallelism (``model_axis``) and
the contiguous per-slot cache are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dtf_tpu_torch.ops.flash_attention import flash_attention
from dtf_tpu_torch.ops.paged_attention import (paged_attention_auto,
                                               write_pages)

LN_EPS = 1e-6   # flax nn.LayerNorm default


class CausalSelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        # flax DenseGeneral((3, H, Dh)): output features ordered (3, H, Dh)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out = nn.Linear(d_model, d_model, bias=False)

    def forward(self, x, cache_index=None, block_table=None,
                flash_prefill: bool = False,
                window_pages: Optional[int] = None, layer_cache=None):
        b, s, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, s, 3, h, d // h)
        # contiguous [B, S, H, Dh] each: the kernels' layout
        q, k, v = (t.contiguous() for t in qkv.unbind(2))
        if layer_cache is None:
            o = flash_attention(q, k, v, causal=True)
        else:
            if cache_index is None or block_table is None:
                raise ValueError("paged decode needs cache_index [B] and "
                                 "block_table [B, M], both int32")
            pool_k = layer_cache["paged_key"]
            pool_v = layer_cache["paged_value"]
            # write-then-attend.  Prefill chunks (S a page multiple,
            # page-aligned starts by engine construction) write whole
            # pages; decode steps (S = 1) write token rows
            aligned = s > 1 and s % pool_k.shape[1] == 0
            write_pages(pool_k, k, block_table, cache_index, aligned)
            write_pages(pool_v, v, block_table, cache_index, aligned)
            if flash_prefill:
                # first chunk (cache_index == 0): the chunk is the whole
                # history, so plain causal self-attention, no gather
                o = flash_attention(q, k, v, causal=True)
            else:
                o = paged_attention_auto(q, pool_k, pool_v, block_table,
                                         cache_index,
                                         window_pages=window_pages)
        return self.out(o.reshape(b, s, d))


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(d_model, num_heads)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x, cache_index=None, block_table=None,
                flash_prefill: bool = False,
                window_pages: Optional[int] = None, layer_cache=None):
        x = x + self.attn(self.ln1(x), cache_index, block_table,
                          flash_prefill, window_pages, layer_cache)
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class TransformerLM(nn.Module):
    """Next-token LM: tokens [B, S] int -> logits [B, S, vocab] float32.

    Weights live in ``dtype`` (float32 or bfloat16), which is also the
    compute dtype -- flax keeps float32 params and casts them at use,
    which rounds them the same way."""

    def __init__(self, vocab_size: int, num_layers: int = 12,
                 d_model: int = 512, num_heads: int = 8, d_ff: int = 2048,
                 max_seq_len: int = 2048, dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.d_ff = d_ff
        self.max_seq_len = max_seq_len
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.zeros(max_seq_len, d_model))
        for i in range(num_layers):
            self.add_module(f"block{i}", Block(d_model, num_heads, d_ff))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.lm_head = nn.Linear(d_model, vocab_size)
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.pos_embed.dtype

    @property
    def blocks(self) -> List[Block]:
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def forward(self, tokens, cache_index=None, block_table=None,
                cache=None, flash_prefill: bool = False,
                window_pages: Optional[int] = None):
        b, s = tokens.shape
        x = self.embed(tokens)
        if cache is None:
            if s > self.max_seq_len:
                raise ValueError(f"sequence {s} exceeds max_seq_len "
                                 f"{self.max_seq_len}")
            x = x + self.pos_embed[:s]
        else:
            if cache_index is None:
                raise ValueError("decode needs cache_index [B] int32")
            if len(cache) != self.num_layers:
                raise ValueError(f"cache has {len(cache)} layers, model "
                                 f"{self.num_layers}")
            # per-row positions, clamped so a padded prefill tail cannot
            # index past the table (those rows' logits are unused)
            pos = torch.clamp(
                cache_index.long()[:, None]
                + torch.arange(s, device=tokens.device)[None, :],
                max=self.max_seq_len - 1)
            x = x + self.pos_embed[pos]
        for i, block in enumerate(self.blocks):
            x = block(x, cache_index, block_table, flash_prefill,
                      window_pages, None if cache is None else cache[i])
        return self.lm_head(self.ln_f(x)).float()
