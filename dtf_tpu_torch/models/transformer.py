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
  contiguous decode -- ``model(tokens, cache_index=..., cache=...)``
      with per-slot slabs: each row's chunk is written at its
      ``cache_index`` and the queries attend over the whole slab under
      the mask key <= query position (``ops.paged_attention.
      cached_attention``, dense; the JAX package runs no Pallas kernel
      on this layout either).

The cache is a list with one dict per layer, owned by the caller
(``serve.decode.Decoder``) and updated in place: ``{"paged_key",
"paged_value"}`` [pool_pages, page_size, H, Dh] pools, or
``{"cached_key", "cached_value"}`` [slots, max_seq_len, H, Dh] slabs.

Parameter names follow the flax module tree (``embed``, ``pos_embed``,
``block{i}.ln1/attn.qkv/attn.out/ln2/fc1/fc2``, ``ln_f``, ``lm_head``),
so ``convert.py`` maps one onto the other leaf by leaf.  The details a
direct translation would get wrong are pinned here and in the tests:
GELU is the tanh approximation (jax's ``nn.gelu`` default), LayerNorm
epsilon is 1e-6 (flax's default, not torch's 1e-5), and ``out`` and
``fc2`` have no bias.  Logits are float32.

Mixed precision is flax's ``dtype`` / ``param_dtype`` split, not
autocast: parameters stay float32 (what the optimizer updates) and are
cast to ``dtype`` where they are used.  Embedding rows, positions, the
residual stream, the attention and MLP run in ``dtype``; LayerNorm
takes its statistics and affine transform in float32 and returns
``dtype``, as flax's LayerNorm does; the logits are cast to float32.
Outside autograd (serving) each weight's ``dtype`` copy is kept and
reused until the weight changes (:func:`cast`).

``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, the counterpart of ``nn.remat(Block)``),
so the flash forward runs twice per block and step.
``remat_policy="dots"`` (:func:`remat_context`) is the JAX package's
selective policy: every matmul output is saved and the elementwise ops
(LayerNorm, GELU, bias adds, residual sums) are recomputed.  A
selective checkpoint policy sees aten ops only, and the flash forward
is a ctypes launch inside an autograd Function, so a policy could not
save its ``o`` and ``lse``: the block is checkpointed in two regions
around the attention instead (LayerNorm and the qkv projection; the
output projection and the MLP), and ``_FlashAttention``, outside both,
saves q, k, v, o and lse itself -- K1 runs once a block and step, as
under the JAX policy's ``flash_out``/``flash_lse`` names.

Ring attention (``seq_axis``) and tensor parallelism (``model_axis``)
are not ported yet.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from dtf_tpu_torch.ops.flash_attention import flash_attention
from dtf_tpu_torch.ops.paged_attention import (cached_attention,
                                               paged_attention_auto,
                                               write_pages)

LN_EPS = 1e-6   # flax nn.LayerNorm default

# the ops whose outputs "dots" saves: F.linear reaches the dispatcher as
# one of these on the CPU and on CUDA (jax's checkpoint_dots saves
# every dot_general)
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context(name: str):
    """The ``context_fn`` of a named selective policy for
    ``torch.utils.checkpoint`` (the JAX package's ``remat_policy``)."""
    if name == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    raise ValueError(f"unknown remat_policy {name!r}; choose 'dots'")


def cast(p: torch.Tensor, dtype) -> torch.Tensor:
    """Parameter ``p`` in the compute dtype.  Under autograd a fresh
    cast (its gradient flows to the float32 parameter); outside it -- a
    serving step -- a copy kept on the parameter and reused until the
    parameter changes in place (its version counter or storage), so a
    decode step does not cast every weight again."""
    if p.dtype == dtype:
        return p
    if torch.is_grad_enabled():
        return p.to(dtype)
    key = (p._version, p.data_ptr(), dtype)
    kept = getattr(p, "_compute_copy", None)
    if kept is None or kept[0] != key:
        kept = (key, p.detach().to(dtype))
        p._compute_copy = kept
    return kept[1]


def dense(layer: nn.Linear, x, dtype):
    """flax ``Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    bias = None if layer.bias is None else cast(layer.bias, dtype)
    return F.linear(x.to(dtype), cast(layer.weight, dtype), bias)


def layer_norm(ln: nn.LayerNorm, x, dtype):
    """flax ``LayerNorm(dtype=...)``: statistics, scale and bias in
    float32, the result in ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int,
                 dtype=torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.compute_dtype = dtype
        # flax DenseGeneral((3, H, Dh)): output features ordered (3, H, Dh)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out = nn.Linear(d_model, d_model, bias=False)

    def project(self, x):
        """q, k, v: contiguous [B, S, H, Dh] each, the kernels' layout."""
        b, s, d = x.shape
        h = self.num_heads
        qkv = dense(self.qkv, x, self.compute_dtype).view(b, s, 3, h,
                                                          d // h)
        return tuple(t.contiguous() for t in qkv.unbind(2))

    def output(self, o):
        b, s = o.shape[:2]
        return dense(self.out, o.reshape(b, s, -1), self.compute_dtype)

    def forward(self, x, cache_index=None, block_table=None,
                flash_prefill: bool = False,
                window_pages: Optional[int] = None, layer_cache=None):
        q, k, v = self.project(x)
        if layer_cache is None:
            o = flash_attention(q, k, v, causal=True)
        elif "cached_key" in layer_cache:
            if cache_index is None:
                raise ValueError("decode needs cache_index [B] int32")
            o = _contiguous_attention(q, k, v, layer_cache, cache_index)
        else:
            if cache_index is None or block_table is None:
                raise ValueError("paged decode needs cache_index [B] and "
                                 "block_table [B, M], both int32")
            pool_k = layer_cache["paged_key"]
            pool_v = layer_cache["paged_value"]
            # write-then-attend.  Prefill chunks (S a page multiple,
            # page-aligned starts by engine construction) write whole
            # pages; decode steps (S = 1) write token rows
            s = q.shape[1]
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
        return self.output(o)


def _contiguous_attention(q, k, v, layer_cache, cache_index):
    """Write the chunk's K/V at each row's ``cache_index`` into the
    [B, L, H, Dh] slabs, then attend every query over the slab: query i
    (position index + i) sees slab rows j <= index + i -- the chunk
    causally, the prefix fully, never the stale tail.  The write start
    is clamped to L - S, as ``lax.dynamic_update_slice`` clamps it."""
    ck, cv = layer_cache["cached_key"], layer_cache["cached_value"]
    b, s = q.shape[:2]
    length = ck.shape[1]
    dev = q.device
    start = torch.clamp(cache_index.long(), 0, length - s)
    rows = torch.arange(b, device=dev)[:, None]
    pos = start[:, None] + torch.arange(s, device=dev)[None, :]
    ck[rows, pos] = k.to(ck.dtype)
    cv[rows, pos] = v.to(cv.dtype)
    jpos = torch.arange(length, device=dev)[None, None, :]
    qpos = (cache_index.long()[:, None, None]
            + torch.arange(s, device=dev)[None, :, None])
    return cached_attention(q, ck, cv, jpos <= qpos)


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(d_model, num_heads, dtype)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x, cache_index=None, block_table=None,
                flash_prefill: bool = False,
                window_pages: Optional[int] = None, layer_cache=None):
        dt = self.compute_dtype
        x = x + self.attn(layer_norm(self.ln1, x, dt), cache_index,
                          block_table, flash_prefill, window_pages,
                          layer_cache)
        return self._mlp(x)

    def _mlp(self, x):
        dt = self.compute_dtype
        h = F.gelu(dense(self.fc1, layer_norm(self.ln2, x, dt), dt),
                   approximate="tanh")
        return x + dense(self.fc2, h, dt)

    def _attn_in(self, x):
        return self.attn.project(layer_norm(self.ln1, x, self.compute_dtype))

    def _attn_out_mlp(self, x, o):
        return self._mlp(x + self.attn.output(o))

    def selective(self, x, context_fn):
        """The training forward under a selective policy: two
        checkpointed regions around the flash attention, which saves
        its own residuals (see the module's docstring)."""
        ckpt = torch.utils.checkpoint.checkpoint
        q, k, v = ckpt(self._attn_in, x, use_reentrant=False,
                       context_fn=context_fn)
        o = flash_attention(q, k, v, causal=True)
        return ckpt(self._attn_out_mlp, x, o, use_reentrant=False,
                    context_fn=context_fn)


class TransformerLM(nn.Module):
    """Next-token LM: tokens [B, S] int -> logits [B, S, vocab] float32.

    Parameters are float32; ``dtype`` (float32 or bfloat16) is the
    compute dtype they are cast to at use, as flax's ``dtype`` with its
    float32 ``param_dtype``."""

    def __init__(self, vocab_size: int, num_layers: int = 12,
                 d_model: int = 512, num_heads: int = 8, d_ff: int = 2048,
                 max_seq_len: int = 2048, dtype=torch.float32,
                 remat: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        # a named policy implies remat (the JAX package's rule)
        self.remat_context = (None if remat_policy is None
                              else remat_context(remat_policy))
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.d_ff = d_ff
        self.max_seq_len = max_seq_len
        self.compute_dtype = dtype
        self.remat = remat or remat_policy is not None
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.zeros(max_seq_len, d_model))
        for i in range(num_layers):
            self.add_module(f"block{i}",
                            Block(d_model, num_heads, d_ff, dtype))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.lm_head = nn.Linear(d_model, vocab_size)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (activations, KV pages); parameters are
        float32."""
        return self.compute_dtype

    @property
    def blocks(self) -> List[Block]:
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def forward(self, tokens, cache_index=None, block_table=None,
                cache=None, flash_prefill: bool = False,
                window_pages: Optional[int] = None):
        b, s = tokens.shape
        dt = self.compute_dtype
        # flax Embed(dtype=...): the table cast, then the rows taken
        x = F.embedding(tokens, cast(self.embed.weight, dt))
        if cache is None:
            if s > self.max_seq_len:
                raise ValueError(f"sequence {s} exceeds max_seq_len "
                                 f"{self.max_seq_len}")
            x = x + self.pos_embed[:s].to(dt)
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
            x = x + self.pos_embed[pos].to(dt)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if remat and self.remat_context is not None:
                x = block.selective(x, self.remat_context)
            elif remat:
                x = torch.utils.checkpoint.checkpoint(block, x,
                                                      use_reentrant=False)
            else:
                x = block(x, cache_index, block_table, flash_prefill,
                          window_pages, None if cache is None else cache[i])
        return dense(self.lm_head, layer_norm(self.ln_f, x, dt), dt).float()
