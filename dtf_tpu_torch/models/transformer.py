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

Tensor parallelism (``model_parallelism`` > 1; the JAX ``model_axis``)
is Megatron's layout (``models/partition.py``): a model shard holds
H/mp heads of qkv and the matching input columns of ``out``, d_ff/mp of
fc1 and of fc2's input, and (``shard_vocab``) V/mp rows of the
``lm_head``; everything else is replicated.  In training each shard is
one rank and ``model_group`` its model axis: each block enters its
attention and its MLP through ``tp_region`` (identity forward, sum of
the cotangent backward) and leaves through ``tp_psum`` (sum forward,
identity backward), so the flash kernels run at [B, S, H/mp, Dh] and
a sharded ``lm_head`` returns local logits [B, S, V/mp] for the
collective cross-entropy (``train/loop.py``).  In serving one process
drives every shard (:class:`TensorParallelLM`): the row-parallel
partials of each block are summed in shard order on the first shard's
device.  The head size is ``d_model // num_heads`` of the full model
whatever the shard.

Sequence parallelism (``--seq_parallelism``; the JAX ``seq_axis``):
:meth:`TransformerLM.set_seq_group` gives a training rank its seq group,
and the rank's tokens are its columns of the sequence (``seq_index`` x
S_local onward).  Every attention then runs ``parallel.ring_attention``
over the group in place of the flash kernels -- K and V rotate around
the ring, each query attending to the whole global sequence -- and the
positions added are the rank's own (``pos_embed[offset : offset +
S_local]``).  Heads never cross the ring, so the shard-local tensor
parallel blocks compose with it; under ``remat_policy="dots"`` the two
checkpointed regions surround the ring.  Decode with a seq group is
refused (the JAX message): serving drops the group, as the JAX decoder
drops ``seq_axis``.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from dtf_tpu_torch.models import partition
from dtf_tpu_torch.ops.flash_attention import flash_attention
from dtf_tpu_torch.parallel.collectives import tp_psum, tp_region
from dtf_tpu_torch.parallel.ring_attention import ring_attention
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


def _local(n: int, mp: int, what: str) -> int:
    if n % mp:
        raise ValueError(f"{what} {n} not divisible by model_parallelism "
                         f"{mp}")
    return n // mp


class CausalSelfAttention(nn.Module):
    """``num_heads`` is the full model's; a tensor-parallel shard
    (``model_parallelism`` mp) holds num_heads / mp of them."""

    def __init__(self, d_model: int, num_heads: int,
                 dtype=torch.float32, model_parallelism: int = 1):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"num_heads {num_heads}")
        self.head_dim = d_model // num_heads
        self.num_heads = _local(num_heads, model_parallelism, "num_heads")
        self.compute_dtype = dtype
        # the seq group of sequence parallelism (None: the whole sequence)
        self.seq_group = None
        width = self.num_heads * self.head_dim
        # flax DenseGeneral((3, H, Dh)): output features ordered (3, H, Dh)
        self.qkv = nn.Linear(d_model, 3 * width)
        self.out = nn.Linear(width, d_model, bias=False)

    def project(self, x):
        """q, k, v: contiguous [B, S, H, Dh] each, the kernels' layout."""
        b, s, _ = x.shape
        qkv = dense(self.qkv, x, self.compute_dtype).view(
            b, s, 3, self.num_heads, self.head_dim)
        return tuple(t.contiguous() for t in qkv.unbind(2))

    def output(self, o):
        b, s = o.shape[:2]
        return dense(self.out, o.reshape(b, s, -1), self.compute_dtype)

    def attend(self, q, k, v):
        """Causal self-attention of the training forward: the ring over
        the seq group under sequence parallelism, else the flash
        kernels."""
        if self.seq_group is not None:
            return ring_attention(q, k, v, self.seq_group, causal=True)
        return flash_attention(q, k, v, causal=True)

    def forward(self, x, cache_index=None, block_table=None,
                flash_prefill: bool = False,
                window_pages: Optional[int] = None, layer_cache=None):
        if layer_cache is not None and self.seq_group is not None:
            raise ValueError(
                "decode mode (KV cache) does not compose with seq_axis "
                "sharding (ring attention)")
        q, k, v = self.project(x)
        if layer_cache is None:
            o = self.attend(q, k, v)
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
    """One pre-LN block.  Under tensor parallelism (``model_group`` set)
    its attention and MLP are shard-local between ``tp_region`` and
    ``tp_psum``; :meth:`attn_partial` and :meth:`mlp_partial` are the
    shard's row-parallel outputs before the sum, which
    :class:`TensorParallelLM` sums itself."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dtype=torch.float32, model_parallelism: int = 1):
        super().__init__()
        self.compute_dtype = dtype
        self.model_group = None
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(d_model, num_heads, dtype,
                                        model_parallelism)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        d_ff = _local(d_ff, model_parallelism, "d_ff")
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x, cache_index=None, block_table=None,
                flash_prefill: bool = False,
                window_pages: Optional[int] = None, layer_cache=None):
        x = x + tp_psum(self.attn_partial(x, cache_index, block_table,
                                          flash_prefill, window_pages,
                                          layer_cache), self.model_group)
        return self._mlp(x)

    def attn_partial(self, x, cache_index=None, block_table=None,
                     flash_prefill: bool = False,
                     window_pages: Optional[int] = None, layer_cache=None):
        h = tp_region(layer_norm(self.ln1, x, self.compute_dtype),
                      self.model_group)
        return self.attn(h, cache_index, block_table, flash_prefill,
                         window_pages, layer_cache)

    def mlp_partial(self, x):
        dt = self.compute_dtype
        h = tp_region(layer_norm(self.ln2, x, dt), self.model_group)
        return dense(self.fc2, F.gelu(dense(self.fc1, h, dt),
                                      approximate="tanh"), dt)

    def _mlp(self, x):
        return x + tp_psum(self.mlp_partial(x), self.model_group)

    def _attn_in(self, x):
        return self.attn.project(tp_region(
            layer_norm(self.ln1, x, self.compute_dtype), self.model_group))

    def _attn_out_mlp(self, x, o):
        return self._mlp(x + tp_psum(self.attn.output(o),
                                     self.model_group))

    def selective(self, x, context_fn):
        """The training forward under a selective policy: two
        checkpointed regions around the attention (the flash kernels or
        the ring), which saves its own residuals (see the module's
        docstring)."""
        ckpt = torch.utils.checkpoint.checkpoint
        q, k, v = ckpt(self._attn_in, x, use_reentrant=False,
                       context_fn=context_fn)
        o = self.attn.attend(q, k, v)
        return ckpt(self._attn_out_mlp, x, o, use_reentrant=False,
                    context_fn=context_fn)


class TransformerLM(nn.Module):
    """Next-token LM: tokens [B, S] int -> logits [B, S, vocab] float32.

    Parameters are float32; ``dtype`` (float32 or bfloat16) is the
    compute dtype they are cast to at use, as flax's ``dtype`` with its
    float32 ``param_dtype``.

    ``model_parallelism`` mp > 1 builds model shard ``model_index`` of
    mp (``shard_vocab``: the ``lm_head`` sharded too); the config
    attributes stay the full model's.  :meth:`set_model_group` gives a
    training shard its model axis."""

    def __init__(self, vocab_size: int, num_layers: int = 12,
                 d_model: int = 512, num_heads: int = 8, d_ff: int = 2048,
                 max_seq_len: int = 2048, dtype=torch.float32,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 model_parallelism: int = 1, model_index: int = 0,
                 shard_vocab: bool = False):
        super().__init__()
        mp = int(model_parallelism)
        if not 0 <= model_index < mp:
            raise ValueError(f"model_index {model_index} outside "
                             f"0..{mp - 1}")
        if shard_vocab and mp == 1:
            raise ValueError("shard_vocab needs model_parallelism > 1")
        self.model_parallelism = mp
        self.model_index = int(model_index)
        self.shard_vocab = bool(shard_vocab)
        self.model_group = None
        self.seq_group = None
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
                            Block(d_model, num_heads, d_ff, dtype, mp))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        vocab = (_local(vocab_size, mp, "vocab_size") if shard_vocab
                 else vocab_size)
        self.lm_head = nn.Linear(d_model, vocab)

    def config(self) -> dict:
        """The constructor's arguments (the full model's), so a twin or
        another shard can be built."""
        return dict(vocab_size=self.vocab_size, num_layers=self.num_layers,
                    d_model=self.d_model, num_heads=self.num_heads,
                    d_ff=self.d_ff, max_seq_len=self.max_seq_len,
                    dtype=self.compute_dtype, shard_vocab=self.shard_vocab,
                    model_parallelism=self.model_parallelism,
                    model_index=self.model_index)

    def split(self, name: str):
        """The partition rule's sharded dimension of parameter ``name``
        in this model (None: replicated, or no tensor parallelism)."""
        if self.model_parallelism == 1:
            return None
        return partition.rule(name, self.shard_vocab)

    def set_model_group(self, group) -> None:
        """The training shard's model axis (a process group of its
        model_parallelism ranks)."""
        self.model_group = group
        for block in self.blocks:
            block.model_group = group

    def set_seq_group(self, group) -> None:
        """The training rank's seq group (sequence parallelism; None:
        the whole sequence on this rank): every attention becomes ring
        attention over it, and the positions start at this rank's
        columns."""
        self.seq_group = group
        for block in self.blocks:
            block.attn.seq_group = group

    @property
    def seq_index(self) -> int:
        """This rank's place on the seq ring (0 without one)."""
        if self.seq_group is None:
            return 0
        return dist.get_rank(self.seq_group)

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
        if self.model_parallelism > 1 and self.model_group is None:
            raise ValueError(
                "a tensor-parallel shard runs within its model group "
                "(set_model_group) or under a TensorParallelLM")
        x = self.embed_positions(tokens, cache_index, cache)
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
        return self.head(x)

    def head(self, x):
        """The final LayerNorm and the ``lm_head``: float32 logits (a
        vocabulary shard's under ``shard_vocab``)."""
        dt = self.compute_dtype
        h = layer_norm(self.ln_f, x, dt)
        if self.shard_vocab:
            # x is whole here (the last block left through tp_psum), but
            # its cotangent comes back vocabulary-partial
            h = tp_region(h, self.model_group)
        return dense(self.lm_head, h, dt).float()

    def embed_positions(self, tokens, cache_index=None, cache=None):
        """Token embeddings plus positions, in the compute dtype: each
        row's positions from ``cache_index`` when decoding."""
        b, s = tokens.shape
        dt = self.compute_dtype
        # flax Embed(dtype=...): the table cast, then the rows taken
        x = F.embedding(tokens, cast(self.embed.weight, dt))
        if cache is None:
            # a seq rank's columns start at its place on the ring
            offset = self.seq_index * s
            if offset + s > self.max_seq_len:
                raise ValueError(f"sequence {offset + s} exceeds "
                                 f"max_seq_len {self.max_seq_len}")
            x = x + self.pos_embed[offset:offset + s].to(dt)
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
        return x


class TensorParallelLM(nn.Module):
    """A serving model whose mp shards (:class:`TransformerLM` built at
    ``model_parallelism`` mp, shard k on ``devices[k]``) one process
    drives in step -- the counterpart of the JAX decoder's shard_map
    over the 'model' axis.  Each shard runs its own attention kernels
    at H/mp heads over its own K/V pools (``cache[k]``, the shard's
    per-layer list); each block's row-parallel partials come to the
    first shard's device and are summed there in shard order, and the
    sum goes back to every shard.  The first shard embeds and computes
    the logits (replicated leaves: every shard holds the same ones).
    No parameter or cache is replicated beyond the partition rule."""

    def __init__(self, shards: List[TransformerLM]):
        super().__init__()
        mp = len(shards)
        if mp < 2 or any(s.model_parallelism != mp or s.model_index != k
                         for k, s in enumerate(shards)):
            raise ValueError("TensorParallelLM needs the model_parallelism "
                             "shards 0..mp-1 of one model, in order")
        if shards[0].shard_vocab:
            raise ValueError("decode does not compose with shard_vocab "
                             "(the serving logits are whole)")
        self.shards = nn.ModuleList(shards)
        self.tp = mp
        first = shards[0]
        for name in ("vocab_size", "num_layers", "d_model", "num_heads",
                     "d_ff", "max_seq_len", "compute_dtype"):
            setattr(self, name, getattr(first, name))

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype

    @property
    def pos_embed(self) -> torch.Tensor:
        """The first shard's position table: where the engine's inputs
        and the logits live."""
        return self.shards[0].pos_embed

    @property
    def embed(self) -> nn.Embedding:
        return self.shards[0].embed

    @property
    def devices(self) -> List[torch.device]:
        return [s.pos_embed.device for s in self.shards]

    def forward(self, tokens, cache_index=None, block_table=None,
                cache=None, flash_prefill: bool = False,
                window_pages: Optional[int] = None):
        if cache is None or len(cache) != self.tp:
            raise ValueError(f"a tensor-parallel model decodes over one "
                             f"cache a shard ({self.tp})")
        first = self.shards[0]
        home = first.pos_embed.device
        devs = self.devices
        index = [None if cache_index is None else cache_index.to(d)
                 for d in devs]
        tables = [None if block_table is None else block_table.to(d)
                  for d in devs]
        x = first.embed_positions(tokens, cache_index, cache[0])
        for i in range(self.num_layers):
            blocks = [s.blocks[i] for s in self.shards]
            parts = [b.attn_partial(x.to(d), index[k], tables[k],
                                    flash_prefill, window_pages,
                                    cache[k][i])
                     for k, (b, d) in enumerate(zip(blocks, devs))]
            x = x + _sum_in_order(parts, home)
            parts = [b.mlp_partial(x.to(d))
                     for b, d in zip(blocks, devs)]
            x = x + _sum_in_order(parts, home)
        return first.head(x)


def _sum_in_order(parts, device):
    """The shards' partials summed in shard order on ``device``."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total
