"""Mixture-of-experts transformer LM -- the PyTorch counterpart of
``dtf_tpu/models/moe.py`` (GShard/Switch routing, expert parallelism).

Routing is static-shape, as in the JAX module: a float32 router (a
Linear on float32 tokens, then softmax) picks each token's top-k experts
by iterated argmax (k = 1 is Switch, k = 2 GShard's top-2; k is clamped
to the expert count), each choice gets a slot by cumulative count (a
later choice's slots after every earlier choice's), and an expert keeps
``max(1, min(n, round(capacity_factor k n / E)))`` slots: a token past
its expert's capacity is dropped there (its MoE output is 0; the
residual carries it).  Top-2 gates are renormalized to sum to 1; top-1
keeps the raw probability (the router's gradient path).  The Switch
load-balance term ``aux_weight * E * sum_e f_e p_e`` of the last
training forward is kept on each MoE layer (:meth:`MoETransformerLM.
aux_loss`, which the Trainer adds to the objective); eval keeps none.
The experts are ``[E_loc, C, d]`` batched products (``torch.bmm``)
through ``w1``/``b1``, tanh GELU, then ``w2``/``b2`` in the compute
dtype; the combine runs in float32.

Two dispatches (``dispatch_mode``):
  scatter  the default: each choice copies its tokens into their slot
           rows (``index_copy``) and gathers the experts' outputs back
           (``index_select``).  A token that is dropped, or routed to
           another rank's experts, goes to a dump row of its own past
           the slot rows, sliced off after: every row of every copy and
           gather has one writer, so the result (and its gradient, a
           gather and a one-writer scatter) is the same bits run after
           run on the card, no atomics.
  dense    the one-hot ``[n, E, C]`` einsums, the tests' oracle; it
           refuses the model-axis placement, as the JAX one does.

Expert parallelism, two placements (``expert_axis``), each rank holding
``E / ep`` experts, ``expert_index`` its place:
  "data"   the classic placement: the expert group is the data axis
           (:meth:`MoETransformerLM.set_expert_group`, the rank's data
           group).  Two tiled ``all_to_all`` (``parallel/
           collectives.py``) a MoE layer exchange the slot rows,
           [E, C, d] -> [E/ep, ep C, d] and back.  The Trainer divides
           these leaves' gradients by dp instead of averaging them
           (reverse-mode all_to_all already summed them), averages them
           over the seq group, and gathers them for a checkpoint.
  "model"  the model axis (``--model_parallelism`` with this family):
           the batch is replicated over it, so no token moves: each rank
           runs its experts on the tokens routed to them, and the
           partial outputs leave through ``tp_psum``; the router's
           probabilities and the tokens enter through ``tp_region``, so
           every replicated leaf gets the unsharded gradient on every
           rank.  The Trainer's tensor-parallel machinery carries it
           (:meth:`split`, ``set_model_group``).
The partition rule (:func:`expert_rule`, the JAX
``moe_param_partition_specs``): ``w1``, ``b1``, ``w2`` and ``b2`` under
``moe`` are split on dim 0 over the expert axis; everything else is
replicated.

Parameter names follow the flax tree: ``block{i}`` is a dense block
(``models/transformer.py Block``) or, at ``i % moe_every == moe_every -
1``, a :class:`MoEBlock` (``ln1``, ``attn``, ``ln2``, ``moe.router``,
``moe.w1`` [E, d, d_ff], ``moe.b1``, ``moe.w2`` [E, d_ff, d],
``moe.b2``); LayerNorm epsilon 1e-6 and the tanh GELU as the
transformer pins them.  Remat and ``remat_policy="dots"`` are the
transformer's (the expert exchange re-runs in the recompute, as under
the JAX policy).  :meth:`MoETransformerLM.set_seq_group` gives ring
attention and the rank's position offset under sequence parallelism.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from dtf_tpu_torch.models.partition import Split
from dtf_tpu_torch.models.transformer import (LN_EPS, Block,
                                              CausalSelfAttention, cast,
                                              dense, layer_norm,
                                              remat_context)
from dtf_tpu_torch.parallel.collectives import (all_to_all, tp_psum,
                                                tp_region)

EXPERT_PARAMS = ("w1", "b1", "w2", "b2")
PLACEMENTS = ("data", "model")


def expert_rule(name: str) -> Optional[Split]:
    """The sharded dimension of parameter ``name`` under expert
    parallelism: dim 0 (the experts) of ``w1``/``b1``/``w2``/``b2``
    under a ``moe`` module, None for a replicated leaf."""
    keys = name.split(".")
    if "moe" in keys and keys[-1] in EXPERT_PARAMS:
        return Split(0)
    return None


class MoEMLP(nn.Module):
    """Top-k routed expert MLP with static capacity: ``x`` [B, S, d] ->
    the same shape.  A shard of ``expert_parallelism`` ep > 1 holds
    experts [index E/ep, (index + 1) E/ep) and runs within its expert
    group (``group``)."""

    def __init__(self, d_model: int, num_experts: int, d_ff: int,
                 capacity_factor: float = 1.25, router_top_k: int = 2,
                 dtype=torch.float32, expert_axis: Optional[str] = None,
                 expert_parallelism: int = 1, expert_index: int = 0,
                 dispatch_mode: str = "scatter", aux_weight: float = 0.01):
        super().__init__()
        ep = int(expert_parallelism)
        if num_experts % ep:
            raise ValueError(f"num_experts {num_experts} not divisible by "
                             f"expert-parallel group size {ep}")
        if dispatch_mode not in ("scatter", "dense"):
            raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
        if dispatch_mode == "dense" and expert_axis == "model":
            raise ValueError(
                "dense dispatch implements the along-batch (all_to_all) "
                "placement only; use dispatch_mode='scatter' for "
                "model-axis expert parallelism")
        if router_top_k < 1:
            raise ValueError(f"router_top_k {router_top_k} must be >= 1")
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.top_k = router_top_k
        self.compute_dtype = dtype
        self.expert_axis = expert_axis
        self.expert_parallelism = ep
        self.expert_index = int(expert_index)
        self.dispatch_mode = dispatch_mode
        self.aux_weight = aux_weight
        # the expert group (None: every expert on this rank)
        self.group = None
        # the last training forward's load-balance term, and its routed
        # choices dropped for capacity (a 0-d device tensor)
        self.aux: Optional[torch.Tensor] = None
        self.dropped: Optional[torch.Tensor] = None
        self.routed = 0
        e_loc = num_experts // ep
        self.w1 = nn.Parameter(torch.zeros(e_loc, d_model, d_ff))
        self.b1 = nn.Parameter(torch.zeros(e_loc, d_ff))
        self.w2 = nn.Parameter(torch.zeros(e_loc, d_ff, d_model))
        self.b2 = nn.Parameter(torch.zeros(e_loc, d_model))
        self.router = nn.Linear(d_model, num_experts)

    @property
    def local_experts(self) -> int:
        return self.num_experts // self.expert_parallelism

    def _on_data_axis(self) -> bool:
        """True where the slot rows cross the data axis."""
        return self.expert_axis == "data" and self.expert_parallelism > 1

    def _on_model_axis(self) -> bool:
        return self.expert_axis == "model" and self.expert_parallelism > 1

    def experts(self, xin):
        """[E_loc, slots, d] expert batch -> the same shape, in the
        compute dtype."""
        dt = self.compute_dtype
        h = torch.bmm(xin, cast(self.w1, dt)) + cast(self.b1, dt)[:, None, :]
        h = F.gelu(h, approximate="tanh")
        out = torch.bmm(h, cast(self.w2, dt))
        return out + cast(self.b2, dt)[:, None, :]

    def forward(self, x):
        ep = self.expert_parallelism
        if ep > 1:
            if self.group is None:
                raise ValueError(
                    "an expert shard runs within its expert group "
                    "(set_expert_group / set_model_group)")
            if dist.get_world_size(self.group) != ep:
                raise ValueError(
                    f"expert group of {dist.get_world_size(self.group)} "
                    f"ranks for expert_parallelism {ep}")
        b, s, d = x.shape
        e = self.num_experts
        n = b * s
        tok32 = x.reshape(n, d).float()

        # ---- router (float32) ----------------------------------------
        probs = torch.softmax(F.linear(tok32, self.router.weight,
                                       self.router.bias), -1)
        k = min(self.top_k, e)   # a single expert degenerates top-2
        idxs, masks = [], []
        remaining = probs
        for _ in range(k):
            idx = remaining.argmax(-1)
            m = F.one_hot(idx, e).to(probs.dtype)
            idxs.append(idx)
            masks.append(m)
            remaining = remaining * (1.0 - m)
        aux = e * (masks[0].mean(0) * probs.mean(0)).sum()

        # ---- capacity slots (static C) ---------------------------------
        cap = max(1, min(n, int(round(self.capacity_factor * k * n / e))))
        keeps, slots = [], []
        count_prev = torch.zeros(e, dtype=torch.long, device=x.device)
        for idx in idxs:
            m = F.one_hot(idx, e)
            slots.append(((m.cumsum(0) - m + count_prev) * m).sum(-1))
            count_prev = count_prev + m.sum(0)
            keeps.append(slots[-1] < cap)
        if self.training:
            self.aux = self.aux_weight * aux
            self.dropped = (n * k - sum(kp.sum() for kp in keeps)).detach()
            self.routed = n * k

        # the model-axis placement consumes gates and tokens per rank:
        # their replicated producers enter through tp_region, so the
        # summed cotangent is the unsharded one on every rank
        group = self.group if self._on_model_axis() else None
        probs_src = tp_region(probs, group)
        tok_src = tp_region(tok32, group)
        gates = [(probs_src * m).sum(-1) * kp.to(probs.dtype)
                 for m, kp in zip(masks, keeps)]
        if k > 1:
            # GShard renormalizes the kept top-k gates to sum to 1
            denom = sum(gates)
            denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        else:
            # Switch keeps the raw probability
            denom = 1.0
        if self.dispatch_mode == "dense":
            y = self._dense(tok_src, masks, gates, denom, keeps, slots, cap)
        else:
            y = self._scatter(tok_src, idxs, gates, denom, keeps, slots, cap)
        return y.reshape(b, s, d).to(x.dtype)

    def _scatter(self, tok, idxs, gates, denom, keeps, slots, cap):
        n, d = tok.shape
        if self._on_model_axis():
            e_here = self.local_experts
            first = self.expert_index * e_here
        else:
            e_here, first = self.num_experts, 0
        rows = e_here * cap
        # token i's own dump row: rows + i, sliced off after
        spill = rows + torch.arange(n, device=tok.device)
        buf = tok.new_zeros(rows + n, d)
        weights, dests = [], []
        for idx, pos, kp, g in zip(idxs, slots, keeps, gates):
            local = idx - first
            ok = kp & (local >= 0) & (local < e_here)
            dest = torch.where(ok, local * cap + pos, spill)
            buf = buf.index_copy(0, dest, tok)
            dests.append(dest)
            weights.append(ok.to(g.dtype) * g / denom)
        xin = buf[:rows].view(e_here, cap, d).to(self.compute_dtype)
        if self._on_data_axis():
            # the slot rows cross the data axis: [E, C, d] -> [E/ep, ep C,
            # d], this rank's experts' slots from every peer
            xin = all_to_all(xin, self.group, 0, 1)
        out = self.experts(xin)
        if self._on_data_axis():
            out = all_to_all(out, self.group, 1, 0)
        # zero rows where the dump rows were: a dropped token reads 0
        out = torch.cat([out.reshape(rows, d).float(), tok.new_zeros(n, d)])
        y = torch.zeros_like(tok)
        for w, dest in zip(weights, dests):
            y = y + w[:, None] * out.index_select(0, dest)
        if self._on_model_axis():
            # identity backward: each rank's partial carries the whole
            # cotangent of its own tokens' outputs
            y = tp_psum(y, self.group)
        return y

    def _dense(self, tok, masks, gates, denom, keeps, slots, cap):
        """The one-hot oracle: dispatch and combine as [n, E, C]."""
        n = tok.shape[0]
        e = self.num_experts
        cols = torch.arange(cap, device=tok.device)
        dispatch = tok.new_zeros(n, e, cap)
        combine = tok.new_zeros(n, e, cap)
        for m, g, kp, pos in zip(masks, gates, keeps, slots):
            # an out-of-capacity position matches no column
            oh = (pos[:, None] == cols[None, :]).to(tok.dtype) \
                * kp.to(tok.dtype)[:, None]
            slot = m[:, :, None] * oh[:, None, :]
            dispatch = dispatch + slot
            combine = combine + (g / denom)[:, None, None] * slot
        xin = torch.einsum("nec,nd->ecd", dispatch.detach(),
                           tok).to(self.compute_dtype)
        if self._on_data_axis():
            xin = all_to_all(xin, self.group, 0, 1)
        out = self.experts(xin)
        if self._on_data_axis():
            out = all_to_all(out, self.group, 1, 0)
        return torch.einsum("nec,ecd->nd", combine, out.float())


class MoEBlock(nn.Module):
    """Pre-LN block: causal attention (the transformer's) and a routed
    expert MLP."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 num_experts: int, dtype=torch.float32, **moe_kw):
        super().__init__()
        self.compute_dtype = dtype
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(d_model, num_heads, dtype)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.moe = MoEMLP(d_model, num_experts, d_ff, dtype=dtype, **moe_kw)

    def forward(self, x):
        o = self.attn.attend(*self._attn_in(x))
        return self._attn_out_mlp(x, o)

    def _attn_in(self, x):
        return self.attn.project(layer_norm(self.ln1, x, self.compute_dtype))

    def _attn_out_mlp(self, x, o):
        x = x + self.attn.output(o)
        return x + self.moe(layer_norm(self.ln2, x, self.compute_dtype))

    def selective(self, x, context_fn):
        """Two checkpointed regions around the attention, as
        ``Block.selective``."""
        ckpt = torch.utils.checkpoint.checkpoint
        q, k, v = ckpt(self._attn_in, x, use_reentrant=False,
                       context_fn=context_fn)
        o = self.attn.attend(q, k, v)
        return ckpt(self._attn_out_mlp, x, o, use_reentrant=False,
                    context_fn=context_fn)


class MoETransformerLM(nn.Module):
    """Decoder-only LM with a routed-expert MLP in every ``moe_every``-th
    block: tokens [B, S] -> logits [B, S, vocab] float32.

    ``expert_axis`` ("data" or "model") and ``expert_parallelism`` ep >
    1 build expert shard ``expert_index`` of ep (E/ep experts a MoE
    layer); the config attributes stay the full model's."""

    def __init__(self, vocab_size: int, num_layers: int = 12,
                 d_model: int = 512, num_heads: int = 8, d_ff: int = 2048,
                 num_experts: int = 8, moe_every: int = 2,
                 capacity_factor: float = 1.25, router_top_k: int = 2,
                 aux_weight: float = 0.01, max_seq_len: int = 2048,
                 dtype=torch.float32, remat: bool = False,
                 remat_policy: Optional[str] = None,
                 dispatch_mode: str = "scatter",
                 expert_axis: Optional[str] = None,
                 expert_parallelism: int = 1, expert_index: int = 0):
        super().__init__()
        ep = int(expert_parallelism)
        if expert_axis not in (None,) + PLACEMENTS:
            raise ValueError(f"expert_axis must be one of {PLACEMENTS} or "
                             f"None, got {expert_axis!r}")
        if ep > 1 and expert_axis is None:
            raise ValueError("expert_parallelism > 1 needs an expert_axis")
        if not 0 <= expert_index < ep:
            raise ValueError(f"expert_index {expert_index} outside "
                             f"0..{ep - 1}")
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.d_ff = d_ff
        self.num_experts = num_experts
        self.moe_every = moe_every
        self.capacity_factor = capacity_factor
        self.router_top_k = router_top_k
        self.aux_weight = aux_weight
        self.max_seq_len = max_seq_len
        self.compute_dtype = dtype
        self.remat = remat or remat_policy is not None
        self.remat_context = (None if remat_policy is None
                              else remat_context(remat_policy))
        self.expert_axis = expert_axis
        self.expert_parallelism = ep
        self.expert_index = int(expert_index)
        self.shard_vocab = False
        self.seq_group = None
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.zeros(max_seq_len, d_model))
        moe_kw = dict(capacity_factor=capacity_factor,
                      router_top_k=router_top_k, expert_axis=expert_axis,
                      expert_parallelism=ep, expert_index=expert_index,
                      dispatch_mode=dispatch_mode, aux_weight=aux_weight)
        for i in range(num_layers):
            if i % moe_every == moe_every - 1:
                block = MoEBlock(d_model, num_heads, d_ff, num_experts,
                                 dtype, **moe_kw)
            else:
                block = Block(d_model, num_heads, d_ff, dtype)
            self.add_module(f"block{i}", block)
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.lm_head = nn.Linear(d_model, vocab_size)

    # the model axis the Trainer's tensor-parallel machinery sees: the
    # expert shards under the model-axis placement, else none
    @property
    def model_parallelism(self) -> int:
        return (self.expert_parallelism if self.expert_axis == "model"
                else 1)

    @property
    def model_index(self) -> int:
        return self.expert_index if self.expert_axis == "model" else 0

    def split(self, name: str) -> Optional[Split]:
        """The partition rule's sharded dimension of parameter ``name``
        in this shard (None: replicated, or every expert here)."""
        if self.expert_parallelism == 1:
            return None
        return expert_rule(name)

    def set_expert_group(self, group) -> None:
        """The expert group: the rank's data group under the data-axis
        placement, its model group under the model-axis one."""
        for layer in self.moe_layers:
            layer.group = group

    def set_model_group(self, group) -> None:
        """The training shard's model axis: the expert group of the
        model-axis placement."""
        self.set_expert_group(group)

    def set_seq_group(self, group) -> None:
        """The training rank's seq group: ring attention over it, and
        positions from this rank's columns."""
        self.seq_group = group
        for block in self.blocks:
            block.attn.seq_group = group

    @property
    def seq_index(self) -> int:
        if self.seq_group is None:
            return 0
        return dist.get_rank(self.seq_group)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype

    @property
    def blocks(self) -> List[nn.Module]:
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    @property
    def moe_layers(self) -> List[MoEMLP]:
        return [b.moe for b in self.blocks if isinstance(b, MoEBlock)]

    def aux_loss(self) -> torch.Tensor:
        """The sum of the MoE layers' load-balance terms of the last
        training forward (float32, 0-d), taken: a second call returns
        zero until the next training forward."""
        total = torch.zeros((), dtype=torch.float32,
                            device=self.pos_embed.device)
        for layer in self.moe_layers:
            if layer.aux is not None:
                total = total + layer.aux
                layer.aux = None
        return total

    def forward(self, tokens):
        b, s = tokens.shape
        dt = self.compute_dtype
        offset = self.seq_index * s
        if offset + s > self.max_seq_len:
            raise ValueError(f"sequence {offset + s} exceeds max_seq_len "
                             f"{self.max_seq_len}")
        x = (F.embedding(tokens, cast(self.embed.weight, dt))
             + self.pos_embed[offset:offset + s].to(dt))
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat and self.remat_context is not None:
                x = block.selective(x, self.remat_context)
            elif remat:
                x = torch.utils.checkpoint.checkpoint(block, x,
                                                      use_reentrant=False)
            else:
                x = block(x)
        h = layer_norm(self.ln_f, x, dt)
        return dense(self.lm_head, h, dt).float()
