"""Pipeline-parallel decoder-only LM -- the PyTorch counterpart of
``dtf_tpu/models/pipeline_lm.py``.

The transformer blocks are *stacked*: every block parameter
(``BLOCK_PARAMS``) carries a leading layer dimension, and under
pipeline parallelism (``model_parallelism`` pp > 1, the JAX
``pipe_axis``) stage j's rank holds only its layers [j L / pp,
(j + 1) L / pp) -- the partition rule :meth:`PipelinedTransformerLM.split`
(the JAX ``pipeline_param_partition_specs``) cuts dim 0.  Parameter
names and shapes are the flax module's (``embed`` [V, d],
``qkv_k`` [L, d, 3 H Dh], ``head_k`` [d, V], ...), so ``convert.py``
carries them across as they are.

A stage is a loop over its local stack, and the stages exchange
activations through ``parallel.pipeline`` (GPipe, or the interleaved
schedule at ``interleave=2``) over the model group
(:meth:`PipelinedTransformerLM.set_model_group`, the training rank's
model axis).  Off the mesh (pp 1, no group) the whole batch runs
through every layer in one pass, no microbatching: the twin the JAX
tests hold the pipeline to; at ``interleave=2`` it needs
``interleave_pp`` to visit the layers in the interleaved order.

Replicated leaves get the same gradient on every stage by
construction, as in the JAX module: the embedded input enters the
pipeline through ``tp_region`` (identity forward, the group's sum of
the cotangent backward: only stage 0's injection has one), and the
pipeline's output reaches the head through ``last_stage_broadcast``,
so every stage computes the head on the same input.  The Trainer then
reduces them over the data (x seq) group alone, as under tensor
parallelism.

The block pins what a direct translation would get wrong: LayerNorm
statistics and affine in float32 with epsilon 1e-6 (``LN_EPS``, not
torch's 1e-5), GELU in its tanh form (``GELU_APPROXIMATE``: flax's
``nn.gelu`` default), parameters cast to the compute dtype at each
matmul, q/k/v made contiguous for the flash kernels (K1 forward, K3 or
K2a + K2b backward), float32 logits.

Remat: ``remat=True`` recomputes each block (``torch.utils.checkpoint``);
``remat_policy="dots"`` is the JAX selective policy through the
transformer's ``remat_context``: two checkpointed regions around the
attention, which saves its own residuals, so the matmul and flash
outputs are kept and the elementwise ops recomputed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from dtf_tpu_torch.models.partition import Split
from dtf_tpu_torch.models.transformer import remat_context
from dtf_tpu_torch.ops.flash_attention import flash_attention
from dtf_tpu_torch.parallel.collectives import tp_region
from dtf_tpu_torch.parallel.pipeline import (last_stage_broadcast,
                                             pipeline_spmd,
                                             pipeline_spmd_interleaved)

# parameter names that carry a leading stacked-layer dimension
BLOCK_PARAMS = ("ln1_s", "ln1_b", "qkv_k", "qkv_b", "out_k", "out_b",
                "ln2_s", "ln2_b", "fc1_k", "fc1_b", "fc2_k", "fc2_b")
# the block leaves a matmul reads, cast to the compute dtype
_MATMUL = ("qkv_k", "qkv_b", "out_k", "out_b", "fc1_k", "fc1_b", "fc2_k",
           "fc2_b")
LN_EPS = 1e-6                # the JAX module's _layernorm
GELU_APPROXIMATE = "tanh"    # flax nn.gelu's default form


def layer_norm(x, scale, bias):
    """The JAX ``_layernorm``: statistics, scale and bias in float32,
    the result in ``x``'s dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(),
                        bias.float(), LN_EPS).to(x.dtype)


def _dense(x, kernel, bias):
    """``x @ kernel + bias`` with a flax [in, out] kernel."""
    return F.linear(x, kernel.t()) + bias


class PipelinedTransformerLM(nn.Module):
    """Next-token LM with stacked blocks: tokens [B, S] -> logits
    [B, S, vocab] float32.

    ``model_parallelism`` pp > 1 builds pipeline stage ``model_index``
    of pp (its num_layers / pp local layers); the config attributes stay
    the full model's.  Such a stage runs only within its model group
    (:meth:`set_model_group`): its forward raises without one."""

    def __init__(self, vocab_size: int, num_layers: int = 12,
                 d_model: int = 512, num_heads: int = 8, d_ff: int = 2048,
                 max_seq_len: int = 2048, num_microbatches: int = 4,
                 dtype=torch.float32, remat: bool = False,
                 remat_policy: Optional[str] = None, interleave: int = 1,
                 interleave_pp: Optional[int] = None,
                 model_parallelism: int = 1, model_index: int = 0):
        super().__init__()
        pp = int(model_parallelism)
        if num_layers % pp:
            raise ValueError(f"num_layers {num_layers} not divisible by "
                             f"pipeline length {pp}")
        if not 0 <= model_index < pp:
            raise ValueError(f"model_index {model_index} outside "
                             f"0..{pp - 1}")
        if interleave not in (1, 2):
            raise ValueError(f"interleave must be 1 or 2, got {interleave}")
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"num_heads {num_heads}")
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.d_ff = d_ff
        self.max_seq_len = max_seq_len
        self.num_microbatches = int(num_microbatches)
        self.compute_dtype = dtype
        self.remat = remat or remat_policy is not None
        self.remat_context = (None if remat_policy is None
                              else remat_context(remat_policy))
        self.interleave = interleave
        self.interleave_pp = interleave_pp
        self.model_parallelism = pp
        self.model_index = int(model_index)
        self.model_group = None
        local = num_layers // pp
        width = 3 * d_model          # 3 * heads * head_dim
        shapes = dict(
            ln1_s=(local, d_model), ln1_b=(local, d_model),
            qkv_k=(local, d_model, width), qkv_b=(local, width),
            out_k=(local, d_model, d_model), out_b=(local, d_model),
            ln2_s=(local, d_model), ln2_b=(local, d_model),
            fc1_k=(local, d_model, d_ff), fc1_b=(local, d_ff),
            fc2_k=(local, d_ff, d_model), fc2_b=(local, d_model))
        self.embed = nn.Parameter(torch.zeros(vocab_size, d_model))
        self.pos_embed = nn.Parameter(torch.zeros(max_seq_len, d_model))
        for name in BLOCK_PARAMS:
            self.register_parameter(name,
                                    nn.Parameter(torch.zeros(shapes[name])))
        self.ln_f_s = nn.Parameter(torch.ones(d_model))
        self.ln_f_b = nn.Parameter(torch.zeros(d_model))
        self.head_k = nn.Parameter(torch.zeros(d_model, vocab_size))
        self.head_b = nn.Parameter(torch.zeros(vocab_size))

    @property
    def local_layers(self) -> int:
        return self.num_layers // self.model_parallelism

    def split(self, name: str) -> Optional[Split]:
        """The partition rule's sharded dimension of parameter ``name``:
        the layer dimension of a stacked block leaf between pipeline
        stages, None for a replicated leaf (and at pp 1)."""
        if self.model_parallelism == 1 or name not in BLOCK_PARAMS:
            return None
        return Split(0)

    def set_model_group(self, group) -> None:
        """The training stage's model axis (a process group of its
        model_parallelism ranks): the pipeline's stages."""
        self.model_group = group

    # ------------------------------------------------------------------
    # one block on [mb, S, d]
    # ------------------------------------------------------------------
    def _attn_in(self, h, p):
        """LayerNorm and the fused qkv projection: q, k, v contiguous
        [mb, S, H, Dh] each, the kernels' layout."""
        b, s, _ = h.shape
        hn = layer_norm(h, p["ln1_s"], p["ln1_b"])
        qkv = _dense(hn, p["qkv_k"], p["qkv_b"]).view(
            b, s, 3, self.num_heads, self.d_model // self.num_heads)
        return tuple(t.contiguous() for t in qkv.unbind(2))

    def _attn_out_mlp(self, h, o, p):
        b, s = o.shape[:2]
        h = h + _dense(o.reshape(b, s, self.d_model), p["out_k"], p["out_b"])
        hn = layer_norm(h, p["ln2_s"], p["ln2_b"])
        f = F.gelu(_dense(hn, p["fc1_k"], p["fc1_b"]),
                   approximate=GELU_APPROXIMATE)
        return h + _dense(f, p["fc2_k"], p["fc2_b"])

    def _block(self, h, p):
        q, k, v = self._attn_in(h, p)
        return self._attn_out_mlp(h, flash_attention(q, k, v, causal=True), p)

    def _step(self, h, p):
        if not (self.remat and torch.is_grad_enabled()):
            return self._block(h, p)
        ckpt = torch.utils.checkpoint.checkpoint
        if self.remat_context is None:
            return ckpt(self._block, h, p, use_reentrant=False)
        q, k, v = ckpt(self._attn_in, h, p, use_reentrant=False,
                       context_fn=self.remat_context)
        o = flash_attention(q, k, v, causal=True)
        return ckpt(self._attn_out_mlp, h, o, p, use_reentrant=False,
                    context_fn=self.remat_context)

    def _stage(self, h, layers):
        for p in layers:
            h = self._step(h, p)
        return h

    def _layers(self):
        """One dict of per-layer views a local layer: the matmul leaves
        cast to the compute dtype once a forward, the LayerNorm leaves
        float32."""
        dt = self.compute_dtype
        cols = {name: (getattr(self, name).to(dt) if name in _MATMUL
                       else getattr(self, name)).unbind(0)
                for name in BLOCK_PARAMS}
        return [{name: cols[name][i] for name in BLOCK_PARAMS}
                for i in range(self.local_layers)]

    # ------------------------------------------------------------------
    def forward(self, tokens):
        pp, group = self.model_parallelism, self.model_group
        if pp > 1 and group is None:
            raise ValueError(
                "a pipeline stage runs within its model group "
                "(set_model_group); the local run is the pp-1 twin")
        b, s = tokens.shape
        if s > self.max_seq_len:
            raise ValueError(f"sequence {s} exceeds max_seq_len "
                             f"{self.max_seq_len}")
        dt = self.compute_dtype
        x = (F.embedding(tokens, self.embed).to(dt)
             + self.pos_embed[:s].to(dt))
        layers = self._layers()
        if group is None:
            if self.interleave == 2:
                # the interleaved visitation order off the mesh: lap 0's
                # chunk of every stage, then lap 1's
                ipp = self.interleave_pp
                if not ipp or self.num_layers % (2 * ipp):
                    raise ValueError(
                        "interleave=2 off-mesh needs interleave_pp with "
                        "num_layers divisible by 2*interleave_pp")
                per = self.num_layers // ipp
                half = per // 2
                layers = [layers[dev * per + lap * half + i]
                          for lap in range(2) for dev in range(ipp)
                          for i in range(half)]
            h = self._stage(x, layers)
        else:
            m = self.num_microbatches
            if b % m:
                raise ValueError(f"per-shard batch {b} not divisible by "
                                 f"num_microbatches {m}")
            # identity forward, the group's sum backward: every stage
            # derives the same embedding gradient (module docstring)
            x = tp_region(x, group)
            xmb = x.reshape(m, b // m, s, self.d_model)
            if self.interleave == 2:
                local = self.local_layers
                if local % 2:
                    raise ValueError(
                        f"interleave=2 needs an even per-stage layer "
                        f"count, got {local}")
                half = local // 2
                h = pipeline_spmd_interleaved(
                    lambda a, lap: self._stage(
                        a, layers[lap * half:(lap + 1) * half]), xmb, group)
            else:
                h = pipeline_spmd(lambda a: self._stage(a, layers), xmb,
                                  group)
            h = last_stage_broadcast(h.reshape(b, s, self.d_model), group)
        h = layer_norm(h, self.ln_f_s, self.ln_f_b)
        return _dense(h, self.head_k.to(dt), self.head_b.to(dt)).float()
