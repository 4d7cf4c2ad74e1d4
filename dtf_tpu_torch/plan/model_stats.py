"""Model characterization for the planner — per-layer param counts,
forward FLOPs, and activation-byte estimates, derived from the existing
model configs (transformer + resnet families).

The port's copy of ``dtf_tpu/plan/model_stats.py``: it reads the port's
registry (``dtf_tpu_torch/models/registry.py``), whose entries take the
same keywords, and a constructor's defaults from its signature (the
port's models are ``nn.Module`` classes, not dataclasses).  The counts
and their arithmetic are the JAX package's, and so are the refusals
(MoE, ``trivial``).

Everything is computed from the registry's construction parameters
(``models.registry._REGISTRY`` partial keywords + module class
defaults), so ``characterize("transformer_small")`` describes exactly
the model ``build_model("transformer_small")`` builds.  Param counts
are EXACT for the transformer and ResNet families (test-pinned against
the port model's ``sum(p.numel())``); FLOPs count
matmul/conv MACs × 2 (elementwise work is ignored — it is neither the
compute nor the memory term that decides a plan); activation bytes
approximate the saved-for-backward set per example (flash attention
saves no S×S score matrix, so attention contributes O(S·d), not O(S²)).

Per-layer fields the cost model consumes:
  params / state    — trainable / non-trainable (BN stats) element count
  flops             — forward FLOPs per example
  act_bytes         — saved activation bytes per example, no remat
  act_tp_bytes      — the portion of act_bytes that divides by the
                      tensor-parallel degree (ff/head-sharded
                      intermediates; the residual-stream tensors stay
                      replicated under Megatron TP)
  remat_act_bytes   — bytes still saved when the layer is remat'd
                      (the block input)
  tp / stage        — whether params shard over the 'model' axis under
                      tensor parallelism / belong to the pipeline-
                      stacked blocks
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerStats:
    name: str
    params: int = 0
    state: int = 0            # non-trainable elements (BN running stats)
    flops: int = 0            # forward FLOPs per example
    act_bytes: int = 0        # saved activations per example (no remat)
    act_tp_bytes: int = 0     # portion of act_bytes dividing by TP ways
    remat_act_bytes: int = 0  # saved per example when remat'd
    tp: bool = False          # params shard over the 'model' axis
    stage: bool = False       # pipeline-stacked block (stage-shardable)


@dataclasses.dataclass(frozen=True)
class ModelStats:
    model: str
    family: str               # transformer | pipeline_transformer |
                              # moe_transformer | resnet | cifar_resnet
    layers: Tuple[LayerStats, ...]
    seq_len: int = 0          # 0 for vision
    num_layers: int = 0       # stacked-block count (pipeline divisor)
    num_heads: int = 0        # TP divisibility constraint
    d_ff: int = 0             # TP divisibility constraint
    d_model: int = 0
    dtype_bytes: int = 4

    # -- capability surface (mirrors what cli/runner.py accepts) -------
    @property
    def supports_tp(self) -> bool:
        return self.family == "transformer"

    @property
    def supports_seq(self) -> bool:
        return self.family == "transformer" and self.seq_len > 0

    @property
    def supports_pipeline(self) -> bool:
        return self.family == "pipeline_transformer"

    @property
    def supports_remat(self) -> bool:
        # runner.py: transformer families take --remat; of the vision
        # family only resnet50 has a remat policy
        return self.family in ("transformer", "pipeline_transformer",
                               "resnet")

    # -- totals --------------------------------------------------------
    @property
    def params(self) -> int:
        return sum(l.params for l in self.layers)

    @property
    def state(self) -> int:
        return sum(l.state for l in self.layers)

    @property
    def flops(self) -> int:
        return sum(l.flops for l in self.layers)

    @property
    def act_bytes(self) -> int:
        return sum(l.act_bytes for l in self.layers)


def _model_ctor_kwargs(name: str) -> dict:
    """Construction parameters of a registry entry: the partial's
    keywords over the module class's constructor defaults."""
    from dtf_tpu_torch.models import registry

    if name not in registry._REGISTRY:
        raise ValueError(f"unknown model {name!r}; have "
                         f"{sorted(registry._REGISTRY)}")
    ctor = registry._REGISTRY[name][0]
    kw = {}
    if isinstance(ctor, functools.partial):
        kw = dict(ctor.keywords)
        ctor = ctor.func
    for pname, param in inspect.signature(ctor).parameters.items():
        if pname not in kw and param.default is not inspect.Parameter.empty:
            kw[pname] = param.default
    return kw


def characterize(model_name: str, *, seq_len: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 dtype_bytes: int = 4) -> ModelStats:
    """Per-layer stats for a registry model at a run's shapes.

    ``seq_len`` is the RUN's sequence length (defaults to the LM
    dataset's 2048); ``num_classes`` the vocabulary / class count
    (defaults to the registry default); ``dtype_bytes`` the compute
    dtype width (2 for bf16) — param storage is always counted f32 by
    the cost model, this only scales activations."""
    from dtf_tpu_torch.models import registry

    if model_name.startswith("moe_transformer"):
        raise ValueError(
            f"model {model_name!r}: the planner does not model routed-"
            f"expert capacity/all_to_all traffic — plan MoE runs by hand")
    if model_name == "trivial":
        raise ValueError("model 'trivial' is a smoke artifact; there is "
                         "nothing to plan")
    default_classes = (registry._REGISTRY[model_name][1]
                       if model_name in registry._REGISTRY else None)
    if model_name.startswith(("transformer", "pipeline_transformer")):
        vocab = num_classes or default_classes
        return _characterize_transformer(model_name, vocab,
                                         seq_len or 2048, dtype_bytes)
    if model_name == "resnet50":
        return _characterize_resnet50(num_classes or default_classes,
                                      dtype_bytes)
    if model_name.startswith("resnet"):
        return _characterize_cifar_resnet(model_name,
                                          num_classes or default_classes,
                                          dtype_bytes)
    raise ValueError(f"unknown model {model_name!r}")


# ---------------------------------------------------------------------------
# Transformer family (models/transformer.py, models/pipeline_lm.py)
# ---------------------------------------------------------------------------

def _characterize_transformer(name: str, vocab: int, seq: int,
                              dt: int) -> ModelStats:
    kw = _model_ctor_kwargs(name)
    L, d = kw["num_layers"], kw["d_model"]
    heads, ff = kw["num_heads"], kw["d_ff"]
    max_seq = kw.get("max_seq_len", 2048)
    family = ("pipeline_transformer" if name.startswith("pipeline")
              else "transformer")
    layers = [
        # embed V·d + learned pos table max_seq_len·d; act: the [S, d]
        # embedded stream
        LayerStats("embed", params=vocab * d + max_seq * d,
                   flops=0, act_bytes=seq * d * dt),
    ]
    # one block: ln1 2d | qkv d·3d+3d | out d·d (no bias) | ln2 2d |
    # fc1 d·ff+ff | fc2 ff·d (no bias)
    blk_params = (2 * d) + (3 * d * d + 3 * d) + (d * d) + (2 * d) \
        + (d * ff + ff) + (ff * d)
    # matmul MACs ×2; causal flash attention does S²/2·d score MACs and
    # the same again for the value aggregation → 2·S²·d FLOPs total
    blk_flops = 2 * seq * d * (4 * d + 2 * ff) + 2 * seq * seq * d
    # saved-for-backward per example: residual stream x, ln1, attn_out,
    # ln2 (replicated under TP) + qkv, pre-projection heads, fc1 out,
    # gelu out (these shard over the TP ways)
    act_rep = 4 * seq * d * dt
    act_tp = (4 * seq * d + 2 * seq * ff) * dt
    for i in range(L):
        layers.append(LayerStats(
            f"block{i}", params=blk_params, flops=blk_flops,
            act_bytes=act_rep + act_tp, act_tp_bytes=act_tp,
            remat_act_bytes=seq * d * dt, tp=True, stage=True))
    # ln_f 2d; lm_head d·V+V; the f32 logits [S, V] are the single
    # largest activation of a small-model step — counted here
    layers.append(LayerStats(
        "head", params=2 * d + d * vocab + vocab,
        flops=2 * seq * d * vocab,
        act_bytes=seq * d * dt + seq * vocab * 4,
        remat_act_bytes=seq * d * dt + seq * vocab * 4))
    return ModelStats(model=name, family=family, layers=tuple(layers),
                      seq_len=seq, num_layers=L, num_heads=heads,
                      d_ff=ff, d_model=d, dtype_bytes=dt)


# ---------------------------------------------------------------------------
# Vision families (models/resnet_cifar.py, models/resnet.py)
# ---------------------------------------------------------------------------

def _conv(name: str, k: int, cin: int, cout: int, hout: int, dt: int,
          with_bn: bool = True, **extra) -> LayerStats:
    """3×3/1×1 conv (+BN) layer: params k²·cin·cout (+2·cout BN params,
    2·cout running stats); FLOPs 2·k²·cin·cout·H·W at the OUTPUT
    resolution; saved activations ≈ conv output + post-BN/ReLU copy."""
    return LayerStats(
        name,
        params=k * k * cin * cout + (2 * cout if with_bn else 0),
        state=2 * cout if with_bn else 0,
        flops=2 * k * k * cin * cout * hout * hout,
        act_bytes=2 * hout * hout * cout * dt,
        remat_act_bytes=hout * hout * cout * dt, **extra)


def _characterize_cifar_resnet(name: str, classes: int, dt: int
                               ) -> ModelStats:
    n = _model_ctor_kwargs(name)["num_blocks"]
    layers = [_conv("conv1", 3, 3, 16, 32, dt)]
    specs = ((16, 16, 32), (16, 32, 16), (32, 64, 8))  # cin, cout, H
    for s, (cin, cout, h) in enumerate(specs, start=2):
        for b in range(n):
            cb = cout if b else cin
            block = [_conv(f"stage{s}_block{b}_conv_a", 3, cb, cout, h, dt),
                     _conv(f"stage{s}_block{b}_conv_b", 3, cout, cout, h,
                           dt)]
            if b == 0:  # projection shortcut (1×1 conv + BN)
                block.append(_conv(f"stage{s}_block{b}_proj", 1, cin,
                                   cout, h, dt))
            layers.extend(block)
    layers.append(LayerStats("fc", params=64 * classes + classes,
                             flops=2 * 64 * classes,
                             act_bytes=(64 + classes) * dt))
    return ModelStats(model=name, family="cifar_resnet",
                      layers=tuple(layers), num_layers=3 * n)


def _characterize_resnet50(classes: int, dt: int) -> ModelStats:
    layers = [_conv("conv1", 7, 3, 64, 112, dt)]
    h = 56  # after the 3×3/2 max-pool
    cin = 64
    for s, (f, blocks) in enumerate(((64, 3), (128, 4), (256, 6),
                                     (512, 3)), start=1):
        if s > 1:
            h //= 2  # the stage's stride-2 sits on block0's 3×3 conv
        for b in range(blocks):
            cb = cin if b == 0 else 4 * f
            pre = [_conv(f"stage{s}_block{b}_conv_a", 1, cb, f, h, dt),
                   _conv(f"stage{s}_block{b}_conv_b", 3, f, f, h, dt),
                   _conv(f"stage{s}_block{b}_conv_c", 1, f, 4 * f, h, dt)]
            if b == 0:
                pre.append(_conv(f"stage{s}_block{b}_proj", 1, cb, 4 * f,
                                 h, dt))
            layers.extend(pre)
        cin = 4 * f
    layers.append(LayerStats("fc", params=2048 * classes + classes,
                             flops=2 * 2048 * classes,
                             act_bytes=(2048 + classes) * dt))
    return ModelStats(model="resnet50", family="resnet",
                      layers=tuple(layers), num_layers=16)
