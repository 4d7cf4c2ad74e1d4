"""The port's mixture-of-experts model (``dtf_tpu_torch/models/moe.py``)
against the JAX package's ``dtf_tpu/models/moe.py``, in one process on
the CPU: the routed MLP (one expert, capacity drops, top-1, the scatter
dispatch against the dense oracle, both against flax), the load-balance
term, the partition rule, the whole LM's logits and gradients, the
Trainer at world 1 (with and without ``remat_policy="dots"``) against
JAX's, the registry entries, the flags and the refusals, and ``lm_main``
training ``moe_transformer_small`` on the CPU.  Mirrors the
single-device cases of ``tests/test_moe.py``; the multi-rank ones are
``tests/test_torch_ep.py``.

Weights are drawn by flax and carried across by ``convert.py``; inputs
are drawn with numpy from a seed.  Tolerance: rtol 1e-5 in float32 (the
gradients of a sum of squares at rtol 1e-5 with an atol of 1e-5 of
their scale, as the JAX oracle test holds them).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.models.moe import MoEMLP as JaxMoEMLP
from dtf_tpu.models.moe import moe_param_partition_specs
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import lm_main, runner
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.data import get_dataset_spec
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.models.moe import MoEMLP, MoETransformerLM, expert_rule
from dtf_tpu_torch.models.partition import Split, shard_for
from test_torch_ep import (SEQ, TINY, VOCAB, _case_cfg, _draw, _jax_model,
                           _jax_trainer, _TinyRegistry, _weights)

torch.set_num_threads(1)

RTOL = 1e-5


def _port_mlp(jparams, **kw) -> MoEMLP:
    """A port MoEMLP holding the flax MoEMLP's ``jparams``."""
    e, d, ff = np.asarray(jparams["w1"]).shape
    m = MoEMLP(d, e, ff, **kw)
    with torch.no_grad():
        for name in ("w1", "b1", "w2", "b2"):
            getattr(m, name).copy_(torch.tensor(np.asarray(jparams[name])))
        m.router.weight.copy_(torch.tensor(
            np.asarray(jparams["router"]["kernel"])).t())
        m.router.bias.copy_(torch.tensor(np.asarray(
            jparams["router"]["bias"])))
    return m


def _both(x, **kw):
    """(flax layer, its params, the port's layer) at ``kw``."""
    layer = JaxMoEMLP(**kw)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(layer.init)(
        jax.random.key(0), jnp.asarray(x))["params"])
    port_kw = {k: v for k, v in kw.items()
               if k not in ("num_experts", "d_ff")}
    return layer, params, _port_mlp(params, **port_kw)


def _gelu(x):
    return jax.nn.gelu(x)


def _apply(layer, params, x):
    return jax.jit(layer.apply)({"params": params}, jnp.asarray(x))


def test_single_expert_equals_dense_mlp():
    """E = 1 routing degenerates to the plain MLP on the same weights,
    and to the flax layer's output (rtol 1e-5)."""
    x = np.random.default_rng(0).normal(size=(2, 8, 32)).astype(np.float32)
    layer, params, port = _both(x, num_experts=1, d_ff=64,
                                capacity_factor=100.0)
    y = port(torch.from_numpy(x)).detach().numpy()
    w1, b1 = params["w1"][0], params["b1"][0]
    w2, b2 = params["w2"][0], params["b2"][0]
    ref = np.asarray(_gelu(x @ w1 + b1)) @ w2 + b2
    np.testing.assert_allclose(y, ref, atol=1e-5, rtol=RTOL)
    np.testing.assert_allclose(
        y, np.asarray(_apply(layer, params, x)), atol=1e-6,
        rtol=RTOL)


def test_capacity_overflow_drops_tokens():
    """cap = 1 a expert: 2 experts x 1 slot of the 16 top-2 choices kept,
    the other 14 dropped (their MoE output 0); the flax layer's output
    exactly as far as float32 goes."""
    x = np.random.default_rng(1).normal(size=(1, 8, 8)).astype(np.float32)
    layer, params, port = _both(x, num_experts=2, d_ff=16,
                                capacity_factor=1 / 8)
    y = port(torch.from_numpy(x)).detach().numpy().reshape(8, 8)
    nonzero_rows = int(np.sum(np.any(np.abs(y) > 1e-9, axis=-1)))
    assert 1 <= nonzero_rows <= 4
    assert float(port.dropped) == 14 and port.routed == 16
    np.testing.assert_allclose(
        y, np.asarray(_apply(layer, params, x)).reshape(8, 8),
        atol=1e-6, rtol=RTOL)


def test_aux_loss_is_the_jax_sown_term():
    """The load-balance terms of a training forward (moe_every 1: both
    layers) sum to the flax model's sown ``aux_loss`` (rtol 1e-5), at
    least aux_weight x layers x 1 (balanced routing's floor); reading
    takes them, and an eval forward keeps none."""
    params, full = _draw(4)
    model = MoETransformerLM(vocab_size=VOCAB, num_experts=4,
                             capacity_factor=100.0, **TINY)
    model.load_state_dict(full)
    tokens = np.random.default_rng(2).integers(0, VOCAB, (2, SEQ))
    _, mutated = jax.jit(functools.partial(
        _jax_model(4, capacity_factor=100.0).apply, mutable=["aux_loss"]))(
        {"params": params}, jnp.asarray(tokens, jnp.int32))
    leaves = jax.tree_util.tree_leaves(mutated["aux_loss"])
    assert len(leaves) == 2
    want = float(sum(jnp.sum(a) for a in leaves))
    model.train()
    model(torch.from_numpy(tokens))
    got = float(model.aux_loss().detach())
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got >= 0.01 * 2 * 0.99
    assert float(model.aux_loss()) == 0.0
    model.eval()
    with torch.no_grad():
        model(torch.from_numpy(tokens))
    assert float(model.aux_loss()) == 0.0


def test_top1_switch_routing():
    """k = 1 (Switch): each kept token's output is its single expert's
    MLP output weighted by the raw router probability -- the numpy
    formula and the flax layer's output, rtol 1e-5."""
    x = np.random.default_rng(3).normal(size=(2, 4, 8)).astype(np.float32)
    layer, params, port = _both(x, num_experts=2, d_ff=16,
                                capacity_factor=100.0, router_top_k=1)
    y = port(torch.from_numpy(x)).detach().numpy().reshape(8, 8)
    tokens = x.reshape(8, 8)
    logits = tokens @ params["router"]["kernel"] + params["router"]["bias"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    choice = logits.argmax(-1)
    ref = np.stack([
        probs[i, c] * (np.asarray(_gelu(t @ params["w1"][c]
                                        + params["b1"][c]))
                       @ params["w2"][c] + params["b2"][c])
        for i, (t, c) in enumerate(zip(tokens, choice))])
    np.testing.assert_allclose(y, ref, atol=1e-5, rtol=RTOL)
    np.testing.assert_allclose(
        y, np.asarray(_apply(layer, params, x)).reshape(8, 8),
        atol=1e-6, rtol=RTOL)


def test_partition_rule_is_the_jax_rule():
    """``expert_rule`` splits dim 0 of w1/b1/w2/b2 under ``moe`` and
    replicates everything else -- leaf for leaf the JAX
    ``moe_param_partition_specs``; a shard's ``split`` applies it only
    when the experts are spread, and ``shard_for`` cuts each rank's
    experts under either placement."""
    full = MoETransformerLM(vocab_size=VOCAB, num_experts=4, **TINY)
    jparams = convert.to_flax_params(full)
    specs = convert.flatten(moe_param_partition_specs(jparams, "data"))
    for key, coll, path, _ in convert.leaves(full):
        split = expert_rule(key)
        assert (split == Split(0)) == (specs[path] != jax.sharding
                                       .PartitionSpec()), key
    assert full.split("block0.moe.w1") is None
    sd = full.state_dict()
    for axis in ("data", "model"):
        for index in (0, 1):
            shard = MoETransformerLM(vocab_size=VOCAB, num_experts=4,
                                     expert_axis=axis, expert_parallelism=2,
                                     expert_index=index, **TINY)
            assert shard.split("block1.moe.b2") == Split(0)
            assert shard.split("block1.moe.router.weight") is None
            assert shard.model_parallelism == (2 if axis == "model" else 1)
            part = shard_for(shard, sd)
            assert torch.equal(part["block0.moe.w1"],
                               sd["block0.moe.w1"][2 * index:2 * index + 2])
            assert torch.equal(part["block0.attn.qkv.weight"],
                               sd["block0.attn.qkv.weight"])
            shard.load_state_dict(part)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_scatter_dispatch_matches_dense_oracle(cf):
    """The scatter dispatch against the one-hot dense one in the port and
    the flax dense layer, with a capacity limit (capacity factor 0.5
    drops, 1.25 the slice's default): outputs rtol 1e-5 and gradients of
    a sum of squares rtol 1e-5 (atol 1e-5 of their scale)."""
    x = np.random.default_rng(0).normal(size=(2, 8, 32)).astype(np.float32)
    layer, params, scat = _both(x, num_experts=4, d_ff=16,
                                capacity_factor=cf)
    dense = _port_mlp(params, capacity_factor=cf, dispatch_mode="dense")
    jdense = JaxMoEMLP(num_experts=4, d_ff=16, capacity_factor=cf,
                       dispatch_mode="dense")

    def jloss(p):
        return jnp.sum(jnp.square(jdense.apply({"params": p}, x)))

    jy = np.asarray(_apply(jdense, params, x))
    jg = convert.flatten(jax.tree_util.tree_map(
        np.asarray, jax.grad(jloss)(params)))
    outs = {}
    for name, m in (("scatter", scat), ("dense", dense)):
        y = m(torch.from_numpy(x))
        y.square().sum().backward()
        outs[name] = y.detach().numpy()
        np.testing.assert_allclose(outs[name], jy, rtol=RTOL, atol=1e-6)
        for key in ("w1", "b1", "w2", "b2"):
            g = getattr(m, key).grad.numpy()
            np.testing.assert_allclose(
                g, jg[key], rtol=RTOL,
                atol=1e-5 * np.abs(jg[key]).max(), err_msg=key)
        np.testing.assert_allclose(
            m.router.weight.grad.numpy().T, jg["router/kernel"], rtol=RTOL,
            atol=1e-5 * np.abs(jg["router/kernel"]).max())
    np.testing.assert_allclose(outs["scatter"], outs["dense"], rtol=RTOL,
                               atol=1e-6)


def test_dense_dispatch_refuses_the_model_axis():
    with pytest.raises(ValueError, match="dense dispatch implements the "
                       "along-batch"):
        MoEMLP(32, 4, 64, dispatch_mode="dense", expert_axis="model",
               expert_parallelism=2)
    with pytest.raises(ValueError, match="unknown dispatch_mode"):
        MoEMLP(32, 4, 64, dispatch_mode="sparse")
    with pytest.raises(ValueError, match="not divisible by expert-parallel"):
        MoEMLP(32, 4, 64, expert_axis="data", expert_parallelism=3)
    with pytest.raises(ValueError, match="router_top_k 0 must be >= 1"):
        MoEMLP(32, 4, 64, router_top_k=0)


@pytest.mark.parametrize("mode", ["scatter", "dense"])
def test_lm_logits_and_grads_match_jax(mode):
    """The whole tiny MoE LM at world 1: logits and the gradients of a
    loss against the flax model's (rtol 1e-5), both dispatches."""
    params, full = _draw(4)
    model = MoETransformerLM(vocab_size=VOCAB, num_experts=4,
                             capacity_factor=1.25, dispatch_mode=mode,
                             **TINY)
    model.load_state_dict(full)
    jmodel = _jax_model(4, capacity_factor=1.25, dispatch_mode=mode)
    tokens = np.random.default_rng(4).integers(0, VOCAB, (4, SEQ))

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens, jnp.int32))
        return jnp.mean(jax.nn.log_softmax(logits)[..., 0] * -1.0), logits

    (_, jlogits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    logits = model(torch.from_numpy(tokens))
    (-torch.log_softmax(logits, -1)[..., 0].mean()).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=1e-5)
    want = convert.from_flax_params(jax.tree_util.tree_map(np.asarray, g),
                                    model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=1e-6, err_msg=name)


def _world1_losses(flags: dict, x, y) -> list:
    """The port's Trainer at world 1 (``--distribution_strategy off``)
    over the batches (x, y) from the flax-drawn weights."""
    params, full = _draw(4)
    cfg = Config(**_case_cfg(dict(flags, distribution_strategy="off")))
    with _TinyRegistry(), _weights(full):
        trainer, state, _, _ = runner.build_training(cfg)
    losses = []
    for step in range(len(x)):
        state, m = trainer.train_step(state, torch.from_numpy(x[step]),
                                      torch.from_numpy(y[step]))
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("flags", [{}, dict(moe_capacity_factor=1.25)],
                         ids=["cf100", "cf125"])
def test_trainer_at_world1_matches_jax(flags):
    """The port's Trainer at world 1 (the load-balance term in the
    objective and the reported loss) against JAX's Trainer on one
    device: per-step losses rtol 1e-5, with and without drops."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, VOCAB, (3, 8, SEQ)).astype(np.int32)
    y = np.roll(x, -1, 2)
    params, _ = _draw(4)
    trainer, rt, state = _jax_trainer(1, flags, {"x": x, "y": y,
                                                 "params": {4: params}})
    jl = []
    for step in range(3):
        state, m = trainer.train_step(state, *rt.shard_batch((x[step],
                                                              y[step])))
        jl.append(float(m["loss"]))
    np.testing.assert_allclose(_world1_losses(flags, x, y), jl, rtol=RTOL)


def test_remat_policy_dots_matches_no_remat():
    """``--remat_policy dots`` and ``--remat`` on the MoE family at world
    1: the no-remat trajectory within rtol 1e-6 (the routing is
    recomputed to the same choices)."""
    rng = np.random.default_rng(6)
    x = rng.integers(0, VOCAB, (3, 8, SEQ)).astype(np.int32)
    y = np.roll(x, -1, 2)
    none = _world1_losses({}, x, y)
    np.testing.assert_allclose(_world1_losses(dict(remat_policy="dots"),
                                              x, y), none, rtol=1e-6)
    np.testing.assert_allclose(_world1_losses(dict(remat=True), x, y),
                               none, rtol=1e-6)


# ---------------------------------------------------------------------------
# the registry, the flags, the CLI and the refusals
# ---------------------------------------------------------------------------

def test_moe_family_is_an_lm_with_the_jax_presets():
    """The registry's MoE entries build the MoE LM with the JAX
    defaults (12 layers, d 512, 8 heads, d_ff 2048, 8 experts every
    second block, top-2, capacity factor 1.25, aux weight 0.01, vocab
    32768, no L2; the small preset 4 layers, d 256, 4 heads, d_ff 1024,
    4 experts) and take the LM's random init, never a vision model's."""
    assert not registry.is_vision("moe_transformer")
    assert registry.is_moe("moe_transformer_small")
    model, l2 = registry.build_model("moe_transformer")
    assert l2 == 0.0
    assert (model.num_layers, model.d_model, model.num_heads, model.d_ff,
            model.num_experts, model.moe_every, model.router_top_k,
            model.capacity_factor, model.aux_weight, model.vocab_size,
            model.max_seq_len) == (12, 512, 8, 2048, 8, 2, 2, 1.25, 0.01,
                                   32768, 2048)
    assert len(model.moe_layers) == 6 and hasattr(model.block1, "moe")
    small, _ = registry.build_model("moe_transformer_small")
    assert (small.num_layers, small.d_model, small.num_heads, small.d_ff,
            small.num_experts) == (4, 256, 4, 1024, 4)
    spec = dataclasses.replace(get_dataset_spec("lm"), num_classes=256,
                               seq_len=32)
    built, _ = runner.build_model_for(
        Config(model="moe_transformer_small", num_classes=256,
               device="cpu", num_experts=8, moe_top_k=1),
        spec, torch.device("cpu"))
    assert isinstance(built, MoETransformerLM)
    assert (built.num_experts, built.router_top_k) == (8, 1)
    assert built.expert_axis == "data" and built.expert_parallelism == 1
    assert abs(float(built.pos_embed.detach().std()) - 0.02) < 2e-3
    assert float(built.block1.moe.b1.detach().abs().max()) == 0.0
    std = float(built.block1.moe.w2.detach().std())
    assert abs(std - 1024 ** -0.5) < 0.1 * 1024 ** -0.5


def test_moe_flags_parse_with_the_jax_defaults_and_validation():
    """The four MoE flags parse (None: the preset's own), as the JAX
    Config declares them; ``moe_top_k`` below 1 is refused with the JAX
    message; no flag is left unported."""
    from dtf_tpu.config.flags import define_flags
    from dtf_tpu_torch.config.flags import NOT_PORTED
    jax_defaults = define_flags()
    cfg = parse_flags(["--num_experts", "16", "--moe_capacity_factor",
                       "2.0", "--moe_aux_weight", "0.1", "--moe_top_k",
                       "1"])
    assert (cfg.num_experts, cfg.moe_capacity_factor, cfg.moe_aux_weight,
            cfg.moe_top_k) == (16, 2.0, 0.1, 1)
    for name in ("num_experts", "moe_capacity_factor", "moe_aux_weight",
                 "moe_top_k"):
        assert getattr(Config(), name) is None is jax_defaults[name]
    with pytest.raises(ValueError, match="moe_top_k must be >= 1, got 0"):
        parse_flags(["--moe_top_k", "0"])
    assert NOT_PORTED == {}


@pytest.mark.parametrize("model", ["moe_transformer",
                                   "moe_transformer_small"])
def test_fp16_with_the_moe_family_is_refused(model):
    """The MoE family runs the attention kernels, which have no fp16
    route: --dtype fp16 is refused as for the transformers."""
    with pytest.raises(ValueError, match="float32 and bfloat16 routes"):
        parse_flags(["--model", model, "--dtype", "fp16"])
    assert parse_flags(["--model", model, "--dtype", "bf16"]).dtype == "bf16"


def test_shard_lm_head_with_the_moe_family_is_refused():
    """--shard_lm_head is the plain transformer's (the MoE family has no
    model_axis for its head): with experts on the model axis it raises
    the JAX message."""
    spec = get_dataset_spec("lm")
    with pytest.raises(ValueError, match="--shard_lm_head needs the plain "
                       "transformer family with --model_parallelism > 1"):
        runner.build_model_for(Config(model="moe_transformer_small",
                                      model_parallelism=2,
                                      shard_lm_head=True, device="cpu"),
                               spec, torch.device("cpu"))


def test_async_ps_refuses_the_moe_family(tmp_path):
    """The async parameter server trains single-device workers: the MoE
    family, built through the runner, is refused there (the JAX
    message)."""
    with pytest.raises(ValueError, match="is not supported in async "
                       "parameter-server mode"):
        runner.run(Config(model="moe_transformer_small", dataset="lm",
                          device="cpu", use_synthetic_data=True,
                          num_classes=256, seq_len=32, batch_size=2,
                          train_steps=1, skip_eval=True,
                          skip_checkpoint=True, model_dir=str(tmp_path),
                          distribution_strategy="parameter_server",
                          ps_mode="async"))


@pytest.mark.parametrize("argv", [[], ["--num_experts", "4",
                                       "--moe_top_k", "1"]],
                         ids=["default", "top1"])
def test_lm_main_trains_moe_small_on_the_cpu(argv):
    """``lm_main --model moe_transformer_small --device cpu``: finite,
    falling losses (also at top-1)."""
    stats = lm_main.main([
        "--use_synthetic_data", "--device", "cpu", "--model",
        "moe_transformer_small", "--seq_len", "32", "--num_classes", "256",
        "--batch_size", "4", "--train_steps", "4", "--log_steps", "1",
        "--dtype", "fp32", "--skip_checkpoint"] + argv)
    losses = [v for _, v in stats["train_loss_log"]]
    assert len(losses) == 4 and all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
