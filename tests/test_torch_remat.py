"""The port's rematerialization (dtf_tpu_torch: ``models/transformer.py``
``remat_policy="dots"`` and ``remat=True``, ``models/resnet.py``'s
selective policy, their wiring in ``cli/runner.py``) against the port's
run without remat and against the JAX package, on the CPU.

Recomputing deterministic ops on the same inputs gives the same bits,
so every remat arm's losses, gradients and BN buffers equal the run
without remat bit for bit.  Against the JAX remat Trainer (``dots`` and
full remat, float32) the per-step losses agree within 1e-5 relative,
the tolerance of ``tests/test_torch_train.py``; a bottleneck block
under each package's ResNet policy agrees within 1e-5 of each leaf's
largest value (``tests/test_torch_resnet.py``'s gate for the plain
block).  What each policy
recomputes is pinned by counting the ops that run during the backward
under a dispatch mode: ``dots`` runs no biased matmul again and K1 (the
flash forward; its plain version here) once a block; the ResNet policy
runs no convolution again.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dtf_tpu.data.base as jdata_base
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.runtime import initialize
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.data import base as data_base
from dtf_tpu_torch.models import resnet
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.ops import flash_attention as fa
from dtf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

VOCAB, SEQ, BATCH = 64, 16, 4
DIMS = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
            d_ff=64, max_seq_len=SEQ)
JAX_TINY = dataclasses.replace(jdata_base.LM, num_classes=VOCAB, seq_len=SEQ,
                               num_train=64, num_eval=16)
TINY = dataclasses.replace(data_base.LM, num_classes=VOCAB, seq_len=SEQ,
                           num_train=64, num_eval=16)
ARMS = {"none": {}, "dots": {"remat_policy": "dots"},
        "remat": {"remat": True}}


class OpCount(TorchDispatchMode):
    """Counts each aten op that runs while it is active."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] = self.n.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def _tokens(seed=3):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (BATCH, SEQ))
    return torch.from_numpy(toks), torch.from_numpy(np.roll(toks, -1, 1))


def _lm_step(arm, monkeypatch):
    """(loss, gradients, K1 calls, ops run in the backward) of one step
    of the seeded LM under ``arm``."""
    calls = []
    real = fa.flash_forward

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(fa, "flash_forward", counted)
    torch.manual_seed(0)
    model = TransformerLM(**DIMS, **ARMS[arm])
    x, y = _tokens()
    loss = torch.nn.functional.cross_entropy(model(x).flatten(0, 1),
                                             y.flatten())
    ops = OpCount()
    with ops:
        loss.backward()
    return loss, [p.grad for p in model.parameters()], len(calls), ops.n


@pytest.mark.parametrize("arm", ["dots", "remat"])
def test_lm_remat_is_bit_identical_to_no_remat(arm, monkeypatch):
    loss0, grads0, k1_none, ops0 = _lm_step("none", monkeypatch)
    loss, grads, k1, ops = _lm_step(arm, monkeypatch)
    assert torch.equal(loss, loss0)
    for a, b in zip(grads, grads0):
        assert torch.equal(a, b)
    layers = DIMS["num_layers"]
    assert k1_none == layers
    # dots: K1 once a block (the flash residuals are saved); full remat
    # runs each block's forward, K1 included, again
    assert k1 == layers * (1 if arm == "dots" else 2)
    # both recompute LayerNorm and GELU in the backward; only full remat
    # runs the biased matmuls (qkv, fc1) again
    assert ops0.get("aten.native_layer_norm.default", 0) == 0
    assert ops.get("aten.native_layer_norm.default", 0) == 2 * layers
    assert ops.get("aten.gelu.default", 0) == layers
    assert ops.get("aten.addmm.default", 0) == (0 if arm == "dots"
                                                else 2 * layers)


def test_unknown_remat_policy_raises_the_jax_message():
    from dtf_tpu.models.transformer import remat_policy as jax_policy
    with pytest.raises(ValueError) as port:
        TransformerLM(**DIMS, remat_policy="everything")
    with pytest.raises(ValueError) as ref:
        jax_policy("everything")
    assert str(port.value) == str(ref.value)


@pytest.fixture
def tiny_lm_spec(monkeypatch):
    monkeypatch.setitem(jdata_base._SPECS, "lm", JAX_TINY)


def _trainers(arm):
    """(jax trainer, its runtime and state, port trainer and state) of
    the same JAX-initialized LM under ``arm``."""
    common = dict(batch_size=BATCH, train_steps=3, dataset="lm",
                  use_synthetic_data=True, skip_eval=True,
                  optimizer="adamw", **ARMS[arm])
    jcfg = JaxConfig(model="transformer", skip_checkpoint=True, model_dir="",
                     distribution_strategy="off", num_devices=1, **common)
    rt = initialize(jcfg)
    jmodel = JaxLM(**DIMS, remat=jcfg.remat or bool(jcfg.remat_policy),
                   remat_policy=jcfg.remat_policy)
    jtrainer = JaxTrainer(jcfg, rt, jmodel, 0.0, JAX_TINY)
    x, y = _tokens()
    jstate = jtrainer.init_state(jax.random.key(0), (x.numpy(), y.numpy()))
    cfg = Config(device="cpu", **common)
    model = TransformerLM(**DIMS, **ARMS[arm])
    model.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), model))
    trainer = Trainer(cfg, model, 0.0, TINY)
    return jtrainer, rt, jstate, trainer, trainer.init_state()


@pytest.mark.parametrize("arm", ["dots", "remat"])
def test_lm_remat_trainer_matches_jax_remat_trainer_f32(tiny_lm_spec, arm):
    """Three AdamW steps of the JAX remat Trainer and the port's under
    the same arm: losses within 1e-5; the port's arm equals its own run
    without remat bit for bit, step by step."""
    x, y = _tokens()
    jtrainer, rt, jstate, trainer, state = _trainers(arm)
    _, _, _, plain, plain_state = _trainers("none")
    for _ in range(3):
        jstate, jm = jtrainer.train_step(jstate, *rt.shard_batch(
            (x.numpy(), y.numpy())))
        state, m = trainer.train_step(state, x, y)
        plain_state, pm = plain.train_step(plain_state, x, y)
        assert torch.equal(m["loss"], pm["loss"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    for a, b in zip(trainer.model.parameters(), plain.model.parameters()):
        assert torch.equal(a, b)


def _resnet_step(remat: bool):
    model = resnet.ResNet50(num_classes=10, remat=remat).init_weights(0)
    model = model.to(memory_format=torch.channels_last).train()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    loss = model(x).square().mean()
    ops = OpCount()
    with ops:
        loss.backward()
    return (loss, [p.grad for p in model.parameters()],
            [b.clone() for b in model.buffers()], ops.n)


def test_resnet_policy_recomputes_no_convolution():
    """RESNET_REMAT_POLICY: the convolution outputs and the BN
    statistics are saved, so the backward runs no convolution (only
    their gradients) but recomputes the normalize/ReLU chains; the
    running statistics move once; every bit equals the run without
    remat."""
    loss0, grads0, buffers0, ops0 = _resnet_step(False)
    loss, grads, buffers, ops = _resnet_step(True)
    assert torch.equal(loss, loss0)
    for a, b in zip(grads + buffers, grads0 + buffers0):
        assert torch.equal(a, b)
    assert ops.get("aten.convolution.default", 0) == 0
    assert ops.get("aten.convolution_backward.default", 0) == ops0.get(
        "aten.convolution_backward.default") == 53
    # the normalize/ReLU chains of the 16 blocks ran again, and the
    # batch statistics' reductions did not
    assert ops0.get("aten.relu.default", 0) == 0
    assert ops.get("aten.relu.default", 0) == 3 * 16
    assert ops.get("aten.mean.dim", 0) == 0


@pytest.mark.parametrize("case", ["proj_s2", "identity"])
def test_remat_bottleneck_block_matches_the_jax_remat_block(case):
    """The block under each package's selective policy (flax's
    ``nn.remat(BottleneckBlock, policy=RESNET_REMAT_POLICY)``) in train
    mode: output, parameter gradients and BN buffers within 1e-5, as
    ``tests/test_torch_resnet.py`` holds the plain block."""
    from flax import linen as nn

    from dtf_tpu.models import resnet as jresnet
    from test_torch_resnet import (BLOCK_CASES, _assert_trees, _grad_tree,
                                   _load, _nchw, _nhwc, _rng)
    cin, proj, stride = BLOCK_CASES[case]
    rng = _rng(7)
    x = rng.normal(size=(2, 6, 6, cin)).astype(np.float32)
    jblock = nn.remat(jresnet.BottleneckBlock,
                      policy=jresnet.RESNET_REMAT_POLICY, prevent_cse=False,
                      static_argnums=(2,))((8, 8, 32), strides=stride,
                                           projection=proj)
    # nn.remat's static_argnums counts ``train`` as positional
    variables = jblock.init(jax.random.key(1), jax.numpy.asarray(x), False)
    out_shape = jax.eval_shape(lambda: jblock.apply(
        variables, jax.numpy.asarray(x), False)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    def loss(params):
        y, mutated = jblock.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jax.numpy.asarray(x), True, mutable=["batch_stats"])
        return (y * cot).sum(), (y, mutated)

    (_, (y, mutated)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    block = _load(resnet.BottleneckBlock(cin, (8, 8, 32), strides=stride,
                                         projection=proj, remat=True),
                  variables).train()
    out = block(_nchw(x))
    (out * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(_nhwc(out), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    _assert_trees(_grad_tree(block), jax.tree_util.tree_map(
        np.array, grads), 1e-5, "grad")
    _assert_trees(convert.to_flax_vision(block)[1], jax.tree_util.tree_map(
        np.array, mutated["batch_stats"]), 1e-5, "batch_stats")


def test_resnet_remat_is_training_only():
    """Eval mode (and no_grad) runs the blocks plainly, as nn.remat
    applies only under ``train``."""
    model = resnet.ResNet50(num_classes=10, remat=True).init_weights(0)
    model.eval()
    x = torch.zeros(1, 32, 32, 3)
    ops = OpCount()
    with ops, torch.no_grad():
        model(x)
    assert ops.n.get("aten.convolution.default") == 53
    assert not any("checkpoint" in k for k in ops.n)


def test_runner_builds_the_vision_remat_as_the_jax_runner_does():
    """--remat on resnet50 builds the selective policy; --remat_policy
    there, and --remat on another vision model, raise the JAX errors."""
    spec = data_base.get_dataset_spec("imagenet")
    cfg = Config(device="cpu", model="resnet50", dataset="imagenet",
                 remat=True)
    model, _ = runner.build_model_for(cfg, spec, torch.device("cpu"))
    blocks = [getattr(model, n) for n in model.block_names]
    assert len(blocks) == 16 and all(b.remat for b in blocks)
    with pytest.raises(ValueError, match="--remat_policy applies to the "
                                         "transformer families"):
        runner.build_model_for(cfg.replace(remat_policy="dots"), spec,
                               torch.device("cpu"))
    cifar = data_base.get_dataset_spec("cifar10")
    with pytest.raises(ValueError, match="--remat is implemented for the "
                                         "transformer families and "
                                         "resnet50, not 'resnet20'"):
        runner.build_model_for(Config(device="cpu", model="resnet20",
                                      remat=True), cifar,
                               torch.device("cpu"))
    lm = runner.build_model_for(
        Config(device="cpu", model="transformer_small", num_classes=VOCAB,
               remat_policy="dots"), TINY, torch.device("cpu"))[0]
    assert lm.remat and lm.remat_context is not None
