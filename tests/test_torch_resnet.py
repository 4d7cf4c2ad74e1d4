"""The port's vision models (dtf_tpu_torch.models.resnet, resnet_cifar,
trivial), their weight conversion and their training step against the
JAX package, on the CPU.

Inputs come from a numpy seed and go through both packages; the JAX
models are initialized by flax and their ``params`` and ``batch_stats``
carried into the port by ``convert.from_flax_vision``.  The port's
models take the same NHWC batches.

Tolerances: BatchNorm and the 'SAME' window ops 1e-6 (float32, the same
operations in another summation order); the stems and a bottleneck
block 1e-5; resnet20 logits 1e-5 and gradients 1e-4 of each leaf's
largest |value|; ResNet-50 logits 1e-4; three Trainer steps 1e-5
relative on the loss in float32 and 5e-3 in bf16 (bf16 rounds at other
places in the two frameworks), the parameters after them 1e-4 of each
leaf's largest |value| plus 1e-2 of the learning rate; bf16 BatchNorm
outputs one bf16 step.
"""

import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.data import base as jdata_base
from dtf_tpu.models import resnet as jresnet
from dtf_tpu.models import resnet_cifar as jcifar
from dtf_tpu.models import trivial as jtrivial
from dtf_tpu.runtime import initialize
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu_torch import convert
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.data import base as data_base
from dtf_tpu_torch.models import registry, resnet, resnet_cifar, trivial
from dtf_tpu_torch.train import loop
from dtf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _np(tree):
    """A tree of writable numpy copies."""
    return jax.tree_util.tree_map(np.array, tree)


def _init(jmodel, seed, x):
    return jmodel.init(jax.random.key(seed), jnp.asarray(x), train=False)


def _random_variables(jmodel, x, seed):
    """Variables of ``jmodel``'s tree drawn with numpy (flax's own init
    of a whole ResNet dispatches op by op for seconds): kernels
    N(0, 1/fan_in), BN scales U(0.5, 1.5) and biases N(0, 0.1), running
    means N(0, 0.1) and variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.key(0), jnp.asarray(x))
    rng = _rng(seed)

    def draw(path, sds):
        key = path[-1].key
        shape = sds.shape
        if key == "kernel":
            return rng.normal(0, (1 / np.prod(shape[:-1])) ** 0.5, shape)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.1, shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: draw(p, s).astype(np.float32), shapes)


def _load(model, variables):
    model.load_state_dict(convert.from_flax_vision(
        _np(variables["params"]), _np(variables.get("batch_stats", {})),
        model))
    return model


def _grad_tree(model):
    """The port's parameter gradients as a flax params tree."""
    g = copy.deepcopy(model)
    for (_, p), (_, q) in zip(model.named_parameters(),
                              g.named_parameters()):
        q.data = p.grad.detach().clone()
    return convert.to_flax_vision(g)[0]


def _assert_trees(got, want, rel, what, atol=0.0):
    """Each leaf within ``rel`` of its largest |value| (plus ``atol``)."""
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_w.keys() == flat_g.keys()
    for path, w in flat_w.items():
        w = np.asarray(w, np.float64)
        tol = rel * max(np.abs(w).max(), 1e-30) + atol
        np.testing.assert_allclose(flat_g[path], w, rtol=0, atol=tol,
                                   err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# BatchNorm: statistics, running buffers, normalize order, output dtype
# ---------------------------------------------------------------------------

BN_REFS = {
    # (flax module, the port's output dtype for it)
    "tagged": (jresnet.TaggedBatchNorm, "compute"),
    "flax": (fnn.BatchNorm, None),
}


def _bn_pair(ref, momentum, dtype, train):
    cls, out = BN_REFS[ref]
    jdtype = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    kw = dict(momentum=momentum, epsilon=1e-5, param_dtype=jnp.float32,
              dtype=jdtype if out == "compute" else jnp.float32)
    jbn = cls(use_running_average=not train, **kw)
    tbn = resnet.BatchNorm(6, momentum,
                           dtype=tdtype if out == "compute" else None)
    rng = _rng(1)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(
                                np.float32),
                            "bias": rng.normal(0, 0.3, 6).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.2, 6).astype(
                                     np.float32),
                                 "var": rng.uniform(0.5, 2, 6).astype(
                                     np.float32)}}
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        tbn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        tbn.running_mean.copy_(torch.from_numpy(
            variables["batch_stats"]["mean"]))
        tbn.running_var.copy_(torch.from_numpy(
            variables["batch_stats"]["var"]))
    tbn.train(train)
    return jbn, tbn, variables, jdtype, tdtype


def _check_out(got: torch.Tensor, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == "bf16":
        # one bf16 step of the value
        tol = np.abs(want) * 2.0 ** -7 + 1e-6
        assert np.all(np.abs(_nhwc(got) - want) <= tol)
    else:
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("momentum", [0.9, 0.997])
@pytest.mark.parametrize("ref", sorted(BN_REFS))
def test_batchnorm_train_mode_matches_flax(ref, momentum, dtype):
    """Three calls in train mode: outputs, running mean and variance,
    and the output dtype (the compute dtype for ResNet-50's BN, float32
    for flax's nn.BatchNorm(dtype=float32) of the CIFAR ResNets)."""
    jbn, tbn, variables, jdtype, tdtype = _bn_pair(ref, momentum, dtype,
                                                   train=True)
    rng = _rng(2)
    for call in range(3):
        x = rng.normal(0.5 * call, 1 + call, (4, 5, 5, 6)).astype(np.float32)
        y, mutated = jbn.apply(variables, jnp.asarray(x, jdtype),
                               mutable=["batch_stats"])
        variables = {**variables, **_np(mutated)}
        out = tbn(_nchw(x).to(tdtype))
        assert out.dtype == torch.float32 if y.dtype == jnp.float32 else \
            out.dtype == torch.bfloat16
        _check_out(out, y, dtype)
        for buf, key in ((tbn.running_mean, "mean"),
                         (tbn.running_var, "var")):
            np.testing.assert_allclose(buf.numpy(),
                                       variables["batch_stats"][key],
                                       rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ref", sorted(BN_REFS))
def test_batchnorm_eval_mode_matches_flax(ref, dtype):
    jbn, tbn, variables, jdtype, tdtype = _bn_pair(ref, 0.9, dtype,
                                                   train=False)
    x = _rng(3).normal(0, 2, (3, 4, 4, 6)).astype(np.float32)
    before = tbn.running_mean.clone()
    out = tbn(_nchw(x).to(tdtype))
    _check_out(out, jbn.apply(variables, jnp.asarray(x, jdtype)), dtype)
    assert torch.equal(tbn.running_mean, before)


def test_batchnorm_variance_is_the_clamped_biased_form():
    """A constant channel: E[x^2] - E[x]^2 rounds below zero in float32
    and is clamped, and the running variance moves with the biased
    variance (nn.BatchNorm2d's running_var takes the unbiased one)."""
    bn = resnet.BatchNorm(2, 0.5)
    x = torch.full((2, 2, 3, 3), 0.1)
    x[:, 1] = torch.arange(18.).view(2, 3, 3)
    bn(x)
    biased = x[:, 1].var(unbiased=False)
    assert float(bn.running_var[0]) == pytest.approx(0.5, abs=1e-7)
    assert float(bn.running_var[1]) == pytest.approx(
        0.5 + 0.5 * float(biased), rel=1e-6)


# ---------------------------------------------------------------------------
# XLA's 'SAME' padding, the stems
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_same_conv_matches_xla(size, kernel, stride):
    rng = _rng(4)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    k = rng.normal(size=(kernel, kernel, 5, 7)).astype(np.float32)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert [resnet.same_pads(size, kernel, stride)] * 2 == [
        tuple(p) for p in lax.padtype_to_pads((size, size), (kernel, kernel),
                                              (stride, stride), "SAME")]
    conv = resnet.Conv2d(5, 7, kernel, stride=stride)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    np.testing.assert_allclose(_nhwc(conv(_nchw(x))), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_same_pads_are_asymmetric_on_even_sizes():
    assert resnet.same_pads(32, 3, 2) == (0, 1)
    assert resnet.same_pads(5, 3, 2) == (1, 1)
    assert resnet.same_pads(112, 3, 2) == (0, 1)
    assert resnet.same_pads(56, 1, 2) == (0, 0)


@pytest.mark.parametrize("size", [8, 9, 12])
def test_same_max_pool_matches_flax(size):
    x = _rng(5).normal(size=(2, size, size, 3)).astype(np.float32) - 3.0
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    np.testing.assert_allclose(_nhwc(resnet.max_pool_same(_nchw(x))),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("space_to_depth", [True, False])
def test_stems_match_jax(space_to_depth):
    """Both stems on the same (7, 7, 3, 64) kernel: the port's against
    Conv1SpaceToDepth and nn.Conv(7x7/2, pad 3), and against each
    other; an odd input falls back to the plain conv."""
    rng = _rng(6)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jstem = (jresnet.Conv1SpaceToDepth() if space_to_depth else
             fnn.Conv(64, (7, 7), strides=(2, 2), padding=[(3, 3), (3, 3)],
                      use_bias=False))
    variables = jstem.init(jax.random.key(0), jnp.asarray(x))
    kernel = np.array(variables["params"]["kernel"])
    stem = resnet.Stem(64, space_to_depth=space_to_depth)
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    out = stem(torch.from_numpy(x))
    assert out.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(jstem.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(out), want, rtol=1e-5, atol=1e-5)
    other = resnet.Stem(64, space_to_depth=not space_to_depth)
    other.load_state_dict(stem.state_dict())
    np.testing.assert_allclose(_nhwc(other(torch.from_numpy(x))), want,
                               rtol=1e-5, atol=1e-5)
    odd = rng.normal(size=(1, 15, 15, 3)).astype(np.float32)
    plain = fnn.Conv(64, (7, 7), strides=(2, 2), padding=[(3, 3), (3, 3)],
                     use_bias=False)
    np.testing.assert_allclose(
        _nhwc(stem(torch.from_numpy(odd))),
        np.asarray(plain.apply(variables, jnp.asarray(odd))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the bottleneck block, resnet20, ResNet-50, the trivial model
# ---------------------------------------------------------------------------

BLOCK_CASES = {"proj_s1": (16, True, 1), "proj_s2": (16, True, 2),
               "identity": (32, False, 1)}


@pytest.mark.parametrize("size", [6, 5])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_bottleneck_block_matches_jax(case, size):
    """filters (8, 8, 32) in train mode: output, parameter gradients
    and BN buffers (an even size pads stride 2 (0, 1), an odd one
    (1, 1))."""
    cin, proj, stride = BLOCK_CASES[case]
    rng = _rng(7)
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    jblock = jresnet.BottleneckBlock((8, 8, 32), strides=stride,
                                     projection=proj)
    variables = _init(jblock, 1, x)
    out_shape = jax.eval_shape(lambda: jblock.apply(
        variables, jnp.asarray(x), train=False)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    def loss(params):
        y, mutated = jblock.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mutated)

    (_, (y, mutated)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    block = _load(resnet.BottleneckBlock(cin, (8, 8, 32), strides=stride,
                                         projection=proj), variables)
    out = block(_nchw(x))
    (out * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(_nhwc(out), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    _assert_trees(_grad_tree(block), _np(grads), 1e-5, "grad")
    _assert_trees(convert.to_flax_vision(block)[1],
                  _np(mutated["batch_stats"]), 1e-5, "batch_stats")


def _resnet20_pair(dtype="f32", seed=0, size=8):
    jdtype = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    jmodel = jcifar.resnet20(dtype=jdtype)
    x = _rng(seed).normal(size=(4, size, size, 3)).astype(np.float32)
    variables = _random_variables(jmodel, x, seed)
    model = _load(resnet_cifar.resnet20(dtype=tdtype), variables)
    return jmodel, model, variables, x


def test_resnet20_matches_jax_train_and_eval():
    """Train-mode logits, parameter gradients of the mean cross-entropy
    and BN buffers, then eval-mode logits on the moved buffers."""
    jmodel, model, variables, x = _resnet20_pair()
    labels = _rng(1).integers(0, 10, 4).astype(np.int32)

    def loss(params):
        logits, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        ce = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                           labels[:, None], 1))
        return ce, (logits, mutated)

    (_, (jlogits, mutated)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    model.train()
    logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    loop.cross_entropy(logits, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    _assert_trees(_grad_tree(model), _np(grads), 1e-4, "grad")
    _assert_trees(convert.to_flax_vision(model)[1],
                  _np(mutated["batch_stats"]), 1e-5, "batch_stats")
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = jmodel.apply({"params": variables["params"], **_np(mutated)},
                        jnp.asarray(x), train=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bn_output_dtypes_under_bf16():
    """bf16 compute: the CIFAR ResNets' BN returns float32 (their
    residual adds run in float32), ResNet-50's returns bf16; both give
    float32 logits and keep float32 parameters."""
    seen = {}

    def hook(name):
        def fn(mod, args, out):
            seen[name] = out.dtype
        return fn

    cifar = resnet_cifar.resnet20(dtype=torch.bfloat16)
    r50 = resnet.ResNet50(num_classes=5, dtype=torch.bfloat16)
    cifar.stage2_block0.bn_a.register_forward_hook(hook("cifar"))
    r50.stage2_block0.bn_a.register_forward_hook(hook("r50"))
    x = torch.from_numpy(_rng(2).normal(size=(2, 16, 16, 3)).astype(
        np.float32))
    assert cifar(x).dtype == r50(x).dtype == torch.float32
    assert seen == {"cifar": torch.float32, "r50": torch.bfloat16}
    assert {p.dtype for m in (cifar, r50) for p in m.parameters()} == {
        torch.float32}


def test_resnet20_bf16_logits_track_jax():
    jmodel, model, variables, x = _resnet20_pair(dtype="bf16", seed=3)
    model.train()
    got = model(torch.from_numpy(x)).detach().numpy()
    want, _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=3e-2 * np.abs(want).max())


def test_resnet50_matches_jax_at_40px():
    """ResNet-50 at 40x40, batch 2, 11 classes, eval mode on random
    weights and running statistics: the max-pool and stage-3 convs pad (0, 1) (even
    sizes 20 and 10), stages 4 and 5 pad (1, 1) (odd sizes 5 and 3)."""
    rng = _rng(8)
    x = rng.normal(size=(2, 40, 40, 3)).astype(np.float32)
    jmodel = jresnet.ResNet50(num_classes=11)
    variables = _random_variables(jmodel, x, 2)
    model = _load(resnet.ResNet50(num_classes=11), variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _jax_param_count(jmodel, shape):
    v = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                           jnp.zeros(shape), train=False))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(v["params"]))


@pytest.mark.parametrize("name", ["resnet20", "resnet56", "resnet50",
                                  "trivial"])
def test_param_counts_match_jax(name):
    shape = (1, 32, 32, 3) if name != "trivial" else (1, 8, 8, 3)
    kw = {"in_features": 8 * 8 * 3} if name == "trivial" else {}
    model, l2 = registry.build_model(name, **kw)
    jmodel, jl2 = _jax_build(name)
    assert l2 == jl2
    n = sum(p.numel() for p in model.parameters())
    assert n == _jax_param_count(jmodel, shape)
    if name == "resnet50":
        assert n == 25_559_081


def _jax_build(name):
    from dtf_tpu.models.registry import build_model
    return build_model(name)


def test_trivial_model_matches_jax():
    """flatten over (H, W, C) -> Dense(1) -> Dense(num_classes)."""
    x = _rng(9).normal(size=(3, 8, 8, 3)).astype(np.float32)
    jmodel = jtrivial.TrivialModel(num_classes=7)
    variables = _init(jmodel, 3, x)
    model = _load(trivial.TrivialModel(num_classes=7, in_features=192),
                  variables)
    np.testing.assert_allclose(
        model(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["resnet20", "resnet50", "trivial"])
def test_init_draws_the_flax_distributions(name):
    """Seeded init: conv kernels he_normal (truncated, std sqrt(2 /
    fan_in)), the ResNets' classifier N(0, 0.01), the trivial model's
    Dense lecun_normal, zero biases, unit BN scales, fresh buffers; the
    same seed gives the same weights."""
    kw = {"in_features": 64 * 64 * 3} if name == "trivial" else {}
    a = registry.build_model(name, **kw)[0].init_weights(5)
    b = registry.build_model(name, **kw)[0].init_weights(5)
    for (n, p), (_, q) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(p, q), n
    for mod_name, mod in a.named_modules():
        if isinstance(mod, torch.nn.Conv2d) and mod.weight.numel() > 4000:
            w = mod.weight.detach()
            fan_in = w[0].numel()
            assert float(w.std()) == pytest.approx(
                (2.0 / fan_in) ** 0.5, rel=0.1), mod_name
            assert float(w.abs().max()) <= 2 * (2.0 / fan_in) ** 0.5 / 0.8796
        elif isinstance(mod, torch.nn.Linear):
            std = (0.01 if name != "trivial"
                   else (1.0 / mod.weight.shape[1]) ** 0.5)
            if mod.weight.numel() > 1000:
                assert float(mod.weight.detach().std()) == pytest.approx(std, rel=0.1)
            assert not mod.bias.any()
        elif isinstance(mod, resnet.BatchNorm):
            assert bool((mod.weight == 1).all() and (mod.running_var == 1)
                        .all() and not mod.bias.any()
                        and not mod.running_mean.any())


# ---------------------------------------------------------------------------
# convert: the vision trees both ways
# ---------------------------------------------------------------------------

def test_convert_vision_round_trips_bit_exact():
    jmodel = jcifar.resnet20()
    variables = _random_variables(jmodel, np.zeros((1, 8, 8, 3)), 4)
    model = _load(resnet_cifar.resnet20(), variables)
    params, stats = convert.to_flax_vision(model)
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    again = resnet_cifar.resnet20().init_weights(9)
    sd = convert.from_flax_vision(*convert.to_flax_vision(again), again)
    for name, t in again.state_dict().items():
        assert torch.equal(sd[name], t), name


def test_convert_vision_raises_on_missing_bad_and_extra_leaves():
    model = trivial.TrivialModel(num_classes=4, in_features=12)
    params, stats = convert.to_flax_vision(model)
    missing = copy.deepcopy(params)
    del missing["fc"]["bias"]
    with pytest.raises(KeyError, match="fc/bias"):
        convert.from_flax_vision(missing, stats, model)
    bad = copy.deepcopy(params)
    bad["fc1"]["kernel"] = np.zeros((13, 1), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        convert.from_flax_vision(bad, stats, model)
    extra = copy.deepcopy(params)
    extra["fc2"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="no place"):
        convert.from_flax_vision(extra, stats, model)
    with pytest.raises(KeyError, match="bn_conv1"):
        cifar = resnet_cifar.resnet20()
        p, s = convert.to_flax_vision(cifar)
        del s["bn_conv1"]
        convert.from_flax_vision(p, s, cifar)


# ---------------------------------------------------------------------------
# the Trainer against the JAX Trainer on resnet20
# ---------------------------------------------------------------------------

TRAIN_CASES = {"f32": dict(dtype="fp32"), "bf16": dict(dtype="bf16"),
               "grad_accum_2": dict(dtype="fp32", grad_accum_steps=2)}


def _trainer_pair(steps=3, **flags):
    batch = 4
    common = dict(batch_size=batch, train_steps=steps, dataset="cifar10",
                  use_synthetic_data=True, skip_eval=True, optimizer="sgd",
                  **flags)
    jcfg = JaxConfig(model="resnet20", skip_checkpoint=True, model_dir="",
                     distribution_strategy="off", num_devices=1, **common)
    rt = initialize(jcfg)
    jmodel = jcifar.resnet20(dtype=jcfg.compute_dtype)
    jtrainer = JaxTrainer(jcfg, rt, jmodel, registry.L2_CIFAR,
                          jdata_base.CIFAR10)
    rng = _rng(11)
    # 16x16: the last stage's BN then sees 2 x 4 x 4 values a channel
    # per micro-batch; at 8x8 and grad_accum 2 it sees 8, E[x^2] -
    # E[x]^2 cancels, and the two packages' float32 rounding
    # differences grow to 5e-5 of the loss by step 3
    images = (rng.normal(size=(batch, 16, 16, 3)) * 60 + 127).astype(
        np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    jstate = jtrainer.init_state(jax.random.key(0), (images, labels))
    cfg = Config(device="cpu", model="resnet20", **common)
    model = resnet_cifar.resnet20(dtype=cfg.compute_dtype)
    model.load_state_dict(convert.from_flax_vision(
        _np(jstate.params), _np(jstate.batch_stats), model))
    trainer = Trainer(cfg, model.to(memory_format=torch.channels_last),
                      registry.L2_CIFAR, data_base.CIFAR10)
    return jtrainer, rt, jstate, trainer, (images, labels)


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_resnet20_trainer_matches_jax_trainer(case):
    """Three steps of Keras-momentum SGD under the CIFAR schedule with
    L2 2e-4: losses, and (float32) parameters and BN buffers after."""
    flags = TRAIN_CASES[case]
    jtrainer, rt, jstate, trainer, (images, labels) = _trainer_pair(**flags)
    state = trainer.init_state()
    jl, tl = [], []
    for _ in range(3):
        jstate, m = jtrainer.train_step(jstate,
                                        *rt.shard_batch((images, labels)))
        jl.append(float(m["loss"]))
        state, tm = trainer.train_step(state, torch.from_numpy(images),
                                       torch.from_numpy(labels))
        tl.append(float(tm["loss"]))
        assert tm["learning_rate"] == pytest.approx(
            float(m["learning_rate"]), rel=1e-6)
    rtol = 5e-3 if flags["dtype"] == "bf16" else 1e-5
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    if flags["dtype"] == "bf16":
        return
    # a zero-initialized BN bias holds three updates of lr x a gradient
    # that sums cancelling terms: 1e-2 of the LR besides 1e-4 of a leaf
    params, stats = convert.to_flax_vision(trainer.model)
    lr = float(m["learning_rate"])
    _assert_trees(params, _np(jstate.params), 1e-4, "params", atol=1e-2 * lr)
    _assert_trees(stats, _np(jstate.batch_stats), 1e-4, "batch_stats")


def test_dynamic_scale_skip_keeps_the_bn_buffers(monkeypatch):
    """A step whose gradients are not finite keeps the parameters and
    the BN running statistics."""
    cfg = Config(device="cpu", model="resnet20", dataset="cifar10",
                 batch_size=4, train_steps=3, loss_scale="dynamic")
    model = resnet_cifar.resnet20().init_weights(0)
    trainer = Trainer(cfg, model, registry.L2_CIFAR, data_base.CIFAR10)
    state = trainer.init_state()
    forward = model.forward
    calls = [0]

    def poisoned(x):
        calls[0] += 1
        out = forward(x)
        return out * float("nan") if calls[0] == 2 else out

    monkeypatch.setattr(model, "forward", poisoned)
    x = torch.from_numpy(_rng(12).normal(size=(4, 8, 8, 3)).astype(
        np.float32))
    y = torch.arange(4)
    state, _ = trainer.train_step(state, x, y)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, m = trainer.train_step(state, x, y)
    assert not np.isfinite(float(m["loss"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    state, _ = trainer.train_step(state, x, y)
    assert not torch.equal(model.bn_conv1.running_mean,
                           before["bn_conv1.running_mean"])


def test_channels_first_batches_train_alike():
    """--data_format channels_first: NCHW batches give the same step as
    the NHWC ones."""
    x = _rng(13).normal(size=(4, 8, 8, 3)).astype(np.float32)
    y = torch.arange(4)
    losses = []
    for fmt, batch in (("channels_last", x),
                       ("channels_first", x.transpose(0, 3, 1, 2))):
        cfg = Config(device="cpu", model="resnet20", dataset="cifar10",
                     batch_size=4, train_steps=2, data_format=fmt)
        model = resnet_cifar.resnet20().init_weights(0)
        trainer = Trainer(cfg, model, registry.L2_CIFAR, data_base.CIFAR10)
        state = trainer.init_state()
        for _ in range(2):
            state, m = trainer.train_step(
                state, torch.from_numpy(np.ascontiguousarray(batch)), y)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
