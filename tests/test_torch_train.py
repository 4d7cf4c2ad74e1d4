"""The port's training path (dtf_tpu_torch: data, schedules, optimizers,
the L2 rule, the model in training mode, the Trainer, lm_main) against
the JAX package, on the CPU.

Inputs come from a numpy seed and go through both packages; weights are
JAX-initialized and carried into the port by ``convert.from_flax_params``.
On the CPU the port's attention runs the kernels' plain versions, forward
and backward; the JAX model on the CPU runs its blockwise attention.

Tolerances: schedules and optimizer updates 1e-6 relative (double
against float32 arithmetic); float32 training steps 1e-5 relative on the
per-step loss and 1e-4 on the parameters after three steps (the forward
and backward sums run in another order than XLA's, and AdamW divides by
the gradients' running RMS); bf16 steps 5e-3 relative on the loss (bf16
rounds at other places in the two frameworks; 1.0e-3 measured over five
steps); data bit-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import dtf_tpu.data.base as jdata_base
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.data.synthetic import synthetic_input_fn as jax_synthetic
from dtf_tpu.models.registry import l2_weight_penalty as jax_l2
from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.runtime import initialize
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu.train import optimizer as jopt
from dtf_tpu.train import schedules as jsched
from dtf_tpu.utils import logs as jlogs
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import lm_main
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.data import base as data_base
from dtf_tpu_torch.data.pipeline import DevicePrefetcher
from dtf_tpu_torch.data.synthetic import synthetic_input_fn
from dtf_tpu_torch.models import registry, transformer
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.ops import flash_attention as tfa
from dtf_tpu_torch.train import loop, optimizer, schedules
from dtf_tpu_torch.train.loop import Trainer
from dtf_tpu_torch.utils import logs

torch.set_num_threads(1)

VOCAB, SEQ, BATCH = 64, 16, 4
DIMS = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
            d_ff=64, max_seq_len=SEQ)
JAX_TINY = dataclasses.replace(jdata_base.LM, num_classes=VOCAB, seq_len=SEQ,
                               num_train=64, num_eval=16)
TINY = dataclasses.replace(data_base.LM, num_classes=VOCAB, seq_len=SEQ,
                           num_train=64, num_eval=16)


# ---------------------------------------------------------------------------
# data: specs, the synthetic stream, the prefetcher
# ---------------------------------------------------------------------------

def test_dataset_specs_are_the_jax_specs():
    for name in ("cifar10", "cifar", "imagenet", "lm"):
        assert (dataclasses.asdict(data_base.get_dataset_spec(name))
                == dataclasses.asdict(jdata_base.get_dataset_spec(name)))
    assert data_base.LM.is_sequence and not data_base.CIFAR10.is_sequence
    with pytest.raises(ValueError, match="unknown dataset"):
        data_base.get_dataset_spec("mnist")


@pytest.mark.parametrize("name", ["lm", "cifar10"])
@pytest.mark.parametrize("is_training", [True, False])
def test_synthetic_batches_are_bit_identical_to_jax(name, is_training):
    spec = dataclasses.replace(data_base.get_dataset_spec(name),
                               num_eval=24)
    jspec = dataclasses.replace(jdata_base.get_dataset_spec(name),
                                num_eval=24)
    if spec.is_sequence:
        spec = dataclasses.replace(spec, seq_len=32)
        jspec = dataclasses.replace(jspec, seq_len=32)
    port = list(zip(range(3), synthetic_input_fn(spec, is_training, 8, 5)))
    ref = list(zip(range(3), jax_synthetic(jspec, is_training, 8, 5)))
    assert len(port) == len(ref) == 3
    for (_, (pi, pl)), (_, (ji, jl)) in zip(port, ref):
        assert pi.dtype == ji.dtype and pl.dtype == jl.dtype
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pl, jl)


def test_prefetcher_yields_the_batches_and_latches_errors():
    def batches():
        for i in range(3):
            yield np.full((2, 4), i, np.int32), np.arange(2, dtype=np.int32)
        raise RuntimeError("reader broke")

    pf = DevicePrefetcher(batches(), "cpu", buffer_size=2)
    for i in range(3):
        x, y = next(pf)
        assert isinstance(x, torch.Tensor) and x.dtype == torch.int32
        assert torch.equal(x, torch.full((2, 4), i, dtype=torch.int32))
        assert torch.equal(y, torch.arange(2, dtype=torch.int32))
    for _ in range(2):          # a retry re-raises instead of blocking
        with pytest.raises(RuntimeError, match="reader broke"):
            next(pf)
    pf.close()


def test_prefetcher_close_stops_an_endless_stream():
    pf = DevicePrefetcher(synthetic_input_fn(TINY, True, 2), "cpu")
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("lm_schedule", lambda m: m.lm_schedule(20)),
    ("lm_schedule_long", lambda m: m.lm_schedule(50_000)),
    ("constant", lambda m: m.constant(0.05)),
    ("cifar", lambda m: m.cifar_schedule(256, 3)),
    ("imagenet", lambda m: m.imagenet_schedule(1024, 2)),
    ("tensor_lr", lambda m: m.piecewise_constant_with_warmup(256, 2560)),
    ("horovod", lambda m: m.horovod_schedule(4, 5)),
    ("warmup_piecewise", lambda m: m.piecewise_by_epoch(
        128, 4, 128, m.CIFAR_LR_SCHEDULE, warmup_epochs=2.5)),
    ("for_dataset_lm", lambda m: m.for_dataset("lm", 8, 30, 100_000)),
]


@pytest.mark.parametrize("name,make", SCHEDULES)
def test_schedules_match_jax(name, make):
    port, ref = make(schedules), make(jsched)
    steps = list(range(0, 40)) + [299, 300, 301, 364, 365, 2000, 60_000]
    for step in steps:
        want = float(ref(jnp.int32(step)))
        got = port(step)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (name, step)


def test_lm_schedule_first_step_is_zero():
    assert schedules.lm_schedule(30)(0) == 0.0
    assert schedules.for_dataset("lm", 8, 30, 100_000)(0) == 0.0


def _opt_pair(name):
    """(port, JAX) optimizer over the LM schedule of 10 steps."""
    lr, jlr = schedules.lm_schedule(10), jsched.lm_schedule(10)
    if name == "adamw":
        return optimizer.adamw(lr), jopt.adamw(jlr)
    return optimizer.keras_sgd(lr), jopt.keras_sgd(jlr)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_updates_match_jax_over_five_steps(name):
    """The port's update, applied in place, against the optax
    transformation over five steps of the LM schedule (lr 0 at step 0)
    -- parameters and moments alike."""
    rng = np.random.default_rng(9)
    shapes = [(3, 5), (7,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    port_opt, jax_opt = _opt_pair(name)
    tparams = [torch.from_numpy(x.copy()) for x in init]
    jparams = [jnp.asarray(x) for x in init]
    tstate, jstate = port_opt.init(tparams), jax_opt.init(jparams)
    for step in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        updates, tstate = port_opt.update(
            [torch.from_numpy(g) for g in grads], tstate, tparams, step=step)
        optimizer.apply_updates(tparams, updates)
        jup, jstate = jax_opt.update([jnp.asarray(g) for g in grads],
                                     jstate, jparams, step=jnp.int32(step))
        jparams = [p + u for p, u in zip(jparams, jup)]
        if step == 0:
            # the LM schedule's first lr is 0: nothing moves yet
            for t, x in zip(tparams, init):
                np.testing.assert_array_equal(t.numpy(), x)
        for t, j in zip(tparams, jparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)
    if name == "adamw":
        assert tstate.count == int(jstate.adam.count) == 5
        for t, j in zip(tstate.mu + tstate.nu,
                        list(jstate.adam.mu) + list(jstate.adam.nu)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-9)
    else:
        for t, j in zip(tstate.velocity, jstate.velocity):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-9)


def test_optimizer_state_is_float32_for_bf16_params():
    p = [torch.zeros(3, dtype=torch.bfloat16)]
    for opt in (optimizer.adamw(schedules.constant(0.1)),
                optimizer.keras_sgd(schedules.constant(0.1))):
        state = opt.init(p)
        for t in state[-1] + (state[1] if len(state) == 3 else []):
            assert t.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizer.build_optimizer("lamb", schedules.constant(0.1))


# ---------------------------------------------------------------------------
# the L2 rule
# ---------------------------------------------------------------------------

class _ToyNet(nn.Module):
    """conv + BN + dense + a classifier named fc, and an fc nested under
    a head: the shapes of the ResNets' penalized and unpenalized
    leaves."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3)
        self.bn = nn.BatchNorm2d(4)
        self.dense = nn.Linear(5, 6)
        self.fc = nn.Linear(6, 2)
        self.head = nn.Module()
        self.head.fc = nn.Linear(2, 3)
        self.ln = nn.LayerNorm(3)
        self.embed = nn.Embedding(4, 3)


def test_l2_penalty_is_the_jax_rule_on_torch_names():
    torch.manual_seed(0)
    net = _ToyNet()
    with torch.no_grad():
        for p in net.parameters():
            p.normal_()
    names = [n for n, _ in registry.penalized_parameters(net)]
    assert sorted(names) == sorted([
        "conv.weight", "dense.weight", "fc.weight", "fc.bias",
        "head.fc.weight", "head.fc.bias"])

    def a(t):
        return np.asarray(t.detach().numpy())

    flax_tree = {
        "conv": {"kernel": a(net.conv.weight).transpose(2, 3, 1, 0),
                 "bias": a(net.conv.bias)},
        "bn": {"scale": a(net.bn.weight), "bias": a(net.bn.bias)},
        "dense": {"kernel": a(net.dense.weight).T, "bias": a(net.dense.bias)},
        "fc": {"kernel": a(net.fc.weight).T, "bias": a(net.fc.bias)},
        "head": {"fc": {"kernel": a(net.head.fc.weight).T,
                        "bias": a(net.head.fc.bias)}},
        "ln": {"scale": a(net.ln.weight), "bias": a(net.ln.bias)},
        "embed": {"embedding": a(net.embed.weight)},
    }
    for l2 in (registry.L2_CIFAR, registry.L2_IMAGENET, 0.0):
        got = registry.l2_weight_penalty(net, l2)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got.detach()) == pytest.approx(
            float(jax_l2(flax_tree, l2)),
                                           rel=1e-6)
    # no 1/2 factor: d/dw (l2 * w^2) = 2 * l2 * w
    registry.l2_weight_penalty(net, 0.5).backward()
    assert torch.allclose(net.fc.bias.grad, net.fc.bias.detach())
    assert net.bn.weight.grad is None and net.dense.bias.grad is None


def test_registry_l2_constants_and_lm_weight():
    from dtf_tpu.models import registry as jreg
    assert (registry.L2_CIFAR, registry.L2_IMAGENET) == (jreg.L2_CIFAR,
                                                         jreg.L2_IMAGENET)
    for name in ("transformer", "transformer_small", "transformer_tpu"):
        assert registry.build_model(name, max_seq_len=8)[1] == 0.0


# ---------------------------------------------------------------------------
# the model in training mode
# ---------------------------------------------------------------------------

def test_bf16_model_keeps_float32_parameters():
    model = TransformerLM(**DIMS, dtype=torch.bfloat16)
    assert model.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    logits = model(torch.zeros(2, 8, dtype=torch.long))
    assert logits.dtype == torch.float32
    logits.sum().backward()
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}


def test_bf16_residual_stream_is_bf16(monkeypatch):
    """The residual stream and the attention run in bf16, as the JAX
    model's do under dtype=bfloat16 -- not float32 under an autocast."""
    seen = []
    real = transformer.flash_attention

    def spy(q, k, v, **kw):
        seen.append(q.dtype)
        return real(q, k, v, **kw)

    monkeypatch.setattr(transformer, "flash_attention", spy)
    model = TransformerLM(**DIMS, dtype=torch.bfloat16)
    outs = []
    model.block0.register_forward_hook(lambda m, i, o: outs.append(o.dtype))
    model(torch.zeros(1, 8, dtype=torch.long))
    assert seen == [torch.bfloat16] * 2 and outs == [torch.bfloat16]


def test_inference_reuses_weight_casts_until_a_weight_changes():
    """Outside autograd the bf16 copy of each float32 weight is kept and
    reused -- the same logits as a fresh cast -- and a parameter changed
    in place (an optimizer step, a load) is cast again."""
    torch.manual_seed(0)
    model = TransformerLM(**DIMS, dtype=torch.bfloat16)
    toks = torch.arange(8).reshape(1, 8)
    with torch.no_grad():
        first = model(toks)
        kept = model.block0.fc1.weight._compute_copy[1]
        again = model(toks)
        assert model.block0.fc1.weight._compute_copy[1] is kept
        assert torch.equal(first, again)
        model.block0.fc1.weight.mul_(2.0)
        changed = model(toks)
        assert model.block0.fc1.weight._compute_copy[1] is not kept
    assert torch.equal(model(toks).detach(), changed)
    assert not torch.equal(changed, first)


def test_remat_recomputes_each_block_with_the_same_gradients(monkeypatch):
    calls = []
    real = transformer.flash_attention

    def spy(q, k, v, **kw):
        calls.append(1)
        return real(q, k, v, **kw)

    monkeypatch.setattr(transformer, "flash_attention", spy)
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, VOCAB, (2, SEQ)))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = TransformerLM(**DIMS, remat=remat)
        calls.clear()
        model(toks).square().mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
        # one attention per block forward; remat runs each again
        assert len(calls) == DIMS["num_layers"] * (2 if remat else 1)
    for a, b in zip(*grads):
        assert torch.allclose(a, b, atol=1e-6)
    # the selective policy (ported since): one attention per block, and
    # an unknown name raises the JAX message
    torch.manual_seed(0)
    model = TransformerLM(**DIMS, remat_policy="dots")
    calls.clear()
    model(toks).square().mean().backward()
    assert len(calls) == DIMS["num_layers"]
    with pytest.raises(ValueError, match="unknown remat_policy 'x'; "
                                         "choose 'dots'"):
        TransformerLM(**DIMS, remat_policy="x")


# ---------------------------------------------------------------------------
# the Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_lm_spec(monkeypatch):
    monkeypatch.setitem(jdata_base._SPECS, "lm", JAX_TINY)


def _batch(seed=7):
    tokens = np.random.default_rng(seed).integers(
        0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    return tokens, np.roll(tokens, -1, 1)


def _pair(dtype="fp32", steps=3, **flags):
    """(jax trainer, its runtime and state, port trainer and state) on
    the same JAX-initialized weights."""
    common = dict(batch_size=BATCH, train_steps=steps, dataset="lm",
                  use_synthetic_data=True, skip_eval=True, dtype=dtype,
                  **flags)
    jcfg = JaxConfig(model="transformer", skip_checkpoint=True, model_dir="",
                     distribution_strategy="off", num_devices=1, **common)
    rt = initialize(jcfg)
    jmodel = JaxLM(**DIMS, dtype=jcfg.compute_dtype)
    jtrainer = JaxTrainer(jcfg, rt, jmodel, 0.0, JAX_TINY)
    jstate = jtrainer.init_state(jax.random.key(0), _batch())
    cfg = Config(device="cpu", **common)
    model = TransformerLM(**DIMS, dtype=cfg.compute_dtype)
    model.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), model))
    trainer = Trainer(cfg, model, 0.0, TINY)
    return jtrainer, rt, jstate, trainer, trainer.init_state()


def _run_both(jtrainer, rt, jstate, trainer, state, steps=3):
    tokens, labels = _batch()
    jl, tl, jm, tm = [], [], [], []
    for _ in range(steps):
        jstate, m = jtrainer.train_step(jstate,
                                        *rt.shard_batch((tokens, labels)))
        jl.append(float(m["loss"]))
        jm.append(jax.device_get(m))
        state, tmet = trainer.train_step(state, torch.from_numpy(tokens),
                                         torch.from_numpy(labels))
        tl.append(float(tmet["loss"]))
        tm.append(tmet)
    return jstate, state, jl, tl, jm, tm


TRAIN_CASES = {
    "plain": dict(optimizer="adamw"),
    "grad_accum_2": dict(optimizer="adamw", grad_accum_steps=2),
    "clip": dict(optimizer="sgd", clip_grad_norm=0.05),
    "static_scale_128": dict(optimizer="adamw", loss_scale="128"),
    "dynamic_scale": dict(optimizer="adamw", loss_scale="dynamic"),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_trainer_matches_jax_trainer_f32(tiny_lm_spec, case):
    jtrainer, rt, jstate, trainer, state = _pair(**TRAIN_CASES[case])
    jstate, state, jl, tl, jm, tm = _run_both(jtrainer, rt, jstate, trainer,
                                              state)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for j, t in zip(jm, tm):
        assert t["learning_rate"] == pytest.approx(
            float(j["learning_rate"]), rel=1e-6, abs=1e-12)
        assert float(t["accuracy"]) == pytest.approx(float(j["accuracy"]),
                                                     abs=1e-6)
        if "loss_scale" in j:
            assert t["loss_scale"] == float(j["loss_scale"])
    assert state.step == int(jstate.step) == 3
    want = convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), trainer.model)
    for name, p in trainer.model.state_dict().items():
        np.testing.assert_allclose(_comparable(name, p.numpy()),
                                   _comparable(name, want[name].numpy()),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _comparable(name, arr):
    """The parameter minus the key bias (the middle third of qkv.bias):
    its gradient is identically zero -- adding a constant to every key of
    a row shifts the row's scores alike, which softmax ignores -- so each
    package's AdamW step there is its own rounding noise divided by its
    RMS, +-lr whatever the noise's size."""
    if name.endswith("attn.qkv.bias"):
        third = arr.shape[0] // 3
        return np.concatenate([arr[:third], arr[2 * third:]])
    return arr


def test_trainer_matches_jax_trainer_bf16(tiny_lm_spec):
    """bf16 compute, float32 parameters and optimizer state in both."""
    jtrainer, rt, jstate, trainer, state = _pair(dtype="bf16",
                                                 optimizer="adamw")
    jstate, state, jl, tl, _, _ = _run_both(jtrainer, rt, jstate, trainer,
                                            state)
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    assert all(np.isfinite(tl))
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert {t.dtype for t in state.opt_state.mu + state.opt_state.nu} == {
        torch.float32}
    assert {np.asarray(x).dtype for x in jax.tree_util.tree_leaves(
        jstate.params)} == {np.dtype(np.float32)}


def _poisoned(model, bad_calls):
    """Wrap the model's forward so the given calls return NaN logits."""
    forward = model.forward
    count = [0]

    def wrapped(tokens, *a, **kw):
        count[0] += 1
        out = forward(tokens, *a, **kw)
        return out * float("nan") if count[0] in bad_calls else out

    model.forward = wrapped


def test_dynamic_scale_skips_non_finite_steps_and_grows(monkeypatch):
    """TF2 LossScaleOptimizer semantics: a non-finite step keeps the
    parameters and optimizer state and halves the scale; the scale
    doubles after DYNAMIC_GROWTH_INTERVAL finite steps in a row."""
    monkeypatch.setattr(loop, "DYNAMIC_GROWTH_INTERVAL", 2)
    cfg = Config(device="cpu", dataset="lm", batch_size=BATCH,
                 train_steps=5, optimizer="adamw", loss_scale="dynamic")
    model = TransformerLM(**DIMS)
    trainer = Trainer(cfg, model, 0.0, TINY)
    state = trainer.init_state()
    _poisoned(model, {2})
    tokens, labels = (torch.from_numpy(x) for x in _batch())
    scales, counts = [], []
    for step in range(4):
        before = [p.detach().clone() for p in model.parameters()]
        state, m = trainer.train_step(state, tokens, labels)
        scales.append(m["loss_scale"])
        counts.append(state.opt_state.count)
        if step == 1:
            assert not np.isfinite(float(m["loss"]))
            for p, b in zip(model.parameters(), before):
                assert torch.equal(p.detach(), b)
    s0 = loop.DYNAMIC_SCALE_INIT
    assert scales == [s0, s0 / 2, s0 / 2, s0]
    assert counts == [1, 1, 2, 3]
    assert state.good_steps == 0 and state.step == 4


# ---------------------------------------------------------------------------
# flags and the entry point
# ---------------------------------------------------------------------------

def test_flags_parse_the_jax_training_names():
    cfg = parse_flags(["--use_synthetic_data", "--batch_size", "2",
                       "--skip_eval", "false", "--remat",
                       "--loss_scale=dynamic", "--clip_grad_norm", "1.5",
                       "--train_steps", "7", "--seq_len", "32"],
                      defaults=lm_main.LM_DEFAULTS)
    assert cfg.use_synthetic_data and cfg.remat and not cfg.skip_eval
    assert (cfg.batch_size, cfg.train_steps, cfg.seq_len) == (2, 7, 32)
    assert cfg.loss_scale_value == "dynamic" and cfg.clip_grad_norm == 1.5
    assert (cfg.optimizer, cfg.dataset, cfg.dtype) == ("adamw", "lm", "bf16")
    assert Config().loss_scale_value == 1.0
    assert Config(loss_scale="128").loss_scale_value == 128.0
    from dtf_tpu.config.flags import define_flags
    jax_defaults = define_flags()
    for f in dataclasses.fields(Config):
        # the port keeps its checkpoints apart from the JAX package's
        if f.name in jax_defaults and f.name not in ("model", "device",
                                                     "model_dir"):
            assert f.default == jax_defaults[f.name], f.name


@pytest.mark.parametrize("flag", ["--seq_parallelism", "--zero_stage",
                                  "--model_parallelism", "--num_experts",
                                  "--remat_policy", "--plan"])
def test_flags_of_unported_features_raise(flag):
    if flag in ("--zero_stage", "--remat_policy", "--model_parallelism",
                "--seq_parallelism", "--num_experts"):
        # ported since (ZeRO, the selective remat policy, tensor,
        # sequence and expert parallelism): they parse, the MoE flags
        # beside the JAX defaults of the others
        cfg = parse_flags([flag, "1"])
        assert getattr(cfg, flag[2:]) in (1, "1")
        if flag == "--num_experts":
            assert (cfg.moe_top_k, cfg.moe_capacity_factor) == (None, None)
    else:
        # ported since (the planner): "auto" parses, and a plan file
        # that does not exist is refused with the JAX message
        assert parse_flags([flag, "auto"]).plan == "auto"
        with pytest.raises(ValueError, match="no such plan file"):
            parse_flags([flag, "1"])
    with pytest.raises(ValueError, match="unknown flag"):
        parse_flags(["--no_such_flag", "1"])


def test_real_data_dir_raises():
    with pytest.raises(NotImplementedError, match="data_dir"):
        lm_main.main(["--device", "cpu", "--data_dir", "/nonexistent",
                      "--model", "transformer_small"])


def test_lm_main_on_cpu_returns_finite_run_stats():
    stats = lm_main.main(["--use_synthetic_data", "--device", "cpu",
                          "--model", "transformer_small", "--seq_len", "32",
                          "--num_classes", "256", "--batch_size", "4",
                          "--train_steps", "4", "--log_steps", "2",
                          "--dtype", "fp32", "--skip_checkpoint"])
    assert np.isfinite(stats["loss"]) and stats["avg_exp_per_second"] > 0
    assert [s for s, _ in stats["train_loss_log"]] == [2, 4]
    assert all(np.isfinite(v) for _, v in stats["train_loss_log"])
    assert 0.0 <= stats["training_accuracy_top_1"] <= 1.0


def test_lm_main_eval_returns_masked_mean():
    stats = lm_main.main(["--use_synthetic_data", "--device", "cpu",
                          "--model", "transformer_small", "--seq_len", "16",
                          "--num_classes", "128", "--batch_size", "4",
                          "--train_steps", "2", "--log_steps", "1",
                          "--skip_eval", "false", "--dtype", "bf16",
                          "--skip_checkpoint"])
    assert np.isfinite(stats["eval_loss"])
    assert 0.0 <= stats["accuracy_top_1"] <= 1.0


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the refusal needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_main.main(["--use_synthetic_data", "--model", "transformer_small",
                      "--train_steps", "1"])


def test_build_stats_is_the_jax_build_stats():
    history = {"loss": [3.0, 2.5], "sparse_categorical_accuracy": [0.1, 0.2]}
    port_cb, jax_cb = logs.TimeHistory(8, 2), jlogs.TimeHistory(8, 2)
    port_cb.timestamp_log = [logs.BatchTimestamp(1, 10.0),
                             logs.BatchTimestamp(3, 12.0)]
    jax_cb.timestamp_log = [jlogs.BatchTimestamp(1, 10.0),
                            jlogs.BatchTimestamp(3, 12.0)]
    port = logs.build_stats(history, (1.5, 0.25), port_cb)
    ref = jlogs.build_stats(history, (1.5, 0.25), jax_cb)
    port.pop("step_timestamp_log")
    ref.pop("step_timestamp_log")
    assert port == ref


def test_flash_attention_binding_is_the_module_global():
    """The model calls ``flash_attention`` through its module, so a run
    can bind another formulation (functools.partial(...,
    fused_bwd=False)) without a package flag."""
    assert transformer.flash_attention is tfa.flash_attention
