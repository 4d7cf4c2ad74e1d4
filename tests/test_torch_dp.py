"""The port's data parallelism (dtf_tpu_torch: runtime/mesh.py,
parallel/collectives.py, the Trainer's all-reduce, sync BN) against the
JAX package on a two-device mesh, on the CPU.

The JAX side is the JAX ``Trainer`` on ``make_mesh(jax.devices()[:2],
data=2)`` (``tests/conftest.py`` gives 8 virtual CPU devices).  The port
side is two gloo processes, started with the launcher's environment
(``cli/launch.py build_env``) and built by the runner
(``cli/runner.py build_training``): each is fed its half of the same
numpy global batches.  The weights are carried over by ``convert.py``:
the ResNets' seeded port init into the JAX state, and for the LM a
flax tree drawn with numpy into the port -- neither compiles flax's
init, so the ranks start at once and train while the JAX side
compiles its step.

Tolerances: per-step losses 1e-5 relative (float32, as the one-process
parity of ``tests/test_torch_resnet.py`` and ``test_torch_train.py``);
learning rates 1e-6; BN buffers 1e-4 of each buffer's largest |value|;
the parameters' three-step update (final minus initial) within 1e-2 of
the JAX update's L2 norm.  Float32 gradients of a ResNet at its init
move by up to a per cent between two evaluations that round apart
(ReLUs at 0 switch; ROADMAP.md Queue 3 item 5), and three SGD steps
carry that into the update -- most under sync BN, whose statistics
and gradients sum in another order on two devices than on one -- so
the update's norm is held, not each element.  The two ranks end every step with bit-identical parameters,
buffers and metrics, and ``multi_worker_mirrored`` at world 1 is bit
for bit the ``off`` path.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dtf_tpu.data.base as jdata_base
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models import build_model as jax_build_model
from dtf_tpu.runtime.mesh import MeshRuntime as JaxMeshRuntime
from dtf_tpu.runtime.mesh import make_mesh
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu.train.loop import DYNAMIC_SCALE_INIT
from dtf_tpu.train.loop import TrainState as JaxTrainState
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.cli.launch import build_env
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.parallel import collectives
from dtf_tpu_torch.runtime import mesh
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV

torch.set_num_threads(1)

# every gloo group this file's ranks start gives up on a dead peer within
# 120 s (runtime/mesh.py TIMEOUT_ENV), well inside the suite's limit
os.environ.setdefault(TIMEOUT_ENV, "120")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, STEPS, VOCAB, SEQ = 2, 3, 64, 16
TIMEOUT_S = 120

# one port rank: the runner's Trainer on the runtime the launcher's
# environment names, fed its half of each global batch
WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.config.flags import apply_env_topology
from dtf_tpu_torch.runtime.mesh import initialize

args = json.loads(sys.argv[1])
cfg = apply_env_topology(Config(**args["cfg"]))
rt = initialize(cfg)
trainer, state, _, _ = runner.build_training(cfg, rt)
if args["weights"]:
    trainer.model.load_state_dict(torch.load(args["weights"]))
data = np.load(args["batches"])
n = data["x"].shape[1] // rt.num_replicas
rows = slice(rt.rank * n, (rt.rank + 1) * n)
losses, lrs, accs = [], [], []
for step in range(data["x"].shape[0]):
    x, y = (torch.from_numpy(data[k][step, rows]) for k in ("x", "y"))
    state, m = trainer.train_step(state, x, y)
    losses.append(float(m["loss"]))
    accs.append(float(m["accuracy"]))
    lrs.append(m["learning_rate"])
out = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
np.savez(args["out"] + "%d.npz" % rt.rank, losses=np.array(losses),
         accs=np.array(accs), lrs=np.array(lrs),
         global_batch=trainer.global_batch, **out)
rt.shutdown()
"""

CASES = {
    "resnet20": dict(model="resnet20", dataset="cifar10", optimizer="sgd",
                     batch_size=8),
    "resnet20_sync_bn": dict(model="resnet20", dataset="cifar10",
                             optimizer="sgd", batch_size=8, sync_bn=True),
    # --batch_size per replica: 4 each, 8 in all, horovod's schedule
    "horovod": dict(model="resnet20", dataset="cifar10", optimizer="sgd",
                    batch_size=4, distribution_strategy="horovod"),
    "transformer_small": dict(model="transformer_small", dataset="lm",
                              optimizer="adamw", batch_size=4,
                              num_classes=VOCAB, seq_len=SEQ),
    # the step's order: accumulate, unscale, all-reduce, clip, verdict
    "transformer_small_accum_clip_dynamic": dict(
        model="transformer_small", dataset="lm", optimizer="adamw",
        batch_size=8, num_classes=VOCAB, seq_len=SEQ, grad_accum_steps=2,
        clip_grad_norm=0.05, loss_scale="dynamic"),
}


def _batches(case: dict, global_batch: int):
    rng = np.random.default_rng(5)
    if case["dataset"] == "lm":
        x = rng.integers(0, VOCAB, (STEPS, global_batch, SEQ)).astype(
            np.int32)
        return x, np.roll(x, -1, 2)
    x = (rng.normal(size=(STEPS, global_batch, 8, 8, 3)) * 60 + 127).astype(
        np.float32)
    return x, rng.integers(0, 10, (STEPS, global_batch)).astype(np.int32)


def _jax_spec(case: dict):
    spec = jdata_base.get_dataset_spec(case["dataset"])
    if case["dataset"] == "lm":
        spec = dataclasses.replace(spec, num_classes=VOCAB, seq_len=SEQ)
    return spec


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _to_port(case: dict, jstate) -> dict:
    """The JAX state's parameters (and BN statistics) as the port
    model's state dict."""
    model, _ = registry.build_model(case["model"],
                                    num_classes=case.get("num_classes"))
    if case["dataset"] == "lm":
        return convert.from_flax_params(_np(jstate.params), model)
    return convert.from_flax_vision(_np(jstate.params),
                                    _np(jstate.batch_stats), model)


def _jax_state(jtrainer, rt, params, stats):
    """A fresh JAX TrainState holding ``params``, replicated."""
    dynamic = jtrainer.dynamic_scale
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jtrainer.tx.init(params),
        loss_scale=jnp.float32(DYNAMIC_SCALE_INIT) if dynamic else None,
        good_steps=jnp.zeros((), jnp.int32) if dynamic else None)
    return jax.device_put(jstate, rt.replicated())


def _initial(case: dict, jmodel, jtrainer, rt, x):
    """(the initial port state dict, the JAX state on the same
    weights): the port's seeded init for a ResNet; for the LM, flax's
    tree drawn with numpy -- kernels and embeddings N(0, 1/fan_in),
    LayerNorm scales U(0.5, 1.5), biases N(0, 0.02)."""
    model, _ = registry.build_model(case["model"],
                                    num_classes=case.get("num_classes"))
    if case["dataset"] != "lm":
        model.init_weights(0)
        params, stats = convert.to_flax_vision(model)
        return model.state_dict(), _jax_state(jtrainer, rt, params, stats)
    shapes = jax.eval_shape(
        lambda k, t: jmodel.init(k, t, train=False), jax.random.key(0),
        jnp.asarray(x[0][:1]))["params"]
    rng = np.random.default_rng(1)

    def draw(path, sds):
        key, shape = path[-1].key, sds.shape
        if key == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if key == "bias":
            return rng.normal(0, 0.02, shape).astype(np.float32)
        return rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape).astype(
            np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return (convert.from_flax_params(params, model),
            _jax_state(jtrainer, rt, params, {}))


def _start_ranks(tmp_path, cfg: dict, weights, batches: str,
                 world: int = WORLD):
    args = json.dumps({"cfg": cfg, "weights": weights, "batches": batches,
                       "out": str(tmp_path / "rank")})
    coordinator = f"file://{tmp_path / 'rendezvous'}"
    procs = []
    for rank in range(world):
        env = build_env(rank, world, coordinator)
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, tmp_path, world: int = WORLD):
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _assert_ranks_identical(ranks):
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key],
                                      err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_gloo_ranks_match_the_jax_two_device_mesh(tmp_path, name):
    case = CASES[name]
    strategy = case.get("distribution_strategy", "multi_worker_mirrored")
    global_batch = case["batch_size"] * (
        WORLD if strategy == "horovod" else 1)
    x, y = _batches(case, global_batch)
    np.savez(tmp_path / "batches.npz", x=x, y=y)

    jflags = {k: v for k, v in case.items()
              if k not in ("model", "distribution_strategy", "batch_size")}
    jcfg = JaxConfig(model=case["model"], skip_checkpoint=True, model_dir="",
                     distribution_strategy=strategy, batch_size=global_batch,
                     train_steps=STEPS, use_synthetic_data=True,
                     skip_eval=True, **jflags)
    rt = JaxMeshRuntime(mesh=make_mesh(jax.devices()[:WORLD], data=WORLD),
                        strategy=strategy,
                        shard_seq=case["dataset"] == "lm")
    jmodel, l2 = jax_build_model(
        case["model"], num_classes=case.get("num_classes"),
        bn_axis="data" if case.get("sync_bn") else None)
    jtrainer = JaxTrainer(jcfg, rt, jmodel, l2, _jax_spec(case))
    initial, jstate = _initial(case, jmodel, jtrainer, rt, x)
    weights = None
    if case["dataset"] == "lm":
        weights = str(tmp_path / "weights.pt")
        torch.save(initial, weights)

    cfg = dict(case, device="cpu", train_steps=STEPS, seed=0,
               use_synthetic_data=True, skip_eval=True)
    procs = _start_ranks(tmp_path, cfg, weights,
                         str(tmp_path / "batches.npz"))
    jl, jlr = [], []
    for step in range(STEPS):
        jstate, m = jtrainer.train_step(
            jstate, *rt.shard_batch((x[step], y[step])))
        jl.append(float(m["loss"]))
        jlr.append(float(m["learning_rate"]))
    final = _to_port(case, jstate)
    ranks = _wait(procs, tmp_path)

    _assert_ranks_identical(ranks)
    got = ranks[0]
    assert int(got["global_batch"]) == global_batch
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
    np.testing.assert_allclose(got["lrs"], jlr, rtol=1e-6)
    for key, want in final.items():
        want = want.numpy()
        if "running_" in key:
            scale = max(np.abs(want).max(), 1e-30)
            np.testing.assert_allclose(got[key] / scale, want / scale,
                                       atol=1e-4, err_msg=key)
    keys = [k for k in final if "running_" not in k]
    step_port = np.concatenate([(got[k] - initial[k].numpy()).ravel()
                                for k in keys])
    step_jax = np.concatenate([(final[k] - initial[k]).numpy().ravel()
                               for k in keys])
    gap = np.linalg.norm(step_port - step_jax) / np.linalg.norm(step_jax)
    assert gap < 1e-2, gap


def _port_steps(cfg: Config, rt, x, y):
    """Three port steps in this process: (losses, state dict)."""
    trainer, state, _, _ = runner.build_training(cfg, rt)
    losses = []
    for step in range(STEPS):
        state, m = trainer.train_step(state, torch.from_numpy(x[step]),
                                      torch.from_numpy(y[step]))
        losses.append(m["loss"].clone())
    return losses, {k: v.clone() for k, v in
                    trainer.model.state_dict().items()}


@pytest.mark.parametrize("model", ["resnet20", "transformer_small"])
def test_world_one_multi_worker_mirrored_is_bit_identical_to_off(
        tmp_path, model):
    """A one-rank gloo group runs the all-reduce, and changes no bit."""
    case = CASES[model]
    x, y = _batches(case, case["batch_size"])
    base = dict(case, device="cpu", train_steps=STEPS,
                use_synthetic_data=True, skip_eval=True, sync_bn=True)
    off = Config(**base, distribution_strategy="off")
    want = _port_steps(off, mesh.initialize(off), x, y)
    one = Config(**base, distribution_strategy="multi_worker_mirrored",
                 coordinator_address=f"file://{tmp_path / 'rdv'}",
                 process_id=0, process_count=1)
    rt = mesh.initialize(one)
    try:
        assert rt.group is not None and rt.backend == "gloo"
        got = _port_steps(one, rt, x, y)
    finally:
        rt.shutdown()
    assert not torch.distributed.is_initialized()
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for key in want[1]:
        assert torch.equal(got[1][key], want[1][key]), key


def test_sync_bn_two_ranks_match_one_process_at_the_global_batch(tmp_path):
    """Sync BN's statistics and gradient are those of the global batch:
    two ranks of 4 examples train as one process of 8 does."""
    case = CASES["resnet20_sync_bn"]
    x, y = _batches(case, 8)
    np.savez(tmp_path / "batches.npz", x=x, y=y)
    base = dict(case, device="cpu", train_steps=STEPS,
                use_synthetic_data=True, skip_eval=True)
    cfg = Config(**dict(base, distribution_strategy="off", sync_bn=False))
    rt = mesh.initialize(cfg)
    trainer, _, _, _ = runner.build_training(cfg, rt)
    torch.save(trainer.model.state_dict(), tmp_path / "weights.pt")
    procs = _start_ranks(tmp_path, base, str(tmp_path / "weights.pt"),
                         str(tmp_path / "batches.npz"))
    losses, state = _port_steps(cfg, rt, x, y)
    got = _wait(procs, tmp_path)[0]
    np.testing.assert_allclose(got["losses"], [float(v) for v in losses],
                               rtol=1e-5)
    for key, want in state.items():
        want = want.numpy()
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got[key] / scale, want / scale,
                                   atol=1e-4, err_msg=key)


def test_collectives_are_the_identity_without_a_group():
    x = torch.arange(4.0)
    assert collectives.all_reduce_sum(x, None) is x
    assert collectives.all_reduce_mean(x, None) is x
    assert collectives.broadcast_from(x, None) is x
    assert collectives.all_reduce_mean_grad(x, None) is x
    assert torch.equal(x, torch.arange(4.0))
