"""The port's expert parallelism in training (dtf_tpu_torch: the
``all_to_all`` collective, the MoE family's two placements -- experts
over the data axis, or over the model axis under
``--model_parallelism`` -- the runner's expert shards, the Trainer's
expert-leaf reductions, clipping, ZeRO stages 1 and 3, ``remat_policy
"dots"``, sequence parallelism, eval and the full-shaped checkpoint that
resumes at another dp) against the JAX package's, on the CPU.  Mirrors
the multi-device cases of ``tests/test_moe.py`` and
``tests/test_zero.py``'s ``test_zero_composes_with_ep``,
``test_zero_composes_with_ep_on_model_axis`` and
``test_zero3_composes_with_ep``.

The port side is gloo ranks started with the launcher's environment
(``cli/launch.py build_env``), one launch of 2 ranks and one of 4, each
job in a process group of its own; the ranks' results are made once a
module and each test reads its part.  The JAX side runs on its 8
virtual CPU devices on a mesh of the same shape: the tiny MoE of
``tests/test_moe.py`` (2 layers, both routed, d 32, 4 heads, d_ff 64,
4 experts, vocab 64, S 16; the registry's ``moe_transformer`` patched
in the port), the same flax-drawn weights (carried across by
``convert.py``), each port rank fed the JAX shard's tokens.

Tolerance: per-step Trainer losses, logits, gradients and the eval loss
at rtol 1e-5 in float32; the all_to_all exactly; the ranks of a run
agree bit for bit on the loss.
"""

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import dtf_tpu.data.base as jdata_base
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models.moe import MoETransformerLM as JaxMoE
from dtf_tpu.models.moe import moe_param_partition_specs
from dtf_tpu.runtime.mesh import MeshRuntime as JaxMeshRuntime
from dtf_tpu.runtime.mesh import make_mesh
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu.train import elastic as jax_elastic
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.cli.launch import build_env
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.data import get_dataset_spec
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.models.moe import MoETransformerLM, expert_rule
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV
from dtf_tpu_torch.train import elastic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, STEPS, BATCH = 64, 16, 3, 8
# tests/test_moe.py tiny_moe / tiny_moe_registry (the expert count and
# capacity factor come from the flags, as there)
TINY = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, moe_every=1,
            max_seq_len=SEQ)
RTOL = 1e-5
# each rank's wait for its peers, and the test's for its ranks
GROUP_TIMEOUT_S, TIMEOUT_S = 60, 300

# one port rank: each job in turn, each in a process group of its own
WORKER = r"""
import faulthandler
faulthandler.dump_traceback_later(@DUMP_S@, exit=True)
import functools, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.config.flags import apply_env_topology
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.models.moe import MoETransformerLM
from dtf_tpu_torch.models.partition import shard_for
from dtf_tpu_torch.obs.registry import default_registry
from dtf_tpu_torch.parallel.collectives import all_reduce_mean, all_to_all
from dtf_tpu_torch.runtime.mesh import initialize

args = json.loads(sys.argv[1])
registry._REGISTRY["moe_transformer"] = (
    functools.partial(MoETransformerLM, **args["tiny"]), args["vocab"], 0.0)
build = runner.build_model_for
weights = {}


def with_weights(cfg, spec, device, bn_group=None, **kw):
    model, l2 = build(cfg, spec, device, bn_group, **kw)
    if weights.get("path"):
        model.load_state_dict(shard_for(model, torch.load(weights["path"])))
    return model, l2


runner.build_model_for = with_weights


def cut(rt, a):
    n = a.shape[0] // rt.num_replicas
    a = a[rt.data_index * n:(rt.data_index + 1) * n]
    if a.ndim > 1:
        c = a.shape[1] // rt.seq_parallelism
        a = a[:, rt.seq_index * c:(rt.seq_index + 1) * c]
    return torch.from_numpy(np.ascontiguousarray(a))


def a2a(rt, job):
    # the layout and the backward of the tiled exchange, per case
    out = {}
    rank, n = rt.rank, rt.num_replicas
    for e in job["experts"]:
        shape = (e, 3, 2)
        base = torch.arange(float(np.prod(shape))).view(shape)
        x = (base + 1000 * rank).requires_grad_()
        y = all_to_all(x, rt.data_group, 0, 1)
        dy = (base[: e // n].repeat(1, n, 1) + 1) * (rank + 1)
        y.backward(dy)
        out["y_e%d" % e] = y.detach().numpy()
        out["dx_e%d" % e] = x.grad.numpy()
    return out


def grads(rt, job):
    # EP logits and the Trainer's reduction of the gradients of a loss
    model = MoETransformerLM(vocab_size=args["vocab"], num_experts=4,
                             capacity_factor=100.0, expert_axis="data",
                             expert_parallelism=rt.num_replicas,
                             expert_index=rt.data_index, **args["tiny"])
    model.load_state_dict(shard_for(model, torch.load(job["weights"])))
    model.set_expert_group(rt.data_group)
    tokens = cut(rt, np.load(job["batches"])["tokens"])
    logits = model(tokens.long())
    loss = -torch.log_softmax(logits, -1)[..., 0].mean()
    loss.backward()
    out = {"logits": logits.detach().numpy()}
    for name, p in model.named_parameters():
        g = p.grad
        if model.split(name) is None:
            g = all_reduce_mean(g.clone(), rt.data_group)
        else:
            g = g / rt.num_replicas
        out["grad:" + name] = g.numpy()
    return out


for i, job in enumerate(args["jobs"]):
    cfg = apply_env_topology(Config(**job["cfg"]))
    cfg = cfg.replace(coordinator_address="file://%s.%d" % (args["rdv"], i))
    weights["path"] = job.get("weights")
    if job["kind"] == "run":
        stats = runner.run(cfg)
        with open("%s%d.json" % (job["out"], cfg.process_id), "w") as f:
            json.dump({"losses": [v for _, v in stats["train_loss_log"]]}, f)
        continue
    rt = initialize(cfg)
    if job["kind"] == "a2a":
        out = a2a(rt, job)
    elif job["kind"] == "grads":
        out = grads(rt, job)
    else:
        trainer, state, _, _ = runner.build_training(cfg, rt)
        data = np.load(job["batches"])
        reg = default_registry()
        calls0 = reg.counter("all_to_all_calls").value
        bytes0 = reg.counter("all_to_all_bytes").value
        losses = []
        for step in range(data["x"].shape[0]):
            state, m = trainer.train_step(state, cut(rt, data["x"][step]),
                                          cut(rt, data["y"][step]))
            losses.append(float(m["loss"]))
        out = {"losses": np.array(losses),
               "a2a_calls": reg.counter("all_to_all_calls").value - calls0,
               "a2a_bytes": reg.counter("all_to_all_bytes").value - bytes0,
               "dropped": sum(float(l.dropped)
                              for l in trainer.model.moe_layers)}
        if "eval" in job:
            ev = np.load(job["eval"])
            batches = [(cut(rt, ev["x"][j]), cut(rt, ev["y"][j]),
                        cut(rt, ev["mask"][j]))
                       for j in range(ev["x"].shape[0])]
            loss, top1 = trainer.evaluate(state, iter(batches))
            out.update(eval_loss=loss, eval_top1=top1,
                       eval_count=trainer.eval_count)
        trainer.materialize(state)
        out.update({k: v.detach().numpy()
                    for k, v in trainer.model.state_dict().items()})
    np.savez("%s%d.npz" % (job["out"], rt.rank), data_index=rt.data_index,
             **out)
    # every rank past its last collective before any tears it down
    torch.distributed.barrier()
    rt.shutdown()
""".replace("@DUMP_S@", str(TIMEOUT_S - 30))


def _launch(root, jobs, world):
    args = json.dumps({"jobs": jobs, "rdv": os.path.join(root, "rdv"),
                       "tiny": TINY, "vocab": VOCAB})
    procs = []
    for rank in range(world):
        env = build_env(rank, world, f"file://{os.path.join(root, 'x')}")
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                   **{TIMEOUT_ENV: str(GROUP_TIMEOUT_S)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                tails = [q.communicate(timeout=10)[0][-1500:]
                         for q in procs]
                pytest.fail(f"EP rank {p.pid} still running after "
                            f"{TIMEOUT_S} s (killed); the ranks' output "
                            f"tails: {tails}")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def _batches(steps: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB, (steps, BATCH, SEQ)).astype(np.int32)
    return x, np.roll(x, -1, 2)


# every Trainer case: (world, the flags of both packages); the JAX run on
# a data x seq x model mesh of the same shape.  Experts ride the data
# axis unless --model_parallelism puts them on the model axis
CASES = {
    "dp2": (2, {}),
    # a real capacity limit: the drops are each rank's own
    "dp2_cf125": (2, dict(moe_capacity_factor=1.25)),
    "dp2_top1": (2, dict(moe_top_k=1)),
    "dp2_dots": (2, dict(remat_policy="dots")),
    "dp2_clip": (2, dict(clip_grad_norm=0.05)),
    "dp2_zero1": (2, dict(optimizer_sharding=True)),
    "dp2_zero3": (2, dict(zero_stage=3)),
    "mp2": (2, dict(model_parallelism=2)),
    "mp2_cf1": (2, dict(model_parallelism=2, moe_capacity_factor=1.0)),
    "dp4": (4, {}),
    "dp4_e16": (4, dict(num_experts=16)),
    "dp2_sp2": (4, dict(seq_parallelism=2)),
    "dp2_mp2": (4, dict(model_parallelism=2)),
    "dp2_mp2_zero1": (4, dict(model_parallelism=2, optimizer_sharding=True)),
}
# the cases that also evaluate (a masked eval set) after their steps
EVAL_CASES = ("dp2", "mp2_cf1")
# the all_to_all layout cases: the expert counts at each world (E / ep 1
# and 2)
A2A_EXPERTS = {2: [2, 4], 4: [4, 8]}


def _experts(flags: dict) -> int:
    return flags.get("num_experts", 4)


def _case_cfg(flags: dict) -> dict:
    return dict(dict(model="moe_transformer", dataset="lm",
                     optimizer="adamw", batch_size=BATCH,
                     num_classes=VOCAB, seq_len=SEQ, device="cpu",
                     train_steps=STEPS, seed=0, dtype="fp32",
                     use_synthetic_data=True, skip_eval=True,
                     skip_checkpoint=True, log_steps=1, num_experts=4,
                     moe_capacity_factor=100.0,
                     distribution_strategy="multi_worker_mirrored"),
                **flags)


def _jax_model(experts: int, **kw):
    return JaxMoE(vocab_size=VOCAB, **TINY, num_experts=experts,
                  use_pallas=False, **kw)


def _draw(experts: int):
    """The tiny MoE's flax-drawn weights: (flax params, the port's full
    state dict)."""
    params = jax.jit(_jax_model(experts).init)(
        jax.random.key(0), jnp.zeros((2, SEQ), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    full = convert.from_flax_params(
        params, MoETransformerLM(vocab_size=VOCAB, num_experts=experts,
                                 **TINY))
    return params, full


class _TinyRegistry:
    """The registry's moe_transformer as the tiny model, in this
    process, for as long as the context lasts."""

    def __enter__(self):
        self.saved = registry._REGISTRY["moe_transformer"]
        registry._REGISTRY["moe_transformer"] = (
            functools.partial(MoETransformerLM, **TINY), VOCAB, 0.0)

    def __exit__(self, *exc):
        registry._REGISTRY["moe_transformer"] = self.saved


def _losses(stats) -> list:
    return [v for _, v in stats["train_loss_log"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port job's results: the Trainer cases, the all_to_all
    layouts, EP logits and gradients at ep 2 and 4, and a dp 2 runner
    run checkpointing every 2 of 4 steps -- one two-rank and one
    four-rank launch."""
    root = str(tmp_path_factory.mktemp("ep"))
    params, weights = {}, {}
    for e in sorted({_experts(f) for _, f in CASES.values()}):
        params[e], full = _draw(e)
        weights[e] = os.path.join(root, f"weights_e{e}.pt")
        torch.save(full, weights[e])
    x, y = _batches(STEPS, 5)
    batches = os.path.join(root, "batches.npz")
    np.savez(batches, x=x, y=y)
    ex, ey = _batches(2, 6)
    mask = np.ones((2, BATCH), np.float32)
    mask[1, 3] = mask[0, 0] = 0.0
    evals = os.path.join(root, "eval.npz")
    np.savez(evals, x=ex, y=ey, mask=mask)
    tokens = _batches(1, 7)[0][0]
    probe = os.path.join(root, "tokens.npz")
    np.savez(probe, tokens=tokens)
    jobs = {2: [], 4: []}
    for name, (world, flags) in CASES.items():
        job = {"kind": "steps", "cfg": _case_cfg(flags),
               "weights": weights[_experts(flags)], "batches": batches,
               "out": os.path.join(root, name)}
        if name in EVAL_CASES:
            job["eval"] = evals
        jobs[world].append(job)
    for world in (2, 4):
        jobs[world] += [
            {"kind": "a2a", "cfg": _case_cfg({}),
             "experts": A2A_EXPERTS[world],
             "out": os.path.join(root, f"a2a{world}_")},
            {"kind": "grads", "cfg": _case_cfg({}), "weights": weights[4],
             "batches": probe, "out": os.path.join(root, f"grads{world}_")}]
    # the dp 2 runner run (a batch of 4 a rank: each rank draws the
    # world-1 run's batch) whose checkpoint resumes at dp 1
    jobs[2].append({"kind": "run", "cfg": _case_cfg(dict(
        batch_size=8, train_steps=4, skip_checkpoint=False,
        checkpoint_steps=2, model_dir=os.path.join(root, "ckpt_dp2"))),
        "weights": weights[4], "out": os.path.join(root, "ckpt_dp2_")})
    for world in (2, 4):
        _launch(root, jobs[world], world)
    return {"root": root, "params": params, "x": x, "y": y, "ex": ex,
            "ey": ey, "mask": mask, "tokens": tokens, "weights": weights}


def _ranks(runs, name, world):
    return [dict(np.load(os.path.join(runs["root"], f"{name}{r}.npz")))
            for r in range(world)]


def _run_losses(runs, name, rank):
    with open(os.path.join(runs["root"], f"{name}{rank}.json")) as f:
        return json.load(f)["losses"]


def _jax_trainer(world: int, flags: dict, runs):
    """JAX's Trainer on a data x seq x model mesh of the case's shape,
    the model as the JAX runner builds it, from the drawn weights:
    (trainer, runtime, state)."""
    mp = flags.get("model_parallelism", 1)
    sp = flags.get("seq_parallelism", 1)
    cfg = _case_cfg(flags)
    jflags = {k: v for k, v in cfg.items() if k != "device"}
    jcfg = JaxConfig(**dict(jflags, skip_checkpoint=True, model_dir=""))
    rt = JaxMeshRuntime(mesh=make_mesh(jax.devices()[:world],
                                       data=world // (mp * sp), seq=sp,
                                       model=mp),
                        strategy="multi_worker_mirrored", shard_seq=True)
    axis = "model" if mp > 1 else "data"
    remat = flags.get("remat_policy")
    model = _jax_model(
        _experts(flags), capacity_factor=cfg["moe_capacity_factor"],
        router_top_k=flags.get("moe_top_k", 2), expert_axis=axis,
        expert_axis_along_batch=mp == 1,
        seq_axis="seq" if sp > 1 else None, remat_policy=remat)
    spec = dataclasses.replace(jdata_base.get_dataset_spec("lm"),
                               num_classes=VOCAB, seq_len=SEQ)
    trainer = JaxTrainer(jcfg, rt, model, 0.0, spec,
                         param_spec_fn=functools.partial(
                             moe_param_partition_specs, expert_axis=axis))
    x, y = runs["x"], runs["y"]
    params = runs["params"][_experts(flags)]
    state = trainer.init_state(jax.random.key(0), (x[0], y[0]))
    if trainer.zero:
        canon = trainer.canonical_state(state)
        state = trainer.staged_state(canon.replace(params=params))
    else:
        state = state.replace(params=jax.device_put(
            params, jax.tree_util.tree_map(lambda a: a.sharding,
                                           state.params)))
    return trainer, rt, state


def _jax_run(runs, world: int, flags: dict, evaluate: bool):
    trainer, rt, state = _jax_trainer(world, flags, runs)
    x, y = runs["x"], runs["y"]
    losses = []
    for step in range(STEPS):
        state, m = trainer.train_step(state,
                                      *rt.shard_batch((x[step], y[step])))
        losses.append(float(m["loss"]))
    ev = None
    if evaluate:
        batches = [(runs["ex"][j], runs["ey"][j], runs["mask"][j])
                   for j in range(len(runs["mask"]))]
        ev = trainer.evaluate(state, iter(batches))
    return losses, ev


# ---------------------------------------------------------------------------
# the all_to_all
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_all_to_all_matches_the_tiled_lax_all_to_all(runs, world):
    """The port's exchange of [E, 3, 2] over ep 2 and 4 ranks (E / ep 1
    and 2) against ``lax.all_to_all(split_axis=0, concat_axis=1,
    tiled=True)`` on as many devices: the slots ordered by their source
    rank, exactly; its backward against the JAX transpose's with the
    same cotangents, exactly."""
    ranks = _ranks(runs, f"a2a{world}_", world)
    mesh = make_mesh(jax.devices()[:world], data=world, seq=1, model=1)
    for e in A2A_EXPERTS[world]:
        shape = (e, 3, 2)
        base = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        xs = np.concatenate([base + 1000 * r for r in range(world)])
        dys = np.concatenate([(np.tile(base[:e // world], (1, world, 1))
                               + 1) * (r + 1) for r in range(world)])

        def exchange(x):
            return lax.all_to_all(x, "data", split_axis=0, concat_axis=1,
                                  tiled=True)

        fn = jax.shard_map(exchange, mesh=mesh, in_specs=P("data"),
                           out_specs=P("data"), check_vma=False)
        y, vjp = jax.vjp(fn, jnp.asarray(xs))
        dx = np.asarray(vjp(jnp.asarray(dys))[0])
        y = np.asarray(y)
        ny, nx = y.shape[0] // world, e
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out[f"y_e{e}"],
                                          y[r * ny:(r + 1) * ny])
            np.testing.assert_array_equal(out[f"dx_e{e}"],
                                          dx[r * nx:(r + 1) * nx])


# ---------------------------------------------------------------------------
# EP logits and gradients against the unsharded JAX model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_ep_logits_and_grads_match_unsharded(runs, world):
    """Experts sharded over ep 2 and 4 data ranks, each rank its shard of
    the batch: the logits are the unsharded JAX model's, and with the
    Trainer's reduction (replicated leaves averaged over the group,
    expert leaves divided by ep: reverse-mode all_to_all already summed
    them) the gradients are its unsharded gradients, rtol 1e-5."""
    ranks = _ranks(runs, f"grads{world}_", world)
    model = _jax_model(4, capacity_factor=100.0)
    tokens = jnp.asarray(runs["tokens"])

    def loss_fn(p):
        logits = model.apply({"params": p}, tokens)
        return jnp.mean(jax.nn.log_softmax(logits)[..., 0] * -1.0), logits

    (_, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        runs["params"][4])
    np.testing.assert_allclose(
        np.concatenate([r["logits"] for r in ranks]), np.asarray(logits),
        rtol=RTOL, atol=1e-5)
    port = MoETransformerLM(vocab_size=VOCAB, num_experts=4, **TINY)
    want = convert.from_flax_params(jax.tree_util.tree_map(np.asarray, g),
                                    port)
    for name, w in want.items():
        got = [r["grad:" + name] for r in ranks]
        got = (np.concatenate(got) if expert_rule(name) is not None
               else got[0])
        np.testing.assert_allclose(got, w.numpy(), rtol=RTOL, atol=1e-6,
                                   err_msg=name)
    for r in ranks[1:]:
        for name in want:
            if expert_rule(name) is None:
                np.testing.assert_array_equal(r["grad:" + name],
                                              ranks[0]["grad:" + name])


# ---------------------------------------------------------------------------
# the Trainer against the JAX EP Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_ep_trainer_matches_the_jax_ep_trainer(runs, name):
    """Per-step losses (the load-balance terms included) of the port's
    grid -- experts over data 2 (plain, capacity factor 1.25 with drops,
    top-1, ``remat_policy="dots"``, clipping, ZeRO 1 and 3), over the
    model axis at mp 2 (plain and with drops), data 4 (4 and 16
    experts), data 2 x seq 2, data 2 x model 2 (plain and ZeRO 1) --
    against JAX's Trainer on the same mesh shape, rtol 1e-5 in float32;
    every rank agrees bit for bit on the loss, and the ranks that hold
    the same experts on their weights."""
    world, flags = CASES[name]
    ranks = _ranks(runs, name, world)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    mp = flags.get("model_parallelism", 1)
    if mp > 1:
        # the data ranks of one model index hold the same experts
        for r in range(mp, world):
            np.testing.assert_array_equal(ranks[r]["block0.moe.w1"],
                                          ranks[r % mp]["block0.moe.w1"])
    jl, _ = _jax_run(runs, world, flags, evaluate=False)
    np.testing.assert_allclose(ranks[0]["losses"], jl, rtol=RTOL)


@pytest.mark.parametrize("name", EVAL_CASES)
def test_ep_eval_matches_jax(runs, name):
    """Eval after the steps (no load-balance term): the loss and top-1
    summed over the data group with the per-example mask, against JAX's
    eval on the same mesh (rtol 1e-5); the count is the unmasked
    tokens, on every rank."""
    world, flags = CASES[name]
    ranks = _ranks(runs, name, world)
    _, (jloss, jtop1) = _jax_run(runs, world, flags, evaluate=True)
    for r in ranks:
        assert float(r["eval_count"]) == runs["mask"].sum() * SEQ
        np.testing.assert_allclose(float(r["eval_loss"]), jloss, rtol=RTOL)
        np.testing.assert_allclose(float(r["eval_top1"]), jtop1, rtol=RTOL)


@pytest.mark.parametrize("stage", ["dp2_zero1", "dp2_zero3",
                                   "dp2_mp2_zero1"])
def test_zero_composes_with_ep(runs, stage):
    """ZeRO stages 1 and 3 with experts on the data axis (expert leaves
    keep their local shape, divided not reduce-scattered) and stage 1
    with experts on the model axis: the plain EP run's trajectory (rtol
    1e-5) and its weights after the steps."""
    world = CASES[stage][0]
    plain = _ranks(runs, stage.rsplit("_", 1)[0], world)
    zero = _ranks(runs, stage, world)
    for p, z in zip(plain, zero):
        np.testing.assert_allclose(z["losses"], p["losses"], rtol=RTOL)
        for key in ("block0.moe.w1", "block1.moe.router.weight"):
            np.testing.assert_allclose(z[key], p[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def test_dots_remat_matches_no_remat(runs):
    """``--remat_policy dots`` with experts on the data axis: the
    no-remat run's losses within rtol 1e-5 (the routing is recomputed
    to the same choices)."""
    for d, p in zip(_ranks(runs, "dp2_dots", 2), _ranks(runs, "dp2", 2)):
        np.testing.assert_allclose(d["losses"], p["losses"], rtol=RTOL)


def test_all_to_all_traffic_as_predicted(runs):
    """The exchanges a step: two a MoE layer forward and two backward
    (two more in the dots recompute), each the [E, C, d] float32 slot
    rows, C = min(n, round(cf k n / E)) for the rank's n tokens; none
    with the experts on the model axis.  The drops of the capacity
    factor 1.25 case are each rank's own and above none."""
    layers, d = TINY["num_layers"], TINY["d_model"]
    for name, per_layer in (("dp2", 4), ("dp2_dots", 6), ("dp4", 4),
                            ("dp4_e16", 4), ("dp2_cf125", 4),
                            ("dp2_sp2", 4), ("mp2", 0), ("dp2_mp2", 0)):
        world, flags = CASES[name]
        e = _experts(flags)
        mp = flags.get("model_parallelism", 1)
        sp = flags.get("seq_parallelism", 1)
        n = BATCH // (world // (mp * sp)) * SEQ // sp
        cf = flags.get("moe_capacity_factor", 100.0)
        cap = max(1, min(n, int(round(cf * 2 * n / e))))
        for r in _ranks(runs, name, world):
            assert int(r["a2a_calls"]) == STEPS * layers * per_layer, name
            assert int(r["a2a_bytes"]) == (STEPS * layers * per_layer * e
                                           * cap * d * 4), name
    assert all(float(r["dropped"]) > 0 for r in _ranks(runs, "dp2_cf125",
                                                       2))
    assert all(float(r["dropped"]) == 0 for r in _ranks(runs, "dp2", 2))


# ---------------------------------------------------------------------------
# the checkpoint across dp
# ---------------------------------------------------------------------------

def _drop_step(model_dir: str, step: int) -> None:
    shutil.rmtree(os.path.join(model_dir, "checkpoints", str(step)))
    os.remove(os.path.join(model_dir, "checkpoints.meta",
                           f"manifest_{step}.json"))


def test_dp2_checkpoint_resumes_at_dp1(runs, tmp_path):
    """The dp 2 runner run (each rank a batch of 4, the world-1 run's
    batch) trains the world-1 run's losses; its step-2 checkpoint holds
    the full [E, ...] expert leaves and moments (gathered over the data
    group), and resumed at dp 1 in one process it continues the dp 2
    run's steps 3-4 within rtol 1e-5."""
    from dtf_tpu_torch.train.checkpoint import Checkpointer
    dp2 = _run_losses(runs, "ckpt_dp2_", 0)
    assert _run_losses(runs, "ckpt_dp2_", 1) == dp2
    world1 = dict(_case_cfg(dict(distribution_strategy="off",
                                 batch_size=4, train_steps=4)))
    with _TinyRegistry(), _weights(runs["weights"][4]):
        np.testing.assert_allclose(dp2, _losses(runner.run(Config(
            **world1))), rtol=RTOL)
    model_dir = str(tmp_path / "m")
    shutil.copytree(os.path.join(runs["root"], "ckpt_dp2"), model_dir)
    payload = Checkpointer(model_dir).restore(step=2)
    assert tuple(payload["params/block0/moe/w1"].shape) == (4, 32, 64)
    assert tuple(payload["opt_state/adam/mu/block1/moe/b2"].shape) == (
        4, 32)
    _drop_step(model_dir, 4)
    with _TinyRegistry():
        resumed = _losses(runner.run(Config(**dict(
            world1, resume=True, model_dir=model_dir))))
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, dp2[2:], rtol=RTOL)


class _weights:
    """``runner.build_model_for`` loading a full state dict (or the file
    that holds one; each rank its part), for as long as the context
    lasts."""

    def __init__(self, source):
        self.sd = (torch.load(source) if isinstance(source, str)
                   else source)

    def __enter__(self):
        from dtf_tpu_torch.models.partition import shard_for
        self.saved = build = runner.build_model_for

        def with_weights(*a, **kw):
            model, l2 = build(*a, **kw)
            model.load_state_dict(shard_for(model, self.sd))
            return model, l2

        runner.build_model_for = with_weights

    def __exit__(self, *exc):
        runner.build_model_for = self.saved


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_check_reshardable_names_the_expert_leaves():
    """A data axis that does not divide the experts is refused naming
    each expert leaf -- the leaves the JAX rule names on the
    moe_param_partition_specs at the same worlds; on the model axis
    likewise; and the runner refuses such a world before building a
    shard."""
    full = MoETransformerLM(vocab_size=VOCAB, num_experts=4, **TINY)
    names = [n for n, _ in full.named_parameters()]
    splits = {n: expert_rule(n) for n in names}
    shapes = {n: tuple(p.shape) for n, p in full.named_parameters()}
    jparams = convert.to_flax_params(full)
    for axis in ("data", "model"):
        jspecs = moe_param_partition_specs(jparams, axis)
        for ways in (1, 2, 3, 4, 8):
            world = {"data": 1, "seq": 1, "model": 1, axis: ways}
            got = {m.split(":")[0] for m in elastic.check_reshardable(
                splits, shapes, world, {n: axis for n in names})}
            # the JAX path ['block0']['moe']['w1'] is block0.moe.w1
            want = {".".join(m.split(":")[0][2:-2].split("']['"))
                    for m in jax_elastic.check_reshardable(jspecs, jparams,
                                                           world)}
            assert len(got) == (8 if ways in (3, 8) else 0), (axis, ways)
            assert got == want, (axis, ways)
    bad = elastic.check_reshardable(splits, shapes, {"data": 3},
                                    {n: "data" for n in names})
    assert any(b.startswith("block0.moe.w1: dim 0 (4,") and "data axis"
               in b for b in bad)
    spec = dataclasses.replace(get_dataset_spec("lm"), num_classes=VOCAB,
                               seq_len=SEQ)
    with _TinyRegistry(), pytest.raises(ValueError,
                                        match=r"block0\.moe\.w1: dim 0"):
        runner.build_model_for(Config(**_case_cfg({})), spec,
                               torch.device("cpu"), data_index=1,
                               data_parallelism=3)
