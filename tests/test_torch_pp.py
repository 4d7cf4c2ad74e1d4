"""The port's pipeline parallelism in training (dtf_tpu_torch: the
runner's pipeline family -- its stages on the model axis, the auto
microbatch count, the refusals -- the Trainer's reductions, clipping,
ZeRO stages 1 and 3 over stage-local stacks, eval, ``remat_policy
"dots"`` and the full-shaped checkpoint that resumes at another pp)
against the JAX package's, on the CPU.  Mirrors the Trainer cases of
``tests/test_pipeline.py`` and ``tests/test_zero.py``'s
``test_zero_composes_with_pp`` / ``test_zero3_composes_with_pp``.

The port side is gloo ranks started with the launcher's environment
(``cli/launch.py build_env``), one launch of 2 ranks and one of 4, each
job in a process group of its own; the ranks' results are made once a
module and each test reads its part.  The JAX side is its Trainer on its
8 virtual CPU devices on a data x model mesh of the same shape: the same
tiny pipeline LM (4 layers, d 32, 4 heads, d_ff 64, vocab 64, S 16; the
registry's ``pipeline_transformer`` patched in the port), the same
flax-drawn weights (carried across by ``convert.py``), the same batches.

Tolerance: per-step Trainer losses and the eval loss at rtol 1e-5 in
float32, as the data-parallel, ZeRO, tensor- and sequence-parallel
parity tests hold them; the stages of a replica agree bit for bit.
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

import dtf_tpu.data.base as jdata_base
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models.pipeline_lm import PipelinedTransformerLM as JaxPLM
from dtf_tpu.models.pipeline_lm import pipeline_param_partition_specs
from dtf_tpu.runtime.mesh import MeshRuntime as JaxMeshRuntime
from dtf_tpu.runtime.mesh import make_mesh
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu.train import elastic as jax_elastic
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.cli.launch import build_env
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.data import get_dataset_spec
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.models.pipeline_lm import PipelinedTransformerLM
from dtf_tpu_torch.runtime import mesh
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV
from dtf_tpu_torch.train import elastic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, STEPS, BATCH = 64, 16, 3, 8
TINY = dict(num_layers=4, d_model=32, num_heads=4, d_ff=64,
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
from dtf_tpu_torch.models.partition import shard_for
from dtf_tpu_torch.models.pipeline_lm import PipelinedTransformerLM
from dtf_tpu_torch.obs.registry import default_registry
from dtf_tpu_torch.ops import flash_attention as fa
from dtf_tpu_torch.runtime.mesh import initialize

args = json.loads(sys.argv[1])
# the flash forward and backward calls (K1 and K3 on the card; their
# plain versions here)
flash = {"fwd": 0, "bwd": 0}


def counted(fn, key):
    def wrapped(*a, **kw):
        flash[key] += 1
        return fn(*a, **kw)
    return wrapped


fa.flash_forward = counted(fa.flash_forward, "fwd")
fa.flash_backward = counted(fa.flash_backward, "bwd")
registry._REGISTRY["pipeline_transformer"] = (
    functools.partial(PipelinedTransformerLM, **args["tiny"]),
    args["vocab"], 0.0)
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
    return torch.from_numpy(np.ascontiguousarray(
        a[rt.data_index * n:(rt.data_index + 1) * n]))


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
    trainer, state, _, _ = runner.build_training(cfg, rt)
    data = np.load(job["batches"])
    reg = default_registry()
    calls0 = reg.counter("ring_shift_calls").value
    flash0 = dict(flash)
    losses = []
    for step in range(data["x"].shape[0]):
        state, m = trainer.train_step(state, cut(rt, data["x"][step]),
                                      cut(rt, data["y"][step]))
        losses.append(float(m["loss"]))
    calls = reg.counter("ring_shift_calls").value - calls0
    out = {"flash_" + k: flash[k] - flash0[k] for k in flash}
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
    np.savez("%s%d.npz" % (job["out"], rt.rank), losses=np.array(losses),
             ring_calls=calls, microbatches=trainer.model.num_microbatches,
             model_index=rt.model_index, **out)
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
                pytest.fail(f"PP rank {p.pid} still running after "
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
# a data x model mesh of the same shape
CASES = {
    "pp2": (2, dict(model_parallelism=2, num_microbatches=2)),
    "pp2_interleave": (2, dict(model_parallelism=2, num_microbatches=2,
                               pipeline_interleave=2)),
    # the auto count: 4 pp = 8 divides the per-replica batch of 8
    "pp2_auto": (2, dict(model_parallelism=2)),
    "pp2_dots": (2, dict(model_parallelism=2, num_microbatches=2,
                         remat_policy="dots")),
    "pp2_clip": (2, dict(model_parallelism=2, num_microbatches=4,
                         clip_grad_norm=0.05)),
    "pp4": (4, dict(model_parallelism=4, num_microbatches=2)),
    "dp2_pp2": (4, dict(model_parallelism=2, num_microbatches=2)),
    "dp2_pp2_zero1": (4, dict(model_parallelism=2, num_microbatches=2,
                              optimizer_sharding=True)),
    "dp2_pp2_zero3": (4, dict(model_parallelism=2, num_microbatches=2,
                              zero_stage=3)),
}
# the cases that also evaluate (a masked eval set) after their steps
EVAL_CASES = ("pp2", "dp2_pp2")


def _case_cfg(flags: dict) -> dict:
    return dict(dict(model="pipeline_transformer", dataset="lm",
                     optimizer="adamw", batch_size=BATCH,
                     num_classes=VOCAB, seq_len=SEQ, device="cpu",
                     train_steps=STEPS, seed=0, dtype="fp32",
                     use_synthetic_data=True, skip_eval=True,
                     skip_checkpoint=True, log_steps=1,
                     distribution_strategy="multi_worker_mirrored"),
                **flags)


class _TinyRegistry:
    """The registry's pipeline_transformer as the tiny model, in this
    process, for as long as the context lasts."""

    def __enter__(self):
        self.saved = registry._REGISTRY["pipeline_transformer"]
        registry._REGISTRY["pipeline_transformer"] = (
            functools.partial(PipelinedTransformerLM, **TINY), VOCAB, 0.0)

    def __exit__(self, *exc):
        registry._REGISTRY["pipeline_transformer"] = self.saved


def _world1_cfg(**kw) -> Config:
    return Config(**_case_cfg(dict(distribution_strategy="off",
                                   train_steps=4, **kw)))


def _losses(stats) -> list:
    return [v for _, v in stats["train_loss_log"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port job's results: the Trainer cases, a pp 2 runner run
    checkpointing every 2 of 4 steps, and a pp 2 run resumed from a
    world-1 run's step-2 checkpoint -- one two-rank and one four-rank
    launch."""
    root = str(tmp_path_factory.mktemp("pp"))
    params = JaxPLM(vocab_size=VOCAB, **TINY, use_pallas=False).init(
        jax.random.key(0), jnp.zeros((2, SEQ), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    full = convert.from_flax_params(
        params, PipelinedTransformerLM(vocab_size=VOCAB, **TINY))
    weights = os.path.join(root, "weights.pt")
    torch.save(full, weights)
    x, y = _batches(STEPS, 5)
    batches = os.path.join(root, "batches.npz")
    np.savez(batches, x=x, y=y)
    ex, ey = _batches(2, 6)
    mask = np.ones((2, BATCH), np.float32)
    mask[1, 3] = mask[0, 0] = 0.0
    evals = os.path.join(root, "eval.npz")
    np.savez(evals, x=ex, y=ey, mask=mask)
    jobs = {2: [], 4: []}
    for name, (world, flags) in CASES.items():
        job = {"kind": "steps", "cfg": _case_cfg(flags), "weights": weights,
               "batches": batches, "out": os.path.join(root, name)}
        if name in EVAL_CASES:
            job["eval"] = evals
        jobs[world].append(job)
    # the pp 2 runner run whose checkpoint resumes at pp 1
    pp2 = dict(model_parallelism=2, num_microbatches=2, train_steps=4,
               skip_checkpoint=False, checkpoint_steps=2,
               model_dir=os.path.join(root, "ckpt_pp2"))
    jobs[2].append({"kind": "run", "cfg": _case_cfg(pp2),
                    "out": os.path.join(root, "ckpt_pp2_")})
    # a world-1 run's step-2 checkpoint, resumed at pp 2
    with _TinyRegistry():
        world1 = _losses(runner.run(_world1_cfg(
            skip_checkpoint=False, checkpoint_steps=2,
            model_dir=os.path.join(root, "ckpt_pp1"))))
    resume = os.path.join(root, "resume_pp1")
    shutil.copytree(os.path.join(root, "ckpt_pp1"), resume)
    _drop_step(resume, 4)
    jobs[2].append({"kind": "run", "cfg": _case_cfg(dict(
        model_parallelism=2, num_microbatches=2, train_steps=4,
        resume=True, model_dir=resume)),
        "out": os.path.join(root, "resumed_pp2_")})
    for world in (2, 4):
        _launch(root, jobs[world], world)
    return {"root": root, "params": params, "x": x, "y": y, "ex": ex,
            "ey": ey, "mask": mask, "world1": world1}


def _drop_step(model_dir: str, step: int) -> None:
    shutil.rmtree(os.path.join(model_dir, "checkpoints", str(step)))
    os.remove(os.path.join(model_dir, "checkpoints.meta",
                           f"manifest_{step}.json"))


def _ranks(runs, name, world):
    return [dict(np.load(os.path.join(runs["root"], f"{name}{r}.npz")))
            for r in range(world)]


def _run_losses(runs, name, rank):
    with open(os.path.join(runs["root"], f"{name}{rank}.json")) as f:
        return json.load(f)["losses"]


def _jax_trainer(world: int, flags: dict, runs, microbatches: int):
    """JAX's Trainer on a data x model mesh of the case's shape, the
    model as the JAX runner builds it, from the drawn weights:
    (trainer, runtime, state)."""
    mp = flags["model_parallelism"]
    jflags = {k: v for k, v in flags.items() if k != "num_microbatches"}
    jcfg = JaxConfig(model="pipeline_transformer", dataset="lm",
                     optimizer="adamw", batch_size=BATCH,
                     num_classes=VOCAB, seq_len=SEQ, skip_checkpoint=True,
                     model_dir="", train_steps=STEPS,
                     use_synthetic_data=True, skip_eval=True,
                     distribution_strategy="multi_worker_mirrored",
                     num_microbatches=microbatches, **jflags)
    rt = JaxMeshRuntime(mesh=make_mesh(jax.devices()[:world],
                                       data=world // mp, seq=1, model=mp),
                        strategy="multi_worker_mirrored", shard_seq=True)
    remat = flags.get("remat_policy")
    model = JaxPLM(vocab_size=VOCAB, **TINY, use_pallas=False,
                   num_microbatches=microbatches, pipe_axis="model",
                   interleave=flags.get("pipeline_interleave", 1),
                   remat=remat is not None, remat_policy=remat)
    spec = dataclasses.replace(jdata_base.get_dataset_spec("lm"),
                               num_classes=VOCAB, seq_len=SEQ)
    trainer = JaxTrainer(jcfg, rt, model, 0.0, spec,
                         param_spec_fn=functools.partial(
                             pipeline_param_partition_specs,
                             pipe_axis="model"))
    x, y = runs["x"], runs["y"]
    state = trainer.init_state(jax.random.key(0), (x[0], y[0]))
    if trainer.zero:
        canon = trainer.canonical_state(state)
        state = trainer.staged_state(canon.replace(params=runs["params"]))
    else:
        state = state.replace(params=jax.device_put(
            runs["params"], jax.tree_util.tree_map(lambda a: a.sharding,
                                                   state.params)))
    return trainer, rt, state


def _jax_run(runs, world: int, flags: dict, microbatches: int,
             evaluate: bool):
    trainer, rt, state = _jax_trainer(world, flags, runs, microbatches)
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
# the Trainer against the JAX PP Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_trainer_matches_the_jax_pp_trainer(runs, name):
    """Per-step losses of the port's grid (pp 2, GPipe and interleaved,
    the auto microbatch count, ``remat_policy="dots"``, clipping; pp 4;
    data 2 x pp 2, plain and under ZeRO stages 1 and 3) against JAX's
    Trainer on the same mesh shape, rtol 1e-5 in float32; every rank
    agrees bit for bit on the loss, and the data ranks of a stage on its
    weights."""
    world, flags = CASES[name]
    ranks = _ranks(runs, name, world)
    mp = flags["model_parallelism"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    for r in range(mp, world):
        for key in ranks[r]:
            if key in dict(PipelinedTransformerLM(
                    vocab_size=VOCAB, **TINY).named_parameters()):
                np.testing.assert_array_equal(ranks[r][key],
                                              ranks[r % mp][key],
                                              err_msg=key)
    jl, _ = _jax_run(runs, world, flags, int(ranks[0]["microbatches"]),
                     evaluate=False)
    np.testing.assert_allclose(ranks[0]["losses"], jl, rtol=RTOL)


@pytest.mark.parametrize("name", EVAL_CASES)
def test_pp_eval_matches_jax(runs, name):
    """Eval after the steps, the pipeline forward under no_grad: the
    loss and top-1 summed over the data group with the per-example mask,
    against JAX's eval on the same mesh (rtol 1e-5); the count is the
    unmasked tokens, on every stage."""
    world, flags = CASES[name]
    ranks = _ranks(runs, name, world)
    _, (jloss, jtop1) = _jax_run(runs, world, flags,
                                 int(ranks[0]["microbatches"]),
                                 evaluate=True)
    for r in ranks:
        assert float(r["eval_count"]) == runs["mask"].sum() * SEQ
        np.testing.assert_allclose(float(r["eval_loss"]), jloss, rtol=RTOL)
        np.testing.assert_allclose(float(r["eval_top1"]), jtop1, rtol=RTOL)


@pytest.mark.parametrize("stage", ["zero1", "zero3"])
def test_zero_composes_with_pp(runs, stage):
    """ZeRO stages 1 and 3 slice each stage-local stack over the data
    group: the same trajectory as plain PP (rtol 1e-5) and the same
    weights on each stage after the steps."""
    plain = _ranks(runs, "dp2_pp2", 4)
    zero = _ranks(runs, f"dp2_pp2_{stage}", 4)
    for p, z in zip(plain, zero):
        np.testing.assert_allclose(z["losses"], p["losses"], rtol=RTOL)
        np.testing.assert_allclose(z["qkv_k"], p["qkv_k"], rtol=1e-4,
                                   atol=1e-6)


def test_dots_remat_matches_no_remat(runs):
    """``--remat_policy dots`` on the pipeline: the no-remat run's
    losses within rtol 1e-5."""
    for d, p in zip(_ranks(runs, "pp2_dots", 2), _ranks(runs, "pp2", 2)):
        np.testing.assert_allclose(d["losses"], p["losses"], rtol=RTOL)


def test_auto_microbatches():
    """--num_microbatches unset: 4 pp, halved until it divides the
    per-replica batch (the JAX runner's rule; its test's M = 8 at pp 2
    and a per-replica batch of 8)."""
    def auto(pp, per_replica):
        return runner.pipeline_kw(Config(model_parallelism=pp),
                                  per_replica)["num_microbatches"]
    assert auto(2, 8) == 8
    assert auto(2, 4) == 4
    assert auto(2, 6) == 2
    assert auto(4, 32) == 16
    assert auto(3, 5) == 1
    assert runner.pipeline_kw(Config(model_parallelism=2,
                                     num_microbatches=2), 8) == {
        "num_microbatches": 2}


def test_auto_microbatches_reach_the_model(runs):
    """The pp 2 run with no --num_microbatches built its stages at
    M = 8 (per-replica batch 8), the others at their flag's M."""
    for r in _ranks(runs, "pp2_auto", 2):
        assert int(r["microbatches"]) == 8
    for r in _ranks(runs, "dp2_pp2", 4):
        assert int(r["microbatches"]) == 2


def test_ring_traffic_as_predicted(runs):
    """The activations' shifts a step, as the schedules make them: every
    tick forward and all but the last backward -- (M + pp - 1) + (M + pp
    - 2) for GPipe, 2 (2 pp ceil(M / pp) + pp - 1) - 1 interleaved."""
    for name in ("pp2", "pp2_auto", "pp2_interleave", "pp4", "dp2_pp2"):
        world, flags = CASES[name]
        pp = flags["model_parallelism"]
        for r in _ranks(runs, name, world):
            m = int(r["microbatches"])
            ticks = (m + pp - 1 if "interleave" not in name
                     else 2 * pp * -(-m // pp) + pp - 1)
            assert int(r["ring_calls"]) == STEPS * (2 * ticks - 1), name


def test_flash_calls_as_predicted(runs):
    """The flash attention a step on each stage, as the schedules make
    it (K1 and K3 on the card): every tick runs the stage's layers (half
    of them interleaved), bubble ticks included, one forward and one
    backward each -- under ``dots`` too (the attention is never
    recomputed)."""
    for name in ("pp2", "pp2_auto", "pp2_interleave", "pp2_dots", "pp4",
                 "dp2_pp2_zero3"):
        world, flags = CASES[name]
        pp = flags["model_parallelism"]
        local = TINY["num_layers"] // pp
        for r in _ranks(runs, name, world):
            m = int(r["microbatches"])
            if "interleave" in name:
                want = (2 * pp * -(-m // pp) + pp - 1) * local // 2
            else:
                want = (m + pp - 1) * local
            assert int(r["flash_fwd"]) == int(r["flash_bwd"]) == \
                STEPS * want, name


# ---------------------------------------------------------------------------
# the checkpoint across pp
# ---------------------------------------------------------------------------

def test_pp2_checkpoint_resumes_at_pp1(runs, tmp_path):
    """The pp 2 runner run trains the world-1 run's losses; its step-2
    checkpoint is full-shaped (the stacked leaves gathered over the
    stages), and resumed at pp 1 in one process it continues the pp 2
    run's steps 3-4 within rtol 1e-5."""
    from dtf_tpu_torch.train.checkpoint import Checkpointer
    pp2 = _run_losses(runs, "ckpt_pp2_", 0)
    assert _run_losses(runs, "ckpt_pp2_", 1) == pp2
    np.testing.assert_allclose(pp2, runs["world1"], rtol=RTOL)
    model_dir = str(tmp_path / "m")
    shutil.copytree(os.path.join(runs["root"], "ckpt_pp2"), model_dir)
    payload = Checkpointer(model_dir).restore(step=2)
    assert tuple(payload["params/qkv_k"].shape) == (4, 32, 96)
    assert tuple(payload["opt_state/adam/mu/fc1_k"].shape) == (4, 32, 64)
    _drop_step(model_dir, 4)
    with _TinyRegistry():
        resumed = _losses(runner.run(_world1_cfg(
            resume=True, skip_checkpoint=True, model_dir=model_dir)))
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, pp2[2:], rtol=RTOL)


def test_pp1_checkpoint_resumes_at_pp2(runs):
    """A world-1 run's step-2 checkpoint, resumed at pp 2 (each stage
    cutting its layers of the full leaves and moments), continues the
    world-1 run's steps 3-4 within rtol 1e-5, both stages alike."""
    for rank in (0, 1):
        resumed = _run_losses(runs, "resumed_pp2_", rank)
        assert len(resumed) == 2
        np.testing.assert_allclose(resumed, runs["world1"][2:], rtol=RTOL)


# ---------------------------------------------------------------------------
# refusals and the repairs
# ---------------------------------------------------------------------------

def _lm_cfg(**kw):
    return Config(**_case_cfg(kw))


def test_interleave_without_stages_is_refused():
    """--pipeline_interleave 2 at --model_parallelism 1 raises the JAX
    message before any model is built."""
    rt = mesh.MeshRuntime(strategy="off")
    with pytest.raises(ValueError, match=r"--pipeline_interleave > 1 needs "
                       r"pipeline stages: set --model_parallelism > 1"):
        runner.build_training(_lm_cfg(distribution_strategy="off",
                                      pipeline_interleave=2), rt)


def test_shard_lm_head_with_the_pipeline_family_is_refused():
    """--shard_lm_head is the plain transformer's: with the pipeline
    family at pp 2 it raises the JAX message."""
    spec = get_dataset_spec("lm")
    with pytest.raises(ValueError, match="--shard_lm_head needs the plain "
                       "transformer family with --model_parallelism > 1"):
        runner.build_model_for(_lm_cfg(model_parallelism=2,
                                       shard_lm_head=True), spec,
                               torch.device("cpu"))


@pytest.mark.parametrize("model", ["pipeline_transformer",
                                   "pipeline_transformer_small"])
def test_fp16_with_the_pipeline_family_is_refused(model):
    """The pipeline family runs the attention kernels, which have no
    fp16 route: --dtype fp16 is refused as for the transformers."""
    with pytest.raises(ValueError, match="float32 and bfloat16 routes"):
        parse_flags(["--model", model, "--dtype", "fp16"])
    assert parse_flags(["--model", model, "--dtype", "bf16"]).dtype == "bf16"


def test_pipeline_family_is_an_lm_not_a_vision_model():
    """The registry's pipeline entries build the stacked LM with the
    JAX defaults and take the LM's random init (N(0, 0.02) embeddings,
    unit scales), never a vision model's init or layout."""
    assert not registry.is_vision("pipeline_transformer")
    assert registry.is_pipeline("pipeline_transformer_small")
    model, l2 = registry.build_model("pipeline_transformer")
    assert l2 == 0.0
    assert (model.num_layers, model.d_model, model.num_heads, model.d_ff,
            model.vocab_size, model.max_seq_len) == (12, 512, 8, 2048,
                                                     32768, 2048)
    small, _ = registry.build_model("pipeline_transformer_small")
    assert (small.num_layers, small.d_model, small.num_heads,
            small.d_ff) == (4, 256, 4, 1024)
    spec = dataclasses.replace(get_dataset_spec("lm"), num_classes=256,
                               seq_len=32)
    built, _ = runner.build_model_for(
        _lm_cfg(model="pipeline_transformer_small", num_classes=256,
                distribution_strategy="off"), spec, torch.device("cpu"))
    assert isinstance(built, PipelinedTransformerLM)
    assert abs(float(built.embed.detach().std()) - 0.02) < 2e-3
    assert torch.equal(built.ln1_s, torch.ones_like(built.ln1_s))
    assert float(built.qkv_b.detach().abs().max()) == 0.0
    std = float(built.fc2_k.detach().std())
    assert abs(std - 1024 ** -0.5) < 0.1 * 1024 ** -0.5


def test_check_reshardable_names_the_stacked_leaves():
    """A model axis that does not divide num_layers is refused naming
    each stacked leaf -- the leaves the JAX rule names on its
    pipeline specs at the same worlds."""
    stage = PipelinedTransformerLM(vocab_size=VOCAB, **TINY,
                                   model_parallelism=2)
    full = PipelinedTransformerLM(vocab_size=VOCAB, **TINY)
    splits = {n: stage.split(n) for n, _ in stage.named_parameters()}
    shapes = {n: tuple(p.shape) for n, p in full.named_parameters()}
    jparams = {n: jax.ShapeDtypeStruct(s, np.float32)
               for n, s in shapes.items()}
    jspecs = pipeline_param_partition_specs(jparams, "model")
    for dp, mp in ((1, 2), (2, 4), (1, 3), (3, 3), (1, 8)):
        world = {"data": dp, "seq": 1, "model": mp}
        got = {m.split(":")[0] for m in elastic.check_reshardable(
            splits, shapes, world)}
        want = {m.split("']")[0].split("['")[1] for m in
                jax_elastic.check_reshardable(jspecs, jparams, world)}
        assert got == want, (dp, mp)
    bad = elastic.check_reshardable(splits, shapes,
                                    {"data": 1, "model": 3})
    assert {b.split(":")[0] for b in bad} == set(
        pipeline_param_partition_specs(jparams, "model")) - {
            "embed", "pos_embed", "ln_f_s", "ln_f_b", "head_k", "head_b"}
    assert any(b.startswith("qkv_k: dim 0 (4,") for b in bad)
