"""The port's ZeRO stages 1-3 (dtf_tpu_torch: ``train/zero.py``, the
Trainer's stages, ``parallel/collectives.py`` ``all_gather`` and
``reduce_scatter``, the canonical checkpoint, the flags) against the JAX
package's ZeRO Trainer and against the port's own plain data
parallelism, on the CPU.

The port side is two gloo processes started with the launcher's
environment (``cli/launch.py build_env``), as ``tests/test_torch_dp.py``
starts them; each job in a worker joins a process group of its own.
Against the JAX ZeRO Trainer on a two-device mesh (``tests/conftest.py``
gives 8 virtual CPU devices), at the same stage, from the same weights,
each rank fed its half of the same numpy global batches: per-step
losses within 1e-5 relative in float32, as ``tests/test_torch_dp.py``.

Against the port's own stage 0 (plain data parallelism) every stage is
bit for bit where the arithmetic is the same: a sum of two ranks'
values does not depend on their order, and a dynamic loss scale is a
power of two.  Where the JAX tests allow a tolerance because the sums
run in another order -- the stage-2/3 accumulation carry sums the
micro-batches' reduce-scattered slices, clipping's norm sums the
slices' squares -- the port is held to that tolerance
(``tests/test_zero.py``, ``tests/test_zero_stages.py``: rtol 1e-5, atol
2e-6).  Checkpoints hold the stage-0 payload, so a save at one stage and
a resume at another continue the uninterrupted run bit for bit.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models import build_model as jax_build_model
from dtf_tpu.runtime.mesh import MeshRuntime as JaxMeshRuntime
from dtf_tpu.runtime.mesh import make_mesh
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu.train import zero as jax_zero
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.cli.launch import build_env
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.parallel import collectives
from dtf_tpu_torch.serve import bridge
from dtf_tpu_torch.train import zero
from test_torch_dp import CASES, _batches, _initial, _jax_spec, _np
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV

torch.set_num_threads(1)

# every gloo group this file's ranks start gives up on a dead peer within
# 120 s (runtime/mesh.py TIMEOUT_ENV), well inside the suite's limit
os.environ.setdefault(TIMEOUT_ENV, "120")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, STEPS = 2, 3
TIMEOUT_S = 180
RTOL, ATOL = 1e-5, 2e-6     # the JAX ZeRO tests' tolerances

# one port rank: each job in turn, each in a process group of its own
WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.config.flags import apply_env_topology
from dtf_tpu_torch.parallel import collectives
from dtf_tpu_torch.runtime.mesh import initialize

args = json.loads(sys.argv[1])
build = runner.build_model_for
weights = {}


def with_weights(cfg, spec, device, bn_group=None, **kw):
    model, l2 = build(cfg, spec, device, bn_group, **kw)
    if weights.get("path"):
        model.load_state_dict(torch.load(weights["path"]))
    return model, l2


runner.build_model_for = with_weights
for i, job in enumerate(args["jobs"]):
    cfg = apply_env_topology(Config(**job["cfg"]))
    cfg = cfg.replace(coordinator_address="file://%s.%d" % (args["rdv"], i))
    out = job["out"]
    if job["kind"] == "run":
        stats = runner.run(cfg)
        rank = cfg.process_id
        with open("%s%d.json" % (out, rank), "w") as f:
            json.dump({"losses": [v for _, v in stats["train_loss_log"]],
                       "resident": stats["resident_bytes"],
                       "zero_probe": stats.get("zero_probe")}, f)
        continue
    rt = initialize(cfg)
    if job["kind"] == "collectives":
        g = rt.group
        x = torch.arange(10, dtype=torch.float32) * (rt.rank + 1)
        total = x.clone()
        torch.distributed.all_reduce(total, group=g)
        np.savez("%s%d.npz" % (out, rt.rank),
                 backend=torch.distributed.get_backend(g),
                 scattered=collectives.reduce_scatter(x, g).numpy(),
                 total=total.numpy(),
                 gathered=collectives.all_gather(x[:3], g).numpy())
        # every rank past its last collective before any tears the group
        # down: under load a rank that closed first aborted its peer
        # ("terminate called without an active exception")
        torch.distributed.barrier(group=g)
        rt.shutdown()
        continue
    weights["path"] = job.get("weights")
    trainer, state, _, _ = runner.build_training(cfg, rt)
    data = np.load(job["batches"])
    n = data["x"].shape[1] // rt.num_replicas
    rows = slice(rt.rank * n, (rt.rank + 1) * n)
    losses = []
    for step in range(data["x"].shape[0]):
        x, y = (torch.from_numpy(data[k][step, rows]) for k in ("x", "y"))
        state, m = trainer.train_step(state, x, y)
        losses.append(float(m["loss"]))
    resident = trainer.zero_resident_bytes(state)
    shapes = [list(t.shape) for t in trainer.moments(state.opt_state)]
    trainer.materialize(state)
    out_state = {k: v.detach().numpy()
                 for k, v in trainer.model.state_dict().items()}
    np.savez("%s%d.npz" % (out, rt.rank), losses=np.array(losses),
             resident=json.dumps(resident), opt_shapes=json.dumps(shapes),
             **out_state)
    rt.shutdown()
"""


def _launch(tmp_path, jobs, world=WORLD):
    """The worker over ``jobs`` in ``world`` gloo ranks; waits for
    them."""
    args = json.dumps({"jobs": jobs, "rdv": str(tmp_path / "rdv")})
    procs = []
    for rank in range(world):
        env = build_env(rank, world, f"file://{tmp_path / 'unused'}")
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs):
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def _steps_job(tmp_path, name, cfg, batches, weights=None):
    return {"kind": "steps", "cfg": cfg, "batches": batches,
            "weights": weights, "out": str(tmp_path / name)}


def _ranks(tmp_path, name, world=WORLD):
    return [dict(np.load(tmp_path / f"{name}{r}.npz"))
            for r in range(world)]


def _stage_flags(stage: int) -> dict:
    """Stage 1 as the JAX tests ask for it: --optimizer_sharding."""
    return ({"optimizer_sharding": True} if stage == 1
            else {"zero_stage": stage})


def _same(a: dict, b: dict, exact: bool = True):
    """Every array of rank results ``a`` equals ``b``'s (bit for bit, or
    within the JAX ZeRO tests' tolerance)."""
    for key in b:
        if key in ("resident", "opt_shapes"):
            continue
        if exact:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            np.testing.assert_allclose(a[key], b[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# the layout, the collectives and the flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("numel,nd", [(1, 2), (7, 2), (8, 2), (10, 4)])
def test_layout_is_the_jax_layout(numel, nd):
    """pad_flat and slice_leaf cut a leaf as the JAX package's do; the
    slices gathered back (world 1 per slice here) give the leaf."""
    from jax.sharding import PartitionSpec as P
    p = np.arange(numel, dtype=np.float32).reshape(-1, 1) + 1
    want = np.asarray(jax_zero.pad_flat(jax.numpy.asarray(p), nd))
    np.testing.assert_array_equal(zero.pad_flat(torch.from_numpy(p),
                                                nd).numpy(), want)
    slices = [zero.slice_leaf(torch.from_numpy(p), nd, i) for i in range(nd)]
    for i, s in enumerate(slices):
        np.testing.assert_array_equal(s.numpy(), np.asarray(
            jax_zero.slice_leaf(P(), jax.numpy.asarray(p), nd, i)))
        assert s.shape == zero.slice_zeros(torch.from_numpy(p), nd).shape
    full = torch.cat(slices)[:numel].view(p.shape)
    assert torch.equal(full, torch.from_numpy(p))
    assert zero.slice_len(numel, nd) == slices[0].numel()


def test_replicated_sentinel_and_sharded_leaves():
    """The step count -- the JAX layout's replicated leaf -- stays whole
    in the sliced optimizer state while the moments are sliced; an
    expert leaf keeps its local shape (the JAX ``zero_leaf_spec`` of a
    leaf sharded over 'data'), and the MoE flags parse."""
    from dtf_tpu_torch.train.loop import Trainer
    from dtf_tpu_torch.train.optimizer import AdamWState
    opt = AdamWState(count=3, mu=[torch.arange(3.0)],
                     nu=[torch.arange(3.0) + 1])
    sliced = Trainer._opt_map(opt, lambda i, t: zero.slice_leaf(t, 2, 1))
    assert sliced.count == 3
    assert torch.equal(sliced.mu[0], torch.tensor([2.0, 0.0]))
    assert torch.equal(sliced.nu[0], torch.tensor([3.0, 0.0]))
    # expert parallelism is ported since: the flags parse with the JAX
    # defaults, and an expert leaf keeps its local shape at every stage
    # (train/zero.py; tests/test_torch_ep.py)
    cfg = parse_flags(["--zero_stage", "3", "--num_experts", "4"])
    assert (cfg.zero_stage, cfg.num_experts, cfg.moe_top_k) == (3, 4, None)
    w = torch.arange(6.0).view(3, 2)
    assert torch.equal(zero.slice_leaf(w, 2, 1, expert=True), w)
    assert zero.slice_zeros(w, 2, expert=True).shape == w.shape
    # tensor parallelism is ported since: a model-sharded leaf slices
    # its local shard over the data axis (tests/test_torch_tp.py)
    assert parse_flags(["--zero_stage", "3", "--model_parallelism",
                        "2"]).model_parallelism == 2


def test_collectives_without_a_group_are_the_identity():
    x = torch.arange(4.0)
    assert collectives.all_gather(x, None) is x
    assert collectives.reduce_scatter(x, None) is x
    # world 1 without a group: the slices are the leaf, the scatter
    # the mean of one
    s = zero.scatter_leaf(x.view(2, 2), 1, None)
    assert s.dtype == torch.float32 and torch.equal(s, x)


def test_gloo_reduce_scatter_is_an_all_reduce_then_the_slice(tmp_path):
    """gloo: reduce_scatter is the all-reduce's own slice of the rank
    (the per-backend rule of ``parallel/collectives.py``) and
    all_gather the ranks' tensors in rank order."""
    _wait(_launch(tmp_path, [{"kind": "collectives", "cfg": dict(
        device="cpu", distribution_strategy="multi_worker_mirrored"),
        "out": str(tmp_path / "c")}]))
    ranks = _ranks(tmp_path, "c")
    x = [np.arange(10, dtype=np.float32) * (r + 1) for r in range(WORLD)]
    for r, got in enumerate(ranks):
        assert str(got["backend"]) == "gloo"
        np.testing.assert_array_equal(got["total"], x[0] + x[1])
        np.testing.assert_array_equal(got["scattered"],
                                      got["total"][5 * r:5 * (r + 1)])
        np.testing.assert_array_equal(got["gathered"],
                                      np.concatenate([x[0][:3], x[1][:3]]))


def test_zero_stage_flag_validation():
    with pytest.raises(ValueError, match="zero_stage"):
        Config(zero_stage=4)
    with pytest.raises(ValueError, match="optimizer_sharding"):
        Config(optimizer_sharding=True, zero_stage=2)
    with pytest.raises(ValueError, match="zero_probe"):
        Config(zero_probe=True)  # needs stage >= 2
    assert Config(zero_stage=2).zero_stage_effective == 2
    assert Config(optimizer_sharding=True).zero_stage_effective == 1
    assert Config().zero_stage_effective == 0
    from dtf_tpu.config import parse_flags as jax_parse_flags
    for argv in (["--zero_stage", "3"], ["--optimizer_sharding"], []):
        assert (parse_flags(argv).zero_stage_effective
                == jax_parse_flags(argv).zero_stage_effective)


def test_zero_wire_validation():
    with pytest.raises(ValueError, match="zero_wire"):
        Config(zero_wire="fp8")
    with pytest.raises(ValueError, match="zero_wire"):
        Config(zero_wire="bf16")              # needs stage >= 2
    with pytest.raises(ValueError, match="zero_wire"):
        Config(zero_wire="bf16", optimizer_sharding=True)  # stage 1
    assert Config(zero_wire="bf16", zero_stage=2).zero_wire == "bf16"
    assert Config(zero_stage=3).zero_wire == "fp32"
    assert zero.wire_dtype("bf16") == torch.bfloat16
    assert zero.wire_dtype("fp32") == torch.float32


# ---------------------------------------------------------------------------
# stages 1-3 against the JAX ZeRO Trainer on a two-device mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("name", ["resnet20", "transformer_small"])
def test_zero_ranks_match_the_jax_zero_trainer(tmp_path, name, stage):
    case = CASES[name]
    x, y = _batches(case, case["batch_size"])
    np.savez(tmp_path / "batches.npz", x=x, y=y)
    jflags = {k: v for k, v in case.items() if k not in ("model",
                                                         "batch_size")}
    jcfg = JaxConfig(model=case["model"], skip_checkpoint=True, model_dir="",
                     distribution_strategy="multi_worker_mirrored",
                     batch_size=case["batch_size"], train_steps=STEPS,
                     use_synthetic_data=True, skip_eval=True,
                     **_stage_flags(stage), **jflags)
    rt = JaxMeshRuntime(mesh=make_mesh(jax.devices()[:WORLD], data=WORLD),
                        strategy="multi_worker_mirrored",
                        shard_seq=case["dataset"] == "lm")
    jmodel, l2 = jax_build_model(case["model"],
                                 num_classes=case.get("num_classes"))
    jtrainer = JaxTrainer(jcfg, rt, jmodel, l2, _jax_spec(case))
    # the ZeRO state of the JAX init, then the weights both packages
    # start from, placed through the canonical form
    zstate = jtrainer.init_state(jax.random.key(0), (x[0], y[0]))
    initial, plain = _initial(case, jmodel, jtrainer, rt, x)
    canon = jtrainer.canonical_state(zstate)
    jstate = jtrainer.staged_state(canon.replace(
        params=_np(plain.params), batch_stats=_np(plain.batch_stats)))
    weights = str(tmp_path / "weights.pt")
    torch.save(initial, weights)
    cfg = dict(case, device="cpu", train_steps=STEPS, seed=0,
               use_synthetic_data=True, skip_eval=True,
               distribution_strategy="multi_worker_mirrored",
               **_stage_flags(stage))
    procs = _launch(tmp_path, [_steps_job(
        tmp_path, "z", cfg, str(tmp_path / "batches.npz"), weights)])
    jl = []
    for step in range(STEPS):
        jstate, m = jtrainer.train_step(
            jstate, *rt.shard_batch((x[step], y[step])))
        jl.append(float(m["loss"]))
    _wait(procs)
    ranks = _ranks(tmp_path, "z")
    _same(ranks[1], ranks[0])
    np.testing.assert_allclose(ranks[0]["losses"], jl, rtol=1e-5)


# ---------------------------------------------------------------------------
# stages 1-3 against the port's own plain data parallelism
# ---------------------------------------------------------------------------

SELF_CASES = {
    # test_zero_matches_plain_dp / test_stage23_match_plain_dp
    "plain": dict(model="resnet20", dataset="cifar10", optimizer="sgd",
                  batch_size=8),
    # test_zero_with_grad_accum_matches (stage 1 slices the accumulated
    # gradient: bit for bit); stages 2-3 accumulate in slices
    "grad_accum": dict(model="resnet20", dataset="cifar10",
                       optimizer="sgd", batch_size=8, grad_accum_steps=2),
    # test_zero_with_dynamic_loss_scale
    "dynamic_scale": dict(model="resnet20", dataset="cifar10",
                          optimizer="sgd", batch_size=8, dtype="fp16",
                          loss_scale="dynamic"),
    # test_zero_with_clipping_matches: the norm from the slices' squares
    "clip": dict(model="transformer_small", dataset="lm",
                 optimizer="adamw", batch_size=4, num_classes=64,
                 seq_len=16, clip_grad_norm=0.05),
}


@pytest.mark.parametrize("name", sorted(SELF_CASES))
def test_zero_stages_match_the_ports_plain_dp(tmp_path, name):
    case = SELF_CASES[name]
    x, y = _batches(case, case["batch_size"])
    np.savez(tmp_path / "batches.npz", x=x, y=y)
    base = dict(case, device="cpu", train_steps=STEPS, seed=0,
                use_synthetic_data=True, skip_eval=True,
                distribution_strategy="multi_worker_mirrored")
    _wait(_launch(tmp_path, [
        _steps_job(tmp_path, f"s{st}", dict(base, **_stage_flags(st)),
                   str(tmp_path / "batches.npz")) for st in range(4)]))
    stages = [_ranks(tmp_path, f"s{st}") for st in range(4)]
    ref = stages[0][0]
    for st, ranks in enumerate(stages):
        _same(ranks[1], ranks[0])
        exact = not (name == "clip" and st > 0
                     or name == "grad_accum" and st >= 2)
        _same(ranks[0], ref, exact=exact)
    # the layout: optimizer moments as flat slices of ceil(numel / 2),
    # the resident bytes falling stage by stage
    n = json.loads(str(ref["resident"]))["n"]
    resident = [json.loads(str(s[0]["resident"])) for s in stages]
    assert [r["total_bytes"] for r in resident] == sorted(
        {r["total_bytes"] for r in resident}, reverse=True)
    moments = 2 if case["optimizer"] == "adamw" else 1
    slice_elems = resident[2]["grad_bytes"] // 4     # sum of ceil(numel/2)
    assert n <= 2 * slice_elems < n + 2 * len(json.loads(str(
        stages[0][0]["opt_shapes"])))
    for st in (1, 2, 3):
        shapes = json.loads(str(stages[st][0]["opt_shapes"]))
        assert all(len(s) == 1 for s in shapes)
        assert sum(s[0] for s in shapes) == moments * slice_elems
    assert resident[3]["param_bytes"] < resident[2]["param_bytes"]
    assert resident[2]["grad_bytes"] < resident[1]["grad_bytes"]


def test_zero_wire_bf16_tracks_f32_within_tolerance(tmp_path):
    """--zero_wire bf16: the stage-2 scatter sums in bf16, the slices
    stay f32: losses within the JAX test's 5e-2 of the fp32 wire's."""
    case = SELF_CASES["plain"]
    x, y = _batches(case, case["batch_size"])
    np.savez(tmp_path / "batches.npz", x=x, y=y)
    base = dict(case, device="cpu", train_steps=STEPS, seed=0,
                use_synthetic_data=True, skip_eval=True, zero_stage=2,
                distribution_strategy="multi_worker_mirrored")
    _wait(_launch(tmp_path, [
        _steps_job(tmp_path, wire, dict(base, zero_wire=wire),
                   str(tmp_path / "batches.npz"))
        for wire in ("fp32", "bf16")]))
    f32, bf16 = (_ranks(tmp_path, w)[0]["losses"] for w in ("fp32", "bf16"))
    np.testing.assert_allclose(bf16, f32, rtol=5e-2)
    assert not np.array_equal(bf16, f32)


# ---------------------------------------------------------------------------
# the canonical checkpoint
# ---------------------------------------------------------------------------

def _run_cfg(model_dir, stage, steps, **kw):
    kw.setdefault("checkpoint_steps", 2)
    return dict(model="resnet20", dataset="cifar10", batch_size=8,
                train_steps=steps, use_synthetic_data=True, skip_eval=True,
                model_dir=str(model_dir), log_steps=1, device="cpu",
                distribution_strategy="multi_worker_mirrored",
                step_time_guard_factor=0, **_stage_flags(stage), **kw)


# save-stage -> restore-stage pairs covering every conversion direction
MATRIX = [(0, 3), (3, 0), (2, 3), (3, 2), (1, 2), (3, 3)]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The stage-0 run's per-step losses over 4 steps, two ranks."""
    tmp = tmp_path_factory.mktemp("ref")
    _wait(_launch(tmp, [{"kind": "run", "out": str(tmp / "ref"),
                         "cfg": _run_cfg(tmp / "m", 0, 4,
                                         skip_checkpoint=True)}]))
    with open(tmp / "ref0.json") as f:
        return json.load(f)["losses"]


@pytest.mark.parametrize("save_stage,restore_stage", MATRIX)
def test_checkpoint_matrix_cross_stage_trajectory_exact(
        tmp_path, uninterrupted, save_stage, restore_stage):
    """Save at stage A (the stage-0 payload on disk), resume at stage B,
    train on: the resumed steps are the uninterrupted stage-0 run's,
    bit for bit."""
    model_dir = tmp_path / "m"
    _wait(_launch(tmp_path, [
        {"kind": "run", "out": str(tmp_path / "a"),
         "cfg": _run_cfg(model_dir, save_stage, 2)},
        {"kind": "run", "out": str(tmp_path / "b"),
         "cfg": _run_cfg(model_dir, restore_stage, 4, resume=True)}]))
    for rank in range(WORLD):
        with open(tmp_path / f"b{rank}.json") as f:
            assert json.load(f)["losses"] == uninterrupted[2:]


def test_zero3_checkpoint_serves_via_bridge(tmp_path):
    """A stage-3 run's checkpoint (two ranks) loads through the serve
    bridge with full-shaped parameters equal, bit for bit, to the same
    seed's stage-0 checkpoint's."""
    lm = dict(model="transformer_small", dataset="lm", optimizer="adamw",
              num_classes=64, seq_len=16, batch_size=4)
    _wait(_launch(tmp_path, [
        {"kind": "run", "out": str(tmp_path / name),
         "cfg": dict(_run_cfg(tmp_path / name, stage, 2), **lm)}
        for name, stage in (("z3", 3), ("z0", 0))]))
    v3 = bridge.load_inference_variables(model_dir=str(tmp_path / "z3"))
    v0 = bridge.load_inference_variables(model_dir=str(tmp_path / "z0"))
    f3, f0 = (convert.flatten(v["params"]) for v in (v3, v0))
    assert set(f3) == set(f0) and len(f0) > 10
    for key, want in f0.items():
        assert tuple(f3[key].shape) == tuple(want.shape), key
        assert torch.equal(torch.as_tensor(f3[key]),
                           torch.as_tensor(want)), key
    models = []
    for name in ("z3", "z0"):
        model, _ = registry.build_model("transformer_small", num_classes=64)
        models.append(bridge.load_for_serving(
            model, model_dir=str(tmp_path / name)).state_dict())
    for key in models[1]:
        assert torch.equal(models[0][key], models[1][key]), key


def test_zero_resume_layout_mismatch_is_loud(tmp_path):
    """A checkpoint that verifies but cannot be placed into the run's
    canonical ZeRO layout (another optimizer's state) raises, and does
    not restart from step 0."""
    one = dict(distribution_strategy="off")
    runner.run(Config(**dict(_run_cfg(tmp_path, 0, 2), **one)))
    with pytest.raises(ValueError, match="canonical ZeRO checkpoint"):
        runner.run(Config(**dict(_run_cfg(tmp_path, 3, 4, resume=True),
                                 optimizer="adamw", **one)))


@pytest.mark.parametrize("eval_between", [False, True])
def test_zero3_eval_after_a_step_reads_the_new_weights(eval_between):
    """Stage 3 swaps each parameter's storage (gathered, freed), which
    keeps the parameter's version counter; a no-grad forward keeps a
    compute-dtype copy of each weight keyed by that version and the
    storage's address.  In bf16 compute at world 1, where the gathered
    parameters view the slices the update writes in place: evaluate,
    train a step, evaluate again (and once more after a second step, with
    or without an eval in between) -- each eval is the stage-0 run's at
    the same point, bit for bit."""
    torch.set_num_threads(1)
    from dtf_tpu_torch.runtime.mesh import initialize
    case = dict(model="transformer_small", dataset="lm", optimizer="adamw",
                batch_size=4, num_classes=64, seq_len=16, dtype="bf16")
    x, y = (torch.from_numpy(a) for a in _batches(case, 4))
    evals = {}
    for stage in (0, 3):
        cfg = Config(device="cpu", train_steps=2, seed=0, skip_eval=True,
                     use_synthetic_data=True, distribution_strategy="off",
                     zero_stage=stage, **case)
        trainer, state, _, _ = runner.build_training(cfg, initialize(cfg))
        ev = lambda: trainer.evaluate(state, iter([(x[0], y[0])]))
        got = [ev()]
        for step in range(2):
            state, _ = trainer.train_step(state, x[step], y[step])
            if eval_between or step:
                got.append(ev())
        evals[stage] = got
    assert evals[3] == evals[0]
    # the schedule's first step has learning rate 0; the second moves
    assert evals[0][-1] != evals[0][0]


@pytest.mark.parametrize("stage", [0, 2])
def test_fit_lets_the_initial_optimizer_state_go(tmp_path, monkeypatch,
                                                 stage):
    """runner.run hands the initial state to fit and keeps no reference:
    from the second step on, the initial optimizer moments are freed
    (at full width they are 8N bytes at stage 0, a rank's 4N at 2)."""
    import weakref
    from dtf_tpu_torch.train import loop
    torch.set_num_threads(1)
    seen, alive = [], []
    step = loop.Trainer.train_step

    def spy(self, state, *args, **kw):
        if not seen:
            seen.extend(weakref.ref(t) for t in self.moments(
                state.opt_state))
        else:
            alive.append(sum(r() is not None for r in seen))
        return step(self, state, *args, **kw)

    monkeypatch.setattr(loop.Trainer, "train_step", spy)
    runner.run(Config(**dict(_run_cfg(tmp_path, stage, 3,
                                      skip_checkpoint=True),
                             distribution_strategy="off")))
    assert len(seen) > 0 and alive == [0, 0]


def test_zero_probe_reports_exposed_communication(tmp_path):
    """--zero_probe at stage 2 (one process): the serialized scatter and
    gather, the comm-off twin's step and the exposed share are in the
    run's stats, and the twin leaves the trained state as it was."""
    cfg = dict(_run_cfg(tmp_path, 2, 3, skip_checkpoint=True),
               distribution_strategy="off")
    plain = runner.run(Config(**cfg))
    probed = runner.run(Config(**dict(cfg, zero_probe=True)))
    probe = probed["zero_probe"]
    assert probe["zero_stage"] == 2
    for key in ("scatter_wall_s", "gather_wall_s", "serialized_s",
                "step_s", "nocomm_step_s", "exposed_s", "exposed_frac"):
        assert np.isfinite(probe[key]) and probe[key] >= 0, key
    assert probed["train_loss_log"] == plain["train_loss_log"]
    assert "zero_probe" not in plain
