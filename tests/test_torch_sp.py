"""The port's sequence parallelism in training (dtf_tpu_torch:
``runtime/mesh.py``'s data x seq x model grid, ring attention in the
transformer, the runner's seq columns, the Trainer's reductions over
data x seq, ZeRO's seq mean, the latch, the checkpoint and serving an
SP-trained checkpoint) against the JAX package's, on the CPU.  Mirrors
the SP cases of ``tests/test_tensor_parallel.py``
(``test_tp_with_seq_parallel``, ``test_remat_policy_composes_with_tp_and_sp``)
and the JAX Trainer at ``seq_parallelism`` 2 and 4.

The port side is gloo ranks started with the launcher's environment
(``cli/launch.py build_env``), one launch of 2 ranks and one of 4, each
job in a process group of its own; the ranks' results are made once a
module and each test reads its part.  The JAX side runs on its 8
virtual CPU devices (``tests/conftest.py``) on a mesh of the same shape:
the same tiny model (2 layers, d 32, 4 heads, d_ff 64, vocab 64, S 16,
an L2 weight of 1e-3; the registry's transformer patched in both
packages), the same weights drawn with numpy, the same batches.

Tolerance: per-step Trainer losses and the eval loss at rtol 1e-5 in
float32, as the data-parallel, ZeRO and tensor-parallel parity tests
hold them; the seq ranks of a replica agree bit for bit.
"""

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import dtf_tpu.data.base as jdata_base
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models.transformer import param_partition_specs
from dtf_tpu.runtime.mesh import MeshRuntime as JaxMeshRuntime
from dtf_tpu.runtime.mesh import make_mesh
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import runner, serve_main
from dtf_tpu_torch.cli.launch import build_env
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.data import get_dataset_spec
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.runtime import mesh
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV
from dtf_tpu_torch.serve.engine import ServeEngine
from dtf_tpu_torch.train import loop
# the tensor-parallel tests' tiny model, its numpy-drawn weights and
# its L2 weight: both grids train the same function
from test_torch_tp import (L2, SEQ, TINY, VOCAB, _draw_params, _jax_model,
                           _port_model)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH = 3, 4
RTOL = 1e-5
# each rank's wait for its peers, and the test's for its ranks
GROUP_TIMEOUT_S, TIMEOUT_S = 60, 240

# one port rank: each job in turn, each in a process group of its own
WORKER = r"""
import faulthandler
# a rank still running near the test's limit prints every thread's
# stack and exits, so a hang shows where it waits
faulthandler.dump_traceback_later(@DUMP_S@, exit=True)
import functools, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.config.flags import apply_env_topology
from dtf_tpu_torch.models import partition, registry
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.obs.registry import default_registry
from dtf_tpu_torch.runtime.mesh import initialize
from dtf_tpu_torch.train import preemption

args = json.loads(sys.argv[1])
registry._REGISTRY["transformer"] = (
    functools.partial(TransformerLM, **args["tiny"]), args["vocab"],
    args["l2"])
build = runner.build_model_for
weights = {}


def with_weights(cfg, spec, device, bn_group=None, **kw):
    model, l2 = build(cfg, spec, device, bn_group, **kw)
    if weights.get("path"):
        model.load_state_dict(partition.shard_state_dict(
            torch.load(weights["path"]), model.model_parallelism,
            model.model_index, model.shard_vocab))
    return model, l2


runner.build_model_for = with_weights


def cut(rt, a, seq_axis=True):
    n = a.shape[0] // rt.num_replicas
    a = a[rt.data_index * n:(rt.data_index + 1) * n]
    if seq_axis:
        c = a.shape[1] // rt.seq_parallelism
        a = a[:, rt.seq_index * c:(rt.seq_index + 1) * c]
    return torch.from_numpy(np.ascontiguousarray(a))


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
    losses, latches = [], []
    if job["kind"] == "latch":
        preemption.install()
    reg = default_registry()
    calls0 = reg.counter("ring_shift_calls").value
    for step in range(data["x"].shape[0]):
        if job["kind"] == "latch" and step == 1 and rt.rank == job["latcher"]:
            # one rank of the grid alone takes the signal
            preemption.latch()
        state, m = trainer.train_step(state, cut(rt, data["x"][step]),
                                      cut(rt, data["y"][step]))
        losses.append(float(m["loss"]))
        latches.append(float(m["preempt"]))
    calls = reg.counter("ring_shift_calls").value - calls0
    if job["kind"] == "latch":
        preemption.restore()
    out = {}
    if "eval" in job:
        ev = np.load(job["eval"])
        batches = [(cut(rt, ev["x"][j]), cut(rt, ev["y"][j]),
                    cut(rt, ev["mask"][j], seq_axis=False))
                   for j in range(ev["x"].shape[0])]
        loss, top1 = trainer.evaluate(state, iter(batches))
        out.update(eval_loss=loss, eval_top1=top1,
                   eval_count=trainer.eval_count)
    trainer.materialize(state)
    out.update({k: v.detach().numpy()
                for k, v in trainer.model.state_dict().items()})
    np.savez("%s%d.npz" % (job["out"], rt.rank), losses=np.array(losses),
             latches=np.array(latches), ring_calls=calls, **out)
    # every rank past its last collective before any tears it down
    torch.distributed.barrier()
    rt.shutdown()
""".replace("@DUMP_S@", str(TIMEOUT_S - 30))


def _launch(root, jobs, world):
    args = json.dumps({"jobs": jobs, "rdv": os.path.join(root, "rdv"),
                       "tiny": TINY, "vocab": VOCAB, "l2": L2})
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
                pytest.fail(f"SP rank {p.pid} still running after "
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
# a data x seq x model mesh of the same shape
CASES = {
    "sp2": (2, dict(seq_parallelism=2)),
    "sp2_accum_clip": (2, dict(seq_parallelism=2, grad_accum_steps=2,
                               clip_grad_norm=0.05)),
    "sp4": (4, dict(seq_parallelism=4)),
    "dp2_sp2_zero1": (4, dict(seq_parallelism=2, optimizer_sharding=True)),
    "dp2_sp2_zero3": (4, dict(seq_parallelism=2, zero_stage=3,
                              clip_grad_norm=0.05)),
    "tp2_sp2": (4, dict(seq_parallelism=2, model_parallelism=2)),
    "tp2_sp2_dots": (4, dict(seq_parallelism=2, model_parallelism=2,
                             remat_policy="dots")),
}
# the cases that also evaluate (a masked eval set) after their steps
EVAL_CASES = ("sp2", "tp2_sp2")


def _case_cfg(flags: dict) -> dict:
    return dict(model="transformer", dataset="lm", optimizer="adamw",
                batch_size=BATCH, num_classes=VOCAB, seq_len=SEQ,
                device="cpu", train_steps=STEPS, seed=0,
                use_synthetic_data=True, skip_eval=True,
                skip_checkpoint=True, log_steps=1,
                distribution_strategy="multi_worker_mirrored", **flags)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port job's results: the Trainer cases, the latch over a
    data 1 x seq 2 x model 2 grid, and a runner run at sp 2
    checkpointing every 2 of 4 steps, from one two-rank and one
    four-rank launch."""
    root = str(tmp_path_factory.mktemp("sp"))
    params = _draw_params()
    full = convert.from_flax_params(jax.tree_util.tree_map(np.asarray,
                                                           params),
                                    _port_model())
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
    jobs[4].append({"kind": "latch", "cfg": _case_cfg(dict(
        seq_parallelism=2, model_parallelism=2)), "weights": weights,
        "batches": batches, "latcher": 3,
        "out": os.path.join(root, "latch")})
    ckpt = dict(_case_cfg(dict(seq_parallelism=2)), train_steps=4,
                skip_checkpoint=False, checkpoint_steps=2,
                model_dir=os.path.join(root, "ckpt_model"),
                export_dir=os.path.join(root, "export"))
    jobs[2].append({"kind": "run", "cfg": ckpt,
                    "out": os.path.join(root, "ckpt")})
    for world in (2, 4):
        _launch(root, jobs[world], world)
    return {"root": root, "params": params, "full": full, "x": x, "y": y,
            "ex": ex, "ey": ey, "mask": mask}


def _ranks(runs, name, world):
    return [dict(np.load(os.path.join(runs["root"], f"{name}{r}.npz")))
            for r in range(world)]


def _jax_trainer(world: int, flags: dict, runs):
    """JAX's Trainer on a data x seq x model mesh of the case's shape,
    from the drawn weights: (trainer, runtime, state)."""
    mp = flags.get("model_parallelism", 1)
    sp = flags["seq_parallelism"]
    jcfg = JaxConfig(model="transformer", dataset="lm", optimizer="adamw",
                     batch_size=BATCH, num_classes=VOCAB, seq_len=SEQ,
                     skip_checkpoint=True, model_dir="", train_steps=STEPS,
                     use_synthetic_data=True, skip_eval=True,
                     distribution_strategy="multi_worker_mirrored",
                     **flags)
    rt = JaxMeshRuntime(mesh=make_mesh(jax.devices()[:world],
                                       data=world // (mp * sp), seq=sp,
                                       model=mp),
                        strategy="multi_worker_mirrored", shard_seq=True)
    model = _jax_model(seq_axis="seq",
                       model_axis="model" if mp > 1 else None,
                       remat_policy=flags.get("remat_policy"))
    spec = dataclasses.replace(jdata_base.get_dataset_spec("lm"),
                               num_classes=VOCAB, seq_len=SEQ)
    trainer = JaxTrainer(
        jcfg, rt, model, L2, spec,
        param_spec_fn=(functools.partial(param_partition_specs,
                                         model_axis="model")
                       if mp > 1 else None))
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
# the Trainer against JAX seq_parallelism 2 and 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_sp_trainer_matches_the_jax_sp_trainer(runs, name):
    """Per-step losses of the port's grid (seq 2 and 4; data 2 x seq 2
    under ZeRO stages 1 and 3; model 2 x seq 2, plain and under
    ``remat_policy="dots"``) against JAX's trainer on the same mesh
    shape, rtol 1e-5 in float32; every rank agrees bit for bit on the
    loss, and the seq and data ranks of a model shard on its weights."""
    world, flags = CASES[name]
    ranks = _ranks(runs, name, world)
    mp = flags.get("model_parallelism", 1)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    for r in range(mp, world):
        for key in ranks[r]:
            if key.startswith(("block", "embed", "pos", "ln_f", "lm_")):
                np.testing.assert_array_equal(ranks[r][key],
                                              ranks[r % mp][key],
                                              err_msg=key)
    jl, _ = _jax_run(runs, world, flags, evaluate=False)
    np.testing.assert_allclose(ranks[0]["losses"], jl, rtol=RTOL)


@pytest.mark.parametrize("name", EVAL_CASES)
def test_sp_eval_matches_jax(runs, name):
    """Eval after the steps: the loss and top-1 summed over data x seq
    with the per-example mask split over data only, against JAX's eval
    on the same mesh (rtol 1e-5); the count is the unmasked tokens."""
    world, flags = CASES[name]
    ranks = _ranks(runs, name, world)
    _, (jloss, jtop1) = _jax_run(runs, world, flags, evaluate=True)
    for r in ranks:
        assert float(r["eval_count"]) == runs["mask"].sum() * SEQ
        np.testing.assert_allclose(float(r["eval_loss"]), jloss, rtol=RTOL)
        np.testing.assert_allclose(float(r["eval_top1"]), jtop1, rtol=RTOL)


def test_ring_rides_every_layer_forward_and_backward(runs):
    """The ring's traffic a step, as the code predicts it: per layer,
    K and V rotated sp times forward (the last result unused) and sp - 1
    times backward; under ``dots`` the same (the checkpointed regions
    surround the ring, which is never recomputed)."""
    layers = TINY["num_layers"]
    for name in ("sp2", "sp4", "tp2_sp2", "tp2_sp2_dots"):
        world, flags = CASES[name]
        sp = flags["seq_parallelism"]
        for r in _ranks(runs, name, world):
            assert int(r["ring_calls"]) == STEPS * layers * 2 * (
                sp + sp - 1), name


def test_preemption_latch_reaches_every_rank_of_the_grid(runs):
    """Rank 3 of a data 1 x seq 2 x model 2 grid latches a signal before
    step 2: that step's latch is set on all four ranks (over data x seq,
    then over the model axis)."""
    for rank in _ranks(runs, "latch", 4):
        assert list(rank["latches"][:3]) == [0.0, 1.0, 1.0]


# ---------------------------------------------------------------------------
# the checkpoint and serving
# ---------------------------------------------------------------------------

def _tiny_registry(monkeypatch):
    monkeypatch.setitem(registry._REGISTRY, "transformer", (
        functools.partial(TransformerLM, **TINY), VOCAB, L2))


def test_sp_checkpoint_resumes_at_sp1(runs, tmp_path, monkeypatch):
    """The sp 2 runner run (its seq columns cut by the runner from the
    synthetic stream) trains the world-1 run's losses; its step-2
    checkpoint is full-shaped with one writer, and resumed at sp 1 in
    one process it continues the sp 2 run's steps 3-4 within rtol
    1e-5."""
    from dtf_tpu_torch.train.checkpoint import Checkpointer
    _tiny_registry(monkeypatch)
    with open(os.path.join(runs["root"], "ckpt0.json")) as f:
        sp2 = json.load(f)["losses"]
    with open(os.path.join(runs["root"], "ckpt1.json")) as f:
        assert json.load(f)["losses"] == sp2
    base = dict(_case_cfg({}), distribution_strategy="off", train_steps=4)
    world1 = [v for _, v in runner.run(Config(**base))["train_loss_log"]]
    np.testing.assert_allclose(sp2, world1, rtol=RTOL)
    model_dir = str(tmp_path / "m")
    shutil.copytree(os.path.join(runs["root"], "ckpt_model"), model_dir)
    payload = Checkpointer(model_dir).restore(step=2)
    assert tuple(payload["params/pos_embed"].shape) == (SEQ, 32)
    assert tuple(payload["params/block0/attn/qkv/kernel"].shape) == (
        32, 3, 4, 8)
    shutil.rmtree(os.path.join(model_dir, "checkpoints", "4"))
    os.remove(os.path.join(model_dir, "checkpoints.meta",
                           "manifest_4.json"))
    stats = runner.run(Config(**dict(base, resume=True,
                                     skip_checkpoint=True,
                                     model_dir=model_dir)))
    resumed = [v for _, v in stats["train_loss_log"]]
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, sp2[2:], rtol=RTOL)


def test_serve_main_on_an_sp_checkpoint_is_token_exact(runs, monkeypatch):
    """serve_main on the sp 2 run's export (no seq group: decode drops
    it) decodes, greedy, the tokens of an engine over the same weights
    loaded by hand."""
    from dtf_tpu_torch.train.checkpoint import load_exported_model
    _tiny_registry(monkeypatch)
    export = os.path.join(runs["root"], "export")
    cfg = parse_flags(["--device", "cpu", "--model", "transformer",
                       "--num_classes", str(VOCAB), "--export_dir", export,
                       "--serve_max_batch", "3", "--kv_page_size", "4",
                       "--serve_prefill_chunk", "8",
                       "--serve_max_delay_ms", "0"])
    _, engine = serve_main.build_serving_engine(cfg)
    model = _port_model()
    model.load_state_dict(convert.from_flax_params(
        load_exported_model(export)["params"], model))
    direct = ServeEngine(model.eval(), max_batch=3, max_seq_len=SEQ,
                         kv_page_size=4, prefill_chunk=8,
                         prefix_sharing=False, max_delay_s=0.0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, (n,)).astype(np.int32)
               for n in (1, 5, 8)]
    tokens = []
    for eng in (engine, direct):
        try:
            hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            tokens.append([h.result(timeout=120).tokens for h in hs])
        finally:
            eng.stop(drain=False)
    assert tokens[0] == tokens[1]
    assert all(len(t) == 6 for t in tokens[0])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _lm_cfg(**kw):
    return Config(**dict(_case_cfg({}), **kw))


def test_seq_len_indivisible_by_sp_is_refused():
    """The Trainer refuses seq_len % sp (the JAX message)."""
    rt = mesh.MeshRuntime(strategy="multi_worker_mirrored",
                          seq_parallelism=3)
    spec = dataclasses.replace(get_dataset_spec("lm"), num_classes=VOCAB,
                               seq_len=SEQ)
    with pytest.raises(ValueError, match=r"seq_len 16 must be divisible "
                       r"by seq_parallelism \(3\)"):
        loop.Trainer(_lm_cfg(seq_parallelism=3), _port_model(), 0.0, spec,
                     runtime=rt)


def test_pipeline_family_with_sp_is_refused():
    """pipeline_transformer x SP raises the JAX message before any model
    is built."""
    rt = mesh.MeshRuntime(strategy="off")
    with pytest.raises(ValueError, match="pipeline_transformer does not "
                       "compose with seq_parallelism"):
        runner.build_training(_lm_cfg(model="pipeline_transformer_small",
                                      seq_parallelism=2), rt)


def test_async_ps_refuses_seq_parallelism():
    """--ps_mode async keeps the JAX refusal: its workers have no grid."""
    cfg = Config(device="cpu", model="transformer_small", dataset="lm",
                 num_classes=VOCAB, seq_len=SEQ, batch_size=2,
                 train_steps=1, use_synthetic_data=True, skip_eval=True,
                 skip_checkpoint=True, seq_parallelism=2,
                 distribution_strategy="parameter_server", ps_mode="async")
    with pytest.raises(ValueError, match="seq_parallelism.*single-device"):
        runner.run(cfg)


@pytest.mark.parametrize("world,sp,mp", [(6, 4, 1), (2, 2, 2), (4, 3, 1)])
def test_indivisible_world_is_refused(world, sp, mp):
    """A world mp x sp does not divide raises the JAX message before any
    rendezvous (an elastic shrink to such a world is refused here)."""
    cfg = Config(device="cpu", seq_parallelism=sp, model_parallelism=mp,
                 process_count=world, process_id=0,
                 coordinator_address="localhost:1",
                 distribution_strategy="multi_worker_mirrored")
    with pytest.raises(ValueError, match=f"{world} devices not divisible "
                       rf"by model_parallelism\*seq_parallelism={mp * sp}"):
        mesh.initialize(cfg)


def test_grid_layout_is_the_jax_mesh():
    """Rank r sits where ``reshape(dp, sp, mp)`` puts device r: data
    index r // (sp mp), seq index (r // mp) % sp, model index r % mp;
    the reduce group (data x seq) and slice group (data x model) are
    the ranks of one model index and of one seq index."""
    world, sp, mp = 8, 2, 2
    grid = np.arange(world).reshape(world // (sp * mp), sp, mp)
    axes = mesh.grid_ranks(world, mp, sp)
    assert sorted(map(sorted, axes["data"])) == sorted(
        sorted(grid[:, s, m]) for s in range(sp) for m in range(mp))
    assert sorted(map(sorted, axes["seq"])) == sorted(
        sorted(grid[d, :, m]) for d in range(2) for m in range(mp))
    assert sorted(map(sorted, axes["model"])) == sorted(
        sorted(grid[d, s, :]) for d in range(2) for s in range(sp))
    assert sorted(map(sorted, axes["reduce"])) == sorted(
        sorted(grid[:, :, m].ravel()) for m in range(mp))
    assert sorted(map(sorted, axes["slice"])) == sorted(
        sorted(grid[:, s, :].ravel()) for s in range(sp))
    for r in range(world):
        rt = mesh.MeshRuntime(strategy="multi_worker_mirrored", rank=r,
                              model_parallelism=mp, seq_parallelism=sp)
        d, s, m = np.argwhere(grid == r)[0]
        assert (rt.data_index, rt.seq_index, rt.model_index) == (d, s, m)
