"""The port's tensor parallelism in training (dtf_tpu_torch:
``runtime/mesh.py``'s data x model grid, ``parallel/collectives.py``
``tp_region``/``tp_psum``, ``models/partition.py``, the shard-local
transformer, the Trainer's sharded cross-entropy, reductions, clipping,
L2 term, ZeRO composition and full-shaped checkpoint) against the JAX
package's, on the CPU.  Mirrors ``tests/test_tensor_parallel.py``.

The port side is gloo processes started with the launcher's environment
(``cli/launch.py build_env``), as ``tests/test_torch_zero.py`` starts
them, each job in a process group of its own; the ranks' results are
made once a module (setup) and each test reads its part.  The JAX side
runs on its 8 virtual CPU devices (``tests/conftest.py``): the same
tiny model (2 layers, d 32, 4 heads, d_ff 64, vocab 64, S 16; the
registry's transformer patched in both packages, with an L2 weight of
1e-3 so the sharding-aware L2 term is exercised), the same weights drawn
with numpy, the same batches.

Tolerances: the JAX tests' -- logits atol/rtol 2e-4, gradients atol
1e-5 / rtol 1e-4, the vocabulary-sharded loss rtol 1e-5 -- and per-step
Trainer losses at rtol 1e-5 in float32 (the port against JAX
``model_parallelism=2``), as the data-parallel and ZeRO parity tests
hold them.
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
from jax.sharding import NamedSharding, PartitionSpec as P

import dtf_tpu.data.base as jdata_base
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models import registry as jax_registry
from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.models.transformer import param_partition_specs
from dtf_tpu.runtime.mesh import MeshRuntime as JaxMeshRuntime
from dtf_tpu.runtime.mesh import make_mesh
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.cli.launch import build_env
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.models import partition
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.runtime import mesh
from dtf_tpu_torch.train import loop
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV

torch.set_num_threads(1)

# every gloo group this file's ranks start gives up on a dead peer within
# 120 s (runtime/mesh.py TIMEOUT_ENV), well inside the suite's limit
os.environ.setdefault(TIMEOUT_ENV, "120")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, STEPS, L2 = 64, 16, 3, 1e-3
TINY = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64,
            max_seq_len=SEQ)
TIMEOUT_S = 240
RTOL = 1e-5

# one port rank: each job in turn, each in a process group of its own
WORKER = r"""
import functools, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.config.flags import apply_env_topology
from dtf_tpu_torch.models import partition, registry
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.parallel import collectives
from dtf_tpu_torch.runtime.mesh import initialize
from dtf_tpu_torch.train import loop, preemption

args = json.loads(sys.argv[1])
tiny = args["tiny"]
registry._REGISTRY["transformer"] = (
    functools.partial(TransformerLM, **tiny), args["vocab"], args["l2"])
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


def ops(rt, job):
    g, r = rt.model_group, rt.model_index
    out = {}
    x = torch.ones(3, requires_grad=True)
    (collectives.tp_region(x, g) * (r + 1.0)).sum().backward()
    out["region_grad"] = x.grad.numpy()
    x = torch.ones(3, requires_grad=True)
    y = collectives.tp_psum(x * (r + 1.0), g)
    y.sum().backward()
    out["psum_value"], out["psum_grad"] = y.detach().numpy(), x.grad.numpy()
    full = torch.load(job["weights"])
    data = np.load(job["data"])
    tokens = torch.from_numpy(data["tokens"]).long()
    labels = torch.from_numpy(data["labels"]).long()
    mp = rt.model_parallelism
    for sv in (False, True):
        m = TransformerLM(vocab_size=args["vocab"], model_parallelism=mp,
                          model_index=r, shard_vocab=sv, **tiny)
        m.load_state_dict(partition.shard_state_dict(full, mp, r, sv))
        m.set_model_group(g)
        logits = m(tokens)
        if sv:
            loss = loop.sharded_cross_entropy(logits, labels, g)
        else:
            loss = (-torch.log_softmax(logits, -1)[..., 0]).mean()
        loss.backward()
        tag = "vocab" if sv else "tp"
        out[tag + "/logits"] = logits.detach().numpy()
        out[tag + "/loss"] = loss.detach().numpy()
        for name, p in m.named_parameters():
            out[tag + "/grad/" + name] = p.grad.numpy()
    local = data["argmax_logits"].shape[-1] // mp
    out["argmax"] = loop.sharded_argmax(torch.from_numpy(
        data["argmax_logits"][..., r * local:(r + 1) * local]), g).numpy()
    np.savez("%s%d.npz" % (job["out"], rt.rank), **out)


for i, job in enumerate(args["jobs"]):
    cfg = apply_env_topology(Config(**job["cfg"]))
    cfg = cfg.replace(coordinator_address="file://%s.%d" % (args["rdv"], i))
    if job["kind"] == "run":
        stats = runner.run(cfg)
        with open("%s%d.json" % (job["out"], cfg.process_id), "w") as f:
            json.dump({"losses": [v for _, v in stats["train_loss_log"]]}, f)
        continue
    rt = initialize(cfg)
    if job["kind"] == "ops":
        ops(rt, job)
        rt.shutdown()
        continue
    weights["path"] = job.get("weights")
    trainer, state, _, _ = runner.build_training(cfg, rt)
    data = np.load(job["batches"])
    n = data["x"].shape[1] // rt.num_replicas
    rows = slice(rt.data_index * n, (rt.data_index + 1) * n)
    losses, latches = [], []
    if job["kind"] == "latch":
        preemption.install()
    for step in range(data["x"].shape[0]):
        if job["kind"] == "latch" and step == 1 and rt.model_index == 1:
            # one model rank alone takes the signal
            preemption.latch()
        x, y = (torch.from_numpy(data[k][step, rows]) for k in ("x", "y"))
        state, m = trainer.train_step(state, x, y)
        losses.append(float(m["loss"]))
        latches.append(float(m["preempt"]))
    if job["kind"] == "latch":
        preemption.restore()
    trainer.materialize(state)
    out = {k: v.detach().numpy()
           for k, v in trainer.model.state_dict().items()}
    np.savez("%s%d.npz" % (job["out"], rt.rank), losses=np.array(losses),
             latches=np.array(latches), **out)
    rt.shutdown()
"""


def _launch(root, jobs, world):
    args = json.dumps({"jobs": jobs, "rdv": os.path.join(root, "rdv"),
                       "tiny": TINY, "vocab": VOCAB, "l2": L2})
    procs = []
    for rank in range(world):
        env = build_env(rank, world, f"file://{os.path.join(root, 'x')}")
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def _jax_model(**kw):
    return JaxLM(vocab_size=VOCAB, **TINY, **kw)


def _port_model(**kw):
    return TransformerLM(vocab_size=VOCAB, **TINY, **kw)


def _draw_params():
    """flax's parameter tree of the tiny model drawn with numpy:
    kernels and embeddings N(0, 1/fan_in), LayerNorm scales U(0.5,
    1.5), biases N(0, 0.02)."""
    shapes = jax.eval_shape(
        lambda k, t: _jax_model().init(k, t), jax.random.key(0),
        jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(1)

    def draw(path, sds):
        key, shape = path[-1].key, sds.shape
        if key == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if key == "bias":
            return rng.normal(0, 0.02, shape).astype(np.float32)
        return rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batches(global_batch: int):
    rng = np.random.default_rng(5)
    x = rng.integers(0, VOCAB, (STEPS, global_batch, SEQ)).astype(np.int32)
    return x, np.roll(x, -1, 2)


# every Trainer case: (world, the port's and JAX's flags); the JAX run
# on a data x model mesh of the same shape
CASES = {
    "tp": (2, dict(model_parallelism=2)),
    "tp_accum_clip": (2, dict(model_parallelism=2, grad_accum_steps=2,
                              clip_grad_norm=0.05)),
    "tp_vocab": (2, dict(model_parallelism=2, shard_lm_head=True)),
    "dp2_tp2_zero1": (4, dict(model_parallelism=2,
                              optimizer_sharding=True)),
    "dp2_tp2_zero3": (4, dict(model_parallelism=2, zero_stage=3,
                              clip_grad_norm=0.05)),
}
BATCH = 4


def _case_cfg(flags: dict) -> dict:
    return dict(model="transformer", dataset="lm", optimizer="adamw",
                batch_size=BATCH, num_classes=VOCAB, seq_len=SEQ,
                device="cpu", train_steps=STEPS, seed=0,
                use_synthetic_data=True, skip_eval=True,
                skip_checkpoint=True, log_steps=1,
                distribution_strategy="multi_worker_mirrored", **flags)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port job's results: the collectives and the sharded model
    (``ops``), the Trainer cases, and a run checkpointing every 2 of 4
    steps at mp 2, from one two-rank and one four-rank launch."""
    root = str(tmp_path_factory.mktemp("tp"))
    params = _draw_params()
    full = convert.from_flax_params(jax.tree_util.tree_map(np.asarray,
                                                           params),
                                    _port_model())
    weights = os.path.join(root, "weights.pt")
    torch.save(full, weights)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, VOCAB, (2, SEQ)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (2, SEQ)).astype(np.int32)
    amax = rng.normal(size=(3, 5, VOCAB)).astype(np.float32)
    # ties across the two shards and within one: the lowest index wins
    amax[0, 0, [3, 40]] = amax[0, 0].max() + 1
    amax[1, 2, [35, 50]] = amax[1, 2].max() + 1
    data = os.path.join(root, "ops.npz")
    np.savez(data, tokens=tokens, labels=labels, argmax_logits=amax)
    x, y = _batches(BATCH)
    batches = os.path.join(root, "batches.npz")
    np.savez(batches, x=x, y=y)
    jobs = {2: [], 4: []}
    base = _case_cfg({})
    jobs[2].append({"kind": "ops", "cfg": dict(base, model_parallelism=2),
                    "weights": weights, "data": data,
                    "out": os.path.join(root, "ops")})
    for name, (world, flags) in CASES.items():
        jobs[world].append({"kind": "steps", "cfg": _case_cfg(flags),
                            "weights": weights, "batches": batches,
                            "out": os.path.join(root, name)})
    jobs[2].append({"kind": "latch", "cfg": _case_cfg(dict(
        model_parallelism=2)), "weights": weights, "batches": batches,
        "out": os.path.join(root, "latch")})
    ckpt = dict(_case_cfg(dict(model_parallelism=2)), train_steps=4,
                skip_checkpoint=False, checkpoint_steps=2,
                model_dir=os.path.join(root, "ckpt_model"),
                export_dir=os.path.join(root, "export"))
    jobs[2].append({"kind": "run", "cfg": ckpt,
                    "out": os.path.join(root, "ckpt")})
    for world in (2, 4):
        _launch(root, jobs[world], world)
    return {"root": root, "params": params, "full": full, "tokens": tokens,
            "labels": labels, "argmax_logits": amax, "x": x, "y": y}


def _ranks(runs, name, world):
    return [dict(np.load(os.path.join(runs["root"], f"{name}{r}.npz")))
            for r in range(world)]


# ---------------------------------------------------------------------------
# the f and g operators, the partition rule
# ---------------------------------------------------------------------------

def test_tp_region_and_tp_psum_vjp(runs):
    """tp_region: identity forward, sum backward (1 + 2 on every rank);
    tp_psum: sum forward, identity backward -- the JAX custom_vjps'
    semantics, not a raw all-reduce both ways."""
    for r, rank in enumerate(_ranks(runs, "ops", 2)):
        np.testing.assert_array_equal(rank["region_grad"], 3.0 * np.ones(3))
        np.testing.assert_array_equal(rank["psum_value"], 3.0 * np.ones(3))
        np.testing.assert_array_equal(rank["psum_grad"],
                                      (r + 1.0) * np.ones(3))


@pytest.mark.parametrize("shard_vocab", [False, True])
def test_partition_rule_cuts_every_leaf_as_the_jax_specs(shard_vocab):
    """Each port parameter's shard, in its flax layout, is the JAX
    PartitionSpec's slice of the flax leaf; unshard joins the shards
    back; replicated leaves are whole on every shard (the JAX test's
    rule table, leaf by leaf, for every leaf)."""
    params = _draw_params()
    specs = param_partition_specs(params, "model", shard_vocab=shard_vocab)
    full = _port_model()
    full.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), full))
    flat_params = convert.flatten(jax.tree_util.tree_map(np.asarray, params))
    flat_specs = dict(jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda s: isinstance(s, P)))
    spec_of = {"/".join(k.key for k in path): spec
               for path, spec in flat_specs.items()}
    sd = full.state_dict()
    shards = [_port_model(model_parallelism=2, model_index=k,
                          shard_vocab=shard_vocab) for k in range(2)]
    for key, coll, path, layout in convert.leaves(full):
        spec = spec_of[path]
        split = partition.rule(key, shard_vocab)
        axes = [i for i, a in enumerate(spec) if a == "model"]
        assert (split is None) == (not axes), key
        parts = [partition.shard(sd[key], split, 2, k) for k in range(2)]
        for k, part in enumerate(parts):
            assert part.shape == shards[k].state_dict()[key].shape, key
            want = (np.split(flat_params[path], 2, axes[0])[k] if axes
                    else flat_params[path])
            got = convert._to_flax(part, layout, full).numpy()
            np.testing.assert_array_equal(got, want, err_msg=key)
        assert torch.equal(partition.unshard(parts, split), sd[key]), key


# ---------------------------------------------------------------------------
# the sharded model: logits, gradients, the vocabulary-sharded loss
# ---------------------------------------------------------------------------

def _jax_tp(params, tokens, labels, shard_vocab: bool):
    """JAX's TP=2 forward, loss and gradients through shard_map (the
    JAX test's construction)."""
    from dtf_tpu.train.loop import sharded_cross_entropy
    mesh = make_mesh(jax.devices()[:2], data=1, seq=1, model=2)
    model = _jax_model(model_axis="model", shard_vocab=shard_vocab,
                       use_pallas=False)
    pspecs = {"params": param_partition_specs(params, "model",
                                              shard_vocab=shard_vocab)}
    variables = jax.device_put(
        {"params": params},
        jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), pspecs,
                               is_leaf=lambda x: isinstance(x, P)))

    def local(v, t, y):
        def loss_fn(vv):
            logits = model.apply(vv, t)
            if shard_vocab:
                return sharded_cross_entropy(logits, y, "model"), logits
            return (jnp.mean(jax.nn.log_softmax(logits)[..., 0] * -1.0),
                    logits)
        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(v)
        return loss, logits, g

    out_logits = P(None, None, "model") if shard_vocab else P()
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(pspecs, P(), P()),
        out_specs=(P(), out_logits, pspecs), check_vma=False))
    loss, logits, grads = fn(variables, jnp.asarray(tokens),
                             jnp.asarray(labels))
    return (float(loss), np.asarray(logits),
            jax.tree_util.tree_map(np.asarray, grads["params"]))


def _gathered(ranks, prefix, shard_vocab):
    """{parameter: the full gradient} from the ranks' shards."""
    out = {}
    for key in ranks[0]:
        if key.startswith(prefix):
            name = key[len(prefix):]
            out[name] = partition.unshard(
                [torch.from_numpy(r[key]) for r in ranks],
                partition.rule(name, shard_vocab)).numpy()
    return out


def _unsharded(runs, vocab_loss: bool):
    model = _port_model()
    model.load_state_dict(runs["full"])
    tokens = torch.from_numpy(runs["tokens"]).long()
    logits = model(tokens)
    if vocab_loss:
        loss = loop.cross_entropy(logits,
                                  torch.from_numpy(runs["labels"]).long())
    else:
        loss = (-torch.log_softmax(logits, -1)[..., 0]).mean()
    loss.backward()
    return (float(loss.detach()), logits.detach().numpy(),
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def test_tp_logits_and_grads_match_unsharded_and_jax(runs):
    """The f/g pair leaves the logits and every parameter's gradient as
    the unsharded model's (a raw psum in place of g compounds a x mp
    error a layer), against the port's unsharded model and JAX TP."""
    ranks = _ranks(runs, "ops", 2)
    _, logits, grads = _unsharded(runs, vocab_loss=False)
    _, jlogits, jgrads = _jax_tp(runs["params"], runs["tokens"],
                                 runs["labels"], False)
    jgrads = convert.from_flax_params(jgrads, _port_model())
    for rank in ranks:
        np.testing.assert_array_equal(rank["tp/logits"],
                                      ranks[0]["tp/logits"])
        np.testing.assert_allclose(rank["tp/logits"], logits, atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(rank["tp/logits"], jlogits, atol=2e-4,
                                   rtol=2e-4)
    got = _gathered(ranks, "tp/grad/", False)
    assert sorted(got) == sorted(grads)
    for name, g in got.items():
        np.testing.assert_allclose(g, grads[name], atol=1e-5, rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(g, jgrads[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_vocab_sharded_loss_and_grads_match(runs):
    """--shard_lm_head: the collective softmax CE over local [B, S,
    V/mp] logits gives the dense CE's value (rtol 1e-5) and gradients,
    against the port's dense model and JAX's sharded CE."""
    ranks = _ranks(runs, "ops", 2)
    loss, logits, grads = _unsharded(runs, vocab_loss=True)
    jloss, jlogits, jgrads = _jax_tp(runs["params"], runs["tokens"],
                                     runs["labels"], True)
    jgrads = convert.from_flax_params(jgrads, _port_model())
    local = np.concatenate([r["vocab/logits"] for r in ranks], -1)
    np.testing.assert_allclose(local, logits, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(local, jlogits, atol=2e-4, rtol=2e-4)
    for rank in ranks:
        np.testing.assert_allclose(float(rank["vocab/loss"]), loss,
                                   rtol=RTOL)
        np.testing.assert_allclose(float(rank["vocab/loss"]), jloss,
                                   rtol=RTOL)
    got = _gathered(ranks, "vocab/grad/", True)
    for name, g in got.items():
        np.testing.assert_allclose(g, grads[name], atol=1e-5, rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(g, jgrads[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_sharded_argmax_with_ties(runs):
    """The global argmax of vocabulary-sharded logits, ties to the
    lowest index across and within shards, on every rank; JAX's
    sharded_argmax agrees."""
    from dtf_tpu.train.loop import sharded_argmax
    want = np.argmax(runs["argmax_logits"], -1)
    assert want[0, 0] == 3 and want[1, 2] == 35
    for rank in _ranks(runs, "ops", 2):
        np.testing.assert_array_equal(rank["argmax"], want)
    mesh = make_mesh(jax.devices()[:2], data=1, seq=1, model=2)
    fn = jax.jit(jax.shard_map(
        lambda lg: sharded_argmax(lg, "model"), mesh=mesh,
        in_specs=P(None, None, "model"), out_specs=P(), check_vma=False))
    np.testing.assert_array_equal(np.asarray(fn(jnp.asarray(
        runs["argmax_logits"]))), want)


# ---------------------------------------------------------------------------
# the Trainer against JAX model_parallelism=2
# ---------------------------------------------------------------------------

def _jax_losses(runs, world: int, flags: dict):
    mp = flags["model_parallelism"]
    shard_vocab = bool(flags.get("shard_lm_head"))
    jflags = {k: v for k, v in flags.items() if k != "model_parallelism"}
    jcfg = JaxConfig(model="transformer", dataset="lm", optimizer="adamw",
                     batch_size=BATCH, num_classes=VOCAB, seq_len=SEQ,
                     skip_checkpoint=True, model_dir="", train_steps=STEPS,
                     use_synthetic_data=True, skip_eval=True,
                     distribution_strategy="multi_worker_mirrored",
                     model_parallelism=mp, **jflags)
    rt = JaxMeshRuntime(mesh=make_mesh(jax.devices()[:world],
                                       data=world // mp, model=mp),
                        strategy="multi_worker_mirrored", shard_seq=True)
    model = _jax_model(model_axis="model", shard_vocab=shard_vocab)
    spec = dataclasses.replace(jdata_base.get_dataset_spec("lm"),
                               num_classes=VOCAB, seq_len=SEQ)
    trainer = JaxTrainer(
        jcfg, rt, model, L2, spec,
        param_spec_fn=functools.partial(param_partition_specs,
                                        model_axis="model",
                                        shard_vocab=shard_vocab),
        vocab_axis="model" if shard_vocab else None)
    x, y = runs["x"], runs["y"]
    state = trainer.init_state(jax.random.key(0), (x[0], y[0]))
    if trainer.zero:
        canon = trainer.canonical_state(state)
        state = trainer.staged_state(canon.replace(params=runs["params"]))
    else:
        state = state.replace(params=jax.device_put(
            runs["params"], jax.tree_util.tree_map(lambda a: a.sharding,
                                                   state.params)))
    losses = []
    for step in range(STEPS):
        state, m = trainer.train_step(state,
                                      *rt.shard_batch((x[step], y[step])))
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_trainer_matches_the_jax_tp_trainer(runs, name):
    """Per-step losses of the port's grid (mp 2; data 2 x model 2 under
    ZeRO stages 1 and 3) against JAX's trainer on the same mesh shape,
    rtol 1e-5 in float32; the model ranks of a replica agree bit for
    bit on the loss, and the data ranks of a shard on its weights."""
    world, flags = CASES[name]
    ranks = _ranks(runs, name, world)
    mp = flags["model_parallelism"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    for r in range(mp, world):
        for key in ranks[r]:
            np.testing.assert_array_equal(ranks[r][key],
                                          ranks[r % mp][key], err_msg=key)
    jl = _jax_losses(runs, world, flags)
    np.testing.assert_allclose(ranks[0]["losses"], jl, rtol=RTOL)


def test_preemption_latch_reaches_every_model_rank(runs):
    """One model rank latches a signal before step 2: that step's
    all-reduced latch is set on both ranks, so the replica's shards stop
    at one boundary (one left in a tp_psum would hang)."""
    for rank in _ranks(runs, "latch", 2):
        assert list(rank["latches"][:3]) == [0.0, 1.0, 1.0]


# ---------------------------------------------------------------------------
# the checkpoint: full-shaped, resumed at another mp
# ---------------------------------------------------------------------------

def test_tp_checkpoint_is_full_shaped_and_resumes_at_mp1(runs, tmp_path,
                                                         monkeypatch):
    """The mp 2 run's step-2 checkpoint holds the full model's leaves
    (gathered over the model group), and resumed at mp 1 in one process
    continues the mp 2 run's steps 3-4 within rtol 1e-5; its
    ``--export_dir`` holds the full model's trained parameters."""
    from dtf_tpu_torch.train.checkpoint import (Checkpointer,
                                                load_exported_model)
    monkeypatch.setitem(registry._REGISTRY, "transformer", (
        functools.partial(TransformerLM, **TINY), VOCAB, L2))
    with open(os.path.join(runs["root"], "ckpt0.json")) as f:
        mp2 = json.load(f)["losses"]
    model_dir = str(tmp_path / "m")
    shutil.copytree(os.path.join(runs["root"], "ckpt_model"), model_dir)
    payload = Checkpointer(model_dir).restore(step=2)
    assert tuple(payload["params/block0/attn/qkv/kernel"].shape) == (
        32, 3, 4, 8)
    assert tuple(payload["opt_state/adam/mu/block0/fc1/kernel"].shape) == (
        32, 64)
    assert tuple(payload["params/block1/fc2/kernel"].shape) == (64, 32)
    exported = load_exported_model(os.path.join(runs["root"], "export"))
    final = Checkpointer(model_dir).restore(step=4)
    np.testing.assert_array_equal(
        np.asarray(exported["params"]["block1"]["attn"]["qkv"]["kernel"]),
        final["params/block1/attn/qkv/kernel"].numpy())
    shutil.rmtree(os.path.join(model_dir, "checkpoints", "4"))
    os.remove(os.path.join(model_dir, "checkpoints.meta",
                           "manifest_4.json"))
    cfg = Config(**dict(_case_cfg({}), distribution_strategy="off",
                        train_steps=4, skip_checkpoint=True, resume=True,
                        model_dir=model_dir))
    stats = runner.run(cfg)
    resumed = [v for _, v in stats["train_loss_log"]]
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, mp2[2:], rtol=RTOL)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(num_heads=3, d_model=30), "num_heads 3 not divisible"),
    (dict(d_ff=30, model_parallelism=4), "d_ff 30 not divisible"),
    (dict(vocab_size=63, shard_vocab=True), "vocab_size 63 not divisible"),
])
def test_indivisible_shapes_are_refused(kw, match):
    args = dict(vocab_size=VOCAB, model_parallelism=2, **TINY)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        TransformerLM(**args)


def test_grid_and_flag_refusals():
    """The grid needs mp x sp | world (the JAX message, for an
    indivisible grid too); --model_parallelism 2 --seq_parallelism 2
    parses (ring attention is ported); --shard_lm_head needs mp > 1; a
    shard run outside its group raises."""
    with pytest.raises(ValueError, match="not divisible by model_paral"):
        mesh.initialize(Config(device="cpu", model_parallelism=2,
                               distribution_strategy="off"))
    cfg = parse_flags(["--model_parallelism", "2", "--seq_parallelism", "2"])
    assert (cfg.model_parallelism, cfg.seq_parallelism) == (2, 2)
    with pytest.raises(ValueError, match="6 devices not divisible by "
                       r"model_parallelism\*seq_parallelism=4"):
        mesh.initialize(Config(device="cpu", model_parallelism=2,
                               seq_parallelism=2, process_count=6,
                               process_id=0,
                               coordinator_address="localhost:1",
                               distribution_strategy="multi_worker_mirrored"))
    assert parse_flags(["--model_parallelism", "2",
                        "--shard_lm_head"]).shard_lm_head
    spec = dataclasses.replace(
        __import__("dtf_tpu_torch.data", fromlist=["x"]).get_dataset_spec(
            "lm"), num_classes=VOCAB, seq_len=SEQ)
    with pytest.raises(ValueError, match="shard_lm_head needs"):
        runner.build_model_for(Config(device="cpu", shard_lm_head=True,
                                      model="transformer_small"),
                               spec, torch.device("cpu"))
    shard = _port_model(model_parallelism=2)
    with pytest.raises(ValueError, match="model group"):
        shard(torch.zeros((1, SEQ), dtype=torch.long))


def test_async_ps_refuses_model_parallelism():
    """--ps_mode async keeps the JAX refusal: its workers have no grid."""
    cfg = Config(device="cpu", model="transformer_small", dataset="lm",
                 num_classes=VOCAB, seq_len=SEQ, batch_size=2,
                 train_steps=1, use_synthetic_data=True, skip_eval=True,
                 skip_checkpoint=True, model_parallelism=2,
                 distribution_strategy="parameter_server", ps_mode="async")
    with pytest.raises(ValueError, match="model_parallelism.*single-device"):
        runner.run(cfg)
