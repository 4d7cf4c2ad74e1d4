"""The port's pipeline parallelism at the model level (dtf_tpu_torch:
``parallel/pipeline.py``'s schedules and ``last_stage_broadcast``,
``models/pipeline_lm.py``'s stacked LM and its partition rule) against
the JAX package's, on the CPU.  Mirrors the model and primitive cases of
``tests/test_pipeline.py``; the Trainer's are in
``tests/test_torch_pp.py``.

The port side is gloo ranks started with the launcher's environment
(``cli/launch.py build_env``), one launch at pp 4 and one at pp 2, each
rank a pipeline stage; the ranks' results are made once a module and
each test reads its part.  The JAX side is ``tests/test_pipeline.py``'s
own: ``pipeline_spmd`` and the model inside ``shard_map`` on its 8
virtual CPU devices (``use_pallas=False``), on the same tiny model (4
layers, d 32, 4 heads, d_ff 64, vocab 64, S 16) with the weights flax
draws, carried into the port by ``convert.py``.

Tolerances: the primitives exactly; logits f32 within 1e-5; gradients
atol 1e-5 / rtol 1e-4 (the JAX test's).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from dtf_tpu.models import pipeline_lm as jax_pipeline_lm
from dtf_tpu.parallel.pipeline import (last_stage_broadcast, pipeline_spmd,
                                       pipeline_spmd_interleaved)
from dtf_tpu.runtime.mesh import MODEL_AXIS, make_mesh
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli.launch import build_env
from dtf_tpu_torch.models import pipeline_lm
from dtf_tpu_torch.models.partition import Split, shard_for
from dtf_tpu_torch.models.pipeline_lm import (BLOCK_PARAMS,
                                              PipelinedTransformerLM)
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV
from test_pipeline import _sharded_pipe_call, tiny_pipe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 64
TINY = dict(vocab_size=VOCAB, num_layers=4, d_model=32, num_heads=4,
            d_ff=64, max_seq_len=16)
ATOL = RTOL = 1e-5            # logits, f32
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# each rank's wait for its peers, and the test's for its ranks
GROUP_TIMEOUT_S, TIMEOUT_S = 60, 240

# the model cases each launch runs: (name, tokens seed, batch, M,
# interleave, grad).  The seeds, batches and counts are
# tests/test_pipeline.py's
MODEL_CASES = {
    4: [("gpipe_logits", 0, 4, 2, 1, False),
        ("gpipe_grads", 1, 4, 2, 1, True)],
    2: [("gpipe_logits", 0, 4, 2, 1, False),
        ("gpipe_grads", 1, 4, 2, 1, True),
        ("interleaved_logits", 3, 8, 4, 2, False),
        ("interleaved_grads", 4, 4, 2, 2, True)],
}
# the interleaved identity's microbatch counts: = pp, two blocks, a
# partial block
IDENTITY_M = (4, 8, 2)

# one port rank: its stage of every schedule and model case
WORKER = r"""
import faulthandler
faulthandler.dump_traceback_later(@DUMP_S@, exit=True)
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.config.flags import apply_env_topology
from dtf_tpu_torch.models.partition import shard_for
from dtf_tpu_torch.models.pipeline_lm import PipelinedTransformerLM
from dtf_tpu_torch.obs.registry import default_registry
from dtf_tpu_torch.parallel.collectives import gather_dim
from dtf_tpu_torch.parallel.pipeline import (last_stage_broadcast,
                                             pipeline_spmd,
                                             pipeline_spmd_interleaved)
from dtf_tpu_torch.runtime.mesh import initialize

args = json.loads(sys.argv[1])
cfg = apply_env_topology(Config(
    device="cpu", distribution_strategy="multi_worker_mirrored",
    model_parallelism=args["pp"]))
rt = initialize(cfg.replace(coordinator_address="file://" + args["rdv"]))
g, idx, pp = rt.model_group, rt.model_index, rt.model_parallelism
data = np.load(args["data"])
out = {}
reg = default_registry()


def shifts():
    return reg.counter("ring_shift_calls").value


def lsb(y):
    return last_stage_broadcast(y, g).detach().numpy()


# the primitives
x = torch.from_numpy(data["ident"])
out["gpipe_identity"] = lsb(pipeline_spmd(lambda h: h, x, g))
out["gpipe_transform"] = lsb(pipeline_spmd(
    lambda h: h + (idx + 1.0), torch.zeros(4, 2, 3), g))
for m in args["identity_m"]:
    out[f"interleaved_identity_{m}"] = lsb(pipeline_spmd_interleaved(
        lambda h, lap: h, torch.from_numpy(data[f"ident_{m}"]), g))
out["interleaved_order"] = lsb(pipeline_spmd_interleaved(
    lambda h, lap: h + (idx + 1.0) * (1.0 if lap == 0 else 10.0),
    torch.zeros(4, 2, 3), g))

# the backward through every tick: each stage scales by its own
# weights, the loss weights the broadcast output
for name, fn in (("gpipe", pipeline_spmd),
                 ("interleaved", pipeline_spmd_interleaved)):
    w = torch.tensor([idx + 2.0, idx + 1.5], requires_grad=True)
    xb = torch.from_numpy(data["bx"]).requires_grad_()
    stage = ((lambda h: h * w[0]) if name == "gpipe"
             else (lambda h, lap: h * w[lap]))
    before = shifts()
    y = last_stage_broadcast(fn(stage, xb, g), g)
    forward = shifts() - before
    (y * torch.from_numpy(data["bc"])).sum().backward()
    out[f"bwd_{name}_x"] = xb.grad.numpy()
    out[f"bwd_{name}_w"] = w.grad.numpy()
    out[f"bwd_{name}_shifts"] = np.array([forward,
                                          shifts() - before - forward])

# the model
full = torch.load(args["weights"])
for case in args["cases"]:
    name, m, il, grad = (case[k] for k in ("name", "m", "interleave",
                                           "grad"))
    model = PipelinedTransformerLM(num_microbatches=m, interleave=il,
                                   model_parallelism=pp, model_index=idx,
                                   **args["tiny"])
    model.load_state_dict(shard_for(model, full))
    model.set_model_group(g)
    tokens = torch.from_numpy(data[name]).long()
    if not grad:
        with torch.no_grad():
            out[name] = model(tokens).numpy()
        continue
    logits = model(tokens)
    loss = (-torch.log_softmax(logits, -1)[..., 0]).mean()
    loss.backward()
    out[name + "/loss"] = loss.detach().numpy()
    for key, p in model.named_parameters():
        out[name + "/grad/" + key] = p.grad.numpy()
        if model.split(key) is not None:
            out[name + "/full/" + key] = gather_dim(p.grad, 0, g).numpy()

# the refusals a stage raises before any collective
for tag, kw in (("batch", dict(num_microbatches=3)),
                ("odd", dict(num_layers=pp, interleave=2))):
    model = PipelinedTransformerLM(model_parallelism=pp, model_index=idx,
                                   **dict(args["tiny"], **kw))
    model.set_model_group(g)
    try:
        model(torch.zeros(4, 16, dtype=torch.long))
        out["refusal_" + tag] = np.array("")
    except ValueError as e:
        out["refusal_" + tag] = np.array(str(e))

np.savez(args["out"] % rt.rank, **out)
# every rank past its last collective before any tears it down
torch.distributed.barrier()
rt.shutdown()
""".replace("@DUMP_S@", str(TIMEOUT_S - 30))


def _launch(root: str, pp: int, args: dict) -> None:
    args = json.dumps(dict(args, pp=pp, rdv=os.path.join(root, f"rdv{pp}"),
                           out=os.path.join(root, f"pp{pp}_%d.npz")))
    procs = []
    for rank in range(pp):
        env = build_env(rank, pp, f"file://{os.path.join(root, 'x')}")
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
                pytest.fail(f"pipeline rank {p.pid} still running after "
                            f"{TIMEOUT_S} s (killed); the ranks' output "
                            f"tails: {tails}")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def _tokens(seed: int, batch: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, VOCAB, (batch, 16)).astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, from one launch at pp 4 and one at pp 2 over
    the flax-drawn weights; the JAX params and the inputs beside."""
    root = str(tmp_path_factory.mktemp("pipeline"))
    params = tiny_pipe().init(jax.random.key(0),
                              jnp.zeros((2, 16), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    full = convert.from_flax_params(params,
                                    PipelinedTransformerLM(**TINY))
    weights = os.path.join(root, "weights.pt")
    torch.save(full, weights)
    rng = np.random.default_rng(7)
    data = {"ident": rng.normal(size=(8, 3)).astype(np.float32).reshape(
                4, 2, 3),
            "bx": rng.normal(size=(4, 2, 3)).astype(np.float32),
            "bc": rng.normal(size=(4, 2, 3)).astype(np.float32)}
    for m in IDENTITY_M:
        data[f"ident_{m}"] = np.random.default_rng(m).normal(
            size=(m, 2, 3)).astype(np.float32)
    for cases in MODEL_CASES.values():
        for name, seed, batch, _, _, _ in cases:
            data[name] = _tokens(seed, batch)
    path = os.path.join(root, "data.npz")
    np.savez(path, **data)
    for pp, cases in MODEL_CASES.items():
        _launch(root, pp, {
            "data": path, "weights": weights, "tiny": TINY,
            "identity_m": IDENTITY_M,
            "cases": [dict(name=n, m=m, interleave=il, grad=gr)
                      for n, _, _, m, il, gr in cases]})
    ranks = {pp: [dict(np.load(os.path.join(root, f"pp{pp}_{r}.npz")))
                  for r in range(pp)] for pp in MODEL_CASES}
    return {"params": params, "full": full, "data": data, "ranks": ranks}


def _jax_shard_map(mesh, f):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P(), out_specs=P(),
                                 check_vma=False))


# ---------------------------------------------------------------------------
# the primitives, exact against the JAX schedules
# ---------------------------------------------------------------------------

def test_gpipe_identity_and_per_stage_transform(runs, eight_devices):
    """Identity stages at pp 4 are a delayed copy of the input, and
    stages adding idx + 1 sum to 10 -- on every rank, bit for bit the
    JAX schedule's."""
    mesh = make_mesh(eight_devices[:4], data=1, seq=1, model=4)
    x = runs["data"]["ident"]
    ident = np.asarray(_jax_shard_map(mesh, lambda a: last_stage_broadcast(
        pipeline_spmd(lambda h: h, a, MODEL_AXIS), MODEL_AXIS))(x))
    add = np.asarray(_jax_shard_map(mesh, lambda a: last_stage_broadcast(
        pipeline_spmd(lambda h: h + (jax.lax.axis_index(MODEL_AXIS) + 1.0),
                      a, MODEL_AXIS), MODEL_AXIS))(np.zeros((4, 2, 3),
                                                            np.float32)))
    np.testing.assert_array_equal(ident, x)
    np.testing.assert_array_equal(add, np.full((4, 2, 3), 10.0))
    for r in runs["ranks"][4]:
        np.testing.assert_array_equal(r["gpipe_identity"], ident)
        np.testing.assert_array_equal(r["gpipe_transform"], add)


@pytest.mark.parametrize("pp", [2, 4])
def test_interleaved_identity_and_visitation_order(runs, eight_devices,
                                                   pp):
    """The interleaved schedule with identity chunks is a delayed copy
    at M = pp, two blocks and a partial block; chunks adding
    (idx + 1) 10^lap visit lap 0 of every stage, then lap 1 (110 at pp
    4, 30 at pp 2): the JAX schedule's values exactly."""
    mesh = make_mesh(eight_devices[:pp], data=1, seq=1, model=pp)
    for m in IDENTITY_M:
        x = runs["data"][f"ident_{m}"]
        ref = np.asarray(_jax_shard_map(
            mesh, lambda a: last_stage_broadcast(pipeline_spmd_interleaved(
                lambda h, c: h, a, MODEL_AXIS), MODEL_AXIS))(x))
        np.testing.assert_array_equal(ref, x)
        for r in runs["ranks"][pp]:
            np.testing.assert_array_equal(r[f"interleaved_identity_{m}"],
                                          ref, err_msg=f"M={m}")

    def order(a):
        def stage(h, lap):
            return h + (jax.lax.axis_index(MODEL_AXIS) + 1.0) * \
                jnp.where(lap == 0, 1.0, 10.0)
        return last_stage_broadcast(
            pipeline_spmd_interleaved(stage, a, MODEL_AXIS), MODEL_AXIS)

    ref = np.asarray(_jax_shard_map(mesh, order)(np.zeros((4, 2, 3),
                                                          np.float32)))
    np.testing.assert_array_equal(ref, np.full((4, 2, 3),
                                               11.0 * pp * (pp + 1) / 2))
    for r in runs["ranks"][pp]:
        np.testing.assert_array_equal(r["interleaved_order"], ref)


@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_backward_runs_every_tick_on_every_rank(runs, pp, schedule):
    """Through either schedule the backward completes on every rank (no
    rank skips a tick's ``ring_shift`` backward its neighbour waits in)
    and is right: stage j scales by w_j (w_j,lap interleaved), so dL/dx
    is c times the product of every weight on stage 0 and zero
    elsewhere, and dL/dw_j is sum(c x) times the product of the others.
    The shifts: every tick forward, all but the last backward."""
    x, c = runs["data"]["bx"], runs["data"]["bc"]
    laps = 1 if schedule == "gpipe" else 2
    w = np.array([[j + 2.0, j + 1.5][:laps] for j in range(pp)])
    prod = np.prod(w)
    m = x.shape[0]
    ticks = m + pp - 1 if laps == 1 else 2 * pp * -(-m // pp) + pp - 1
    for j, r in enumerate(runs["ranks"][pp]):
        np.testing.assert_allclose(r[f"bwd_{schedule}_x"],
                                   c * prod if j == 0 else 0 * c,
                                   rtol=1e-6)
        np.testing.assert_allclose(r[f"bwd_{schedule}_w"][:laps],
                                   (c * x).sum() * prod / w[j], rtol=1e-5)
        assert list(r[f"bwd_{schedule}_shifts"]) == [ticks, ticks - 1]


# ---------------------------------------------------------------------------
# the model: logits and gradients against JAX PP, the twin against JAX's
# ---------------------------------------------------------------------------

def _jax_case(eight_devices, params, pp, seed, batch, m, interleave,
              grad):
    mesh = make_mesh(eight_devices[:pp], data=1, seq=1, model=pp)
    model = tiny_pipe(pipe_axis=MODEL_AXIS, num_microbatches=m,
                      interleave=interleave)
    return _sharded_pipe_call(mesh, {"params": params}, model,
                              jnp.asarray(_tokens(seed, batch)), grad=grad)


@pytest.mark.parametrize("pp,name", [(pp, c[0]) for pp, cs in
                                     MODEL_CASES.items() for c in cs
                                     if "logits" in c[0]])
def test_pp_logits_match_jax_pp(runs, eight_devices, pp, name):
    """Each stage's logits (every stage computes the head) against JAX's
    pipelined forward on the same weights, f32 within 1e-5."""
    _, seed, batch, m, il, _ = next(c for c in MODEL_CASES[pp]
                                    if c[0] == name)
    ref = np.asarray(_jax_case(eight_devices, runs["params"], pp, seed,
                               batch, m, il, False))
    for r in runs["ranks"][pp]:
        np.testing.assert_allclose(r[name], ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("interleave", [1, 2])
def test_twin_logits_match_jax_twin(runs, interleave):
    """The off-mesh twin (pp 1, no group: the whole batch through every
    layer, in the interleaved order at interleave 2) against JAX's, f32
    within 1e-5."""
    tokens = _tokens(3, 8)
    kw = dict(interleave=interleave,
              interleave_pp=2 if interleave == 2 else None)
    ref = np.asarray(tiny_pipe(**kw).apply({"params": runs["params"]},
                                           jnp.asarray(tokens)))
    model = PipelinedTransformerLM(**TINY, **kw)
    model.load_state_dict(runs["full"])
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pp,name", [(pp, c[0]) for pp, cs in
                                     MODEL_CASES.items() for c in cs
                                     if "grads" in c[0]])
def test_pp_grads_match_jax_pp(runs, eight_devices, pp, name):
    """The loss and the gradients against JAX's pipelined run: embed,
    head_k, qkv_k and fc2_b (the JAX test's leaves) and every other
    replicated leaf on every stage, each stage's stacked leaves against
    its layers of JAX's, and the stacked leaves gathered over the stages
    against JAX's whole -- atol 1e-5, rtol 1e-4."""
    _, seed, batch, m, il, _ = next(c for c in MODEL_CASES[pp]
                                    if c[0] == name)
    loss, grads = _jax_case(eight_devices, runs["params"], pp, seed, batch,
                            m, il, True)
    grads = jax.tree_util.tree_map(np.asarray, grads["params"])
    local = TINY["num_layers"] // pp
    for j, r in enumerate(runs["ranks"][pp]):
        np.testing.assert_allclose(r[name + "/loss"], float(loss),
                                   rtol=1e-5)
        for key, g in grads.items():
            if key in BLOCK_PARAMS:
                np.testing.assert_allclose(
                    r[name + "/full/" + key], g, atol=GRAD_ATOL,
                    rtol=GRAD_RTOL, err_msg=key)
                g = g[j * local:(j + 1) * local]
            np.testing.assert_allclose(r[name + "/grad/" + key], g,
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"rank {j} {key}")


def test_ln_eps_and_tanh_gelu_are_pinned(runs, monkeypatch):
    """The twin agrees with JAX's (1e-5) only with LayerNorm eps 1e-6
    and the tanh GELU: torch's defaults (eps 1e-5, the erf GELU) each
    miss by far more."""
    tokens = _tokens(0, 4)
    ref = np.asarray(tiny_pipe().apply({"params": runs["params"]},
                                       jnp.asarray(tokens)))
    model = PipelinedTransformerLM(**TINY)
    model.load_state_dict(runs["full"])

    def gap():
        with torch.no_grad():
            out = model(torch.from_numpy(tokens).long()).numpy()
        return float(np.abs(out - ref).max())

    assert gap() <= ATOL
    monkeypatch.setattr(pipeline_lm, "LN_EPS", 1e-5)
    assert gap() > 100 * ATOL
    monkeypatch.setattr(pipeline_lm, "LN_EPS", 1e-6)
    monkeypatch.setattr(pipeline_lm, "GELU_APPROXIMATE", "none")
    assert gap() > 100 * ATOL
    # the port's helper against the JAX function on one input
    x = np.random.default_rng(2).normal(size=(3, 32)).astype(np.float32)
    s = np.random.default_rng(3).normal(size=(32,)).astype(np.float32)
    b = np.random.default_rng(4).normal(size=(32,)).astype(np.float32)
    monkeypatch.undo()
    np.testing.assert_allclose(
        pipeline_lm.layer_norm(*(torch.from_numpy(a) for a in (x, s, b)))
        .numpy(), np.asarray(jax_pipeline_lm._layernorm(x, s, b)),
        atol=1e-6)
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(x)), atol=1e-6)


# ---------------------------------------------------------------------------
# the partition rule, convert.py, refusals
# ---------------------------------------------------------------------------

def test_pp_partition_rule():
    """The stacked leaves split their layer dim between stages (the JAX
    ``pipeline_param_partition_specs``); embedding, head and final norm
    are replicated; nothing is split at pp 1."""
    stage = PipelinedTransformerLM(**TINY, model_parallelism=2,
                                   model_index=1)
    for name in BLOCK_PARAMS:
        assert stage.split(name) == Split(0), name
    for name in ("embed", "pos_embed", "head_k", "head_b", "ln_f_s",
                 "ln_f_b"):
        assert stage.split(name) is None, name
    assert PipelinedTransformerLM(**TINY).split("qkv_k") is None
    assert tuple(stage.qkv_k.shape) == (2, 32, 96)
    assert tuple(stage.fc1_b.shape) == (2, 64)
    assert tuple(stage.embed.shape) == (VOCAB, 32)


def test_convert_full_and_stage_local(runs):
    """convert.py carries the flax tree into a stage (its layers of the
    full tree, or a stage-local tree as it is) and back out as the
    stage's local tree; the AdamW moments likewise."""
    from dtf_tpu_torch.train.loop import TrainState
    from dtf_tpu_torch.train.optimizer import AdamWState
    params = runs["params"]
    for index in (0, 1):
        stage = PipelinedTransformerLM(**TINY, model_parallelism=2,
                                       model_index=index)
        sd = convert.from_flax_params(params, stage)
        local = {k: (v[index * 2:(index + 1) * 2] if k in BLOCK_PARAMS
                     else v) for k, v in params.items()}
        for key, v in local.items():
            np.testing.assert_array_equal(sd[key].numpy(), v, err_msg=key)
        assert convert.from_flax_params(local, stage).keys() == sd.keys()
        for key, v in convert.from_flax_params(local, stage).items():
            np.testing.assert_array_equal(v.numpy(), sd[key].numpy())
        stage.load_state_dict(sd)
        back = convert.to_flax_params(stage)
        assert back.keys() == local.keys()
        for key, v in back.items():
            np.testing.assert_array_equal(v, local[key], err_msg=key)
        names = [n for n, _ in stage.named_parameters()]
        moments = [torch.full_like(p, i + 0.5)
                   for i, p in enumerate(stage.parameters())]
        state = TrainState(step=3, params=list(stage.parameters()),
                           opt_state=AdamWState(count=3, mu=moments,
                                                nu=moments))
        tree = convert.train_state_to_flax(stage, state)
        assert tree["opt_state"]["adam"]["mu"]["qkv_k"].shape == (2, 32, 96)
        again = convert.train_state_from_flax(tree, stage)
        for a, b, n in zip(again.opt_state.mu, moments, names):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)


def test_stage_refusals(runs, eight_devices):
    """num_layers % pp, a batch M does not divide and an odd per-stage
    count under interleave raise the JAX messages (the last two from a
    stage in its group, before any collective); a stage's forward
    without its group raises and never runs the local twin."""
    with pytest.raises(ValueError, match="num_layers 4 not divisible by "
                       "pipeline length 3"):
        PipelinedTransformerLM(**TINY, model_parallelism=3)
    stage = PipelinedTransformerLM(**TINY, model_parallelism=2)
    with pytest.raises(ValueError, match="model group"):
        stage(torch.zeros(4, 16, dtype=torch.long))
    batch = "per-shard batch 4 not divisible by num_microbatches 3"
    odd = "interleave=2 needs an even per-stage layer count, got 1"
    for r in runs["ranks"][2]:
        assert str(r["refusal_batch"]) == batch
        assert str(r["refusal_odd"]) == odd
    mesh = make_mesh(eight_devices[:2], data=1, seq=1, model=2)
    with pytest.raises(ValueError, match=batch):
        _sharded_pipe_call(mesh, {"params": runs["params"]},
                           tiny_pipe(pipe_axis=MODEL_AXIS,
                                     num_microbatches=3),
                           jnp.zeros((4, 16), jnp.int32))
    two = tiny_pipe(num_layers=2)
    params2 = two.init(jax.random.key(0), jnp.zeros((2, 16), jnp.int32))
    with pytest.raises(ValueError, match=odd):
        _sharded_pipe_call(mesh, params2,
                           tiny_pipe(num_layers=2, pipe_axis=MODEL_AXIS,
                                     interleave=2),
                           jnp.zeros((4, 16), jnp.int32))


def test_shard_for_cuts_each_stage(runs):
    """``shard_for`` gives stage j the layers [j L / pp, (j + 1) L / pp)
    of every stacked leaf and every replicated leaf whole."""
    full = runs["full"]
    for pp in (2, 4):
        for j in range(pp):
            stage = PipelinedTransformerLM(**TINY, model_parallelism=pp,
                                           model_index=j)
            sd = shard_for(stage, full)
            n = 4 // pp
            for key, v in sd.items():
                want = full[key][j * n:(j + 1) * n] if key in BLOCK_PARAMS \
                    else full[key]
                assert torch.equal(v, want), (pp, j, key)
