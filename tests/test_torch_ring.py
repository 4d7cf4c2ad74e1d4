"""The port's ring attention (dtf_tpu_torch: ``parallel/collectives.py
ring_shift``, ``parallel/ring_attention.py``, the transformer's seq
group) against the JAX package's, on the CPU.  Mirrors the ring cases of
``tests/test_attention.py`` and ``tests/test_transformer.py``.

The port side is gloo ranks started with the launcher's environment
(``cli/launch.py build_env``), one set of 2 and one of 4 a module, each
rank on a seq ring as wide as its world (``runtime/mesh.py initialize``
at ``seq_parallelism`` = world); the ranks save their results and each
test reads its part.  The JAX side runs on its virtual CPU devices
(``tests/conftest.py``) on a seq mesh of the same width.  Inputs are
drawn with numpy; the tiny model's weights go through ``convert.py``.

Tolerances: the JAX tests' -- outputs atol/rtol 1e-5, gradients 1e-4,
model logits 2e-4.
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
from jax.sharding import Mesh, PartitionSpec as P

from dtf_tpu.ops.blockwise import mha_reference as jax_mha_reference
from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.parallel import ring_shift as jax_ring_shift
from dtf_tpu.parallel.ring_attention import ring_self_attention as jax_ring
from dtf_tpu.runtime.mesh import MESH_AXES
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli.launch import build_env
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.ops import blockwise as bw
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, H, D = 2, 64, 4, 16            # tests/test_attention.py's shapes
TINY = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=2, d_ff=64,
            max_seq_len=16)          # tests/test_transformer.py tiny_model
WORLDS = (2, 4)
# each rank's wait for its peers, and the test's for its ranks
GROUP_TIMEOUT_S, TIMEOUT_S = 60, 150

WORKER = r"""
import faulthandler
# a rank still running near the test's limit prints every thread's
# stack and exits, so a hang shows where it waits
faulthandler.dump_traceback_later(@DUMP_S@, exit=True)
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.config.flags import apply_env_topology
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.obs.registry import default_registry
from dtf_tpu_torch.parallel.collectives import ring_shift
from dtf_tpu_torch.parallel.ring_attention import ring_self_attention
from dtf_tpu_torch.runtime.mesh import initialize

args = json.loads(sys.argv[1])
n = args["world"]
cfg = apply_env_topology(Config(device="cpu", seq_parallelism=n,
                                distribution_strategy="multi_worker_mirrored"))
rt = initialize(cfg)
g, r = rt.seq_group, rt.seq_index
out = {"seq_index": r}
reg = default_registry()
calls0 = reg.counter("ring_shift_calls").value
bytes0 = reg.counter("ring_shift_bytes").value
for shift in (1, -1):
    x = (10.0 * r + torch.arange(3, dtype=torch.float32)).requires_grad_()
    y = ring_shift(x, g, shift)
    (y * (r + 1.0)).sum().backward()
    out["shift%d/value" % shift] = y.detach().numpy()
    out["shift%d/grad" % shift] = x.grad.numpy()
out["calls"] = reg.counter("ring_shift_calls").value - calls0
out["bytes"] = reg.counter("ring_shift_bytes").value - bytes0
data = np.load(args["data"])
for causal in (False, True):
    q, k, v = (torch.from_numpy(data[t]).requires_grad_()
               for t in "qkv")
    o = ring_self_attention(q, k, v, g, causal=causal)
    (o ** 2).sum().backward()
    tag = "causal" if causal else "full"
    out[tag + "/out"] = o.detach().numpy()
    for t, leaf in zip("qkv", (q, k, v)):
        out[tag + "/grad_" + t] = leaf.grad.numpy()
model = TransformerLM(**args["tiny"])
model.load_state_dict(torch.load(args["weights"]))
model.set_seq_group(g)
tokens = torch.from_numpy(data["tokens"]).long()
cols = tokens.shape[1] // n
with torch.no_grad():
    out["logits"] = model(tokens[:, r * cols:(r + 1) * cols]).numpy()
np.savez("%s%d.npz" % (args["out"], rt.rank), **out)
# every rank past its last collective before any tears it down
torch.distributed.barrier()
rt.shutdown()
""".replace("@DUMP_S@", str(TIMEOUT_S - 30))


def _launch(root, world, args):
    args = json.dumps(dict(args, world=world,
                           out=os.path.join(root, f"w{world}_")))
    procs = []
    for rank in range(world):
        env = build_env(rank, world,
                        f"file://{os.path.join(root, f'rdv{world}')}")
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
                pytest.fail(f"ring rank {p.pid} still running after "
                            f"{TIMEOUT_S} s (killed); the ranks' output "
                            f"tails: {tails}")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [dict(np.load(os.path.join(root, f"w{world}_{r}.npz")))
            for r in range(world)]


def _draw_params():
    """The tiny model's flax tree drawn with numpy: kernels and
    embeddings N(0, 1/fan_in), LayerNorm scales U(0.5, 1.5), biases
    N(0, 0.02)."""
    shapes = jax.eval_shape(
        lambda key, t: JaxLM(**TINY).init(key, t), jax.random.key(0),
        jnp.zeros((1, TINY["max_seq_len"]), jnp.int32))["params"]
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


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """Inputs, weights and every rank's results at 2 and 4 ranks."""
    root = str(tmp_path_factory.mktemp("ring"))
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    tokens = rng.integers(0, TINY["vocab_size"],
                          (2, TINY["max_seq_len"])).astype(np.int32)
    data = os.path.join(root, "data.npz")
    np.savez(data, q=q, k=k, v=v, tokens=tokens)
    params = _draw_params()
    model = TransformerLM(**TINY)
    weights = os.path.join(root, "weights.pt")
    torch.save(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), model), weights)
    args = {"data": data, "weights": weights, "tiny": TINY}
    ranks = {w: _launch(root, w, args) for w in WORLDS}
    return {"q": q, "k": k, "v": v, "tokens": tokens, "params": params,
            "weights": weights, "ranks": ranks}


def _seq_mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(1, n, 1), MESH_AXES)


# ---------------------------------------------------------------------------
# ring_shift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_ring_shift_forward_and_vjp(ring, world):
    """Shard i lands on shard (i + shift) % n, and the cotangent goes
    back: rank i's gradient is the weight (j + 1) of the rank j its
    shard went to."""
    ranks = ring["ranks"][world]
    for i, rank in enumerate(ranks):
        assert int(rank["seq_index"]) == i
        for shift in (1, -1):
            src = (i - shift) % world
            np.testing.assert_array_equal(
                rank[f"shift{shift}/value"],
                10.0 * src + np.arange(3, dtype=np.float32))
            np.testing.assert_array_equal(
                rank[f"shift{shift}/grad"],
                np.full(3, (i + shift) % world + 1.0, np.float32))


def test_ring_shift_round_trip_matches_jax(ring):
    """The JAX round trip (``tests/test_attention.py``'s ring_shift
    case, on a 4-wide seq mesh): the port's four ranks give the JAX
    shift's shards, np.roll of the stacked input by one."""
    n = 4
    x = np.stack([10.0 * r + np.arange(3, dtype=np.float32)
                  for r in range(n)])
    fn = jax.jit(jax.shard_map(
        lambda a: jax_ring_shift(a, "seq", 1), mesh=_seq_mesh(n),
        in_specs=P("seq", None), out_specs=P("seq", None),
        check_vma=False))
    want = np.asarray(fn(jnp.asarray(x)))
    np.testing.assert_array_equal(want, np.roll(x, 1, axis=0))
    got = np.stack([r["shift1/value"] for r in ring["ranks"][n]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_shift_counts_calls_and_bytes(ring, world):
    """Each call, forward or backward, adds one call and its payload's
    bytes to the default registry: 2 shifts x (forward + backward) of
    3 float32 values."""
    for rank in ring["ranks"][world]:
        assert int(rank["calls"]) == 4
        assert int(rank["bytes"]) == 4 * 3 * 4


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference_and_jax(ring, world, causal):
    """The ranks' output shards, joined, are plain attention over the
    global sequence (the port's mha_reference) and the JAX ring on a
    seq mesh of the same width, atol/rtol 1e-5."""
    ranks = ring["ranks"][world]
    tag = "causal" if causal else "full"
    got = _gathered(ranks, tag + "/out")
    q, k, v = (ring[t] for t in "qkv")
    ref = bw.mha_reference(*(torch.from_numpy(t) for t in (q, k, v)),
                           causal=causal).numpy()
    mesh = _seq_mesh(world)
    jout = np.asarray(jax.jit(lambda a, b, c: jax_ring(
        a, b, c, mesh, causal=causal))(q, k, v))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, jout, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grads(ring, world, causal):
    """d sum(out^2) / d(q, k, v) through the ring's backward (each
    cotangent rotating back), summed over the ranks, against the
    reference's gradients and JAX's ring, atol/rtol 1e-4."""
    ranks = ring["ranks"][world]
    tag = "causal" if causal else "full"
    q, k, v = (torch.from_numpy(ring[t]).requires_grad_() for t in "qkv")
    (bw.mha_reference(q, k, v, causal=causal) ** 2).sum().backward()
    mesh = _seq_mesh(world)
    jgrads = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(jax_ring(a, b, c, mesh,
                                         causal=causal) ** 2),
        argnums=(0, 1, 2)))(ring["q"], ring["k"], ring["v"])
    jref = jax.grad(lambda a, b, c: jnp.sum(jax_mha_reference(
        a, b, c, causal=causal) ** 2), argnums=(0, 1, 2))(
        ring["q"], ring["k"], ring["v"])
    for t, leaf, jg, jr in zip("qkv", (q, k, v), jgrads, jref):
        got = sum(r[f"{tag}/grad_{t}"] for r in ranks)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, leaf.grad.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=t)
        np.testing.assert_allclose(got, np.asarray(jg), atol=1e-4,
                                   rtol=1e-4, err_msg=t)
        np.testing.assert_allclose(got, np.asarray(jr), atol=1e-4,
                                   rtol=1e-4, err_msg=t)


def test_fully_masked_block_is_inert_and_finite():
    """A block entirely in a row's future (every score NEG_INF) folded
    into the carry first leaves rows that are fully masked so far
    finite, and changes nothing once a visible block follows: the ring
    masks such a block, it never skips it."""
    rng = np.random.default_rng(7)
    q, k1, v1, k2, v2 = (torch.from_numpy(rng.normal(
        size=(1, 2, 4, 8)).astype(np.float32)) for _ in range(5))
    o = torch.zeros_like(q)
    m = torch.full(q.shape[:-1], bw.NEG_INF)
    l = torch.zeros(q.shape[:-1])
    future = bw.causal_bias(torch.arange(4), 4 + torch.arange(4))
    o1, m1, l1 = bw.block_accumulate(o, m, l, q, k1, v1, 0.5, future)
    assert torch.isfinite(o1).all() and torch.isfinite(m1).all()
    assert torch.isfinite(bw.finalize(o1, l1)).all()
    o2, _, l2 = bw.block_accumulate(o1, m1, l1, q, k2, v2, 0.5)
    o3, _, l3 = bw.block_accumulate(o, m, l, q, k2, v2, 0.5)
    torch.testing.assert_close(bw.finalize(o2, l2), bw.finalize(o3, l3),
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the model on a seq ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_ring_model_matches_unsharded_and_jax(ring, world):
    """The tiny model with its sequence split over 2 and 4 ranks (ring
    attention, each rank's positions from its offset) gives the
    unsharded model's logits and the JAX model's, atol/rtol 2e-4."""
    got = _gathered(ring["ranks"][world], "logits")
    model = TransformerLM(**TINY)
    model.load_state_dict(torch.load(ring["weights"]))
    tokens = torch.from_numpy(ring["tokens"]).long()
    with torch.no_grad():
        ref = model(tokens).numpy()
    jref = np.asarray(JaxLM(**TINY).apply({"params": ring["params"]},
                                          jnp.asarray(ring["tokens"])))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, jref, atol=2e-4, rtol=2e-4)


def test_decode_under_a_seq_group_is_refused():
    """Decode (a KV cache) with a seq group raises the JAX message
    before any collective; the Decoder drops the group instead."""
    from dtf_tpu_torch.serve.decode import Decoder
    model = TransformerLM(**TINY)
    model.set_seq_group(object())
    cache = [{"cached_key": torch.zeros(1, 16, 2, 16),
              "cached_value": torch.zeros(1, 16, 2, 16)}
             for _ in range(TINY["num_layers"])]
    with pytest.raises(ValueError, match="decode mode .KV cache. does not "
                       "compose with seq_axis sharding .ring attention."):
        model(torch.zeros((1, 1), dtype=torch.long),
              cache_index=torch.zeros(1, dtype=torch.int32), cache=cache)
    Decoder(model, num_slots=1, max_seq_len=16)
    assert model.seq_group is None
    assert all(b.attn.seq_group is None for b in model.blocks)
