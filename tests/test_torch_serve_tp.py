"""The port's tensor-parallel serving (dtf_tpu_torch: ``serve/bridge.py``
``serving_devices`` and ``place_for_serving``, the ``TensorParallelLM``
over its shards, the Decoder's shard pools and page payloads, the engine's
gauge and refusals, ``--serve_tp`` in serve_main and the router's flag
forwarding) against its own single-device engine and the JAX
package's tensor-parallel engine, on the CPU.  Mirrors
``tests/test_serve_tp.py``.

Two shards on the CPU (``serving_devices(2, ["cpu", "cpu"])``, as the
JAX tests carve a serving mesh out of the 8 virtual CPU devices).
Greedy decode is deterministic, so the shards are held to the
single-device tokens and to the JAX TP=2 engine's, token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.serve import ServeEngine as JaxEngine
from dtf_tpu.serve import place_for_serving as jax_place
from dtf_tpu.serve import serving_mesh
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import router_main, serve_main
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.models import partition
from dtf_tpu_torch.models.transformer import TensorParallelLM, TransformerLM
from dtf_tpu_torch.serve import ServeEngine, bridge
from dtf_tpu_torch.serve.decode import Decoder
from dtf_tpu_torch.serve.migrate import payload_digest
from dtf_tpu_torch.train.checkpoint import Checkpointer
from dtf_tpu_torch.train.loop import TrainState
from dtf_tpu_torch.train.optimizer import KerasSGDState

torch.set_num_threads(1)

VOCAB, SEQ, PS = 64, 64, 8
DIMS = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
            d_ff=64, max_seq_len=SEQ)
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, the port's full model on them)."""
    jmodel = JaxLM(**DIMS)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, SEQ), jnp.int32))["params"]
    full = TransformerLM(**DIMS)
    full.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), full))
    return jmodel, params, full.eval()


def _prompts(batch, rng_seed=3):
    rng = np.random.default_rng(rng_seed)
    # varied lengths: one crossing a page boundary, one over 3 pages
    lens = [3, PS, PS + 5, 3 * PS + 2, 5, 9, 2, 17][:batch]
    return [rng.integers(0, VOCAB, (n,)).astype(np.int32) for n in lens]


def _engine(model, **kw):
    return ServeEngine(model, **{"max_batch": 8, "max_seq_len": SEQ,
                                 "kv_page_size": PS, "max_delay_s": 0.0,
                                 **kw})


def _generate(engine, prompts, n_new=6):
    try:
        handles = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
        return [h.result(timeout=300).tokens for h in handles]
    finally:
        engine.stop(drain=False)


@pytest.fixture(scope="module")
def tp2(models):
    return bridge.place_for_serving(models[2], CPU2, 2).eval()


@pytest.mark.parametrize("batch", [1, 4, 8])
def test_tp2_token_exact_vs_single_device_and_jax_tp(models, tp2, batch,
                                                     eight_devices):
    """serve_tp 2 reproduces the serve_tp 1 token stream and the JAX
    TP=2 engine's exactly at batch 1/4/8: prefill chunks (K1's plain
    version at H/2 heads), paged attention over each shard's pool,
    sampling on the whole logits."""
    jmodel, params, full = models
    prompts = _prompts(batch)
    ref = _generate(_engine(full), prompts)
    got = _generate(_engine(tp2), prompts)
    assert got == ref
    mesh = serving_mesh(2)
    jparams = jax_place({"params": params}, mesh=mesh,
                        model_parallelism=2)["params"]
    jax_tp = JaxEngine(jmodel, jparams, max_batch=8, max_seq_len=SEQ,
                       kv_page_size=PS, max_delay_s=0.0, mesh=mesh)
    assert _generate(jax_tp, prompts) == got


def test_tp_shards_hold_their_heads(tp2):
    """Each shard holds H/mp heads of qkv, of out's input and of its KV
    pools, half of d_ff, and whole replicated leaves -- placed straight
    into the shards (the bridge builds each at its own size)."""
    assert isinstance(tp2, TensorParallelLM) and tp2.tp == 2
    for shard in tp2.shards:
        attn = shard.block0.attn
        assert attn.num_heads == 2 and attn.head_dim == 8
        assert tuple(attn.qkv.weight.shape) == (3 * 2 * 8, 32)
        assert tuple(attn.out.weight.shape) == (32, 16)
        assert tuple(shard.block0.fc1.weight.shape) == (32, 32)
        assert tuple(shard.block0.fc2.weight.shape) == (32, 32)
        assert tuple(shard.embed.weight.shape) == (VOCAB, 32)
        assert tuple(shard.lm_head.weight.shape) == (VOCAB, 32)
    dec = Decoder(tp2, num_slots=2, max_seq_len=SEQ, kv_page_size=PS)
    cache = dec.fresh_cache()
    assert len(cache) == 2 and dec.tp == 2
    assert tuple(cache[1][0]["paged_key"].shape[2:]) == (2, 8)
    plan = bridge.serving_memory_plan(tp2, num_slots=2, max_seq_len=SEQ,
                                      kv_page_size=PS, model_parallelism=2)
    assert plan["kv_bytes_per_device"] * 2 == plan["kv_bytes_paged"]


def test_partition_rule_covers_every_leaf(models):
    """Every parameter has a rule answer, and the shards' parameters
    are exactly the rule's cut of the full model's (a missing rule
    would silently replicate a leaf the layout says is sharded)."""
    full = models[2]
    sd = full.state_dict()
    names = [n for n, _ in full.named_parameters()]
    sharded = [n for n in names if partition.rule(n) is not None]
    # qkv weight and bias, out, fc1 weight and bias, fc2: six a block
    assert len(sharded) == 6 * DIMS["num_layers"]
    for k in range(2):
        shard = TransformerLM(**DIMS, model_parallelism=2, model_index=k)
        want = partition.shard_state_dict(sd, 2, k)
        assert sorted(shard.state_dict()) == sorted(want)
        for name, t in shard.state_dict().items():
            assert t.shape == want[name].shape, name


def test_tp_rejects_contiguous_cache(tp2):
    with pytest.raises(ValueError, match="paged"):
        Decoder(tp2, num_slots=2, max_seq_len=SEQ)
    with pytest.raises(ValueError, match="paged"):
        Config(serve_tp=2, kv_page_size=0)
    with pytest.raises(ValueError, match="serve_tp must be >= 1"):
        Config(serve_tp=0)


def test_tp_rejects_indivisible_heads():
    model = TransformerLM(**dict(DIMS, num_heads=2))
    with pytest.raises(ValueError, match="divisible"):
        bridge.place_for_serving(model, ["cpu"] * 4, 4)


def test_engine_rejects_tp_without_paging(tp2):
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tp2, max_batch=2, max_seq_len=SEQ, kv_page_size=None)
    eng = _engine(tp2)
    try:
        assert eng.metrics.get("serve_tp_ways").value == 2
    finally:
        eng.stop(drain=False)


def test_serving_devices_refuse_missing_cards():
    """serving_mesh's rule: fewer devices than shards raise, naming the
    count; the default for the CUDA device is one card a shard."""
    with pytest.raises(ValueError, match="needs 2 devices, 1 attached"):
        bridge.serving_devices(2, ["cpu"])
    cpu = torch.device("cpu")
    assert bridge.serving_devices(2, device="cpu") == [cpu, cpu]
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs 2 devices"):
            bridge.serving_devices(2, device="cuda")


def test_tp_restore_train_checkpoint_token_exact(tmp_path, models):
    """A training checkpoint (the port's full TrainState payload) loads
    straight into the TP=2 layout and serves the single-device tokens
    at batches 1/4/8."""
    jmodel, params, full = models
    state = TrainState(step=3, params=list(full.parameters()),
                       opt_state=KerasSGDState(velocity=[
                           torch.zeros_like(p) for p in full.parameters()]))
    ck = Checkpointer(str(tmp_path))
    ck.save(lambda: convert.state_to_flat(full, state), step=3)
    model = TransformerLM(**DIMS)
    tp = bridge.load_for_serving(model, model_dir=str(tmp_path),
                                 devices=CPU2, model_parallelism=2).eval()
    qkv = tp.shards[0].block0.attn.qkv.weight
    assert qkv.shape[0] == full.block0.attn.qkv.weight.shape[0] // 2
    engines = [_engine(full), _engine(tp)]
    try:
        for batch in (1, 4, 8):
            prompts = _prompts(batch, rng_seed=batch)
            ref, got = ([h.result(timeout=300).tokens for h in
                         [e.submit(p, max_new_tokens=6) for p in prompts]]
                        for e in engines)
            assert got == ref, f"batch {batch} diverged"
    finally:
        for e in engines:
            e.stop(drain=False)


def test_page_payloads_cross_serve_tp(models, tp2):
    """A page's payload has one layout at every serve_tp: the shards'
    heads joined in order.  A serve_tp 1 page written into a serve_tp 2
    pool reads back bit for bit (same digest), and the other way; the
    two decoders' own pages for one prompt agree within float32
    rounding."""
    full = models[2]
    decs = [Decoder(m, num_slots=2, max_seq_len=SEQ, kv_page_size=PS)
            for m in (full, tp2)]
    caches = [d.fresh_cache() for d in decs]
    prompt = _prompts(4)[3][:2 * PS]
    row = np.array([1, 2] + [0] * (decs[0].pages_per_slot - 2), np.int32)
    for d, c in zip(decs, caches):
        d.prefill_chunk(c, prompt, row, 0, len(prompt) - 1, 0.0)
    one, two = (d.read_page(c, 2) for d, c in zip(decs, caches))
    assert [a.shape for a in one] == [a.shape for a in two]
    for a, b in zip(one, two):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    for (src, payload), (dst, cache) in (((0, one), (1, caches[1])),
                                         ((1, two), (0, caches[0]))):
        decs[dst].write_page(cache, 5, payload)
        back = decs[dst].read_page(cache, 5)
        assert payload_digest(back) == payload_digest(payload)
        for a, b in zip(back, payload):
            np.testing.assert_array_equal(a, b)


def test_serve_main_tp2_on_the_cpu_and_the_router_forwards_it(tmp_path):
    """serve_main --serve_tp 2 serves through two shards (stats 'tp'),
    and the router hands --serve_tp to every replica it starts."""
    stats = serve_main.serve(parse_flags([
        "--device", "cpu", "--model", "transformer_small", "--num_classes",
        "256", "--serve_requests", "2", "--serve_max_new_tokens", "4",
        "--serve_tp", "2", "--serve_max_seq_len", "64"]), random_init=True)
    assert stats["tp"] == 2 and stats["requests"] == 2
    cfg = parse_flags(["--device", "cpu", "--serve_tp", "2",
                       "--rendezvous_dir", str(tmp_path)])
    cmd = router_main.replica_command(cfg, random_init=True)
    assert cmd[cmd.index("--serve_tp") + 1] == "2"
    assert "--serve_tp" not in router_main.replica_command(
        parse_flags(["--device", "cpu"]), random_init=True)
