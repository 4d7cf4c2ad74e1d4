"""The port's checkpoints (dtf_tpu_torch: train/checkpoint.py,
convert.py's training-state layout, cli/runner.py's --resume wiring,
serve/bridge.py's checkpoint sources) on the CPU, against the JAX
package where the two meet.

  - a whole TrainState (AdamW with dynamic loss scaling on the LM; Keras
    SGD with BN buffers on resnet20) saved and restored into a fresh
    model is bit-exact, and the next step is bit-identical;
  - the payload's keys, shapes and dtypes are the JAX TrainState's flax
    paths; the manifest's keys and host state are those the JAX runner
    writes;
  - integrity: a truncated, missing or unreadable newest step falls
    back to the previous verified one with one ``ckpt_integrity``
    anomaly (``ckpt_truncate@latest`` included); the GC cases of
    ``tests/test_checkpoint.py``;
  - the runner: a seed mismatch on resume raises, ``--eval_only
    --resume`` needs a checkpoint, ``--export_dir``;
  - a JAX Trainer's state after K steps, carried across by
    ``convert.py``, continues in the port with the JAX run's losses
    (1e-5 relative in float32; resnet20's update within 1e-2 of its
    norm, ROADMAP Queue 3 item 5);
  - ``serve_main --model_dir`` on a port checkpoint decodes the JAX
    engine's greedy tokens on the converted parameters.
"""

import dataclasses
import functools
import json
import os

import flax
import jax
import numpy as np
import pytest
import torch

import dtf_tpu.data.base as jdata_base
from dtf_tpu.cli.runner import run as jax_run
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models import build_model as jax_build_model
from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.runtime import initialize as jax_initialize
from dtf_tpu.serve.engine import ServeEngine as JaxEngine
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu_torch import chaos, convert
from dtf_tpu_torch.cli import cifar_main, lm_main, serve_main
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.data import base as data_base
from dtf_tpu_torch.models import registry, resnet_cifar
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.train.checkpoint import (PAYLOAD, CheckpointCallback,
                                            Checkpointer,
                                            load_exported_model,
                                            load_train_checkpoint,
                                            manifest_path)
from dtf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

VOCAB, SEQ, BATCH = 64, 16, 4
DIMS = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
            d_ff=64, max_seq_len=SEQ)
LM_TINY = dataclasses.replace(data_base.LM, num_classes=VOCAB, seq_len=SEQ,
                              num_train=64, num_eval=16)


@pytest.fixture(autouse=True)
def clean_chaos():
    yield
    chaos.disable()
    trace.disable()


def _tokens(seed):
    t = np.random.default_rng(seed).integers(0, VOCAB, (BATCH, SEQ))
    return torch.from_numpy(t.astype(np.int32)), torch.from_numpy(
        np.roll(t, -1, 1).astype(np.int32))


def _images(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy((rng.normal(size=(BATCH, 16, 16, 3)) * 60
                              + 127).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, BATCH).astype(np.int32)))


def _lm_trainer(seed, **flags):
    cfg = Config(device="cpu", dataset="lm", batch_size=BATCH,
                 train_steps=8, optimizer="adamw", **flags)
    model = TransformerLM(**DIMS)
    torch.manual_seed(seed)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.05)
    return Trainer(cfg, model, 0.0, LM_TINY), _tokens


def _resnet_trainer(seed, **flags):
    cfg = Config(device="cpu", model="resnet20", dataset="cifar10",
                 batch_size=BATCH, train_steps=8, optimizer="sgd", **flags)
    model = resnet_cifar.resnet20().init_weights(seed)
    return (Trainer(cfg, model.to(memory_format=torch.channels_last),
                    registry.L2_CIFAR, data_base.CIFAR10), _images)


CASES = {"lm_adamw_dynamic_scale": (_lm_trainer,
                                    dict(loss_scale="dynamic")),
         "lm_adamw": (_lm_trainer, {}),
         "resnet20_sgd_bn": (_resnet_trainer, {})}


def _snapshot(trainer, state):
    opt = state.opt_state
    adam = hasattr(opt, "mu")
    moments = list(opt.mu) + list(opt.nu) if adam else list(opt.velocity)
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            [m.clone() for m in moments], state.step,
            opt.count if adam else None, state.loss_scale, state.good_steps)


def _assert_same(a, b):
    (sa, ma, *rest_a), (sb, mb, *rest_b) = a, b
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    assert len(ma) == len(mb)
    assert all(torch.equal(x, y) for x, y in zip(ma, mb))
    assert rest_a == rest_b


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_state_round_trip_is_bit_exact(tmp_path, case):
    """Two steps, a save, a fresh trainer of another seed restored from
    it: parameters, BN buffers, moments, step, AdamW count and the
    dynamic scale equal bit for bit, and so does the next step."""
    make, flags = CASES[case]
    trainer, batch = make(0, **flags)
    state = trainer.init_state()
    for i in range(2):
        state, _ = trainer.train_step(state, *batch(i))
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(lambda: trainer.checkpoint_payload(state), step=state.step)
    assert ckpt.verify(2) == "ok"
    other, _ = make(1, **flags)
    restored = other.restore_state(ckpt.restore())
    _assert_same(_snapshot(trainer, state), _snapshot(other, restored))
    state, m1 = trainer.train_step(state, *batch(7))
    restored, m2 = other.train_step(restored, *batch(7))
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_same(_snapshot(trainer, state), _snapshot(other, restored))


# ---------------------------------------------------------------------------
# the layout: the JAX TrainState's flax paths, the JAX manifest's keys
# ---------------------------------------------------------------------------

def _jax_state(model_name, num_classes, spec, batch, **flags):
    jcfg = JaxConfig(model=model_name, skip_checkpoint=True, model_dir="",
                     distribution_strategy="off", num_devices=1,
                     batch_size=BATCH, train_steps=8, use_synthetic_data=True,
                     skip_eval=True, dataset=spec.name, **flags)
    rt = jax_initialize(jcfg)
    model, l2 = jax_build_model(model_name, num_classes=num_classes,
                                dtype=jcfg.compute_dtype)
    trainer = JaxTrainer(jcfg, rt, model, l2, spec)
    return trainer, rt, trainer.init_state(jax.random.key(0), batch)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = (tuple(np.shape(v)),
                                   np.asarray(v).dtype.name)
    return out


@pytest.mark.parametrize("model_name,optimizer,loss_scale", [
    ("transformer_small", "adamw", "dynamic"),
    ("resnet20", "sgd", None)])
def test_payload_keys_are_the_jax_train_states_flax_paths(
        monkeypatch, model_name, optimizer, loss_scale):
    if model_name == "resnet20":
        jspec = dataclasses.replace(jdata_base.CIFAR10, image_size=16)
        batch = (np.zeros((BATCH, 16, 16, 3), np.float32),
                 np.zeros((BATCH,), np.int32))
        num_classes = 10
    else:
        jspec = dataclasses.replace(jdata_base.LM, num_classes=VOCAB,
                                    seq_len=SEQ)
        batch = (np.zeros((BATCH, SEQ), np.int32),) * 2
        num_classes = VOCAB
    _, _, jstate = _jax_state(model_name, num_classes, jspec, batch,
                              optimizer=optimizer, loss_scale=loss_scale)
    want = _leaves(flax.serialization.to_state_dict(jstate))
    cfg = Config(device="cpu", model=model_name, batch_size=BATCH,
                 optimizer=optimizer, loss_scale=loss_scale,
                 dataset=jspec.name, train_steps=8)
    model, l2 = registry.build_model(model_name, num_classes=num_classes)
    spec = dataclasses.replace(data_base.get_dataset_spec(jspec.name),
                               num_classes=num_classes)
    trainer = Trainer(cfg, model, l2, spec)
    flat = convert.state_to_flat(model, trainer.init_state())
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flat.items()}
    assert got == want
    # and the nested numpy form round-trips through a fresh model
    tree = convert.train_state_to_flax(model, trainer.init_state())
    again, _ = registry.build_model(model_name, num_classes=num_classes)
    state = convert.train_state_from_flax(tree, again)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    assert state.loss_scale == (2.0 ** 15 if loss_scale else None)


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return type(obj).__name__


def test_manifest_is_the_jax_runners(tmp_path, monkeypatch):
    """One interval checkpoint at step 2 from each package's runner, the
    same flags: the manifests' key trees are equal, and so are their
    host states (seed, step, epoch, step in epoch, topology, data)."""
    tiny = dataclasses.replace(jdata_base.CIFAR10, num_train=64,
                               num_eval=16)
    monkeypatch.setitem(jdata_base._SPECS, "cifar10", tiny)
    common = dict(model="resnet20", dataset="cifar10", batch_size=4,
                  train_steps=3, use_synthetic_data=True, skip_eval=True,
                  use_trivial_model=True, log_steps=1, checkpoint_steps=2,
                  distribution_strategy="off", seed=5)
    jax_run(JaxConfig(model_dir=str(tmp_path / "jax"), verbose=0, **common))
    lm_flags = []
    for k, v in common.items():
        lm_flags += [f"--{k}", str(v).lower() if isinstance(v, bool)
                     else str(v)]
    cifar_main.main(lm_flags + ["--device", "cpu", "--model_dir",
                                str(tmp_path / "port")])
    read = lambda d: json.load(open(manifest_path(
        str(tmp_path / d / "checkpoints"), 2)))
    jm, pm = read("jax"), read("port")
    assert _key_tree(pm) == {**_key_tree(jm),
                             "files": {PAYLOAD: {"sha256": "str",
                                                 "size": "int"}}}
    assert all(set(f) == {"sha256", "size"} for f in jm["files"].values())
    assert pm["step"] == jm["step"] == 2
    assert pm["host_state"] == jm["host_state"]


# ---------------------------------------------------------------------------
# integrity: fallback past a torn newest step
# ---------------------------------------------------------------------------

def _toy(step, scale):
    return {"step": torch.tensor(step), "w": torch.full((64,), float(scale))}


def _save_two_steps(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    for s in (1, 2):
        ckpt.save(lambda s=s: _toy(s, s), step=s, host_state={"seed": 7})
    return ckpt


def _payload(tmp_path, step):
    return str(tmp_path / "checkpoints" / str(step) / PAYLOAD)


def _anomalies(trace_dir):
    trace.flush()
    return [r for r in trace.read_records(
        os.path.join(trace_dir, "trace_rank0.jsonl"))
        if r.get("kind") == "anomaly"]


def test_manifest_sealed_and_verified(tmp_path):
    ckpt = _save_two_steps(tmp_path)
    assert ckpt.all_steps() == [1, 2]
    assert ckpt.verified_steps() == [1, 2]
    assert ckpt.host_state(2) == {"seed": 7}
    # an unfinished write's temp directory is no step
    os.makedirs(os.path.join(ckpt.directory, "3.tmp-99"))
    assert ckpt.all_steps() == [1, 2] and ckpt.latest_step() == 2


def test_ckpt_truncate_falls_back_with_one_integrity_anomaly(tmp_path):
    """ckpt_truncate@latest tears the newest step once at the next
    restore, which falls back to the previous verified step; one
    ckpt_integrity anomaly says so."""
    trace.configure(str(tmp_path / "trace"), rank=0)
    ckpt = _save_two_steps(tmp_path)
    chaos.configure("ckpt_truncate@latest", rank=0)
    payload = ckpt.restore()
    assert int(payload["step"]) == 1 and float(payload["w"][0]) == 1.0
    assert ckpt.last_restored_step == 1 and ckpt.verify(2) == "corrupt"
    fault, integrity = _anomalies(str(tmp_path / "trace"))
    assert fault["name"] == "injected_fault"
    assert fault["fault"] == "ckpt_truncate@latest"
    assert (integrity["name"], integrity["step"], integrity["verdict"],
            integrity["action"]) == ("ckpt_integrity", 2, "corrupt",
                                     "fallback")
    # one-shot: the next restore does not tear step 1
    assert int(ckpt.restore()["step"]) == 1 and ckpt.verify(1) == "ok"


def test_corrupt_manifest_is_unverified_but_restorable(tmp_path):
    ckpt = _save_two_steps(tmp_path)
    with open(manifest_path(ckpt.directory, 2), "w") as f:
        f.write('{"files": {truncated garbage')
    assert ckpt.verify(2) == "unverified"
    assert int(ckpt.restore()["step"]) == 2


def test_missing_payload_is_corrupt_and_falls_back(tmp_path):
    ckpt = _save_two_steps(tmp_path)
    os.unlink(_payload(tmp_path, 2))
    assert ckpt.verify(2) == "corrupt"
    assert int(ckpt.restore()["step"]) == 1


def test_unreadable_unsealed_payload_falls_back(tmp_path):
    """No manifest (the process died between the payload and the seal)
    and a payload torch.load refuses: skipped as unreadable."""
    trace.configure(str(tmp_path / "trace"), rank=0)
    ckpt = _save_two_steps(tmp_path)
    os.unlink(manifest_path(ckpt.directory, 2))
    with open(_payload(tmp_path, 2), "r+b") as f:
        f.truncate(100)
    assert int(ckpt.restore()["step"]) == 1
    (a,) = _anomalies(str(tmp_path / "trace"))
    assert (a["name"], a["verdict"], a["step"]) == ("ckpt_integrity",
                                                    "unreadable", 2)


def test_explicit_step_restore_raises_on_corruption(tmp_path):
    ckpt = _save_two_steps(tmp_path)
    with open(_payload(tmp_path, 2), "r+b") as f:
        f.truncate(1)
    with pytest.raises(OSError):
        ckpt.restore(step=2)


def test_all_corrupt_restores_nothing(tmp_path):
    trace.configure(str(tmp_path / "trace"), rank=0)
    ckpt = _save_two_steps(tmp_path)
    for s in (1, 2):
        with open(_payload(tmp_path, s), "r+b") as f:
            f.truncate(1)
    assert ckpt.restore() is None
    assert any(a.get("verdict") == "none_usable"
               for a in _anomalies(str(tmp_path / "trace")))
    assert Checkpointer(str(tmp_path / "empty")).restore() is None


def test_load_train_checkpoint_falls_back_past_a_mid_write_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(lambda: {"step": torch.tensor(4), "params/w": torch.ones(8),
                       "opt_state/velocity/w": torch.zeros(8)}, step=4)
    mid = tmp_path / "checkpoints" / "5"
    mid.mkdir()
    (mid / PAYLOAD).write_bytes(b"\x00" * 10)
    out = load_train_checkpoint(str(tmp_path))
    assert set(out) == {"params", "batch_stats"} and out["batch_stats"] == {}
    assert torch.equal(out["params"]["w"], torch.ones(8))
    assert load_train_checkpoint(str(tmp_path / "none")) is None


def test_resave_of_a_step_replaces_it(tmp_path):
    """A run resumed past a corrupt newest step saves that step again:
    the new payload and seal replace the old."""
    ckpt = _save_two_steps(tmp_path)
    with open(_payload(tmp_path, 2), "r+b") as f:
        f.truncate(10)
    again = Checkpointer(str(tmp_path))
    again.save(lambda: _toy(2, 5.0), step=2)
    assert again.verify(2) == "ok"
    assert float(again.restore()["w"][0]) == 5.0


def test_max_to_keep_prunes_this_runs_oldest(tmp_path):
    ckpt = _save_two_steps(tmp_path)            # a previous run: 1, 2
    run = Checkpointer(str(tmp_path), max_to_keep=2)
    for s in (3, 4, 5):
        run.save(lambda s=s: _toy(s, s), step=s)
    assert run.all_steps() == [1, 2, 4, 5]
    assert not os.path.exists(manifest_path(ckpt.directory, 3))


# ---------------------------------------------------------------------------
# cross-run GC by verified set (--checkpoint_keep), tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def _sealed_steps(tmp_path, steps, name="gc"):
    ckpt = Checkpointer(str(tmp_path / name), max_to_keep=50)
    for s in steps:
        ckpt.save(lambda s=s: {"w": torch.full((4,), float(s))}, step=s)
    return ckpt


def test_gc_keeps_newest_verified(tmp_path):
    ckpt = _sealed_steps(tmp_path, [1, 2, 3, 4, 5])
    assert ckpt.gc(keep=2) == [1, 2, 3]
    assert ckpt.all_steps() == [4, 5]
    assert ckpt.verify(4) == "ok" and ckpt.verify(5) == "ok"
    for s in (1, 2, 3):
        assert not os.path.exists(manifest_path(ckpt.directory, s))


def test_gc_never_deletes_newer_than_newest_verified(tmp_path):
    ckpt = _sealed_steps(tmp_path, [1, 2, 3])
    os.makedirs(os.path.join(ckpt.directory, "9"))  # in flight, no manifest
    assert ckpt.gc(keep=1) == [1, 2]
    assert ckpt.all_steps() == [3, 9]


def test_gc_all_unverified_deletes_nothing(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "u"), max_to_keep=50)
    for s in (1, 2, 3):
        os.makedirs(os.path.join(ckpt.directory, str(s)))
    assert ckpt.gc(keep=1) == []
    assert ckpt.all_steps() == [1, 2, 3]


def test_gc_disabled_and_validated(tmp_path):
    ckpt = _sealed_steps(tmp_path, [1, 2])
    assert ckpt.gc(keep=0) == []
    assert ckpt.all_steps() == [1, 2]
    with pytest.raises(ValueError, match="checkpoint_keep"):
        Config(checkpoint_keep=-1)


def test_gc_spans_previous_runs_via_callback(tmp_path):
    zeros = lambda state: {"w": torch.zeros(2)}
    prev = CheckpointCallback(str(tmp_path), zeros, max_to_keep=50)
    for s in (1, 2, 3):                          # a previous run's
        prev.ckpt.save(lambda: {"w": torch.zeros(2)}, step=s)
    prev.on_train_end()
    cb = CheckpointCallback(str(tmp_path), zeros, max_to_keep=50, keep=2,
                            every_steps=1)
    for s in (4, 5):
        cb.on_batch_end(0, {"state": None, "step": s})
    cb.on_train_end()                            # gc(2)
    assert cb.ckpt.all_steps() == [4, 5]


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _lm_argv(tmp_path, *extra):
    return ["--use_synthetic_data", "--device", "cpu", "--model",
            "transformer_small", "--seq_len", "16", "--num_classes", "64",
            "--batch_size", "2", "--train_steps", "2", "--log_steps", "1",
            "--dtype", "fp32", "--model_dir", str(tmp_path / "m"),
            "--distribution_strategy", "off", *extra]


def test_seed_mismatch_on_resume_raises(tmp_path):
    lm_main.main(_lm_argv(tmp_path))
    with pytest.raises(ValueError, match="seed mismatch"):
        lm_main.main(_lm_argv(tmp_path, "--resume", "--seed", "1"))
    # the same seed resumes: nothing left to train
    stats = lm_main.main(_lm_argv(tmp_path, "--resume"))
    assert stats["train_loss_log"] == []


def test_eval_only_resume(tmp_path):
    with pytest.raises(FileNotFoundError, match="eval_only"):
        lm_main.main(_lm_argv(tmp_path, "--resume", "--eval_only",
                              "--skip_eval", "false"))
    lm_main.main(_lm_argv(tmp_path))
    stats = lm_main.main(_lm_argv(tmp_path, "--resume", "--eval_only",
                                  "--skip_eval", "false"))
    assert np.isfinite(stats["eval_loss"]) and "loss" not in stats
    assert stats["eval_count"] > 0


def test_resume_without_checkpoint_trains_from_scratch(tmp_path):
    stats = lm_main.main(_lm_argv(tmp_path, "--resume", "--clean"))
    assert [s for s, _ in stats["train_loss_log"]] == [1, 2]
    assert Checkpointer(str(tmp_path / "m")).all_steps() == [2]


def test_export_dir_serves_the_trained_weights(tmp_path):
    lm_main.main(_lm_argv(tmp_path, "--export_dir", str(tmp_path / "x")))
    exported = load_exported_model(str(tmp_path / "x"))
    trained = load_train_checkpoint(str(tmp_path / "m"))
    assert exported.keys() == trained.keys()
    flat_e, flat_t = (convert.flatten(v["params"])
                      for v in (exported, trained))
    assert flat_e.keys() == flat_t.keys()
    assert all(torch.equal(flat_e[k], flat_t[k]) for k in flat_e)
    base = ["--device", "cpu", "--model", "transformer_small",
            "--num_classes", "64", "--serve_max_seq_len", "16",
            "--serve_requests", "2", "--serve_max_new_tokens", "3",
            "--serve_prompt_len", "4", "--kv_page_size", "4"]
    out = serve_main.main(base + ["--export_dir", str(tmp_path / "x"),
                                  "--model_dir", str(tmp_path / "none")])
    assert out["requests"] == 2 and out["new_tokens"] == 6


# ---------------------------------------------------------------------------
# a JAX Trainer's state continued in the port
# ---------------------------------------------------------------------------

K_STEPS, MORE = 2, 2


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_jax_lm_train_state_continues_in_the_port(monkeypatch):
    """transformer_small (seq 16, vocab 64), AdamW with dynamic loss
    scaling: K JAX steps, the TrainState converted, MORE port steps on
    the batches the JAX run continues on -- losses 1e-5 relative, the
    step, the AdamW count and the scale carried."""
    jspec = dataclasses.replace(jdata_base.LM, num_classes=VOCAB, seq_len=SEQ,
                                num_train=64, num_eval=16)
    batches = [tuple(t.numpy() for t in _tokens(i))
               for i in range(K_STEPS + MORE)]
    jtrainer, rt, jstate = _jax_state(
        "transformer_small", VOCAB, jspec, batches[0], optimizer="adamw",
        loss_scale="dynamic")
    jl = []
    for i, batch in enumerate(batches):
        if i == K_STEPS:
            carried = _to_numpy(flax.serialization.to_state_dict(jstate))
        jstate, m = jtrainer.train_step(jstate, *rt.shard_batch(batch))
        jl.append(float(m["loss"]))
    cfg = Config(device="cpu", model="transformer_small", dataset="lm",
                 batch_size=BATCH, train_steps=8, optimizer="adamw",
                 loss_scale="dynamic")
    model, _ = registry.build_model("transformer_small", num_classes=VOCAB)
    trainer = Trainer(cfg, model, 0.0, dataclasses.replace(
        LM_TINY, num_classes=VOCAB))
    state = convert.train_state_from_flax(carried, model)
    assert (state.step, state.opt_state.count) == (K_STEPS, K_STEPS)
    assert state.loss_scale == float(carried["loss_scale"])
    tl = []
    for batch in batches[K_STEPS:]:
        state, m = trainer.train_step(state, *map(torch.from_numpy, batch))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl[K_STEPS:], rtol=1e-5)
    assert state.step == int(jstate.step)


def test_jax_resnet20_train_state_continues_in_the_port():
    """resnet20, Keras SGD + L2, BN buffers: K JAX steps converted, MORE
    port steps -- losses 1e-5 relative; the MORE steps' update within
    1e-2 of its norm and the BN buffers 1e-4 (Queue 3 item 5)."""
    jspec = dataclasses.replace(jdata_base.CIFAR10, image_size=16)
    batches = [tuple(t.numpy() for t in _images(i))
               for i in range(K_STEPS + MORE)]
    jtrainer, rt, jstate = _jax_state("resnet20", 10, jspec, batches[0],
                                      optimizer="sgd")
    jl = []
    for i, batch in enumerate(batches):
        if i == K_STEPS:
            carried = _to_numpy(flax.serialization.to_state_dict(jstate))
        jstate, m = jtrainer.train_step(jstate, *rt.shard_batch(batch))
        jl.append(float(m["loss"]))
    trainer, _ = _resnet_trainer(3)
    state = convert.train_state_from_flax(carried, trainer.model)
    tl = []
    for batch in batches[K_STEPS:]:
        state, m = trainer.train_step(state, *map(torch.from_numpy, batch))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl[K_STEPS:], rtol=1e-5)
    got = convert.train_state_to_flax(trainer.model, state)
    want = _to_numpy(flax.serialization.to_state_dict(jstate))
    start = convert.flatten(carried["params"])
    g, w = convert.flatten(got["params"]), convert.flatten(want["params"])
    upd_g = np.concatenate([(g[k] - start[k]).ravel() for k in sorted(g)])
    upd_w = np.concatenate([(w[k] - start[k]).ravel() for k in sorted(g)])
    assert np.linalg.norm(upd_g - upd_w) <= 1e-2 * np.linalg.norm(upd_w)
    for k, v in convert.flatten(want["batch_stats"]).items():
        np.testing.assert_allclose(convert.flatten(got["batch_stats"])[k],
                                   v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_serve_main_on_a_port_checkpoint_decodes_the_jax_tokens(
        tmp_path, monkeypatch):
    """Two port training steps, a checkpoint; serve_main's engine from
    --model_dir decodes, greedy, the JAX engine's tokens on the same
    parameters converted back to flax."""
    dims = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64,
                max_seq_len=32)
    monkeypatch.setitem(registry._REGISTRY, "transformer_small", (
        functools.partial(TransformerLM, **dims), VOCAB, 0.0))
    jmodel = JaxLM(vocab_size=VOCAB, **dims)
    model = TransformerLM(vocab_size=VOCAB, **dims)
    model.load_state_dict(convert.from_flax_params(_to_numpy(jmodel.init(
        jax.random.key(1), np.zeros((1, 32), np.int32))["params"]), model))
    trainer = Trainer(Config(device="cpu", dataset="lm", batch_size=BATCH,
                             train_steps=8, optimizer="adamw"),
                      model, 0.0, LM_TINY)
    state = trainer.init_state()
    for i in range(2):
        state, _ = trainer.train_step(state, *_tokens(i))
    Checkpointer(str(tmp_path)).save(
        lambda: trainer.checkpoint_payload(state), step=2)
    cfg = parse_flags(["--device", "cpu", "--model", "transformer_small",
                       "--model_dir", str(tmp_path), "--serve_max_batch",
                       "3", "--kv_page_size", "4", "--serve_prefill_chunk",
                       "8", "--serve_max_delay_ms", "0"])
    _, engine = serve_main.build_serving_engine(cfg)
    params = jax.tree_util.tree_map(jax.numpy.asarray,
                                    convert.to_flax_params(model))
    jengine = JaxEngine(jmodel, params, max_batch=3,
                        max_seq_len=32, kv_page_size=4, prefill_chunk=8,
                        prefix_sharing=False, max_delay_s=0.0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, (n,)).astype(np.int32)
               for n in (1, 5, 9, 17)]
    tokens = []
    for eng in (engine, jengine):
        try:
            hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            tokens.append([h.result(timeout=300).tokens for h in hs])
        finally:
            eng.stop(drain=False)
    assert tokens[0] == tokens[1]
    assert all(len(t) == 8 for t in tokens[0])
