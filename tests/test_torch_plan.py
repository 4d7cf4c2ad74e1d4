"""The port's training planner (``dtf_tpu_torch/plan``,
``cli/plan_main.py``, ``--plan`` in the runner and the elastic path)
against the JAX package's (``dtf_tpu/plan``, ``tests/test_plan.py``), on
the CPU.

Case by case as ``tests/test_plan.py``:

  1. characterization: each plannable registry model gives equal
     ``ModelStats`` in both packages, and its parameter count is the
     port model's ``sum(p.numel())``;
  2. the lattice point and the mesh descriptor: the same parser on the
     same ``k=v`` strings (the port carries ``cpu`` and the H100
     presets, not the TPU ones);
  3. ``check_plan``, 4. ``predict`` and 5. ``search`` /
     ``ranked_artifact``: JSON-identical on the same descriptor meshes
     (``hosts=4,devices=4,...`` and ``hosts=1,devices=8,hbm=16m``);
  6. ``apply_plan`` / ``plan_from_config`` to the same flags, and
     ``resolve_plan``'s guards, the live mesh counting ranks;
  7. ``--plan`` runs bit for bit with their hand-flagged twins: world 1
     in this process (and within 1e-5 of the JAX Trainer under the same
     plan), and two gloo ranks from a plan file;
  8. ``plan_main``: ranking, the cache, ``--check`` through launched
     ranks, ``--calibrate`` and its overlap feedback; the Trainer's two
     calibration gauges.

The calibration contract's band (step-time ratio in [0.5, 2]) is held
on the card by ``chip_smoke.py``'s planner phase.  On the CPU most of
the port's Trainer step is the AdamW update's elementwise passes, which
the cost model (matmul FLOPs only) does not price, so here the run's
gauges and the memory factor are checked.
"""

import dataclasses
import functools
import glob
import importlib
import inspect
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dtf_tpu.data.base as jdata_base
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.plan import apply_plan as jax_apply_plan
from dtf_tpu.plan import characterize as jax_characterize
from dtf_tpu.plan import check_plan as jax_check_plan
from dtf_tpu.plan import plan_from_config as jax_plan_from_config
from dtf_tpu.plan import predict as jax_predict
from dtf_tpu.plan import resolve_plan as jax_resolve_plan
from dtf_tpu.plan.cost_model import Plan as JaxPlan
from dtf_tpu.plan.mesh_spec import mesh_spec as jax_mesh_spec
from dtf_tpu.plan.search import enumerate_plans as jax_enumerate_plans
from dtf_tpu.plan.search import ranked_artifact as jax_ranked_artifact
from dtf_tpu.plan.search import search as jax_search
from dtf_tpu.runtime import initialize as jax_initialize
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import launch, lm_main, plan_main, runner
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.config import flags as port_flags
from dtf_tpu_torch.data import base as data_base
from dtf_tpu_torch.models import registry
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.registry import default_registry
from dtf_tpu_torch.plan import (Plan, apply_plan, characterize, check_plan,
                                load_plan_file, plan_from_config, predict,
                                resolve_plan, search)
from dtf_tpu_torch.plan.cost_model import OPTIMIZER_SLOTS
from dtf_tpu_torch.plan.mesh_spec import (GiB, H100_HBM_BYTES, PRESETS,
                                          mesh_spec)
from dtf_tpu_torch.plan.search import (best_plan, enumerate_plans,
                                       ranked_artifact)
from dtf_tpu_torch.runtime import mesh as rt_mesh
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV
from dtf_tpu_torch.train import elastic
from dtf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)
# every gloo group this file's ranks start gives up on a dead peer within
# 120 s (runtime/mesh.py TIMEOUT_ENV), well inside the suite's limit
os.environ.setdefault(TIMEOUT_ENV, "120")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
ENV_NAMES = ("DTF_COORDINATOR", "DTF_PROCESS_ID", "DTF_PROCESS_COUNT",
             "TF_CONFIG")
# the JAX package's 4x4 preset as a descriptor both packages parse alike
POD = "hosts=4,devices=4,hbm=32g,flops=140t,intra=100g,inter=25g"
TINY_HBM = "hosts=1,devices=8,hbm=16m"
CPU8 = "hosts=1,devices=8"
PLANNABLE = sorted(n for n in registry._REGISTRY
                   if not n.startswith("moe_transformer") and n != "trivial")
VOCAB, SEQ, BATCH = 256, 32, 4


@pytest.fixture(autouse=True)
def no_topology(monkeypatch):
    """Each test names its own topology: none leaks in from the shell."""
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    yield
    trace.disable()


def _same(port_obj, jax_obj):
    assert json.dumps(port_obj, sort_keys=True) == json.dumps(
        jax_obj, sort_keys=True)


def _both(name):
    """(port, JAX) objects of one name from the two plan packages."""
    return (importlib.import_module(f"dtf_tpu_torch.plan.{name}"),
            importlib.import_module(f"dtf_tpu.plan.{name}"))


# ---------------------------------------------------------------------------
# 1. model characterization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PLANNABLE)
def test_characterize_equals_the_jax_stats(name):
    for kw in (dict(), dict(seq_len=64, dtype_bytes=2),
               dict(num_classes=256, seq_len=128)):
        _same(dataclasses.asdict(characterize(name, **kw)),
              dataclasses.asdict(jax_characterize(name, **kw)))


@pytest.mark.parametrize("name", PLANNABLE)
def test_param_counts_are_the_port_models(name):
    """Counted without materializing: the model built on the meta
    device.  BatchNorm's running statistics are the non-trainable state
    (``num_batches_tracked`` is the port's bookkeeping, no flax leaf).
    Exact where the JAX package pins it (the transformer and ResNet
    families); the pipeline family's stacked blocks carry 2 d a layer
    more than the characterization counts, in the JAX model as in the
    port's -- both packages' stats alike, the port model the JAX
    model's size."""
    stats = characterize(name, seq_len=128)
    with torch.device("meta"):
        model, _ = registry.build_model(name)
    n = sum(p.numel() for p in model.parameters())
    if name.startswith("pipeline_transformer"):
        from dtf_tpu.models import build_model as jax_build_model
        jmodel, _ = jax_build_model(name)
        shapes = jax.eval_shape(
            functools.partial(jmodel.init, train=False), jax.random.key(0),
            jax.ShapeDtypeStruct((1, 128), jnp.int32))["params"]
        assert n == sum(int(np.prod(x.shape))
                        for x in jax.tree_util.tree_leaves(shapes))
        assert n - stats.params == 2 * stats.d_model * stats.num_layers
    else:
        assert stats.params == n
    state = sum(b.numel() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var")))
    assert stats.state == state


def test_characterize_rejects_unplannable():
    with pytest.raises(ValueError, match="MoE|by hand"):
        characterize("moe_transformer_small")
    with pytest.raises(ValueError, match="trivial"):
        characterize("trivial")
    with pytest.raises(ValueError, match="unknown model"):
        characterize("resnet9000")


def test_family_capabilities_mirror_runner():
    t = characterize("transformer_small", seq_len=64)
    assert t.supports_tp and t.supports_seq and t.supports_remat
    p = characterize("pipeline_transformer_small", seq_len=64)
    assert p.supports_pipeline and not p.supports_tp
    r = characterize("resnet20")
    assert not (r.supports_tp or r.supports_seq or r.supports_pipeline
                or r.supports_remat)
    assert characterize("resnet50").supports_remat


# ---------------------------------------------------------------------------
# 2. plan lattice point + mesh descriptor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(model=2, pipeline=2), dict(zero=4),
                                dict(data=0), dict(microbatch=0)])
def test_plan_rejects(kw):
    with pytest.raises(ValueError):
        Plan(**kw)
    with pytest.raises(ValueError):
        JaxPlan(**kw)


def test_plan_dict_roundtrip():
    p = Plan(data=2, model=4, zero=1, microbatch=2, remat=True)
    assert Plan.from_dict(p.to_dict()) == p
    assert p.to_dict() == JaxPlan(**p.to_dict()).to_dict()
    assert p.num_devices == 8 and p.model_axis_size == 4
    assert p.describe() == "dp=2,tp=4,zero1,micro=2,remat"
    with pytest.raises(ValueError, match="unknown plan fields"):
        Plan.from_dict({"data": 2, "tensor": 4})


@pytest.mark.parametrize("spec", [POD, TINY_HBM, CPU8, "cpu",
                                  "hosts=2,devices=4,hbm=16g,flops=10t,"
                                  "inter=5g"])
def test_mesh_descriptor_parses_as_jax(spec):
    _same(mesh_spec(spec).to_dict(), jax_mesh_spec(spec).to_dict())


def test_mesh_spec_presets_and_descriptor():
    assert mesh_spec("4xh100x8") is PRESETS["4xh100x8"]
    h = PRESETS["h100x8"]
    assert (h.num_hosts, h.devices_per_host) == (1, 8)
    assert h.hbm_bytes == H100_HBM_BYTES and h.device_flops == 989e12 / 2
    assert (h.intra_bw, h.inter_bw) == (450e9, 50e9)
    assert PRESETS["4xh100x8"].num_devices == 32
    m = mesh_spec("hosts=2,devices=4,hbm=16g,flops=10t,inter=5g")
    assert m.hbm_bytes == 16 * GiB and m.device_flops == 10e12
    assert m.intra_bw == PRESETS["cpu"].intra_bw    # unset keys inherit
    # the TPU presets are not carried: refused, naming the port's
    for tpu in ("v4-8", "4x4"):
        with pytest.raises(ValueError, match="unknown mesh preset.*"
                                             "4xh100x8.*h100x8"):
            mesh_spec(tpu)
    with pytest.raises(ValueError, match="unknown mesh descriptor key"):
        mesh_spec("hosts=2,chips=4")
    with pytest.raises(ValueError, match="positive"):
        mesh_spec("hbm=0")


def test_axis_bandwidth_tiers():
    m = PRESETS["4xh100x8"]          # 4 hosts x 8 devices
    assert m.axis_bandwidth(1, 8) == m.intra_bw    # span fits one host
    assert m.axis_bandwidth(1, 16) == m.inter_bw   # spans two hosts
    assert m.axis_bandwidth(8, 4) == m.inter_bw    # outer axis across
    assert m.axis_bandwidth(1, 1) == m.intra_bw    # degenerate
    j = jax_mesh_spec(POD)
    p = mesh_spec(POD)
    for stride, size in ((1, 4), (1, 8), (4, 4), (2, 2), (1, 1)):
        assert p.axis_bandwidth(stride, size) == j.axis_bandwidth(stride,
                                                                  size)


# ---------------------------------------------------------------------------
# 3-5. check_plan, predict, search: the JAX package's answers
# ---------------------------------------------------------------------------

CHECK_CASES = [
    ("transformer_small", 64, dict(data=2, model=4), 8),
    ("transformer_small", 64, dict(data=4), 8),
    ("transformer_small", 64, dict(data=1, model=8), 8),
    ("transformer_small", 64, dict(data=2, seq=4), 8),
    ("transformer_small", 60, dict(data=1, seq=8), 8),
    ("transformer_small", 64, dict(data=2, model=4), 9),
    ("transformer_small", 64, dict(data=2, model=4, microbatch=8), 8),
    ("resnet20", None, dict(data=2, model=4), 8),
    ("transformer_small", 64, dict(data=2, pipeline=4), 8),
    ("resnet20", None, dict(data=8, remat=True), 8),
    ("pipeline_transformer_small", 64, dict(data=2, pipeline=4,
                                            microbatch=2), 8),
    ("pipeline_transformer_small", 64, dict(data=1, pipeline=8), 8),
]


@pytest.mark.parametrize("model,seq,plan,batch", CHECK_CASES)
def test_check_plan_as_jax(model, seq, plan, batch):
    got = check_plan(Plan(**plan), characterize(model, seq_len=seq),
                     mesh_spec("cpu"), batch)
    want = jax_check_plan(JaxPlan(**plan), jax_characterize(model,
                                                            seq_len=seq),
                          jax_mesh_spec("cpu"), batch)
    assert got == want


PREDICT_CASES = [
    dict(data=16), dict(data=16, zero=1), dict(data=16, zero=2),
    dict(data=16, zero=3), dict(data=16, zero=2, microbatch=2),
    dict(data=16, zero=3, microbatch=4), dict(data=16, remat=True),
    dict(data=4, model=4), dict(data=8, seq=2), dict(data=16, microbatch=4),
    dict(data=2, model=8, zero=1, remat=True),
]


@pytest.mark.parametrize("plan", PREDICT_CASES)
@pytest.mark.parametrize("overlap", [0.0, 0.5, 0.9])
def test_predict_is_json_identical(plan, overlap):
    kw = dict(seq_len=2048, dtype_bytes=2)
    got = predict(Plan(**plan), characterize("transformer_tpu", **kw),
                  mesh_spec(POD), 256, optimizer="adamw",
                  overlap_frac=overlap)
    want = jax_predict(JaxPlan(**plan),
                       jax_characterize("transformer_tpu", **kw),
                       jax_mesh_spec(POD), 256, optimizer="adamw",
                       overlap_frac=overlap)
    _same(got.to_dict(), want.to_dict())


def _cost(plan, batch=256, optimizer="adamw"):
    return predict(plan, characterize("transformer_tpu", seq_len=2048,
                                      dtype_bytes=2),
                   mesh_spec(POD), batch, optimizer=optimizer)


def test_cost_model_levers_move_the_right_way():
    """The JAX tests' directions on the port's copy: ZeRO-1 cuts memory
    at equal time, stage 2 beats stage 1's grads, remat trades memory
    for compute, TP divides params and pays psums, seq parallelism pays
    the ring, accumulation double-buffers the gradient."""
    base = _cost(Plan(data=16))
    z1 = _cost(Plan(data=16, zero=1))
    assert z1.peak_bytes < base.peak_bytes
    assert z1.step_time_s == base.step_time_s
    z1m, z2m = (_cost(Plan(data=16, zero=z, microbatch=2)) for z in (1, 2))
    assert z2m.breakdown["grad_bytes"] < z1m.breakdown["grad_bytes"] / 2
    r = _cost(Plan(data=16, remat=True))
    assert r.breakdown["act_bytes"] < base.breakdown["act_bytes"]
    assert r.compute_s > base.compute_s
    tp = _cost(Plan(data=4, model=4))
    assert tp.breakdown["param_bytes"] < base.breakdown["param_bytes"]
    assert tp.breakdown["tp_psum_s"] > 0
    assert _cost(Plan(data=8, seq=2)).breakdown["seq_ring_s"] > 0
    m = _cost(Plan(data=16, microbatch=4))
    assert m.breakdown["grad_bytes"] == 2 * base.breakdown["grad_bytes"]
    assert OPTIMIZER_SLOTS["adamw"] == 2
    with pytest.raises(ValueError, match="unknown optimizer"):
        _cost(Plan(data=16), optimizer="lion")
    with pytest.raises(ValueError, match="overlap_frac"):
        predict(Plan(data=16, zero=2), characterize("transformer_tpu"),
                mesh_spec(POD), 256, overlap_frac=1.5)


SEARCH_CASES = [
    ("transformer_small", 64, 8, CPU8, "adamw", 4),
    ("transformer_small", 64, 8, TINY_HBM, "sgd", 4),
    ("transformer_tpu", 2048, 256, POD, "adamw", 2),
    ("pipeline_transformer_small", 64, 8, CPU8, "sgd", 4),
    ("resnet20", None, 8, CPU8, "momentum", 4),
    ("resnet50", None, 64, POD, "sgd", 4),
]


@pytest.mark.parametrize("model,seq,batch,spec,opt,dt", SEARCH_CASES)
def test_search_and_artifact_are_json_identical(model, seq, batch, spec,
                                                opt, dt):
    stats = characterize(model, seq_len=seq, dtype_bytes=dt)
    jstats = jax_characterize(model, seq_len=seq, dtype_bytes=dt)
    mesh, jmesh = mesh_spec(spec), jax_mesh_spec(spec)
    assert [p.to_dict() for p in enumerate_plans(stats, mesh, batch)] == [
        p.to_dict() for p in jax_enumerate_plans(jstats, jmesh, batch)]
    ranked = search(stats, mesh, batch, optimizer=opt)
    jranked = jax_search(jstats, jmesh, batch, optimizer=opt)
    _same([r.to_dict() for r in ranked], [r.to_dict() for r in jranked])
    _same(ranked_artifact(stats, mesh, batch, ranked, top=5),
          jax_ranked_artifact(jstats, jmesh, batch, jranked, top=5))


def test_search_ranks_feasible_first_fastest_first():
    ranked = search(characterize("transformer_small", seq_len=64),
                    PRESETS["cpu"], 8, optimizer="adamw")
    feas = [r.feasible for r in ranked]
    assert feas == sorted(feas, reverse=True)
    times = [r.cost.step_time_s for r in ranked if r.feasible]
    assert times == sorted(times)


def test_best_plan_loud_when_nothing_fits():
    with pytest.raises(ValueError, match="HBM budget"):
        best_plan(characterize("transformer_small", seq_len=64),
                  mesh_spec(TINY_HBM), 8)


def test_h100_presets_rank_the_flagship():
    """transformer_tpu (bf16, S 2048, AdamW, global batch 256) on the
    H100 presets: every plan of the lattice fits 80 GB, and the ranking
    is the JAX code's on the same numbers."""
    stats = characterize("transformer_tpu", seq_len=2048, dtype_bytes=2)
    for name in ("h100x8", "4xh100x8"):
        preset = PRESETS[name]
        spec = (f"hosts={preset.num_hosts},devices={preset.devices_per_host},"
                f"hbm={preset.hbm_bytes},flops=494.5t,intra=450g,inter=50g")
        ranked = search(stats, preset, 256, optimizer="adamw")
        assert ranked and all(r.feasible for r in ranked)
        jranked = jax_search(jax_characterize("transformer_tpu",
                                              seq_len=2048, dtype_bytes=2),
                             jax_mesh_spec(spec), 256, optimizer="adamw")
        assert [r.plan.to_dict() for r in ranked] == [
            r.plan.to_dict() for r in jranked]


# ---------------------------------------------------------------------------
# 6. plan -> config compilation, resolution and the live mesh
# ---------------------------------------------------------------------------

def _kw(**kw):
    base = dict(model="transformer_small", dataset="lm",
                use_synthetic_data=True, seq_len=64, batch_size=8,
                train_steps=3, log_steps=1, skip_eval=True,
                skip_checkpoint=True, model_dir="")
    base.update(kw)
    return base


def _port_cfg(**kw):
    return Config(device="cpu", **_kw(**kw))


OWNED = ("plan", "num_devices", "model_parallelism", "seq_parallelism",
         "optimizer_sharding", "zero_stage", "grad_accum_steps",
         "num_microbatches", "remat", "remat_policy")

COMPILE_CASES = [
    ("transformer_small", dict(data=8)),
    ("transformer_small", dict(data=2, model=4, zero=1, microbatch=2)),
    ("transformer_small", dict(data=4, seq=2, microbatch=2, remat=True)),
    ("transformer_small", dict(data=8, zero=3, microbatch=4)),
    ("pipeline_transformer_small", dict(data=2, pipeline=4, microbatch=2)),
]


@pytest.mark.parametrize("model,plan", COMPILE_CASES)
def test_apply_plan_and_back_as_jax(model, plan):
    cfg = apply_plan(_port_cfg(model=model), Plan(**plan))
    jcfg = jax_apply_plan(JaxConfig(**_kw(model=model)), JaxPlan(**plan))
    assert {k: getattr(cfg, k) for k in OWNED} == {
        k: getattr(jcfg, k) for k in OWNED}
    assert plan_from_config(cfg, 8) == Plan(**plan)
    assert jax_plan_from_config(jcfg, 8).to_dict() == Plan(**plan).to_dict()


def test_apply_plan_rejects_handset_conflicts():
    with pytest.raises(ValueError, match="conflicts with hand-set"):
        apply_plan(_port_cfg(model_parallelism=4), Plan(data=8))
    with pytest.raises(ValueError, match="contradicts"):
        apply_plan(_port_cfg(num_devices=4), Plan(data=8))
    assert apply_plan(_port_cfg(num_devices=8), Plan(data=8)).num_devices == 8


def test_plan_from_config_pipeline_auto_microbatch():
    cfg = _port_cfg(model="pipeline_transformer_small",
                    model_parallelism=4, batch_size=32)
    assert plan_from_config(cfg, 8).microbatch == 16
    cfg_odd = _port_cfg(model="pipeline_transformer_small",
                        model_parallelism=4, batch_size=4)
    assert plan_from_config(cfg_odd, 8).microbatch == 2


@pytest.mark.parametrize("pp,batch", [(2, 8), (2, 6), (4, 32), (4, 4),
                                      (4, 3), (1, 5)])
def test_plan_from_config_takes_the_runners_microbatch_rule(pp, batch):
    """A pipeline config with ``num_microbatches`` unset: the plan's
    microbatch count is the one the runner builds the stages with."""
    cfg = _port_cfg(model="pipeline_transformer_small",
                    model_parallelism=pp, batch_size=batch)
    assert plan_from_config(cfg, pp).microbatch == runner.pipeline_kw(
        cfg, batch)["num_microbatches"]


def test_load_plan_file_forms(tmp_path):
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"data": 2, "model": 4}))
    assert load_plan_file(str(bare)) == Plan(data=2, model=4)
    wrapped = tmp_path / "wrapped.json"
    wrapped.write_text(json.dumps({"plan": {"data": 8}}))
    assert load_plan_file(str(wrapped)) == Plan(data=8)
    art = tmp_path / "ranked.json"
    art.write_text(json.dumps({"plans": [
        {"plan": {"data": 4}, "feasible": False},
        {"plan": {"data": 8, "zero": 1}, "feasible": True}]}))
    assert load_plan_file(str(art)) == Plan(data=8, zero=1)
    art.write_text(json.dumps({"plans": [
        {"plan": {"data": 4}, "feasible": False}]}))
    with pytest.raises(ValueError, match="no\\s+feasible"):
        load_plan_file(str(art))


def _launched(monkeypatch, world: int, coordinator="file:///tmp/rdv"):
    """The launcher's environment for rank 0 of ``world`` local ranks."""
    monkeypatch.setenv("DTF_COORDINATOR", coordinator)
    monkeypatch.setenv("DTF_PROCESS_ID", "0")
    monkeypatch.setenv("DTF_PROCESS_COUNT", str(world))


@pytest.mark.parametrize("strategy", ["multi_worker_mirrored", "mirrored"])
def test_resolve_plan_auto_as_jax_on_the_live_mesh(monkeypatch, strategy):
    """Eight locally launched ranks are the JAX package's 8-device CPU
    mesh: the same plan, the same flags."""
    _launched(monkeypatch, 8)
    cfg = parse_flags(["--device", "cpu", "--distribution_strategy",
                       strategy, "--plan", "auto", "--model",
                       "transformer_small", "--dataset", "lm",
                       "--seq_len", "64", "--batch_size", "8"])
    got = resolve_plan(cfg)
    want = jax_resolve_plan(JaxConfig(**_kw(plan="auto")))
    assert got.plan == "" and got.num_devices == 8
    assert {k: getattr(got, k) for k in OWNED} == {
        k: getattr(want, k) for k in OWNED}


def test_resolve_plan_rejects_oversized_mesh(tmp_path):
    """A plan for more devices than the run has ranks dies at resolve
    time with the JAX message (here: one rank, a 16-device plan)."""
    f = tmp_path / "p.json"
    f.write_text(json.dumps({"data": 16}))
    with pytest.raises(ValueError, match="attached"):
        resolve_plan(_port_cfg(plan=str(f), plan_mesh="hosts=2,devices=8",
                               batch_size=16))


def test_resolve_plan_rejects_a_plan_smaller_than_the_launched_world(
        monkeypatch, tmp_path):
    _launched(monkeypatch, 4)
    f = tmp_path / "p.json"
    f.write_text(json.dumps({"data": 2}))
    cfg = parse_flags(["--device", "cpu", "--distribution_strategy",
                       "multi_worker_mirrored", "--plan", str(f),
                       "--plan_mesh", "hosts=1,devices=2", "--model",
                       "transformer_small", "--dataset", "lm",
                       "--seq_len", "64", "--batch_size", "8"])
    with pytest.raises(ValueError, match="has 4 ranks"):
        resolve_plan(cfg)


def test_resolve_plan_rejects_multihost_num_devices():
    with pytest.raises(ValueError, match="multi-host"):
        resolve_plan(_port_cfg(plan="auto", num_devices=4),
                     mesh=mesh_spec(POD))


def test_resolve_plan_noop_and_guards(tmp_path):
    cfg = _port_cfg()
    assert resolve_plan(cfg) is cfg
    bad = tmp_path / "p.json"
    bad.write_text(json.dumps({"data": 8}))
    with pytest.raises(ValueError, match="SPMD"):
        resolve_plan(_port_cfg(plan=str(bad),
                               distribution_strategy="parameter_server"))


def test_resolve_plan_rejects_infeasible_file(tmp_path):
    f = tmp_path / "p.json"
    f.write_text(json.dumps({"data": 8}))
    with pytest.raises(ValueError, match="INFEASIBLE"):
        resolve_plan(_port_cfg(plan=str(f)), mesh=mesh_spec(TINY_HBM))


def test_resolve_plan_on_cuda_needs_a_card():
    """On CUDA the guard also checks that the rank's card exists: here
    there is none, and the resolve raises before any run starts."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_plan(Config(**_kw(plan="auto", plan_mesh="cpu",
                                  num_devices=None),
                            distribution_strategy="off"))


def test_config_validates_plan_flags(tmp_path):
    with pytest.raises(ValueError, match="no such plan file"):
        Config(model="resnet20", dataset="cifar10",
               plan=str(tmp_path / "missing.json"))
    with pytest.raises(ValueError, match="unknown mesh preset"):
        Config(model="resnet20", dataset="cifar10", plan_mesh="v9000")
    Config(model="resnet20", dataset="cifar10", plan="auto",
           plan_mesh="4xh100x8")
    assert port_flags.NOT_PORTED == {}


class _Props:
    total_memory = 80 * GiB


def _one_card(monkeypatch):
    """A host with one CUDA card, as far as the live mesh asks."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props())
    monkeypatch.setattr(rt_mesh, "resolve_device",
                        lambda name: torch.device(name))


def test_live_mesh_counts_local_ranks_as_one_host_sharing_the_card(
        monkeypatch):
    """Two ranks the launcher started on this host are one host with two
    devices, not two hosts; on one card each gets half its memory and
    half the H100 preset's FLOP/s."""
    _one_card(monkeypatch)
    _launched(monkeypatch, 2)
    cfg = parse_flags(["--device", "cuda", "--distribution_strategy",
                       "multi_worker_mirrored"])
    topo = rt_mesh.topology(cfg)
    assert topo == {"num_hosts": 1, "devices_per_host": 2,
                    "platform": "gpu", "cards_per_host": 1,
                    "ranks_per_device": 2, "device_memory": 80 * GiB}
    live = mesh_spec("", cfg=cfg)
    assert (live.num_hosts, live.devices_per_host) == (1, 2)
    assert live.hbm_bytes == 40 * GiB
    assert live.device_flops == PRESETS["h100x8"].device_flops / 2
    assert (live.intra_bw, live.inter_bw) == (450e9, 50e9)
    # a bound on the devices a host (plan_main --devices 4, say) shares
    # the card four ways; one rank alone has it whole
    assert mesh_spec("", cfg=cfg, live_devices=4).hbm_bytes == 20 * GiB
    one = parse_flags(["--device", "cuda", "--distribution_strategy",
                       "off"])
    assert mesh_spec("", cfg=one).hbm_bytes == 80 * GiB


def test_live_mesh_counts_named_hosts(monkeypatch):
    """``--worker_hosts`` and ``TF_CONFIG`` name hosts; a launcher
    rendezvous on another host is the ``--hosts`` fan-out (one rank a
    host); the CPU run takes the ``cpu`` preset's numbers."""
    cfg = parse_flags(["--device", "cpu", "--distribution_strategy",
                       "multi_worker_mirrored", "--worker_hosts",
                       "h1:1,h1:2,h2:1,h2:2", "--task_index", "0"])
    assert rt_mesh.topology(cfg)["num_hosts"] == 2
    assert mesh_spec("", cfg=cfg).devices_per_host == 2
    monkeypatch.setenv("TF_CONFIG", json.dumps(
        {"cluster": {"worker": ["a:1", "b:1", "c:1"]},
         "task": {"type": "worker", "index": 0}}))
    cfg = parse_flags(["--device", "cpu", "--distribution_strategy",
                       "multi_worker_mirrored"])
    assert rt_mesh.topology(cfg)["num_hosts"] == 3
    monkeypatch.delenv("TF_CONFIG")
    _launched(monkeypatch, 4, coordinator="h0.cluster:1234")
    cfg = parse_flags(["--device", "cpu", "--distribution_strategy",
                       "multi_worker_mirrored"])
    live = mesh_spec("", cfg=cfg)
    assert (live.num_hosts, live.devices_per_host) == (4, 1)
    assert live.hbm_bytes == PRESETS["cpu"].hbm_bytes
    _launched(monkeypatch, 4, coordinator="localhost:1234")
    cfg = parse_flags(["--device", "cpu", "--distribution_strategy",
                       "multi_worker_mirrored"])
    assert rt_mesh.topology(cfg)["num_hosts"] == 1


def test_mirrored_main_starts_the_plans_ranks(monkeypatch, tmp_path):
    """A mirrored command resolves its plan before counting the ranks it
    starts: a 2-device plan on a 4-device host starts 2."""
    calls = []
    monkeypatch.setattr(rt_mesh, "local_device_count", lambda kind: 4)
    monkeypatch.setattr(launch, "launch_local",
                        lambda *a, **kw: calls.append(a) or 0)
    f = tmp_path / "p.json"
    f.write_text(json.dumps({"data": 2, "zero": 2}))
    argv = ["--use_synthetic_data", "--device", "cpu", "--model",
            "transformer_small", "--seq_len", "32", "--num_classes", "256",
            "--plan", str(f), "--plan_mesh", "hosts=1,devices=2"]
    assert lm_main.main(argv) == {}
    (cmd, world, _, _), = calls
    assert world == 2 and cmd[-len(argv):] == argv


def test_replan_for_surviving_keeps_global_batch(monkeypatch):
    """As ``tests/test_elastic.py``: the global batch is invariant, the
    data-parallel degree follows the surviving ranks."""
    _launched(monkeypatch, 8)
    cfg = parse_flags(["--device", "cpu", "--distribution_strategy",
                       "multi_worker_mirrored", "--model",
                       "transformer_small", "--dataset", "lm",
                       "--seq_len", "64", "--batch_size", "8",
                       "--use_synthetic_data", "--plan", "auto"])
    full = elastic.replan_for_surviving(cfg, 4)
    half = elastic.replan_for_surviving(cfg, 2)
    assert full.batch_size == half.batch_size == 8
    assert full.num_devices == 4 and half.num_devices == 2
    assert (full.process_count, half.process_count) == (4, 2)
    assert not full.plan and not half.plan


# ---------------------------------------------------------------------------
# 7. --plan runs are bit-identical to the hand-flagged equivalent
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=VOCAB, num_layers=2, d_model=256, num_heads=4,
             d_ff=1024)


@pytest.fixture
def two_layers(monkeypatch):
    """transformer_small at 2 of its 4 layers in this process."""
    ctor, classes, l2 = registry._REGISTRY["transformer_small"]
    monkeypatch.setitem(registry._REGISTRY, "transformer_small",
                        (functools.partial(ctor, num_layers=2), classes, l2))


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Launched CPU ranks take one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _run_here(cfg):
    """runner.run(cfg) in this process: per-step losses and the trained
    state dict."""
    kept = {}
    build = runner.build_training

    def keep(c, rt=None):
        out = build(c, rt)
        kept["trainer"], kept["cfg"] = out[0], c
        return out

    runner.build_training = keep
    try:
        stats = runner.run(cfg)
    finally:
        runner.build_training = build
    return ([v for _, v in stats["train_loss_log"]],
            kept["trainer"].model.state_dict(), kept["cfg"])


def test_plan_auto_world1_bit_identical_to_hand_flags(two_layers):
    """The world-1 live mesh: ``--plan auto`` and the flags it resolves
    to, set by hand, train alike to the bit (losses and weights)."""
    base = dict(num_classes=VOCAB, seq_len=SEQ, batch_size=BATCH,
                optimizer="adamw")
    planned = _port_cfg(plan="auto", **base)
    losses, state, ran = _run_here(planned)
    hand = resolve_plan(planned)
    assert hand.plan == "" and hand.num_devices == 1
    assert ran.plan == "" and {k: getattr(ran, k) for k in OWNED} == {
        k: getattr(hand, k) for k in OWNED}
    hand_losses, hand_state, _ = _run_here(hand)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses == hand_losses
    for name, t in state.items():
        assert torch.equal(t, hand_state[name]), name


def test_plan_auto_world1_within_1e5_of_the_jax_trainer(monkeypatch):
    """The same plan in both packages (the world-1 mesh: JAX's descriptor
    of one device), then each Trainer under its flags on the same
    JAX-initialized weights and batches: float32 losses within 1e-5."""
    base = dict(num_classes=VOCAB, seq_len=SEQ, batch_size=BATCH,
                optimizer="adamw", distribution_strategy="off",
                plan="auto")
    cfg = resolve_plan(_port_cfg(**base))
    jcfg = jax_resolve_plan(JaxConfig(**_kw(**base)),
                            mesh=jax_mesh_spec("hosts=1,devices=1"))
    assert {k: getattr(cfg, k) for k in OWNED} == {
        k: getattr(jcfg, k) for k in OWNED}
    jspec = dataclasses.replace(jdata_base.LM, num_classes=VOCAB,
                                seq_len=SEQ, num_train=64, num_eval=16)
    spec = dataclasses.replace(data_base.LM, num_classes=VOCAB,
                               seq_len=SEQ, num_train=64, num_eval=16)
    monkeypatch.setitem(jdata_base._SPECS, "lm", jspec)
    rt = jax_initialize(jcfg)
    tokens = np.random.default_rng(7).integers(
        0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    jtrainer = JaxTrainer(jcfg, rt, JaxLM(**SMALL, dtype=jnp.float32), 0.0,
                          jspec)
    jstate = jtrainer.init_state(jax.random.key(0), (tokens, labels))
    model = TransformerLM(**SMALL)
    model.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), model))
    trainer = Trainer(cfg, model, 0.0, spec)
    state = trainer.init_state()
    jl, tl = [], []
    for _ in range(3):
        jstate, m = jtrainer.train_step(jstate,
                                        *rt.shard_batch((tokens, labels)))
        jl.append(float(m["loss"]))
        state, tm = trainer.train_step(state, torch.from_numpy(tokens),
                                       torch.from_numpy(labels))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def _trace_losses(trace_dir: str) -> dict:
    out = {}
    for path in glob.glob(os.path.join(trace_dir, "trace_rank*.jsonl")):
        for rec in trace.read_records(path):
            if rec.get("kind") == "event" and rec.get("name") == "train_loss":
                out.setdefault(int(rec["step"]), set()).add(rec["loss"])
    return out


def _launch_lm(tmp_path, name: str, argv, world: int = 2) -> dict:
    """``lm_main`` on ``world`` gloo ranks through the launcher; the
    per-step losses every rank traced."""
    root = tmp_path / name
    root.mkdir()
    cmd = [sys.executable, "-m", "dtf_tpu_torch.cli.lm_main",
           "--use_synthetic_data", "--device", "cpu", "--model",
           "transformer_small", "--seq_len", str(SEQ), "--num_classes",
           str(VOCAB), "--batch_size", str(BATCH), "--train_steps", "3",
           "--log_steps", "1", "--skip_checkpoint", "--dtype", "fp32",
           "--distribution_strategy", "multi_worker_mirrored",
           "--trace_dir", str(root / "trace")] + list(argv)
    rc = launch.launch_local(cmd, world, f"file://{root}/rdv",
                             str(root / "logs"), timeout_s=TIMEOUT_S)
    logs = "".join(open(p).read()[-2000:]
                   for p in glob.glob(str(root / "logs" / "log*.log")))
    assert rc == 0, logs
    return _trace_losses(str(root / "trace"))


def test_two_gloo_ranks_from_a_plan_file_bit_identical(tmp_path,
                                                       one_thread_ranks):
    """A ZeRO-2 plan file on two gloo ranks and the same flags by hand:
    per-step losses to the bit, every rank's alike."""
    f = tmp_path / "zero2.json"
    f.write_text(json.dumps({"plan": {"data": 2, "zero": 2}}))
    results = {}

    def go(name, argv):
        results[name] = _launch_lm(tmp_path, name, argv)

    threads = [threading.Thread(target=go, args=a, daemon=True) for a in (
        ("planned", ["--plan", str(f)]),
        ("hand", ["--zero_stage", "2", "--num_devices", "2"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S + 30)
        assert not t.is_alive()
    planned, hand = results["planned"], results["hand"]
    assert set(planned) == {1, 2, 3}
    assert all(len(v) == 1 for v in planned.values())   # ranks alike
    assert planned == hand


# ---------------------------------------------------------------------------
# 8. plan_main, the cache, calibration and the Trainer's gauges
# ---------------------------------------------------------------------------

def _plan_main(capsys, *args):
    rc = plan_main.main(list(args))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_plan_main_ranks_and_writes_artifact(tmp_path, capsys):
    out = tmp_path / "plans.json"
    rc, stdout, err = _plan_main(
        capsys, "--model", "transformer_tpu", "--dataset", "lm",
        "--seq_len", "2048", "--batch_size", "256", "--dtype", "bf16",
        "--optimizer", "adamw", "--plan_mesh", "4xh100x8", "--top", "5",
        "--out", str(out))
    assert rc == 0, err
    assert "plans feasible" in stdout and "4xh100x8 (4×8 devices" in stdout
    art = json.loads(out.read_text())
    assert art["mesh"]["name"] == "4xh100x8" and len(art["plans"]) == 5
    assert art["plans"][0]["feasible"] is True


def test_plan_main_artifact_is_the_jax_artifact(tmp_path, capsys):
    """The same ranking through both CLIs on one descriptor mesh."""
    from dtf_tpu.cli import plan_main as jax_plan_main
    args = ["--model", "transformer_small", "--dataset", "lm",
            "--seq_len", "64", "--batch_size", "8", "--optimizer", "adamw",
            "--plan_mesh", POD, "--top", "7"]
    rc = plan_main.main(args + ["--out", str(tmp_path / "port.json")])
    jrc = jax_plan_main.main(args + ["--out", str(tmp_path / "jax.json")])
    capsys.readouterr()
    assert rc == jrc == 0
    assert (tmp_path / "port.json").read_text() == (
        tmp_path / "jax.json").read_text()


def test_plan_cache_hit_reproduces_search_and_keys_strictly(tmp_path):
    cached_search = _both("cache")[0].cached_search
    from dtf_tpu_torch.plan.compile import stats_for_config
    stats = stats_for_config(_port_cfg())
    mesh = mesh_spec("cpu")
    path = str(tmp_path / "plan_cache.json")
    fresh, hit1 = cached_search(path, stats, mesh, 8)
    again, hit2 = cached_search(path, stats, mesh, 8)
    assert not hit1 and hit2
    assert [r.to_dict() for r in again] == [r.to_dict() for r in fresh]
    assert not cached_search(path, stats, mesh, 16)[1]
    assert not cached_search(path, stats, mesh_spec("4xh100x8"), 8)[1]
    with open(path, "w") as f:
        f.write("{not json")
    recomputed, hit5 = cached_search(path, stats, mesh, 8)
    assert not hit5
    assert [r.to_dict() for r in recomputed] == [r.to_dict() for r in fresh]
    assert cached_search(path, stats, mesh, 8)[1]


def test_plan_cache_key_and_file_as_jax(tmp_path):
    """One workload through both packages' caches: the same key, and the
    same sidecar file byte for byte."""
    (port_cache, jax_cache) = _both("cache")
    from dtf_tpu.plan.compile import stats_for_config as jax_stats
    from dtf_tpu_torch.plan.compile import stats_for_config
    stats = stats_for_config(_port_cfg())
    jstats = jax_stats(JaxConfig(**_kw()))
    assert port_cache.CACHE_VERSION == jax_cache.CACHE_VERSION
    assert port_cache.cache_key(stats, mesh_spec(CPU8), 8, "sgd") == \
        jax_cache.cache_key(jstats, jax_mesh_spec(CPU8), 8, "sgd")
    port_cache.cached_search(str(tmp_path / "p.json"), stats,
                             mesh_spec(CPU8), 8)
    jax_cache.cached_search(str(tmp_path / "j.json"), jstats,
                            jax_mesh_spec(CPU8), 8)
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())


def test_plan_main_uses_cache_on_repeat(tmp_path, capsys):
    cache = str(tmp_path / "cache.json")
    args = ("--model", "transformer_tpu", "--dataset", "lm",
            "--seq_len", "2048", "--batch_size", "256", "--dtype", "bf16",
            "--optimizer", "adamw", "--plan_mesh", "h100x8", "--top", "3",
            "--plan_cache", cache)
    rc1, out1, _ = _plan_main(capsys, *args)
    rc2, out2, _ = _plan_main(capsys, *args)
    assert rc1 == rc2 == 0
    assert "plan cache: miss" in out1 and "HIT — search skipped" in out2
    tbl = lambda s: [ln for ln in s.splitlines()
                     if ln.strip().startswith(("1 ", "2 ", "3 "))]
    assert tbl(out1) == tbl(out2) and len(tbl(out1)) == 3


def test_resolve_plan_auto_through_cache(monkeypatch, tmp_path):
    """--plan auto resolution (the runner's path) through the sidecar
    compiles the same flags as the uncached resolve, miss and hit."""
    _launched(monkeypatch, 8)
    argv = ["--device", "cpu", "--distribution_strategy",
            "multi_worker_mirrored", "--model", "transformer_small",
            "--dataset", "lm", "--seq_len", "64", "--batch_size", "8",
            "--plan", "auto"]
    want = resolve_plan(parse_flags(argv))
    cache = str(tmp_path / "cache.json")
    for _ in range(2):                               # miss, then hit
        got = resolve_plan(parse_flags(argv + ["--plan_cache", cache]))
        assert {k: getattr(got, k) for k in OWNED} == {
            k: getattr(want, k) for k in OWNED}
    assert os.path.exists(cache)


def test_plan_main_auto_rejects_all_infeasible(capsys):
    rc, _, err = _plan_main(capsys, "--model", "transformer_small",
                            "--dataset", "lm", "--seq_len", "64",
                            "--batch_size", "8", "--plan", "auto",
                            "--plan_mesh", TINY_HBM)
    assert rc == 2 and "plan auto REJECTED" in err


def test_plan_main_rejects_infeasible_loudly(tmp_path, capsys):
    f = tmp_path / "p.json"
    f.write_text(json.dumps({"data": 8}))
    rc, _, err = _plan_main(capsys, "--model", "transformer_small",
                            "--dataset", "lm", "--seq_len", "64",
                            "--batch_size", "8", "--plan", str(f),
                            "--plan_mesh", TINY_HBM)
    assert rc == 2 and "REJECTED (memory-infeasible)" in err


def test_calibrate_resets_plan_owned_flags(monkeypatch):
    mesh_spec_mod = importlib.import_module("dtf_tpu_torch.plan.mesh_spec")
    from dtf_tpu_torch.plan.compile import stats_for_config
    cfg = _port_cfg(grad_accum_steps=2, remat=True)
    seen = {}

    def fake_run(run_cfg):
        seen["cfg"] = run_cfg
        return {"avg_exp_per_second": 100.0}

    monkeypatch.setattr(runner, "run", fake_run)
    monkeypatch.setattr(mesh_spec_mod, "calibrate_device_flops",
                        lambda device: 1e10)
    mesh = mesh_spec("hosts=1,devices=1")
    plan = plan_from_config(cfg, mesh.num_devices)
    assert plan.microbatch == 2 and plan.remat
    rc = plan_main._calibrate(cfg, stats_for_config(cfg), mesh, plan,
                              steps=2, tolerance=1e9, overlap_frac=0.5)
    assert rc == 0
    assert seen["cfg"].grad_accum_steps == 2 and seen["cfg"].remat is True
    assert default_registry().get("plan_measured_step_s").value == 8 / 100


def test_calibration_probe_without_a_device_runs_on_the_card(monkeypatch):
    """``calibrate_device_flops()`` probes the card, as ``--device``
    defaults to it: with no card the call raises, never returning the
    CPU's rate."""
    mesh_spec_mod = importlib.import_module("dtf_tpu_torch.plan.mesh_spec")
    params = inspect.signature(mesh_spec_mod.calibrate_device_flops)
    assert params.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_spec_mod.calibrate_device_flops()


@pytest.mark.parametrize("probe,want", [
    ("small", {}),
    ("run", dict(model="transformer_small", batch=4, seq_len=64,
                 num_classes=None, dtype=torch.bfloat16))])
def test_calibrate_probe_small_is_jaxs_and_run_the_workloads(
        monkeypatch, capsys, probe, want):
    """``--calibrate_probe small`` (the default) times the JAX package's
    probe on ``--device``; ``run`` the workload's LM at its seq length,
    compute dtype and per-replica microbatch (batch 8 over 2 accumulation
    steps: 4)."""
    mesh_spec_mod = importlib.import_module("dtf_tpu_torch.plan.mesh_spec")
    seen = []

    def probe_fn(device, **kw):
        seen.append((device, kw))
        return 1e10

    monkeypatch.setattr(mesh_spec_mod, "calibrate_device_flops", probe_fn)
    monkeypatch.setattr(runner, "run",
                        lambda cfg: {"avg_exp_per_second": 100.0})
    cfg = _port_cfg(seq_len=64, batch_size=8, dtype="bf16")
    mesh = mesh_spec("hosts=1,devices=1")
    plan = Plan(microbatch=2)
    from dtf_tpu_torch.plan.compile import stats_for_config
    rc = plan_main._calibrate(cfg, stats_for_config(cfg), mesh, plan,
                              steps=2, tolerance=1e9, overlap_frac=0.5,
                              probe=probe)
    assert rc == 0
    assert seen == [("cpu", want)]
    assert default_registry().get("plan_probe_flops").value == 1e10
    assert f"{probe} probe" in capsys.readouterr().out


def test_calibrate_probe_refuses_an_unknown_probe(capsys):
    rc, _, err = _plan_main(capsys, "--model", "transformer_small",
                            "--dataset", "lm", "--calibrate",
                            "--calibrate_probe", "big", "--device", "cpu")
    assert rc == 2 and "--calibrate_probe must be one of" in err


def test_plan_cache_calibration_feedback_loop(tmp_path):
    port_cache, jax_cache = _both("cache")
    from dtf_tpu_torch.plan.compile import stats_for_config
    from dtf_tpu_torch.plan.cost_model import DEFAULT_OVERLAP_FRAC
    stats = stats_for_config(_port_cfg())
    mesh = mesh_spec("cpu")
    path = str(tmp_path / "plan_cache.json")
    assert port_cache.load_calibration(path, stats, mesh) is None
    auto, hit = port_cache.cached_search(path, stats, mesh, 8)
    assert not hit
    assert [r.to_dict() for r in auto] == [
        r.to_dict() for r in search(stats, mesh, 8,
                                    overlap_frac=DEFAULT_OVERLAP_FRAC)]
    port_cache.store_calibration(path, stats, mesh, 0.9)
    assert port_cache.load_calibration(path, stats, mesh) == \
        pytest.approx(0.9)
    cal, hit2 = port_cache.cached_search(path, stats, mesh, 8)
    assert not hit2
    assert [r.to_dict() for r in cal] == [
        r.to_dict() for r in search(stats, mesh, 8, overlap_frac=0.9)]
    assert port_cache.cached_search(path, stats, mesh, 8)[1]
    exp, _ = port_cache.cached_search(path, stats, mesh, 8,
                                      overlap_frac=0.1)
    assert [r.to_dict() for r in exp] == [
        r.to_dict() for r in search(stats, mesh, 8, overlap_frac=0.1)]
    assert port_cache.load_calibration(path, stats,
                                       mesh_spec("4xh100x8")) is None
    port_cache.store_calibration(path, stats, mesh, 7.5)
    assert port_cache.load_calibration(path, stats, mesh) is None


def test_calibrate_on_the_cpu_records_the_contract_gauges(capsys):
    """``plan_main --calibrate`` at the JAX contract's shape on the CPU
    (world 1): the FLOP/s probe, the measured run and every gauge of the
    contract, with the memory factor in the JAX test's [1, 4].  (The
    step-time band is the card's gate: ``chip_smoke.py``.)"""
    rc, stdout, err = _plan_main(
        capsys, "--model", "transformer_small", "--dataset", "lm",
        "--use_synthetic_data", "--seq_len", "64", "--batch_size", "4",
        "--optimizer", "adamw", "--calibrate", "--calibrate_steps", "4",
        "--calibrate_tolerance", "1e9", "--top", "0", "--device", "cpu")
    assert rc == 0, err
    reg = default_registry()
    for name in ("plan_predicted_step_s", "plan_measured_step_s",
                 "plan_step_time_ratio", "plan_predicted_peak_bytes",
                 "plan_measured_live_bytes", "plan_live_bytes_ratio"):
        assert reg.get(name).value > 0, name
    assert 1.0 <= reg.get("plan_live_bytes_ratio").value <= 4.0
    assert "ratio" in stdout and "measured live" in stdout


def test_plan_main_check_launches_each_plans_ranks(capsys, one_thread_ranks):
    """``--check``: each feasible plan of the top trains one step on its
    own gloo ranks (``--devices 2``), and a plan larger than ``--devices``
    is reported as a failure, never skipped."""
    args = ["--device", "cpu", "--model", "transformer_small", "--dataset",
            "lm", "--use_synthetic_data", "--seq_len", str(SEQ),
            "--num_classes", str(VOCAB), "--batch_size", str(BATCH),
            "--plan_mesh", "hosts=1,devices=2", "--check", "--check_top",
            "2", "--top", "3"]
    rc, stdout, err = _plan_main(capsys, "--devices", "2", *args)
    assert rc == 0, stdout + err
    assert stdout.count(": OK") == 2
    rc, stdout, err = _plan_main(capsys, "--devices", "1", *args)
    assert rc == 1 and stdout.count(": OK") == 0
    assert err.count("cannot check on this box") == 2


def test_trainer_publishes_the_calibration_gauges(two_layers):
    """World 1: ``train_step_s`` is the JAX median (the upper one) of the
    windows, ``train_live_bytes`` what the rank holds."""
    reg = default_registry()
    cfg = _port_cfg(num_classes=VOCAB, seq_len=SEQ, batch_size=BATCH,
                    optimizer="adamw", train_steps=5)
    stats = runner.run(cfg)
    w = sorted(stats["window_step_s"])
    assert reg.get("train_step_s").value == w[len(w) // 2]
    assert reg.get("train_live_bytes").value == \
        stats["resident_bytes"]["total_bytes"] > 0


def test_train_live_bytes_on_cuda_count_this_run_alone(monkeypatch,
                                                      two_layers):
    """On CUDA ``train_live_bytes`` is what the allocator gained for
    this run: its count at the end of the fit less what it held before
    the Trainer (its count then, less the model it was handed) -- so an
    earlier run's leftovers in the process do not enter it."""
    from dtf_tpu_torch.train import loop
    earlier, model_bytes, held_at_end = 7_000_000, 300_000, 9_500_000
    counts = iter([earlier + model_bytes])
    monkeypatch.setattr(Trainer, "_allocated",
                        lambda self: next(counts, held_at_end))
    monkeypatch.setattr(loop, "_allocator_bytes", lambda model: model_bytes)
    cfg = _port_cfg(num_classes=VOCAB, seq_len=SEQ, batch_size=BATCH,
                    optimizer="adamw", train_steps=2)
    runner.run(cfg)
    assert default_registry().get("train_live_bytes").value == \
        held_at_end - earlier


def test_train_live_bytes_fall_across_zero_stages_at_two_ranks(
        one_thread_ranks):
    """Two gloo ranks at ZeRO stages 0-3 (plan_main's launched smoke,
    rank 0's gauges): what a rank holds falls stage by stage."""
    base = _port_cfg(num_classes=VOCAB, seq_len=SEQ, batch_size=BATCH,
                     optimizer="adamw", train_steps=2,
                     distribution_strategy="multi_worker_mirrored")
    got = {}

    def go(stage):
        got[stage] = plan_main._run_smoke(
            plan_main._smoke_config(apply_plan(base, Plan(data=2,
                                                          zero=stage)),
                                    2, ""), 2)

    threads = [threading.Thread(target=go, args=(s,), daemon=True)
               for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S + 30)
        assert not t.is_alive()
    live = [got[s]["train_live_bytes"] for s in range(4)]
    assert all(b > 0 for b in live)
    assert live == sorted(live, reverse=True) and len(set(live)) == 4
    assert all(got[s]["train_step_s"] > 0 for s in range(4))
