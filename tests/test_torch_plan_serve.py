"""The port's serving-capacity planner (``dtf_tpu_torch/plan/serve_trace``,
``plan/serve_model``, ``cli/plan_serve_main.py``) against the JAX
package's (``tests/test_plan_serve.py``), on the CPU.

Case by case as the JAX file, each case fed to both packages:

  1. the trace-replay parser: the same recorded streams (torn tails,
     records missing a trace id, router + replica views merged, a
     failover counted once, shed and deadline outcomes) reconstruct the
     same requests; and one trace the port's own engine recorded parses
     alike in both;
  2. synthetic arrivals and their rescaling, request for request;
  3. the simulator: the same predictions, field for field, under every
     lever (batching, admission, a starved pool, deadlines, prefix
     sharing, TP's Amdahl split, jitter, hedging);
  4. the what-ifs (``replicas_for``, ``rank_tp_vs_replicas``,
     ``pool_vs_shed``, ``pool_split``, ``rank_cost_per_token``) and the
     calibration arithmetic: identical answers;
  5. the CLI: the same artifacts from the same arguments; and the
     port's live calibration on its own engine (``--calibrate``, and
     ``--measure_tp_comm`` through ``serve_tp`` 2) within the JAX
     contract's 2x.
"""

import dataclasses
import importlib
import json
import math

import pytest
import torch

from dtf_tpu.cli import plan_serve_main as jax_cli
from dtf_tpu_torch.cli import plan_serve_main as port_cli
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.registry import MetricsRegistry, default_registry
from dtf_tpu_torch.plan.serve_model import (FleetConfig, ServeProfile,
                                            calibration_ratios,
                                            measured_tp_comm_frac,
                                            ratios_within, simulate)
from dtf_tpu_torch.plan.serve_trace import (Workload, measured_stats,
                                            parse_workload)

torch.set_num_threads(1)

PKGS = ("dtf_tpu_torch", "dtf_tpu")
PROFILE = dict(decode_step_s=0.010, prefill_chunk_s=0.008,
               chunk_tokens=64, page_size=16)
CONFIG = dict(replicas=1, slots=8, pool_pages=64, queue_size=64,
              admission_limit=256, deadline_s=30.0, replica_inflight=16)
JITTER = (0.8, 0.9, 1.0, 1.0, 1.1, 1.5, 2.5)


@pytest.fixture(autouse=True)
def no_trace():
    yield
    trace.disable()


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.plan.serve_trace"),
            importlib.import_module(f"{pkg}.plan.serve_model"))


def _json(obj):
    return json.dumps(obj, sort_keys=True, default=str)


def _wl_dict(w):
    return {"requests": [dataclasses.asdict(r) for r in w.requests],
            "duration_s": w.duration_s, "source": w.source,
            "skipped": w.skipped_no_trace}


# ---------------------------------------------------------------------------
# 1. trace-replay parsing
# ---------------------------------------------------------------------------

def _router_lifecycle(tid, t0, prompt=32, tokens=16, latency=0.5,
                      wait=0.02, replica=0):
    """The records serve/router.py writes for one completed request."""
    return [
        {"kind": "event", "name": "router_submit", "ts": t0,
         "rank": "router", "request": 1, "trace": tid,
         "prompt_len": prompt, "deadline_s": 120.0, "queue_depth": 1},
        {"kind": "event", "name": "router_dispatch", "ts": t0 + wait,
         "rank": "router", "request": 1, "trace": tid,
         "replica": replica, "attempt": 1, "queue_wait_s": wait},
        {"kind": "event", "name": "router_complete",
         "ts": t0 + latency, "rank": "router", "request": 1,
         "trace": tid, "replica": replica, "tokens": tokens,
         "redispatches": 0, "latency_s": latency},
    ]


def _ev(name, ts, **kw):
    return {"kind": "event", "name": name, "ts": ts, **kw}


TRACES = {
    "two_requests": {"trace_router.jsonl": (
        _router_lifecycle("aaa", 100.0, prompt=48, tokens=24, latency=0.8,
                          wait=0.05)
        + _router_lifecycle("bbb", 100.3, prompt=16, tokens=8,
                            latency=0.4, wait=0.01))},
    "torn_tail": {"trace_router.jsonl": _router_lifecycle("aaa", 10.0),
                  "tail": '{"kind": "event", "name": "router_submit", '
                          '"ts": 11.0, "trace": "bb'},
    "missing_trace_id": {"trace_router.jsonl": _router_lifecycle(
        "aaa", 10.0) + [_ev("router_submit", 11.0, rank="router",
                            request=9, prompt_len=8)]},
    "router_and_replica": {
        "trace_router.jsonl": _router_lifecycle("ccc", 50.0, wait=0.04),
        "trace_rank0.jsonl": [
            _ev("serve_submit", 50.05, rank=0, request=3, trace="ccc",
                prompt_len=32),
            _ev("serve_admit", 50.1, rank=0, request=3, trace="ccc",
                queue_wait_s=0.05, shared_tokens=16),
            _ev("serve_retire", 50.4, rank=0, request=3, trace="ccc",
                tokens=16, latency_s=0.35)]},
    "failover": {"trace_router.jsonl": [
        _ev("router_submit", 10.0, rank="router", request=5, trace="ddd",
            prompt_len=24),
        _ev("router_dispatch", 10.02, rank="router", request=5,
            trace="ddd", replica=0, attempt=1, queue_wait_s=0.02),
        _ev("router_requeue", 10.3, rank="router", request=5, trace="ddd",
            reason="conn_lost", redispatches=1, delivered=3),
        _ev("router_dispatch", 10.35, rank="router", request=5,
            trace="ddd", replica=1, attempt=2),
        _ev("router_complete", 10.9, rank="router", request=5,
            trace="ddd", replica=1, tokens=12, redispatches=1,
            latency_s=0.9)]},
    "lost_first_attempt": {"trace_router.jsonl": [
        _ev("router_submit", 10.0, rank="router", request=6, trace="xyz",
            prompt_len=24),
        _ev("router_dispatch", 10.4, rank="router", request=6,
            trace="xyz", replica=1, attempt=2, queue_wait_s=0.03),
        _ev("router_complete", 10.8, rank="router", request=6,
            trace="xyz", replica=1, tokens=8, redispatches=1,
            latency_s=0.8)]},
    "engine_only": {"trace_rank0.jsonl": [
        _ev("serve_submit", 5.0, rank=0, request=0, trace="eee",
            prompt_len=20),
        _ev("serve_admit", 5.2, rank=0, request=0, trace="eee",
            queue_wait_s=0.2),
        _ev("serve_retire", 5.6, rank=0, request=0, trace="eee",
            tokens=10, latency_s=0.6)]},
    "shed_and_deadline": {"trace_router.jsonl": (
        _router_lifecycle("fff", 20.0)
        + [{"kind": "anomaly", "name": "router_shed", "ts": 20.1,
            "rank": "router", "reason": "admission limit 128",
            "trace": "ggg", "retry_after": 0.5},
           _ev("router_submit", 20.2, rank="router", request=7,
               trace="hhh", prompt_len=8),
           {"kind": "anomaly", "name": "router_deadline", "ts": 25.2,
            "rank": "router", "request": 7, "trace": "hhh",
            "deadline_s": 5.0, "delivered": 2, "redispatches": 0}])},
    "recorded_48": {"trace_router.jsonl": sum(
        (_router_lifecycle(f"req{i:04d}", 1000.0 + i * 0.05, prompt=64,
                           tokens=24, latency=0.6, wait=0.03,
                           replica=i % 2) for i in range(48)), [])},
}


def _write(root, case: dict):
    root.mkdir(parents=True, exist_ok=True)
    for name, recs in case.items():
        if name == "tail":
            continue
        with open(root / name, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    if "tail" in case:
        with open(root / "trace_router.jsonl", "a") as f:
            f.write(case["tail"])
    return str(root)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_parse_workload_as_jax(tmp_path, name):
    path = _write(tmp_path / name, TRACES[name])
    got = {pkg: _mods(pkg)[0].parse_workload([path]) for pkg in PKGS}
    assert _wl_dict(got["dtf_tpu_torch"]) == _wl_dict(got["dtf_tpu"])
    assert _json(measured_stats(got["dtf_tpu_torch"])) == _json(
        _mods("dtf_tpu")[0].measured_stats(got["dtf_tpu"]))
    assert got["dtf_tpu_torch"].requests


def test_parse_pinned_cases(tmp_path):
    """The JAX file's pinned readings, on the port's parser."""
    w = parse_workload([_write(tmp_path / "a", TRACES["two_requests"])])
    a, b = w.requests
    assert (a.trace_id, a.prompt_tokens, a.decode_tokens) == ("aaa", 48, 24)
    assert a.arrival_s == 0.0 and b.arrival_s == pytest.approx(0.3)
    assert w.duration_s == pytest.approx(0.8)
    assert measured_stats(w)["tokens_per_s"] == pytest.approx(32 / 0.8)
    w = parse_workload([_write(tmp_path / "b", TRACES["missing_trace_id"])])
    assert len(w.requests) == 1 and w.skipped_no_trace == 1
    r, = parse_workload([_write(tmp_path / "c",
                                TRACES["router_and_replica"])]).requests
    assert r.queue_wait_s == pytest.approx(0.04) and r.prefix_tokens == 16
    r, = parse_workload([_write(tmp_path / "d", TRACES["failover"])]).requests
    assert r.redispatches == 1 and r.queue_wait_s == pytest.approx(0.02)
    w = parse_workload([_write(tmp_path / "e",
                               TRACES["shed_and_deadline"])])
    assert {r.trace_id: r.outcome for r in w.requests} == {
        "fff": "complete", "ggg": "shed", "hhh": "deadline"}
    m = measured_stats(w)
    assert m["shed"] == 1 and m["deadlined"] == 1 and m["completed"] == 1


@pytest.fixture(scope="module")
def engine_trace(tmp_path_factory):
    """One trace the port's own engine recorded: plan_serve_main's
    calibration burst on the CPU (6 requests of 8 tokens)."""
    root = tmp_path_factory.mktemp("engine_trace")
    args = port_cli._build_parser().parse_args(
        ["--device", "cpu", "--calibrate_requests", "6",
         "--calibrate_budget", "8", "--seq", "64"])
    try:
        geom = port_cli._record_calibration_run(args, str(root))
    finally:
        trace.disable()
    return str(root), geom


def test_port_recorded_trace_parses_alike(engine_trace):
    """The port engine's trace through both packages' parsers (each
    reading it with its own trace_main): the same requests, and the same
    service profile from the merged records."""
    path, geom = engine_trace
    got = {pkg: _mods(pkg)[0].parse_workload([path]) for pkg in PKGS}
    assert _wl_dict(got["dtf_tpu_torch"]) == _wl_dict(got["dtf_tpu"])
    assert len(got["dtf_tpu_torch"].requests) == 2 + 6
    assert all(r.outcome == "complete" and r.decode_tokens in (2, 8)
               for r in got["dtf_tpu_torch"].requests)
    from dtf_tpu.cli import trace_main as jtm
    from dtf_tpu_torch.cli import trace_main as ptm
    profiles = []
    for pkg, tm in (("dtf_tpu_torch", ptm), ("dtf_tpu", jtm)):
        merged = tm.merge_records(tm.discover([path]))
        profiles.append(_mods(pkg)[1].ServeProfile.from_records(
            merged, page_size=geom["page_size"],
            chunk_tokens=geom["chunk_tokens"]).to_dict())
    assert _json(profiles[0]) == _json(profiles[1])


# ---------------------------------------------------------------------------
# 2. synthetic arrivals
# ---------------------------------------------------------------------------

SYNTHETIC = [
    dict(rate_rps=20, duration_s=10, seed=7),
    dict(rate_rps=10, duration_s=16, seed=3, process="burst",
         burst_factor=4.0, burst_period_s=4.0),
    dict(rate_rps=30, duration_s=10, seed=1, shared_fraction=0.5,
         shared_groups=3, shared_prefix_tokens=64, prompt_tokens=(4, 8)),
    dict(rate_rps=50, duration_s=5, seed=9, decode_tokens=64),
]


@pytest.mark.parametrize("kw", SYNTHETIC)
def test_synthetic_and_scaled_workloads_as_jax(kw):
    got = [_mods(pkg)[0].synthetic_workload(**kw) for pkg in PKGS]
    assert _wl_dict(got[0]) == _wl_dict(got[1])
    scaled = [_mods(pkg)[0].scale_workload(w, 2 * kw["rate_rps"])
              for pkg, w in zip(PKGS, got)]
    assert _wl_dict(scaled[0]) == _wl_dict(scaled[1])
    assert scaled[0].rate_rps == pytest.approx(2 * kw["rate_rps"])


def test_synthetic_validation():
    for pkg in PKGS:
        sw = _mods(pkg)[0].synthetic_workload
        for kw in (dict(rate_rps=0, duration_s=5),
                   dict(rate_rps=1, duration_s=5, process="stampede"),
                   dict(rate_rps=1, duration_s=5, shared_fraction=1.5)):
            with pytest.raises(ValueError):
                sw(**kw)


# ---------------------------------------------------------------------------
# 3. the simulator
# ---------------------------------------------------------------------------

def _reqs(pkg, specs):
    st = _mods(pkg)[0]
    return [st.RequestRecord(trace_id=f"t{i:04d}", arrival_s=a,
                             prompt_tokens=p, decode_tokens=d, **kw)
            for i, (a, p, d, kw) in enumerate(specs)]


def _workload(pkg, specs, duration=None):
    reqs = _reqs(pkg, specs)
    dur = duration if duration is not None else (
        max(r.arrival_s for r in reqs) + 60.0)
    return _mods(pkg)[0].Workload(reqs, dur, "test")


def _synthetic(pkg, **kw):
    return _mods(pkg)[0].synthetic_workload(**kw)


SIM_CASES = {
    "lone": (lambda pkg: _workload(pkg, [(0.0, 64, 32, {})]), {}, {}),
    "full_prefix_hit": (lambda pkg: _workload(
        pkg, [(0.0, 64, 32, dict(prefix_tokens=64))]), {}, {}),
    "batch_of_8": (lambda pkg: _workload(
        pkg, [(0.0, 64, 32, {})] * 8), {}, {}),
    "admission_limit": (lambda pkg: _workload(
        pkg, [(0.0, 32, 16, {})] * 10), {}, dict(admission_limit=4)),
    "starved_pool": (lambda pkg: _workload(
        pkg, [(0.0, 32, 16, {})] * 4), {}, dict(pool_pages=3)),
    "oversized": (lambda pkg: _workload(pkg, [(0.0, 64, 32, {})]), {},
                  dict(pool_pages=2)),
    "deadline": (lambda pkg: _workload(pkg, [(0.0, 64, 32, {})]), {},
                 dict(deadline_s=0.1)),
    "prefix_sharing": (lambda pkg: _workload(
        pkg, [(0.001 * i, 144, 16, dict(prefix_group="g0",
                                        prefix_tokens=128))
              for i in range(8)]), {}, dict(pool_pages=30)),
    "eviction": (lambda pkg: _workload(
        pkg, [(0.0, 144, 16, dict(prefix_group="g0", prefix_tokens=144)),
              (5.0, 32, 160, dict(prefix_group="g0", prefix_tokens=32))]),
        {}, dict(pool_pages=12, slots=4)),
    "tp2": (lambda pkg: _synthetic(pkg, rate_rps=25, duration_s=10,
                                   seed=5), {}, dict(tp=2)),
    "poisson": (lambda pkg: _synthetic(pkg, rate_rps=25, duration_s=10,
                                       seed=5), {}, {}),
    "jitter": (lambda pkg: _synthetic(pkg, rate_rps=25, duration_s=10,
                                      seed=5), dict(jitter=JITTER), {}),
    "hedge": (lambda pkg: _synthetic(
        pkg, rate_rps=20, duration_s=20, seed=0, process="burst",
        burst_factor=4.0, prompt_tokens=(64, 256), decode_tokens=32),
        dict(jitter=JITTER), dict(replicas=2, pool_pages=128, hedge_s=0.2)),
}


@pytest.mark.parametrize("name", sorted(SIM_CASES))
def test_simulate_as_jax(name):
    build, prof, conf = SIM_CASES[name]
    preds = []
    for pkg in PKGS:
        sm = _mods(pkg)[1]
        preds.append(sm.simulate(build(pkg),
                                 sm.ServeProfile(**PROFILE, **prof),
                                 sm.FleetConfig(**{**CONFIG, **conf}))
                     .to_dict())
    assert _json(preds[0]) == _json(preds[1])


def test_simulator_pinned_arithmetic():
    """The JAX file's exact readings on the port's simulator: a lone
    request is one chunk plus (budget - 1) decode steps, a full prefix
    hit pays the whole budget, TP follows the Amdahl split."""
    prof, cfg = ServeProfile(**PROFILE), FleetConfig(**CONFIG)
    lone = simulate(_workload("dtf_tpu_torch", [(0.0, 64, 32, {})]), prof,
                    cfg)
    assert lone.latency_p50_s == pytest.approx(0.008 + 31 * 0.010,
                                               abs=1e-9)
    hit = simulate(_workload("dtf_tpu_torch",
                             [(0.0, 64, 32, dict(prefix_tokens=64))]),
                   prof, cfg)
    assert hit.latency_p50_s == pytest.approx(32 * 0.010, abs=1e-9)
    assert prof.decode_step_for(2) == pytest.approx(
        0.010 * (0.15 + 0.85 / 2))
    tp = dataclasses.replace(cfg, tp=2)
    assert tp.usable_pages == 2 * cfg.pool_pages and tp.chips == 2
    shed = simulate(_workload("dtf_tpu_torch", [(0.0, 32, 16, {})] * 10),
                    prof, dataclasses.replace(cfg, admission_limit=4))
    assert shed.shed == 6 and shed.completed == 4


def test_profile_validation_and_from_records():
    recs = ([{"kind": "span", "name": "serve_decode", "ts": 0.0,
              "dur_s": d} for d in (0.01, 0.012, 5.0, 0.011, 0.010,
                                    0.013, 0.009, 0.030)]
            + [{"kind": "span", "name": "serve_prefill_chunk", "ts": 0.0,
                "dur_s": d, "tokens": 64} for d in (0.008, 0.009, 0.009)]
            + [{"kind": "event", "name": "ledger_exec",
                "exec": "serve_decode_step", "ts": 0.0, "flops": 1.5e9,
                "bytes": 2e8}])
    got = [_mods(pkg)[1].ServeProfile.from_records(recs, page_size=8)
           .to_dict() for pkg in PKGS]
    assert _json(got[0]) == _json(got[1])
    p = ServeProfile.from_records(recs, page_size=8)
    assert p.chunk_tokens == 64 and p.decode_flops == pytest.approx(1.5e9)
    for pkg in PKGS:
        sm = _mods(pkg)[1]
        with pytest.raises(ValueError):
            sm.ServeProfile.from_records([])
        with pytest.raises(ValueError):
            sm.ServeProfile(decode_step_s=0.0, prefill_chunk_s=0.01)
        with pytest.raises(ValueError):
            sm.ServeProfile(decode_step_s=0.01, prefill_chunk_s=0.01,
                            tp_comm_frac=1.0)
        with pytest.raises(ValueError, match="jitter"):
            sm.ServeProfile(decode_step_s=0.01, prefill_chunk_s=0.01,
                            jitter=(1.0, -0.5))
        with pytest.raises(ValueError):
            sm.FleetConfig(replicas=0)
        with pytest.raises(ValueError):
            sm.FleetConfig(placement="telepathy")


# ---------------------------------------------------------------------------
# 4. the what-ifs and the calibration arithmetic
# ---------------------------------------------------------------------------

def _recorded(pkg, tmp_path):
    return _mods(pkg)[0].parse_workload(
        [_write(tmp_path / "rec", TRACES["recorded_48"])])


def _pairs(rows):
    return [(c.to_dict(), p.to_dict()) for c, p in rows]


def test_whatifs_from_recorded_trace_as_jax(tmp_path):
    out = {}
    for pkg in PKGS:
        sm = _mods(pkg)[1]
        w = _recorded(pkg, tmp_path)
        prof = sm.ServeProfile(**PROFILE)
        base = sm.FleetConfig(**{**CONFIG, "slots": 4, "pool_pages": 40})
        n, evaluated = sm.replicas_for(w, prof, base, target_rps=40.0,
                                       slo_p99_s=1.5)
        best, rows = sm.pool_vs_shed(w, prof, base, [4, 8, 16, 40])
        out[pkg] = {
            "replicas_for": (n, [(r, p.to_dict()) for r, p in evaluated]),
            "tp": _pairs(sm.rank_tp_vs_replicas(w, prof, base, chips=4)),
            "pool": (best, [(pg, p.to_dict()) for pg, p in rows])}
    assert _json(out["dtf_tpu_torch"]) == _json(out["dtf_tpu"])
    # the JAX file's pinned answers
    port = out["dtf_tpu_torch"]
    assert port["replicas_for"][0] == 2 and port["pool"][0] == 8
    assert [(c["tp"], c["replicas"]) for c, _ in port["tp"]] == [
        (4, 1), (2, 2), (1, 4)]


def test_replicas_for_can_fail_loudly_as_jax():
    out = []
    for pkg in PKGS:
        sm = _mods(pkg)[1]
        w = _synthetic(pkg, rate_rps=50, duration_s=5, seed=9,
                       decode_tokens=64)
        n, ev = sm.replicas_for(w, sm.ServeProfile(**PROFILE),
                                sm.FleetConfig(**CONFIG),
                                target_rps=5000.0, slo_p99_s=0.001,
                                max_replicas=3)
        assert n is None and len(ev) == 3
        out.append([(r, p.to_dict()) for r, p in ev])
    assert _json(out[0]) == _json(out[1])


def test_cost_per_token_ranking_as_jax():
    out = []
    for pkg in PKGS:
        sm = _mods(pkg)[1]
        w = _synthetic(pkg, rate_rps=20, duration_s=20, seed=5,
                       prompt_tokens=(16, 48), decode_tokens=24)
        base = sm.FleetConfig(**{**CONFIG, "slots": 4, "pool_pages": 40})
        rows = sm.rank_cost_per_token(w, sm.ServeProfile(**PROFILE), base,
                                      chips=4, chip_cost_per_hour=3.6,
                                      slo_p99_s=5.0)
        top = rows[0]
        assert top.meets_slo and top.usd_per_mtoken == pytest.approx(
            4 * 3.6 / 3600.0 / top.prediction.tokens_per_s * 1e6)
        with pytest.raises(ValueError, match="chip_cost_per_hour"):
            sm.rank_cost_per_token(w, sm.ServeProfile(**PROFILE), base,
                                   chips=4, chip_cost_per_hour=0.0,
                                   slo_p99_s=5.0)
        out.append([r.to_dict() for r in rows])
    assert _json(out[0]) == _json(out[1])


@pytest.mark.parametrize("wire", [(1 << 18, 20.0, 0.001),
                                  (1 << 20, 0.01, 0.05)])
def test_pool_split_as_jax(wire):
    page_bytes, gbps, latency = wire
    out = []
    for pkg in PKGS:
        sm = _mods(pkg)[1]
        w = _synthetic(pkg, rate_rps=30, duration_s=10, seed=0,
                       prompt_tokens=(64, 256), decode_tokens=32)
        best, rows = sm.pool_split(
            w, sm.ServeProfile(**PROFILE),
            sm.FleetConfig(**{**CONFIG, "pool_pages": 128}), 4,
            page_bytes=page_bytes, wire_gbps=gbps, wire_latency_s=latency)
        assert [r.prefill_replicas for r in rows] == [0, 1, 2, 3]
        assert (best is None) == (gbps < 1)
        out.append((best.to_dict() if best else None,
                    [r.to_dict() for r in rows]))
    assert _json(out[0]) == _json(out[1])


def test_pool_split_validation():
    sm = _mods("dtf_tpu_torch")[1]
    w = _workload("dtf_tpu_torch", [(0.0, 32, 16, {})])
    prof, cfg = sm.ServeProfile(**PROFILE), sm.FleetConfig(**CONFIG)
    with pytest.raises(ValueError, match="chips"):
        sm.pool_split(w, prof, cfg, 1)
    with pytest.raises(ValueError, match="multiple"):
        sm.pool_split(w, prof, dataclasses.replace(cfg, tp=2), 5)
    with pytest.raises(ValueError, match="wire_gbps"):
        sm.pool_split(w, prof, cfg, 4, wire_gbps=0.0)


@pytest.mark.parametrize("args,kw", [
    ((0.010, 0.006), {}), ((0.010, 0.005), {}), ((0.010, 0.012), {}),
    ((0.010, 0.007), dict(tp_base=2, tp_scaled=4))])
def test_measured_tp_comm_frac_as_jax(args, kw):
    got = [_mods(pkg)[1].measured_tp_comm_frac(*args, **kw)
           for pkg in PKGS]
    assert got[0] == got[1]
    assert 0.0 <= got[0] <= 0.95
    with pytest.raises(ValueError):
        measured_tp_comm_frac(0.0, 0.01)


def test_calibration_ratios_and_gauges():
    reqs = [dataclasses.replace(r, latency_s=0.35, queue_wait_s=0.01)
            for r in _reqs("dtf_tpu_torch",
                           [(0.1 * i, 64, 32, {}) for i in range(6)])]
    w = Workload(reqs, 2.0, "test")
    measured = measured_stats(w)
    pred = simulate(w, ServeProfile(**PROFILE), FleetConfig(**CONFIG))
    reg = MetricsRegistry()
    ratios = calibration_ratios(measured, pred, registry=reg)
    assert reg.get("plan_serve_tokens_ratio").value == pytest.approx(
        ratios["tokens_ratio"])
    assert ratios_within(ratios, 2.0)
    assert not ratios_within({"r": 3.0}, 2.0)
    jsm = _mods("dtf_tpu")[1]
    jreqs = _reqs("dtf_tpu", [(0.1 * i, 64, 32, {}) for i in range(6)])
    jw = _mods("dtf_tpu")[0].Workload(
        [dataclasses.replace(r, latency_s=0.35, queue_wait_s=0.01)
         for r in jreqs], 2.0, "test")
    from dtf_tpu.obs.registry import MetricsRegistry as JaxRegistry
    jratios = jsm.calibration_ratios(
        _mods("dtf_tpu")[0].measured_stats(jw),
        jsm.simulate(jw, jsm.ServeProfile(**PROFILE),
                     jsm.FleetConfig(**CONFIG)), registry=JaxRegistry())
    assert _json(ratios) == _json(jratios)
    shed = Workload([dataclasses.replace(reqs[0], outcome="shed")], 1.0,
                    "test")
    with pytest.raises(ValueError):
        calibration_ratios(measured_stats(shed), pred)


# ---------------------------------------------------------------------------
# 5. the CLI
# ---------------------------------------------------------------------------

def _both_cli(tmp_path, capsys, argv):
    """The same arguments through both CLIs: (return codes, artifacts
    without their argv, the port's stdout)."""
    rcs, arts, text = [], [], ""
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        out = tmp_path / f"{name}.json"
        rcs.append(cli.main(argv + ["--out", str(out)]))
        if name == "port":
            text = capsys.readouterr().out
        art = json.loads(out.read_text())
        art.pop("argv")
        arts.append(art)
    capsys.readouterr()
    return rcs, arts, text


def test_cli_synthetic_whatifs_as_jax(tmp_path, capsys):
    rcs, (port, jax_art), text = _both_cli(tmp_path, capsys, [
        "--rate", "30", "--duration", "10", "--decode_step_ms", "10",
        "--prefill_chunk_ms", "8", "--chunk_tokens", "64",
        "--target_rps", "40", "--slo_p99", "2.0", "--chips", "4",
        "--pool_sweep", "16,64,128", "--chip_cost_per_hour", "3.6"])
    assert rcs == [0, 0]
    assert _json(port) == _json(jax_art)
    assert port["replicas_for"]["answer"] is not None
    assert len(port["tp_vs_replicas"]["ranked"]) == 3
    assert "what-if: replicas for" in text and "what-if: $/Mtoken" in text


def test_cli_trace_mode_as_jax(tmp_path, capsys):
    path = _write(tmp_path / "rec", TRACES["recorded_48"])
    rcs, (port, jax_art), _ = _both_cli(tmp_path, capsys, [
        "--trace", path, "--decode_step_ms", "10", "--prefill_chunk_ms",
        "8", "--chunk_tokens", "64", "--chips", "2"])
    assert rcs == [0, 0]
    assert _json(port) == _json(jax_art)
    assert port["workload"]["requests"] == 48


def test_cli_pool_split_as_jax(tmp_path, capsys):
    rcs, (port, jax_art), text = _both_cli(tmp_path, capsys, [
        "--rate", "30", "--duration", "10", "--decode_step_ms", "10",
        "--prefill_chunk_ms", "12", "--chunk_tokens", "64",
        "--prompt_tokens", "64:256", "--decode_tokens", "32",
        "--pool_pages", "128", "--chips", "4", "--pool_split",
        "--migrate_page_bytes", str(1 << 18), "--migrate_wire_gbps", "20",
        "--migrate_latency_ms", "1"])
    assert rcs == [0, 0] and _json(port) == _json(jax_art)
    assert port["pool_split"]["answer"] is not None
    assert "what-if: prefill:decode split" in text


def test_cli_refusals(tmp_path, capsys):
    assert port_cli.main(["--rate", "5", "--duration", "5"]) == 2
    assert "decode_step_ms" in capsys.readouterr().err
    assert port_cli.main(["--trace", str(tmp_path)]) == 2
    with pytest.raises(SystemExit, match="chips"):
        port_cli.main(["--rate", "5", "--duration", "5",
                       "--decode_step_ms", "10", "--prefill_chunk_ms", "8",
                       "--pool_split"])
    with pytest.raises(SystemExit, match="chips"):
        port_cli.main(["--rate", "5", "--duration", "5",
                       "--decode_step_ms", "10", "--prefill_chunk_ms", "8",
                       "--chip_cost_per_hour", "2"])


def test_calibration_contract_live_engine(tmp_path, capsys):
    """The contract on the port's own engine (the CPU: the kernels' plain
    versions): record a traced run, rebuild workload and profile from
    the trace alone, replay, and land within 2x -- the gauges in the
    default registry, metric.log written."""
    bench = tmp_path / "bench"
    rc = port_cli.main(["--calibrate", "--device", "cpu",
                        "--calibrate_tolerance", "2.0",
                        "--benchmark_log_dir", str(bench)])
    text = capsys.readouterr().out
    assert rc == 0, text
    reg = default_registry()
    for name in ("plan_serve_tokens_ratio", "plan_serve_p99_ratio"):
        assert 0.5 <= reg.get(name).value <= 2.0, name
    assert (bench / "metric.log").exists()
    assert "calibration (12 measured requests" in text


def test_cli_measure_tp_comm_live(tmp_path, capsys):
    """Two live traced bursts -- tp 1, and ``serve_tp`` 2 with both
    shards on the CPU -- solve the Amdahl split; the gauge lands in the
    default registry and the what-ifs of the run use it."""
    out = tmp_path / "art.json"
    rc = port_cli.main([
        "--measure_tp_comm", "--device", "cpu", "--calibrate_requests",
        "6", "--calibrate_budget", "12", "--seq", "64",
        "--decode_step_ms", "10", "--prefill_chunk_ms", "8", "--rate",
        "10", "--duration", "5", "--out", str(out)])
    capsys.readouterr()
    assert rc == 0
    meas = json.loads(out.read_text())["tp_comm_measurement"]
    art = json.loads(out.read_text())
    assert 0.0 <= meas["tp_comm_frac"] <= 0.95
    assert meas["decode_step_s_tp1"] > 0 and meas["decode_step_s_tp2"] > 0
    assert art["profile"]["tp_comm_frac"] == meas["tp_comm_frac"]
    assert default_registry().get("plan_serve_tp_comm_frac").value == \
        meas["tp_comm_frac"]
    assert math.isfinite(meas["tp_comm_frac"])
