"""Crash-exact recovery end to end on the CPU: the contract of the JAX
package's ``tools/chaos_smoke.py`` run on the port.

Real training processes are killed under the port's launcher
(``cli/launch.py`` with ``--max_restarts 1``) -- a hard ``os._exit`` by
``--fault crash@step:4`` after the step-4 checkpoint is sealed, or a
SIGTERM by ``sigterm@step:3`` whose emergency checkpoint is the only
one -- and resumed with ``--resume``.  The resumed run is held to an
uninterrupted one of the same flags: every rank's loss at every step
equal as a float (the ``train_loss`` trace events), the final
checkpoints the same bytes, the supervisor's restart classified as
expected, and ``trace_main --check --allow injected_fault`` green (the
port's tool and the JAX tool), red without the allowance.  Cases:
``lm_main`` transformer_small in float32; ``cifar_main`` resnet20 on
CIFAR-10 files the test writes (shuffled, augmented: a repeated or
skipped batch would show at once); two gloo ranks with
``crash@rank1:step:4`` (the whole group restarts) and with one rank
latching SIGTERM; and the two-rank crash under each data-parallel
strategy.  Every spawned rank runs one thread.
"""

import contextlib
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from dtf_tpu.cli.trace_main import main as jax_trace_main
from dtf_tpu_torch.cli import launch
from dtf_tpu_torch.cli.trace_main import main as trace_main
from dtf_tpu_torch.data import cifar
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.train.checkpoint import (PAYLOAD, Checkpointer,
                                            read_manifest)
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV

torch.set_num_threads(1)

# every gloo group this file's ranks start gives up on a dead peer within
# 120 s (runtime/mesh.py TIMEOUT_ENV), well inside the suite's limit
os.environ.setdefault(TIMEOUT_ENV, "120")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(log_dir):
    with open(os.path.join(log_dir, "supervisor_events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _loss_by_step(trace_dir):
    """{(rank, step): {losses}} over every rank's and attempt's trace."""
    out = {}
    for path in glob.glob(os.path.join(trace_dir, "trace_rank*.jsonl")):
        for rec in trace.read_records(path):
            if rec.get("kind") == "event" and rec.get("name") == "train_loss":
                out.setdefault((rec["rank"], rec["step"]), set()).add(
                    rec["loss"])
    return out


STEPS = 8


def _lm_cmd(model_dir, trace_dir, extra=()):
    return [sys.executable, "-m", "dtf_tpu_torch.cli.lm_main",
            "--use_synthetic_data", "--device", "cpu",
            "--model", "transformer_small", "--seq_len", "32",
            "--num_classes", "256", "--batch_size", "4",
            "--train_steps", str(STEPS), "--log_steps", "1",
            "--dtype", "fp32", "--step_time_guard_factor", "0",
            "--model_dir", model_dir, "--trace_dir", trace_dir, *extra]


def _cifar_cmd(data_dir, model_dir, trace_dir, extra=()):
    return [sys.executable, "-m", "dtf_tpu_torch.cli.cifar_main",
            "--data_dir", data_dir, "--device", "cpu", "--model",
            "resnet20", "--batch_size", "8", "--train_steps", str(STEPS),
            "--log_steps", "1", "--skip_eval", "--seed", "3",
            "--distribution_strategy", "off",
            "--step_time_guard_factor", "0",
            "--model_dir", model_dir, "--trace_dir", trace_dir, *extra]


def _supervised(base, name, cmd, world=1, **kw):
    """``cmd`` under the port's launcher (a file rendezvous of its
    own); returns (rc, log dir)."""
    logs = os.path.join(base, f"{name}_logs")
    kw.setdefault("restart_backoff_s", 0.05)
    rc = launch.launch_local(cmd, world,
                             f"file://{os.path.join(base, name)}.rdv", logs,
                             timeout_s=240, teardown_grace=10, **kw)
    return rc, logs


def _final_sha(model_dir):
    ckpt = Checkpointer(model_dir)
    step = ckpt.latest_step()
    assert ckpt.verify(step) == "ok"
    return step, read_manifest(ckpt.directory, step)["files"][PAYLOAD][
        "sha256"]


def _run_pair(base, name, make_cmd, fault, world=1, **kw):
    """The uninterrupted run and the faulted, supervised one."""
    runs = {}
    for key, extra, sup in (
            ("base", [], {}),
            ("fault", ["--resume", "--fault", fault],
             dict(max_restarts=1, **kw))):
        m = os.path.join(base, f"{name}_{key}_m")
        t = os.path.join(base, f"{name}_{key}_t")
        rc, logs = _supervised(base, f"{name}_{key}", make_cmd(m, t, extra),
                               world=world, **sup)
        runs[key] = {"rc": rc, "logs": logs, "trace": t, "model": m,
                     "losses": _loss_by_step(t)}
    return runs


@contextlib.contextmanager
def _one_thread_ranks():
    """Spawned ranks take one thread each (OMP_NUM_THREADS) and import
    the package from this checkout, wherever pytest runs from."""
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "PYTHONPATH")}
    os.environ.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_chaos"))
    data = os.path.join(base, "data")
    d = os.path.join(data, "cifar-10-batches-bin")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        cifar.write_binary_file(os.path.join(d, name),
                                rng.integers(0, 256, (16, 32, 32, 3)),
                                rng.integers(0, 10, 16))
    lm_cmd = lambda m, t, extra: _lm_cmd(
        m, t, ["--checkpoint_steps", "2", *extra])
    dp_cmd = lambda m, t, extra: _lm_cmd(
        m, t, ["--checkpoint_steps", "2", "--distribution_strategy",
               "multi_worker_mirrored", *extra])
    cifar_cmd = lambda m, t, extra: _cifar_cmd(
        data, m, t, ["--checkpoint_steps", "2", *extra])
    with _one_thread_ranks():
        yield {
            "lm": _run_pair(base, "lm", lm_cmd, "crash@step:4"),
            "cifar": _run_pair(base, "cifar", cifar_cmd, "crash@step:4"),
            # sigterm with no interval checkpoints: only the emergency
            # save makes the resume possible
            "sigterm": _run_pair(base, "sigterm",
                                 lambda m, t, extra: _cifar_cmd(
                                     data, m, t, extra), "sigterm@step:3"),
            "dp": _run_pair(base, "dp", dp_cmd, "crash@rank1:step:4",
                            world=2),
            # one rank latches SIGTERM at step 3; its latch rides step
            # 4's all-reduce and both ranks stop at step 5's boundary
            "dp_sigterm": _run_pair(base, "dp_sigterm", dp_cmd,
                                    "sigterm@rank0:step:3", world=2),
        }


E2E = ["lm", "cifar", "sigterm", "dp", "dp_sigterm"]


@pytest.mark.parametrize("case", E2E)
def test_e2e_resumed_trajectory_is_bit_identical(e2e, case):
    """Killed (a hard os._exit after the step-4 checkpoint, or a SIGTERM
    at step 3), restarted by the supervisor, resumed: every rank's loss
    at every step equals the uninterrupted run's as a float, and the
    final checkpoints are the same bytes."""
    runs = e2e[case]
    assert runs["base"]["rc"] == 0 and runs["fault"]["rc"] == 0
    base, got = runs["base"]["losses"], runs["fault"]["losses"]
    ranks = 2 if case.startswith("dp") else 1
    assert set(base) == {(r, s) for r in range(ranks)
                         for s in range(1, STEPS + 1)}
    assert all(len(v) == 1 for v in base.values())
    assert got == base
    if ranks == 2:
        assert all(base[(0, s)] == base[(1, s)]
                   for s in range(1, STEPS + 1))
    assert _final_sha(runs["fault"]["model"]) == _final_sha(
        runs["base"]["model"])


@pytest.mark.parametrize("case,code,cls,resumed", [
    ("lm", 77, "crash", 4), ("cifar", 77, "crash", 4),
    ("sigterm", 75, "preempted", 3), ("dp", 77, "crash", 4),
    ("dp_sigterm", 75, "preempted", 5)])
def test_e2e_supervisor_events_and_resume_point(e2e, case, code, cls,
                                                resumed):
    ev = _events(e2e[case]["fault"]["logs"])
    exits = [e for e in ev if e["event"] == "rank_exit"]
    assert exits[0]["code"] == code and exits[0]["classification"] == cls
    restarts = [e for e in ev if e["event"] == "restart"]
    assert [e["classification"] for e in restarts] == [cls]
    # a preemption leaves the crash budget untouched, a crash spends it
    assert restarts[0]["crashes_in_window"] == (cls == "crash")
    assert ev[-1]["event"] == "job_done"
    # the restarted attempt started at the checkpointed step
    with open(os.path.join(e2e[case]["fault"]["logs"],
                           "log0.retry1.log")) as f:
        assert f"resuming at step {resumed} " in f.read()


@pytest.mark.parametrize("case", E2E)
def test_e2e_trace_check_allows_only_the_injected_fault(e2e, case):
    """``trace_main --check --allow injected_fault`` is green on the
    faulted run's traces (the port's tool and the JAX tool alike), red
    without the allowance; the uninterrupted run is clean."""
    t = e2e[case]["fault"]["trace"]
    for tool in (trace_main, jax_trace_main):
        assert tool([t, "--check", "--allow", "injected_fault"]) == 0
        assert tool([t, "--check"]) == 1
    assert trace_main([e2e[case]["base"]["trace"], "--check"]) == 0


@pytest.fixture(scope="module", params=["mirrored", "horovod",
                                        "parameter_server"])
def strategy_runs(request, tmp_path_factory):
    base = str(tmp_path_factory.mktemp(f"torch_chaos_{request.param}"))
    cmd = lambda m, t, extra: _lm_cmd(
        m, t, ["--checkpoint_steps", "2", "--distribution_strategy",
               request.param, *extra])
    with _one_thread_ranks():
        yield _run_pair(base, request.param, cmd, "crash@rank1:step:4",
                        world=2)


def test_two_rank_resume_under_each_strategy(strategy_runs):
    """The other data-parallel strategies (horovod and parameter_server
    with their per-replica batch) resume the same way: the group
    restarts and continues bit for bit."""
    base, got = strategy_runs["base"], strategy_runs["fault"]
    assert base["rc"] == got["rc"] == 0
    assert len(base["losses"]) == 2 * STEPS
    assert got["losses"] == base["losses"]
    assert _final_sha(got["model"]) == _final_sha(base["model"])
    restarts = [e["classification"] for e in _events(got["logs"])
                if e["event"] == "restart"]
    assert restarts == ["crash"]
