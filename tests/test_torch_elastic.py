"""The port's elastic training (dtf_tpu_torch: ``train/elastic.py``, the
``cli/launch.py`` ``--elastic`` supervisor, the ``device_loss`` chaos
kind, the Trainer's device-loss guard and reshard check, the runner's
exit 76 and ``elastic_resume``) against the JAX package's, on the CPU.
Mirrors ``tests/test_elastic.py`` case by case.

The supervisor cases run scripted ranks (``python -c``, no torch in the
children).  The training cases run gloo ranks on the CPU started with
the launcher's environment (``cli/launch.py build_env``), each job in a
process group of its own, as ``tests/test_torch_zero.py`` starts them.

One process a device: where the JAX supervisor halves
``--devices_per_process`` on a device loss, the port drops one rank,
and it exports ``DTF_ELASTIC_DEVICES`` (the surviving rank count) on
every elastic attempt.

End to end: ``lm_main`` transformer_small under ZeRO-3 on 2 gloo ranks
through ``launch_local(elastic=True)``, a host lost at step 2, the job
resumed on 1 rank and grown back to 2 once capacity is re-announced; the
shrunken window bit for bit with a fresh 1-rank oracle resumed from a
prep run's checkpoint, and the 2-rank prefix with the prep run.  Held to
the JAX package: the same topology schedule (2 devices, the canonical
state, staged at 1 device, on) through the JAX ZeRO Trainer from the
same weights, per-step losses within 1e-5 in float32.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dtf_tpu import chaos as jax_chaos
from dtf_tpu.cli import launch as jax_launch
from dtf_tpu.config import Config as JaxConfig
from dtf_tpu.models import build_model as jax_build_model
from dtf_tpu.runtime.mesh import MeshRuntime as JaxMeshRuntime
from dtf_tpu.runtime.mesh import make_mesh
from dtf_tpu.train import Trainer as JaxTrainer
from dtf_tpu.train import elastic as jax_elastic
from dtf_tpu_torch import chaos
from dtf_tpu_torch.cli import launch
from dtf_tpu_torch.cli.launch import build_env
from dtf_tpu_torch.cli.trace_main import main as trace_main
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.models import partition, registry
from dtf_tpu_torch.models.partition import Split
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.runtime.mesh import MeshRuntime
from dtf_tpu_torch.train import elastic
from dtf_tpu_torch.train.loop import device_loss_guard
from test_torch_dp import CASES, _batches, _initial, _jax_spec, _np
from dtf_tpu_torch.runtime.mesh import TIMEOUT_ENV

torch.set_num_threads(1)

# every gloo group this file's ranks start gives up on a dead peer within
# 120 s (runtime/mesh.py TIMEOUT_ENV), well inside the suite's limit
os.environ.setdefault(TIMEOUT_ENV, "120")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _events(log_dir):
    with open(os.path.join(log_dir, "supervisor_events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _named(events, name):
    return [e for e in events if e["event"] == name]


def _launch(cmd, world, tmp_path, name="logs", **kw):
    """``cmd`` as ``world`` ranks under launch_local (a file rendezvous
    of its own); returns (rc, log dir)."""
    logs = str(tmp_path / name)
    kw.setdefault("timeout_s", 120)
    rc = launch.launch_local(cmd, world, f"file://{tmp_path / name}.rdv",
                             logs, **kw)
    return rc, logs


# ---------------------------------------------------------------------------
# contracts: the standard-library copies match train/elastic.py's, and
# the JAX package's
# ---------------------------------------------------------------------------

def test_contract_parity():
    assert (elastic.EXIT_DEVICE_LOST == chaos.EXIT_DEVICE_LOST
            == launch.EXIT_DEVICE_LOST == jax_elastic.EXIT_DEVICE_LOST
            == jax_chaos.EXIT_DEVICE_LOST == 76)
    assert (elastic.REJOIN_FILE == launch.REJOIN_FILE
            == jax_elastic.REJOIN_FILE == jax_launch.REJOIN_FILE)
    assert (elastic.DEVICES_ENV == launch.ELASTIC_DEVICES_ENV
            == jax_elastic.DEVICES_ENV == jax_launch.ELASTIC_DEVICES_ENV)


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------

XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})
# torch's CUDA error type, faked by name as another torch would present it
AcceleratorError = type("AcceleratorError", (RuntimeError,), {})


def _cuda_error(cls, text):
    """The exception torch raises for a CUDA status, its message as
    c10's CUDA check words it."""
    return cls(f"CUDA error: {text}\nCUDA kernel errors might be "
               f"asynchronously reported at some other API call, so the "
               f"stacktrace below might be incorrect.\nFor debugging "
               f"consider passing CUDA_LAUNCH_BLOCKING=1\n")


@pytest.mark.parametrize("exc", [
    XlaRuntimeError("INTERNAL: DEVICE_LOST: TPU driver reset detected"),
    XlaRuntimeError("DATA_LOSS: core halted unexpectedly"),
    XlaRuntimeError("INVALID_ARGUMENT: shapes do not match"),
    ValueError("DEVICE_LOST"),
    RuntimeError("[gloo] Connection closed by peer"),
], ids=["device_lost", "data_loss", "shape_bug", "wrong_family",
        "closed_peer"])
def test_device_loss_classifier_is_the_jax_packages(exc):
    """The XLA cases classify as the JAX package classifies them: the
    runtime's device-loss vocabulary in a runtime-error family; a shape
    bug, the right text in a ValueError and a survivor's closed peer do
    not."""
    assert elastic.is_device_loss(exc) == jax_elastic.is_device_loss(exc)


def test_device_lost_wraps_its_cause():
    lost = XlaRuntimeError("INTERNAL: DEVICE_LOST: TPU driver reset")
    assert elastic.is_device_loss(lost)
    wrapped = elastic.DeviceLost(17, lost)
    assert wrapped.step == 17 and wrapped.cause is lost
    assert "DEVICE_LOST" in str(wrapped)
    assert isinstance(wrapped, RuntimeError)
    assert str(wrapped) == str(jax_elastic.DeviceLost(17, lost))


# the CUDA runtime's device-loss statuses, as cudaGetErrorString words
# them, and kernel bugs, which must stay crashes
CUDA_LOST = {
    "cudaErrorNoDevice": "no CUDA-capable device is detected",
    "cudaErrorDevicesUnavailable":
        "CUDA-capable device(s) is/are busy or unavailable",
    "cudaErrorECCUncorrectable": "uncorrectable ECC error encountered",
}
CUDA_BUGS = {
    "cudaErrorIllegalAddress": "an illegal memory access was encountered",
    "cudaErrorLaunchFailure": "unspecified launch failure",
}


@pytest.mark.parametrize("cls", [AcceleratorError, torch.AcceleratorError,
                                 RuntimeError],
                         ids=["by_name", "torch", "runtime_error"])
@pytest.mark.parametrize("status", sorted(CUDA_LOST) + sorted(CUDA_BUGS))
def test_cuda_device_loss_texts(status, cls):
    exc = _cuda_error(cls, {**CUDA_LOST, **CUDA_BUGS}[status])
    assert elastic.is_device_loss(exc) == (status in CUDA_LOST)


def test_out_of_memory_is_not_device_loss():
    """A real ``torch.OutOfMemoryError`` (a RuntimeError subclass) stays
    a crash."""
    with pytest.raises(torch.OutOfMemoryError) as info:
        raise torch.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 80.00 GiB. GPU 0 has a "
            "total capacity of 79.19 GiB")
    assert not elastic.is_device_loss(info.value)
    assert not elastic.is_device_loss(_cuda_error(
        torch.AcceleratorError, "out of memory"))


def test_guard_converts_device_loss_and_passes_the_rest(tmp_path):
    """The train loop's guard: a recognised loss becomes a
    ``device_lost`` anomaly and DeviceLost; anything else passes
    through untouched."""
    trace.configure(str(tmp_path), rank=0)
    try:
        lost = _cuda_error(torch.AcceleratorError, CUDA_LOST[
            "cudaErrorNoDevice"])
        with pytest.raises(elastic.DeviceLost) as info:
            with device_loss_guard(5):
                raise lost
        assert info.value.step == 5 and info.value.cause is lost
        bug = _cuda_error(torch.AcceleratorError, CUDA_BUGS[
            "cudaErrorIllegalAddress"])
        with pytest.raises(torch.AcceleratorError) as info:
            with device_loss_guard(6):
                raise bug
        assert info.value is bug
        trace.flush()
    finally:
        trace.disable()
    recs = trace.read_records(str(tmp_path / "trace_rank0.jsonl"))
    lost_recs = [r for r in recs if r.get("name") == "device_lost"]
    assert [r["step"] for r in lost_recs] == [5]


# ---------------------------------------------------------------------------
# the chaos kinds
# ---------------------------------------------------------------------------

def test_chaos_grammar_device_and_host_loss():
    text = "device_loss@step:3,host_loss@rank1:step:5"
    specs = chaos.parse_spec(text)
    assert [str(s) for s in specs] == [str(s) for s in
                                      jax_chaos.parse_spec(text)] == [
        "device_loss@step:3", "host_loss@rank1:step:5"]
    assert specs[1].rank == 1
    for bad, kind in (("device_loss@latest", "device_loss"),
                      ("host_loss@req:3", "host_loss")):
        with pytest.raises(ValueError, match=kind):
            chaos.parse_spec(bad)
        with pytest.raises(ValueError, match=kind):
            jax_chaos.parse_spec(bad)
    assert chaos.NOT_PORTED == {}


def test_device_loss_fires_exit_76_in_a_child(tmp_path):
    """``device_loss@step:N`` exits EXIT_DEVICE_LOST at its step, its
    injected_fault record flushed first; no earlier step fires it."""
    script = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from dtf_tpu_torch import chaos\n"
        "from dtf_tpu_torch.obs import trace\n"
        f"trace.configure({str(tmp_path)!r}, rank=0)\n"
        "chaos.configure('device_loss@step:3', rank=0)\n"
        "chaos.step(2)\n"
        "chaos.step(3)\n"
        "print('survived')\n")
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 76 and "survived" not in proc.stdout
    recs = trace.read_records(str(tmp_path / "trace_rank0.jsonl"))
    fired = [r for r in recs if r.get("name") == "injected_fault"]
    assert len(fired) == 1 and fired[0]["fault_kind"] == "device_loss"
    assert fired[0]["step"] == 3


# ---------------------------------------------------------------------------
# the supervisor's classification matrix (scripted ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script,want", [
    ("import sys; sys.exit(3)", "crash"),
    (f"import sys; sys.exit({launch.EXIT_PREEMPTED})", "preempted"),
    (f"import sys; sys.exit({launch.EXIT_DEVICE_LOST})", "device_loss"),
    ("import os, signal; os.kill(os.getpid(), signal.SIGKILL)",
     "host_loss"),
])
def test_classification_matrix(tmp_path, script, want):
    """Crash, preempted (75), device loss (76) and host loss (an
    unprompted SIGKILL, which no Python crash produces by itself)."""
    _launch([sys.executable, "-c", script], 1, tmp_path)
    exits = _named(_events(str(tmp_path / "logs")), "rank_exit")
    assert exits and exits[0]["classification"] == want


# ---------------------------------------------------------------------------
# the elastic policy: shrink, floor, cap, grow (scripted ranks)
# ---------------------------------------------------------------------------

def test_elastic_shrink_drops_a_rank_and_exports_the_survivors(tmp_path):
    """A device loss under --elastic: the job resumes one rank smaller,
    DTF_ELASTIC_DEVICES the surviving count ("2", then "1"), outside the
    crash budget (max_restarts 0, and the job completes)."""
    seen = tmp_path / "seen"
    script = (
        "import os, sys, time\n"
        "n = os.environ['DTF_ELASTIC_DEVICES']\n"
        f"open({str(seen)!r} + os.environ['DTF_PROCESS_ID'] + '_' + "
        f"os.environ['DTF_PROCESS_COUNT'], 'w').write(n)\n"
        "if n == '1':\n"
        "    sys.exit(0)\n"
        "if os.environ['DTF_PROCESS_ID'] == '1':\n"
        # rank 0 has started (its marker written) before the loss: the
        # launcher's teardown cannot reach it first
        "    t0 = time.monotonic()\n"
        f"    while not os.path.exists({str(seen)!r} + '0_2') and \\\n"
        "            time.monotonic() - t0 < 30:\n"
        "        time.sleep(0.01)\n"
        f"    sys.exit({launch.EXIT_DEVICE_LOST})\n"
        "time.sleep(60)\n")
    rc, logs = _launch([sys.executable, "-c", script], 2, tmp_path,
                       elastic=True, teardown_grace=5.0)
    assert rc == 0
    assert (tmp_path / "seen0_2").read_text() == "2"
    assert (tmp_path / "seen1_2").read_text() == "2"
    assert (tmp_path / "seen0_1").read_text() == "1"
    ev = _events(logs)
    (shrink,) = _named(ev, "elastic_shrink")
    assert shrink["classification"] == "device_loss"
    assert shrink["total_devices"] == shrink["procs"] == 1
    assert not _named(ev, "restart") and _named(ev, "job_done")


def test_ranks_start_through_the_given_spawn(tmp_path):
    """``spawn`` starts every rank of every attempt, with the rank's
    environment and its log; the default starts a child process."""
    calls = []

    def spawn(cmd, env, log_path):
        calls.append((env["DTF_PROCESS_ID"], env["DTF_PROCESS_COUNT"],
                      env.get(launch.ELASTIC_DEVICES_ENV),
                      os.path.basename(log_path)))
        return launch.popen_rank(cmd, env, log_path)

    script = ("import os, sys\n"
              "print('rank', os.environ['DTF_PROCESS_ID'])\n"
              "sys.exit(76 if os.environ['DTF_PROCESS_ID'] == '1' else 0)\n")
    rc, logs = _launch([sys.executable, "-c", script], 2, tmp_path,
                       elastic=True, spawn=spawn)
    assert rc == 0
    assert calls == [("0", "2", "2", "log0.log"), ("1", "2", "2", "log1.log"),
                     ("0", "1", "1", "log0.retry1.log")]
    with open(os.path.join(logs, "log1.log")) as f:
        assert f.read() == "rank 1\n"


def test_elastic_host_loss_drops_one_rank(tmp_path):
    """A host loss in a 3-rank job: the lost host's rank goes (3 -> 2),
    not half the world."""
    script = (
        "import os, signal, sys, time\n"
        "if os.environ['DTF_PROCESS_COUNT'] == '2':\n"
        "    sys.exit(0)\n"
        "if os.environ['DTF_PROCESS_ID'] == '1':\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "time.sleep(60)\n")
    rc, logs = _launch([sys.executable, "-c", script], 3, tmp_path,
                       elastic=True, teardown_grace=5.0)
    assert rc == 0
    (shrink,) = _named(_events(logs), "elastic_shrink")
    assert shrink["procs"] == 2
    assert shrink["classification"] == "host_loss"


def test_shrink_below_min_devices_refuses_loudly(tmp_path):
    """The --min_devices floor: a loss that would leave fewer gives up
    with a structured reason instead of resuming that small."""
    rc, logs = _launch(
        [sys.executable, "-c",
         f"import sys; sys.exit({launch.EXIT_DEVICE_LOST})"], 2, tmp_path,
        elastic=True, min_devices=2)
    assert rc == launch.EXIT_DEVICE_LOST
    (give_up,) = _named(_events(logs), "give_up")
    assert give_up["reason"] == "min_devices"
    assert give_up["surviving_devices"] == 1


def test_max_elastic_caps_flapping_topology(tmp_path):
    """A flapping fabric (a loss every attempt) is bounded by
    --max_elastic, not by the crash budget: 4 -> 3 -> 2, then the third
    loss gives up."""
    rc, logs = _launch(
        [sys.executable, "-c",
         f"import sys; sys.exit({launch.EXIT_DEVICE_LOST})"], 4, tmp_path,
        elastic=True, min_devices=1, max_elastic=2)
    assert rc == launch.EXIT_DEVICE_LOST
    ev = _events(logs)
    assert [e["procs"] for e in _named(ev, "elastic_shrink")] == [3, 2]
    (give_up,) = _named(ev, "give_up")
    assert give_up["losses"] == 3


def test_elastic_at_one_rank_is_refused(tmp_path):
    """One process a device: a one-rank job has nothing to shrink."""
    with pytest.raises(ValueError, match="elastic"):
        launch.launch_local(["true"], 1, "localhost:0", str(tmp_path),
                            elastic=True, timeout_s=60)
    with pytest.raises(ValueError, match="elastic"):
        launch.main(["--elastic", "--log_dir", str(tmp_path), "--",
                     "true"])


def test_grow_back_on_reannounce(tmp_path):
    """A re-announced capacity while shrunken drains the job (SIGTERM:
    the ranks' preemption path) and relaunches it at full size; the
    announce is consumed, and an announce left by an earlier job is
    unlinked at the start rather than read as this job's."""
    phase, shrunk = tmp_path / "phase", tmp_path / "shrunk"
    log_dir = tmp_path / "logs"
    os.makedirs(log_dir)
    elastic.announce_rejoin(str(log_dir), 2)          # stale
    script = (
        "import os, signal, sys, time\n"
        f"phase, shrunk = {str(phase)!r}, {str(shrunk)!r}\n"
        "if os.environ['DTF_ELASTIC_DEVICES'] == '2':\n"
        "    if os.path.exists(phase):\n"
        "        sys.exit(0)\n"
        "    if os.environ['DTF_PROCESS_ID'] == '1':\n"
        "        open(phase, 'w').write('x')\n"
        f"        sys.exit({launch.EXIT_DEVICE_LOST})\n"
        "    time.sleep(60)\n"
        "signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))\n"
        "open(shrunk, 'w').write('x')\n"
        "for _ in range(1200):\n"
        "    time.sleep(0.05)\n"
        "sys.exit(1)\n")
    announced = []

    def announcer():
        deadline = time.monotonic() + 60
        while not shrunk.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)   # a stale announce would have grown it by now
        announced.append(time.time())
        elastic.announce_rejoin(str(log_dir), 2)

    th = threading.Thread(target=announcer, daemon=True)
    th.start()
    rc = launch.launch_local([sys.executable, "-c", script], 2,
                             f"file://{tmp_path / 'rdv'}", str(log_dir),
                             elastic=True, teardown_grace=5.0,
                             timeout_s=120)
    th.join(timeout=10)
    assert rc == 0 and not th.is_alive()
    ev = _events(str(log_dir))
    names = [e["event"] for e in ev]
    for expected in ("elastic_shrink", "grow_triggered", "elastic_grow",
                     "job_done"):
        assert expected in names, names
    (grow,) = _named(ev, "grow_triggered")
    assert grow["ts"] >= announced[0]
    (grown,) = _named(ev, "elastic_grow")
    assert grown["procs"] == 2 and grown["drain_classification"] == \
        "preempted"
    assert not (log_dir / launch.REJOIN_FILE).exists()


@pytest.mark.parametrize("text", ['{"devices": ', '[2]', '{"devices": "x"}',
                                  ""], ids=["torn", "list", "word", "empty"])
def test_malformed_announce_reads_as_not_yet(tmp_path, text):
    (tmp_path / launch.REJOIN_FILE).write_text(text)
    assert launch.read_rejoin(str(tmp_path)) is None
    assert launch.read_rejoin(str(tmp_path / "absent")) is None
    elastic.announce_rejoin(str(tmp_path), 3)
    assert launch.read_rejoin(str(tmp_path)) == jax_launch.read_rejoin(
        str(tmp_path)) == 3


def test_survivor_crash_does_not_hide_the_loss(tmp_path):
    """Rank 1 SIGKILLs itself (a lost host); rank 0 -- a survivor whose
    collective fails on the closed peer -- exits 1 as soon as rank 1 is
    dead, so both exits usually land in one poll of the supervisor.
    The loss must win: the job shrinks (max_restarts 0, so a crash
    would end it)."""
    pid_file = tmp_path / "pid1"
    script = (
        "import os, signal, sys, time\n"
        "if os.environ['DTF_PROCESS_COUNT'] == '1':\n"
        "    sys.exit(0)\n"
        f"pid_file = {str(pid_file)!r}\n"
        "if os.environ['DTF_PROCESS_ID'] == '1':\n"
        "    open(pid_file + '.tmp', 'w').write(str(os.getpid()))\n"
        "    os.replace(pid_file + '.tmp', pid_file)\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "deadline = time.monotonic() + 30\n"
        "while not os.path.exists(pid_file) and time.monotonic() < deadline:\n"
        "    time.sleep(0.001)\n"
        "pid = open(pid_file).read()\n"
        "def gone():\n"
        "    try:\n"
        "        with open('/proc/%s/stat' % pid) as f:\n"
        "            return f.read().rsplit(')', 1)[1].split()[0] in 'ZX'\n"
        "    except OSError:\n"
        "        return True\n"
        "while not gone() and time.monotonic() < deadline:\n"
        "    time.sleep(0.0005)\n"
        "sys.exit(1)\n")
    rc, logs = _launch([sys.executable, "-c", script], 2, tmp_path,
                       elastic=True, teardown_grace=5.0)
    ev = _events(logs)
    assert rc == 0, ev
    (shrink,) = _named(ev, "elastic_shrink")
    assert shrink["classification"] == "host_loss" and shrink["procs"] == 1


# ---------------------------------------------------------------------------
# the reshard check, the planner, the resume note
# ---------------------------------------------------------------------------

def _small_description():
    """transformer_small's partition rule and full shapes, the port's
    parameter names."""
    model, _ = registry.build_model("transformer_small", num_classes=256)
    names = [n for n, _ in model.named_parameters()]
    return ({n: partition.rule(n) for n in names},
            {n: tuple(p.shape) for n, p in model.named_parameters()})


def test_check_reshardable_on_the_partition_rule():
    """Replicated and ZeRO-flat leaves reshard onto any data-parallel
    degree; a tensor-parallel dimension the model axis does not divide
    is a violation naming the leaf (qkv per head group, fc1 on d_ff,
    out and fc2 on their input)."""
    splits, shapes = _small_description()
    for dp in (1, 2, 3, 5, 7):
        for mp in (1, 2, 4):
            assert elastic.check_reshardable(
                splits, shapes, {"data": dp, "model": mp}) == []
    bad = elastic.check_reshardable(splits, shapes, {"data": 1, "model": 3})
    named = {b.split(":")[0] for b in bad}
    assert named == {n for n, s in splits.items() if s is not None}
    assert any(n.endswith("qkv.weight") for n in named)
    # the rule reads dimensions only: d 256 and d_ff 1024 divide by 8
    assert elastic.check_reshardable(splits, shapes,
                                     {"data": 1, "model": 8}) == []
    # the grouped dimension: three groups of 8 rows, a model axis of 3
    (msg,) = elastic.check_reshardable({"w": Split(0, 3)}, {"w": (24, 4)},
                                       {"data": 1, "model": 3})
    assert msg.startswith("w:") and "size 3" in msg


def test_check_reshardable_agrees_with_the_jax_rule():
    """A Split on dim d is the JAX spec with 'model' at d: the same
    leaves violate at the same worlds."""
    sds = jax.ShapeDtypeStruct
    shapes = {"tp": (8, 6), "rep": (7,), "col": (12, 4)}
    port = {"tp": Split(1), "rep": None, "col": Split(0)}
    jspecs = {"tp": P(None, "model"), "rep": P(), "col": P("model")}
    jleaves = {k: sds(v, np.float32) for k, v in shapes.items()}
    for dp, mp in ((2, 2), (3, 3), (1, 4), (1, 5), (8, 6)):
        world = {"data": dp, "seq": 1, "model": mp}
        got = {m.split(":")[0] for m in elastic.check_reshardable(
            port, shapes, world)}
        want = {m.split("']")[0].split("['")[1] for m in
                jax_elastic.check_reshardable(jspecs, jleaves, world)}
        assert got == want, (dp, mp)


def test_replan_for_surviving_is_refused_naming_the_planner():
    """The planner is ported (``tests/test_torch_plan.py`` holds the
    re-resolution to the JAX package's): what it cannot plan is refused
    with its message, as the JAX planner refuses it -- MoE."""
    cfg = Config(model="moe_transformer_small", dataset="lm", seq_len=64,
                 batch_size=8, use_synthetic_data=True, plan="auto",
                 device="cpu", distribution_strategy="multi_worker_mirrored",
                 process_count=4)
    with pytest.raises(ValueError, match="the planner does not model "
                                         "routed-expert"):
        elastic.replan_for_surviving(cfg, 2)


def test_note_elastic_resume(monkeypatch, tmp_path):
    """A world other than the supervisor's count is refused; a matching
    one stamps ``elastic_resume`` (step, devices, replicas) into the
    trace; outside elastic supervision it is a no-op."""
    rt = MeshRuntime(strategy="multi_worker_mirrored", num_replicas=1,
                     model_parallelism=2)
    monkeypatch.delenv(elastic.DEVICES_ENV, raising=False)
    elastic.note_elastic_resume(rt, 4)                 # no-op
    monkeypatch.setenv(elastic.DEVICES_ENV, "1")
    with pytest.raises(RuntimeError, match="sized this attempt for 1"):
        elastic.note_elastic_resume(rt, 4)
    monkeypatch.setenv(elastic.DEVICES_ENV, "2")
    trace.configure(str(tmp_path), rank=0)
    try:
        elastic.note_elastic_resume(rt, 0)             # a fresh start
        elastic.note_elastic_resume(rt, 4)
        trace.flush()
    finally:
        trace.disable()
    recs = [r for r in trace.read_records(str(tmp_path / "trace_rank0.jsonl"))
            if r.get("name") == "elastic_resume"]
    assert [(r["step"], r["devices"], r["replicas"]) for r in recs] == [
        (4, 2, 1)]


# ---------------------------------------------------------------------------
# gloo ranks: the layout reshard and the JAX-held losses
# ---------------------------------------------------------------------------

# one port rank: build the run's trainer (optionally from given weights,
# or restoring a canonical payload), train the given steps of the numpy
# batches, report the losses and the pad rows of this rank's ZeRO slices,
# and (rank 0) save the canonical payload
WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.config.flags import apply_env_topology
from dtf_tpu_torch.runtime.mesh import initialize
from dtf_tpu_torch.train import zero

args = json.loads(sys.argv[1])
cfg = apply_env_topology(Config(**args["cfg"]))
cfg = cfg.replace(coordinator_address="file://" + args["rdv"])
build = runner.build_model_for


def with_weights(cfg, spec, device, bn_group=None, **kw):
    model, l2 = build(cfg, spec, device, bn_group, **kw)
    if args.get("weights"):
        model.load_state_dict(torch.load(args["weights"]))
    return model, l2


runner.build_model_for = with_weights
rt = initialize(cfg)
trainer, state, _, _ = runner.build_training(cfg, rt)
if args.get("payload_in"):
    state = trainer.restore_state(torch.load(args["payload_in"]))
losses = []
if args["steps"]:
    data = np.load(args["batches"])
    n = data["x"].shape[1] // rt.num_replicas
    rows = slice(rt.data_index * n, (rt.data_index + 1) * n)
    for step in args["steps"]:
        x, y = (torch.from_numpy(data[k][step, rows]) for k in ("x", "y"))
        state, m = trainer.train_step(state, x, y)
        losses.append(float(m["loss"]))
# the tail past a leaf's length in this rank's slice: zeros
pad = 0.0
leaves = list(enumerate(state.params)) + [
    (i % len(trainer.params), t)
    for i, t in enumerate(trainer.moments(state.opt_state))]
for i, s in leaves:
    numel = int(np.prod(trainer._shapes[i]))
    start = trainer.idx * s.numel()
    if start + s.numel() > numel:
        tail = s[max(numel - start, 0):]
        pad = max(pad, float(tail.abs().max()))
payload = trainer.checkpoint_payload(state)
if rt.rank == 0:
    torch.save(payload, args["out"] + "payload.pt")
with open(args["out"] + "rank%d.json" % rt.rank, "w") as f:
    json.dump({"losses": losses, "pad": pad,
               "slice_len": [int(s.numel()) for _, s in leaves]}, f)
rt.shutdown()
"""


def _start(tmp_path, name, world, cfg, steps=(), batches=None,
           weights=None, payload_in=None):
    """The worker as ``world`` gloo ranks, started; :func:`_wait` reads
    them."""
    out = str(tmp_path / f"{name}_")
    args = json.dumps({"cfg": cfg, "rdv": str(tmp_path / f"{name}.rdv"),
                       "steps": list(steps), "batches": batches,
                       "weights": weights, "payload_in": payload_in,
                       "out": out})
    procs = []
    for rank in range(world):
        env = build_env(rank, world, "unused")
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, out


def _wait(pending):
    """(each rank's report, the canonical payload's path)."""
    procs, out = pending
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    reports = []
    for rank in range(len(procs)):
        with open(f"{out}rank{rank}.json") as f:
            reports.append(json.load(f))
    return reports, f"{out}payload.pt"


LAYOUT = dict(model="transformer_small", dataset="lm", optimizer="adamw",
              num_classes=64, seq_len=16, batch_size=12, device="cpu",
              train_steps=4, use_synthetic_data=True, skip_eval=True,
              distribution_strategy="multi_worker_mirrored", zero_stage=3)


@pytest.mark.parametrize("before,after", [((4, 1), (3, 1)),
                                          ((2, 2), (1, 2))],
                         ids=["zero3_4_to_3", "tp_2x2_to_1x2"])
def test_canonical_state_reshards_bit_for_bit(tmp_path, before, after):
    """A ZeRO-3 canonical state (after a step, so the moments are
    live) from one world staged at another -- a data-parallel degree
    that divides almost no leaf, so every pad row is exercised; and a
    data 2 x model 2 grid at data 1 x model 2 -- reads back bit for bit,
    and every pad row of every slice is zero."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 64, (1, 12, 16)).astype(np.int32)
    np.savez(tmp_path / "b.npz", x=x, y=np.roll(x, -1, 2))
    worlds = []
    for name, (dp, mp) in (("w0", before), ("w1", after)):
        cfg = dict(LAYOUT, model_parallelism=mp)
        worlds.append(_wait(_start(
            tmp_path, name, dp * mp, cfg,
            steps=[0] if name == "w0" else [],
            batches=str(tmp_path / "b.npz"),
            payload_in=worlds[0][1] if worlds else None)))
    (reports0, payload0), (reports1, payload1) = worlds
    assert all(np.isfinite(r["losses"]).all() for r in reports0)
    assert all(r["pad"] == 0.0 for r in reports0 + reports1)
    if before[1] == 1:
        # 3 ranks cut every leaf into thirds, padded
        assert reports1[0]["slice_len"] != reports0[0]["slice_len"]
    a, b = torch.load(payload0), torch.load(payload1)
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(torch.as_tensor(a[key]), torch.as_tensor(b[key])), \
            key


@pytest.fixture(scope="module")
def jax_held(tmp_path_factory, eight_devices):
    """The same topology schedule in both packages, from the same
    weights and batches: ZeRO-3 on 2 replicas for 2 steps, the canonical
    state, staged on 1 replica, 2 more steps.  Returns (the port's
    2-rank reports, its 1-rank report, the JAX losses)."""
    tmp_path = tmp_path_factory.mktemp("jax_held")
    case = CASES["transformer_small"]
    steps, cut = 4, 2
    x, y = _batches(case, case["batch_size"])
    x = np.concatenate([x, x[::-1]])[:steps]
    y = np.concatenate([y, y[::-1]])[:steps]
    np.savez(tmp_path / "batches.npz", x=x, y=y)
    jflags = {k: v for k, v in case.items() if k not in ("model",
                                                         "batch_size")}
    jcfg = JaxConfig(model=case["model"], skip_checkpoint=True, model_dir="",
                     distribution_strategy="multi_worker_mirrored",
                     batch_size=case["batch_size"], train_steps=steps,
                     use_synthetic_data=True, skip_eval=True, zero_stage=3,
                     **jflags)

    def jax_trainer(world):
        rt = JaxMeshRuntime(mesh=make_mesh(eight_devices[:world],
                                           data=world),
                            strategy="multi_worker_mirrored",
                            shard_seq=True)
        jmodel, l2 = jax_build_model(case["model"],
                                     num_classes=case["num_classes"])
        return rt, jmodel, JaxTrainer(jcfg, rt, jmodel, l2,
                                      _jax_spec(case))

    rt2, jmodel, jt2 = jax_trainer(2)
    zstate = jt2.init_state(jax.random.key(0), (x[0], y[0]))
    initial, plain = _initial(case, jmodel, jt2, rt2, x)
    jstate = jt2.staged_state(jt2.canonical_state(zstate).replace(
        params=_np(plain.params), batch_stats=_np(plain.batch_stats)))
    weights = str(tmp_path / "weights.pt")
    torch.save(initial, weights)
    cfg = dict(case, device="cpu", train_steps=steps, seed=0,
               use_synthetic_data=True, skip_eval=True,
               distribution_strategy="multi_worker_mirrored", zero_stage=3)
    batches = str(tmp_path / "batches.npz")
    # each port world runs while the JAX package runs the same steps
    pending = _start(tmp_path, "w2", 2, cfg, steps=range(cut),
                     batches=batches, weights=weights)
    jl = []
    for step in range(cut):
        jstate, m = jt2.train_step(jstate, *rt2.shard_batch((x[step],
                                                             y[step])))
        jl.append(float(m["loss"]))
    canon = jax.device_get(jt2.canonical_state(jstate))
    wide, payload = _wait(pending)
    pending = _start(tmp_path, "w1", 1, cfg, steps=range(cut, steps),
                     batches=batches, payload_in=payload)
    rt1, _, jt1 = jax_trainer(1)
    jt1.init_state(jax.random.key(0), (x[0], y[0]))   # its layout
    jstate = jt1.staged_state(canon)
    for step in range(cut, steps):
        jstate, m = jt1.train_step(jstate, *rt1.shard_batch((x[step],
                                                             y[step])))
        jl.append(float(m["loss"]))
    narrow, _ = _wait(pending)
    return wide, narrow[0], jl


def test_shrink_losses_match_the_jax_zero_trainer(jax_held):
    """Per-step losses within 1e-5 in float32 across the shrink."""
    wide, narrow, jl = jax_held
    np.testing.assert_allclose(wide[0]["losses"] + narrow["losses"], jl,
                               rtol=1e-5)


def test_shrink_ranks_agree_before_the_shrink(jax_held):
    wide, _, _ = jax_held
    assert wide[0]["losses"] == wide[1]["losses"]
    assert all(r["pad"] == 0.0 for r in wide)


# ---------------------------------------------------------------------------
# end to end: lm_main under the elastic supervisor, against a prep run
# and a fresh 1-rank oracle
# ---------------------------------------------------------------------------

E2E_STEPS = 16     # the tail after the announce outlasts the drain
LOSS_AT = 2        # on a checkpoint boundary (exact-match chaos)
GROW_AFTER = 4     # re-announce once this step's checkpoint is sealed


def _lm_cmd(model_dir, trace_dir, fault):
    return [sys.executable, "-m", "dtf_tpu_torch.cli.lm_main",
            "--use_synthetic_data", "--device", "cpu",
            "--model", "transformer_small", "--seq_len", "32",
            "--num_classes", "256", "--batch_size", "4",
            "--train_steps", str(E2E_STEPS), "--log_steps", "1",
            "--dtype", "fp32", "--step_time_guard_factor", "0",
            "--distribution_strategy", "multi_worker_mirrored",
            "--zero_stage", "3", "--resume", "--checkpoint_steps", "2",
            "--model_dir", model_dir, "--trace_dir", trace_dir,
            *(["--fault", fault] if fault else [])]


def _trace_records(trace_dir, name):
    out = []
    for f in sorted(os.listdir(trace_dir)):
        if f.startswith("trace_rank"):
            out += [r for r in trace.read_records(os.path.join(trace_dir, f))
                    if r.get("kind") == "event" and r.get("name") == name]
    return out


def _losses(trace_dir):
    """{step: {losses}} over every rank's trace."""
    out: dict = {}
    for r in _trace_records(trace_dir, "train_loss"):
        out.setdefault(int(r["step"]), set()).add(r["loss"])
    return out


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The supervised run (host loss at step 2 on 2 ranks, shrink to 1,
    grow back) beside the prep run (the same command, crash@step:2),
    then the oracle: 1 rank resumed from a copy of the prep run's
    model dir."""
    base = tmp_path_factory.mktemp("elastic_e2e")
    d = lambda name: str(base / name)  # noqa: E731
    logs = d("logs")
    os.makedirs(logs)
    manifest = os.path.join(d("m"), "checkpoints.meta",
                            f"manifest_{GROW_AFTER}.json")

    def announcer():
        deadline = time.monotonic() + 150
        while not os.path.exists(manifest) and time.monotonic() < deadline:
            time.sleep(0.05)
        elastic.announce_rejoin(logs, 2)

    results = {}

    def prep():
        results["prep"] = launch.launch_local(
            _lm_cmd(d("prep_m"), d("prep_t"), f"crash@step:{LOSS_AT}"), 2,
            f"file://{d('prep.rdv')}", d("prep_logs"), timeout_s=150)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        threads = [threading.Thread(target=fn, daemon=True)
                   for fn in (announcer, prep)]
        for th in threads:
            th.start()
        rc = launch.launch_local(
            _lm_cmd(d("m"), d("t"), f"host_loss@rank1:step:{LOSS_AT}"), 2,
            f"file://{d('run.rdv')}", logs, timeout_s=150, elastic=True,
            min_devices=1, max_restarts=2, restart_backoff_s=0.05,
            teardown_grace=10.0)
        for th in threads:
            th.join(timeout=160)
        shutil.copytree(d("prep_m"), d("oracle_m"))
        oracle = launch.launch_local(
            _lm_cmd(d("oracle_m"), d("oracle_t"), None), 1,
            f"file://{d('oracle.rdv')}", d("oracle_logs"), timeout_s=150)
    return {"rc": rc, "prep": results.get("prep"), "oracle": oracle,
            "events": _events(logs), "t": d("t"),
            "run": _losses(d("t")), "prep_losses": _losses(d("prep_t")),
            "oracle_losses": _losses(d("oracle_t")),
            # one event an attempt's rank: (step, world) once each
            "resumes": sorted({(int(r["step"]), int(r["devices"])) for r in
                               _trace_records(d("t"), "elastic_resume")})}


def test_e2e_shrinks_on_host_loss_and_grows_back(e2e):
    assert e2e["rc"] == 0, e2e["events"]
    ev = e2e["events"]
    (shrink,) = _named(ev, "elastic_shrink")
    assert shrink["classification"] == "host_loss"
    assert shrink["total_devices"] == 1
    assert _named(ev, "elastic_grow") and not _named(ev, "restart")
    (first, second) = e2e["resumes"]
    assert first == (LOSS_AT, 1)
    assert second[0] >= GROW_AFTER and second[1] == 2
    # every step trained exactly once, over every rank's trace
    assert sorted(e2e["run"]) == list(range(1, E2E_STEPS + 1))
    assert all(len(v) == 1 for v in e2e["run"].values()), e2e["run"]


def test_e2e_prefix_and_shrunken_window_are_bit_identical(e2e):
    """Steps 1-2 equal the prep run's; steps 3 to the grow step equal
    the fresh 1-rank oracle's, as floats."""
    assert e2e["prep"] == chaos.EXIT_INJECTED_CRASH
    assert e2e["oracle"] == 0
    for step in range(1, LOSS_AT + 1):
        assert e2e["run"][step] == e2e["prep_losses"][step], step
    grow_step = e2e["resumes"][1][0]
    for step in range(LOSS_AT + 1, grow_step + 1):
        assert e2e["run"][step] == e2e["oracle_losses"][step], step


def test_e2e_trace_is_clean_but_for_the_fault(e2e):
    assert trace_main([e2e["t"], "--check", "--allow", "injected_fault",
                       "--allow", "host_loss"]) == 0
    assert trace_main([e2e["t"], "--check"]) != 0


def test_e2e_device_loss_classifies_and_resumes(tmp_path):
    """``device_loss@step:2`` (exit 76) under --elastic: classified,
    resumed on 1 rank, every step 1-6 trained once, the trace clean but
    for the fault."""
    cmd = _lm_cmd(str(tmp_path / "m"), str(tmp_path / "t"),
                  "device_loss@step:2")
    cmd[cmd.index("--train_steps") + 1] = "6"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rc, logs = _launch(cmd, 2, tmp_path, elastic=True, max_restarts=1,
                           restart_backoff_s=0.05, teardown_grace=10.0)
    assert rc == 0
    (shrink,) = _named(_events(logs), "elastic_shrink")
    assert shrink["classification"] == "device_loss"
    assert shrink["total_devices"] == 1
    got = _losses(str(tmp_path / "t"))
    assert sorted(got) == list(range(1, 7))
    assert all(len(v) == 1 for v in got.values())
    assert trace_main([str(tmp_path / "t"), "--check", "--allow",
                       "injected_fault", "--allow", "device_loss"]) == 0
