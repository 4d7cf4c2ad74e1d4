"""The port's fault injection, preemption, tracing, launcher supervision
and trace summarizer (dtf_tpu_torch: chaos/, train/preemption.py,
obs/trace.py, obs/vocab.py, obs/watchdog.py, cli/launch.py,
cli/trace_main.py) against the JAX package's.

The grammar, the exit codes, the vocabulary and ``trace_main``'s
verdicts are compared with the JAX package's on the same inputs.  The
supervisor's policy runs scripted ranks (plain Python, no torch), as
``tests/test_chaos.py`` and ``tests/test_supervision.py`` do; the
in-process runs hold an armed-but-unfired fault to a chaos-off run and
a SIGTERM to its emergency checkpoint.  The end-to-end kill-and-resume
runs are ``tests/test_torch_recovery.py``.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from dtf_tpu import chaos as jax_chaos
from dtf_tpu.cli import launch as jax_launch
from dtf_tpu.cli.trace_main import main as jax_trace_main
from dtf_tpu.obs import vocab as jax_vocab
from dtf_tpu_torch import chaos
from dtf_tpu_torch.cli import launch
from dtf_tpu_torch.cli.trace_main import main as trace_main
from dtf_tpu_torch.config import Config
from dtf_tpu_torch.obs import trace, vocab
from dtf_tpu_torch.obs.watchdog import Heartbeat
from dtf_tpu_torch.train import preemption
from dtf_tpu_torch.train.checkpoint import Checkpointer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_chaos():
    yield
    chaos.disable()
    trace.disable()
    preemption.restore()


# ---------------------------------------------------------------------------
# the spec grammar, against the JAX package's parser
# ---------------------------------------------------------------------------

VALID_SPECS = [
    "crash@step:120, sigterm@rank1:step:80,ps_drop@version:50,"
    "heartbeat_stall@step:60,ckpt_truncate@latest",
    "device_loss@step:4,host_loss@rank2:step:6",
    "replica_kill@req:5, replica_kill@replica0:req:3",
    "net_partition@replica1:6, slow_replica@replica0:2.5",
    "net_partition@replica2:ticks:4,page_fetch_stall@replica1:0.5",
    "rollout_kill@phase:canary,router_kill@req:7,lease_stall@3",
    "reader_crash@batch:9",
]

INVALID_SPECS = [
    "explode@step:3", "crash@version:3", "crash@step:x", "crash",
    "ckpt_truncate@step:3", "crash@rankX:step:3", "crash@step:-1",
    "net_partition@4", "slow_replica@replica0:1.0",
    "net_partition@replica1:0", "replica_kill@step:4",
    "net_partition@replicaX:4",
]


def _fields(specs):
    return [(s.kind, s.rank, s.value, s.replica, s.label, str(s))
            for s in specs]


@pytest.mark.parametrize("text", VALID_SPECS)
def test_parse_spec_matches_jax(text):
    assert _fields(chaos.parse_spec(text)) == _fields(
        jax_chaos.parse_spec(text))
    for spec in chaos.parse_spec(text):
        (again,) = chaos.parse_spec(str(spec))
        assert _fields([again]) == _fields([spec])


@pytest.mark.parametrize("bad", INVALID_SPECS)
def test_parse_spec_rejects_as_jax(bad):
    with pytest.raises(ValueError):
        jax_chaos.parse_spec(bad)
    with pytest.raises(ValueError):
        chaos.parse_spec(bad)


def test_kinds_and_vocabulary_are_the_jax_packages():
    assert chaos.KINDS == jax_chaos.KINDS
    assert set(vocab.CHAOS_FAULT_KINDS) == set(chaos.KINDS)
    for name in ("KNOWN_ANOMALY_KINDS", "KNOWN_EVENT_KINDS",
                 "CHAOS_FAULT_KINDS", "METRIC_SUBSYSTEMS"):
        assert getattr(vocab, name) == getattr(jax_vocab, name), name
    assert vocab.allowable_kinds() == jax_vocab.allowable_kinds()


@pytest.mark.parametrize("spec,subsystem", [
    ("device_loss@step:4", "elastic"),
    ("ps_drop@version:3", "parameter server"),
    ("replica_kill@req:3", "serving fleet"),
    ("net_partition@replica1:6", "serving fleet"),
    ("slow_replica@replica0:2.5", "serving fleet"),
    ("page_fetch_stall@replica0:0.5", "serving fleet"),
    ("router_kill@req:2", "serving fleet"),
    ("lease_stall@3", "serving fleet"),
    ("rollout_kill@phase:rolling", "serving fleet"),
])
def test_unported_kinds_parse_but_refuse_to_arm(spec, subsystem):
    chaos.parse_spec(spec)
    Config(fault=spec)                       # the flag's grammar check
    if spec.partition("@")[0] not in chaos.NOT_PORTED:
        # ported since (ps_drop, with the async parameter server): it
        # arms, and fires once at its point
        inj = chaos.configure(spec, rank=0)
        assert chaos.enabled() and [str(s) for s in inj.specs] == [spec]
        assert not chaos.ps_drop(2) and chaos.ps_drop(3)
        assert not chaos.ps_drop(4)
        return
    with pytest.raises(ValueError, match=f"{subsystem}.*not ported"):
        chaos.configure(spec)
    assert not chaos.enabled()


def test_config_flag_validates_spec():
    with pytest.raises(ValueError):
        Config(fault="explode@step:3")
    assert Config(fault="crash@step:3").fault == "crash@step:3"
    assert Config().fault == ""


def test_rank_filtering():
    inj = chaos.configure("crash@rank1:step:5,heartbeat_stall@step:2",
                          rank=0)
    # the rank-1 crash is not armed on rank 0
    assert [s.kind for s in inj.specs] == ["heartbeat_stall"]
    inj.step(5)  # must NOT crash this process
    assert inj.heartbeat_stalled(3)


def test_off_by_default_and_probes_are_noops():
    chaos.disable()
    assert not chaos.enabled()
    assert chaos.maybe_configure(None) is None
    chaos.step(10 ** 9)
    assert chaos.heartbeat_stalled(10 ** 9) is False
    assert chaos.ckpt_truncate() is False


def test_maybe_configure_disarms_stale_injector(monkeypatch):
    monkeypatch.delenv("DTF_FAULT", raising=False)
    chaos.configure("crash@step:1")
    assert chaos.enabled()
    chaos.maybe_configure(Config())      # a run with no --fault disarms
    assert not chaos.enabled()
    monkeypatch.setenv("DTF_FAULT", "sigterm@step:7")
    inj = chaos.maybe_configure(Config())
    assert [str(s) for s in inj.specs] == ["sigterm@step:7"]


def test_exit_code_contract_matches_jax():
    assert (launch.EXIT_PREEMPTED == preemption.EXIT_PREEMPTED
            == chaos.EXIT_PREEMPTED == jax_launch.EXIT_PREEMPTED == 75)
    assert chaos.EXIT_DEVICE_LOST == jax_chaos.EXIT_DEVICE_LOST == 76
    assert chaos.EXIT_INJECTED_CRASH == jax_chaos.EXIT_INJECTED_CRASH == 77
    for rc in (0, 1, 3, 75, 76, 77, -9, -15):
        assert launch.classify_exit(rc) == jax_launch.classify_exit(rc)


def test_heartbeat_stall_fault(tmp_path):
    chaos.configure("heartbeat_stall@step:5")
    hb = Heartbeat(str(tmp_path / "hb.json"), interval_s=0.0)
    assert hb.beat(step=1, force=True)          # before the stall: writes
    assert not hb.beat(step=5, force=True)      # stalled
    assert not hb.beat(step=7, force=True)      # latched
    assert not hb.beat(step=1, force=True)      # even for earlier steps


@pytest.mark.parametrize("kind,code", [("crash", 77),
                                       ("host_loss", -signal.SIGKILL)])
def test_fired_fault_reaches_the_trace_before_the_process_dies(tmp_path,
                                                               kind, code):
    """The fault's injected_fault anomaly is flushed before os._exit or
    the SIGKILL, which run no cleanup."""
    script = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from dtf_tpu_torch import chaos\n"
        "from dtf_tpu_torch.obs import trace\n"
        f"trace.configure({str(tmp_path)!r}, rank=0)\n"
        f"chaos.configure('{kind}@step:3', rank=0)\n"
        "chaos.step(2)\n"
        "chaos.step(3)\n"
        "print('survived')\n")
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == code and "survived" not in proc.stdout
    recs = trace.read_records(str(tmp_path / "trace_rank0.jsonl"))
    fired = [r for r in recs if r.get("name") == "injected_fault"]
    assert len(fired) == 1 and fired[0]["fault_kind"] == kind
    assert fired[0]["step"] == 3


def test_preemption_guard_latches_sigterm():
    guard = preemption.install()
    assert guard.active and preemption.triggered() is None
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 5
    while preemption.triggered() is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert preemption.triggered() == signal.SIGTERM
    preemption.restore()
    assert preemption.triggered() is None


# ---------------------------------------------------------------------------
# trace_main, against the JAX tool on the same files
# ---------------------------------------------------------------------------

def _write_trace(path, recs):
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")


def test_trace_check_allowlist_as_jax(tmp_path):
    path = tmp_path / "trace_rank0.jsonl"
    _write_trace(path, [
        {"kind": "span", "name": "step", "ts": 0.0, "dur_s": 0.1,
         "rank": 0, "step": 1},
        {"kind": "anomaly", "name": "injected_fault", "ts": 1.0,
         "rank": 0, "fault": "crash@step:1"}])
    cases = [["--check"], ["--check", "--allow", "injected_fault"]]
    for argv in cases:
        assert trace_main([str(tmp_path)] + argv) == jax_trace_main(
            [str(tmp_path)] + argv)
    assert trace_main([str(tmp_path), "--check"]) == 1
    assert trace_main([str(tmp_path), "--check",
                       "--allow", "injected_fault"]) == 0
    # a second, NOT-allowed anomaly still fails the allowlisted check
    with path.open("a") as f:
        f.write(json.dumps({"kind": "anomaly", "name": "nan_loss",
                            "ts": 2.0, "rank": 0, "step": 2}) + "\n")
    for argv in cases:
        assert trace_main([str(tmp_path)] + argv) == jax_trace_main(
            [str(tmp_path)] + argv) == 1


def test_trace_merge_request_and_summary_as_jax(tmp_path, capsys):
    """Two ranks' files: the merged stream, one trace id's timeline and
    the summary print as the JAX tool prints them."""
    _write_trace(tmp_path / "trace_rank0.jsonl", [
        {"kind": "event", "name": "trace_start", "ts": 0.5, "rank": 0,
         "trace": "aa"},
        {"kind": "span", "name": "step", "ts": 1.0, "dur_s": 0.2, "rank": 0,
         "step": 0, "trace": "aa"},
        {"kind": "event", "name": "train_loss", "ts": 1.2, "rank": 0,
         "step": 1, "loss": 2.5, "trace": "aa"}])
    _write_trace(tmp_path / "trace_rank1.jsonl", [
        {"kind": "span", "name": "step", "ts": 0.9, "dur_s": 0.3, "rank": 1,
         "step": 0, "trace": "aa"},
        {"kind": "event", "name": "train_loss", "ts": 1.3, "rank": 1,
         "step": 1, "loss": 2.5, "trace": "bb"}])
    for argv in (["--merge"], ["--request", "aa"],
                 ["--request", "aa", "--merge"]):
        assert trace_main([str(tmp_path)] + argv) == 0
        port = capsys.readouterr().out
        assert jax_trace_main([str(tmp_path)] + argv) == 0
        assert port == capsys.readouterr().out, argv
    assert trace_main([str(tmp_path)]) == jax_trace_main([str(tmp_path)])
    assert capsys.readouterr().out.count("step spans: 2") == 2
    assert trace_main([str(tmp_path), "--request", "zz"]) == 2


# ---------------------------------------------------------------------------
# supervisor policy (scripted ranks, no torch)
# ---------------------------------------------------------------------------

def _events(log_dir):
    with open(os.path.join(log_dir, "supervisor_events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _counting_script(marker, codes):
    """A rank that exits codes[n] on its n-th start."""
    return ("import os, sys\n"
            f"p = {str(marker)!r}\n"
            "n = int(open(p).read()) if os.path.exists(p) else 0\n"
            "open(p, 'w').write(str(n + 1))\n"
            f"sys.exit({list(codes)!r}[n])\n")


def test_restart_recovers_from_transient_failure(tmp_path):
    marker = tmp_path / "attempted"
    script = (f"import os, sys; p = {str(marker)!r}\n"
              f"sys.exit(0) if os.path.exists(p) else "
              f"(open(p, 'w').close(), sys.exit(3))")
    rc = launch.launch_local([sys.executable, "-c", script], 2,
                             launch.free_address(), str(tmp_path / "logs"),
                             max_restarts=2, restart_backoff_s=0.01)
    assert rc == 0 and marker.exists()


def test_no_restart_without_flag(tmp_path):
    rc = launch.launch_local([sys.executable, "-c", "import sys; sys.exit(5)"],
                             2, launch.free_address(), str(tmp_path / "logs"))
    assert rc == 5
    assert _events(str(tmp_path / "logs"))[-1]["event"] == "give_up"


def test_preempted_restart_does_not_consume_budget(tmp_path):
    """preempt -> crash -> success on a crash budget of ONE."""
    script = _counting_script(tmp_path / "count",
                              [launch.EXIT_PREEMPTED, 3, 0])
    rc = launch.launch_local([sys.executable, "-c", script], 1,
                             launch.free_address(), str(tmp_path / "logs"),
                             max_restarts=1, restart_backoff_s=0.01)
    assert rc == 0
    restarts = [e for e in _events(str(tmp_path / "logs"))
                if e["event"] == "restart"]
    assert [e["classification"] for e in restarts] == ["preempted",
                                                       "crash"]
    assert [e["crashes_in_window"] for e in restarts] == [0, 1]
    assert restarts[0]["backoff_s"] == 0.0


def test_unsupervised_preemption_does_not_restart(tmp_path):
    marker = tmp_path / "ran"
    script = (f"import sys; open({str(marker)!r}, 'a').write('x'); "
              f"sys.exit({launch.EXIT_PREEMPTED})")
    rc = launch.launch_local([sys.executable, "-c", script], 1,
                             launch.free_address(), str(tmp_path / "logs"))
    assert rc == launch.EXIT_PREEMPTED
    assert marker.read_text() == "x"            # ran exactly once
    give_up = [e for e in _events(str(tmp_path / "logs"))
               if e["event"] == "give_up"]
    assert give_up and give_up[0]["reason"] == "unsupervised"


def test_preemption_loop_backstop(tmp_path):
    rc = launch.launch_local(
        [sys.executable, "-c",
         f"import sys; sys.exit({launch.EXIT_PREEMPTED})"], 1,
        launch.free_address(), str(tmp_path / "logs"), max_restarts=1,
        max_preemptions=3)
    assert rc == launch.EXIT_PREEMPTED
    ev = _events(str(tmp_path / "logs"))
    assert len([e for e in ev if e["event"] == "restart"]) == 3
    assert ev[-1]["event"] == "give_up"
    assert ev[-1]["classification"] == "preempted"


def test_teardown_escalates_to_kill_for_stuck_rank(tmp_path):
    script = ("import os, signal, sys, time\n"
              "if os.environ['DTF_PROCESS_ID'] == '1':\n"
              "    sys.exit(3)\n"
              "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
              "time.sleep(600)\n")
    t0 = time.monotonic()
    rc = launch.launch_local([sys.executable, "-c", script], 2,
                             launch.free_address(), str(tmp_path / "logs"),
                             teardown_grace=1.0)
    assert rc == 3 and time.monotonic() - t0 < 30
    assert any(e["event"] == "teardown_kill" and e["rank"] == 0
               for e in _events(str(tmp_path / "logs")))


def test_crash_budget_is_per_window_with_backoff(tmp_path):
    rc = launch.launch_local(
        [sys.executable, "-c", "import sys; sys.exit(3)"], 1,
        launch.free_address(), str(tmp_path / "logs"), max_restarts=2,
        restart_window_s=3600.0, restart_backoff_s=0.01)
    assert rc == 3
    ev = _events(str(tmp_path / "logs"))
    restarts = [e for e in ev if e["event"] == "restart"]
    assert [e["classification"] for e in restarts] == ["crash", "crash"]
    assert restarts[1]["backoff_s"] == pytest.approx(0.02)
    give_up = [e for e in ev if e["event"] == "give_up"]
    assert give_up and give_up[0]["crashes_in_window"] == 2


def test_crash_window_expiry_restores_budget(tmp_path):
    marker = tmp_path / "count"
    rc = launch.launch_local(
        [sys.executable, "-c", _counting_script(marker, [3, 3, 0])], 1,
        launch.free_address(), str(tmp_path / "logs"), max_restarts=1,
        restart_window_s=0.001, restart_backoff_s=0.05)
    assert rc == 0 and marker.read_text() == "3"


def test_heartbeat_kills_hung_rank_as_host_loss(tmp_path):
    script = "import time; print('up', flush=True); time.sleep(600)"
    t0 = time.monotonic()
    rc = launch.launch_local([sys.executable, "-c", script], 2,
                             launch.free_address(), str(tmp_path / "logs"),
                             heartbeat_timeout=1.0, startup_grace=1.0)
    assert rc != 0 and time.monotonic() - t0 < 60
    ev = _events(str(tmp_path / "logs"))
    assert any(e["event"] == "heartbeat_lost" for e in ev)
    assert any(e["event"] == "rank_exit"
               and e["classification"] == "host_loss" for e in ev)


def test_heartbeat_file_keeps_a_quiet_rank_alive(tmp_path):
    """A rank that logs nothing but beats (obs/watchdog.Heartbeat under
    the launcher's DTF_HEARTBEAT_DIR) outlives the timeout."""
    script = ("import sys, time\n"
              f"sys.path.insert(0, {REPO!r})\n"
              "from dtf_tpu_torch.obs.watchdog import Heartbeat\n"
              "hb = Heartbeat.from_env(interval_s=0.2)\n"
              "t = time.monotonic()\n"
              "while time.monotonic() - t < 4.5:\n"
              "    hb.beat(step=1)\n"
              "    time.sleep(0.1)\n")
    rc = launch.launch_local([sys.executable, "-c", script], 1,
                             launch.free_address(), str(tmp_path / "logs"),
                             heartbeat_timeout=2.0, startup_grace=1.0)
    assert rc == 0


def test_startup_grace_spares_slow_starter(tmp_path):
    script = "import time; time.sleep(3); print('compiled', flush=True)"
    rc = launch.launch_local([sys.executable, "-c", script], 1,
                             launch.free_address(), str(tmp_path / "logs"),
                             heartbeat_timeout=1.0, startup_grace=30.0)
    assert rc == 0


def test_unprompted_sigkill_is_host_loss(tmp_path):
    script = "import os, signal; os.kill(os.getpid(), signal.SIGKILL)"
    rc = launch.launch_local([sys.executable, "-c", script], 1,
                             launch.free_address(), str(tmp_path / "logs"))
    assert rc == -signal.SIGKILL
    exits = [e for e in _events(str(tmp_path / "logs"))
             if e["event"] == "rank_exit"]
    assert exits[0]["classification"] == "host_loss"


@pytest.mark.parametrize("scheme", ["file", "tcp"])
def test_every_restart_gets_a_fresh_rendezvous(tmp_path, scheme):
    """Each attempt's ranks see another DTF_COORDINATOR: a new file://
    store path, or a newly free port; and the job's one trace id."""
    seen = tmp_path / "seen"
    script = ("import os, sys\n"
              f"open({str(seen)!r}, 'a').write(os.environ['DTF_COORDINATOR']"
              " + ' ' + os.environ['DTF_TRACE_ID'] + ' ' + "
              "os.environ['DTF_RESTART_GENERATION'] + '\\n')\n"
              "sys.exit(0 if os.environ['DTF_RESTART_GENERATION'] == '2' "
              "else 3)\n")
    coordinator = (f"file://{tmp_path / 'store'}" if scheme == "file"
                   else launch.free_address())
    rc = launch.launch_local([sys.executable, "-c", script], 1, coordinator,
                             str(tmp_path / "logs"), max_restarts=2,
                             restart_backoff_s=0.01)
    assert rc == 0
    rows = [line.split() for line in seen.read_text().splitlines()]
    assert [r[2] for r in rows] == ["0", "1", "2"]
    assert rows[0][0] == coordinator
    assert len({r[0] for r in rows}) == 3
    assert len({r[1] for r in rows}) == 1
    if scheme == "file":
        assert [r[0] for r in rows[1:]] == [f"{coordinator}.1",
                                            f"{coordinator}.2"]


def test_hosts_mode_rejects_supervision_flags():
    with pytest.raises(ValueError, match="supervise"):
        launch.main(["--hosts", "h1,h2", "--max_restarts", "1", "--",
                     "echo", "hi"])


# ---------------------------------------------------------------------------
# in-process runs: an armed fault that never fires, an emergency save
# ---------------------------------------------------------------------------

def _lm_flags(tmp_path, steps=4):
    return ["--use_synthetic_data", "--device", "cpu", "--model",
            "transformer_small", "--seq_len", "16", "--num_classes", "64",
            "--batch_size", "2", "--train_steps", str(steps),
            "--log_steps", "1", "--dtype", "fp32",
            "--distribution_strategy", "off",
            "--step_time_guard_factor", "0",
            "--model_dir", str(tmp_path / "m")]


def _loss_by_step(trace_dir):
    """{step: {losses}} over every rank's and every attempt's trace."""
    out = {}
    for path in glob.glob(os.path.join(trace_dir, "trace_rank*.jsonl")):
        for rec in trace.read_records(path):
            if rec.get("kind") == "event" and rec.get("name") == "train_loss":
                out.setdefault((rec["rank"], rec["step"]), set()).add(
                    rec["loss"])
    return out


def test_armed_but_unfired_is_behavior_identical(tmp_path):
    from dtf_tpu_torch.cli import lm_main

    def traced(sub, fault):
        argv = _lm_flags(tmp_path / sub) + ["--skip_checkpoint",
                                            "--trace_dir",
                                            str(tmp_path / sub / "t")]
        lm_main.main(argv + (["--fault", fault] if fault else []))
        trace.disable()
        return _loss_by_step(str(tmp_path / sub / "t"))

    off = traced("off", "")
    armed = traced("armed", "crash@step:999999,sigterm@step:888888")
    assert len(off) == 4 and armed == off


def test_inprocess_sigterm_writes_emergency_checkpoint(tmp_path):
    from dtf_tpu_torch.cli import lm_main

    with pytest.raises(SystemExit) as exc:
        lm_main.main(_lm_flags(tmp_path) + ["--fault", "sigterm@step:2"])
    assert exc.value.code == preemption.EXIT_PREEMPTED
    ckpt = Checkpointer(str(tmp_path / "m"))
    assert ckpt.all_steps() == [2] and ckpt.verify(2) == "ok"
    assert ckpt.host_state(2)["global_step"] == 2
    chaos.disable()
    stats = lm_main.main(_lm_flags(tmp_path) + ["--resume"])
    assert [s for s, _ in stats["train_loss_log"]] == [3, 4]


def test_reader_crash_fires_once_on_its_batch_like_jax():
    """reader_crash is ported with the data service: it arms, and fires
    once, on its exact merged batch, as the JAX injector does."""
    from dtf_tpu import chaos as jchaos
    for mod in (chaos, jchaos):
        mod.configure("reader_crash@batch:3", rank=0)
        try:
            assert [mod.reader_crash(b) for b in (2, 3, 3, 4)] == [
                False, True, False, False]
        finally:
            mod.disable()
    assert not chaos.reader_crash(3)    # disarmed: a None check
