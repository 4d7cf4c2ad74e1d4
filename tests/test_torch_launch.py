"""The port's topology, global-batch rules and launcher
(dtf_tpu_torch: config/flags.py, runtime/mesh.py, cli/runner.py,
cli/launch.py) against the JAX package's, on the CPU.

The topology cases run the same environment through both packages'
``parse_flags`` and compare the fields they fill.  The launcher cases
start real ranks: a two-rank ``cifar_main --device cpu`` on CIFAR files
the test writes (gloo), whose ranks must log the same losses and whose
stride-sharded, masked eval must count each test example once and equal
one process's eval of the same weights (1e-6 relative on the loss,
exact on the counts); and a rank that fails, which must take the
launcher down within seconds.
"""

import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from dtf_tpu.cli import runner as jax_runner
from dtf_tpu.config import parse_flags as jax_parse_flags
from dtf_tpu_torch.cli import cifar_main, launch, runner
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.data import base as data_base
from dtf_tpu_torch.data import cifar
from dtf_tpu_torch.models import resnet_cifar
from dtf_tpu_torch.runtime import mesh
from dtf_tpu_torch.runtime.mesh import MeshRuntime
from dtf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGY = ("coordinator_address", "process_id", "process_count")
ENV_NAMES = ("DTF_COORDINATOR", "DTF_PROCESS_ID", "DTF_PROCESS_COUNT",
             "TF_CONFIG")
TF_CLUSTER = {"ps": ["ps0:2222"], "worker": ["w0:2222", "w1:2222"]}

TOPOLOGY_CASES = {
    "dtf_env": ({"DTF_COORDINATOR": "h0:1234", "DTF_PROCESS_ID": "1",
                 "DTF_PROCESS_COUNT": "4"}, []),
    "tf_config_ps_task": ({"TF_CONFIG": json.dumps(
        {"cluster": TF_CLUSTER, "task": {"type": "ps", "index": 0}})}, []),
    "tf_config_worker_after_ps": ({"TF_CONFIG": json.dumps(
        {"cluster": TF_CLUSTER, "task": {"type": "worker", "index": 1}})},
        []),
    "tf_config_workers_only": ({"TF_CONFIG": json.dumps(
        {"cluster": {"worker": ["a:1", "b:1", "c:1"]},
         "task": {"type": "worker", "index": 2}})}, []),
    "tf_config_malformed": ({"TF_CONFIG": "{not json"}, []),
    "dtf_env_wins_over_tf_config": (
        {"DTF_PROCESS_ID": "0", "TF_CONFIG": json.dumps(
            {"cluster": TF_CLUSTER, "task": {"type": "worker",
                                             "index": 0}})}, []),
    "worker_hosts": ({}, ["--worker_hosts", "h1:9, h2:9,h3:9",
                          "--task_index", "2"]),
    "worker_hosts_without_task_index": ({}, ["--worker_hosts", "h1:9"]),
    "explicit_flags_win": (
        {"DTF_COORDINATOR": "env:1", "DTF_PROCESS_ID": "3",
         "DTF_PROCESS_COUNT": "4"},
        ["--coordinator_address", "flag:2", "--process_id", "1"]),
    "nothing": ({}, []),
}


@pytest.mark.parametrize("case", sorted(TOPOLOGY_CASES))
def test_topology_matches_jax(monkeypatch, case):
    env, argv = TOPOLOGY_CASES[case]
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = parse_flags(argv)
    want = jax_parse_flags(argv)
    assert ({k: getattr(got, k) for k in TOPOLOGY}
            == {k: getattr(want, k) for k in TOPOLOGY})


def test_strategy_flags_parse_and_default_as_jax():
    cfg = parse_flags(["--distribution_strategy", "horovod",
                       "--num_devices", "2", "--sync_bn",
                       "--ps_mode", "sync"])
    assert (cfg.distribution_strategy, cfg.num_devices, cfg.sync_bn,
            cfg.ps_mode) == ("horovod", 2, True, "sync")
    jcfg = jax_parse_flags([])
    for name in ("distribution_strategy", "ps_mode", "num_devices",
                 "worker_hosts", "task_index", "sync_bn") + TOPOLOGY:
        assert getattr(Config(), name) == getattr(jcfg, name), name
    with pytest.raises(ValueError, match="distribution_strategy"):
        parse_flags(["--distribution_strategy", "central_storage"])
    with pytest.raises(ValueError, match="ps_mode"):
        parse_flags(["--ps_mode", "lazy"])


@pytest.mark.parametrize("strategy", ["off", "mirrored",
                                      "multi_worker_mirrored", "horovod",
                                      "parameter_server", "tpu"])
def test_effective_global_batch_matches_jax(strategy):
    rt = types.SimpleNamespace(num_replicas=4)
    got = runner.effective_global_batch(
        Config(distribution_strategy=strategy, batch_size=32), rt)
    want = jax_runner.effective_global_batch(
        jax_parse_flags(["--distribution_strategy", strategy,
                         "--batch_size", "32"]), rt)
    assert got == want == (128 if strategy in ("horovod", "parameter_server")
                           else 32)


@pytest.mark.parametrize("batch,accum,match", [
    (6, 1, "divisible by the number of data-parallel replicas"),
    (8, 3, "per-replica batch 2 must be divisible by grad_accum_steps"),
])
def test_trainer_refuses_batches_the_replicas_cannot_split(batch, accum,
                                                          match):
    cfg = Config(device="cpu", model="resnet20", dataset="cifar10",
                 batch_size=batch, grad_accum_steps=accum,
                 distribution_strategy="multi_worker_mirrored")
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, resnet_cifar.resnet20(), 0.0, data_base.CIFAR10,
                runtime=MeshRuntime("multi_worker_mirrored", num_replicas=4))


def test_host_batch_must_split_over_the_processes():
    cfg = Config(device="cpu", dataset="cifar10", use_synthetic_data=True)
    rt = MeshRuntime("multi_worker_mirrored", num_replicas=3, rank=1)
    with pytest.raises(ValueError, match="process count"):
        runner.make_input_fns(cfg, data_base.CIFAR10, 8, rt)
    train_fn, _ = runner.make_input_fns(cfg, data_base.CIFAR10, 9, rt)
    images, labels = next(train_fn())
    assert images.shape[0] == labels.shape[0] == 3


@pytest.mark.parametrize("argv,match", [
    (["--distribution_strategy", "parameter_server", "--ps_mode", "async"],
     "dispatches it to parallel/ps.py run_async before initialize"),
    (["--distribution_strategy", "off", "--process_count", "2",
      "--process_id", "0", "--coordinator_address", "localhost:1"],
     "runs one process"),
    (["--distribution_strategy", "multi_worker_mirrored",
      "--process_count", "2"], "coordinator_address and process_id"),
])
def test_initialize_refuses(argv, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        mesh.initialize(parse_flags(argv + ["--device", "cpu"]))


def test_single_device_runtime_has_no_group():
    for strategy in ("off", "mirrored", "multi_worker_mirrored"):
        rt = mesh.initialize(Config(device="cpu",
                                    distribution_strategy=strategy))
        assert (rt.group, rt.num_replicas, rt.rank) == (None, 1, 0)
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.is_coordinator()
    assert mesh.topology()["num_hosts"] == 1


def test_mirrored_over_many_devices_starts_one_rank_a_device(monkeypatch):
    """With no DTF_* topology and two local devices, a mirrored main
    starts two ranks of itself through the launcher."""
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    calls = []
    monkeypatch.setattr(mesh, "local_device_count", lambda kind: 2)
    monkeypatch.setattr(launch, "launch_local",
                        lambda *a, **kw: calls.append(a) or 0)
    argv = ["--use_synthetic_data", "--device", "cpu", "--train_steps", "1"]
    assert cifar_main.main(argv) == {}
    (cmd, world, coordinator, _), = calls
    assert cmd == [sys.executable, "-m", "dtf_tpu_torch.cli.cifar_main",
                   *argv]
    assert world == 2 and coordinator.startswith("localhost:")
    with pytest.raises(ValueError, match="one process a device"):
        mesh.initialize(parse_flags(argv))
    monkeypatch.setattr(launch, "launch_local", lambda *a, **kw: 7)
    with pytest.raises(SystemExit) as exit_info:
        cifar_main.main(argv)
    assert exit_info.value.code == 7


@pytest.mark.parametrize("option", list(launch.ELASTIC_OPTIONS)
                         + ["--devices_per_process", "--bogus"])
def test_launcher_refuses_supervision_and_unknown_options(option):
    """Elastic resizing is the supervision left unported."""
    match = {"--devices_per_process": "one process a device",
             "--bogus": "unknown launcher option"}.get(
                 option, "elastic resizing")
    with pytest.raises(ValueError, match=match):
        launch.main([option, "1", "--", "true"])


@pytest.mark.parametrize("option", sorted(launch.SUPERVISION_OPTIONS))
def test_launcher_takes_supervision_options(tmp_path, option):
    logs = tmp_path / "logs"
    assert launch.main([option, "1", "--log_dir", str(logs), "--",
                        "true"]) == 0
    events = [json.loads(line) for line in
              (logs / "supervisor_events.jsonl").read_text().splitlines()]
    assert [e["event"] for e in events] == ["attempt_start", "rank_exit",
                                            "job_done"]


def test_cluster_command_generation_matches_jax():
    from dtf_tpu.cli.launch import cluster_commands as jax_cluster_commands
    cmd = ["python", "train.py", "--x", "1"]
    lines = launch.cluster_commands(cmd, ["h1", "h2"], "h1:12346",
                                    "/tmp/logs")
    assert len(lines) == 2
    assert "DTF_PROCESS_ID=0" in lines[0] and "DTF_PROCESS_ID=1" in lines[1]
    assert all("DTF_PROCESS_COUNT=2" in line and line.startswith("ssh h")
               for line in lines)
    assert "log1.log" in lines[1] and lines[1].endswith("&'")
    # one exported trace id: both packages' lines carry it alike
    os.environ["DTF_TRACE_ID"] = "0123456789abcdef"
    try:
        jlines = jax_cluster_commands(cmd, ["h1", "h2"], "h1:12346",
                                      "/tmp/logs", background=False)
        got = launch.cluster_commands(cmd, ["h1", "h2"], "h1:12346",
                                      "/tmp/logs", background=False)
    finally:
        del os.environ["DTF_TRACE_ID"]
    assert jlines == got
    assert all("DTF_TRACE_ID=0123456789abcdef" in line for line in got)


def test_a_failing_rank_takes_the_launcher_down(tmp_path):
    code = ("import os, sys, time\n"
            "if os.environ['DTF_PROCESS_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    rc = launch.launch_local([sys.executable, "-c", code], 2,
                             "localhost:1", str(tmp_path / "logs"),
                             timeout_s=60)
    assert rc == 3
    assert time.monotonic() - t0 < 15
    assert sorted(os.listdir(tmp_path / "logs")) == [
        "log0.log", "log1.log", "supervisor_events.jsonl"]


def test_launcher_kills_ranks_past_its_timeout(tmp_path):
    rc = launch.launch_local([sys.executable, "-c",
                              "import time; time.sleep(120)"], 2,
                             "localhost:1", str(tmp_path / "logs"),
                             timeout_s=1)
    assert rc == 124


# a rank of the two-rank run: cifar_main itself, with the trained model
# kept (the runner hands it over) so the test can evaluate it alone
RANK = r"""
import json, os, sys
import torch
from dtf_tpu_torch.cli import cifar_main, runner
kept = {}
build = runner.build_training
def keep(cfg, rt=None):
    out = build(cfg, rt)
    kept["trainer"] = out[0]
    return out
runner.build_training = keep
stats = cifar_main.main(sys.argv[1:])
rank = os.environ["DTF_PROCESS_ID"]
torch.save(kept["trainer"].model.state_dict(),
           os.path.join(os.environ["OUT_DIR"], "model%s.pt" % rank))
print("STATS=" + json.dumps({k: stats[k] for k in (
    "train_loss_log", "eval_loss", "accuracy_top_1", "eval_count")}))
"""


@pytest.fixture()
def cifar_dir(tmp_path):
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        n = 30 if name == "test_batch.bin" else 20
        cifar.write_binary_file(str(d / name),
                                rng.integers(0, 256, (n, 32, 32, 3)),
                                rng.integers(0, 10, n))
    return str(tmp_path)


def test_two_rank_cifar_main_through_the_launcher(tmp_path, cifar_dir,
                                                  monkeypatch):
    """Both ranks log the same losses; the sharded eval counts each of
    the 30 test examples once and equals one process's eval of the
    trained weights."""
    flags = ["--data_dir", cifar_dir, "--device", "cpu", "--model",
             "resnet20", "--batch_size", "8", "--train_steps", "2",
             "--log_steps", "1", "--distribution_strategy",
             "multi_worker_mirrored", "--seed", "3", "--skip_checkpoint"]
    monkeypatch.setenv("OUT_DIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO)
    logs = tmp_path / "logs"
    rc = launch.launch_local([sys.executable, "-c", RANK] + flags, 2,
                             f"file://{tmp_path / 'rendezvous'}", str(logs),
                             timeout_s=120)
    texts = [(logs / f"log{r}.log").read_text() for r in range(2)]
    assert rc == 0, texts[0][-2000:] + texts[1][-2000:]
    stats = [json.loads(t.split("STATS=")[1].splitlines()[0]) for t in texts]
    assert stats[0] == stats[1]
    assert len(stats[0]["train_loss_log"]) == 2
    assert stats[0]["eval_count"] == 30
    assert "Run stats" in texts[0] and "Run stats" not in texts[1]
    weights = [torch.load(tmp_path / f"model{r}.pt") for r in range(2)]
    for key in weights[0]:
        assert torch.equal(weights[0][key], weights[1][key]), key

    cfg = parse_flags(flags + ["--distribution_strategy", "off"],
                      defaults=cifar_main.CIFAR_DEFAULTS)
    trainer, state, _, eval_fn = runner.build_training(cfg)
    trainer.model.load_state_dict(weights[0])
    loss, top1 = trainer.evaluate(state, eval_fn())
    assert trainer.eval_count == 30
    assert stats[0]["eval_loss"] == pytest.approx(loss, rel=1e-6)
    assert stats[0]["accuracy_top_1"] == pytest.approx(top1, abs=1e-12)


def test_run_synthetic_takes_the_strategy_flags(monkeypatch):
    """The harness parses the strategy flags: horovod at world 1 keeps
    the per-replica batch and trains under horovod's schedule."""
    from dtf_tpu_torch.testing.integration import run_synthetic
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    stats = run_synthetic(runner.run, [
        "--device", "cpu", "--model", "resnet20", "--batch_size", "4",
        "--train_steps", "2", "--log_steps", "1", "--skip_eval",
        "--distribution_strategy", "horovod"],
        defaults=cifar_main.CIFAR_DEFAULTS)
    assert len(stats["train_loss_log"]) == 2
    assert all(np.isfinite(v) for _, v in stats["train_loss_log"])
