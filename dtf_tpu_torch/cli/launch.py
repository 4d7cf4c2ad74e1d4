"""Multi-process launcher -- the PyTorch counterpart of
``dtf_tpu/cli/launch.py``: one command starts every rank of a
data-parallel run, each told its place by the environment.

Local fan-out (every rank on this host: one rank a GPU, or gloo ranks on
the CPU):

    python -m dtf_tpu_torch.cli.launch --num_processes 2 -- \\
        python -m dtf_tpu_torch.cli.cifar_main --distribution_strategy \\
        multi_worker_mirrored --device cpu ...

Cluster fan-out (prints -- or runs with ``--execute`` over ssh -- one
command per host; one rank a host):

    python -m dtf_tpu_torch.cli.launch --hosts h1,h2 -- \\
        python -m dtf_tpu_torch.cli.imagenet_main ...

Each rank gets ``DTF_COORDINATOR`` (the rendezvous: ``host:port``, or a
URL such as ``file:///shared/rendezvous``), ``DTF_PROCESS_ID`` and
``DTF_PROCESS_COUNT``; ``config/flags.py`` reads them.  A local rank's
output goes to ``<log_dir>/log{rank}.log``, and, unless the environment
sets it, ``OMP_NUM_THREADS`` shares the host's cores among the ranks (as
``torchrun`` does: CPU ranks that each take every core run many times
slower).  When one rank fails, the others are terminated (SIGTERM, then
SIGKILL after ``TEARDOWN_GRACE_S``) and the launcher exits with the
first failing rank's code.

Supervision -- restarts, heartbeats, elastic resizing -- resumes from
checkpoints, which are not ported yet: those options raise.
"""

from __future__ import annotations

import os
import shlex
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

TEARDOWN_GRACE_S = 10.0
# the JAX launcher's supervision options (dtf_tpu/cli/launch.py main)
SUPERVISION_OPTIONS = ("--max_restarts", "--heartbeat_timeout",
                       "--startup_grace", "--restart_window",
                       "--restart_backoff", "--max_preemptions",
                       "--teardown_grace", "--elastic", "--min_devices",
                       "--max_elastic")


def build_env(rank: int, world: int, coordinator: str) -> dict:
    env = dict(os.environ)
    env["DTF_COORDINATOR"] = coordinator
    env["DTF_PROCESS_ID"] = str(rank)
    env["DTF_PROCESS_COUNT"] = str(world)
    return env


def free_address() -> str:
    """``localhost:<port>`` of a port free at the time of asking."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def launch_local(cmd: List[str], num_processes: int, coordinator: str,
                 log_dir: str, timeout_s: Optional[float] = None) -> int:
    """Run ``cmd`` as ``num_processes`` ranks on this host and wait for
    them.  Returns 0, or the first failing rank's exit code after the
    others are torn down; past ``timeout_s`` every rank is killed and
    124 returned."""
    os.makedirs(log_dir, exist_ok=True)
    procs, logs = [], []
    rc = 0
    term_at: Optional[float] = None
    t0 = time.monotonic()
    try:
        for rank in range(num_processes):
            f = open(os.path.join(log_dir, f"log{rank}.log"), "wb")
            logs.append(f)
            env = build_env(rank, num_processes, coordinator)
            env.setdefault("OMP_NUM_THREADS", str(max(
                1, len(os.sched_getaffinity(0)) // num_processes)))
            procs.append((rank, subprocess.Popen(
                cmd, env=env, stdout=f, stderr=subprocess.STDOUT)))
        while procs:
            for rank, p in list(procs):
                ret = p.poll()
                if ret is None:
                    continue
                procs.remove((rank, p))
                if ret != 0 and rc == 0:
                    rc = ret
                    print(f"rank {rank} exited {ret} (see "
                          f"{os.path.join(log_dir, f'log{rank}.log')}); "
                          f"tearing down", file=sys.stderr)
                    for _, q in procs:
                        q.send_signal(signal.SIGTERM)
                    term_at = time.monotonic()
            now = time.monotonic()
            if procs and timeout_s is not None and now - t0 > timeout_s:
                print(f"ranks still running after {timeout_s:.0f}s; "
                      f"killing", file=sys.stderr)
                for _, q in procs:
                    q.kill()
                rc = rc or 124
                term_at = None
            if (term_at is not None and procs
                    and now - term_at > TEARDOWN_GRACE_S):
                for _, q in procs:
                    q.kill()
                term_at = None
            time.sleep(0.05)
    finally:
        for _, q in procs:
            q.kill()
            q.wait()
        for f in logs:
            f.close()
    return rc


def cluster_commands(cmd: List[str], hosts: List[str], coordinator: str,
                     log_dir: str, background: bool = True) -> List[str]:
    """One ssh line per host -- the reference's run.sh loop, generated.
    ``background`` appends ``&`` for copy-paste; ``--execute`` passes
    False, so each ssh blocks until its rank exits."""
    world = len(hosts)
    quoted = " ".join(shlex.quote(c) for c in cmd)
    lines = []
    for rank, host in enumerate(hosts):
        envs = (f"DTF_COORDINATOR={coordinator} DTF_PROCESS_ID={rank} "
                f"DTF_PROCESS_COUNT={world}")
        logfile = shlex.quote(f"{log_dir}/log{rank}.log")
        remote = (f"mkdir -p {shlex.quote(log_dir)} && {envs} {quoted} "
                  f"> {logfile} 2>&1")
        if background:
            remote += " &"
        lines.append(f"ssh {host} {shlex.quote(remote)}")
    return lines


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print(__doc__)
        return 2
    split = argv.index("--")
    opts, cmd = argv[:split], argv[split + 1:]
    num_processes, coordinator = 1, None
    hosts: List[str] = []
    log_dir = "./ranklogs"
    execute = False
    i = 0
    while i < len(opts):
        o = opts[i]
        if o in SUPERVISION_OPTIONS:
            raise ValueError(
                f"{o}: supervised restarts resume from checkpoints, which "
                f"are not ported to dtf_tpu_torch yet (ROADMAP.md, Queue 1 "
                f"item 4)")
        if o == "--devices_per_process":
            raise ValueError(
                "--devices_per_process: dtf_tpu_torch runs one process a "
                "device; start one rank a device with --num_processes")
        if o == "--execute":
            execute = True
            i += 1
            continue
        if i + 1 >= len(opts):
            raise ValueError(f"launcher option {o} needs a value")
        val = opts[i + 1]
        if o == "--num_processes":
            num_processes = int(val)
        elif o == "--coordinator":
            coordinator = val
        elif o == "--hosts":
            hosts = [h.strip() for h in val.split(",") if h.strip()]
        elif o == "--log_dir":
            log_dir = val
        else:
            raise ValueError(f"unknown launcher option {o}")
        i += 2

    if hosts:
        if num_processes != 1:
            raise ValueError("--hosts runs one rank per host; "
                             "--num_processes is not supported with it")
        lines = cluster_commands(cmd, hosts,
                                 coordinator or f"{hosts[0]}:12346",
                                 log_dir, background=not execute)
        if not execute:
            print("\n".join(lines))
            return 0
        running = [subprocess.Popen(line, shell=True) for line in lines]
        rc = 0
        for rank, p in enumerate(running):
            ret = p.wait()
            if ret:
                print(f"host rank {rank} exited {ret}", file=sys.stderr)
                rc = rc or ret
        return rc
    return launch_local(cmd, num_processes, coordinator or free_address(),
                        log_dir)


if __name__ == "__main__":
    sys.exit(main())
