"""Multi-process launcher and supervisor -- the PyTorch counterpart of
``dtf_tpu/cli/launch.py``: one command starts every rank of a
data-parallel run, each told its place by the environment, and
restarts the whole job when a rank fails.  It also starts the async
parameter server (``--ps_mode async``): rank 0 serves the store on the
coordinator's port and ranks 1..N are its workers.

Local fan-out (every rank on this host: one rank a GPU, or gloo ranks on
the CPU):

    python -m dtf_tpu_torch.cli.launch --num_processes 2 -- \\
        python -m dtf_tpu_torch.cli.cifar_main --distribution_strategy \\
        multi_worker_mirrored --device cpu ...

Supervised, resuming from checkpoints after a crash or a preemption:

    python -m dtf_tpu_torch.cli.launch --max_restarts 2 -- \\
        python -m dtf_tpu_torch.cli.lm_main --model_dir /ckpt --resume \\
        --checkpoint_steps 100 ...

Cluster fan-out (prints -- or runs with ``--execute`` over ssh -- one
command per host; one rank a host):

    python -m dtf_tpu_torch.cli.launch --hosts h1,h2 -- \\
        python -m dtf_tpu_torch.cli.imagenet_main ...

Each rank gets ``DTF_COORDINATOR`` (the rendezvous: ``host:port``, or a
URL such as ``file:///shared/rendezvous``), ``DTF_PROCESS_ID``,
``DTF_PROCESS_COUNT``, the job's trace id ``DTF_TRACE_ID`` (one for
every rank and restart), ``DTF_HEARTBEAT_DIR`` and
``DTF_RESTART_GENERATION``; ``DTF_FAULT`` and ``DTF_TRACE_DIR`` pass
through from the launcher's environment.  A local rank's output goes to
``<log_dir>/log{rank}.log`` (``log{rank}.retry{N}.log`` for restart N),
and, unless the environment sets it, ``OMP_NUM_THREADS`` shares the
host's cores among the ranks (CPU ranks that each take every core run
many times slower).

Supervision (``launch_local``): when a rank fails, the others get
SIGTERM (the training mains write an emergency checkpoint at their next
step boundary) and SIGKILL after ``--teardown_grace``.  A rank exiting
``EXIT_PREEMPTED`` (75) is restarted without spending the crash budget
(capped by ``--max_preemptions``); any other failure is a crash,
budgeted ``--max_restarts`` per sliding ``--restart_window`` with
exponential ``--restart_backoff``.  With ``--heartbeat_timeout``, a rank
whose heartbeat file (``obs/watchdog.py``) -- or, before its first
beat, its log -- stays still that long after ``--startup_grace`` is
killed as a lost host.  A restart relaunches every rank with a fresh
rendezvous: a new free port, or a new ``file://`` store path, never a
stale store; an async PS job's restarted workers reach its restarted
store at the new port, and its snapshot carries the training state
across (``parallel/ps.py``, with ``DTF_RESTART_GENERATION`` telling the
store's rank to discard the done count of the attempt before).  Every
decision lands in ``<log_dir>/supervisor_events.jsonl``.
Elastic resizing (``--elastic``, ``--min_devices``, ``--max_elastic``)
is not ported yet.
"""

from __future__ import annotations

import collections
import json
import os
import shlex
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

# standard library only: chaos and obs.watchdog import no torch
from dtf_tpu_torch.chaos import EXIT_DEVICE_LOST, EXIT_PREEMPTED
from dtf_tpu_torch.obs.watchdog import (HEARTBEAT_DIR_ENV, heartbeat_path,
                                        read_heartbeat)

# the JAX launcher's elastic options (train/elastic.py is not ported)
ELASTIC_OPTIONS = ("--elastic", "--min_devices", "--max_elastic")
# the supervision options that take a value, with their launch_local names
SUPERVISION_OPTIONS = {
    "--max_restarts": ("max_restarts", int),
    "--heartbeat_timeout": ("heartbeat_timeout", float),
    "--startup_grace": ("startup_grace", float),
    "--restart_window": ("restart_window_s", float),
    "--restart_backoff": ("restart_backoff_s", float),
    "--max_preemptions": ("max_preemptions", int),
    "--teardown_grace": ("teardown_grace", float),
}


def classify_exit(rc: int) -> str:
    if rc == 0:
        return "ok"
    if rc == EXIT_PREEMPTED:
        return "preempted"
    if rc == EXIT_DEVICE_LOST:
        return "device_loss"
    return "crash"


class SupervisorEventLog:
    """Append-only ``supervisor_events.jsonl`` in the log dir: one JSON
    record per supervision decision (rank exits with classification,
    heartbeat kills, restarts with backoff and budget state, give-ups).
    Best-effort: a full disk must not take down the supervisor with the
    job."""

    def __init__(self, log_dir: str):
        self.path = os.path.join(log_dir, "supervisor_events.jsonl")

    def emit(self, event: str, **attrs) -> None:
        rec = {"ts": time.time(), "event": event}
        rec.update(attrs)
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass


def build_env(rank: int, world: int, coordinator: str,
              heartbeat_dir: Optional[str] = None, generation: int = 0,
              trace_id: Optional[str] = None) -> dict:
    env = dict(os.environ)
    env["DTF_COORDINATOR"] = coordinator
    env["DTF_PROCESS_ID"] = str(rank)
    env["DTF_PROCESS_COUNT"] = str(world)
    env["DTF_RESTART_GENERATION"] = str(generation)
    if trace_id:
        # the job's id is authoritative: a stale DTF_TRACE_ID in the
        # launcher's environment was folded in when the job minted it
        env["DTF_TRACE_ID"] = trace_id
    if heartbeat_dir:
        env[HEARTBEAT_DIR_ENV] = os.path.abspath(heartbeat_dir)
    return env


def free_address() -> str:
    """``localhost:<port>`` of a port free at the time of asking."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def _async_ps(cmd: List[str]) -> bool:
    """True when ``cmd`` runs the async parameter server."""
    for i, tok in enumerate(cmd):
        name, eq, val = tok.lstrip("-").partition("=")
        if name == "ps_mode" and tok.startswith("-"):
            val = val if eq else (cmd[i + 1] if i + 1 < len(cmd) else "")
            if val == "async":
                return True
    return False


def fresh_rendezvous(coordinator: str, attempt: int) -> str:
    """The rendezvous of ``attempt``: the given one first; for a
    restart, a ``file://`` store gets a path of its own and a TCP one a
    newly free local port -- a restart must never meet the store (or
    the half-closed port) of the attempt it replaces."""
    if not attempt:
        return coordinator
    if coordinator.startswith("file://"):
        return f"{coordinator}.{attempt}"
    return free_address()


def _run_once(cmd: List[str], num_processes: int, coordinator: str,
              log_dir: str, attempt: int, events: SupervisorEventLog,
              trace_id: str, heartbeat_timeout: Optional[float],
              startup_grace: float, teardown_grace: float,
              deadline: Optional[float]):
    """One attempt: start every rank, watch them, tear down on the first
    failure.  Returns (rc, classification): the first failing rank's
    code and class ("host_loss" for a heartbeat kill or an unprompted
    SIGKILL), or 124 and "timeout" past ``deadline``."""
    events.emit("attempt_start", attempt=attempt, ranks=num_processes,
                coordinator=coordinator)
    suffix = f".retry{attempt}" if attempt else ""
    log_path = lambda rank: os.path.join(log_dir, f"log{rank}{suffix}.log")
    procs, logs = [], []
    rc, first_cls = 0, "ok"
    term_at: Optional[float] = None
    # ranks this supervisor SIGKILLed (heartbeat loss, teardown): their
    # SIGKILL exit is not an unprompted one
    hb_killed: set = set()
    td_killed: set = set()
    # liveness: a rank's heartbeat file advancing, or -- before its
    # first beat only -- its log growing (a log that grows from a side
    # thread while the training thread is stuck is no sign of life)
    sizes = [0] * num_processes
    hb_ts = [None] * num_processes
    hb_mtime = [None] * num_processes
    last_beat = [0.0] * num_processes
    spawned = [0.0] * num_processes
    try:
        for rank in range(num_processes):
            # a heartbeat surviving the previous attempt must not pass
            # for this attempt's first beat
            try:
                os.unlink(heartbeat_path(log_dir, rank))
            except OSError:
                pass
            f = open(log_path(rank), "wb")
            logs.append(f)
            env = build_env(rank, num_processes, coordinator,
                            heartbeat_dir=log_dir, generation=attempt,
                            trace_id=trace_id)
            env.setdefault("OMP_NUM_THREADS", str(max(
                1, len(os.sched_getaffinity(0)) // num_processes)))
            procs.append((rank, subprocess.Popen(
                cmd, env=env, stdout=f, stderr=subprocess.STDOUT)))
            last_beat[rank] = spawned[rank] = time.monotonic()
        while procs:
            now = time.monotonic()
            for rank, p in list(procs):
                ret = p.poll()
                if ret is None:
                    if heartbeat_timeout and rank not in hb_killed:
                        path = heartbeat_path(log_dir, rank)
                        try:
                            mt = os.stat(path).st_mtime
                        except OSError:
                            mt = hb_mtime[rank]
                        if mt != hb_mtime[rank]:
                            hb_mtime[rank] = mt
                            hb = read_heartbeat(path)
                            if hb is not None and hb.get("ts") != hb_ts[rank]:
                                hb_ts[rank] = hb.get("ts")
                                last_beat[rank] = now
                        try:
                            sz = os.path.getsize(log_path(rank))
                        except OSError:
                            sz = sizes[rank]
                        if sz != sizes[rank]:
                            sizes[rank] = sz
                            if hb_ts[rank] is None:
                                last_beat[rank] = now
                        if (now - last_beat[rank] > heartbeat_timeout
                                and now - spawned[rank] > startup_grace):
                            print(f"rank {rank} heartbeat lost "
                                  f"({heartbeat_timeout:.0f}s without "
                                  f"{'a heartbeat' if hb_ts[rank] else 'log output'}"
                                  f"); killing", file=sys.stderr)
                            events.emit("heartbeat_lost", attempt=attempt,
                                        rank=rank,
                                        timeout_s=heartbeat_timeout)
                            hb_killed.add(rank)
                            p.kill()
                    continue
                procs.remove((rank, p))
                cls = classify_exit(ret)
                if rank in hb_killed or (ret == -signal.SIGKILL
                                         and rank not in td_killed):
                    # silence, or a SIGKILL nobody here sent: the
                    # rank-exit pattern of a lost host
                    cls = "host_loss"
                events.emit("rank_exit", attempt=attempt, rank=rank,
                            code=ret, classification=cls,
                            log=log_path(rank))
                if ret != 0 and rc == 0:
                    rc, first_cls = ret, cls
                    print(f"rank {rank} exited {ret} ({cls}; see "
                          f"{log_path(rank)}); tearing down",
                          file=sys.stderr)
                    # SIGTERM first, so the mains write an emergency
                    # checkpoint; SIGKILL after teardown_grace below
                    for _, q in procs:
                        q.send_signal(signal.SIGTERM)
                    term_at = now
            if (term_at is not None and procs
                    and now - term_at > teardown_grace):
                for r2, q in procs:
                    print(f"rank {r2} still alive {teardown_grace:.0f}s "
                          f"after teardown SIGTERM; killing",
                          file=sys.stderr)
                    events.emit("teardown_kill", attempt=attempt, rank=r2,
                                grace_s=teardown_grace)
                    td_killed.add(r2)
                    q.kill()
                term_at = None
            if procs and deadline is not None and now > deadline:
                print("ranks still running past the launcher's timeout; "
                      "killing", file=sys.stderr)
                for r2, q in procs:
                    td_killed.add(r2)
                    q.kill()
                    q.wait()
                events.emit("timeout", attempt=attempt)
                return 124, "timeout"
            time.sleep(0.05)
    finally:
        for _, q in procs:
            q.kill()
            q.wait()
        for f in logs:
            f.close()
    return rc, first_cls


def launch_local(cmd: List[str], num_processes: int, coordinator: str,
                 log_dir: str, timeout_s: Optional[float] = None,
                 max_restarts: int = 0,
                 heartbeat_timeout: Optional[float] = None,
                 startup_grace: float = 300.0,
                 restart_window_s: float = 3600.0,
                 restart_backoff_s: float = 1.0,
                 max_preemptions: int = 100,
                 teardown_grace: float = 60.0) -> int:
    """Run ``cmd`` as ``num_processes`` ranks on this host, supervised.

    On any rank failing (or hanging, with ``heartbeat_timeout``), tear
    down and relaunch ALL ranks: the recovery unit of synchronous data
    parallelism is the whole job, its progress carried by checkpoints
    (pair the command with ``--resume``).  Exit classification drives
    the policy:

      preempted (EXIT_PREEMPTED, 75) -- the rank wrote a sealed
          emergency checkpoint: relaunch at once, without spending the
          crash budget (capped by ``max_preemptions``).  Only when
          supervision was asked for (``max_restarts`` > 0 or a
          ``heartbeat_timeout``): an unsupervised launch whose operator
          SIGTERMs it must stop, not resurrect itself.
      crash (any other failure: a nonzero exit, death by a signal, a
          lost host, a lost device) -- ``max_restarts`` per sliding
          ``restart_window_s``, with backoff ``restart_backoff_s ×
          2^(n-1)`` before relaunching.

    Returns 0, or the failing attempt's code once the policy gives up;
    past ``timeout_s`` (over all attempts) every rank is killed and 124
    returned."""
    if coordinator.startswith("file://") and _async_ps(cmd):
        # rank 0 of an async parameter server serves the store on the
        # coordinator's TCP port, and its workers connect there
        raise ValueError(
            f"--ps_mode async needs a host:port coordinator (rank 0 "
            f"binds its port for the parameter store), not "
            f"{coordinator!r}")
    os.makedirs(log_dir, exist_ok=True)
    events = SupervisorEventLog(log_dir)
    trace_id = os.environ.get("DTF_TRACE_ID") or os.urandom(8).hex()
    supervising = bool(max_restarts) or heartbeat_timeout is not None
    deadline = (time.monotonic() + timeout_s if timeout_s is not None
                else None)
    attempt = preemptions = 0
    crash_times: collections.deque = collections.deque()
    while True:
        rc, cls = _run_once(
            cmd, num_processes, fresh_rendezvous(coordinator, attempt),
            log_dir, attempt, events, trace_id, heartbeat_timeout,
            startup_grace, teardown_grace, deadline)
        if rc == 0:
            events.emit("job_done", attempts=attempt)
            return 0
        if cls == "timeout":
            return rc
        if cls == "preempted":
            if not supervising:
                events.emit("give_up", code=rc, classification=cls,
                            reason="unsupervised")
                print("job preempted; not supervising (no --max_restarts/"
                      "--heartbeat_timeout) -- exiting", file=sys.stderr)
                return rc
            preemptions += 1
            if preemptions > max_preemptions:
                events.emit("give_up", code=rc, classification=cls,
                            preemptions=preemptions,
                            max_preemptions=max_preemptions)
                print(f"giving up: {preemptions} preemptions exceed "
                      f"--max_preemptions {max_preemptions}",
                      file=sys.stderr)
                return rc
            attempt += 1
            events.emit("restart", classification=cls, restart=attempt,
                        backoff_s=0.0, preemptions=preemptions,
                        crashes_in_window=len(crash_times),
                        budget=max_restarts)
            print(f"relaunching all {num_processes} ranks after "
                  f"preemption (restart {attempt}; crash budget "
                  f"untouched)", file=sys.stderr)
            continue
        now = time.monotonic()
        while crash_times and now - crash_times[0] > restart_window_s:
            crash_times.popleft()
        if len(crash_times) >= max_restarts:
            events.emit("give_up", code=rc, classification=cls,
                        crashes_in_window=len(crash_times),
                        window_s=restart_window_s, budget=max_restarts)
            return rc
        crash_times.append(now)
        backoff = restart_backoff_s * (2.0 ** (len(crash_times) - 1))
        attempt += 1
        events.emit("restart", classification=cls, restart=attempt,
                    backoff_s=backoff, crashes_in_window=len(crash_times),
                    window_s=restart_window_s, budget=max_restarts)
        print(f"relaunching all {num_processes} ranks (crash "
              f"{len(crash_times)}/{max_restarts} in window; backoff "
              f"{backoff:.1f}s)", file=sys.stderr)
        if backoff > 0:
            time.sleep(backoff)


def cluster_commands(cmd: List[str], hosts: List[str], coordinator: str,
                     log_dir: str, background: bool = True) -> List[str]:
    """One ssh line per host -- the reference's run.sh loop, generated.
    ``background`` appends ``&`` for copy-paste; ``--execute`` passes
    False, so each ssh blocks until its rank exits.  Every host's rank
    gets the job's one trace id."""
    world = len(hosts)
    quoted = " ".join(shlex.quote(c) for c in cmd)
    trace_id = os.environ.get("DTF_TRACE_ID") or os.urandom(8).hex()
    lines = []
    for rank, host in enumerate(hosts):
        envs = (f"DTF_COORDINATOR={coordinator} DTF_PROCESS_ID={rank} "
                f"DTF_PROCESS_COUNT={world} DTF_TRACE_ID={trace_id}")
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
    supervision: dict = {}
    i = 0
    while i < len(opts):
        o = opts[i]
        if o in ELASTIC_OPTIONS:
            raise ValueError(
                f"{o}: elastic resizing (train/elastic.py) is not ported "
                f"to dtf_tpu_torch yet (ROADMAP.md, Queue 1 item 5)")
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
        elif o in SUPERVISION_OPTIONS:
            name, kind = SUPERVISION_OPTIONS[o]
            supervision[name] = kind(val)
        else:
            raise ValueError(f"unknown launcher option {o}")
        i += 2

    if hosts:
        if num_processes != 1:
            raise ValueError("--hosts runs one rank per host; "
                             "--num_processes is not supported with it")
        if supervision:
            raise ValueError(
                f"{', '.join(sorted(SUPERVISION_OPTIONS))} supervise local "
                f"fan-out; for --hosts runs, supervise on each host")
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
    # an unset startup grace follows an explicit, shorter heartbeat
    # timeout downward (the JAX launcher's rule)
    if "startup_grace" not in supervision and supervision.get(
            "heartbeat_timeout"):
        supervision["startup_grace"] = min(
            supervision["heartbeat_timeout"], 300.0)
    return launch_local(cmd, num_processes, coordinator or free_address(),
                        log_dir, **supervision)


if __name__ == "__main__":
    sys.exit(main())
