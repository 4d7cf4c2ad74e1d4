"""Replica serve process — one ServeEngine behind the router's wire.
The PyTorch counterpart of ``dtf_tpu/cli/replica_main.py``.

The serving router (cli/router_main.py, serve/router.py) spawns N of
these; several may share one card.  Each serves on ``--device`` (default
``cuda``; with no CUDA it raises unless ``--device cpu`` is given).  Each builds the same model the same way (same ``--seed``, same
checkpoint), so greedy decode is replica-interchangeable: the router
can re-dispatch an in-flight request to a sibling — or to this
replica's own respawn — and get token-identical output.

Identity and rendezvous are environment + files, launcher-style:

  DTF_PROCESS_ID / --replica_id   which replica this is
  --rendezvous_dir                where to announce (replica_rank{K}
                                  .json: ephemeral port + pid) and
                                  where heartbeats go
  DTF_HEARTBEAT_DIR               exported by the router's spawner;
                                  the ENGINE LOOP rewrites
                                  heartbeat_rank{K}.json every
                                  iteration — the router's health
                                  probe (and launch.py's hang
                                  watchdog) read that, never the
                                  socket
  DTF_RESTART_GENERATION          respawn generation (stamped into the
                                  announce file)
  DTF_SERVE_CHECKPOINT            checkpoint override (a model_dir or
                                  export_dir path): serve THIS instead
                                  of the flag-configured checkpoint
                                  (``--serve_params_npz`` included) —
                                  the rollout controller's lever for
                                  restarting one replica at a time
                                  onto a new model (serve/rollout.py)
  --serve_host                    address to bind AND announce; a
                                  routable address + a shared
                                  rendezvous dir puts this replica
                                  behind a router on another host
  DTF_FAULT                       chaos passthrough: a
                                  slow_replica@replica<K> spec fires
                                  here when K == DTF_PROCESS_ID, a
                                  page_fetch_stall@replica<K> in its
                                  migration client

SIGTERM drains: admissions shed with retry_after, in-flight finishes,
exit 0 — a drained replica is a clean exit the router's respawn budget
never sees.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading

from dtf_tpu_torch.config import parse_flags

log = logging.getLogger("dtf_tpu_torch")

REPLICA_DEFAULTS = dict(
    model="transformer_small",
    dataset="lm",
    skip_eval=True,
)


def run_replica(cfg, random_init: bool = False,
                ready_event: "threading.Event" = None) -> int:
    """Build the engine, serve the wire until SIGTERM.  Library entry
    (tests drive it in-process with ready_event)."""
    from dtf_tpu_torch.cli.serve_main import build_serving_engine
    from dtf_tpu_torch.serve.replica import ReplicaServer

    replica_id = cfg.replica_id
    if replica_id < 0:
        replica_id = int(os.environ.get("DTF_PROCESS_ID", "0"))
    if not cfg.rendezvous_dir:
        raise ValueError("--rendezvous_dir is required (the router's "
                         "announce/heartbeat rendezvous)")
    ckpt = os.environ.get("DTF_SERVE_CHECKPOINT", "")
    if ckpt:
        # rollout override: serve THIS checkpoint and nothing else (the
        # flax npz the tier may have started from would otherwise win:
        # the bridge reads it first).  An export artifact has a model/
        # subdir; anything else is a train model_dir
        if os.path.isdir(os.path.join(ckpt, "model")):
            cfg = cfg.replace(export_dir=ckpt, model_dir="",
                              serve_params_npz="")
        else:
            cfg = cfg.replace(model_dir=ckpt, export_dir="",
                              serve_params_npz="")
        random_init = False
        log.warning("replica %d: serving rollout checkpoint %s "
                    "(DTF_SERVE_CHECKPOINT)", replica_id, ckpt)
    _, engine = build_serving_engine(cfg, random_init=random_init,
                                     replica_rank=replica_id)
    # warm BEFORE announcing: the first request through a cold engine
    # builds the kernels when no library is built yet, and counts the
    # decode step and its chunk length under the MFU ledger's FLOP
    # counter, during which the engine loop — and therefore its
    # heartbeat — stalls.  A replica that announces cold reads as dead
    # to the router's health probe the moment traffic arrives; one that
    # warms first serves its first real request at steady-state
    # latency.  (Other chunk lengths are still counted on first use;
    # the router's health timeout absorbs those shorter stalls.)
    import numpy as np
    page = cfg.kv_page_size or 16
    warm = np.full((min(page, engine.max_seq_len - 2),), 1, np.int32)
    engine.submit(warm, max_new_tokens=2).result(timeout=600)
    log.info("replica %d: warm", replica_id)
    done = threading.Event()

    def _stop():
        # async-signal-minimal: one lock-free engine call + one event
        engine.begin_drain()
        done.set()

    # an adopting router on another host cannot signal this process:
    # its epoch-fenced stop op does what SIGTERM does
    server = ReplicaServer(engine, replica_id, cfg.rendezvous_dir,
                           host=cfg.serve_host, on_stop=_stop)

    # --metrics_port: this replica's engine registry (queue depth,
    # prefix hits, decode-step MFU ledger gauges) as a live Prometheus
    # scrape + a /healthz probe (503 once draining).  Each replica is
    # its own process/port; router_main fans out base+1+K
    metrics_server = None
    if cfg.metrics_port:
        from dtf_tpu_torch.obs.prom import MetricsServer
        metrics_server = MetricsServer(
            cfg.metrics_port, registry_fn=lambda: engine.metrics,
            health_fn=lambda: {"ok": not engine.draining,
                               "replica": replica_id,
                               "draining": engine.draining,
                               "outstanding": engine.outstanding})

    def _on_sigterm(signum, frame):
        _stop()
        os.write(2, b"replica: SIGTERM - draining\n")

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:   # not the main thread (in-process tests)
        pass

    server.start()
    if ready_event is not None:
        ready_event.set()
    log.info("replica %d: ready on port %d", replica_id, server.port)
    try:
        done.wait()
        # drain: wait out queued + in-flight work, then leave cleanly
        engine.stop(drain=True)
    finally:
        server.stop()
        if metrics_server is not None:
            metrics_server.shutdown()
    log.info("replica %d: drained — exiting 0", replica_id)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    argv = list(argv if argv is not None else sys.argv[1:])
    random_init = "--serve_random_init" in argv
    if random_init:
        argv.remove("--serve_random_init")
    cfg = parse_flags(argv, defaults=REPLICA_DEFAULTS)
    from dtf_tpu_torch import chaos
    from dtf_tpu_torch.obs import trace
    trace.maybe_configure(cfg)
    chaos.maybe_configure(cfg)   # slow_replica / heartbeat_stall
    return run_replica(cfg, random_init=random_init)


if __name__ == "__main__":
    sys.exit(main())
