"""Serving front-end: router + N replica serve processes.  The PyTorch
counterpart of ``dtf_tpu/cli/router_main.py``, with its HA pair
(``--router_ha``/``--router_standby``, serve/ha.py) and its live
rollout (``--rollout_checkpoint``, serve/rollout.py).

The one-command replica-tier entry: spawns ``--router_replicas``
replica processes (cli/replica_main.py — each a full ServeEngine on
``--device``, which every replica gets; several share one card), stands
up the health-checked router over them (serve/router.py: prefix-affine
placement, deadlines, retry/failover, hedging, respawn budget, and with
``--router_prefill_replicas`` the disaggregated tier), drives it with
synthetic shared-prefix traffic, and reports router + per-replica stats
in the BenchmarkMetric format.

Examples:
  # 2 replicas on the card, fresh params (outputs are noise):
  python -m dtf_tpu_torch.cli.router_main --serve_random_init \
      --model transformer_tpu --router_replicas 2 --serve_requests 16

  # on the CPU, chaos-killing replica 0 at the 6th dispatch (the
  # failover and respawn path, live):
  python -m dtf_tpu_torch.cli.router_main --serve_random_init \
      --device cpu --model transformer_small --router_replicas 2 \
      --fault replica_kill@replica0:req:6

  # disaggregated: replica 0 prefills, replica 1 decodes on migrated
  # pages:
  python -m dtf_tpu_torch.cli.router_main --serve_random_init \
      --model transformer_tpu --router_prefill_replicas 1

  # HA pair on shared storage: the leader journals and holds the lease;
  # the standby takes over (fencing epoch + 1, no replica respawned)
  # when the leader dies:
  python -m dtf_tpu_torch.cli.router_main --serve_random_init \
      --router_ha --rendezvous_dir /shared/tier &
  python -m dtf_tpu_torch.cli.router_main --serve_random_init \
      --router_standby --rendezvous_dir /shared/tier

  # a live rollout onto another export after the first burst, while
  # waves of traffic keep flowing (canary-gated, rolled back on a
  # breach):
  python -m dtf_tpu_torch.cli.router_main --export_dir /ckpt/a \
      --rollout_checkpoint /ckpt/b

The standby, unlike the JAX package's, keeps a spawner: it adopts the
live tier without spawning, but a rollout it resumes replaces replicas.

``--metrics_port N`` makes the tier scrapable: the router's registry on
N, replica K's on N+1+K.  SIGTERM drains the tier: the router sheds new
submits, waits out in-flight work, SIGTERMs the replicas (each drains +
exits 0), then exits 0 itself.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import tempfile
import time

import numpy as np

from dtf_tpu_torch.config import parse_flags

log = logging.getLogger("dtf_tpu_torch")

ROUTER_DEFAULTS = dict(
    model="transformer_small",
    dataset="lm",
    skip_eval=True,
)

# flags forwarded verbatim to every replica process (the engine-shape
# subset: every replica must build the same engine, on the same kind of
# device)
_FORWARD_FLAGS = (
    "model", "num_classes", "seed", "dtype", "device", "model_dir",
    "export_dir", "serve_params_npz",
    "serve_max_batch", "serve_max_seq_len", "serve_queue_size",
    "serve_max_delay_ms", "kv_page_size", "kv_pool_pages",
    "serve_prefill_chunk", "serve_prefix_sharing", "serve_tp",
    "heartbeat_secs", "rendezvous_dir", "serve_host",
)


def replica_command(cfg, random_init: bool) -> list:
    from dtf_tpu_torch.config.flags import Config
    import dataclasses
    defaults = {f.name: f.default for f in dataclasses.fields(Config)}
    cmd = [sys.executable, "-m", "dtf_tpu_torch.cli.replica_main"]
    for name in _FORWARD_FLAGS:
        val = getattr(cfg, name)
        if val is None or val == defaults.get(name):
            continue
        cmd += [f"--{name}", str(val)]
    if random_init:
        cmd.append("--serve_random_init")
    return cmd


def run_router(cfg, random_init: bool = False) -> dict:
    from dtf_tpu_torch.serve import Router
    from dtf_tpu_torch.serve.router import replica_spawner

    if cfg.router_health_timeout_s <= cfg.heartbeat_secs:
        # checked HERE, not in Config: only a router run pairs the two
        raise ValueError(
            f"--router_health_timeout_s ({cfg.router_health_timeout_s}) "
            f"must exceed --heartbeat_secs ({cfg.heartbeat_secs}) or "
            f"every healthy replica reads as dead between beats")
    rendezvous = cfg.rendezvous_dir or tempfile.mkdtemp(
        prefix="dtf_router_")
    cfg = cfg.replace(rendezvous_dir=rendezvous)

    # --- high availability (serve/ha.py + serve/journal.py) ---
    # leader: take the lease, journal every request, renew at ttl/3.
    # standby: wait out the leader's lease, then take over under the
    # next fencing epoch, adopting (never respawning) the live tier.
    ha_on = cfg.router_ha or cfg.router_standby
    ha_mod = lease = keeper = None
    journal_file = None
    epoch = 0
    if ha_on:
        from dtf_tpu_torch.serve import ha as ha_mod
        from dtf_tpu_torch.serve import journal as journal_mod
        journal_file = journal_mod.journal_path(rendezvous)
        lease = ha_mod.LeaderLease(rendezvous,
                                   ttl_s=cfg.router_lease_ttl_s)

    # /healthz must answer DURING the standby's wait (external probes
    # watch the takeover through it), so the payload source is swapped
    # once the router exists
    health_box = {"fn": lambda: {"ok": True, "role": "starting"}}
    metrics_server = None
    router_box: dict = {}
    if cfg.metrics_port:
        from dtf_tpu_torch.obs.prom import MetricsServer
        from dtf_tpu_torch.obs.registry import default_registry
        metrics_server = MetricsServer(
            cfg.metrics_port,
            registry_fn=lambda: (router_box["r"].metrics
                                 if "r" in router_box
                                 else default_registry()),
            health_fn=lambda: health_box["fn"]())

    if cfg.router_standby:
        health_box["fn"] = lambda: ha_mod.standby_health(lease)
        log.warning("standby: watching leader lease (ttl %.1fs) under "
                    "%s", cfg.router_lease_ttl_s, rendezvous)
        epoch = ha_mod.wait_for_takeover(lease)
        log.warning("standby: lease expired — taking over at epoch %d",
                    epoch)
    elif ha_on:
        epoch = lease.acquire()
        if epoch is None:
            if metrics_server is not None:
                metrics_server.shutdown()
            raise RuntimeError(
                "leader lease already held — start this router with "
                "--router_standby (or remove the stale "
                "router_lease.json)")

    env_extra = {}
    if cfg.trace_dir:
        env_extra["DTF_TRACE_DIR"] = os.path.abspath(cfg.trace_dir)
    if cfg.fault:
        env_extra["DTF_FAULT"] = cfg.fault
    # --metrics_port N makes the WHOLE tier scrapable from one flag:
    # the router serves its registry on N, replica K on N+1+K (each is
    # a separate process — one port each), every endpoint with a
    # /healthz probe
    extra_flags = None
    if cfg.metrics_port:
        extra_flags = (lambda rid:
                       ["--metrics_port", str(cfg.metrics_port + 1 + rid)])
    # per-replica checkpoint overrides, shared BY REFERENCE between
    # the router (the rollout controller writes it) and the spawner
    # (reads it at spawn time → DTF_SERVE_CHECKPOINT)
    ckpt_map: dict = {}
    spawn = replica_spawner(replica_command(cfg, random_init),
                            rendezvous, env_extra=env_extra,
                            extra_flags=extra_flags,
                            checkpoint_map=ckpt_map)
    router = Router(
        cfg.router_replicas, rendezvous, spawn=spawn,
        checkpoint_map=ckpt_map,
        journal_path=journal_file,
        journal_fsync_s=cfg.router_journal_fsync_s,
        epoch=epoch or 0,
        role="leader",   # by construction: it holds the lease (HA) or
                         # is the only router (HA off)
        page_size=cfg.kv_page_size or 16,
        placement=cfg.router_placement,
        deadline_s=cfg.router_deadline_s,
        admission_limit=cfg.router_admission,
        probe_interval_s=cfg.router_probe_s,
        health_timeout_s=cfg.router_health_timeout_s,
        replica_inflight=(cfg.router_replica_inflight
                          or cfg.serve_queue_size),
        max_respawns=cfg.router_max_respawns,
        respawn_window_s=cfg.router_respawn_window_s,
        respawn_backoff_s=cfg.router_respawn_backoff_s,
        hedge_s=cfg.router_hedge_s,
        prefill_replicas=cfg.router_prefill_replicas,
        seed=cfg.seed)

    def _on_sigterm(signum, frame):
        router.begin_drain()
        os.write(2, b"router: SIGTERM - draining tier\n")

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass

    router_box["r"] = router
    health_box["fn"] = router.health
    if ha_on:
        # the renewal heartbeat: a lease lost (stall, partition,
        # operator force-take) fences this router on the spot
        keeper = ha_mod.LeaseKeeper(lease, on_fenced=router.fence)
        keeper.start()

    log.info("router: %s %d replicas (rendezvous %s)",
             "adopting" if cfg.router_standby else "spawning",
             cfg.router_replicas, rendezvous)
    # a replica's start (the model, its weights, a warm request, and a
    # kernel build when none is built yet) can take minutes on the CPU;
    # the wait only ends early when every replica heartbeats +
    # announces.  From here on the tier must come down with us — a
    # traffic-loop exception must not leave N serve processes running
    try:
        router.start(wait_s=600.0, adopt=cfg.router_standby)
        adopt_summary = None
        if cfg.router_standby:
            adopt_summary = ha_mod.take_over(
                router, rollout_state_path=cfg.rollout_state)
            log.warning("standby: takeover complete — %s", {
                k: v for k, v in adopt_summary.items()
                if k != "handles"})
        out = _drive_traffic(cfg, router)
        if adopt_summary is not None:
            out["takeover_epoch"] = router.epoch
            out["readopted"] = adopt_summary["readopted"]
            out["redispatched"] = adopt_summary["redispatched"]
        log.info("Router stats: %s", out)
        return out
    except BaseException:
        router.stop(drain=False)
        raise
    finally:
        if keeper is not None:
            keeper.stop()
        if lease is not None:
            lease.release()
        if metrics_server is not None:
            metrics_server.shutdown()


def _drive_traffic(cfg, router) -> dict:
    from dtf_tpu_torch.serve import Backpressure, DeadlineExceeded

    rng = np.random.default_rng(cfg.seed)
    vocab = cfg.num_classes or 32_768
    ps = cfg.kv_page_size or 16
    # shared-prefix traffic: a few "system prompts" (whole pages) with
    # per-request tails — the shape prefix-affine placement exists for
    n_groups = max(1, min(4, cfg.router_replicas))
    sys_prompts = [rng.integers(0, vocab, (2 * ps,)).astype(np.int32)
                   for _ in range(n_groups)]

    def make_prompt(i):
        tail = rng.integers(
            0, vocab, (int(rng.integers(1, cfg.serve_prompt_len + 1)),)
        ).astype(np.int32)
        return np.concatenate([sys_prompts[i % n_groups], tail])

    def resolve(handles, outcomes):
        tokens = 0
        for h in handles:
            try:
                r = h.result(timeout=cfg.router_deadline_s + 30)
                tokens += len(r.tokens)
                outcomes["ok"] += 1
            except Backpressure:
                outcomes["backpressure"] += 1
            except DeadlineExceeded:
                outcomes["deadline"] += 1
        return tokens

    t0 = time.time()
    handles = []
    outcomes = {"ok": 0, "backpressure": 0, "deadline": 0}
    for i in range(cfg.serve_requests):
        try:
            handles.append(router.submit(
                make_prompt(i), max_new_tokens=cfg.serve_max_new_tokens,
                temperature=cfg.serve_temperature))
        except Backpressure:
            outcomes["backpressure"] += 1
    tokens = resolve(handles, outcomes)

    # --rollout_checkpoint: a live mid-traffic rollout — the control-
    # surface op, driven while waves of traffic keep flowing (the
    # canary gate compares MIRRORED LIVE requests, so the rollout
    # needs traffic to judge the new model against)
    rollout_state = None
    if cfg.rollout_checkpoint:
        import threading

        box = {}

        def _roll():
            try:
                box["state"] = router.rollout(
                    cfg.rollout_checkpoint,
                    state_path=cfg.rollout_state,
                    canary_requests=cfg.rollout_canary_requests,
                    mirror_fraction=cfg.rollout_mirror_fraction,
                    max_divergence=cfg.rollout_max_divergence,
                    warm_timeout_s=cfg.rollout_warm_timeout_s)
            except Exception as e:  # noqa: BLE001 — surfaced below
                box["error"] = e

        rt = threading.Thread(target=_roll, name="rollout", daemon=True)
        rt.start()
        wave = 0
        while rt.is_alive():
            hs = []
            for i in range(4):
                try:
                    hs.append(router.submit(
                        make_prompt(wave * 4 + i),
                        max_new_tokens=cfg.serve_max_new_tokens,
                        temperature=cfg.serve_temperature))
                except Backpressure:
                    outcomes["backpressure"] += 1
            tokens += resolve(hs, outcomes)
            wave += 1
            rt.join(timeout=0.25)
        if "error" in box:
            raise box["error"]
        rollout_state = box.get("state")
        log.warning("rollout finished: %s",
                    rollout_state.phase if rollout_state else "?")
    wall = time.time() - t0

    out = {
        "requests": cfg.serve_requests,
        "completed": outcomes["ok"],
        "backpressure": outcomes["backpressure"],
        "deadline_exceeded": outcomes["deadline"],
        "tokens_per_second": tokens / wall if wall > 0 else 0.0,
        "replicas": cfg.router_replicas,
        "failovers": router.metrics.get("router_failover_total").value,
        "respawns": router.metrics.get("router_replica_respawns_total").value,
        "affinity_hits": router.metrics.get(
            "router_affinity_hits_total").value,
        "migrations": router.migration_stats(),
        "per_replica_completed": [
            router.replica_completed(i)
            for i in range(cfg.router_replicas)],
    }
    if rollout_state is not None:
        out["rollout_phase"] = rollout_state.phase
        out["rollout_reason"] = rollout_state.reason
        out["canary_compared"] = rollout_state.compared
        out["canary_diverged"] = rollout_state.diverged
    if cfg.benchmark_log_dir:
        import torch

        from dtf_tpu_torch.utils.benchmark_logger import BenchmarkFileLogger
        blog = BenchmarkFileLogger(cfg.benchmark_log_dir)
        blog.log_run_info(cfg.model, cfg.dataset, cfg.to_dict(),
                          torch.device(cfg.device),
                          test_id=cfg.benchmark_test_id)
        blog.log_registry(router.metrics)
    router.stop(drain=True)
    return out


def main(argv=None) -> dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    argv = list(argv if argv is not None else sys.argv[1:])
    random_init = "--serve_random_init" in argv
    if random_init:
        argv.remove("--serve_random_init")
    cfg = parse_flags(argv, defaults=ROUTER_DEFAULTS)
    if cfg.device.split(":")[0] == "cuda":
        # every replica serves on the card: refuse here, before N
        # processes each find no CUDA and crash-loop the respawn budget
        from dtf_tpu_torch.runtime.device import resolve_device
        resolve_device(cfg.device)
    from dtf_tpu_torch import chaos
    from dtf_tpu_torch.obs import trace
    if cfg.trace_dir:
        # the router is a NAMED stream: trace_router.jsonl next to the
        # replicas' trace_rank{K}.jsonl — trace_main --merge interleaves
        trace.configure(cfg.trace_dir, stream="router")
    # replica_kill / net_partition / router_kill / lease_stall /
    # rollout_kill fire here
    chaos.maybe_configure(cfg)
    return run_router(cfg, random_init=random_init)


if __name__ == "__main__":
    main()
