"""The trace vocabulary -- the single source of the event and anomaly
kinds the port's subsystems emit.

A copy of ``dtf_tpu/obs/vocab.py`` (the port imports nothing of
dtf_tpu): every record kind emitted through
:mod:`dtf_tpu_torch.obs.trace` is registered here, and
``cli/trace_main.py`` validates its ``--allow <kind>`` arguments
against it (a typo'd --allow that silently tolerates nothing is the bug
an expected-anomaly list invites).  The registry is the JAX package's
whole vocabulary, kinds of subsystems not ported yet included, so a
trace of either package reads against the same names.

Dependency-free: trace_main needs it importable in a cold process.
"""

from __future__ import annotations

#: anomaly kinds the subsystems emit (docs for --allow; unknown kinds
#: only warn at trace_main — forward compatibility beats a stale
#: registry)
KNOWN_ANOMALY_KINDS = (
    "nan_loss", "step_time_regression", "reader_lag", "serve_shed",
    "ckpt_integrity", "injected_fault",
    # serving replica tier (dtf_tpu/serve/router.py)
    "router_shed", "replica_lost", "replica_give_up",
    "redispatch_divergence", "router_deadline", "mixed_model",
    # zero-downtime rollout (dtf_tpu/serve/rollout.py): the canary
    # gate's verdicts and the rollback record
    "canary_divergence", "rollout_rollback", "rollout_rollback_failed",
    # disaggregated serving's KV-page wire migration (serve/migrate.py
    # detects torn transfers; serve/router.py flags migrations that
    # never made it — an efficiency loss, never a lost request)
    "migration_torn", "migration_failed",
    # router HA (serve/ha.py + serve/replica.py): a replica rejecting
    # a superseded controller's wire op, and the superseded router
    # discovering it has been fenced off the tier
    "stale_epoch", "router_fenced",
    # train/loop.py step-site XLA failure classified as accelerator
    # loss (train/elastic.py is_device_loss) — precedes EXIT_DEVICE_LOST
    "device_lost",
)

#: event kinds of the run/request-timeline / ledger / profiler layer —
#: never anomalies, but part of the vocabulary the --allow typo check
#: validates against: `--allow serve_retire` is a harmless no-op on a
#: known name, while `--allow serve_retier` still warns loudly
KNOWN_EVENT_KINDS = (
    # tracer lifecycle (obs/trace.py stamps one per stream)
    "trace_start",
    # train loop (train/loop.py) + preemption (train/preemption.py)
    "train_loss", "train_end", "epoch_end", "preempted",
    # watchdog heartbeat records (obs/watchdog.py)
    "heartbeat",
    # async-PS client reconnect (parallel/ps.py)
    "ps_reconnect",
    # data-service supervision (data/service/pool.py)
    "reader_respawn",
    # request-scoped distributed tracing (router + serve engine)
    "router_submit", "router_dispatch", "router_requeue",
    "router_first_token", "router_complete", "router_hedge",
    "serve_submit", "serve_admit", "serve_retire", "serve_cancelled",
    # replica-tier supervision (serve/router.py)
    "replica_registered", "replica_respawn",
    # rollout lifecycle (serve/rollout.py + the router's rollout
    # control surface)
    "rollout_phase", "replica_drain", "replica_replaced",
    "canary_mirror", "canary_compare", "canary_drop", "prefix_rehome",
    # disaggregation: the router's chain re-home command + completion
    "chain_migrate", "chain_migrated",
    # MFU/cost ledger (obs/ledger.py)
    "ledger_exec", "ledger_summary",
    # ZeRO compute/comm overlap probe (train/loop.py --zero_probe)
    "zero_overlap",
    # elastic shrink/grow resume (train/elastic.py): the topology a
    # resumed attempt actually trained on
    "elastic_resume",
    # --profile_steps output-path marker (train/loop.py)
    "profiler_trace",
    # router HA takeover (serve/ha.py): a successor assumed the tier
    # under a new fencing epoch; per-request re-adoption confirmations
    # (the replica still held the retained tail)
    "router_takeover", "router_readopt",
)

#: raw chaos kinds — the ``fault_kind`` attr of ``injected_fault``
#: records, never record names themselves.  Accepted by trace_main's
#: --allow typo check (so `--allow replica_kill`-style near-misses
#: warn rather than pass); the same names as ``chaos.KINDS``.
CHAOS_FAULT_KINDS = (
    "crash", "sigterm", "heartbeat_stall", "ps_drop", "ckpt_truncate",
    "reader_crash", "replica_kill", "net_partition", "slow_replica",
    "rollout_kill", "device_loss", "host_loss", "page_fetch_stall",
    "router_kill", "lease_stall",
)

#: metric-name grammar: <subsystem>_<name>[_<unit-ish suffix>], where
#: the leading segment must be one of these subsystem prefixes
METRIC_SUBSYSTEMS = ("data", "ps", "router", "serve", "plan", "train",
                     "ledger")


def allowable_kinds() -> frozenset:
    """Every name ``trace_main --allow`` accepts without a typo
    warning."""
    return frozenset(KNOWN_ANOMALY_KINDS) | frozenset(KNOWN_EVENT_KINDS) \
        | frozenset(CHAOS_FAULT_KINDS)
