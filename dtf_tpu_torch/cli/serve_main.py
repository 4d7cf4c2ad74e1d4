"""Serving entry point -- weights -> paged KV-cache decode -> batched
synthetic traffic.  The PyTorch counterpart of
``dtf_tpu/cli/serve_main.py``.

It builds the model on ``--device`` (default ``cuda``; with no CUDA it
raises unless ``--device cpu`` is given), loads weights (``--serve_
params_npz``, else an ``--export_dir`` export or the newest usable
``--model_dir`` training checkpoint) or draws them at random
(``--serve_random_init``), stands
up the dynamic batching engine, drives it with synthetic traffic --
every request consumed through its token stream -- and reports latency
percentiles and tokens/s (``--benchmark_log_dir`` writes metric.log).

Serving is the JAX package's default: the paged cache with prefix
sharing (``--serve_prefix_sharing``, on; ``--kv_page_size 0`` serves
from the contiguous cache, without sharing).  ``--metrics_port``
serves the engine's registry (queue, prefix hits, the MFU ledger) as
Prometheus text on ``GET /metrics`` and ``GET /healthz`` (503 while
draining).  SIGTERM drains: admissions shed with ``retry_after``,
in-flight requests finish, and the process exits 0.  ``--trace_dir``
records each request's submit, admit and retire.

``--serve_tp N`` serves tensor-parallel: one engine over N model shards
(``serve/bridge.py place_for_serving``), shard k on ``cuda:k``; with
fewer cards than N it exits naming the count (``--device cpu`` puts
every shard on the CPU).  Paged cache only.

Examples:
  # on the GPU, the flagship width in bf16:
  python -m dtf_tpu_torch.cli.serve_main --serve_random_init \\
      --model transformer_tpu --dtype bf16

  # a training run's checkpoint (lm_main --model_dir /ckpt ...):
  python -m dtf_tpu_torch.cli.serve_main --model_dir /ckpt \
      --model transformer_tpu --dtype bf16

  # on the CPU (the kernels' plain versions), a small model:
  python -m dtf_tpu_torch.cli.serve_main --serve_random_init \\
      --device cpu --model transformer_small --serve_requests 4
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
import signal
import sys
import time

import numpy as np

from dtf_tpu_torch.config import parse_flags
from dtf_tpu_torch.models.registry import build_model
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.watchdog import Heartbeat
from dtf_tpu_torch.runtime.device import resolve_device
from dtf_tpu_torch.serve import bridge
from dtf_tpu_torch.serve.engine import Backpressure, ServeEngine
from dtf_tpu_torch.serve.metrics import collect_stats

log = logging.getLogger("dtf_tpu_torch")


def build_serving_engine(cfg, random_init: bool = False,
                         replica_rank=None, devices=None):
    """(model, engine) from a Config, on ``cfg.device`` -- shared by this
    main and the replica entry (cli/replica_main.py).  The engine beats
    a heartbeat when the launcher (or the serving router) exported
    DTF_HEARTBEAT_DIR: ``heartbeat_rank{replica_rank}.json``, the rank
    from DTF_PROCESS_ID when None.  ``devices``: the ``--serve_tp``
    shards' devices, named by a caller (default: one card a shard)."""
    if not cfg.model.startswith("transformer"):
        raise ValueError(f"serving is implemented for the transformer LM "
                         f"family, not {cfg.model!r}")
    device = resolve_device(cfg.device)
    # --serve_tp N: the host's weights cut straight into N shards, one
    # a device; never several on one card unless a caller names them
    devices = (bridge.serving_devices(cfg.serve_tp, devices, device=device)
               if cfg.serve_tp > 1 else [device])
    model, _ = build_model(cfg.model, num_classes=cfg.num_classes,
                           dtype=cfg.compute_dtype)
    if random_init:
        log.warning("--serve_random_init: serving random parameters -- "
                    "a pipeline smoke test, outputs are noise")
        bridge.random_init(model, cfg.seed)
        model = bridge.place_for_serving(model, devices, cfg.serve_tp)
    else:
        try:
            model = bridge.load_for_serving(
                model, cfg.serve_params_npz, model_dir=cfg.model_dir,
                export_dir=cfg.export_dir, devices=devices,
                model_parallelism=cfg.serve_tp)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"no weights to serve ({e}): pass --serve_params_npz "
                f"(flax params as .npz), --export_dir, a --model_dir "
                f"holding checkpoints, or --serve_random_init") from e
    model = model.eval()
    max_seq = cfg.serve_max_seq_len or model.max_seq_len
    bridge.serving_memory_plan(model, num_slots=cfg.serve_max_batch,
                               max_seq_len=max_seq,
                               kv_page_size=cfg.kv_page_size,
                               kv_pool_pages=cfg.kv_pool_pages,
                               model_parallelism=cfg.serve_tp)
    engine = ServeEngine(
        model, max_batch=cfg.serve_max_batch, max_seq_len=max_seq,
        max_delay_s=cfg.serve_max_delay_ms / 1000.0,
        queue_size=cfg.serve_queue_size, seed=cfg.seed,
        kv_page_size=cfg.kv_page_size or None,
        kv_pool_pages=cfg.kv_pool_pages or None,
        # Config refuses a chunk size with the contiguous cache
        prefill_chunk=cfg.serve_prefill_chunk,
        prefix_sharing=cfg.serve_prefix_sharing and bool(cfg.kv_page_size),
        heartbeat=Heartbeat.from_env(rank=replica_rank,
                                     interval_s=cfg.heartbeat_secs))
    return model, engine


def serve(cfg, random_init: bool = False, devices=None) -> dict:
    """Build model + engine from a Config, run the synthetic traffic
    demo and return the stats dict.  Library entry for tests and the
    smoke script."""
    model, engine = build_serving_engine(cfg, random_init=random_init,
                                         devices=devices)

    # SIGTERM (the preemption signal) drains: admissions shed, in-flight
    # work finishes, and the process exits 0.  The handler is minimal:
    # one lock-free engine call and one os.write.  Installed before the
    # metrics server, so a process that answers /healthz drains on it
    drained = {"signaled": False}

    def _on_sigterm(signum, frame):
        drained["signaled"] = True
        engine.begin_drain()
        os.write(2, b"serve: SIGTERM - draining (admissions shed, "
                    b"in-flight finishing)\n")

    old_handler = None
    try:
        old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (library use)
        pass
    metrics_server = None
    if cfg.metrics_port:
        from dtf_tpu_torch.obs.prom import MetricsServer
        metrics_server = MetricsServer(
            cfg.metrics_port, registry_fn=lambda: engine.metrics,
            health_fn=lambda: {"ok": not engine.draining,
                               "draining": engine.draining,
                               "outstanding": engine.outstanding})

    rng = np.random.default_rng(cfg.seed)
    handles = []
    shed = 0

    def _consume(handle):
        # the streaming client: count each token as its step retires
        return sum(1 for _ in handle.stream(timeout=600))

    t0 = time.time()
    stopped = False
    try:
        # synthetic traffic: varied-length prompts, all submitted up
        # front (a burst), each consumed through its token stream
        with cf.ThreadPoolExecutor(max_workers=8) as ex:
            consumers = []
            for _ in range(cfg.serve_requests):
                plen = int(rng.integers(1, cfg.serve_prompt_len + 1))
                prompt = rng.integers(0, model.vocab_size,
                                      (plen,)).astype(np.int32)
                try:
                    h = engine.submit(
                        prompt, max_new_tokens=cfg.serve_max_new_tokens,
                        temperature=cfg.serve_temperature)
                except Backpressure:
                    # a full queue, or the drain: the client's to retry
                    shed += 1
                    continue
                handles.append(h)
                consumers.append(ex.submit(_consume, h))
            streamed = sum(c.result() for c in consumers)
        for h in handles:
            h.result(timeout=600)
        wall = time.time() - t0
        engine.stop()       # drain=True: waits out queued + in-flight
        stopped = True
    finally:
        if not stopped:
            engine.stop(drain=False)
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
        if metrics_server is not None:
            metrics_server.shutdown()
    if engine.failed is not None:
        raise RuntimeError("serving engine failed") from engine.failed
    if drained["signaled"]:
        log.info("serve: drained after SIGTERM (%d in flight finished, %d "
                 "shed) -- exiting 0", len(handles), shed)

    stats = collect_stats(engine.completed, engine.shed_count,
                          wall_time_s=wall)
    if cfg.benchmark_log_dir:
        from dtf_tpu_torch.utils.benchmark_logger import BenchmarkFileLogger
        blog = BenchmarkFileLogger(cfg.benchmark_log_dir)
        blog.log_run_info(cfg.model, "lm", cfg.to_dict(),
                          engine.decoder.device,
                          test_id=cfg.benchmark_test_id)
        blog.log_serving_stats(stats)
        blog.log_registry(engine.metrics)
    steps = engine.metrics.get("serve_decode_step_s")
    m = engine.metrics
    out = {
        "device": str(engine.decoder.device),
        "requests": stats.num_requests,
        "shed": stats.num_shed,
        "new_tokens": stats.total_new_tokens,
        "tokens_per_second": stats.tokens_per_s,
        "latency_p50_s": stats.latency_p50_s,
        "latency_p99_s": stats.latency_p99_s,
        "ttft_p50_s": stats.ttft_p50_s,
        "decode_step_p50_s": steps.percentile(50),
        "decode_steps": steps.count,
        "prefill_chunks": m.get("serve_prefill_chunks_total").value,
        "streamed_tokens": streamed,
        "prefix_sharing": engine.prefix_sharing,
        "prefix_hit_pages": m.get("serve_prefix_hit_pages_total").value,
        "drained": drained["signaled"],
        "tp": cfg.serve_tp,
        "ledger": engine.ledger.summary(),
    }
    log.info("Serve stats: %s", out)
    return out


def main(argv=None) -> dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    argv = list(argv if argv is not None else sys.argv[1:])
    # a serving-only switch kept out of Config, as in the JAX entry
    random_init = "--serve_random_init" in argv
    if random_init:
        argv.remove("--serve_random_init")
    cfg = parse_flags(argv)
    # --trace_dir: batch-form, chunk and decode spans, each request's
    # submit/admit/retire, shed anomalies and the ledger
    trace.maybe_configure(cfg)
    return serve(cfg, random_init=random_init)


if __name__ == "__main__":
    main()
