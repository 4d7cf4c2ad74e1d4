#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dtf_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON object per line (the card's
``nvidia-smi`` name and power limit also print as they come):

  1. device   -- the card, torch and CUDA versions; the kernels are
                 built from ``dtf_tpu_torch/csrc`` (one nvcc per source,
                 all started together) and the build time printed.
  2. kernels  -- each CUDA kernel against its plain PyTorch version on
                 the same inputs on the card: max abs error and
                 tolerance, then kernel, plain and library times (CUDA
                 events, warmed up, median of five, inputs rotated
                 through enough copies to defeat the 50 MB L2) and the
                 least time the card could take (for float32 at the
                 tensor cores' 165 TFLOP/s of f32-accurate work, with
                 the CUDA cores' 67 TFLOP/s beside it).  K1, K2a, K2b
                 and K3 have two routes, reported as separate cases:
                 bfloat16 on tensor cores (wgmma); float32 in split
                 TF32 products on tensor cores (mma.sync).  K1 at
                 serving, ragged, D 64 and training shapes; the backward
                 K2a, K2b and K3 at [2, 200, 6, 128], [1, 2048, 6, 128]
                 and [2, 256, 8, 64], causal and full, f32 and bf16, K3
                 against K2a + K2b, each kernel run twice bit for bit,
                 then all three timed in both dtypes at the training
                 shape [8, 2048, 6, 128] beside the backward of
                 F.scaled_dot_product_attention (K3 with the device time
                 of its two passes from torch.profiler), then K2a and
                 K2b at cross lengths (Sq != Sk: 200 / 320, 320 / 200 at
                 D 128, 64 / 256 at D 64), causal and full, both dtypes,
                 twice bit for bit; K4 (a split pass and a combine: S
                 below 16 decodes on CUDA cores, chunks run on the
                 tensor cores) at decode [8, 1, 6, 128] and [8, 1, 6, 64]
                 and chunks [1, 64, 6, 128] at start 0, 64, 1984 and
                 [1, 16, 6, 128] at 1984, both dtypes, each twice bit
                 for bit, then its keys per split swept, and its f32
                 chunk route at q x 4 against float64; last, peaked
                 attention in float32 (q scaled by 4, [1, 2048, 6, 128],
                 causal and full): K1, K2a, K2b and K3 and their plain
                 versions against the plain versions run in float64,
                 each kernel within its f32 gate of float64.
  3. correct  -- ``transformer_tpu`` at full width in float32, random
                 weights from ``--seed``: greedy tokens from the port's
                 ServeEngine equal the argmax of the port's teacher-
                 forced logits over prompt + generated tokens; sampled
                 requests replay token for token; and the kernels'
                 launches in one first prefill chunk, one continuation
                 chunk and one decode step are counted (one per layer).
  4. serve    -- ``cli.serve_main.main`` in bf16: 16 requests, prompts
                 up to 512 tokens, 64 new tokens each, 8 slots.  The
                 kernels' launch counters are zeroed just before and
                 read just after; K1 and K4 must have run, as many
                 times per first prefill chunk (K1) and per decode step
                 and continuation chunk (K4) as phase 3 counted.
     decode_profile -- ``Decoder.decode_step`` in bf16 on a full batch
                 of 8 rows holding 300-576 tokens: the synced host time
                 of a step, then five steps under torch.profiler --
                 device time by kernel kind, K4's two passes and share,
                 the idle share (a profiler that sees no device time for
                 either of K4's passes fails the run).
  5. train_f32 -- ``transformer_tpu`` in float32, batch 2 x 2048: one
                 step's gradients through K1 + K3 equal those with
                 attention bound to K1 + K2a/K2b and to the plain
                 versions (each within 1e-4 of its largest |value|);
                 launches per step counted for each binding and for
                 remat; each binding's synced step time (forward and
                 backward); three AdamW steps with K3 and with K2a/K2b
                 give the same losses (1e-5 relative).
     train_bf16_parity -- the same model and batch in bf16 compute:
                 gradients through K1 + K3 and through K1 + K2a/K2b
                 (tensor cores) within 1e-2 of each parameter's largest
                 |value| of those through the plain versions, or within
                 twice the gap of a reordered plain binding; three
                 AdamW steps' losses within 5e-3 relative of plain's.
  6. train    -- ``cli.lm_main.main`` in bf16, batch 8 x 2048, 30 steps,
                 the counters zeroed just before and read just after:
                 finite falling losses, tokens/s, synced step-time p50,
                 peak memory, MFU against 989 TFLOP/s, 12 K1 and 12 K3
                 launches a step.
     train_split -- its companion: the same run, 20 steps, with
                 attention bound to ``fused_bwd=False``: 12 K1, 12 K2a
                 and 12 K2b launches a step, step time and tokens/s
                 beside K3's.  Then two steps of a fresh default trainer
                 under torch.profiler: device time by kernel kind and
                 the device's idle share (a profiler that sees no device
                 time for K1 or K3 fails the run).
  7. train_resnet -- the ResNet path, which runs no hand kernel
                 (cuDNN convolutions, BatchNorm in plain torch ops):
     resnet_f32 -- resnet56 in float32, batch 32: one step's loss,
                 logits, gradients and BN buffers on the card against
                 float64 on the CPU (the whole gradient held to three
                 times the CPU float32 step's distance; see
                 ``check_resnet_f32``);
     resnet_determinism -- two fresh resnet56 bf16 runs of 3 steps,
                 bit-identical; step time with cudnn.deterministic on
                 and off (resnet56 b128, resnet50 b256);
     train_cifar / train_imagenet -- ``cli.cifar_main.main`` (resnet56,
                 bf16, batch 128, 50 steps) and ``cli.imagenet_main
                 .main`` (resnet50, bf16, batch 256, 30 steps), then 20
                 steps of ``--use_trivial_model``: finite falling
                 losses, images/s, step-time p50, peak memory, MFU from
                 FlopCounterMode's FLOPs an image;
     resnet_profile -- two steps of each under torch.profiler: device
                 time by kind (convolutions, BatchNorm, optimizer,
                 elementwise, reductions, copies) and idle share (no
                 convolution kernel seen fails the run);
     resnet_stem -- the space-to-depth stem against the plain 7x7/2,
                 forward and backward at [256, 224, 224, 3] bf16;
     train_cifar_files -- ``cifar_main --data_dir`` on CIFAR-10 binary
                 files it writes (uint8 wire), 10 steps and an eval that
                 must count each of the 1000 test examples once.
  8. data parallelism -- each run in processes of its own, every rank
                 printing its per-step losses, step times, kernel
                 launches (counters zeroed just before its run) and a
                 digest of its trained weights:
     dp_world1_cifar / dp_world1_lm -- ``cli.cifar_main`` (resnet56,
                 bf16, batch 128) and ``cli.lm_main`` (transformer_tpu,
                 bf16, batch 8 x 2048), 20 steps each, with
                 ``--distribution_strategy off`` in a plain process and
                 ``multi_worker_mirrored`` through ``cli/launch.py`` with
                 one rank, so an NCCL group exists and the gradient
                 all-reduce runs, in turns (off, NCCL, NCCL, off):
                 losses and weights bit for bit, both step times (the
                 per-step cost of data parallelism), 12 K1 and 12 K3
                 launches a step on the LM's path;
     dp_two_ranks -- resnet20, float32, global batch 32, 3 steps on
                 CIFAR files it writes (each rank its file shard), sync
                 BN off and on: two ranks sharing the card over gloo
                 (``initialize(cfg, backend="gloo")``: CUDA tensors
                 reduced through the host) and the same two ranks on the
                 CPU; the ranks end bit-identical and the card's losses
                 are within ``DP_LOSS_RTOL`` of the CPU's;
     dp_nccl_multi_card -- with two cards, the same runs over NCCL one
                 card a rank; with one, a line saying it is unmeasured.
  9. recovery -- crash-exact resume through the entry points, each run
                 under ``cli/launch.py`` with sealed checkpoints every 2
                 steps (``--checkpoint_keep 2``) and a trace, its
                 processes printing their losses, launches, a digest of
                 the trained state dict and the checkpoint times:
     recovery_disk -- the free space of the temporary directory;
     recovery_lm -- ``cli.lm_main`` transformer_tpu bf16, batch 8 x
                 2048, one ``multi_worker_mirrored`` rank on NCCL, 8
                 steps; then, from an empty model dir, the same with
                 ``--resume --fault crash@step:4`` and one restart: exit
                 0 after a crash exit 77, resumed at step 4, every
                 step's loss equal as a float, the state dicts' and the
                 final checkpoints' sha256 equal, ``trace_main --check
                 --allow injected_fault`` green, 48 K1 and 48 K3
                 launches in the resumed process (steps 5-8);
     recovery_serve -- ``cli.serve_main.main --model_dir`` on that run's
                 checkpoint (4 requests; K1 and K4 launched), and its
                 engine's greedy tokens equal to those the trained
                 parameters held in memory give;
     recovery_resnet_crash / recovery_resnet_preempt -- ``cli.cifar_main``
                 resnet56 bf16 at batch 128 on CIFAR files it writes,
                 the same way with ``crash@step:4``, and with
                 ``sigterm@step:3``: exit 75 with an emergency checkpoint
                 at step 3, restarted outside the crash budget, the same
                 trajectory (BN buffers, Keras SGD momentum, cuDNN);
     recovery_measure -- save ms (state to host, payload, fsync, sha256),
                 restore ms, bytes a step, the barrier behind a save and
                 the time from the supervisor's restart to the resumed
                 process's first step.
  10. ImageNet input -- no hand kernel on this path either (decode, crop
                 and resize on the host, the mean subtraction on the
                 card through ``data/normalize.py``); it writes its own
                 shards: 8 train files of 256 and 2 validation files of
                 150 smooth 375x500 JPEGs with boxes, in the reference's
                 Example format, from ``--seed``:
     imagenet_input -- the data service's host images/s at batch 256 on
                 the uint8 wire, inline and with one spawned reader a
                 core (capped by the 8 shards), then two epochs through
                 the decode-once cache (fill, then served: hit ratio and
                 rate); the decode path (``native`` libjpeg-turbo, built
                 at first use, or ``pil``);
     train_imagenet_files / imagenet_eval -- ``cli.imagenet_main.main
                 --data_dir`` resnet50 bf16 b256, 20 steps with
                 ``--profile_steps 2,3``: step p50 and images/s beside
                 phase 7's synthetic run, the reader-lag gauge, the
                 profiled steps' device time (none fails the run); the
                 eval must count each of the 300 validation records once;
     imagenet_resume -- resnet50 under the launcher, 8 steps, sealed
                 checkpoints every 2, 4 readers uninterrupted; then one
                 reader a core with ``crash@step:4,reader_crash@batch:6``
                 and one restart: every step's loss equal as a float,
                 equal digests, at least one reader respawn;
     train_cifar_fp16 -- ``cli.cifar_main.main`` resnet56 fp16 b128, 40
                 steps, a static loss scale (128) and a dynamic one:
                 finite falling losses, step p50 beside phase 7's bf16.

 11. async_ps -- the async parameter server (``parallel/ps.py``, the
                 native store ``native/ps_store.cpp`` built at first use
                 without libjpeg, ``convert.py``'s wire layout):
     ps_store   -- the store must be the native one; pull and push round
                 trips over loopback at ResNet-50's 25,559,081 floats on
                 the fp32 and bf16 wires, the bytes a step moves (exactly
                 8 or 4 B a float), the bf16 bytes of the client's and
                 the store's conversions equal to the numpy rule, NaNs
                 included;
     ps_one_worker -- resnet56 b128 f32, 10 synthetic steps, an
                 in-process store and one worker, twice: losses equal as
                 floats, the final snapshots' params and velocity equal,
                 version 10; the gap to the sync ``off`` Trainer printed;
     ps_reference -- 1 store + 2 resnet50 workers at the reference's
                 per-worker batch 192 in fp32 through ``cli.launch``, 10
                 steps each, fp32 then bf16 wire: every rank exits 0,
                 version 20, the store's rank touched no card; steps/s,
                 images/s, the pull and push spans' p50 and share, wire
                 bytes, peak memory;
     ps_lm      -- transformer_tpu b8 x 2048 bf16 as one worker, 3 steps:
                 12 K1 and 12 K3 launches a step, its parameter count;
     ps_faults  -- ``ps_drop@version:3`` (a reconnect, every step done,
                 version 8), then the store's rank SIGTERMed while it
                 serves under ``--ps_snapshot_dir``: the launcher
                 restarts the job, the store restores its snapshot and
                 discards the old attempt's done count, and the re-run
                 workers finish at the restored version plus 40.
 12. serving as the JAX package serves by default -- prefix sharing
                 with refcounted, copy-on-write pages, eviction,
                 cancellation, the drain, /metrics and the MFU ledger, the
                 contiguous cache; transformer_tpu, random weights from
                 ``--seed``, a warm request before each burst:
     prefix_concurrency -- bench_serve.py's shared-prefix arm in bf16: a
                 128-token system prompt, 8 tails of 8 tokens, 24 new
                 tokens, 8 slots, a 25-page pool: with sharing at least
                 twice the peak concurrency, fewer pages a live sequence,
                 greedy tokens identical, K1/K4 launches as counted per
                 request and chunk (a hit's first chunk runs K4);
     prefix_ttft -- a 1024-token system prompt, 16 tails of U[1, 64], 64
                 new tokens, the full pool: TTFT p50 with and without
                 sharing (sharing lower), tokens/s, high-water lower,
                 tokens identical; the decode step's ledger MFU and HBM
                 share against the card's peaks;
     prefix_pressure -- the 25-page pool: a distinct 300-token prompt
                 evicts cached pages and completes; a request cancelled
                 mid-decode comes back cancelled, the pool back to what
                 the registry holds; begin_drain sheds the next submit;
     prefix_f32 -- in float32 (the routes agree to ~1e-6 there): a
                 4-page prompt seen twice is a COW replay with the
                 unshared engine's tokens; 8 requests through the
                 contiguous cache and the paged one, tokens equal,
                 tokens/s side by side;
     serve_cli_drain -- ``cli.serve_main`` as a process, bf16, 16
                 requests of 512 new tokens, ``--metrics_port``: the
                 serve_* and ledger_* series scraped, SIGTERM after 20
                 decode steps, /healthz 503 while it drains, every
                 request finished, exit 0, ``trace_main --ledger --json``
                 rows from its trace.
  The training phase 6 also holds the ledger's train_step MFU within 20%
  of its own formula's.

Then the ``{"kernels": [...]}`` line -- each kernel's main case (every
case is on its own phase-2 line), its design and its launches from the
run of its path: K1 and K3 phase 6 (and, as ``launches_dp``, phase 8's
data-parallel LM run; as ``launches_recovery``, phase 9's resumed
process; as ``launches_async``, phase 11's async worker), K2a and K2b
phase 6's companion, the f32 routes phase 5's f32 AdamW steps, K4
serving (and, as ``launches_recovery_serve``, with K1,
serving phase 9's checkpoint; as ``launches_prefix``, with K1, phase
12's bursts with and without sharing) -- and, last, the device line.
Any failure raises: the script exits non-zero and prints no result.
Without CUDA, or without the ``dtf_tpu_torch`` package beside it, it
exits 2 before doing anything.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
# f32-accurate work on the tensor cores: 495 TFLOP/s of TF32 over the
# three products of a split product; bf16 dense tensor cores
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
CUDA_CORE_F32_FLOPS = 67e12          # f32 FMA on the CUDA cores
L2_BYTES = 50e6
TRAIN_SHAPE = (8, 2048, 6, 128)      # transformer_tpu at batch 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 2


class Timer:
    """Device time of a call, from CUDA events.

    A sleep kernel first holds the card while the host queues the timed
    launches, so the events bracket back-to-back device work, not the
    host's Python between launches.  Each launch takes the next of
    ``copies`` input sets, so a working set smaller than the L2 is not
    served from it."""

    def __init__(self, torch):
        self.torch = torch
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(10**7)
        e.record()
        e.synchronize()
        self.cycles_per_s = 1e7 / (s.elapsed_time(e) / 1e3)

    def ms(self, fn, copies, trials: int = 5) -> float:
        torch = self.torch
        for c in copies[:2]:
            fn(*c)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*copies[0])
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        reps = max(len(copies), min(50, max(3, int(0.05 / host))))
        sleep = int(min(1.5 * host * reps, 0.25) * self.cycles_per_s)
        out = []
        for _ in range(trials):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(sleep)
            s.record()
            for i in range(reps):
                fn(*copies[i % len(copies)])
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e) / reps)
        return statistics.median(out)


class PhaseClock:
    """Seconds each phase took, one ``phase_time`` line as it ends: the
    script's time limit is shared by every phase."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        emit({"phase": "phase_time", "of": phase, "s": now - self.t})
        self.t = now


def rotated(tensors, nbytes: int):
    """Enough copies of ``tensors`` that cycling through them touches
    three times the L2."""
    n = min(16, max(2, math.ceil(3 * L2_BYTES / max(nbytes, 1))))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def compare(torch, out, ref, floor: float = 0.0):
    """Kernel output against its plain version, row by row (a row is one
    query and head: the last dim).  float32: 1e-5.  bfloat16: o is
    rounded to 8 significant bits, and the kernel and the plain version
    add their f32 terms in different orders, so a value may round one
    bf16 step apart: each row within two bf16 steps at the larger of its
    own largest |ref| and ``floor``, 2^(e - 6) for that maximum in
    [2^e, 2^(e+1)).

    Returns (max abs error, the tolerance of the row nearest its limit,
    that row's error over its tolerance)."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    if out.dtype == torch.float32:
        tol = torch.full_like(err, 1e-5)
    else:
        top = ref.abs().amax(-1).clamp_min(max(floor, 2.0 ** -126))
        tol = torch.ldexp(torch.ones_like(top),
                          torch.frexp(top).exponent - 7)
    ratio = (err / tol).flatten()
    worst = int(ratio.argmax())
    return (float(err.max()), float(tol.flatten()[worst]),
            float(ratio[worst]))


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def bounds(flops: float, nbytes: float, dtype: str):
    """``bound_ms`` and ``bound_by`` at the dtype's tensor-core peak;
    for float32 also ``bound_cuda_core_ms``, the same work at the CUDA
    cores' f32 rate."""
    ms, by = bound(flops, nbytes, dtype)
    out = {"bound_ms": ms, "bound_by": by}
    if dtype == "float32":
        out["bound_cuda_core_ms"] = max(flops / CUDA_CORE_F32_FLOPS,
                                        nbytes / HBM_BYTES_PER_S) * 1e3
    return out


# the routes of K1, K2a, K2b and K3 inside their C entry points
# (csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/flash_bwd_fused.cu), by
# dtype: the same for all four
SPLIT_TF32 = "3xtf32 mma.sync+cp.async"


def route(dtype: str) -> str:
    return "wgmma+cp.async" if dtype == "bfloat16" else SPLIT_TF32


def check_flash(torch, timer, gen):
    """K1 against its plain version: [1, 64, 6, 128] (a first prefill
    chunk), [2, 200, 6, 128] (ragged against any tile), [2, 256, 8, 64]
    (D 64), [1, 2048, 6, 128] (a whole-context chunk) and the training
    shape [8, 2048, 6, 128], causal and full, float32 (split TF32
    products) and bfloat16 (wgmma)."""
    import torch.nn.functional as F

    from dtf_tpu_torch.ops import flash_attention as fa

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for shape in ((1, 64, 6, 128), (2, 200, 6, 128), (2, 256, 8, 64),
                      (1, 2048, 6, 128), TRAIN_SHAPE):
            b, s, h, d = shape
            for causal in (True, False):
                q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype)
                           for _ in range(3))
                scale = d ** -0.5
                o, lse = fa.flash_forward(q, k, v, causal=causal)
                po, plse = fa.flash_forward_plain(q, k, v, causal=causal,
                                                  scale=scale)
                torch.cuda.synchronize()
                err, tol, ratio = compare(torch, o, po)
                lse_err = float((lse - plse).abs().max())
                lse_tol = 1e-5 * max(1.0, float(plse.abs().max()))
                if not (ratio <= 1.0 and lse_err <= lse_tol):
                    raise AssertionError(
                        f"K1 {dname} {shape} causal={causal}: o err {err}, "
                        f"worst row at {ratio} of its tol {tol}; lse err "
                        f"{lse_err} (tol {lse_tol})")
                elem = q.element_size()
                nbytes = 4 * q.numel() * elem + lse.numel() * 4
                pairs = s * (s + 1) / 2 if causal else s * s
                copies = rotated((q, k, v), 3 * q.numel() * elem)
                tq = [tuple(t.transpose(1, 2).contiguous() for t in c)
                      for c in copies]
                cases.append({
                    "shape": list(shape), "causal": causal, "dtype": dname,
                    "design": route(dname),
                    "max_abs_err": err, "tol": tol, "err_over_tol": ratio,
                    "lse_err": lse_err,
                    "lse_tol": lse_tol,
                    "ms": timer.ms(lambda q_, k_, v_: fa.flash_forward(
                        q_, k_, v_, causal=causal), copies),
                    "plain_ms": timer.ms(
                        lambda q_, k_, v_: fa.flash_forward_plain(
                            q_, k_, v_, causal=causal, scale=scale), copies),
                    "library_ms": timer.ms(
                        lambda q_, k_, v_: F.scaled_dot_product_attention(
                            q_, k_, v_, is_causal=causal), tq),
                    **bounds(4 * b * h * d * pairs, nbytes, dname)})
                emit({"phase": "kernels", "kernel": "K1", **cases[-1]})
    return cases


def grad_tolerance(torch, out, ref):
    """Backward kernel output against its plain version: float32 within
    1e-5 absolute, scaled by the output's largest |ref| where that
    exceeds 1 (dk and dv sum up to S terms); bfloat16 by the per-row rule
    of :func:`compare` with a floor of 2^-8 of the output's largest
    |ref|: a row whose exact value is zero -- causal dq's first row,
    where dS = p (dp - delta) and dp = delta -- comes out as f32 rounding
    noise whose size follows the order of the sums, and is held to the
    tolerance of a row at that floor (2^-14 of the largest |ref|).
    Returns (max abs error, tolerance of the worst row, its error over
    its tolerance)."""
    if out.dtype == torch.float32:
        err = float((out.float() - ref.float()).abs().max())
        tol = 1e-5 * max(1.0, float(ref.float().abs().max()))
        return err, tol, err / tol
    return compare(torch, out, ref,
                   floor=2.0 ** -8 * float(ref.float().abs().max()))


def check_backward(torch, timer, gen):
    """K2a, K2b and K3 against their plain versions on the same inputs:
    [2, 200, 6, 128] (ragged against any tile), [1, 2048, 6, 128] and
    [2, 256, 8, 64], causal and full, float32 (split TF32 products)
    and bfloat16 (wgmma); K3 against K2a + K2b in float32;
    each kernel twice gives the same bits in both.  Then each at the
    training shape, causal, in both dtypes: kernel, plain and library
    times and bounds, the library yardstick being the backward of
    F.scaled_dot_product_attention (autograd.grad of its output), and the
    device time of K3's two passes.  Last, K2a and K2b at cross lengths
    -- Sq 200 / Sk 320 and Sq 320 / Sk 200 at D 128, Sq 64 / Sk 256 at
    D 64, causal and full, both dtypes, twice bit for bit."""
    import torch.nn.functional as F

    from dtf_tpu_torch.ops import _build
    from dtf_tpu_torch.ops import flash_attention as fa

    def inputs(shape, dtype, causal, sk=None):
        b, s, h, d = shape
        kv = (b, s if sk is None else sk, h, d)
        q, k, v, do = (torch.randn(x, generator=gen).to("cuda", dtype)
                       for x in (shape, kv, kv, shape))
        o, lse = fa.flash_forward(q, k, v, causal=causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
            b * h, s).contiguous()
        return q, k, v, do, o, lse, delta

    def held(row, kname, outs, refs):
        res = [grad_tolerance(torch, o_, r_) for o_, r_ in zip(outs, refs)]
        worst = max(res, key=lambda x: x[2])
        row[kname] = {"max_abs_err": max(x[0] for x in res),
                      "tol": worst[1], "err_over_tol": worst[2]}
        if not worst[2] <= 1.0:
            raise AssertionError(f"{kname}: {row}")

    def same_bits(row, kname, first, again):
        row[f"{kname}_bit_identical"] = all(
            torch.equal(a, b_) for a, b_ in zip(first, again))
        if not row[f"{kname}_bit_identical"]:
            raise AssertionError(f"{kname} not deterministic: {row}")

    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for shape in ((2, 200, 6, 128), (1, 2048, 6, 128), (2, 256, 8, 64)):
            for causal in (True, False):
                q, k, v, do, o, lse, delta = inputs(shape, dtype, causal)
                args = (q, k, v, do, lse, delta)
                kw = dict(causal=causal, scale=shape[-1] ** -0.5)
                outs = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                        "K2b": fa.flash_bwd_dkdv(*args, **kw),
                        "K3": fa.flash_bwd_fused(*args, **kw)}
                again = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                         "K2b": fa.flash_bwd_dkdv(*args, **kw),
                         "K3": fa.flash_bwd_fused(*args, **kw)}
                plain = fa.flash_bwd_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                row = {"shape": list(shape), "causal": causal,
                       "dtype": dname,
                       "design": {n: route(dname)
                                  for n in ("K2a", "K2b", "K3")}}
                refs = {"K2a": plain[:1], "K2b": plain[1:], "K3": plain}
                for kname in ("K2a", "K2b", "K3"):
                    held(row, kname, outs[kname], refs[kname])
                if dtype == torch.float32:
                    split_gap = max(
                        grad_tolerance(torch, a, b_)[2]
                        for a, b_ in zip(outs["K3"],
                                         outs["K2a"] + outs["K2b"]))
                    row["K3_vs_split_err_over_tol"] = split_gap
                    if not split_gap <= 1.0:
                        raise AssertionError(f"K3 != K2a + K2b: {row}")
                for kname in ("K2a", "K2b", "K3"):
                    same_bits(row, kname, outs[kname], again[kname])
                checks.append(row)
                emit({"phase": "backward", **row})
                del q, k, v, do, o, lse, delta, args, outs, again, plain

    # times at the training shape, causal: the three kernels on both
    # routes
    b, s, h, d = TRAIN_SHAPE
    kw = dict(causal=True, scale=d ** -0.5)
    pairs = b * h * s * (s + 1) / 2
    rows = b * h * s * 8                 # lse and delta, f32
    kernel = {"K2a": fa.flash_bwd_dq, "K2b": fa.flash_bwd_dkdv,
              "K3": fa.flash_bwd_fused}
    plain = {"K2a": fa.flash_bwd_dq_plain, "K2b": fa.flash_bwd_dkdv_plain,
             "K3": fa.flash_bwd_fused_plain}
    # the profiler's names of K3's two passes on each route
    passes = {"bfloat16": ("bwd_fused_tc_kernel", "dq_reduce_tc_kernel"),
              "float32": ("bwd_fused_x3_kernel", "dq_reduce_x3_kernel")}
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, do, o, lse, delta = inputs(TRAIN_SHAPE, dtype, True)
        args = (q, k, v, do, lse, delta)
        elem = q.element_size()
        copies = rotated(args, 4 * q.numel() * elem)
        qkvo = q.numel() * elem
        # tile products per (query, key) pair: S and dP, then dq (K2a),
        # dk and dv (K2b), all three (K3); 2 D operations each
        work = {"K2a": (3, 4 * qkvo + rows + qkvo),
                "K2b": (4, 4 * qkvo + rows + 2 * qkvo),
                "K3": (5, 4 * qkvo + rows + 3 * qkvo)}
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous().requires_grad_()
                           for t in (q, k, v, do))
        ref_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        library_ms = timer.ms(
            lambda: torch.autograd.grad(ref_o, (qt, kt, vt), dot,
                                        retain_graph=True), [()])
        ref = fa.flash_bwd_fused_plain(*args, **kw)
        refs = {"K2a": ref[:1], "K2b": ref[1:], "K3": ref}
        for name in ("K2a", "K2b", "K3"):
            key = name if dtype == torch.bfloat16 else f"{name} {dname}"
            outs = kernel[name](*args, **kw)
            outs = outs if isinstance(outs, tuple) else (outs,)
            torch.cuda.synchronize()
            res = [grad_tolerance(torch, o_, r_)
                   for o_, r_ in zip(outs, refs[name])]
            del outs
            worst = max(res, key=lambda x: x[2])
            if not worst[2] <= 1.0:
                raise AssertionError(f"{key} at the training shape: {res}")
            products, nbytes = work[name]
            timings[key] = {
                "max_abs_err": max(x[0] for x in res), "tol": worst[1],
                "err_over_tol": worst[2], "shape": list(TRAIN_SHAPE),
                "causal": True, "dtype": dname,
                "design": route(dname),
                "ms": timer.ms(lambda *a, f=kernel[name]: f(*a, **kw),
                               copies),
                "plain_ms": timer.ms(lambda *a, f=plain[name]: f(*a, **kw),
                                     copies[:1]),
                "library_ms": library_ms,
                **bounds(2 * d * products * pairs, nbytes, dname)}
            if name == "K3":
                timings[key]["partial_bytes"] = fa.fused_partial_bytes(q, k)
                # the C side's count agrees with the wrapper's allocation
                c_floats = _build.load("flash_bwd_fused_partial_floats")
                for sk in (s, 200):
                    want = fa.fused_partial_floats(b, h, s, sk, d, dtype)
                    got = c_floats(b, h, s, sk, d, fa.KERNEL_DTYPES[dtype])
                    if got != want:
                        raise AssertionError(f"K3 {dname} partial floats: C "
                                             f"{got}, wrapper {want}")
                timings[key]["passes_ms"] = profile_passes(
                    torch, fa, args, kw, passes[dname])
            emit({"phase": "backward_time", "kernel": key, **timings[key]})
        del q, k, v, do, o, lse, delta, args, copies, qt, kt, vt, dot, \
            ref_o, ref, refs
        torch.cuda.empty_cache()

    # cross-length attention, the split pair's own case under the auto
    # rule: positions count from 0 for queries and keys alike
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for sq, sk, h, d in ((200, 320, 6, 128), (320, 200, 6, 128),
                             (64, 256, 8, 64)):
            for causal in (True, False):
                q, k, v, do, o, lse, delta = inputs((2, sq, h, d), dtype,
                                                    causal, sk)
                args = (q, k, v, do, lse, delta)
                kw = dict(causal=causal, scale=d ** -0.5)
                outs = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                        "K2b": fa.flash_bwd_dkdv(*args, **kw)}
                again = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                         "K2b": fa.flash_bwd_dkdv(*args, **kw)}
                plain = fa.flash_bwd_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                row = {"shape": [2, sq, h, d], "sk": sk, "causal": causal,
                       "dtype": dname,
                       "design": {n: route(dname) for n in ("K2a", "K2b")}}
                held(row, "K2a", outs["K2a"], plain[:1])
                held(row, "K2b", outs["K2b"], plain[1:])
                for kname in ("K2a", "K2b"):
                    same_bits(row, kname, outs[kname], again[kname])
                checks.append(row)
                emit({"phase": "backward_cross", **row})
                del q, k, v, do, o, lse, delta, args, outs, again, plain

    return checks, timings


def check_peaked(torch, gen):
    """Peaked attention in float32: q scaled by 4 at [1, 2048, 6, 128],
    causal and full, where a row's weight falls on a few keys and |o|
    nears the largest |v|.  There the f32 gates are a few ulps of the
    outputs, close to the plain version's own rounding, so the reference
    is the plain versions run on float64 copies of the same inputs: each
    kernel's error against it and, beside it, the float32 plain
    version's.  A kernel fails where it is further from float64 than
    its f32 gate allows (o 1e-5; lse 1e-5 of max(1, max |lse|); each
    gradient 1e-5 of max(1, its max |ref|)); the plain version's error
    is reported, not gated.  The backward's inputs are the kernel
    forward's residuals, so each backward kernel is held to the exact
    function of what it was given."""
    from dtf_tpu_torch.ops import flash_attention as fa

    def gap64(outs, refs, tol=None):
        """(max abs error, the worst error over its tolerance)."""
        res = []
        for out, ref in zip(outs, refs):
            err = float((out.double() - ref).abs().max())
            t = tol if tol is not None else 1e-5 * max(
                1.0, float(ref.abs().max()))
            res.append((err, err / t))
        return max(e for e, _ in res), max(r for _, r in res)

    shape = (1, 2048, 6, 128)
    b, s, h, d = shape
    for causal in (True, False):
        q, k, v, do = (torch.randn(shape, generator=gen).to("cuda")
                       for _ in range(4))
        q = q * 4
        kw = dict(causal=causal, scale=d ** -0.5)
        o, lse = fa.flash_forward(q, k, v, causal=causal)
        delta = (do * o).sum(-1).transpose(1, 2).reshape(b * h,
                                                         s).contiguous()
        args = (q, k, v, do, lse, delta)
        grads = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                 "K2b": fa.flash_bwd_dkdv(*args, **kw),
                 "K3": fa.flash_bwd_fused(*args, **kw)}
        po, plse = fa.flash_forward_plain(q, k, v, **kw)
        plain = fa.flash_bwd_fused_plain(*args, **kw)
        o64, lse64 = fa.flash_forward_plain(
            *(x.double() for x in (q, k, v)), **kw)
        ref = fa.flash_bwd_fused_plain(*(x.double() for x in args), **kw)
        torch.cuda.synchronize()
        lse_tol = 1e-5 * max(1.0, float(lse64.abs().max()))
        row = {"shape": list(shape), "causal": causal, "q_scale": 4,
               "dtype": "float32", "design": route("float32")}
        # name: (kernel outputs, plain f32 outputs, float64 reference,
        # tolerance -- None: the scaled gradient gate)
        held = {"K1": ([o], [po], [o64], 1e-5),
                "K1 lse": ([lse], [plse], [lse64], lse_tol),
                "K2a": (grads["K2a"], plain[:1], ref[:1], None),
                "K2b": (grads["K2b"], plain[1:], ref[1:], None),
                "K3": (grads["K3"], plain, ref, None)}
        for name, (outs, pls, refs, tol) in held.items():
            err, ratio = gap64(outs, refs, tol)
            perr, pratio = gap64(pls, refs, tol)
            row[name] = {"max_abs_err": err, "err_over_tol": ratio,
                         "plain_max_abs_err": perr,
                         "plain_err_over_tol": pratio}
        emit({"phase": "peaked", **row})
        bad = [n for n in held if not row[n]["err_over_tol"] <= 1.0]
        if bad:
            raise AssertionError(f"{bad} further from float64 than the f32 "
                                 f"gate at q x 4: {row}")
        del q, k, v, do, o, lse, delta, args, grads, plain, ref, o64, held


def profile_passes(torch, fa, args, kw, names):
    """Device time a launch of K3's two passes (the key-block walk and
    the dq reduce, the kernels ``names``) from torch.profiler, over the
    launches the profiler recorded (it may drop some); raises where the
    profiler sees no device time for either."""
    from torch.profiler import ProfilerActivity, profile
    fa.flash_bwd_fused(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fa.flash_bwd_fused(*args, **kw)
        torch.cuda.synchronize()
    total, count = {}, {}
    for ev in prof.key_averages():
        for tag in names:
            if tag in ev.key:
                dev_us = getattr(ev, "device_time_total",
                                 getattr(ev, "cuda_time_total", 0.0))
                total[tag] = total.get(tag, 0.0) + dev_us / 1e3
                count[tag] = count.get(tag, 0) + ev.count
    out = {tag: total[tag] / count[tag] for tag in total if count[tag]}
    if not all(out.get(tag, 0.0) > 0 for tag in names):
        raise RuntimeError(f"profiler saw no device time for K3's passes "
                           f"{names}: {out}")
    return out


# K4's routes inside its C entry point (csrc/paged_decode.cu), by S and
# dtype: S below CHUNK_MIN_S there (16) decodes on CUDA cores, chunks run
# on the tensor cores; every route is a split pass and a combine
K4_CHUNK_MIN_S = 16


def k4_route(dtype: str, s: int) -> str:
    if s < K4_CHUNK_MIN_S:
        return "split-kv cuda-core cp.async"
    return ("split-kv wgmma cp.async" if dtype == "bfloat16"
            else "split-kv 3xtf32 mma.sync cp.async")


def paged_oracle64(torch, pa, q, pool_k, pool_v, table, index):
    """K4's function in float64: the gather, the positional mask, a dense
    softmax."""
    s, d = q.shape[1], q.shape[-1]
    k = pa.gather_pages(pool_k, table).double()
    v = pa.gather_pages(pool_v, table).double()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) * d ** -0.5
    jpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    qpos = (index.long()[:, None, None, None]
            + torch.arange(s, device=q.device)[None, None, :, None])
    scores = torch.where(jpos <= qpos, scores,
                         torch.full_like(scores, -1e300))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


# K4's keys per split, swept on the main cases (the constant,
# ops/paged_attention.py KEYS_PER_SPLIT, is one of them)
K4_SPLIT_SWEEP = (64, 128, 256, 512)


def sweep_splits(pa, timer, copies):
    """K4's time at each keys-per-split of the sweep, the constant put
    back after."""
    chosen = pa.KEYS_PER_SPLIT
    out = {}
    try:
        for kps in K4_SPLIT_SWEEP:
            pa.KEYS_PER_SPLIT = kps
            out[kps] = timer.ms(pa.paged_flash_decode, copies)
    finally:
        pa.KEYS_PER_SPLIT = chosen
    return out


def check_paged(torch, timer, gen):
    """K4 against its plain version: a decode step [8, 1, 6, 128] over
    rows holding {1, 15, 16, 17, 1000, 2047} tokens plus two idle rows
    (all-zero tables), the same at D 64, continuation chunks
    [1, 64, 6, 128] at start 0, 64 and 1984 and [1, 16, 6, 128] at 1984;
    pools of 1025 pages of 16, 128 pages a row -- the serving engine's
    layout at max_batch 8.  float32 and bfloat16; each case run twice
    bit for bit; the decode and the chunk at 1984 also timed at each
    keys per split of K4_SPLIT_SWEEP.  Then the f32 chunk route at peaked
    attention (q x 4,
    start 1984) against K4's function in float64, within the f32 gate;
    the plain version's distance beside it."""
    from dtf_tpu_torch.ops import paged_attention as pa

    pages, page, m, h = 1025, 16, 128, 6
    lengths = [1, 15, 16, 17, 1000, 2047, 0, 0]
    table = torch.zeros(len(lengths), m, dtype=torch.int32)
    perm = torch.randperm(pages - 1, generator=gen) + 1
    used = 0
    for row, n_tok in enumerate(lengths):
        n = -(-n_tok // page)
        table[row, :n] = perm[used:used + n]
        used += n
    index = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    full_row = table[5:6].clone()            # 128 pages: 2048 positions
    # (name, table, index, S, D)
    setups = [("decode", table, index, 1, 128),
              ("decode d64", table, index, 1, 64)]
    for start in (0, 64, 1984):
        setups.append((f"chunk@{start}", full_row,
                       torch.tensor([start], dtype=torch.int32), 64, 128))
    setups.append(("chunk16@1984", full_row,
                   torch.tensor([1984], dtype=torch.int32), 16, 128))

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        pools = {d: tuple(torch.randn(pages, page, h, d,
                                      generator=gen).to("cuda", dtype)
                          for _ in range(2)) for d in (64, 128)}
        for name, tab, idx, s, d in setups:
            pool_k, pool_v = pools[d]
            elem = pool_k.element_size()
            tab_c, idx_c = tab.cuda(), idx.cuda()
            q = torch.randn(tab.shape[0], s, h, d,
                            generator=gen).to("cuda", dtype)
            o = pa.paged_flash_decode(q, pool_k, pool_v, tab_c, idx_c)
            again = pa.paged_flash_decode(q, pool_k, pool_v, tab_c, idx_c)
            po = pa.paged_flash_decode_reference(q, pool_k, pool_v, tab_c,
                                                 idx_c)
            torch.cuda.synchronize()
            err, tol, ratio = compare(torch, o, po)
            same = torch.equal(o, again)
            if not (ratio <= 1.0 and same):
                raise AssertionError(f"K4 {dname} {name}: err {err}, worst "
                                     f"row at {ratio} of its tol {tol}; "
                                     f"bit-identical twice: {same}")
            # what this run's data needs: each row's live keys (index +
            # S, within the table) read once from K and V, q read, o
            # written, the table and index read
            keys = [min(int(i) + s, m * page) for i in idx.tolist()]
            nbytes = (2 * sum(keys) * h * d * elem + 2 * q.numel() * elem
                      + tab.numel() * 4 + idx.numel() * 4)
            pairs = sum(min(int(i) + j + 1, m * page)
                        for i in idx.tolist() for j in range(s))
            copies = rotated((q, pool_k, pool_v, tab_c, idx_c),
                             2 * sum(keys) * h * d * elem)
            cases.append({
                "case": name, "shape": list(q.shape), "dtype": dname,
                "design": k4_route(dname, s),
                "keys_per_split": pa.KEYS_PER_SPLIT,
                "row_keys": keys, "max_abs_err": err, "tol": tol,
                "err_over_tol": ratio, "bit_identical": same,
                "ms": timer.ms(pa.paged_flash_decode, copies),
                "plain_ms": timer.ms(pa.paged_flash_decode_reference,
                                     copies[:1]),
                "library_ms": None,
                **bounds(4 * h * d * pairs, nbytes, dname)})
            if name in ("decode", "chunk@1984"):
                cases[-1]["ms_by_keys_per_split"] = sweep_splits(
                    pa, timer, copies)
            emit({"phase": "kernels", "kernel": "K4", **cases[-1]})
            del copies
        del pools

    # the f32 chunk route where a row's weight falls on a few keys
    pool_k, pool_v = (torch.randn(pages, page, h, 128,
                                  generator=gen).to("cuda")
                      for _ in range(2))
    tab_c = full_row.cuda()
    idx_c = torch.tensor([1984], dtype=torch.int32).cuda()
    q = 4 * torch.randn(1, 64, h, 128, generator=gen).to("cuda")
    args = (q, pool_k, pool_v, tab_c, idx_c)
    o = pa.paged_flash_decode(*args)
    po = pa.paged_flash_decode_reference(*args)
    o64 = paged_oracle64(torch, pa, *args)
    torch.cuda.synchronize()
    err = float((o.double() - o64).abs().max())
    row = {"phase": "peaked", "kernel": "K4", "case": "chunk@1984",
           "shape": list(q.shape), "q_scale": 4, "dtype": "float32",
           "design": k4_route("float32", 64), "max_abs_err": err,
           "err_over_tol": err / 1e-5,
           "plain_max_abs_err": float((po.double() - o64).abs().max())}
    emit(row)
    if not err <= 1e-5:
        raise AssertionError(f"K4 f32 chunk further from float64 than the "
                             f"f32 gate at q x 4: {row}")
    del pool_k, pool_v, args
    return cases


def check_serving_f32(torch, seed: int):
    """Greedy engine tokens == teacher-forced argmax, full width, f32;
    sampled requests replay token for token; and the kernels' launches
    in one model call of each kind, counted on the same model."""
    import numpy as np

    from dtf_tpu_torch.cli.serve_main import build_serving_engine
    from dtf_tpu_torch.config import Config
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.serve.decode import Decoder, teacher_forced_logits

    cfg = Config(model="transformer_tpu", dtype="fp32", seed=seed,
                 device="cuda", serve_max_batch=4)
    model, engine = build_serving_engine(cfg, random_init=True)
    rng = np.random.default_rng(seed)
    n_new = 16
    prompts = [rng.integers(0, model.vocab_size, (n,)).astype(np.int32)
               for n in (1, 17, 64, 300)]
    try:
        handles = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
        results = [hd.result(timeout=600) for hd in handles]
        # sampling draws its noise on the card: the same (seed, position)
        # must give the same tokens, another seed other tokens
        sampled = [engine.submit(prompts[1], max_new_tokens=n_new,
                                 temperature=1.0, rng_seed=s).result(
                                     timeout=600).tokens
                   for s in (seed + 1, seed + 1, seed + 2)]
    finally:
        engine.stop(drain=False)
    if engine.failed is not None:
        raise RuntimeError("engine failed") from engine.failed
    for p, r in zip(prompts, results):
        seq = np.concatenate([p, np.asarray(r.tokens, np.int32)])
        logits = teacher_forced_logits(model, seq[None])[0]
        want = logits[len(p) - 1:len(p) - 1 + n_new]
        if not bool(torch.isfinite(want).all()):
            raise AssertionError(f"prompt {len(p)}: non-finite logits")
        ref = want.argmax(-1).cpu().tolist()
        if r.tokens != ref:
            top2 = want.topk(2, dim=-1).values
            raise AssertionError(
                f"prompt {len(p)}: engine {r.tokens} != teacher-forced "
                f"argmax {ref}; smallest top-2 margin "
                f"{float((top2[:, 0] - top2[:, 1]).min())}")
    if not (sampled[0] == sampled[1] != sampled[2] and all(
            0 <= t < model.vocab_size for t in sampled[0] + sampled[2])):
        raise AssertionError(f"sampled requests do not replay: {sampled}")

    # launches per model call: a first prefill chunk (start 0), a
    # continuation chunk and a decode step, each between a reset and a
    # read of the counters
    page, chunk = 16, 64
    dec = Decoder(model, num_slots=1, max_seq_len=model.max_seq_len,
                  kv_page_size=page)
    cache = dec.fresh_cache()
    row = np.arange(1, dec.pages_per_slot + 1, dtype=np.int32)
    toks = rng.integers(0, model.vocab_size, (2 * chunk,)).astype(np.int32)
    per_call = {}
    for name, call in (
            ("first_chunk", lambda: dec.prefill_chunk(
                cache, toks[:chunk], row, 0, chunk - 1, 0.0)),
            ("continuation_chunk", lambda: dec.prefill_chunk(
                cache, toks[chunk:], row, chunk, chunk - 1, 0.0)),
            ("decode_step", lambda: dec.decode_step(
                cache, toks[-1:], [2 * chunk], [0.0], row[None]))):
        fa.launches = pa.launches = 0
        call()
        torch.cuda.synchronize()
        per_call[name] = {"K1": fa.launches, "K4": pa.launches}
    layers = model.num_layers
    want = {"first_chunk": {"K1": layers, "K4": 0},
            "continuation_chunk": {"K1": 0, "K4": layers},
            "decode_step": {"K1": 0, "K4": layers}}
    if per_call != want:
        raise AssertionError(f"launches per model call {per_call}, "
                             f"expected one per layer: {want}")
    emit({"phase": "correct", "model": "transformer_tpu", "dtype": "fp32",
          "prompts": [len(p) for p in prompts], "new_tokens": n_new,
          "token_exact": True, "sampled_replay": True,
          "launches_per_call": per_call})
    del model, engine, dec, cache
    torch.cuda.empty_cache()
    return per_call


def serve_bf16(torch, seed: int, per_call):
    """The main path, through the serving entry point a user runs, in
    bf16 with the counters zeroed just before and read just after."""
    from dtf_tpu_torch.cli import serve_main
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa

    n_req, n_new = 16, 64
    argv = ["--serve_random_init", "--device", "cuda",
            "--model", "transformer_tpu", "--dtype", "bf16",
            "--seed", str(seed), "--serve_max_batch", "8",
            "--serve_requests", str(n_req), "--serve_prompt_len", "512",
            "--serve_max_new_tokens", str(n_new)]
    reset_counts(fa, pa)
    out = serve_main.main(argv)
    launches = kernel_counts(fa, pa)
    if not (out["requests"] == n_req and out["shed"] == 0
            and out["new_tokens"] == out["streamed_tokens"]
            == n_req * n_new):
        raise AssertionError(f"serving run incomplete: {out}")
    # every request has one first chunk (K1); every other chunk and
    # every decode step attends over pages (K4), each as many times as
    # phase 3 counted in one such call
    want = {"K1": per_call["first_chunk"]["K1"] * n_req,
            "K2a": 0, "K2b": 0, "K3": 0,
            "K4": per_call["decode_step"]["K4"] * out["decode_steps"]
            + per_call["continuation_chunk"]["K4"]
            * (out["prefill_chunks"] - n_req)}
    if launches != want or min(launches["K1"], launches["K4"]) <= 0:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    emit({"phase": "serve", "model": "transformer_tpu", "dtype": "bf16",
          **out, "launches": launches})
    return launches


def kernel_counts(fa, pa):
    return {"K1": fa.launches, "K2a": fa.launches_dq,
            "K2b": fa.launches_dkdv, "K3": fa.launches_fused,
            "K4": pa.launches}


def reset_counts(fa, pa):
    fa.launches = fa.launches_dq = fa.launches_dkdv = 0
    fa.launches_fused = pa.launches = 0


def make_plain_attention(torch, fa, block_k: int = 64,
                         block: int = 128):
    """flash attention through the kernels' plain versions, forward and
    backward, on any device: phase 5's reference binding.  ``block_k``
    and ``block`` are the forward's key blocks and the backward's tiles:
    another size is the same function with the f32 sums in another
    order."""

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            scale = q.shape[-1] ** -0.5
            o, lse = fa.flash_forward_plain(q, k, v, causal=causal,
                                            scale=scale, block_k=block_k)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal, ctx.scale = causal, scale
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            b, s, h, _ = q.shape
            do = do.contiguous()
            delta = (do.float() * o.float()).sum(-1).transpose(
                1, 2).reshape(b * h, s).contiguous()
            return (*fa.flash_bwd_fused_plain(q, k, v, do, lse, delta,
                                              causal=ctx.causal,
                                              scale=ctx.scale, block=block),
                    None)

    def plain_attention(q, k, v, *, causal=False, **_):
        return PlainFlash.apply(q, k, v, causal)

    return plain_attention


def training_runs(torch, seed: int, dtype, bindings, adamw,
                  remat: bool = False, timed: bool = False):
    """transformer_tpu at full width and depth, compute in ``dtype``,
    batch 2 x 2048, random weights from ``seed``.  For each attention
    binding (name -> function), one step's loss and parameter gradients;
    with ``timed``, then the median of three more such steps' synced
    host time (forward and backward, ms); with ``remat`` one
    default-bound step under remat; for the bindings named in
    ``adamw``, three AdamW steps' losses.  The kernels' launches of each
    run are counted between a reset just before and a read just after.
    Returns (parameter names, grads, losses, launches, step ms)."""
    from dtf_tpu_torch.config import Config
    from dtf_tpu_torch.data import get_dataset_spec, synthetic_input_fn
    from dtf_tpu_torch.models import transformer
    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.serve.bridge import random_init
    from dtf_tpu_torch.train.loop import Trainer, cross_entropy

    spec = get_dataset_spec("lm")
    batch = 2
    tokens, labels = (torch.from_numpy(x).cuda() for x in
                      next(synthetic_input_fn(spec, True, batch, seed)))

    def fresh(**kw):
        model, _ = build_model("transformer_tpu", dtype=dtype, **kw)
        return random_init(model, seed).cuda()

    default = transformer.flash_attention
    grads, losses, launches, step_ms = {}, {}, {}, {}
    try:
        for name, attn in bindings.items():
            transformer.flash_attention = attn
            model = fresh()
            reset_counts(fa, pa)
            loss = cross_entropy(model(tokens), labels)
            names, params = zip(*model.named_parameters())
            grads[name] = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            launches[f"step_{name}"] = kernel_counts(fa, pa)
            losses[f"step_{name}"] = float(loss.detach())
            if timed:
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    torch.autograd.grad(cross_entropy(model(tokens), labels),
                                        params)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                step_ms[name] = statistics.median(times)
            del model, loss, params
        transformer.flash_attention = default
        if remat:
            model = fresh(remat=True)
            reset_counts(fa, pa)
            cross_entropy(model(tokens), labels).backward()
            torch.cuda.synchronize()
            launches["step_K3_remat"] = kernel_counts(fa, pa)
            del model
        cfg = Config(device="cuda", dataset="lm", batch_size=batch,
                     train_steps=3, optimizer="adamw", seed=seed)
        for name in adamw:
            transformer.flash_attention = bindings[name]
            trainer = Trainer(cfg, fresh(), 0.0, spec)
            state = trainer.init_state()
            reset_counts(fa, pa)
            run = []
            for _ in range(3):
                state, metrics = trainer.train_step(state, tokens, labels)
                run.append(float(metrics["loss"]))
            launches[f"adamw_{name}"] = kernel_counts(fa, pa)
            losses[f"adamw_{name}"] = run
            del trainer, state
    finally:
        transformer.flash_attention = default
    return names, grads, losses, launches, step_ms


def grad_gap(names, grads, ref: str, other: str, tol: float):
    """The worst parameter gradient of binding ``other`` against
    ``ref``'s, each held within ``tol`` of its own largest |value|:
    (error over tolerance, parameter name)."""
    ratios = []
    for name, a, b in zip(names, grads[other], grads[ref]):
        top = float(b.float().abs().max())
        ratios.append((float((a.float() - b.float()).abs().max())
                       / (tol * max(top, 1e-30)), name))
    return max(ratios)


def check_launches(launches, want) -> None:
    got = {k: tuple(v[n] for n in ("K1", "K2a", "K2b", "K3"))
           for k, v in launches.items()}
    if got != want:
        raise AssertionError(f"launches per run {got}, expected {want}")


def check_training_f32(torch, seed: int):
    """float32 (the split-product routes of K1, K2a, K2b and K3): one
    step's gradients through K1 + K3 (the
    default) against the same step with attention bound to K1 + K2a/K2b
    and to the plain versions, each gradient within 1e-4 of its own
    largest |value|; each binding's synced step time; the launches of
    each binding and of remat; then three AdamW steps with K3 and with
    K2a/K2b, per-step losses within 1e-5 relative."""
    import functools

    from dtf_tpu_torch.ops import flash_attention as fa

    bindings = {"K3": fa.flash_attention,
                "K2a+K2b": functools.partial(fa.flash_attention,
                                             fused_bwd=False),
                "plain": make_plain_attention(torch, fa)}
    names, grads, losses, launches, step_ms = training_runs(
        torch, seed, torch.float32, bindings, ("K3", "K2a+K2b"), remat=True,
        timed=True)
    worst = {}
    for other in ("K2a+K2b", "plain"):
        worst[other] = grad_gap(names, grads, "K3", other, 1e-4)
        if not worst[other][0] <= 1.0:
            raise AssertionError(f"{other} gradient of {worst[other][1]} "
                                 f"differs from K3's by {worst[other][0]} "
                                 f"of its tolerance")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["adamw_K2a+K2b"],
                                                  losses["adamw_K3"]))
    if not (rel <= 1e-5 and all(math.isfinite(x)
                                for x in losses["adamw_K3"])):
        raise AssertionError(f"AdamW losses K3 vs K2a/K2b: {losses}")
    layers = 12
    check_launches(launches, {
        "step_K3": (layers, 0, 0, layers),
        "step_K2a+K2b": (layers, layers, layers, 0),
        "step_plain": (0, 0, 0, 0),
        "step_K3_remat": (2 * layers, 0, 0, layers),
        "adamw_K3": (3 * layers, 0, 0, 3 * layers),
        "adamw_K2a+K2b": (3 * layers, 3 * layers, 3 * layers, 0)})
    out = {"phase": "train_f32", "model": "transformer_tpu",
           "batch": 2, "seq": 2048, "losses": losses,
           "grad_err_over_tol": {k: v[0] for k, v in worst.items()},
           "grad_worst_param": {k: v[1] for k, v in worst.items()},
           "adamw_loss_rel_gap": rel, "step_ms": step_ms,
           "launches": launches}
    emit(out)
    del grads
    torch.cuda.empty_cache()
    return out


def check_training_bf16(torch, seed: int):
    """bfloat16 compute (the tensor-core routes): one step's gradients
    through K1 + K3 and through K1 + K2a/K2b (``fused_bwd=False``)
    against the same step with attention bound to the plain versions,
    and three AdamW steps with each binding, losses within 5e-3 relative
    of plain's -- the port's bf16 Trainer tolerance against the JAX
    package.  Each parameter's gradient within 1e-2 of its own largest
    |value|, or within twice the gap between two plain bindings that
    differ only in the order of their f32 sums (forward key blocks 128
    for 64, backward tiles 64 for 128): the step rounds to bf16 at every
    matmul and attention of 12 layers, and a gradient that few terms
    feed -- ``pos_embed``, a sum over the batch's two rows -- carries
    that rounding noise at about 1e-2 of its largest value whichever
    binding computes it."""
    import functools

    from dtf_tpu_torch.ops import flash_attention as fa

    kernels = ("K3", "K2a+K2b")
    bindings = {"K3": fa.flash_attention,
                "K2a+K2b": functools.partial(fa.flash_attention,
                                             fused_bwd=False),
                "plain": make_plain_attention(torch, fa),
                "plain_reordered": make_plain_attention(torch, fa,
                                                        block_k=128,
                                                        block=64)}
    names, grads, losses, launches, _ = training_runs(
        torch, seed, torch.bfloat16, bindings, kernels + ("plain",))
    worst, worst_five, rel = {}, {}, {}
    for kname in kernels:
        gaps = []
        for name, a, b, c in zip(names, grads[kname], grads["plain"],
                                 grads["plain_reordered"]):
            top = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            noise = float((c.float() - b.float()).abs().max())
            gaps.append((err / max(1e-2 * top, 2 * noise, 1e-30), name,
                         err / max(top, 1e-30), noise / max(top, 1e-30)))
        worst[kname] = max(gaps)
        # the five parameters nearest their tolerance: (name, gap and
        # reordered plain's gap, each over the largest |value|)
        worst_five[kname] = [[n, g, r] for _, n, g, r in
                             sorted(gaps, reverse=True)[:5]]
        rel[kname] = max(abs(a - b) / abs(b) for a, b in zip(
            losses[f"adamw_{kname}"], losses["adamw_plain"]))
        if not (worst[kname][0] <= 1.0 and rel[kname] <= 5e-3
                and all(math.isfinite(x) for x in losses[f"adamw_{kname}"])):
            raise AssertionError(
                f"bf16 K1 + {kname} against plain: gradient of "
                f"{worst[kname][1]} at {worst[kname][0]} of its tolerance "
                f"(gap {worst[kname][2]}, reordered plain "
                f"{worst[kname][3]} of its largest value), AdamW losses "
                f"{losses}")
    layers = 12
    check_launches(launches, {
        "step_K3": (layers, 0, 0, layers),
        "step_K2a+K2b": (layers, layers, layers, 0),
        "step_plain": (0, 0, 0, 0), "step_plain_reordered": (0, 0, 0, 0),
        "adamw_K3": (3 * layers, 0, 0, 3 * layers),
        "adamw_K2a+K2b": (3 * layers, 3 * layers, 3 * layers, 0),
        "adamw_plain": (0, 0, 0, 0)})
    out = {"phase": "train_bf16_parity", "model": "transformer_tpu",
           "batch": 2, "seq": 2048, "losses": losses,
           "grad_err_over_tol": {k: v[0] for k, v in worst.items()},
           "grad_worst_param": {k: v[1] for k, v in worst.items()},
           "grad_worst_five": worst_five,
           "adamw_loss_rel_gap": rel, "launches": launches}
    emit(out)
    del grads
    torch.cuda.empty_cache()
    return out


FLOPS_PER_TOKEN = ("6 * (L * (4 d^2 + 2 d d_ff) + d V) + 6 L S d: the "
                   "weight matmuls forward and backward, plus causal "
                   "attention's QK^T and PV (S/2 keys a query on average)")


def train_bf16(torch, seed: int, split: bool = False, steps: int = 30):
    """The main path of the training slice: ``cli/lm_main.main`` trains
    transformer_tpu in bf16, batch 8 x 2048, ``steps`` steps, with the
    counters zeroed just before and read just after.  Every logged loss
    finite, the last below the first (the synthetic stream repeats one
    batch); 12 K1 and 12 K3 launches a step.  With ``split`` the same
    run has attention bound to ``fused_bwd=False`` -- the split pair's
    path (cross-length attention, long sequences, or that choice) at
    the training shape -- and 12 K2a and 12 K2b launches a step."""
    import functools

    from dtf_tpu_torch.cli import lm_main
    from dtf_tpu_torch.models import transformer
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa

    log_steps = 5
    b, s, h, dh = TRAIN_SHAPE
    argv = ["--use_synthetic_data", "--device", "cuda",
            "--model", "transformer_tpu", "--dtype", "bf16",
            "--batch_size", str(b), "--train_steps", str(steps),
            "--log_steps", str(log_steps), "--seed", str(seed),
            "--skip_checkpoint"]
    default = transformer.flash_attention
    if split:
        transformer.flash_attention = functools.partial(fa.flash_attention,
                                                        fused_bwd=False)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, pa)
        t0 = time.perf_counter()
        stats = lm_main.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts(fa, pa)
    finally:
        transformer.flash_attention = default
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in stats["train_loss_log"]]
    if not (len(losses) == steps // log_steps
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"training losses {stats['train_loss_log']}")
    layers = 12
    bwd = layers * steps
    want = {"K1": layers * steps, "K2a": bwd if split else 0,
            "K2b": bwd if split else 0, "K3": 0 if split else bwd, "K4": 0}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    step_p50 = statistics.median(stats["window_step_s"])
    d, d_ff, vocab = h * dh, 3072, 32768
    flops_per_token = (6 * (layers * (4 * d * d + 2 * d * d_ff) + d * vocab)
                       + 6 * layers * s * d)
    tokens_per_s = b * s / step_p50
    out = {"phase": "train_split" if split else "train",
           "model": "transformer_tpu", "dtype": "bf16",
           "backward": "K2a+K2b" if split else "K3",
           "batch": b, "seq": s, "steps": steps, "log_steps": log_steps,
           "losses": stats["train_loss_log"],
           "step_s_p50": step_p50, "window_step_s": stats["window_step_s"],
           "tokens_per_s": tokens_per_s,
           "avg_tokens_per_s": stats["avg_exp_per_second"] * s,
           "peak_memory_bytes": peak,
           "flops_per_token": flops_per_token,
           "flops_per_token_formula": FLOPS_PER_TOKEN,
           "mfu": tokens_per_s * flops_per_token / PEAK_FLOPS["bfloat16"],
           "wall_s": wall, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()}}
    # the MFU ledger's train_step (obs/ledger.py): FlopCounterMode's
    # FLOPs with K1's and K3's own counts, over the synced windows' mean
    # step, against the card's peak by name; the JAX ledger's contract
    # is within 20% of this formula's MFU
    # counted: 6 FLOPs a weight a token, plus K1's 4 D and K3's 10 D a
    # causal pair of each head (K3's reported from autograd's thread)
    ledger = stats["ledger"].get("train_step") or {}
    pairs = b * h * s * (s + 1) // 2
    counted = (6 * b * s * (layers * (4 * d * d + 2 * d * d_ff) + d * vocab)
               + layers * (4 + 10) * dh * pairs)
    out.update(ledger_train_step=ledger, ledger_flops_counted=counted,
               ledger_flops_over_formula=ledger.get("flops", 0.0)
               / (flops_per_token * b * s),
               ledger_mfu_over_mfu=(ledger.get("mfu") or 0.0) / out["mfu"])
    emit(out)
    if not split and (ledger.get("flops") != counted
                      or abs(out["ledger_mfu_over_mfu"] - 1) > 0.2):
        raise AssertionError(f"ledger train_step {ledger}: FLOPs not "
                             f"{counted}, or its MFU not within 20% of the "
                             f"formula's {out['mfu']}")
    torch.cuda.empty_cache()
    return out


def device_time(prof, kinds, steps: int, wall: float):
    """A profiled window's device time per step: summed by kind (the
    first ``kinds`` entry, (label, tag or tags), whose tag a kernel's name
    holds), by kernel name, busy in all, and the device's idle share of
    the window's wall time (s)."""
    from torch.autograd import DeviceType

    by_kind, by_name, busy = {}, {}, 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        busy += us
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us / 1e3 / steps
        name = ev.name.lower()
        kind = "other (copies, ...)"
        for label, tags in kinds:
            tags = (tags,) if isinstance(tags, str) else tags
            if any(t.lower() in name for t in tags):
                kind = label
                break
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / steps
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "device_idle_share": max(0.0, 1 - busy / 1e6 / wall),
            "device_ms_per_step_by_kind": dict(sorted(
                by_kind.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms_per_step": [
                [n[:90], ms] for n, ms in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:10]]}


def profile_train_step(torch, seed: int):
    """Where one bf16 training step's device time goes: two steps of a
    fresh ``transformer_tpu`` trainer (after the counted run) under
    torch.profiler, kernel time summed by kind, and the device's idle
    share of the steps' wall time.  Raises where the profiler sees no
    device time, or none for K1 and K3's two passes."""
    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch.cli.lm_main import LM_DEFAULTS
    from dtf_tpu_torch.cli.runner import build_training
    from dtf_tpu_torch.config import parse_flags

    b = TRAIN_SHAPE[0]
    cfg = parse_flags(["--use_synthetic_data", "--device", "cuda",
                       "--model", "transformer_tpu", "--batch_size", str(b),
                       "--train_steps", "4", "--seed", str(seed)],
                      defaults=LM_DEFAULTS)
    trainer, state, train_fn, _ = build_training(cfg)
    x, y = (torch.from_numpy(a).cuda() for a in next(train_fn()))
    state, m = trainer.train_step(state, x, y)
    float(m["loss"])
    steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = trainer.train_step(state, x, y)
        float(m["loss"])
        wall = time.perf_counter() - t0
    kinds = (("K1 (flash_fwd_tc_kernel)", "flash_fwd_tc_kernel"),
             ("K3 pass 1 (bwd_fused_tc_kernel)", "bwd_fused_tc_kernel"),
             ("K3 pass 2 (dq_reduce_tc_kernel)", "dq_reduce_tc_kernel"),
             ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet")),
             ("cross-entropy / softmax", ("softmax", "nll", "cross")),
             ("layer norm", "layer_norm"),
             ("reductions", "reduce"),
             ("elementwise (incl. AdamW, casts)", ("elementwise",
                                                   "vectorized")))
    out = device_time(prof, kinds, steps, wall)
    by_kind = out["device_ms_per_step_by_kind"]
    missing = [label for label, _ in kinds[:3] if not by_kind.get(label)]
    if not out["device_busy_ms_per_step"] or missing:
        raise RuntimeError(f"profiler saw no device time for "
                           f"{missing or 'any kernel'}; kernels seen: "
                           f"{out['top_kernels_ms_per_step']}")
    emit({"phase": "train_profile", **out})
    del trainer, state, x, y
    torch.cuda.empty_cache()
    return out


def profile_decode_step(torch, seed: int):
    """Where a serving decode step's device time goes: ``Decoder.
    decode_step`` on ``transformer_tpu`` in bf16 at full width, a full
    batch of 8 rows holding 300-576 tokens (phase 4's lengths: prompts
    up to 512 plus up to 64 new tokens), pages shuffled over the full
    pool.  The synced host time of ten steps (median), then five steps
    under torch.profiler: device time by kernel kind, K4's two passes,
    K4's share of the device time and the idle share.  Raises where the
    profiler sees no device time for either of K4's passes, or K4 did
    not launch 12 times a step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.serve.bridge import random_init
    from dtf_tpu_torch.serve.decode import Decoder

    model, _ = build_model("transformer_tpu", dtype=torch.bfloat16)
    model = random_init(model, seed).cuda().eval()
    rows, page = 8, 16
    dec = Decoder(model, num_slots=rows, max_seq_len=model.max_seq_len,
                  kv_page_size=page)
    cache = dec.fresh_cache()
    rng = np.random.default_rng(seed)
    lengths = rng.integers(300, 577, rows)
    perm = rng.permutation(np.arange(1, dec.pool_pages)).astype(np.int32)
    pps = dec.pages_per_slot
    tables = perm[:rows * pps].reshape(rows, pps)
    tokens = rng.integers(0, model.vocab_size, rows)
    temps = np.zeros(rows, np.float32)

    def step():
        toks, _, _ = dec.decode_step(cache, tokens, lengths, temps, tables)
        return toks

    for _ in range(3):
        step().cpu()
    host_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        step().cpu()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    steps = 5
    reset_counts(fa, pa)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            toks = step()
        toks.cpu()
        wall = time.perf_counter() - t0
    launches = kernel_counts(fa, pa)
    kinds = (("K4 split pass (paged_split_*)", "paged_split"),
             ("K4 combine (paged_combine_kernel)", "paged_combine"),
             ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet")),
             ("layer norm", "layer_norm"),
             ("softmax / sampling", ("softmax", "argmax", "topk", "sort")),
             ("reductions", "reduce"),
             ("page writes (index_put / scatter)", ("index", "scatter")),
             ("elementwise (casts, GELU, residuals)", ("elementwise",
                                                       "vectorized")))
    out = device_time(prof, kinds, steps, wall)
    by_kind = out["device_ms_per_step_by_kind"]
    k4_ms = sum(by_kind.get(label, 0.0) for label, _ in kinds[:2])
    missing = [label for label, _ in kinds[:2] if not by_kind.get(label)]
    if missing:
        raise RuntimeError(f"profiler saw no device time for {missing}; "
                           f"kernels seen: {out['top_kernels_ms_per_step']}")
    layers = model.num_layers
    if launches["K4"] != layers * steps:
        raise AssertionError(f"K4 launched {launches['K4']} times in "
                             f"{steps} decode steps, expected "
                             f"{layers * steps}")
    out = {"phase": "decode_profile", "model": "transformer_tpu",
           "dtype": "bf16", "rows": rows, "row_lengths": lengths.tolist(),
           "host_step_ms_p50": statistics.median(host_ms),
           "host_step_ms": host_ms, **out,
           "k4_ms_per_step": k4_ms,
           "k4_share_of_busy": k4_ms / out["device_busy_ms_per_step"],
           "k4_passes_ms_per_call": {
               label: by_kind[label] / layers for label, _ in kinds[:2]},
           "launches": launches}
    emit(out)
    del model, dec, cache
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: ResNet training (cli.cifar_main, cli.imagenet_main)
# ---------------------------------------------------------------------------

VISION_FLOPS = ("torch.utils.flop_counter.FlopCounterMode over one "
                "forward and backward on the card (convolutions and "
                "matmuls, 2 per multiply-add), divided by the batch")


def vision_flops_per_image(torch, name: str, image: int,
                           batch: int = 8) -> float:
    """FLOPs of one image's forward and backward through ``name`` in
    bf16, counted by FlopCounterMode on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.train.loop import cross_entropy

    model, _ = build_model(name, dtype=torch.bfloat16)
    model = model.init_weights(0).cuda().to(memory_format=torch.channels_last)
    x = torch.randn(batch, image, image, 3, device="cuda")
    y = torch.zeros(batch, dtype=torch.long, device="cuda")
    with FlopCounterMode(display=False) as counter:
        cross_entropy(model(x), y).backward()
    del model
    return counter.get_total_flops() / batch


def resnet_step_tensors(torch, model, images, labels, l2):
    """One training forward and backward (cross-entropy + L2): the loss,
    the logits, the parameter gradients and the BN buffers after it."""
    from dtf_tpu_torch.models.registry import l2_weight_penalty
    from dtf_tpu_torch.train.loop import cross_entropy

    model.train()
    logits = model(images)
    loss = cross_entropy(logits, labels) + l2_weight_penalty(model, l2)
    loss.backward()
    return ({"loss": loss.detach(), "logits": logits.detach()},
            {n: p.grad for n, p in model.named_parameters()},
            dict(model.named_buffers()))


def check_resnet_f32(torch, seed: int, card: str):
    """``resnet56`` in float32 (TF32 off), weights from ``seed``, batch
    32 of synthetic CIFAR: one training step's loss, logits, gradients
    and BN buffers on the card against the same model run in float64 on
    the CPU.  Gates: the loss 1e-5 relative; the logits and every
    buffer within 1e-4 of their largest |value|; the whole gradient
    (every parameter's, as one vector) within a relative L2 distance of
    three times that of the same step run in float32 on the CPU.

    A gradient tensor's own largest gap is no gate here: ReLU units
    whose input lies within float32 rounding of 0 switch between any
    float32 evaluation and float64, and a weight gradient that sums a
    few thousand terms of either sign moves by a per cent with each
    such switch.  The CPU's float32 step lands past 1e-4 of the largest
    value on nearly every tensor and at about 4e-3 relative L2 on the
    whole gradient, as does float64 with its input perturbed by 1e-7;
    a TF32 product (1e-3 perturbation) lands near 0.3."""
    from dtf_tpu_torch.data import get_dataset_spec, synthetic_input_fn
    from dtf_tpu_torch.models.registry import build_model

    images, labels = next(synthetic_input_fn(get_dataset_spec("cifar10"),
                                             True, 32, seed))
    model, l2 = build_model("resnet56", dtype=torch.float32)
    model = model.init_weights(seed)
    runs = {}
    for where, dtype in (("float64", torch.float64),
                         ("cpu_float32", torch.float32), ("card", None)):
        if dtype is None:
            m, device, dtype = model.cuda().to(
                memory_format=torch.channels_last), "cuda", torch.float32
        else:
            m, _ = build_model("resnet56", dtype=dtype)
            m.load_state_dict(model.state_dict())
            m, device = m.to(dtype), "cpu"
        runs[where] = resnet_step_tensors(
            torch, m, torch.from_numpy(images).to(device, dtype),
            torch.from_numpy(labels).to(device), l2)

    def gap(got, ref):
        return float((got.cpu().double() - ref.double()).abs().max()) / max(
            float(ref.abs().max()), 1e-30)

    ref_out, ref_grads, ref_bufs = runs["float64"]
    out, grads, bufs = runs["card"]
    loss_rel = abs(float(out["loss"]) - float(ref_out["loss"])) / abs(
        float(ref_out["loss"]))
    logits_gap = gap(out["logits"], ref_out["logits"])
    buf_gap = max((gap(bufs[n], r), n) for n, r in ref_bufs.items())
    def flat(gs):
        return torch.cat([gs[n].detach().cpu().double().flatten()
                          for n in ref_grads])

    ref_flat = flat(ref_grads)
    grad_rel = {where: float((flat(runs[where][1]) - ref_flat).norm()
                             / ref_flat.norm())
                for where in ("card", "cpu_float32")}
    grad_gate = 3 * grad_rel["cpu_float32"]
    per_tensor = [(gap(grads[n], r), gap(runs["cpu_float32"][1][n], r), n)
                  for n, r in ref_grads.items()]
    line = {"phase": "resnet_f32", "card": card, "model": "resnet56",
            "dtype": "float32", "batch": 32, "loss": float(out["loss"]),
            "loss_float64": float(ref_out["loss"]), "loss_rel_err": loss_rel,
            "loss_gate": 1e-5, "logits_gap_over_max": logits_gap,
            "buffer_gap_over_max": buf_gap[0], "buffer_worst": buf_gap[1],
            "gate_over_max": 1e-4,
            "grad_rel_l2": grad_rel["card"],
            "grad_rel_l2_cpu_float32": grad_rel["cpu_float32"],
            "grad_gate": grad_gate,
            "grad_max_gap_over_max": max(per_tensor)[0],
            "grad_max_gap_tensor": max(per_tensor)[2],
            "grad_max_gap_over_max_cpu_float32": max(
                g[1] for g in per_tensor),
            "grads_past_1e-4": sum(g[0] > 1e-4 for g in per_tensor),
            "grads_past_1e-4_cpu_float32": sum(g[1] > 1e-4
                                               for g in per_tensor),
            "grads": len(per_tensor)}
    emit(line)
    if not (loss_rel <= 1e-5 and logits_gap <= 1e-4 and buf_gap[0] <= 1e-4
            and grad_rel["card"] <= grad_gate):
        raise AssertionError(f"resnet56 float32 on the card against "
                             f"float64: {line}")
    del model, runs
    torch.cuda.empty_cache()
    return line


def vision_trainer(torch, seed: int, name: str, batch: int,
                   steps: int = 3):
    """A fresh bf16 Trainer of ``name`` (resnet56 on CIFAR or resnet50
    on ImageNet, the mains' defaults) from ``seed``, built by the runner
    (which sets cudnn.deterministic), and its synthetic batch on the
    card."""
    from dtf_tpu_torch.cli.cifar_main import CIFAR_DEFAULTS
    from dtf_tpu_torch.cli.imagenet_main import IMAGENET_DEFAULTS
    from dtf_tpu_torch.cli.runner import build_training
    from dtf_tpu_torch.config import parse_flags

    defaults = CIFAR_DEFAULTS if name == "resnet56" else IMAGENET_DEFAULTS
    cfg = parse_flags(["--use_synthetic_data", "--device", "cuda",
                       "--model", name, "--dtype", "bf16",
                       "--batch_size", str(batch), "--train_steps",
                       str(steps), "--seed", str(seed)], defaults=defaults)
    trainer, state, train_fn, _ = build_training(cfg)
    x, y = (torch.from_numpy(a).cuda() for a in next(train_fn()))
    return trainer, state, x, y


def synced_step_ms(torch, trainer, state, x, y, steps: int = 10):
    """Median synced host time of ``steps`` training steps (ms), after
    two untimed ones."""
    times = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, x, y)
        float(m["loss"])
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), state


def deterministic_cost(torch, trainer, state, x, y, steps: int):
    """Synced step times (ms) with cudnn.deterministic on and off, in
    turns on, off, off, on: the median of each setting's two."""
    ms = {True: [], False: []}
    for det in (True, False, False, True):
        torch.backends.cudnn.deterministic = det
        t, state = synced_step_ms(torch, trainer, state, x, y, steps)
        ms[det].append(t)
    torch.backends.cudnn.deterministic = True
    return {"on": statistics.median(ms[True]),
            "off": statistics.median(ms[False]),
            "on_runs": ms[True], "off_runs": ms[False]}


def check_resnet_determinism(torch, seed: int, card: str):
    """Two fresh ``resnet56`` bf16 runs of three steps from ``seed``
    (batch 128): losses and parameters bit-identical.  Then the synced
    step time with ``torch.backends.cudnn.deterministic`` on (the
    runner's setting) and off, in turns, for resnet56 at batch 128 and
    resnet50 at batch 256."""
    runs = []
    for _ in range(2):
        trainer, state, x, y = vision_trainer(torch, seed, "resnet56", 128)
        losses = []
        for _ in range(3):
            state, m = trainer.train_step(state, x, y)
            losses.append(float(m["loss"]))
        runs.append((losses, [t.detach().clone() for t in
                              trainer.model.state_dict().values()]))
    identical = (runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])))
    cost = {"resnet56_b128": deterministic_cost(torch, trainer, state, x, y,
                                                10)}
    del trainer, state, x, y, runs[1:]
    trainer, state, x, y = vision_trainer(torch, seed, "resnet50", 256)
    cost["resnet50_b256"] = deterministic_cost(torch, trainer, state, x, y,
                                               4)
    line = {"phase": "resnet_determinism", "card": card, "model": "resnet56",
            "dtype": "bf16", "batch": 128, "losses": runs[0][0],
            "bit_identical": identical,
            "step_ms_cudnn_deterministic": cost}
    emit(line)
    if not identical:
        raise AssertionError(f"two resnet56 runs from one seed differ: "
                             f"{line}")
    del trainer, state, runs
    torch.cuda.empty_cache()
    return line


def vision_run(torch, main, argv, phase: str, card: str, batch: int,
               flops_per_image=None, log_steps: int = 5,
               falling: bool = True, **extra):
    """``main(argv)`` on the card: images/s from the synced step-time
    p50 (the first log window dropped), peak memory, and MFU at 989
    TFLOP/s when ``flops_per_image`` is given; with ``falling``, finite
    losses whose last is below the first."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = main(argv + ["--batch_size", str(batch),
                         "--log_steps", str(log_steps), "--skip_checkpoint"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [loss for _, loss in stats["train_loss_log"]]
    step_p50 = statistics.median(stats["window_step_s"])
    line = {"phase": phase, "card": card, "batch": batch, **extra,
            "losses": stats["train_loss_log"], "step_s_p50": step_p50,
            "window_step_s": stats["window_step_s"],
            "images_per_s": batch / step_p50,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "wall_s": wall}
    if flops_per_image is not None:
        line.update(flops_per_image=flops_per_image,
                    flops_per_image_by=VISION_FLOPS,
                    mfu=batch / step_p50 * flops_per_image
                    / PEAK_FLOPS["bfloat16"])
    emit(line)
    if falling and not (losses and all(math.isfinite(v) for v in losses)
                        and losses[-1] < losses[0]):
        raise AssertionError(f"{phase} losses {stats['train_loss_log']}")
    torch.cuda.empty_cache()
    return line, stats


def train_cifar(torch, seed: int, card: str):
    """``cli.cifar_main.main``: resnet56, bf16, batch 128, synthetic
    data, 50 steps."""
    from dtf_tpu_torch.cli import cifar_main

    argv = ["--use_synthetic_data", "--device", "cuda", "--model",
            "resnet56", "--dtype", "bf16", "--train_steps", "50",
            "--skip_eval", "--seed", str(seed)]
    return vision_run(torch, cifar_main.main, argv, "train_cifar", card,
                      128, vision_flops_per_image(torch, "resnet56", 32),
                      model="resnet56", dtype="bf16", steps=50)[0]


def train_imagenet(torch, seed: int, card: str):
    """``cli.imagenet_main.main``: resnet50, bf16, the JAX main's batch
    of 256 (halved while it does not fit), synthetic 224x224, 30 steps;
    then 20 steps of ``--use_trivial_model`` at the same batch, whose
    images/s is the input path's."""
    from dtf_tpu_torch.cli import imagenet_main

    argv = ["--use_synthetic_data", "--device", "cuda", "--dtype", "bf16",
            "--skip_eval", "--seed", str(seed)]
    flops = vision_flops_per_image(torch, "resnet50", 224)
    batch, note = 256, "the JAX main's default batch"
    while True:
        try:
            line, _ = vision_run(
                torch, imagenet_main.main, argv + ["--train_steps", "30"],
                "train_imagenet", card, batch, flops, model="resnet50",
                dtype="bf16", steps=30, batch_note=note)
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            batch //= 2
            note = f"batch halved to {batch}: 2x did not fit"
            if batch < 32:
                raise
    # the probe's loss runs off to inf/NaN on raw 0-255 pixels, as the
    # JAX model's does: the NaN guard would end the run it times
    trivial, _ = vision_run(
        torch, imagenet_main.main,
        argv + ["--use_trivial_model", "--train_steps", "20",
                "--nan_guard", "false"],
        "train_imagenet_trivial", card, batch, falling=False,
        model="trivial", dtype="bf16", steps=20,
        note="the input probe: images/s of synthetic float32 224x224 "
             "batches through the prefetcher")
    return line, trivial


class VisionProfile:
    """torch.profiler over training steps, the device time of each
    kernel put in a kind by the CPU op that launched it: a range around
    each BatchNorm forward (module hooks) and around the optimizer's
    update and apply, and for the backward the autograd node's sequence
    number, which is its forward op's."""

    KINDS = ("convolution (cuDNN)", "BatchNorm", "optimizer",
             "elementwise", "reductions", "copies")

    def __init__(self, trainer):
        self.trainer = trainer

    def _bn_hooks(self):
        from dtf_tpu_torch.models.resnet import BatchNorm
        from torch.autograd.profiler import record_function

        handles, open_ranges = [], []

        def enter(mod, args):
            rf = record_function("batch_norm")
            rf.__enter__()
            open_ranges.append(rf)

        def leave(mod, args, out):
            open_ranges.pop().__exit__(None, None, None)

        for mod in self.trainer.model.modules():
            if isinstance(mod, BatchNorm):
                handles.append(mod.register_forward_pre_hook(enter))
                handles.append(mod.register_forward_hook(leave))
        return handles

    def run(self, state, x, y, steps: int = 2):
        import functools

        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        from dtf_tpu_torch.train import loop

        def ranged(fn):
            @functools.wraps(fn)
            def wrapped(*a, **kw):
                with record_function("optimizer"):
                    return fn(*a, **kw)
            return wrapped

        tx, apply = self.trainer.tx, loop.apply_updates
        self.trainer.tx = tx._replace(update=ranged(tx.update))
        loop.apply_updates = ranged(apply)
        handles = self._bn_hooks()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    state, m = self.trainer.train_step(state, x, y)
                float(m["loss"])
                wall = time.perf_counter() - t0
        finally:
            self.trainer.tx, loop.apply_updates = tx, apply
            for h in handles:
                h.remove()
        return self.summarize(prof, steps, wall), state

    @staticmethod
    def ancestors(ev):
        while ev is not None:
            yield ev
            ev = ev.cpu_parent

    def bn_sequence(self, events):
        """Sequence numbers of the forward ops inside a BN range: their
        autograd nodes' evaluate_function events carry the same."""
        return {ev.sequence_nr for ev in events
                if ev.sequence_nr >= 0
                and any(a.name == "batch_norm" for a in self.ancestors(ev))}

    def kind_of(self, ev, kernel_name: str, bn_seq) -> str:
        """The kind of a kernel that the CPU op ``ev`` launched."""
        chain = list(self.ancestors(ev))
        names = [a.name for a in chain]
        if "optimizer" in names:
            return "optimizer"
        if "batch_norm" in names or any(
                a.name.startswith("autograd::engine::evaluate_function")
                and a.sequence_nr in bn_seq for a in chain):
            return "BatchNorm"
        if any("convolution" in n for n in names):
            return "convolution (cuDNN)"
        k = kernel_name.lower()
        if "reduce" in k:
            return "reductions"
        if any(t in k for t in ("memcpy", "memset", "copy", "fill")):
            return "copies"
        return "elementwise"

    def summarize(self, prof, steps: int, wall: float):
        from torch.autograd import DeviceType

        events = prof.events()
        # the ranges' own spans on the device timeline are no work
        busy = sum(ev.time_range.elapsed_us() for ev in events
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)
                   and ev.name not in ("batch_norm", "optimizer"))
        cpu = [ev for ev in events if ev.device_type == DeviceType.CPU]
        bn_seq = self.bn_sequence(cpu)
        by_kind = dict.fromkeys(self.KINDS, 0.0)
        by_name = {}
        for ev in cpu:
            for k in getattr(ev, "kernels", ()):
                ms = k.duration / 1e3 / steps
                by_kind[self.kind_of(ev, k.name, bn_seq)] += ms
                by_name[k.name] = by_name.get(k.name, 0.0) + ms
        attributed = sum(by_kind.values())
        return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
                "device_busy_ms_per_step": busy / 1e3 / steps,
                "device_idle_share": max(0.0, 1 - busy / 1e6 / wall),
                "device_ms_per_step_by_kind": by_kind,
                "unattributed_ms_per_step": busy / 1e3 / steps - attributed,
                "top_kernels_ms_per_step": [
                    [n[:90], ms] for n, ms in sorted(
                        by_name.items(), key=lambda kv: -kv[1])[:10]]}


def profile_resnets(torch, seed: int, card: str, step_s: dict):
    """Two training steps each of resnet56 at batch 128 and resnet50 at
    batch 256 (bf16) under torch.profiler: device time per step by kind,
    the device's idle share of the profiled steps (the profiler and its
    ranges slow the host) and of the unprofiled step-time p50 in
    ``step_s`` (the main's run).  Raises where the profiler sees no
    convolution kernel."""
    out = {}
    for name, batch in (("resnet56", 128), ("resnet50", 256)):
        trainer, state, x, y = vision_trainer(torch, seed, name, batch)
        state, m = trainer.train_step(state, x, y)
        float(m["loss"])
        summary, state = VisionProfile(trainer).run(state, x, y)
        busy_s = summary["device_busy_ms_per_step"] / 1e3
        line = {"phase": "resnet_profile", "card": card, "model": name,
                "dtype": "bf16", "batch": batch, **summary,
                "step_s_p50_unprofiled": step_s.get(name),
                "device_idle_share_at_p50": (
                    max(0.0, 1 - busy_s / step_s[name]) if name in step_s
                    else None)}
        emit(line)
        if not summary["device_ms_per_step_by_kind"]["convolution (cuDNN)"]:
            raise RuntimeError(f"profiler saw no convolution kernel for "
                               f"{name}: {line}")
        out[name] = line
        del trainer, state, x, y
        torch.cuda.empty_cache()
    return out


def check_resnet_stem(torch, timer, seed: int, card: str):
    """ResNet-50's stem, forward and backward (the weight's gradient) at
    [256, 224, 224, 3] bf16: space-to-depth (the default) against the
    plain 7x7/2 on the same weight.  Outputs within two bf16 steps of
    each row's largest value (``compare``)."""
    from dtf_tpu_torch.models.resnet import Stem

    gen = torch.Generator().manual_seed(seed)
    stems = {}
    for s2d in (True, False):
        stem = Stem(64, space_to_depth=s2d, dtype=torch.bfloat16)
        stems["space_to_depth" if s2d else "plain"] = stem
    w = torch.randn(stems["plain"].weight.shape, generator=gen) * 0.05
    for stem in stems.values():
        with torch.no_grad():
            stem.weight.copy_(w)
        stem.cuda()
    x = torch.randn(256, 224, 224, 3, generator=gen).cuda().bfloat16()
    outs, ms = {}, {}
    for name, stem in stems.items():
        with torch.no_grad():
            outs[name] = stem(x)
        cot = torch.ones_like(outs[name])

        def step(xx, stem=stem, cot=cot):
            stem(xx).backward(cot)

        ms[name] = timer.ms(step, rotated([x], x.numel() * x.element_size()))
    err, tol, ratio = compare(torch, outs["space_to_depth"], outs["plain"])
    line = {"phase": "resnet_stem", "card": card,
            "shape": [256, 224, 224, 3], "dtype": "bf16",
            "fwd_bwd_ms": ms, "max_abs_diff": err,
            "tol_nearest_row": tol, "worst_err_over_tol": ratio}
    emit(line)
    if not ratio <= 1.0:
        raise AssertionError(f"space-to-depth stem against the plain "
                             f"conv: {line}")
    del stems, outs, x
    torch.cuda.empty_cache()
    return line


def train_cifar_files(torch, seed: int, card: str):
    """``cli.cifar_main.main --data_dir`` on the uint8 wire: five train
    files of 256 images and a test file of 1000, written with the port's
    ``write_binary_file`` into a temporary directory; 10 steps of
    resnet56 bf16 at batch 128, then the eval, which must count each of
    the 1000 test examples once (the last of its 8 batches is masked)."""
    import tempfile

    import numpy as np

    from dtf_tpu_torch.cli import cifar_main
    from dtf_tpu_torch.data.cifar import write_binary_file

    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as root:
        d = os.path.join(root, "cifar-10-batches-bin")
        os.makedirs(d)
        for i in range(1, 6):
            write_binary_file(os.path.join(d, f"data_batch_{i}.bin"),
                              rng.integers(0, 256, (256, 32, 32, 3)),
                              rng.integers(0, 10, 256))
        test_n = 1000
        write_binary_file(os.path.join(d, "test_batch.bin"),
                          rng.integers(0, 256, (test_n, 32, 32, 3)),
                          rng.integers(0, 10, test_n))
        t0 = time.perf_counter()
        stats = cifar_main.main(["--data_dir", root, "--device", "cuda",
                                 "--model", "resnet56", "--dtype", "bf16",
                                 "--batch_size", "128", "--train_steps",
                                 "10", "--log_steps", "5", "--seed",
                                 str(seed), "--skip_checkpoint"])
        wall = time.perf_counter() - t0
    losses = [v for _, v in stats["train_loss_log"]]
    line = {"phase": "train_cifar_files", "card": card, "model": "resnet56",
            "dtype": "bf16", "wire": "uint8", "batch": 128, "steps": 10,
            "losses": stats["train_loss_log"],
            "eval_loss": stats.get("eval_loss"),
            "eval_top1": stats.get("accuracy_top_1"),
            "eval_count": stats.get("eval_count"), "test_examples": test_n,
            "wall_s": wall}
    emit(line)
    if not (losses and all(math.isfinite(v) for v in losses)
            and math.isfinite(stats["eval_loss"])
            and stats.get("eval_count") == test_n):
        raise AssertionError(f"cifar_main on written files: {line}")
    torch.cuda.empty_cache()
    return line


def train_resnet(torch, timer, seed: int, card: str):
    """Phase 7, in order: the f32 check, determinism, the two mains,
    the profile (at the mains' step times), the stem, the record
    files; returns the mains' step-time p50s by model."""
    check_resnet_f32(torch, seed, card)
    check_resnet_determinism(torch, seed, card)
    step_s = {"resnet56": train_cifar(torch, seed, card)["step_s_p50"],
              "resnet50": train_imagenet(torch, seed, card)[0]["step_s_p50"]}
    profile_resnets(torch, seed, card, step_s)
    check_resnet_stem(torch, timer, seed, card)
    train_cifar_files(torch, seed, card)
    return step_s


# ---------------------------------------------------------------------------
# phase 8: data parallelism (runtime/mesh.py, cli/launch.py)
# ---------------------------------------------------------------------------

# one rank of a phase-8 run: an entry point's main (or, with a backend
# named, the runner on initialize(cfg, backend=...)), the kernels'
# counters zeroed just before and read just after, then one line of
# results: the per-step losses, the synced step times, the launches and
# a digest of the trained parameters and buffers
DP_RANK = r"""
import hashlib, json, sys, time
sys.path.insert(0, @ROOT@)
import torch
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.config import parse_flags
from dtf_tpu_torch.ops import flash_attention as fa
from dtf_tpu_torch.runtime.mesh import initialize

spec = json.loads(sys.argv[1])
kept = {}
build = runner.build_training
def keep(cfg, rt=None):
    out = build(cfg, rt)
    kept["trainer"] = out[0]
    return out
runner.build_training = keep
main = __import__("dtf_tpu_torch.cli." + spec["main"], fromlist=["main"])
if spec["backend"]:
    cfg = parse_flags(spec["argv"], defaults=getattr(main, spec["defaults"]))
    run = lambda: runner.run(cfg, initialize(cfg, backend=spec["backend"]))
else:
    run = lambda: main.main(spec["argv"])
fa.launches = fa.launches_dq = fa.launches_dkdv = fa.launches_fused = 0
t0 = time.perf_counter()
stats = run()
if torch.cuda.is_available():
    torch.cuda.synchronize()
wall = time.perf_counter() - t0
trainer = kept["trainer"]
digest = hashlib.sha256()
for t in trainer.model.state_dict().values():
    digest.update(t.detach().float().cpu().contiguous().numpy().tobytes())
print("DP_RESULT=" + json.dumps({
    "rank": trainer.rt.rank, "replicas": trainer.rt.num_replicas,
    "backend": trainer.rt.backend, "device": str(trainer.rt.device),
    "threads": torch.get_num_threads(),
    "losses": [v for _, v in stats["train_loss_log"]],
    "window_step_s": stats["window_step_s"], "wall_s": wall,
    "launches": {"K1": fa.launches, "K2a": fa.launches_dq,
                 "K2b": fa.launches_dkdv, "K3": fa.launches_fused},
    "digest": digest.hexdigest()}))
""".replace("@ROOT@", repr(ROOT))
DP_TIMEOUT_S = 300


def dp_results(texts, what: str):
    out = []
    for text in texts:
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("DP_RESULT=")]
        if not lines:
            raise AssertionError(f"{what}: a rank printed no result:\n"
                                 f"{text[-3000:]}")
        out.append(json.loads(lines[-1][len("DP_RESULT="):]))
    return sorted(out, key=lambda r: r["rank"])


def dp_run(spec: dict, world, root: str, what: str):
    """The rank script under ``spec``: through the port's launcher with
    ``world`` ranks (a file rendezvous under ``root``), or, for None,
    one plain process with no topology.  A rank that fails, or a run
    past ``DP_TIMEOUT_S``, fails the phase."""
    from dtf_tpu_torch.cli.launch import launch_local

    cmd = [sys.executable, "-c", DP_RANK, json.dumps(spec)]
    if world is None:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=DP_TIMEOUT_S, cwd=ROOT)
        if proc.returncode:
            raise AssertionError(f"{what}: exit {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}")
        return dp_results([proc.stdout], what)
    log_dir = os.path.join(root, what.replace(" ", "_"))
    rdv = os.path.join(root, what.replace(" ", "_") + ".rendezvous")
    rc = launch_local(cmd, world, f"file://{rdv}", log_dir,
                      timeout_s=DP_TIMEOUT_S)
    texts = []
    for rank in range(world):
        with open(os.path.join(log_dir, f"log{rank}.log")) as f:
            texts.append(f.read())
    if rc:
        raise AssertionError(f"{what}: launcher exit {rc}\n" + "\n".join(
            t[-3000:] for t in texts))
    return dp_results(texts, what)


def dp_world_one(torch, card: str, root: str, main: str, defaults: str,
                 argv, phase: str, **extra):
    """``main`` with ``--distribution_strategy off`` in a plain process
    and with ``multi_worker_mirrored`` through the launcher with one
    rank (a real NCCL group), in turns: off, NCCL, NCCL, off.  Every
    run's per-step losses and weights bit for bit the first's; each
    arm's step-time p50 over its two runs' windows."""
    arms = {"off": None, "multi_worker_mirrored": 1}
    runs = []
    for turn, strategy in enumerate(("off", "multi_worker_mirrored",
                                     "multi_worker_mirrored", "off")):
        spec = {"main": main, "defaults": defaults, "backend": None,
                "argv": argv + ["--distribution_strategy", strategy]}
        torch.cuda.empty_cache()
        runs.append((strategy, dp_run(spec, arms[strategy], root,
                                      f"{phase} {strategy} {turn}")[0]))
    windows = {s: [w for name, r in runs if name == s
                   for w in r["window_step_s"]] for s in arms}
    one = runs[1][1]
    line = {"phase": phase, "card": card, **extra,
            "backend": one["backend"], "replicas": one["replicas"],
            "turns": [name for name, _ in runs],
            "step_s_p50_off": statistics.median(windows["off"]),
            "step_s_p50_nccl_world1": statistics.median(
                windows["multi_worker_mirrored"]),
            "step_s_p50_by_turn": [statistics.median(r["window_step_s"])
                                   for _, r in runs],
            "losses": one["losses"],
            "losses_bit_identical": all(r["losses"] == one["losses"]
                                        for _, r in runs),
            "params_bit_identical": all(r["digest"] == one["digest"]
                                        for _, r in runs),
            "launches_off": runs[0][1]["launches"],
            "launches_nccl_world1": one["launches"],
            "torch_threads": {name: r["threads"] for name, r in runs}}
    line["dp_cost_ms"] = 1e3 * (line["step_s_p50_nccl_world1"]
                                - line["step_s_p50_off"])
    emit(line)
    if not (one["backend"] == "nccl" and one["replicas"] == 1
            and line["losses_bit_identical"]
            and line["params_bit_identical"]
            and all(math.isfinite(v) for v in one["losses"])):
        raise AssertionError(f"{phase}: {line}")
    return line


DP_LOSS_RTOL = 1e-4   # resnet20 f32, 3 steps: the card against the CPU


def dp_two_ranks(torch, card: str, root: str, data_dir: str, seed: int):
    """resnet20 in float32 on the CIFAR files under ``data_dir`` (each
    rank its file shard), 3 steps at a global batch of 32, sync BN off
    and on: two ranks sharing the card over gloo (CUDA tensors), and
    the same two ranks on the CPU.  The ranks end bit-identical; the
    card's losses are within ``DP_LOSS_RTOL`` of the CPU's.  With two
    cards, the same runs over NCCL, one card a rank."""
    lines = []
    for sync_bn in (False, True):
        argv = ["--data_dir", data_dir, "--model", "resnet20", "--dtype",
                "fp32", "--batch_size", "32", "--train_steps", "3",
                "--log_steps", "1", "--skip_eval", "--seed", str(seed),
                "--skip_checkpoint",
                "--distribution_strategy", "multi_worker_mirrored",
                "--sync_bn", str(sync_bn).lower()]
        runs = {}
        cases = [("gloo_cuda", "cuda", "gloo"), ("gloo_cpu", "cpu", None)]
        if torch.cuda.device_count() >= 2:
            cases.append(("nccl_two_cards", "cuda", None))
        for name, device, backend in cases:
            spec = {"main": "cifar_main", "defaults": "CIFAR_DEFAULTS",
                    "backend": backend, "argv": argv + ["--device", device]}
            torch.cuda.empty_cache()
            runs[name] = dp_run(spec, 2, root,
                                f"dp two ranks {name} sync_bn {sync_bn}")
        cpu = runs["gloo_cpu"][0]["losses"]
        for name, ranks in runs.items():
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(ranks[0]["losses"], cpu))
            line = {"phase": "dp_two_ranks", "card": card, "run": name,
                    "sync_bn": sync_bn, "model": "resnet20",
                    "dtype": "fp32", "global_batch": 32, "steps": 3,
                    "backend": ranks[0]["backend"],
                    "devices": [r["device"] for r in ranks],
                    "losses": ranks[0]["losses"],
                    "ranks_bit_identical": (
                        ranks[0]["digest"] == ranks[1]["digest"]
                        and ranks[0]["losses"] == ranks[1]["losses"]),
                    "loss_rel_gap_to_cpu": gap, "tol": DP_LOSS_RTOL,
                    "step_s_p50": statistics.median(
                        ranks[0]["window_step_s"])}
            emit(line)
            lines.append(line)
            if not (line["ranks_bit_identical"] and gap <= DP_LOSS_RTOL
                    and [r["replicas"] for r in ranks] == [2, 2]):
                raise AssertionError(f"dp_two_ranks: {line}")
    if torch.cuda.device_count() < 2:
        emit({"phase": "dp_nccl_multi_card", "measured": False,
              "reason": f"{torch.cuda.device_count()} card on this "
                        f"machine; NCCL across cards is unmeasured"})
    return lines


def train_data_parallel(torch, seed: int, card: str):
    """Phase 8: (a) ``cifar_main`` resnet56 and ``lm_main``
    transformer_tpu, bf16, ``multi_worker_mirrored`` at world 1 through
    the launcher (NCCL) against ``off``: losses and parameters bit for
    bit, both step times, K1 and K3 launches on the LM's data-parallel
    path; (b) two ranks sharing the card over gloo, sync BN off and on,
    against the same ranks on the CPU; (c) NCCL across two cards where
    there are two, else a line saying it is unmeasured."""
    import tempfile

    import numpy as np

    from dtf_tpu_torch.data.cifar import write_binary_file

    steps = 20
    with tempfile.TemporaryDirectory() as root:
        cifar = dp_world_one(
            torch, card, root, "cifar_main", "CIFAR_DEFAULTS",
            ["--use_synthetic_data", "--device", "cuda", "--model",
             "resnet56", "--dtype", "bf16", "--batch_size", "128",
             "--train_steps", str(steps), "--log_steps", "1",
             "--skip_eval", "--seed", str(seed), "--skip_checkpoint"],
            "dp_world1_cifar", model="resnet56", dtype="bf16", batch=128,
            steps=steps)
        b = TRAIN_SHAPE[0]
        lm = dp_world_one(
            torch, card, root, "lm_main", "LM_DEFAULTS",
            ["--use_synthetic_data", "--device", "cuda", "--model",
             "transformer_tpu", "--dtype", "bf16", "--batch_size", str(b),
             "--train_steps", str(steps), "--log_steps", "1", "--seed",
             str(seed), "--skip_checkpoint"],
            "dp_world1_lm", model="transformer_tpu", dtype="bf16", batch=b,
            seq=TRAIN_SHAPE[1], steps=steps)
        want = {"K1": 12 * steps, "K2a": 0, "K2b": 0, "K3": 12 * steps}
        if lm["launches_nccl_world1"] != want:
            raise AssertionError(f"dp_world1_lm launches "
                                 f"{lm['launches_nccl_world1']}, expected "
                                 f"{want}")
        rng = np.random.default_rng(seed)
        d = os.path.join(root, "cifar-10-batches-bin")
        os.makedirs(d)
        for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
                "test_batch.bin"]:
            write_binary_file(os.path.join(d, name),
                              rng.integers(0, 256, (64, 32, 32, 3)),
                              rng.integers(0, 10, 64))
        two = dp_two_ranks(torch, card, root, root, seed)
    return {"cifar": cifar, "lm": lm, "two_ranks": two}


# phase 9: recovery (train/checkpoint.py, chaos/, cli/launch.py supervision)
# ---------------------------------------------------------------------------

# one process of a phase-9 run under the launcher: the main with the
# kernels' counters zeroed just before, then one line of results -- the
# step it resumed at, its per-step losses, its launches, a digest of the
# trained state dict, its checkpoint save and restore times, and (when
# asked) greedy tokens served from the trained parameters as they are
# held in memory, through serve_main's engine
RECOVERY_RANK = r"""
import hashlib, json, sys, time
T0 = time.time()
sys.path.insert(0, @ROOT@)
import numpy as np
import torch
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.ops import flash_attention as fa
from dtf_tpu_torch.ops import paged_attention as pa

spec = json.loads(sys.argv[1])
kept = {}
build, checkpointing = runner.build_training, runner._checkpointing
def keep_build(cfg, rt=None):
    out = build(cfg, rt)
    kept["trainer"] = out[0]
    return out
def keep_checkpointing(cfg, trainer, rt, state):
    t = time.perf_counter()
    out = checkpointing(cfg, trainer, rt, state)
    kept.update(cb=out[0], resumed_step=out[2],
                restore_total_s=time.perf_counter() - t)
    return out
runner.build_training, runner._checkpointing = keep_build, keep_checkpointing
main = __import__("dtf_tpu_torch.cli." + spec["main"], fromlist=["main"])
fa.launches = fa.launches_dq = fa.launches_dkdv = fa.launches_fused = 0
pa.launches = 0
stats = main.main(spec["argv"])
if torch.cuda.is_available():
    torch.cuda.synchronize()
launches = {"K1": fa.launches, "K2a": fa.launches_dq,
            "K2b": fa.launches_dkdv, "K3": fa.launches_fused,
            "K4": pa.launches}
trainer = kept["trainer"]
digest = hashlib.sha256()
for t in trainer.model.state_dict().values():
    digest.update(t.detach().float().cpu().contiguous().numpy().tobytes())
out = {"process_start": T0, "resumed_step": kept["resumed_step"],
       "losses": stats["train_loss_log"], "launches": launches,
       "digest": digest.hexdigest(), "timings": kept["cb"].ckpt.timings,
       "restore_total_s": kept["restore_total_s"]}
if spec.get("serve_argv"):
    from dtf_tpu_torch.cli.serve_main import build_serving_engine
    from dtf_tpu_torch.config import parse_flags
    model, engine = build_serving_engine(parse_flags(spec["serve_argv"]),
                                         random_init=True)
    # the trained parameters as they are held in memory
    model.load_state_dict(trainer.model.state_dict())
    try:
        handles = [engine.submit(np.asarray(p, np.int32),
                                 max_new_tokens=spec["serve_new"])
                   for p in spec["serve_prompts"]]
        out["served_tokens"] = [h.result(timeout=600).tokens
                                for h in handles]
    finally:
        engine.stop(drain=False)
print("RECOVERY_RESULT=" + json.dumps(out))
""".replace("@ROOT@", repr(ROOT))
RECOVERY_TIMEOUT_S = 400
RECOVERY_STEPS = 8


def trace_losses(trace_dir: str) -> dict:
    """{step: [the distinct losses logged at it]} over every attempt's
    ``train_loss`` events (``obs/trace.py``)."""
    from dtf_tpu_torch.obs.trace import read_records

    out: dict = {}
    for rec in read_records(os.path.join(trace_dir, "trace_rank0.jsonl")):
        if rec.get("name") == "train_loss":
            out.setdefault(int(rec["step"]), set()).add(rec["loss"])
    return {k: sorted(v) for k, v in sorted(out.items())}


def recovery_run(root: str, what: str, main: str, argv, fault=None,
                 serve=None, strategy: str = "off") -> dict:
    """``main`` under the port's launcher, one rank of ``strategy``,
    with sealed checkpoints every 2 steps into a fresh model dir and a
    trace; with ``fault``, ``--resume --fault <fault>`` and one restart.
    Returns the last attempt's result line, the losses of the trace,
    the supervisor's events and the run's directories."""
    from dtf_tpu_torch.cli.launch import launch_local

    base = os.path.join(root, what)
    model_dir, trace_dir = base + "_model", base + "_trace"
    log_dir = base + "_logs"
    flags = ["--model_dir", model_dir, "--trace_dir", trace_dir,
             "--checkpoint_steps", "2", "--checkpoint_keep", "2",
             "--step_time_guard_factor", "0", "--log_steps", "1",
             "--train_steps", str(RECOVERY_STEPS),
             "--distribution_strategy", strategy]
    if fault:
        flags += ["--resume", "--fault", fault]
    spec = {"main": main, "argv": argv + flags}
    if serve:
        spec.update(serve)
    t0 = time.time()
    rc = launch_local([sys.executable, "-c", RECOVERY_RANK,
                       json.dumps(spec)], 1,
                      f"file://{base}.rendezvous", log_dir,
                      timeout_s=RECOVERY_TIMEOUT_S,
                      max_restarts=1 if fault else 0,
                      restart_backoff_s=0.1, teardown_grace=30)
    wall = time.time() - t0
    logs = sorted(n for n in os.listdir(log_dir) if n.startswith("log0"))
    with open(os.path.join(log_dir, logs[-1])) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines()
             if ln.startswith("RECOVERY_RESULT=")]
    if rc or not lines:
        raise AssertionError(f"{what}: launcher exit {rc}, "
                             f"{len(lines)} result line(s):\n"
                             f"{text[-3000:]}")
    with open(os.path.join(log_dir, "supervisor_events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    return {"result": json.loads(lines[-1][len("RECOVERY_RESULT="):]),
            "losses": trace_losses(trace_dir), "events": events,
            "model_dir": model_dir, "trace_dir": trace_dir, "wall_s": wall}


def final_payload_sha(model_dir: str) -> str:
    """The sealed manifest's sha256 of the newest step's payload (the
    bytes of ``torch.save``, which writes the same bytes for the same
    tensors)."""
    from dtf_tpu_torch.train.checkpoint import (PAYLOAD, read_manifest,
                                                step_dirs)

    ckpt = os.path.join(model_dir, "checkpoints")
    return read_manifest(ckpt, step_dirs(ckpt)[-1])["files"][PAYLOAD][
        "sha256"]


def first_step_after_restart(run: dict) -> float:
    """Seconds from the supervisor's restart to the resumed process's
    first logged step (its first ``train_loss`` event: a synced step)."""
    from dtf_tpu_torch.obs.trace import read_records

    restart = next(e["ts"] for e in run["events"]
                   if e["event"] == "restart")
    recs = read_records(os.path.join(run["trace_dir"], "trace_rank0.jsonl"))
    last_start = max(i for i, r in enumerate(recs)
                     if r.get("name") == "trace_start")
    first = next(r["ts"] for r in recs[last_start:]
                 if r.get("name") == "train_loss")
    return first - restart


def quiet(fn, *args):
    """``fn(*args)`` with its standard output and error dropped."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*args)


def check_recovered(what: str, base: dict, run: dict, fault: str,
                    resumed_at: int, classification: str) -> dict:
    """A faulted run against its uninterrupted twin: exit 0 after one
    restart of ``classification``, resumed at ``resumed_at``, the losses
    at every step equal as floats, the final state dicts' and final
    checkpoints' digests equal, ``trace_main --check --allow
    injected_fault`` green (and red without the allowance)."""
    from dtf_tpu_torch.cli.trace_main import main as trace_main

    restarts = [e for e in run["events"] if e["event"] == "restart"]
    first_exit = next(e["code"] for e in run["events"]
                      if e["event"] == "rank_exit")
    res, want = run["result"], base["result"]
    line = {
        "fault": fault, "first_exit_code": first_exit,
        "restarts": [e["classification"] for e in restarts],
        "crashes_in_window": [e["crashes_in_window"] for e in restarts],
        "resumed_step": res["resumed_step"],
        "losses": base["losses"],
        "losses_bit_identical": (run["losses"] == base["losses"] and all(
            len(v) == 1 for v in run["losses"].values())
            and sorted(run["losses"]) == list(range(1, RECOVERY_STEPS + 1))),
        "state_dict_sha_equal": res["digest"] == want["digest"],
        "final_checkpoint_sha_equal": (final_payload_sha(run["model_dir"])
                                       == final_payload_sha(
                                           base["model_dir"])),
        "trace_check_allowing_fault": quiet(
            trace_main, [run["trace_dir"], "--check", "--allow",
                         "injected_fault"]),
        "trace_check": quiet(trace_main, [run["trace_dir"], "--check"]),
        "launches_resumed_process": res["launches"],
        "wall_s": run["wall_s"], "baseline_wall_s": base["wall_s"]}
    ok = (line["restarts"] == [classification]
          and first_exit == {"crash": 77, "preempted": 75}[classification]
          and line["resumed_step"] == resumed_at
          and line["losses_bit_identical"]
          and line["state_dict_sha_equal"]
          and line["final_checkpoint_sha_equal"]
          and line["trace_check_allowing_fault"] == 0
          and line["trace_check"] == 1
          and (classification != "preempted"
               or line["crashes_in_window"] == [0]))
    if not ok:
        raise AssertionError(f"{what}: {line}")
    return line


def train_recovery(torch, seed: int, card: str):
    """Phase 9: crash-exact recovery through the entry points.

    (a) ``lm_main`` transformer_tpu bf16 at batch 8 x 2048 under the
    launcher, one ``multi_worker_mirrored`` rank on NCCL: 8 steps
    uninterrupted, sealed checkpoints every 2; then
    from an empty model dir the same with ``--fault crash@step:4
    --max_restarts 1``: exit 0, resumed at step 4, losses equal at every
    step, state digests equal, K1 and K3 launched by the resumed
    process (12 each a step).  A crash fires on its exact step in every
    process, so it lands on a checkpoint boundary: a crash at step 5
    resumes at 4 and dies at 5 again.  (b) ``cifar_main`` resnet56 bf16
    at batch 128 on written CIFAR files the same way (BN buffers, Keras
    SGD momentum, cuDNN), and (c) with ``sigterm@step:3``: exit 75 with
    an emergency checkpoint at step 3, restarted outside the crash
    budget, the same trajectory.  (d) ``serve_main --model_dir`` on the
    LM's checkpoint: greedy tokens equal those served from the trained
    parameters held in memory; K1 and K4 launched.  (e) Save, restore
    and restart times and bytes a step."""
    import shutil
    import tempfile

    import numpy as np

    from dtf_tpu_torch.cli import serve_main
    from dtf_tpu_torch.cli.serve_main import build_serving_engine
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.data.cifar import write_binary_file
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.runtime.mesh import TIMEOUT_S

    tmp = tempfile.gettempdir()
    usage = shutil.disk_usage(tmp)
    emit({"phase": "recovery_disk", "dir": tmp, "free_bytes": usage.free,
          "total_bytes": usage.total})
    rng = np.random.default_rng(seed + 9)
    n_new = 16
    prompts = [rng.integers(0, 32768, (n,)).tolist() for n in (1, 17, 300)]
    serve_argv = ["--model", "transformer_tpu", "--dtype", "bf16",
                  "--device", "cuda", "--seed", str(seed),
                  "--serve_max_batch", "4"]
    b = TRAIN_SHAPE[0]
    lm_argv = ["--use_synthetic_data", "--device", "cuda", "--model",
               "transformer_tpu", "--dtype", "bf16", "--batch_size", str(b),
               "--seed", str(seed)]
    lines = {}
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.empty_cache()
        # one rank of a data-parallel run: the NCCL group, the flat
        # all-reduce, the barrier behind each save, the restore's
        # broadcast of the chosen step
        dp = "multi_worker_mirrored"
        lm_base = recovery_run(root, "lm_base", "lm_main", lm_argv,
                               strategy=dp)
        lm = recovery_run(root, "lm_crash", "lm_main", lm_argv,
                          fault="crash@step:4", strategy=dp,
                          serve={"serve_argv": serve_argv,
                                 "serve_prompts": prompts,
                                 "serve_new": n_new})
        line = check_recovered("recovery_lm", lm_base, lm, "crash@step:4",
                               4, "crash")
        steps_run = RECOVERY_STEPS - 4
        want = {"K1": 12 * steps_run, "K2a": 0, "K2b": 0,
                "K3": 12 * steps_run, "K4": 0}
        if line["launches_resumed_process"] != want:
            raise AssertionError(f"recovery_lm: resumed process launched "
                                 f"{line['launches_resumed_process']}, "
                                 f"expected {want}")
        lines["lm"] = {"phase": "recovery_lm", "card": card,
                       "model": "transformer_tpu", "dtype": "bf16",
                       "batch": b, "seq": TRAIN_SHAPE[1],
                       "distribution_strategy": dp, "ranks": 1, **line}
        emit(lines["lm"])

        # (d) serving the LM's checkpoint through serve_main
        reset_counts(fa, pa)
        out = serve_main.main(serve_argv + [
            "--model_dir", lm["model_dir"], "--serve_requests", "4",
            "--serve_prompt_len", "64", "--serve_max_new_tokens",
            str(n_new)])
        served_launches = kernel_counts(fa, pa)
        model, engine = build_serving_engine(parse_flags(
            serve_argv + ["--model_dir", lm["model_dir"]]))
        try:
            handles = [engine.submit(np.asarray(p, np.int32),
                                     max_new_tokens=n_new) for p in prompts]
            tokens = [h.result(timeout=600).tokens for h in handles]
        finally:
            engine.stop(drain=False)
        del model, engine
        torch.cuda.empty_cache()
        lines["serve"] = {
            "phase": "recovery_serve", "card": card,
            "model_dir": "lm_crash_model", "requests": out["requests"],
            "new_tokens": out["new_tokens"], "launches": served_launches,
            "prompts": [len(p) for p in prompts], "tokens": tokens,
            "token_exact_to_memory": tokens == lm["result"]["served_tokens"]}
        emit(lines["serve"])
        if not (lines["serve"]["token_exact_to_memory"]
                and out["requests"] == 4 and out["shed"] == 0
                and min(served_launches["K1"], served_launches["K4"]) > 0):
            raise AssertionError(f"recovery_serve: {lines['serve']}, "
                                 f"in memory "
                                 f"{lm['result']['served_tokens']}")
        for run in (lm_base, lm):
            shutil.rmtree(run["model_dir"], ignore_errors=True)

        # (b), (c) resnet56 on written CIFAR files
        d = os.path.join(root, "cifar-10-batches-bin")
        os.makedirs(d)
        for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
                "test_batch.bin"]:
            write_binary_file(os.path.join(d, name),
                              rng.integers(0, 256, (256, 32, 32, 3)),
                              rng.integers(0, 10, 256))
        rn_argv = ["--data_dir", root, "--device", "cuda", "--model",
                   "resnet56", "--dtype", "bf16", "--batch_size", "128",
                   "--skip_eval", "--seed", str(seed)]
        rn_base = recovery_run(root, "resnet_base", "cifar_main", rn_argv)
        for key, fault, at, cls in (
                ("resnet_crash", "crash@step:4", 4, "crash"),
                ("resnet_preempt", "sigterm@step:3", 3, "preempted")):
            run = recovery_run(root, key, "cifar_main", rn_argv, fault=fault)
            line = check_recovered(f"recovery_{key}", rn_base, run, fault,
                                   at, cls)
            lines[key] = {"phase": f"recovery_{key}", "card": card,
                          "model": "resnet56", "dtype": "bf16",
                          "batch": 128, **line}
            emit(lines[key])

        # (e) the measurements, from the LM run (1.65 GB a step)
        save = lm["result"]["timings"]["save"]
        restore = lm["result"]["timings"]["restore"]
        lines["measure"] = {
            "phase": "recovery_measure", "card": card,
            "model": "transformer_tpu", "bytes_per_step": save["bytes"],
            "save_ms": {k[:-2] + "_ms": 1e3 * save[k] for k in (
                "state_to_host_s", "payload_s", "fsync_s", "sha256_s",
                "total_s")},
            "restore_ms": {"verify_and_load_ms": 1e3 * restore["total_s"],
                           "with_state_to_device_ms":
                               1e3 * lm["result"]["restore_total_s"]},
            "restart_to_first_step_s": first_step_after_restart(lm),
            "resnet56_bytes_per_step": run["result"]["timings"]["save"][
                "bytes"],
            "resnet56_preempt_restart_to_first_step_s":
                first_step_after_restart(run),
            # the NCCL barrier every rank passes behind rank 0's save,
            # against the group's collective timeout
            "barrier_behind_save_ms": 1e3 * save["barrier_s"],
            "collective_timeout_s": TIMEOUT_S}
        emit(lines["measure"])

    return lines


# ---------------------------------------------------------------------------
# phase 10: ImageNet input (data/records.py, native/, data/imagenet.py,
# data/service) into ResNet-50, and fp16 on the CIFAR ResNet
# ---------------------------------------------------------------------------

IMAGENET_SIZE = (375, 500)     # ImageNet's typical photograph, H x W
IMAGENET_SHARDS = 8            # train files, one service shard each
IMAGENET_PER_FILE = 256        # 2,048 train images: a batch a shard-epoch
IMAGENET_VAL = (2, 150)        # 300 validation images: 2 batches, masked
IMAGENET_BATCH = 256


def write_imagenet(root: str, seed: int) -> dict:
    """The train and validation shards, one process a file: smooth
    375x500 JPEGs (they compress like photographs, ~10x a noise image's
    ratio) with a box each, from ``seed`` (``testing/imagenet.py``)."""
    import concurrent.futures
    import multiprocessing

    from dtf_tpu_torch.testing.imagenet import shard_files, write_shard_file

    files = shard_files(root, IMAGENET_SHARDS, IMAGENET_PER_FILE,
                        *IMAGENET_VAL)
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(files), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        nbytes = sum(pool.map(
            write_shard_file, [f[0] for f in files], [f[1] for f in files],
            [IMAGENET_SIZE] * len(files), [seed * 1000 + f[3] for f in files],
            [True] * len(files), [f[2] for f in files]))
    train = IMAGENET_SHARDS * IMAGENET_PER_FILE
    return {"train_images": train,
            "validation_images": IMAGENET_VAL[0] * IMAGENET_VAL[1],
            "image_hw": list(IMAGENET_SIZE), "jpeg_bytes": nbytes,
            "mean_jpeg_bytes": nbytes / (train + IMAGENET_VAL[0]
                                         * IMAGENET_VAL[1]),
            "write_s": time.perf_counter() - t0}


def imagenet_input(root: str, seed: int, card: str, shards: dict) -> dict:
    """The data service's host rate on the written shards (batches of
    256 on the uint8 wire): inline, then with one spawned reader a
    core (``os.cpu_count()``, capped by the 8 shards), each after a
    warm-up; then two epochs through the decode-once cache with the
    same readers -- the first decodes and fills it, the second is
    served from it (its hit ratio, and its rate)."""
    import tempfile

    from dtf_tpu_torch import native
    from dtf_tpu_torch.data.service import ServiceStream
    from dtf_tpu_torch.obs.registry import MetricsRegistry

    workers = min(os.cpu_count() or 1, IMAGENET_SHARDS)

    def stream(num_workers, **kw):
        return ServiceStream(root, IMAGENET_BATCH, seed=seed,
                             num_shards=IMAGENET_SHARDS,
                             num_workers=num_workers,
                             registry=MetricsRegistry(), **kw)

    def rate(s, warm: int, batches: int) -> float:
        for _ in range(warm):
            next(s)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(s)
        return batches * IMAGENET_BATCH / (time.perf_counter() - t0)

    s = stream(0)
    try:
        inline = rate(s, 1, 2)
    finally:
        s.close()
    t0 = time.perf_counter()
    s = stream(workers)
    try:
        next(s)
        first_batch_s = time.perf_counter() - t0
        pooled = rate(s, workers, 2 * workers)
    finally:
        s.close()
    epoch = IMAGENET_SHARDS      # one batch a shard an epoch
    with tempfile.TemporaryDirectory() as cache:
        s = stream(workers, cache_dir=cache)
        try:
            fill = rate(s, 0, epoch)
            cached = rate(s, 0, epoch)
            hits, lookups = s.cache_stats()
        finally:
            s.close()
    first_epoch = epoch * IMAGENET_BATCH   # every lookup of it a miss
    line = {"phase": "imagenet_input", "card": card, **shards,
            "decode_path": native.decode_path(),
            "decode_unavailable_reason": native.unavailable_reason or None,
            "batch": IMAGENET_BATCH, "wire": "uint8",
            "num_shards": IMAGENET_SHARDS, "cpu_count": os.cpu_count(),
            "cores_usable": len(os.sched_getaffinity(0)),
            "images_per_s_inline": inline,
            "workers": workers, "images_per_s_workers": pooled,
            "first_batch_s_workers": first_batch_s,
            "images_per_s_cache_fill": fill,
            "images_per_s_cache_epoch2": cached,
            "cache_hit_ratio_epoch2": hits / max(lookups - first_epoch, 1),
            "cache_lookups": lookups, "cache_hits": hits}
    emit(line)
    if not (line["cache_hit_ratio_epoch2"] > 0.99 and inline > 0
            and pooled > 0):
        raise AssertionError(f"imagenet_input: {line}")
    return line


def profile_device_ms(path: str) -> dict:
    """Device time in a ``--profile_steps`` Chrome trace: the kernels'
    durations (``cat`` "kernel") and the copies and sets."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {"kernel_ms": 0.0, "memcpy_ms": 0.0, "kernels": 0}
    for ev in events:
        cat = ev.get("cat", "")
        if cat == "kernel":
            out["kernel_ms"] += ev.get("dur", 0) / 1e3
            out["kernels"] += 1
        elif cat in ("gpu_memcpy", "gpu_memset"):
            out["memcpy_ms"] += ev.get("dur", 0) / 1e3
    return out


def train_imagenet_files(torch, root: str, seed: int, card: str,
                         synthetic_p50) -> dict:
    """``cli.imagenet_main.main --data_dir``: resnet50 bf16 at batch 256
    on the written shards through the data service (default workers),
    20 steps with ``--profile_steps 2,3``, then the eval, which must
    count each validation record once: step p50 and images/s beside
    phase 7's synthetic run, the reader-lag gauge (the consumer's wait
    for the last batch), and the profiled steps' device time (a trace
    without device time fails the run)."""
    import tempfile

    from dtf_tpu_torch.cli import imagenet_main
    from dtf_tpu_torch.obs.registry import default_registry

    default_registry().reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        stats = imagenet_main.main([
            "--data_dir", root, "--device", "cuda", "--dtype", "bf16",
            "--batch_size", str(IMAGENET_BATCH), "--train_steps", "20",
            "--log_steps", "5", "--seed", str(seed), "--skip_checkpoint",
            "--input_num_shards", str(IMAGENET_SHARDS),
            "--profile_steps", "2,3", "--model_dir", model_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = profile_device_ms(stats["profile_trace"])
    reg = default_registry()
    lag = reg.get("data_reader_lag_s")
    p50 = statistics.median(stats["window_step_s"])
    line = {"phase": "train_imagenet_files", "card": card,
            "model": "resnet50", "dtype": "bf16", "batch": IMAGENET_BATCH,
            "steps": 20, "wire": "uint8", "decode": stats["input_decode"],
            "losses": stats["train_loss_log"], "step_s_p50": p50,
            "window_step_s": stats["window_step_s"],
            "images_per_s": IMAGENET_BATCH / p50,
            "synthetic_step_s_p50": synthetic_p50,
            "synthetic_images_per_s": (IMAGENET_BATCH / synthetic_p50
                                       if synthetic_p50 else None),
            "step_over_synthetic": (p50 / synthetic_p50 if synthetic_p50
                                    else None),
            "reader_lag_s_last": lag.value if lag is not None else None,
            "profiled_steps": "2,3", "profile_device": prof,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "wall_s": wall}
    emit(line)
    eval_line = {"phase": "imagenet_eval", "card": card,
                 "eval_count": stats.get("eval_count"),
                 "records_written": IMAGENET_VAL[0] * IMAGENET_VAL[1],
                 "eval_loss": stats.get("eval_loss"),
                 "eval_top1": stats.get("accuracy_top_1")}
    emit(eval_line)
    losses = [v for _, v in stats["train_loss_log"]]
    if not (losses and all(math.isfinite(v) for v in losses)
            and prof["kernel_ms"] > 0
            and eval_line["eval_count"] == eval_line["records_written"]
            and math.isfinite(stats["eval_loss"])):
        raise AssertionError(f"train_imagenet_files: {line} {eval_line}")
    torch.cuda.empty_cache()
    return line


def imagenet_resume(torch, root: str, seed: int, card: str) -> dict:
    """resnet50 bf16 b256 on the shards under the launcher, 8 steps,
    sealed checkpoints every 2: uninterrupted with 4 readers; then with
    one reader a core, ``--fault crash@step:4,reader_crash@batch:6``
    and one restart -- the worker count differs from the uninterrupted
    run's, and the reader owning batch 6 is SIGKILLed and respawned (in
    the first attempt, in the resumed one, or both: the prefetcher may
    have reached batch 6 before the crash).  Every step's loss equal as
    a float, the state and final checkpoint digests equal, and at least
    one reader respawn in the supervisor's events."""
    import tempfile

    argv = ["--data_dir", root, "--device", "cuda", "--dtype", "bf16",
            "--batch_size", str(IMAGENET_BATCH), "--skip_eval",
            "--seed", str(seed), "--input_num_shards", str(IMAGENET_SHARDS)]
    workers = min(os.cpu_count() or 1, IMAGENET_SHARDS)
    fault = "crash@step:4,reader_crash@batch:6"
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        base = recovery_run(tmp, "imagenet_base", "imagenet_main",
                            argv + ["--input_workers", "4"])
        run = recovery_run(tmp, "imagenet_crash", "imagenet_main",
                           argv + ["--input_workers", str(workers)],
                           fault=fault)
        line = check_recovered("imagenet_resume", base, run, fault, 4,
                               "crash")
    respawns = [e for e in run["events"] if e["event"] == "reader_crash"]
    line = {"phase": "imagenet_resume", "card": card, "model": "resnet50",
            "dtype": "bf16", "batch": IMAGENET_BATCH,
            "workers_uninterrupted": 4, "workers_resumed": workers,
            "reader_respawns": len(respawns),
            "reader_respawn_positions": [e.get("shard_positions")
                                         for e in respawns], **line}
    emit(line)
    if not respawns:
        raise AssertionError(f"imagenet_resume: no reader respawn: {line}")
    return line


def train_cifar_fp16(torch, seed: int, card: str, bf16_p50) -> list:
    """``cli.cifar_main.main`` resnet56 in fp16 at batch 128, synthetic,
    40 steps: a static loss scale (128, the JAX rule's default) and a
    dynamic one; finite falling losses, step p50 beside phase 7's bf16
    run."""
    from dtf_tpu_torch.cli import cifar_main

    flops = vision_flops_per_image(torch, "resnet56", 32)
    lines = []
    for scale in ("static", "dynamic"):
        argv = ["--use_synthetic_data", "--device", "cuda", "--model",
                "resnet56", "--dtype", "fp16", "--train_steps", "40",
                "--skip_eval", "--seed", str(seed)]
        if scale == "dynamic":
            argv += ["--loss_scale", "dynamic"]
        line, _ = vision_run(torch, cifar_main.main, argv,
                             "train_cifar_fp16", card, 128, flops,
                             model="resnet56", dtype="fp16", steps=40,
                             loss_scale=(128.0 if scale == "static"
                                         else "dynamic"),
                             bf16_step_s_p50=bf16_p50)
        lines.append(line)
    return lines


def train_imagenet_input(torch, seed: int, card: str, step_s: dict):
    """Phase 10: the shards, the service's rates, ResNet-50 on the files
    with its eval and a profiled range, the crash-resume with another
    worker count and a reader crash, then fp16 on resnet56."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        shards = write_imagenet(root, seed)
        imagenet_input(root, seed, card, shards)
        train_imagenet_files(torch, root, seed, card,
                             step_s.get("resnet50"))
        imagenet_resume(torch, root, seed, card)
    train_cifar_fp16(torch, seed, card, step_s.get("resnet56"))


# phase 11: the async parameter server (parallel/ps.py, native/ps.py,
# convert.py's wire layout, cli/launch.py)
# ---------------------------------------------------------------------------

RESNET50_PARAMS = 25_559_081
PS_TIMEOUT_S = 240
PS_HEADER_BYTES = 13         # a push's op, lr and count before its payload

# one rank of a phase-11 launch: the entry point's main, then one line
# with its stats, the TF32 switches it ran under and whether it touched
# CUDA (the store's rank must not)
PS_RANK = r"""
import json, sys
sys.path.insert(0, @ROOT@)
import torch
spec = json.loads(sys.argv[1])
main = __import__("dtf_tpu_torch.cli." + spec["main"], fromlist=["main"])
stats = main.main(spec["argv"])
out = {k: v for k, v in stats.items() if k != "step_timestamp_log"}
out["tf32"] = {"cudnn": torch.backends.cudnn.allow_tf32,
               "matmul": torch.backends.cuda.matmul.allow_tf32}
out["cuda_initialized"] = torch.cuda.is_initialized()
print("PS_RESULT=" + json.dumps(out), flush=True)
""".replace("@ROOT@", repr(ROOT))


def ps_results(log_dir: str, world: int, what: str, suffix: str = ""):
    """Each rank's PS_RESULT line, by rank (0 is the store's)."""
    out = []
    for rank in range(world):
        with open(os.path.join(log_dir, f"log{rank}{suffix}.log")) as f:
            text = f.read()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("PS_RESULT=")]
        if not lines:
            raise AssertionError(f"{what}: rank {rank} printed no result:\n"
                                 f"{text[-3000:]}")
        out.append(json.loads(lines[-1][len("PS_RESULT="):]))
    return out


def ps_store_case(seed: int, card: str) -> dict:
    """The native store (built here at first use, no libjpeg) at
    ResNet-50's size over loopback: pull and push round trips on both
    wires, the bytes a step moves, and the bf16 wire against the numpy
    rule on the client's and the store's conversions, NaNs included."""
    import numpy as np

    from dtf_tpu_torch.native import ps as native_ps
    from dtf_tpu_torch.parallel import ps

    if native_ps.load() is None:
        raise AssertionError(f"ps_store: the native store did not build: "
                             f"{native_ps.unavailable_reason}")
    n = RESNET50_PARAMS
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal(n, dtype=np.float32)
    special = np.asarray([0x7F800001, 0xFFFFFFFF, 0x7FC00000, 0xFFC00000,
                          0x7F80FFFF, 0x7F800000, 0x80000000, 0x00000001,
                          0x3F80FFFF, 0x3F818000], np.uint32)
    p0[::n // len(special)][:len(special)] = special.view(np.float32)
    client_plain = ps.f32_to_bf16_plain(p0)
    client_native = ps._f32_to_bf16(p0)
    g = (rng.standard_normal(n, dtype=np.float32) * 1e-3)
    server = ps.PsServer(port=0)
    out = {"phase": "ps_store", "card": card, "store": server.store,
           "build_s": native_ps.build_seconds,
           "library": os.path.basename(native_ps.lib_path()),
           "params": n}
    try:
        client = ps.PsClient(f"127.0.0.1:{server.port}")
        client.init(p0)
        buf = np.empty(n, np.float32)
        for wire in ("fp32", "bf16"):
            bf16 = wire == "bf16"
            pull_ms, push_ms = [], []
            for i in range(7):
                before = client.counters()
                t = time.perf_counter()
                client.pull(bf16=bf16, out=buf)
                pull_ms.append(1e3 * (time.perf_counter() - t))
                t = time.perf_counter()
                client.push(0.0, g, bf16=bf16)  # lr 0: the params stay
                push_ms.append(1e3 * (time.perf_counter() - t))
                after = client.counters()
            step_bytes = (after["ps_client_pull_bytes"]
                          - before["ps_client_pull_bytes"]
                          + after["ps_client_push_bytes"]
                          - before["ps_client_push_bytes"]
                          - PS_HEADER_BYTES)
            out[wire] = {"pull_ms_p50": statistics.median(pull_ms[2:]),
                         "push_ms_p50": statistics.median(push_ms[2:]),
                         "pull_ms": pull_ms, "push_ms": push_ms,
                         "bytes_per_step": step_bytes,
                         # pull plus push payloads: 4 + 4 or 2 + 2 B
                         "expected_bytes": (4 if bf16 else 8) * n}
        _, f32 = client.pull()
        f32 = f32.copy()
        _, wide = client.pull(bf16=True)
        store_plain = ps.f32_to_bf16_plain(f32).astype(np.uint32) << 16
        client.done()
        client.close()
    finally:
        server.stop()
    nan = np.isnan(p0)
    out.update({
        "nan_inputs": int(nan.sum()),
        "client_bf16_equal_plain": bool(np.array_equal(client_native,
                                                       client_plain)),
        "store_bf16_equal_plain": bool(np.array_equal(wide.view(np.uint32),
                                                      store_plain)),
        "nan_kept": bool(np.isnan(wide[np.isnan(f32)]).all())})
    emit(out)
    if not (out["store"] == "native" and out["client_bf16_equal_plain"]
            and out["store_bf16_equal_plain"] and out["nan_kept"]
            and out["nan_inputs"] >= 5
            and all(out[w]["bytes_per_step"] == out[w]["expected_bytes"]
                    for w in ("fp32", "bf16"))):
        raise AssertionError(f"ps_store: {out}")
    return out


def snapshot_state(path: str):
    """(version, sha256 of params and velocity) of a store snapshot."""
    import hashlib
    import struct

    with open(path, "rb") as f:
        data = f.read()
    version, n = struct.unpack("<QQ", data[8:24])
    return version, hashlib.sha256(data[24:24 + 8 * n]).hexdigest()


def ps_one_worker(torch, seed: int, card: str, root: str) -> dict:
    """resnet56 b128 f32, 10 synthetic steps, an in-process store and
    one worker, twice: losses equal as floats and the final store equal
    (cudnn.deterministic); then the largest relative gap per step to the
    sync ``off`` Trainer from the same initial state (printed only)."""
    from dtf_tpu_torch.cli.cifar_main import CIFAR_DEFAULTS
    from dtf_tpu_torch.cli.runner import run
    from dtf_tpu_torch.config import parse_flags

    steps = 10
    argv = ["--use_synthetic_data", "--device", "cuda", "--model",
            "resnet56", "--dtype", "fp32", "--batch_size", "128",
            "--train_steps", str(steps), "--log_steps", "1", "--skip_eval",
            "--skip_checkpoint", "--seed", str(seed)]
    runs = []
    for i in range(2):
        snap_dir = os.path.join(root, f"one_worker_{i}")
        cfg = parse_flags(argv + [
            "--distribution_strategy", "parameter_server", "--ps_mode",
            "async", "--ps_snapshot_dir", snap_dir], defaults=CIFAR_DEFAULTS)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        stats = quiet(run, cfg)
        wall = time.perf_counter() - t0
        version, sha = snapshot_state(os.path.join(snap_dir,
                                                   "ps_store.snap"))
        runs.append({"losses": [v for _, v in stats["train_loss_log"]],
                     "version": version, "sha": sha, "wall_s": wall,
                     "step_wall_s": stats["step_wall_s"],
                     "store": stats["ps_store"]})
    torch.cuda.empty_cache()
    sync = quiet(run, parse_flags(argv + ["--distribution_strategy", "off"],
                                  defaults=CIFAR_DEFAULTS))
    sync_losses = [v for _, v in sync["train_loss_log"]]
    a, b = runs
    line = {"phase": "ps_one_worker", "card": card, "model": "resnet56",
            "dtype": "fp32", "batch": 128, "steps": steps,
            "store": a["store"], "losses": a["losses"],
            "losses_bit_identical": a["losses"] == b["losses"],
            "store_sha_equal": a["sha"] == b["sha"],
            "versions": [a["version"], b["version"]],
            "step_wall_s_p50": statistics.median(a["step_wall_s"][1:]),
            "wall_s": [a["wall_s"], b["wall_s"]],
            "sync_off_losses": sync_losses,
            "sync_off_step_s_p50": statistics.median(
                sync["window_step_s"]) if sync["window_step_s"] else None,
            "max_rel_gap_to_sync_off": max(
                abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                    sync_losses)),
            "gap_note": "printed, not gated: the store's update on the "
                        "host and the Trainer's on the card may differ "
                        "in the last bit, which a ResNet's f32 gradient "
                        "amplifies"}
    emit(line)
    if not (line["losses_bit_identical"] and line["store_sha_equal"]
            and line["versions"] == [steps, steps]
            and len(a["losses"]) == steps
            and all(math.isfinite(v) for v in a["losses"])):
        raise AssertionError(f"ps_one_worker: {line}")
    return line


def ps_launch(argv, root: str, what: str, world: int, main: str):
    """``main`` under the port's launcher, 1 store + world - 1 workers
    on a TCP coordinator; (results by rank, log dir, wall s)."""
    from dtf_tpu_torch.cli.launch import free_address, launch_local

    log_dir = os.path.join(root, what)
    cmd = [sys.executable, "-c", PS_RANK,
           json.dumps({"main": main, "argv": argv})]
    t0 = time.perf_counter()
    rc = launch_local(cmd, world, free_address(), log_dir,
                      timeout_s=PS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if rc:
        texts = []
        for rank in range(world):
            with open(os.path.join(log_dir, f"log{rank}.log")) as f:
                texts.append(f.read()[-3000:])
        raise AssertionError(f"{what}: launcher exit {rc}\n"
                             + "\n".join(texts))
    return ps_results(log_dir, world, what), log_dir, wall


def span_ms(trace_dir: str, ranks) -> dict:
    """{span name: [ms, ...]} of the step, ps_pull and ps_push spans in
    these ranks' traces."""
    from dtf_tpu_torch.obs.trace import read_records

    out: dict = {"step": [], "ps_pull": [], "ps_push": []}
    for rank in ranks:
        path = os.path.join(trace_dir, f"trace_rank{rank}.jsonl")
        for rec in read_records(path):
            if rec.get("kind") == "span" and rec["name"] in out:
                out[rec["name"]].append(1e3 * rec["dur_s"])
    return out


def ps_reference(torch, seed: int, card: str, root: str) -> list:
    """The reference's deployment shape on the one card: 1 store + 2
    resnet50 workers at the reference's per-worker --batch_size 192 in
    its default fp32, 10 synthetic steps each, through the launcher, on
    the fp32 wire and then the bf16 one."""
    lines = []
    steps, batch = 10, 192
    for wire in ("fp32", "bf16"):
        what = f"ps_reference_{wire}"
        trace_dir = os.path.join(root, what + "_trace")
        argv = ["--use_synthetic_data", "--device", "cuda", "--model",
                "resnet50", "--dtype", "fp32", "--batch_size", str(batch),
                "--train_steps", str(steps), "--log_steps", "1",
                "--skip_eval", "--skip_checkpoint", "--seed", str(seed),
                "--distribution_strategy", "parameter_server",
                "--ps_mode", "async", "--ps_wire", wire,
                "--trace_dir", trace_dir]
        torch.cuda.empty_cache()
        results, log_dir, wall = ps_launch(argv, root, what, 3,
                                           "imagenet_main")
        store, workers = results[0], results[1:]
        with open(os.path.join(log_dir, "log0.log")) as f:
            ps_done = "PS rank done" in f.read()
        spans = span_ms(trace_dir, (1, 2))
        rates = [[1.0 / s for s in w["step_wall_s"][1:]] for w in workers]
        med = {k: statistics.median(v) for k, v in spans.items()}
        line = {"phase": "ps_reference", "card": card, "wire": wire,
                "model": "resnet50", "dtype": "fp32",
                "tf32": workers[0]["tf32"], "workers": 2,
                "batch_per_worker": batch, "steps_per_worker": steps,
                "store": store["ps_store"], "version": store["ps_version"],
                "ps_rank_logged_done": ps_done,
                "ps_rank_touched_cuda": store["cuda_initialized"],
                "steps_per_s_per_worker": [
                    {"median": statistics.median(r), "min": min(r),
                     "max": max(r)} for r in rates],
                "images_per_s_sum": sum(batch * statistics.median(r)
                                        for r in rates),
                "step_ms_p50": med["step"], "ps_pull_ms_p50":
                med["ps_pull"], "ps_push_ms_p50": med["ps_push"],
                "wire_share": (sum(spans["ps_pull"]) + sum(spans["ps_push"]))
                / sum(sum(v) for v in spans.values()),
                "wire_bytes_per_step": [
                    (w["ps_client"]["ps_client_pull_bytes"]
                     + w["ps_client"]["ps_client_push_bytes"]
                     - PS_HEADER_BYTES * w["ps_client"]["ps_client_pushes"])
                    / w["ps_client"]["ps_client_pushes"] for w in workers],
                "peak_memory_bytes": [w["peak_memory_bytes"]
                                      for w in workers],
                "losses": [[v for _, v in w["train_loss_log"]]
                           for w in workers],
                "wall_s": wall}
        emit(line)
        lines.append(line)
        if not (line["version"] == 2 * steps and ps_done
                and not line["ps_rank_touched_cuda"]
                and line["store"] == "native"
                and all(len(v) == steps and all(map(math.isfinite, v))
                        for v in line["losses"])):
            raise AssertionError(f"ps_reference: {line}")
    return lines


def ps_lm(torch, seed: int, card: str) -> dict:
    """transformer_tpu b8 x 2048 bf16 as one async worker, 3 steps: K1
    and K3 launch 12 times a step (counted as phases 6 and 9 count
    them); the parameters' exact count and the bytes a pull moves."""
    from dtf_tpu_torch.cli.lm_main import LM_DEFAULTS
    from dtf_tpu_torch.cli.runner import run
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.ops import flash_attention as fa

    steps = 3
    cfg = parse_flags(
        ["--use_synthetic_data", "--device", "cuda", "--model",
         "transformer_tpu", "--dtype", "bf16", "--batch_size",
         str(TRAIN_SHAPE[0]), "--train_steps", str(steps), "--log_steps",
         "1", "--seed", str(seed), "--skip_eval", "--skip_checkpoint",
         "--distribution_strategy", "parameter_server", "--ps_mode",
         "async"], defaults=LM_DEFAULTS)
    torch.cuda.empty_cache()
    fa.launches = fa.launches_dq = fa.launches_dkdv = fa.launches_fused = 0
    t0 = time.perf_counter()
    stats = quiet(run, cfg)
    wall = time.perf_counter() - t0
    launches = {"K1": fa.launches, "K2a": fa.launches_dq,
                "K2b": fa.launches_dkdv, "K3": fa.launches_fused}
    wire = stats["ps_client"]
    params = wire["ps_client_pull_bytes"] // wire["ps_client_pulls"] // 4
    line = {"phase": "ps_lm", "card": card, "model": "transformer_tpu",
            "dtype": "bf16", "batch": TRAIN_SHAPE[0], "seq": TRAIN_SHAPE[1],
            "steps": steps, "launches": launches, "params": params,
            "pull_bytes": 4 * params, "version": stats["ps_version"],
            "losses": [v for _, v in stats["train_loss_log"]],
            "step_wall_s": stats["step_wall_s"],
            "peak_memory_bytes": stats["peak_memory_bytes"],
            "wall_s": wall}
    emit(line)
    want = {"K1": 12 * steps, "K2a": 0, "K2b": 0, "K3": 12 * steps}
    if not (launches == want and line["version"] == steps
            and all(map(math.isfinite, line["losses"]))):
        raise AssertionError(f"ps_lm: {line}, expected launches {want}")
    return line


def ps_drop_case(torch, seed: int, card: str, root: str) -> dict:
    """One worker under ``--fault ps_drop@version:3``: its client severs
    the connection at version 3, reconnects and finishes every step."""
    from dtf_tpu_torch.cli.cifar_main import CIFAR_DEFAULTS
    from dtf_tpu_torch.cli.runner import run
    from dtf_tpu_torch.config import parse_flags

    steps = 8
    cfg = parse_flags(
        ["--use_synthetic_data", "--device", "cuda", "--model", "resnet56",
         "--dtype", "fp32", "--batch_size", "128", "--train_steps",
         str(steps), "--log_steps", "1", "--skip_eval", "--skip_checkpoint",
         "--seed", str(seed), "--distribution_strategy",
         "parameter_server", "--ps_mode", "async", "--fault",
         "ps_drop@version:3", "--ps_snapshot_dir",
         os.path.join(root, "ps_drop")], defaults=CIFAR_DEFAULTS)
    torch.cuda.empty_cache()
    stats = quiet(run, cfg)
    line = {"phase": "ps_faults", "case": "ps_drop@version:3", "card": card,
            "model": "resnet56", "steps": steps,
            "reconnects": stats["ps_client"]["ps_client_reconnects"],
            "version": stats["ps_version"],
            "losses": [v for _, v in stats["train_loss_log"]]}
    emit(line)
    if not (line["reconnects"] >= 1 and line["version"] == steps
            and len(line["losses"]) == steps
            and all(map(math.isfinite, line["losses"]))):
        raise AssertionError(f"ps_faults ps_drop: {line}")
    return line


def ps_preempt_case(torch, seed: int, card: str, root: str) -> dict:
    """A store's rank preempted by SIGTERM while it serves, under
    ``--ps_snapshot_dir``: the launcher restarts the whole job (a new
    port, restart generation 1), the store restores its final snapshot
    and discards the done count of attempt 0, and the re-run workers
    finish: the final version is the restored one plus their steps."""
    import re
    import signal

    from dtf_tpu_torch.cli.launch import free_address
    from dtf_tpu_torch.obs.watchdog import heartbeat_path, read_heartbeat
    from dtf_tpu_torch.parallel.ps import PsClient

    steps = 20
    log_dir = os.path.join(root, "ps_preempt")
    coordinator = free_address()
    cmd = [sys.executable, "-m", "dtf_tpu_torch.cli.launch",
           "--num_processes", "3", "--max_restarts", "1",
           "--heartbeat_timeout", "120", "--teardown_grace", "10",
           "--coordinator", coordinator, "--log_dir", log_dir, "--",
           sys.executable, "-m", "dtf_tpu_torch.cli.cifar_main",
           "--use_synthetic_data", "--device", "cuda", "--model",
           "resnet56", "--dtype", "fp32", "--batch_size", "128",
           "--train_steps", str(steps), "--log_steps", "1", "--skip_eval",
           "--skip_checkpoint", "--seed", str(seed),
           "--distribution_strategy", "parameter_server", "--ps_mode",
           "async", "--ps_snapshot_dir", os.path.join(root, "ps_snaps"),
           "--ps_snapshot_secs", "1", "--ps_reconnect_secs", "60"]
    t0 = time.perf_counter()
    launcher = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        # wait for the store to reach version 6, then SIGTERM its rank
        # (the pid in its heartbeat file)
        deadline = time.time() + 120
        version = 0
        while version < 6:
            if time.time() > deadline or launcher.poll() is not None:
                raise AssertionError("ps_faults preempt: the store never "
                                     "reached version 6")
            try:
                client = PsClient(coordinator, connect_timeout=1.0)
                version = client.info()[2]
                client.close()
            except OSError:
                pass
            time.sleep(0.2)
        hb = read_heartbeat(heartbeat_path(log_dir, 0))
        os.kill(hb["pid"], signal.SIGTERM)
        killed_at = version
        out, _ = launcher.communicate(timeout=PS_TIMEOUT_S)
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
    wall = time.perf_counter() - t0

    def text(name):
        with open(os.path.join(log_dir, name)) as f:
            return f.read()

    with open(os.path.join(log_dir, "supervisor_events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    first = next((e for e in events if e["event"] == "rank_exit"
                  and e["rank"] == 0 and e["attempt"] == 0), {})
    ps1 = text("log0.retry1.log") if os.path.exists(
        os.path.join(log_dir, "log0.retry1.log")) else ""
    restored = re.search(r"restored snapshot \S+ at version (\d+)", ps1)
    done = re.search(r"PS rank done: version (\d+)", ps1)
    losses = []
    for rank in (1, 2):
        name = f"log{rank}.retry1.log"
        found = re.findall(r"Run stats: .*'loss': ([-\d.e+]+)",
                           text(name) if os.path.exists(
                               os.path.join(log_dir, name)) else "")
        losses.append(float(found[-1]) if found else None)
    line = {"phase": "ps_faults", "case": "ps rank sigterm, resumed",
            "card": card, "model": "resnet56", "steps_per_worker": steps,
            "launcher_exit": launcher.returncode,
            "ps_first_exit": first.get("code"),
            "ps_first_classification": first.get("classification"),
            "sigterm_at_version": killed_at,
            "restarts": [e.get("classification") for e in events
                         if e["event"] == "restart"],
            "restored_version": int(restored.group(1)) if restored else None,
            "done_count_discarded": "discarded" in ps1,
            "final_version": int(done.group(1)) if done else None,
            "worker_losses": losses, "wall_s": wall}
    emit(line)
    if not (line["launcher_exit"] == 0 and line["ps_first_exit"] == 75
            and line["restarts"] == ["preempted"]
            and line["restored_version"]
            and line["restored_version"] >= killed_at
            and line["done_count_discarded"]
            and line["final_version"] == line["restored_version"]
            + 2 * steps
            and all(v is not None and math.isfinite(v) for v in losses)):
        raise AssertionError(f"ps_faults preempt: {line}\n{out[-3000:]}")
    return line


def async_ps(torch, seed: int, card: str) -> dict:
    """Phase 11: the store, one worker twice, the reference's shape
    through the launcher on both wires, the LM worker's kernels, and
    the two faults."""
    import tempfile

    out = {"store": ps_store_case(seed, card)}
    with tempfile.TemporaryDirectory() as root:
        out["one_worker"] = ps_one_worker(torch, seed, card, root)
        out["reference"] = ps_reference(torch, seed, card, root)
        out["lm"] = ps_lm(torch, seed, card)
        out["drop"] = ps_drop_case(torch, seed, card, root)
        out["preempt"] = ps_preempt_case(torch, seed, card, root)
    return out


# ---------------------------------------------------------------------------
# phase 12: serving as the JAX package serves by default (prefix sharing,
# copy-on-write, eviction, cancellation, drain, /metrics, the MFU ledger,
# the contiguous cache)
# ---------------------------------------------------------------------------

# bench_serve.py's shared-prefix arm: tokens after the system prompt and
# new tokens a request
PREFIX_TAIL_LEN, PREFIX_BUDGET = 8, 24
PREFIX_PAGE = 16


def prefix_pool_pages(batch: int, sys_pages: int, page_size: int) -> int:
    """bench_serve.py's pool: one full prompt copy plus each request's
    tail pages fit, ``batch`` unshared copies do not."""
    tail_pages = (-(-(sys_pages * page_size + PREFIX_TAIL_LEN
                      + PREFIX_BUDGET) // page_size) - sys_pages)
    return 1 + (sys_pages + tail_pages) + (batch - 1) * tail_pages


def settle(engine, timeout: float = 300.0) -> None:
    """Wait until the engine thread has retired everything it holds."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        with engine._cond:
            if not engine._pending and all(s is None
                                           for s in engine._slots):
                return
        time.sleep(0.01)
    raise AssertionError("serving engine did not go idle")


def prefix_arm(torch, model, *, sharing: bool, sys_prompt, tails,
               budget: int, pool=None, batch: int = 8) -> dict:
    """A warm request (the system prompt alone: it registers the prefix
    when sharing), then a burst of ``sys_prompt + tail`` requests with
    the kernels' counters zeroed just before and read just after: the
    tokens, concurrency, pool high-water, TTFTs, launches and what they
    should be (K1 per request without a hit, K4 per continuation chunk
    and decode step), and the decode step's ledger row."""
    import numpy as np

    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.serve import ServeEngine, collect_stats

    eng = ServeEngine(model, max_batch=batch, max_seq_len=model.max_seq_len,
                      max_delay_s=0.0, queue_size=64,
                      kv_page_size=PREFIX_PAGE, kv_pool_pages=pool,
                      prefix_sharing=sharing)
    try:
        eng.generate(sys_prompt, max_new_tokens=2)
        settle(eng)
        n_warm = eng.reset_measurement()
        m = eng.metrics
        names = ("serve_prefill_chunks_total", "serve_prefix_hit_pages_total")
        before = [m.get(n).value for n in names]
        steps0 = m.get("serve_decode_step_s").count
        reset_counts(fa, pa)
        t0 = time.time()
        hs = [eng.submit(np.concatenate([sys_prompt, t]).astype(np.int32),
                         max_new_tokens=budget) for t in tails]
        res = [h.result(timeout=600) for h in hs]
        wall = time.time() - t0
        torch.cuda.synchronize()
        launches = kernel_counts(fa, pa)
        chunks, hits = (m.get(n).value - b for n, b in zip(names, before))
        steps = m.get("serve_decode_step_s").count - steps0
        stats = collect_stats(eng.completed[n_warm:], eng.shed_count,
                              wall_time_s=wall)
        out = {"sharing": sharing, "requests": len(tails),
               "pool_pages": eng.pool.num_pages,
               "max_concurrent": eng.max_concurrent,
               "high_water": eng.pool.high_water,
               "hit_pages": hits, "prefill_chunks": chunks,
               "decode_steps": steps, "tokens_per_s": stats.tokens_per_s,
               "ttft_p50_s": stats.ttft_p50_s,
               "ttft_s": sorted(r.time_to_first_token_s for r in res),
               "latency_p50_s": stats.latency_p50_s,
               "launches": launches,
               "ledger_decode_step": eng.ledger.summary().get(
                   "serve_decode_step"),
               "ledger_gauges": {
                   g: m.get(f"ledger_serve_decode_step_{g}").value
                   for g in ("mfu", "hbm_frac", "flops", "bytes")
                   if m.get(f"ledger_serve_decode_step_{g}") is not None},
               "tokens": [r.tokens for r in res]}
    finally:
        eng.stop()
    # requests whose first chunk starts at 0 run K1 once a layer; every
    # other chunk and every decode step runs K4 once a layer
    layers = model.num_layers
    hit_requests = hits // (len(sys_prompt) // PREFIX_PAGE)
    first_chunks = len(tails) - hit_requests
    want = {"K1": layers * first_chunks, "K2a": 0, "K2b": 0, "K3": 0,
            "K4": layers * (chunks - first_chunks + steps)}
    if launches != want:
        raise AssertionError(f"prefix arm (sharing={sharing}): launches "
                             f"{launches}, expected {want}")
    out["hit_requests"] = hit_requests
    return out


def prefix_concurrency(torch, model, rng) -> dict:
    """bench_serve.py's shared-prefix arm at transformer_tpu bf16: a
    128-token system prompt, tails of 8, 24 new tokens, 8 slots, the
    25-page pool.  Sharing must at least double the peak concurrency,
    lower the high-water mark and leave every greedy token unchanged."""
    sys_pages = 8
    sys_prompt = rng.integers(0, model.vocab_size,
                              (sys_pages * PREFIX_PAGE,)).astype("int32")
    tails = [rng.integers(0, model.vocab_size,
                          (PREFIX_TAIL_LEN,)).astype("int32")
             for _ in range(8)]
    pool = prefix_pool_pages(8, sys_pages, PREFIX_PAGE)
    arms = {name: prefix_arm(torch, model, sharing=name == "sharing",
                             sys_prompt=sys_prompt, tails=tails,
                             budget=PREFIX_BUDGET, pool=pool)
            for name in ("sharing", "nosharing")}
    share, plain = arms["sharing"], arms["nosharing"]
    line = {"phase": "prefix_concurrency", "model": "transformer_tpu",
            "dtype": "bf16", "pool_pages": pool, "sys_tokens": 128,
            "tail_tokens": PREFIX_TAIL_LEN, "new_tokens": PREFIX_BUDGET,
            "concurrency_gain": share["max_concurrent"]
            / max(plain["max_concurrent"], 1),
            "tokens_identical": share["tokens"] == plain["tokens"],
            **{f"{k}_{name}": a[k] for name, a in arms.items()
               for k in ("max_concurrent", "high_water", "hit_pages",
                         "hit_requests", "prefill_chunks", "decode_steps",
                         "tokens_per_s", "ttft_p50_s", "launches",
                         "ledger_gauges")}}
    # the shared arm fills the same pool with 4x the sequences, so its
    # high-water mark a live sequence is the comparison that holds
    line["high_water_per_sequence"] = {
        name: a["high_water"] / max(a["max_concurrent"], 1)
        for name, a in arms.items()}
    emit(line)
    per_seq = line["high_water_per_sequence"]
    if not (share["max_concurrent"] >= 2 * plain["max_concurrent"]
            and per_seq["sharing"] < per_seq["nosharing"]
            and line["tokens_identical"] and share["hit_requests"] == 8):
        raise AssertionError(f"prefix concurrency: {line}")
    return arms


def prefix_ttft(torch, model, rng) -> dict:
    """A 1024-token system prompt, 16 requests with tails from U[1, 64]
    and 64 new tokens each, on the full pool: TTFT p50 and tokens/s
    with and without sharing; tokens identical."""
    sys_prompt = rng.integers(0, model.vocab_size, (1024,)).astype("int32")
    tails = [rng.integers(0, model.vocab_size,
                          (int(rng.integers(1, 65)),)).astype("int32")
             for _ in range(16)]
    arms = {name: prefix_arm(torch, model, sharing=name == "sharing",
                             sys_prompt=sys_prompt, tails=tails, budget=64)
            for name in ("sharing", "nosharing")}
    share, plain = arms["sharing"], arms["nosharing"]
    line = {"phase": "prefix_ttft", "model": "transformer_tpu",
            "dtype": "bf16", "sys_tokens": 1024, "requests": 16,
            "new_tokens": 64,
            "tail_tokens": [len(t) for t in tails],
            "ttft_speedup": plain["ttft_p50_s"] / share["ttft_p50_s"],
            "tokens_identical": share["tokens"] == plain["tokens"],
            **{f"{k}_{name}": a[k] for name, a in arms.items()
               for k in ("ttft_p50_s", "ttft_s", "tokens_per_s",
                         "latency_p50_s", "max_concurrent", "high_water",
                         "hit_requests", "prefill_chunks", "launches",
                         "ledger_decode_step", "ledger_gauges")}}
    emit(line)
    gauges = share["ledger_gauges"]
    if not (line["tokens_identical"] and share["hit_requests"] == 16
            and share["ttft_p50_s"] < plain["ttft_p50_s"]
            and share["high_water"] < plain["high_water"]
            and "mfu" in gauges and "hbm_frac" in gauges
            and 0 < gauges["mfu"] < 1 and 0 < gauges["hbm_frac"] < 1):
        raise AssertionError(f"prefix ttft: {line}")
    return arms


def prefix_pressure(torch, model, rng) -> dict:
    """On the 25-page pool with sharing: eviction -- a distinct 300-token
    prompt needs more pages than the cached prefix leaves free, so
    registry-only pages are evicted and it completes (no livelock); a
    cancel -- a request cancelled mid-decode comes back ``cancelled``
    with its pages reclaimed down to what the registry holds; the drain
    -- ``begin_drain`` sheds the next submit with retry_after."""
    import numpy as np

    from dtf_tpu_torch.serve import Backpressure, ServeEngine

    pool = prefix_pool_pages(8, 8, PREFIX_PAGE)
    eng = ServeEngine(model, max_batch=8, max_seq_len=model.max_seq_len,
                      max_delay_s=0.0, kv_page_size=PREFIX_PAGE,
                      kv_pool_pages=pool)
    m = eng.metrics
    try:
        sys_prompt = rng.integers(0, model.vocab_size, (128,)).astype(
            np.int32)
        eng.generate(sys_prompt, max_new_tokens=2)
        settle(eng)
        cached = len(eng.registry)
        big = rng.integers(0, model.vocab_size, (300,)).astype(np.int32)
        t0 = time.time()
        r_big = eng.submit(big, max_new_tokens=20).result(timeout=300)
        evict_s = time.time() - t0
        settle(eng)
        evicted = m.get("serve_prefix_evicted_total").value
        victim = eng.submit(rng.integers(0, model.vocab_size, (64,)).astype(
            np.int32), max_new_tokens=300)
        it = victim.stream(timeout=300)
        streamed = [next(it) for _ in range(3)]
        victim.cancel()
        r_cancel = victim.result(timeout=300)
        settle(eng)
        reclaimed = eng.pool.used_pages == len(eng.registry)
        eng.begin_drain()
        try:
            eng.submit(np.array([1, 2, 3], np.int32), max_new_tokens=2)
            shed_on_drain = False
        except Backpressure as e:
            shed_on_drain = e.retry_after > 0
        line = {"phase": "prefix_pressure", "model": "transformer_tpu",
                "dtype": "bf16", "pool_pages": pool,
                "registry_pages_before": cached,
                "big_prompt_tokens": 300, "big_tokens": len(r_big.tokens),
                "big_s": evict_s, "evicted_pages": evicted,
                "cancelled": r_cancel.cancelled,
                "cancelled_tokens": len(r_cancel.tokens),
                "cancelled_total": m.get("serve_cancelled_total").value,
                "pages_used_after_cancel": eng.pool.used_pages,
                "registry_pages_after_cancel": len(eng.registry),
                "reclaimed_to_registry": reclaimed,
                "shed_on_drain": shed_on_drain,
                "shed_total": eng.shed_count}
    finally:
        eng.stop()
    emit(line)
    if not (evicted > 0 and len(r_big.tokens) == 20 and r_cancel.cancelled
            and 3 <= len(r_cancel.tokens) < 300
            and r_cancel.tokens[:3] == streamed and reclaimed
            and shed_on_drain and eng.failed is None):
        raise AssertionError(f"prefix pressure: {line}")
    return line


def prefix_f32(torch, seed: int, rng) -> dict:
    """transformer_tpu in float32, where the routes agree to ~1e-6 (phase
    3's precision; in bf16 the COW replay's decode route and a prefill
    chunk round differently, so token equality would be chance): COW --
    a 4-page prompt seen twice, the second a full hit replayed into a
    copied page, every token as the unshared engine's; the contiguous
    cache -- 8 requests through kv_page_size 0 and through the paged
    engine, tokens equal, tokens/s side by side."""
    import numpy as np

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.serve import ServeEngine, collect_stats
    from dtf_tpu_torch.serve.bridge import random_init

    model, _ = build_model("transformer_tpu", dtype=torch.float32)
    model = random_init(model, seed).cuda().eval()
    n_new = 16
    prompt = rng.integers(0, model.vocab_size, (4 * PREFIX_PAGE,)).astype(
        np.int32)
    cow = {}
    for sharing in (True, False):
        eng = ServeEngine(model, max_batch=8, max_seq_len=model.max_seq_len,
                          max_delay_s=0.0, kv_page_size=PREFIX_PAGE,
                          prefix_sharing=sharing)
        try:
            runs = []
            for _ in range(2):
                runs.append(eng.generate(prompt, max_new_tokens=n_new).tokens)
                settle(eng)
            cow[sharing] = (runs, eng.metrics.get(
                "serve_prefix_cow_total").value)
        finally:
            eng.stop()
    prompts = [rng.integers(0, model.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(1, 257, 8)]
    layouts = {}
    for name, page in (("paged", PREFIX_PAGE), ("contiguous", 0)):
        eng = ServeEngine(model, max_batch=8, max_seq_len=model.max_seq_len,
                          max_delay_s=0.0, kv_page_size=page)
        try:
            eng.generate(prompts[0], max_new_tokens=2)    # warm
            n0 = eng.reset_measurement()
            t0 = time.time()
            hs = [eng.submit(p, max_new_tokens=32) for p in prompts]
            res = [h.result(timeout=600) for h in hs]
            st = collect_stats(eng.completed[n0:], eng.shed_count,
                               wall_time_s=time.time() - t0)
            layouts[name] = {"tokens": [r.tokens for r in res],
                             "tokens_per_s": st.tokens_per_s,
                             "ttft_p50_s": st.ttft_p50_s,
                             "decode_step_p50_s": eng.metrics.get(
                                 "serve_decode_step_s").percentile(50)}
        finally:
            eng.stop()
    line = {"phase": "prefix_f32", "model": "transformer_tpu",
            "dtype": "fp32", "cow_prompt_tokens": len(prompt),
            "cow_total": cow[True][1],
            "cow_tokens_equal_unshared":
                cow[True][0][1] == cow[True][0][0] == cow[False][0][0]
                == cow[False][0][1],
            "contiguous_tokens_equal_paged":
                layouts["contiguous"]["tokens"] == layouts["paged"]["tokens"],
            "prompt_tokens": [len(p) for p in prompts], "new_tokens": 32,
            **{f"{k}_{name}": v[k] for name, v in layouts.items()
               for k in ("tokens_per_s", "ttft_p50_s", "decode_step_p50_s")}}
    emit(line)
    del model
    torch.cuda.empty_cache()
    if not (line["cow_total"] >= 1 and line["cow_tokens_equal_unshared"]
            and line["contiguous_tokens_equal_paged"]):
        raise AssertionError(f"prefix f32: {line}")
    return line


def scrape(url: str):
    """(status, body) of one GET."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def serve_cli_drain(seed: int, card: str) -> dict:
    """``cli.serve_main`` as its own process on the card, bf16, with
    ``--metrics_port`` and ``--trace_dir``: /metrics carries the serve_*
    and ledger_* series; SIGTERM while it decodes turns /healthz to 503,
    the in-flight requests finish and the process exits 0; ``trace_main
    --ledger --json`` reads its ledger rows."""
    import ast
    import signal
    import socket
    import tempfile
    import urllib.error

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tdir = tempfile.mkdtemp(prefix="serve_drain_")
    n_req = 16
    argv = [sys.executable, "-m", "dtf_tpu_torch.cli.serve_main",
            "--serve_random_init", "--device", "cuda", "--model",
            "transformer_tpu", "--dtype", "bf16", "--seed", str(seed),
            "--serve_max_batch", "8", "--serve_requests", str(n_req),
            "--serve_prompt_len", "512", "--serve_max_new_tokens", "512",
            "--metrics_port", str(port), "--trace_dir", tdir]
    t0 = time.time()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    body, steps_at_signal, healthz = "", 0.0, []
    try:
        deadline = time.time() + 300
        while time.time() < deadline and proc.poll() is None:
            try:
                status, body = scrape(f"{base}/metrics")
            except (urllib.error.URLError, OSError):
                time.sleep(0.2)
                continue
            counts = [ln for ln in body.splitlines()
                      if ln.startswith("serve_decode_step_s_count")]
            if counts and float(counts[0].split()[1]) >= 20:
                steps_at_signal = float(counts[0].split()[1])
                break
            time.sleep(0.1)
        if not steps_at_signal:
            raise AssertionError("serve_main never reached 20 decode steps "
                                 "on /metrics")
        signal_s = time.time() - t0
        proc.send_signal(signal.SIGTERM)
        while proc.poll() is None:
            try:
                status, hz = scrape(f"{base}/healthz")
                healthz.append((status, json.loads(hz).get("draining")))
            except (urllib.error.URLError, OSError, ValueError):
                break
            time.sleep(0.2)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    stats_lines = [ln for ln in err.splitlines() if "Serve stats:" in ln]
    stats = (ast.literal_eval(stats_lines[-1].split("Serve stats:", 1)[1]
                              .strip()) if stats_lines else {})
    series = sorted({ln.split()[2] for ln in body.splitlines()
                     if ln.startswith("# TYPE ")})
    rows = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.cli.trace_main", tdir,
         "--ledger", "--json"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    ledger_rows = (json.loads(rows.stdout)["ledger"] if rows.returncode == 0
                   else rows.stderr[-500:])
    line = {"phase": "serve_cli_drain", "card": card,
            "model": "transformer_tpu", "dtype": "bf16",
            "returncode": proc.returncode, "requests": n_req,
            "signal_after_s": signal_s,
            "decode_steps_at_signal": steps_at_signal,
            "wall_s": time.time() - t0,
            "healthz_503_while_draining": any(
                s == 503 and d for s, d in healthz),
            "healthz_samples": len(healthz),
            "serve_series": [n for n in series if n.startswith("serve_")],
            "ledger_series": [n for n in series if n.startswith("ledger_")],
            "stats": {k: stats.get(k) for k in (
                "requests", "shed", "new_tokens", "tokens_per_second",
                "ttft_p50_s", "decode_steps", "prefix_sharing", "drained")},
            "ledger_rows": ledger_rows,
            "stderr_tail": err[-1500:] if proc.returncode else ""}
    emit(line)
    want_series = {"serve_prefix_hit_pages_total", "serve_prefix_cow_total",
                   "serve_prefix_evicted_total", "serve_cancelled_total",
                   "serve_kv_pages_shared_refs", "serve_stream_lag_s",
                   "ledger_serve_decode_step_mfu",
                   "ledger_serve_decode_step_hbm_frac"}
    if not (proc.returncode == 0 and line["healthz_503_while_draining"]
            and "SIGTERM - draining" in err
            and stats.get("drained") is True
            and stats.get("requests", 0) + stats.get("shed", 0) == n_req
            and stats.get("requests", 0) > 0
            and stats.get("new_tokens") == stats.get("requests") * 512
            and want_series <= set(series)
            and isinstance(ledger_rows, list) and ledger_rows):
        raise AssertionError(f"serve_main drain: {line}")
    return line


def serve_prefix(torch, seed: int, card: str) -> dict:
    """Phase 12 (see the module docstring)."""
    import numpy as np

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.serve.bridge import random_init

    rng = np.random.default_rng(seed + 12)
    model, _ = build_model("transformer_tpu", dtype=torch.bfloat16)
    model = random_init(model, seed).cuda().eval()
    try:
        out = {"concurrency": prefix_concurrency(torch, model, rng),
               "ttft": prefix_ttft(torch, model, rng),
               "pressure": prefix_pressure(torch, model, rng)}
    finally:
        del model
        torch.cuda.empty_cache()
    out["f32"] = prefix_f32(torch, seed, rng)
    out["cli"] = serve_cli_drain(seed, card)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available; this script runs the port on "
                    "an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "dtf_tpu_torch")):
        return fail("dtf_tpu_torch/ is not beside this script; run it from "
                    "a checkout of the repository")
    sys.path.insert(0, ROOT)
    from dtf_tpu_torch.ops import _build
    from dtf_tpu_torch.runtime.device import resolve_device

    # phase 1: the card and the build
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": time.perf_counter() - t0,
          "build_s_per_source": _build.build_seconds,
          "ptxas": {n: _build.ptxas_report(n) for n in _build.SOURCES}})

    # phase 2: each kernel against its plain version
    clock = PhaseClock()
    gen = torch.Generator().manual_seed(args.seed)
    timer = Timer(torch)
    k1 = check_flash(torch, timer, gen)
    _, bwd = check_backward(torch, timer, gen)
    k4 = check_paged(torch, timer, gen)
    check_peaked(torch, gen)
    clock.done("2")

    # phases 3 and 4: the serving path
    per_call = check_serving_f32(torch, args.seed)
    serve_launches = serve_bf16(torch, args.seed, per_call)
    decode_profile = profile_decode_step(torch, args.seed)
    clock.done("3-4")

    # phases 5 and 6: the training path
    train32 = check_training_f32(torch, args.seed)
    check_training_bf16(torch, args.seed)
    train = train_bf16(torch, args.seed)
    # the split pair's path at the training shape, beside K3's
    train_split = train_bf16(torch, args.seed, split=True, steps=20)
    profile_train_step(torch, args.seed)
    clock.done("5-6")

    # phase 7: ResNet training (no TPU kernel lies on this path)
    resnet_step_s = train_resnet(torch, timer, args.seed, card)
    clock.done("7")

    # phase 8: data parallelism (K1 and K3 on the LM's path)
    dp = train_data_parallel(torch, args.seed, card)
    dp_run_name = ("lm_main multi_worker_mirrored, one rank on NCCL, "
                   "20 steps (phase 8)")
    clock.done("8")

    # phase 9: recovery (K1 and K3 in the resumed LM run, K1 and K4
    # serving its checkpoint)
    rec = train_recovery(torch, args.seed, card)
    rec_run = ("lm_main resumed after crash@step:4, steps 5-8, one "
               "process (phase 9)")
    rec_serve_run = "serve_main --model_dir, 4 requests (phase 9)"
    clock.done("9")

    # phase 10: ImageNet input into ResNet-50 and fp16 (no TPU kernel
    # lies on this path either)
    train_imagenet_input(torch, args.seed, card, resnet_step_s)
    clock.done("10")

    # phase 11: the async parameter server (K1 and K3 in the LM worker)
    ps = async_ps(torch, args.seed, card)
    ps_lm_run = ("lm_main --ps_mode async, one worker, 3 steps "
                 "(phase 11)")
    clock.done("11")

    # phase 12: serving as the JAX package serves by default (K1 on
    # first chunks without a hit, K4 on everything else)
    prefix = serve_prefix(torch, args.seed, card)
    launches_prefix = {
        f"{arm}_{name}": prefix[arm][name]["launches"]
        for arm in ("concurrency", "ttft")
        for name in ("sharing", "nosharing")}
    prefix_run = ("phase 12 shared-prefix bursts after a warm request, "
                  "bf16: concurrency (128-token system prompt, 8 tails "
                  "of 8, the 25-page pool) and ttft (1024-token system "
                  "prompt, 16 tails of U[1, 64]), with and without "
                  "sharing")
    clock.done("12")

    keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    f32_keys = ("bound_cuda_core_ms",)

    def entry(name, source, replaces, main_case, launches, run, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "design": main_case["design"],
                "launches": launches, "launches_run": run,
                "main_path_case": {k: main_case[k] for k in main_case
                                   if k in ("shape", "causal", "case",
                                            "dtype")},
                **{k: main_case[k] for k in keys},
                **{k: main_case[k] for k in f32_keys if k in main_case},
                **extra}

    # the cases the runs launch most: K1 at the training shape (and a
    # 64-token first chunk when serving), K4 at a decode step over 8 rows;
    # each flash kernel on both routes, a bf16 case with the launches of
    # a bf16 run (phase 6 and its split companion), an f32 case with
    # those of phase 5's f32 AdamW steps
    def k1_case(dname):
        return next(c for c in k1 if c["dtype"] == dname
                    and c["shape"] == list(TRAIN_SHAPE) and c["causal"])

    def k4_case(dname, case):
        return next(c for c in k4 if c["dtype"] == dname
                    and c["case"] == case)

    def k4_brief(c):
        return {k: c[k] for k in ("case", "shape", "dtype", "design",
                                  "max_abs_err", "tol", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}

    split32 = train32["launches"]["adamw_K2a+K2b"]
    fused32 = train32["launches"]["adamw_K3"]
    f32_run = "train f32, 3 AdamW steps bound to K3 (phase 5)"
    split32_run = ("train f32, 3 AdamW steps bound to fused_bwd=False "
                   "(phase 5)")
    split_run = "train bound to fused_bwd=False (phase 6 companion)"
    emit({"kernels": [
        entry("K1", "dtf_tpu_torch/csrc/flash_fwd_tc.cuh",
              "dtf_tpu/ops/flash_attention.py:98", k1_case("bfloat16"),
              train["launches"]["K1"], "train (phase 6)",
              launches_dp=dp["lm"]["launches_nccl_world1"]["K1"],
              launches_dp_run=dp_run_name,
              launches_recovery=rec["lm"]["launches_resumed_process"]["K1"],
              launches_recovery_run=rec_run,
              launches_async=ps["lm"]["launches"]["K1"],
              launches_async_run=ps_lm_run,
              launches_recovery_serve=rec["serve"]["launches"]["K1"],
              launches_recovery_serve_run=rec_serve_run,
              launches_serve=serve_launches["K1"],
              launches_per_serve_call={c: n["K1"]
                                       for c, n in per_call.items()},
              launches_prefix={a: n["K1"]
                               for a, n in launches_prefix.items()},
              launches_prefix_run=prefix_run),
        entry("K1 f32", "dtf_tpu_torch/csrc/flash_fwd_x3.cuh",
              "dtf_tpu/ops/flash_attention.py:98", k1_case("float32"),
              fused32["K1"], f32_run,
              serving_chunk_ms=next(
                  c["ms"] for c in k1 if c["dtype"] == "float32"
                  and c["shape"] == [1, 64, 6, 128] and c["causal"]),
              step_ms_f32=train32["step_ms"]),
        entry("K2a", "dtf_tpu_torch/csrc/flash_bwd_dq_tc.cuh",
              "dtf_tpu/ops/flash_attention.py:258", bwd["K2a"],
              train_split["launches"]["K2a"], split_run),
        entry("K2a f32", "dtf_tpu_torch/csrc/flash_bwd_dq_x3.cuh",
              "dtf_tpu/ops/flash_attention.py:258", bwd["K2a float32"],
              split32["K2a"], split32_run),
        entry("K2b", "dtf_tpu_torch/csrc/flash_bwd_tc.cuh",
              "dtf_tpu/ops/flash_attention.py:317", bwd["K2b"],
              train_split["launches"]["K2b"], split_run),
        entry("K2b f32", "dtf_tpu_torch/csrc/flash_bwd_x3.cuh",
              "dtf_tpu/ops/flash_attention.py:317", bwd["K2b float32"],
              split32["K2b"], split32_run),
        entry("K3", "dtf_tpu_torch/csrc/flash_bwd_tc.cuh",
              "dtf_tpu/ops/flash_attention.py:367", bwd["K3"],
              train["launches"]["K3"], "train (phase 6)",
              launches_dp=dp["lm"]["launches_nccl_world1"]["K3"],
              launches_dp_run=dp_run_name,
              launches_recovery=rec["lm"]["launches_resumed_process"]["K3"],
              launches_recovery_run=rec_run,
              launches_async=ps["lm"]["launches"]["K3"],
              launches_async_run=ps_lm_run,
              partial_bytes=bwd["K3"]["partial_bytes"],
              passes_ms=bwd["K3"]["passes_ms"]),
        entry("K3 f32", "dtf_tpu_torch/csrc/flash_bwd_x3.cuh",
              "dtf_tpu/ops/flash_attention.py:367", bwd["K3 float32"],
              fused32["K3"], f32_run,
              partial_bytes=bwd["K3 float32"]["partial_bytes"],
              passes_ms=bwd["K3 float32"]["passes_ms"],
              step_ms_f32=train32["step_ms"]),
        entry("K4", "dtf_tpu_torch/csrc/paged_decode.cu",
              "dtf_tpu/ops/paged_attention.py:170",
              k4_case("bfloat16", "decode"), serve_launches["K4"],
              "serve (phase 4)",
              launches_recovery_serve=rec["serve"]["launches"]["K4"],
              launches_recovery_serve_run=rec_serve_run,
              launches_per_serve_call={c: n["K4"]
                                       for c, n in per_call.items()},
              launches_prefix={a: n["K4"]
                               for a, n in launches_prefix.items()},
              launches_prefix_run=prefix_run,
              keys_per_split=k4[0]["keys_per_split"],
              chunk_case=k4_brief(k4_case("bfloat16", "chunk@1984")),
              f32_decode_case=k4_brief(k4_case("float32", "decode")),
              passes_ms_per_call=decode_profile["k4_passes_ms_per_call"],
              decode_step_share=decode_profile["k4_share_of_busy"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
