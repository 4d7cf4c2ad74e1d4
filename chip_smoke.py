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

Then the ``{"kernels": [...]}`` line -- each kernel's main case (every
case is on its own phase-2 line), its design and its launches from the
run of its path: K1 and K3 phase 6, K2a and K2b phase 6's companion,
the f32 routes phase 5's f32 AdamW steps, K4 serving -- and, last, the
device line.  Any failure raises: the script exits non-zero and prints
no result.
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
            "--log_steps", str(log_steps), "--seed", str(seed)]
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
    emit(out)
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
    gen = torch.Generator().manual_seed(args.seed)
    timer = Timer(torch)
    k1 = check_flash(torch, timer, gen)
    _, bwd = check_backward(torch, timer, gen)
    k4 = check_paged(torch, timer, gen)
    check_peaked(torch, gen)

    # phases 3 and 4: the serving path
    per_call = check_serving_f32(torch, args.seed)
    serve_launches = serve_bf16(torch, args.seed, per_call)
    decode_profile = profile_decode_step(torch, args.seed)

    # phases 5 and 6: the training path
    train32 = check_training_f32(torch, args.seed)
    check_training_bf16(torch, args.seed)
    train = train_bf16(torch, args.seed)
    # the split pair's path at the training shape, beside K3's
    train_split = train_bf16(torch, args.seed, split=True, steps=20)
    profile_train_step(torch, args.seed)

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
              launches_serve=serve_launches["K1"],
              launches_per_serve_call={c: n["K1"]
                                       for c, n in per_call.items()}),
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
              launches_per_serve_call={c: n["K4"]
                                       for c, n in per_call.items()},
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
