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
                 the same inputs on the card, at the serving path's
                 shapes: max abs error and tolerance (per output row),
                 then kernel, plain and library times (CUDA events,
                 warmed up, median of five, inputs rotated through
                 enough copies to defeat the 50 MB L2) and the least
                 time the card could take.
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
                 read just after; both kernels must have run, as many
                 times per first prefill chunk (K1) and per decode step
                 and continuation chunk (K4) as phase 3 counted.

Then the ``{"kernels": [...]}`` line (with the serving run's launch
counts) and, last, the device line.  Any failure raises: the script
exits non-zero and prints no result.  Without CUDA, or without the
``dtf_tpu_torch`` package beside it, it exits 2 before doing anything.
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
PEAK_FLOPS = {"float32": 67e12,      # CUDA cores, no tensor cores
              "bfloat16": 989e12}    # dense tensor cores
L2_BYTES = 50e6


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


def compare(torch, out, ref):
    """Kernel output against its plain version, row by row (a row is one
    query and head: the last dim).  float32: 1e-5.  bfloat16: o is
    rounded to 8 significant bits, and the kernel and the plain version
    add their f32 terms in different orders, so a value may round one
    bf16 step apart: each row within two bf16 steps at its own largest
    |ref|, 2^(e - 6) for that maximum in [2^e, 2^(e+1)).

    Returns (max abs error, the tolerance of the row nearest its limit,
    that row's error over its tolerance)."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    if out.dtype == torch.float32:
        tol = torch.full_like(err, 1e-5)
    else:
        top = ref.abs().amax(-1).clamp_min(2.0 ** -126)
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


def check_flash(torch, timer, gen):
    """K1 against its plain version: [1, 64, 6, 128] (a first prefill
    chunk) and [1, 2048, 6, 128] (a whole-context chunk), causal and
    full, float32 and bfloat16."""
    import torch.nn.functional as F

    from dtf_tpu_torch.ops import flash_attention as fa

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for shape in ((1, 64, 6, 128), (1, 2048, 6, 128)):
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
                bound_ms, bound_by = bound(4 * b * h * d * pairs, nbytes,
                                           dname)
                copies = rotated((q, k, v), 3 * q.numel() * elem)
                tq = [tuple(t.transpose(1, 2).contiguous() for t in c)
                      for c in copies]
                cases.append({
                    "shape": list(shape), "causal": causal, "dtype": dname,
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
                    "bound_ms": bound_ms, "bound_by": bound_by})
                emit({"phase": "kernels", "kernel": "K1", **cases[-1]})
    return cases


def check_paged(torch, timer, gen):
    """K4 against its plain version: a decode step [8, 1, 6, 128] over
    rows holding {1, 15, 16, 17, 1000, 2047} tokens plus two idle rows
    (all-zero tables), and a continuation chunk [1, 64, 6, 128] at
    start 0, 64 and 1984; pools of 1025 pages of 16, 128 pages a row --
    the serving engine's layout at max_batch 8."""
    from dtf_tpu_torch.ops import paged_attention as pa

    pages, page, m, h, d = 1025, 16, 128, 6, 128
    lengths = [1, 15, 16, 17, 1000, 2047, 0, 0]
    table = torch.zeros(len(lengths), m, dtype=torch.int32)
    perm = torch.randperm(pages - 1, generator=gen) + 1
    used = 0
    for row, n_tok in enumerate(lengths):
        n = -(-n_tok // page)
        table[row, :n] = perm[used:used + n]
        used += n
    index = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    setups = [("decode", table, index, 1)]
    full_row = table[5:6].clone()            # 128 pages: 2048 positions
    for start in (0, 64, 1984):
        setups.append((f"chunk@{start}", full_row,
                       torch.tensor([start], dtype=torch.int32), 64))

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        pool_k, pool_v = (torch.randn(pages, page, h, d,
                                      generator=gen).to("cuda", dtype)
                          for _ in range(2))
        elem = pool_k.element_size()
        for name, tab, idx, s in setups:
            tab_c, idx_c = tab.cuda(), idx.cuda()
            q = torch.randn(tab.shape[0], s, h, d,
                            generator=gen).to("cuda", dtype)
            o = pa.paged_flash_decode(q, pool_k, pool_v, tab_c, idx_c)
            po = pa.paged_flash_decode_reference(q, pool_k, pool_v, tab_c,
                                                 idx_c)
            torch.cuda.synchronize()
            err, tol, ratio = compare(torch, o, po)
            if not ratio <= 1.0:
                raise AssertionError(f"K4 {dname} {name}: err {err}, worst "
                                     f"row at {ratio} of its tol {tol}")
            # what this run's data needs: each row's live keys (index +
            # S, within the table) read once from K and V, q read, o
            # written, the table and index read
            keys = [min(int(i) + s, m * page) for i in idx.tolist()]
            nbytes = (2 * sum(keys) * h * d * elem + 2 * q.numel() * elem
                      + tab.numel() * 4 + idx.numel() * 4)
            pairs = sum(min(int(i) + j + 1, m * page)
                        for i in idx.tolist() for j in range(s))
            bound_ms, bound_by = bound(4 * h * d * pairs, nbytes, dname)
            copies = rotated((q, pool_k, pool_v, tab_c, idx_c),
                             2 * sum(keys) * h * d * elem)
            cases.append({
                "case": name, "shape": list(q.shape), "dtype": dname,
                "row_keys": keys, "max_abs_err": err, "tol": tol,
                "err_over_tol": ratio,
                "ms": timer.ms(pa.paged_flash_decode, copies),
                "plain_ms": timer.ms(pa.paged_flash_decode_reference,
                                     copies[:1]),
                "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by})
            emit({"phase": "kernels", "kernel": "K4", **cases[-1]})
        del pool_k, pool_v
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
    fa.launches = 0
    pa.launches = 0
    out = serve_main.main(argv)
    launches = {"K1": fa.launches, "K4": pa.launches}
    if not (out["requests"] == n_req and out["shed"] == 0
            and out["new_tokens"] == out["streamed_tokens"]
            == n_req * n_new):
        raise AssertionError(f"serving run incomplete: {out}")
    # every request has one first chunk (K1); every other chunk and
    # every decode step attends over pages (K4), each as many times as
    # phase 3 counted in one such call
    want = {"K1": per_call["first_chunk"]["K1"] * n_req,
            "K4": per_call["decode_step"]["K4"] * out["decode_steps"]
            + per_call["continuation_chunk"]["K4"]
            * (out["prefill_chunks"] - n_req)}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    emit({"phase": "serve", "model": "transformer_tpu", "dtype": "bf16",
          **out, "launches": launches})
    return launches


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
          "build_s_per_kernel": _build.build_seconds,
          "ptxas": {n: _build.ptxas_report(n) for n in _build.SIGNATURES}})

    # phase 2: each kernel against its plain version
    gen = torch.Generator().manual_seed(args.seed)
    timer = Timer(torch)
    k1 = check_flash(torch, timer, gen)
    k4 = check_paged(torch, timer, gen)

    # phases 3 and 4: the serving path
    per_call = check_serving_f32(torch, args.seed)
    launches = serve_bf16(torch, args.seed, per_call)

    def entry(name, source, replaces, cases, main_case):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                # counted in phase 3, one model call of each kind
                "launches_per_call": {c: n[name]
                                      for c, n in per_call.items()},
                "main_path_case": {k: main_case[k] for k in main_case
                                   if k in ("shape", "causal", "case",
                                            "dtype")},
                **{k: main_case[k] for k in
                   ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")},
                "cases": cases}

    # the cases the bf16 serving run launches most: a 64-token first
    # chunk (K1) and a decode step over 8 rows (K4)
    k1_main = next(c for c in k1 if c["dtype"] == "bfloat16"
                   and c["shape"][1] == 64 and c["causal"])
    k4_main = next(c for c in k4 if c["dtype"] == "bfloat16"
                   and c["case"] == "decode")
    emit({"kernels": [
        entry("K1", "dtf_tpu_torch/csrc/flash_fwd.cu",
              "dtf_tpu/ops/flash_attention.py:98", k1, k1_main),
        entry("K4", "dtf_tpu_torch/csrc/paged_decode.cu",
              "dtf_tpu/ops/paged_attention.py:170", k4, k4_main)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
