"""Always-on MFU/cost ledger -- per-executable FLOPs, bytes and
achieved-utilization gauges; the PyTorch counterpart of
``dtf_tpu/obs/ledger.py`` (the port imports nothing of dtf_tpu).

The train loop and the serving decoder register each executable -- the
train step, the decode step, each prefill chunk length -- with its
operation count, feed it the wall times they already measure across a
device sync, and the ledger exports, under the JAX package's names,

  ledger_<exec>_flops            gauge   operations a call (mean)
  ledger_<exec>_bytes            gauge   bytes a call (mean; where known)
  ledger_<exec>_wall_s           gauge   running-mean measured wall time
  ledger_<exec>_calls            gauge   observations folded in
  ledger_<exec>_achieved_tflops  gauge   flops / mean wall / 1e12
  ledger_<exec>_mfu              gauge   achieved / peak FLOP/s
  ledger_<exec>_hbm_frac         gauge   achieved bytes/s / peak HBM b/s

into the registry that owns the subsystem (the engine's
``engine.metrics``, the trainer's default registry), scraped live
through ``obs/prom.py`` (``--metrics_port``).  Registrations and
summaries also land in the trace stream (``ledger_exec`` /
``ledger_summary`` events), so ``trace_main --ledger`` renders the
table from trace files alone.

Peaks come from the card's name (``torch.cuda.get_device_name``), the
data sheets' dense bf16 TFLOP/s and HBM GB/s of the H100 variants; the
most specific name matches first ("H100 PCIe" before "H100").  An
unknown kind -- the CPU -- exports no mfu or hbm_frac rather than a
made-up number.  ``DTF_PEAK_TFLOPS`` / ``DTF_PEAK_HBM_GBPS`` override
both, as in the JAX package.

Where the counts come from -- the documented divergences from the JAX
ledger, which reads XLA's ``cost_analysis()`` of the compiled program:

  FLOPs -- :func:`count_flops` runs one call and counts its
      ``F.linear`` matmuls and convolutions, forward and backward, with
      the formulas of ``torch.utils.flop_counter``; that cannot see a
      kernel launched through ctypes, so the attention kernels K1-K4
      report their own operation counts (:func:`kernel_ops`, the counts
      the kernels' bounds use).  Their plain versions (einsums) are not
      counted, so a call counts the same on the CPU and on the card.
      Elementwise work is not counted, as XLA's flop count barely
      counts it.
  bytes -- XLA's "bytes accessed" has no torch counterpart.  Bytes are
      given only where the caller has an honest count -- the decode
      step: the weights, the live KV read and the KV rows written --
      and elsewhere not at all: no ``_bytes`` gauge and no
      ``hbm_frac``.
  data-dependent work -- a decode step's attention grows with the rows'
      lengths, which eager torch does not fix at a compile.  A caller
      may hand ``observe`` the call's own counts; the gauges are then
      the means over the observed calls and the MFU is their summed
      operations over their summed wall time.

Accuracy contract (the JAX ledger's): the train-step wall time is the
synced log window's mean, so the ledger's MFU sits within ~20% of a
bench's step-time MFU -- host overhead is in the ledger's number.
"""

from __future__ import annotations

import logging
import math
import os
import threading
from typing import Dict, Optional

from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.registry import MetricsRegistry, default_registry

log = logging.getLogger("dtf_tpu_torch")

# data-sheet peaks of the H100 variants, matched against the card's
# name, longest key first: dense bf16 tensor-core TFLOP/s, HBM GB/s
PEAK_BF16_TFLOPS = {
    "H100 PCIe": 756.0,
    "H100 NVL": 835.0,
    "H100": 989.0,          # SXM5, "NVIDIA H100 80GB HBM3"
}
PEAK_HBM_GBPS = {
    "H100 PCIe": 2000.0,
    "H100 NVL": 3900.0,
    "H100": 3350.0,
}


def _lookup(table: dict, kind: str) -> Optional[float]:
    kind = kind.lower()
    for key in sorted(table, key=len, reverse=True):
        if key.lower() in kind:
            return table[key]
    return None


def device_kind(device=None) -> str:
    """The card's name for a CUDA ``device`` (None: CUDA's current card
    when there is one), "" for anything else."""
    try:
        import torch
        if device is None:
            if not torch.cuda.is_available():
                return ""
            device = torch.device("cuda")
        device = torch.device(device)
        if device.type != "cuda":
            return ""
        return torch.cuda.get_device_name(device)
    except Exception:  # noqa: BLE001 -- diagnostics never crash a run
        return ""


def device_peaks(device=None) -> tuple:
    """(peak FLOP/s, peak HBM bytes/s) of ``device`` -- or (None, None)
    when unknown.  DTF_PEAK_TFLOPS / DTF_PEAK_HBM_GBPS win."""
    tflops = os.environ.get("DTF_PEAK_TFLOPS", "")
    gbps = os.environ.get("DTF_PEAK_HBM_GBPS", "")
    peak_f = float(tflops) * 1e12 if tflops else None
    peak_b = float(gbps) * 1e9 if gbps else None
    if peak_f is None or peak_b is None:
        kind = device_kind(device)
        if peak_f is None:
            t = _lookup(PEAK_BF16_TFLOPS, kind)
            peak_f = t * 1e12 if t else None
        if peak_b is None:
            g = _lookup(PEAK_HBM_GBPS, kind)
            peak_b = g * 1e9 if g else None
    return peak_f, peak_b


# ---------------------------------------------------------------------------
# counting one call: aten FLOPs plus the hand kernels' own operations
# ---------------------------------------------------------------------------

class Count:
    """What :func:`count_flops` saw: ``aten`` FLOPs of the matmuls and
    convolutions, forward and backward, and ``kernel`` operations the
    attention kernels reported."""

    def __init__(self):
        self.aten = 0
        self.kernel = 0

    @property
    def total(self) -> int:
        return self.aten + self.kernel


# the counts open in this process, innermost last: a kernel's wrapper
# reports into the innermost from whatever thread launches it (a CUDA
# backward runs on autograd's own thread)
_counts: list = []
_counts_mu = threading.Lock()


def counting() -> bool:
    """True while a :func:`count_flops` runs."""
    return bool(_counts)


def kernel_ops(n) -> None:
    """A hand kernel's wrapper reports the operations of one call; a
    no-op when no :func:`count_flops` runs."""
    with _counts_mu:
        if _counts:
            _counts[-1].kernel += int(n)


def _linear_flops(x, w, grad: bool) -> int:
    """F.linear(x, w): 2 M N K forward, as much again for each operand
    whose gradient autograd will compute."""
    fwd = 2 * (x.numel() // x.shape[-1]) * w.shape[0] * w.shape[1]
    return fwd * (1 + grad * (int(x.requires_grad) + int(w.requires_grad)))


def _conv_flops(x, w, out, grad: bool) -> int:
    """A convolution and its backward's grad_input and grad_weight --
    ``torch.utils.flop_counter``'s formulas (FlopCounterMode's)."""
    from torch.utils.flop_counter import conv_flop_count

    def t(shape):
        return [shape[1], shape[0]] + list(shape[2:])

    xs, ws, os_ = list(x.shape), list(w.shape), list(out.shape)
    flops = conv_flop_count(xs, ws, os_)
    if grad and x.requires_grad:
        flops += conv_flop_count(os_, ws, xs, transposed=True)
    if grad and w.requires_grad:
        flops += conv_flop_count(t(xs), t(os_), t(ws))
    return flops


def count_flops(fn, *args, **kw):
    """(fn(*args, **kw), :class:`Count`) -- one call counted.

    A torch-function mode sees each ``F.linear`` and convolution the
    call makes and adds its forward FLOPs and those of the gradients
    autograd will take (the formulas ``FlopCounterMode`` applies to the
    aten ops; the tests hold the two equal).  A torch-function mode,
    not ``FlopCounterMode``: a dispatch mode imports dynamo, the
    distributed tensor package and sympy at its first use -- seconds
    every training process would pay at its first step.  The kernels'
    plain versions compute with einsum and are not counted."""
    import torch
    from torch.overrides import TorchFunctionMode

    convs = (torch.conv1d, torch.conv2d, torch.conv3d)

    class _Counter(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.nn.functional.linear:
                count.aten += _linear_flops(args[0], args[1],
                                            torch.is_grad_enabled())
            elif func in convs:
                count.aten += _conv_flops(args[0], args[1], out,
                                          torch.is_grad_enabled())
            return out

    count = Count()
    with _counts_mu:
        _counts.append(count)
    try:
        with _Counter():
            out = fn(*args, **kw)
    finally:
        with _counts_mu:
            _counts.remove(count)
    return out, count


class Ledger:
    """Per-executable cost ledger over one metrics registry.

    ``register(name, flops=..., bytes_accessed=...)`` once per
    executable; ``observe(name, wall_s)`` with each measured wall time
    the caller already has (decode steps sync per step; the train
    loop's log windows span a device sync), optionally with the call's
    own counts.  ``emit_summary()`` flushes one ``ledger_summary`` trace
    event per executable at run or engine teardown.  ``device`` picks
    the peaks (None: CUDA's current card, if any)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 device=None):
        self.registry = registry if registry is not None \
            else default_registry()
        self._mu = threading.Lock()
        self._execs: Dict[str, dict] = {}
        self.peak_flops, self.peak_hbm = device_peaks(device)

    def register(self, name: str, flops: float = 0.0,
                 bytes_accessed: Optional[float] = None) -> None:
        """Record an executable's cost a call.  ``bytes_accessed`` None:
        no honest byte count (no ``_bytes`` gauge, no ``hbm_frac``).
        Re-registering a name updates the counts and keeps the
        accumulated timing."""
        with self._mu:
            e = self._execs.get(name)
            if e is None:
                e = self._execs[name] = {"count": 0, "total_s": 0.0,
                                         "flops_sum": 0.0,
                                         "bytes_sum": 0.0}
            e["flops"] = float(flops)
            e["bytes"] = (None if bytes_accessed is None
                          else float(bytes_accessed))
        self.registry.gauge(f"ledger_{name}_flops",
                            unit="flops").set(flops)
        if bytes_accessed is not None:
            self.registry.gauge(f"ledger_{name}_bytes",
                                unit="bytes").set(bytes_accessed)
        trace.event("ledger_exec", exec=name, flops=float(flops),
                    bytes=(None if bytes_accessed is None
                           else float(bytes_accessed)),
                    peak_tflops=(self.peak_flops / 1e12
                                 if self.peak_flops else None),
                    peak_hbm_gbps=(self.peak_hbm / 1e9
                                   if self.peak_hbm else None))

    def observe(self, name: str, wall_s: float,
                flops: Optional[float] = None,
                bytes_accessed: Optional[float] = None) -> None:
        """Fold one measured wall time into the executable's gauges --
        with this call's own counts when given, else the registered
        ones.  Unregistered names and non-positive times are ignored."""
        if not wall_s or wall_s <= 0 or not math.isfinite(wall_s):
            return
        with self._mu:
            e = self._execs.get(name)
            if e is None:
                return
            e["count"] += 1
            e["total_s"] += float(wall_s)
            e["flops_sum"] += float(e["flops"] if flops is None else flops)
            if e["bytes"] is not None:
                e["bytes_sum"] += float(e["bytes"] if bytes_accessed is None
                                        else bytes_accessed)
            s = self._row(e)
        g = self.registry.gauge
        g(f"ledger_{name}_flops", unit="flops").set(s["flops"])
        if s["bytes"] is not None:
            g(f"ledger_{name}_bytes", unit="bytes").set(s["bytes"])
        g(f"ledger_{name}_wall_s", unit="s").set(s["mean_s"])
        g(f"ledger_{name}_calls", unit="calls").set(s["count"])
        g(f"ledger_{name}_achieved_tflops",
          unit="tflops").set(s["achieved_tflops"])
        if s["mfu"] is not None:
            g(f"ledger_{name}_mfu", unit="mfu").set(s["mfu"])
        if s["hbm_frac"] is not None:
            g(f"ledger_{name}_hbm_frac", unit="fraction").set(s["hbm_frac"])

    def _row(self, e: dict) -> dict:
        n = e["count"]
        mean = e["total_s"] / n if n else 0.0
        flops = e["flops_sum"] / n if n else e["flops"]
        nbytes = (None if e["bytes"] is None
                  else e["bytes_sum"] / n if n else e["bytes"])
        achieved = flops / mean if mean > 0 else 0.0
        return {
            "flops": flops, "bytes": nbytes, "count": n, "mean_s": mean,
            "achieved_tflops": achieved / 1e12,
            "mfu": (achieved / self.peak_flops
                    if self.peak_flops and mean > 0 else None),
            "hbm_frac": (nbytes / mean / self.peak_hbm
                         if self.peak_hbm and mean > 0
                         and nbytes is not None else None),
        }

    def summary(self) -> Dict[str, dict]:
        """{exec: {flops, bytes, count, mean_s, achieved_tflops, mfu,
        hbm_frac}} -- mfu/hbm_frac None when the peak (or the byte
        count) is unknown."""
        with self._mu:
            return {name: self._row(e)
                    for name, e in sorted(self._execs.items())}

    def emit_summary(self) -> None:
        """One ``ledger_summary`` trace event per executable -- the
        record ``trace_main --ledger`` tabulates."""
        for name, s in self.summary().items():
            trace.event("ledger_summary", exec=name, **s)
