"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<source>.cu`` has a plain C interface of one or more
entry points (``SIGNATURES``).  At first use it is compiled for Hopper
(``sm_90a``) into ``dtf_tpu_torch/_build/lib<source>-<hash>.so`` -- the
hash covers the source, the shared headers and the flags, so an edited
source is never served by a stale library -- and opened with ctypes.
Building from the checkout's sources alone is what lets
``python3 chip_smoke.py`` run on a fresh machine.  Nothing here runs at
import: the CPU tests import every module, on machines without nvcc.

``build_all`` starts one nvcc per source at once (the kernels' build
counts against the smoke script's time limit); ``load`` builds an entry
point's source on demand.  Both keep the compiler's ``-Xptxas -v``
report beside the library (``.log``): registers, shared memory and
spills per kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_BWD = [_P] * 6                       # q, k, v, dO, lse2, delta
_BWD_TAIL = [_I] * 7 + [_F, _F, _P]   # B, H, Sq, Sk, D, dtype, causal,
                                      # scale, scale_log2e, stream
# C entry points: name -> (source in csrc/, symbol, argtypes, restype)
SIGNATURES = {
    "flash_fwd": ("flash_fwd", "dtf_flash_fwd",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
                  _I),
    # q, pools, table, index, o, o_part, ml_part; B, S, H, D, P, page,
    # M, keys per split, dtype; scale, stream
    "paged_decode": ("paged_decode", "dtf_paged_decode",
                     [_P] * 8 + [_I] * 9 + [_F, _P], _I),
    "flash_bwd_dq": ("flash_bwd", "dtf_flash_bwd_dq",
                     _BWD + [_P] + _BWD_TAIL, _I),
    "flash_bwd_dkdv": ("flash_bwd", "dtf_flash_bwd_dkdv",
                       _BWD + [_P, _P] + _BWD_TAIL, _I),
    "flash_bwd_fused": ("flash_bwd_fused", "dtf_flash_bwd_fused",
                        _BWD + [_P, _P, _P, _P, ctypes.c_longlong]
                        + _BWD_TAIL, _I),
    "flash_bwd_fused_partial_floats": (
        "flash_bwd_fused", "dtf_flash_bwd_fused_partial_floats",
        [_I] * 6, ctypes.c_longlong),
}
SOURCES = sorted({src for src, *_ in SIGNATURES.values()})

_lock = threading.Lock()
_fns: Dict[str, object] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each source's build took in this process (chip_smoke.py
# reports them)
build_seconds: Dict[str, float] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def _library_path(source: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == f"{source}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{source}-{h.hexdigest()[:12]}.so")


def _start(source: str):
    """Start nvcc for one source; returns (popen, tmp path, final path),
    or None when the library is already built."""
    out = _library_path(source)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    log = open(out[:-3] + ".log", "w")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{source}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, tmp, out


def _finish(source: str, job, t0: float) -> None:
    proc, tmp, out = job
    if proc.wait() != 0:
        with open(out[:-3] + ".log") as f:
            report = f.read()
        raise RuntimeError(f"nvcc failed for csrc/{source}.cu:\n{report}")
    os.replace(tmp, out)
    build_seconds[source] = time.perf_counter() - t0


def build_all() -> None:
    """Compile every source in parallel; raises on the first compiler
    failure after all compilers have exited."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {src: _start(src) for src in SOURCES}
        errors = []
        for n, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(n, job, t0)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]


def ptxas_report(source: str) -> List[str]:
    """The compiler's per-kernel resource lines: each kernel's (mangled)
    name, then its registers and spills."""
    path = _library_path(source)[:-3] + ".log"
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.strip() for ln in f
                if "entry function" in ln or "registers" in ln
                or "spill" in ln]


def load(name: str):
    """The C entry point ``name``, building its library first if
    needed.  The returned ctypes function has argtypes/restype declared,
    so pointers pass as 64-bit values."""
    with _lock:
        fn = _fns.get(name)
        if fn is not None:
            return fn
        source, symbol, argtypes, restype = SIGNATURES[name]
        lib = _libs.get(source)
        if lib is None:
            job = _start(source)
            if job is not None:
                _finish(source, job, time.perf_counter())
            lib = _libs[source] = ctypes.CDLL(_library_path(source))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[name] = fn
        return fn
