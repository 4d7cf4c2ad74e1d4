"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface.  At
first use it is compiled for Hopper (``sm_90a``) into
``dtf_tpu_torch/_build/lib<name>-<hash>.so`` -- the hash covers the
source, the shared header and the flags, so an edited source is never
served by a stale library -- and opened with ctypes.  Building from the
checkout's sources alone is what lets ``python3 chip_smoke.py`` run on a
fresh machine.  Nothing here runs at import: the CPU tests import every
module, and this machine has no nvcc.

``build_all`` starts one nvcc per source at once (the kernels' build
counts against the smoke script's time limit); ``load`` builds one on
demand.  Both keep the compiler's ``-Xptxas -v`` report beside the
library (``.log``): registers, shared memory and spills per kernel.
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
# C signature of each kernel's entry point: (symbol, argtypes)
SIGNATURES = {
    "flash_fwd": ("dtf_flash_fwd",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    "paged_decode": ("dtf_paged_decode",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _F, _P]),
}

_lock = threading.Lock()
_fns: Dict[str, object] = {}
# seconds each build took in this process (chip_smoke.py reports them)
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


def _library_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one kernel; returns (popen, tmp path, final path),
    or None when the library is already built."""
    out = _library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    log = open(out[:-3] + ".log", "w")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, tmp, out


def _finish(name: str, job, t0: float) -> None:
    proc, tmp, out = job
    if proc.wait() != 0:
        with open(out[:-3] + ".log") as f:
            report = f.read()
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{report}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0


def build_all() -> None:
    """Compile every kernel in parallel; raises on the first compiler
    failure after all compilers have exited."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in SIGNATURES}
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


def ptxas_report(name: str) -> List[str]:
    """The compiler's per-kernel resource lines (registers, spills)."""
    path = _library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.strip() for ln in f
                if "registers" in ln or "spill" in ln]


def load(name: str):
    """The kernel's C entry point, building the library first if needed.
    The returned ctypes function has argtypes/restype declared, so
    pointers pass as 64-bit values."""
    with _lock:
        fn = _fns.get(name)
        if fn is not None:
            return fn
        job = _start(name)
        if job is not None:
            _finish(name, job, time.perf_counter())
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(_library_path(name)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
        return fn
