"""ctypes binding of the port's native parameter store
(``ps_store.cpp``): the store of ``parallel/ps.py`` and its one-pass
bf16 wire conversions.

The library is its own, ``_build/libdtf_ps-<hash>.so``, built at first
use with the JAX package's flags (``g++ -O3 -fPIC -shared -std=c++17
-Wall ... -lpthread``) and without libjpeg, so it builds wherever g++
does (a machine without libjpeg-turbo's headers still gets the native
store).  ``-O3`` and no ``-march``: the store's update has no FMA
contraction on x86-64, as in the JAX package's build, so both stores
apply a push to the same bits.

When it cannot be built, :func:`load` returns None and
``parallel/ps.py`` serves through its Python store; the choice is
logged once and named by :func:`store_path`.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import time
from typing import Optional

from dtf_tpu_torch import native

log = logging.getLogger("dtf_tpu_torch")

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "ps_store.cpp")
CXXFLAGS = list(native.CXXFLAGS)
LDLIBS = ["-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_probed = False
# why the library is not loaded ("" once it is)
unavailable_reason = ""
# seconds the build took in this process (0.0 when it was there)
build_seconds = 0.0


def lib_path() -> str:
    return native.library_path("libdtf_ps", SOURCE, CXXFLAGS + LDLIBS)


def build() -> str:
    """Compile the library unless it is there; returns its path.
    Raises RuntimeError naming what is missing."""
    return native.build_library(lib_path(), SOURCE, CXXFLAGS, LDLIBS)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of ``dtf_tpu/parallel/ps.py _bind_native``,
    and the bf16 conversions'."""
    lib.dtf_ps_start.argtypes = [ctypes.c_int, ctypes.c_float]
    lib.dtf_ps_start.restype = ctypes.c_void_p
    lib.dtf_ps_start_paused.argtypes = [ctypes.c_int, ctypes.c_float]
    lib.dtf_ps_start_paused.restype = ctypes.c_void_p
    lib.dtf_ps_begin_accept.argtypes = [ctypes.c_void_p]
    lib.dtf_ps_port.argtypes = [ctypes.c_void_p]
    lib.dtf_ps_port.restype = ctypes.c_int
    lib.dtf_ps_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dtf_ps_stop.argtypes = [ctypes.c_void_p]
    lib.dtf_ps_snapshot.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dtf_ps_snapshot.restype = ctypes.c_int
    lib.dtf_ps_restore.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dtf_ps_restore.restype = ctypes.c_int
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.dtf_f32_to_bf16.argtypes = [f32p, u16p, ctypes.c_int64]
    lib.dtf_bf16_to_f32.argtypes = [u16p, f32p, ctypes.c_int64]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when it cannot be
    built (logged once, with the reason in ``unavailable_reason``)."""
    global _lib, _probed, unavailable_reason, build_seconds
    if _probed:
        return _lib
    with _lock:
        if not _probed:
            t0 = time.perf_counter()
            try:
                path = build()
                build_seconds = time.perf_counter() - t0
                _lib = _bind(ctypes.CDLL(path))
                unavailable_reason = ""
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _lib = None
                unavailable_reason = str(e)
                log.warning("native parameter store unavailable (%s): the "
                            "async parameter server serves through its "
                            "Python store", e)
            _probed = True
    return _lib


def store_path() -> str:
    """``"native"`` (this library) or ``"python"`` (the fallback
    store of ``parallel/ps.py``)."""
    return "native" if load() is not None else "python"
