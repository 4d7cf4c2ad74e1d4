"""ctypes bindings for the port's C++ data runtime (``dtf_native.cpp``):
the PyTorch counterpart of ``dtf_tpu/native/__init__.py``, with its own
copy of the TFRecord and JPEG source.

The library is built at first use, with the JAX package's Makefile
flags (``g++ -O3 -fPIC -shared -std=c++17 -Wall ... -ljpeg
-lpthread``), into ``dtf_tpu_torch/_build/libdtf_native-<hash>.so``:
the hash covers the source and the flags, so an edited source is never
served by a stale library.  The compiler writes a temporary name that
is renamed into place, so processes that build at once (test workers,
the data service's spawned readers) never load a half-written file.

Every consumer degrades to the pure-Python implementation (the TFRecord
reader in ``data/records.py``, PIL for JPEG) when the library cannot be
built -- no g++, no libjpeg-turbo headers.  That choice is logged once
and reported by :func:`decode_path`, which the runner puts in a run's
stats.  ctypes foreign calls release the GIL, so Python worker threads
get true decode parallelism.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional

log = logging.getLogger("dtf_tpu_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "dtf_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# dtf_tpu/native/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LDLIBS = ["-ljpeg", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_probed = False
# why the library is not loaded ("" once it is)
unavailable_reason = ""


def lib_path() -> str:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXXFLAGS + LDLIBS).encode())
    return os.path.join(BUILD_DIR, f"libdtf_native-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless it is there; returns its path.
    Raises RuntimeError naming what is missing."""
    path = lib_path()
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE, *LDLIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise RuntimeError(f"{os.path.basename(cxx)} failed: "
                           f"{proc.stderr.strip()[-400:]}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    # input buffers are c_char_p so Python bytes pass zero-copy (the C
    # side is const and never writes); outputs are void* plus the
    # trailing out_u8 selector of the uint8 wire
    lib.dtf_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.dtf_crc32c.restype = ctypes.c_uint32
    lib.dtf_tfr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dtf_tfr_open.restype = ctypes.c_void_p
    lib.dtf_tfr_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p)]
    lib.dtf_tfr_next.restype = ctypes.c_int64
    lib.dtf_tfr_close.argtypes = [ctypes.c_void_p]
    lib.dtf_jpeg_shape.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.dtf_jpeg_shape.restype = ctypes.c_int
    lib.dtf_jpeg_decode_crop.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, u8p]
    lib.dtf_jpeg_decode_crop.restype = ctypes.c_int
    lib.dtf_jpeg_eval_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_void_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dtf_jpeg_eval_batch.restype = ctypes.c_int
    lib.dtf_train_example_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, i32p,
        i32p, u8p, u8p, ctypes.c_int]
    lib.dtf_train_example_batch.restype = ctypes.c_int
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when it cannot be
    built (logged once, with the reason in ``unavailable_reason``)."""
    global _lib, _probed, unavailable_reason
    if _probed:
        return _lib
    with _lock:
        if not _probed:
            try:
                _lib = _bind(ctypes.CDLL(build()))
                unavailable_reason = ""
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _lib = None
                unavailable_reason = str(e)
                log.warning("native decode library unavailable (%s): "
                            "JPEG decode goes through PIL and TFRecords "
                            "through the Python reader", e)
            _probed = True
    return _lib


def available() -> bool:
    return load() is not None


def decode_path() -> str:
    """``"native"`` (libjpeg-turbo through this library) or ``"pil"``."""
    return "native" if available() else "pil"


def crc32c(data: bytes) -> int:
    lib = load()
    assert lib is not None
    return lib.dtf_crc32c(data, len(data))


def read_tfrecord_file(path: str, verify_crc: bool = False):
    """Native streaming TFRecord reader; same contract as
    ``data/records.py read_tfrecord_file``."""
    lib = load()
    assert lib is not None
    handle = lib.dtf_tfr_open(path.encode(), int(verify_crc))
    if not handle:
        raise IOError(f"{path}: cannot open")
    try:
        data_p = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            n = lib.dtf_tfr_next(handle, ctypes.byref(data_p))
            if n == -1:
                return
            if n < 0:
                raise IOError(f"{path}: corrupt or truncated record")
            yield ctypes.string_at(data_p, n)
    finally:
        lib.dtf_tfr_close(handle)
