"""JPEG decode via the native library (libjpeg-turbo) -- a copy of
``dtf_tpu/native/jpeg.py`` over the port's loader (``native/__init__.py``).

`decode` and `decode_crop` mirror tf.image.decode_jpeg /
decode_and_crop_jpeg (the fused op the reference leans on,
imagenet_preprocessing.py:363-368).  ctypes calls release the GIL, so
calling these from Python worker threads scales across cores.  The
port builds its library from its own source, which always has the
uint8 wire and the fused train-example op, so the JAX bindings'
stale-library branches are gone.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dtf_tpu_torch import native


def _lib():
    lib = native.load()
    if lib is None:
        raise ImportError(f"native decode library unavailable: "
                          f"{native.unavailable_reason}")
    return lib


def shape(buf: bytes):
    """(height, width) from the JPEG header only."""
    lib = _lib()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.dtf_jpeg_shape(buf, len(buf), ctypes.byref(h), ctypes.byref(w)):
        raise ValueError("invalid JPEG")
    return h.value, w.value


def decode_crop(buf: bytes, y: int, x: int, ch: int, cw: int) -> np.ndarray:
    """Fused decode-and-crop → RGB uint8 [ch, cw, 3]."""
    lib = _lib()
    out = np.empty((ch, cw, 3), np.uint8)
    rc = lib.dtf_jpeg_decode_crop(
        buf, len(buf), y, x, ch, cw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def decode(buf: bytes) -> np.ndarray:
    """Full-image RGB uint8 decode."""
    h, w = shape(buf)
    return decode_crop(buf, 0, 0, h, w)


def train_example_batch(records, seed: int, out_h: int, out_w: int, sub,
                        num_threads: int = 4, fast_dct: bool = False,
                        scaled_decode: bool = False,
                        out_u8: bool = False):
    """The whole train path for a batch of raw tf.train.Example
    records in one C++ call: proto parse (image/encoded, label, first
    bbox) → JPEG header → distorted-bbox sampling (reference
    constants; splitmix64 per-image streams seeded by ``seed``) →
    flip → fused decode-crop-resize-mean-subtract.  This is the
    formerly GIL-held per-record Python work (the input pipeline's
    measured Amdahl serial fraction), off the interpreter.

    ``out_u8``: uint8 output wire -- pixels rounded half-up after the
    resize, NO mean subtraction (normalization runs on the device).

    Returns (images f32|u8 [n,oh,ow,3], labels i32 [n] (shifted to
    [0,1000)), crops i32 [n,4], flips u8 [n], statuses u8 [n]):
    status 0 ok; 1 parse/header failure (reprocess the record in
    Python); 2 decode failure (re-decode with the returned crop/flip
    so the augmentation stays identical).
    """
    lib = _lib()
    n = len(records)
    out = np.empty((n, out_h, out_w, 3),
                   np.uint8 if out_u8 else np.float32)
    labels = np.empty((n,), np.int32)
    crops = np.empty((n, 4), np.int32)
    flips = np.empty((n,), np.uint8)
    statuses = np.empty((n,), np.uint8)
    rec_ptrs = (ctypes.c_char_p * n)(*records)
    lens = (ctypes.c_int64 * n)(*[len(r) for r in records])
    sub_arr = np.ascontiguousarray(np.asarray(sub, np.float32))
    lib.dtf_train_example_batch(
        rec_ptrs, lens, n, ctypes.c_uint64(seed & (2**64 - 1)),
        out_h, out_w,
        sub_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(fast_dct), int(scaled_decode), num_threads,
        out.ctypes.data_as(ctypes.c_void_p),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(out_u8))
    return out, labels, crops, flips, statuses


def eval_batch(bufs, resize_min: int, out_h: int, out_w: int, sub,
               num_threads: int = 4, fast_dct: bool = False,
               out_u8: bool = False):
    """Fused eval preprocessing for a batch: aspect-preserving resize to
    shorter-side ``resize_min`` + central [out_h, out_w] crop +
    channel-mean subtraction in one sampling pass over a decode window
    (only the needed source rows/cols are decoded).  tf-bilinear
    numerics — the reference's eval path
    (imagenet_preprocessing.py:375-394,464-480).

    ``out_u8``: uint8 output wire -- pixels rounded half-up after the
    resize, NO mean subtraction (normalization runs on the device).

    Returns (float32|uint8 [n, out_h, out_w, 3], ok mask bool [n]).
    """
    lib = _lib()
    n = len(bufs)
    out = np.empty((n, out_h, out_w, 3),
                   np.uint8 if out_u8 else np.float32)
    statuses = np.empty((n,), np.uint8)
    buf_ptrs = (ctypes.c_char_p * n)(*bufs)
    lens = (ctypes.c_int64 * n)(*[len(b) for b in bufs])
    sub_arr = np.ascontiguousarray(np.asarray(sub, np.float32))
    lib.dtf_jpeg_eval_batch(
        buf_ptrs, lens, n, resize_min, out_h, out_w,
        sub_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.c_void_p),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads, int(fast_dct), int(out_u8))
    return out, statuses == 0
