"""TFRecord container + tf.train.Example wire format, first-principles
-- a copy of ``dtf_tpu/data/records.py`` whose native branch goes
through the port's own loader (``dtf_tpu_torch/native``).

The reference reads TFRecordDataset shards and parses Example protos
with C++ tf.data kernels (imagenet_preprocessing.py:307-310, :156-223).
This module owns those formats natively — no TensorFlow, no protobuf
runtime — so the framework can read (and, for tests/tools, write) the
exact same files:

  TFRecord framing (per record):
      uint64 length (LE) | uint32 masked-crc32c(length) |
      bytes data[length] | uint32 masked-crc32c(data)
  masked_crc = ((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff,
  crc32c = Castagnoli polynomial 0x1EDC6F41 (reflected 0x82F63B78).

  tf.train.Example = { 1: Features { 1: map<string, Feature> } }
  Feature = oneof { 1: BytesList, 2: FloatList, 3: Int64List },
  each list = { 1: repeated value } (floats/ints may be packed).

A C++ implementation with the same contract lives in
dtf_tpu_torch/native (built at first use); this file is the reference
implementation and the fallback when it cannot be built.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Union

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven
# ---------------------------------------------------------------------------

def _make_crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 * (c & 1))
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def crc32c(data: bytes) -> int:
    """Per-byte table loop — correctness reference; the native C++ path
    handles bulk throughput."""
    table = _CRC_TABLE
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ table[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def read_tfrecord_file(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yields the raw serialized records of one TFRecord file.

    Dispatches to the C++ reader (dtf_tpu_torch/native) when it loads;
    the pure Python below is the reference implementation and fallback."""
    try:
        from dtf_tpu_torch import native
        dispatch = native.available()
    except Exception:  # unbuilt, unloadable (wrong arch), anything — fall back
        dispatch = False
    if dispatch:
        yield from native.read_tfrecord_file(path, verify_crc)
        return
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != crc:
                    raise IOError(f"{path}: corrupt length crc")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"{path}: truncated record body")
            footer = f.read(4)
            if len(footer) < 4:
                raise IOError(f"{path}: truncated record footer")
            if verify_crc:
                (crc,) = struct.unpack("<I", footer)
                if masked_crc32c(data) != crc:
                    raise IOError(f"{path}: corrupt data crc")
            yield data


# (path, mtime_ns, size) → record count: repeated evals re-count the
# same immutable shard files otherwise (one tiny seek+read per record —
# noticeable on high-latency network storage)
_COUNT_CACHE: dict = {}


def count_tfrecord_records(path: str) -> int:
    """Record count of one TFRecord file, skipping payloads via seek —
    O(records) tiny reads, no payload I/O, cached per (path, mtime,
    size).  Used by the exact-coverage eval to agree on the per-host
    batch count ahead of decoding."""
    import os
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    cached = _COUNT_CACHE.get(key)
    if cached is not None:
        return cached
    n = 0
    with open(path, "rb") as f:
        f.seek(0, 2)
        end = f.tell()
        pos = 0
        while pos < end:
            f.seek(pos)
            header = f.read(12)
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            pos += 12 + length + 4
            if pos > end:
                raise IOError(f"{path}: truncated record body")
            n += 1
    _COUNT_CACHE[key] = n
    return n


def write_tfrecord_file(path: str, records) -> None:
    """Writes serialized records with valid framing (for tests/tools)."""
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))


# ---------------------------------------------------------------------------
# protobuf wire primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _iter_fields(buf: bytes):
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


FeatureValue = Union[List[bytes], np.ndarray]


def _parse_feature(buf: bytes) -> FeatureValue:
    """Feature = oneof { 1: BytesList, 2: FloatList, 3: Int64List }."""
    for field, _, payload in _iter_fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _iter_fields(payload) if f == 1]
        if field == 2:  # FloatList: packed (wire 2) or fixed32 (wire 5) —
            # both are little-endian f32 payloads
            floats = [np.frombuffer(v, dtype="<f4")
                      for f, _, v in _iter_fields(payload) if f == 1]
            return (np.concatenate(floats) if floats
                    else np.zeros((0,), np.float32))
        if field == 3:  # Int64List: packed or repeated varint
            ints: list = []
            for f, wire, v in _iter_fields(payload):
                if f != 1:
                    continue
                if wire == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        val, pos = _read_varint(v, pos)
                        ints.append(val)
                else:
                    ints.append(v)
            return np.asarray(ints, dtype=np.int64)
    return []


def parse_example(serialized: bytes) -> Dict[str, FeatureValue]:
    """Parses a serialized tf.train.Example into {name: value}."""
    out: Dict[str, FeatureValue] = {}
    for field, _, features_buf in _iter_fields(serialized):
        if field != 1:
            continue
        for f, _, entry in _iter_fields(features_buf):
            if f != 1:
                continue
            key, feature = None, None
            for kf, _, kv in _iter_fields(entry):
                if kf == 1:
                    key = kv.decode("utf-8")
                elif kf == 2:
                    feature = kv
            if key is not None and feature is not None:
                out[key] = _parse_feature(feature)
    return out


# ---------------------------------------------------------------------------
# Example building (tests/tools)
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def build_example(features: Dict[str, Union[bytes, List[bytes], List[int],
                                            List[float], np.ndarray]]) -> bytes:
    """Serializes {name: value} to a tf.train.Example (inverse of
    parse_example; used by tests and dataset-prep tools)."""
    entries = b""
    for key, value in features.items():
        if isinstance(value, bytes):
            value = [value]
        if isinstance(value, np.ndarray):
            value = value.tolist()
        if len(value) and isinstance(value[0], bytes):
            lst = b"".join(_len_delim(1, v) for v in value)
            feature = _len_delim(1, lst)
        elif len(value) and isinstance(value[0], float):
            packed = np.asarray(value, dtype="<f4").tobytes()
            feature = _len_delim(2, _len_delim(1, packed))
        else:
            packed = b"".join(_varint(int(v)) for v in value)
            feature = _len_delim(3, _len_delim(1, packed))
        entry = _len_delim(1, key.encode()) + _len_delim(2, feature)
        entries += _len_delim(1, entry)
    return _len_delim(1, entries)
