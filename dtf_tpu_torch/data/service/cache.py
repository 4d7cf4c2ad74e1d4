"""Decode-once cache tier — per-shard, mmap-backed, single-writer (a
copy of ``dtf_tpu/data/service/cache.py``).

A tf.data-service-style host cache of DECODED images: JPEG decode is
the dominant per-record cost of the ImageNet pipeline, and it produces
the same pixels every epoch — only the crop/flip/resize augmentation
changes.  This cache stores the full decoded uint8 image (plus label
and the first ground-truth bbox, the only one the crop sampler reads)
the first time a record is decoded, so epoch >= 2 — and any other
reader of the same shard on this host — skips libjpeg entirely.

Layout (one pair of files per shard under the cache directory; the
filename encodes the full shard identity — shard/num_shards and the
per-process file split — because the cache key is the SHARD-LOCAL
record index: the same directory reused with a different sharding must
produce a fresh cache, never serve another partition's pixels):

    shard{S}of{N}.p{P}of{C}.data
                    raw uint8 pixel payloads, appended in put() order
    shard{S}of{N}.p{P}of{C}.idx
                    fixed 48-byte index entries
                    <record qq iiii 4f>: record_idx, data offset,
                    h, w, label, has_bbox, bbox(ymin,xmin,ymax,xmax)

Ownership: shard -> worker is a static assignment in the service pool,
so each cache pair has exactly ONE writer process — no cross-process
locking.  Reads go through an mmap of the data file (remapped lazily
when the file has grown), so a respawned worker — or a second training
run over the same dataset — reuses everything already decoded.

Crash safety: the index entry is appended (and flushed) only AFTER its
payload bytes are durably written, and load() ignores a torn final
index entry and any entry pointing past the end of the data file — a
worker SIGKILLed mid-put costs at most that one record.

Bounded: ``limit_bytes`` caps the data file; once the next payload
would not fit, the cache stops inserting (those records simply decode
every epoch) — a loud log line records the saturation once.
"""

from __future__ import annotations

import logging
import mmap
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

log = logging.getLogger("dtf_tpu_torch")

# record_idx, offset: int64; h, w, label, has_bbox: int32; bbox: 4 x f32
_ENTRY = struct.Struct("<qqiiii4f")
ENTRY_SIZE = _ENTRY.size  # 48


class DecodeCache:
    """Decode-once cache for ONE shard (single writer, many readers)."""

    def __init__(self, directory: str, shard: int, limit_bytes: int,
                 num_shards: int = 1, process_id: int = 0,
                 process_count: int = 1):
        os.makedirs(directory, exist_ok=True)
        self.shard = int(shard)
        self.limit_bytes = int(limit_bytes)
        stem = (f"shard{int(shard)}of{int(num_shards)}"
                f".p{int(process_id)}of{int(process_count)}")
        self.data_path = os.path.join(directory, f"{stem}.data")
        self.idx_path = os.path.join(directory, f"{stem}.idx")
        # index: record_idx -> (offset, h, w, label, bbox or None)
        self._index: Dict[int, Tuple[int, int, int, int,
                                     Optional[np.ndarray]]] = {}
        self._data = open(self.data_path, "ab")
        self._idx = open(self.idx_path, "ab")
        self._mm: Optional[mmap.mmap] = None
        self._mm_size = 0
        self._full_logged = False
        self.hits = 0
        self.lookups = 0
        self._load()

    # -- persistence ----------------------------------------------------
    def _load(self) -> None:
        """Rebuild the in-memory index from the idx file, dropping a
        torn tail entry and entries whose payload the data file does
        not fully contain (the mid-put crash window)."""
        try:
            with open(self.idx_path, "rb") as f:
                blob = f.read()
        except OSError:
            return
        data_size = os.path.getsize(self.data_path)
        usable = len(blob) - len(blob) % ENTRY_SIZE
        for pos in range(0, usable, ENTRY_SIZE):
            (ridx, off, h, w, label, has_bbox,
             b0, b1, b2, b3) = _ENTRY.unpack_from(blob, pos)
            if off + h * w * 3 > data_size:
                break  # payload torn — this and anything after is suspect
            bbox = (np.array([[b0, b1, b2, b3]], np.float32)
                    if has_bbox else None)
            self._index[ridx] = (off, h, w, label, bbox)

    def _map(self, end: int) -> mmap.mmap:
        """The data-file mmap, remapped when an entry lies past the
        current mapping (the file grows append-only).  The superseded
        mapping is NOT closed here: get() hands out zero-copy views
        into it, and closing a mmap with live buffer exports raises
        BufferError — dropping the reference lets the GC reclaim it
        once the last view dies."""
        if self._mm is None or end > self._mm_size:
            self._data.flush()
            size = os.path.getsize(self.data_path)
            with open(self.data_path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), size,
                                     access=mmap.ACCESS_READ)
            self._mm_size = size
        return self._mm

    # -- cache API ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._index)

    def get(self, record_idx: int):
        """(image uint8 HWC view, label, bbox or None), or None on miss.
        The image is a zero-copy mmap view — callers crop/copy it, never
        mutate it."""
        self.lookups += 1
        entry = self._index.get(int(record_idx))
        if entry is None:
            return None
        off, h, w, label, bbox = entry
        mm = self._map(off + h * w * 3)
        img = np.frombuffer(mm, np.uint8, h * w * 3, off).reshape(h, w, 3)
        self.hits += 1
        return img, label, bbox

    def put(self, record_idx: int, image: np.ndarray, label: int,
            bbox: Optional[np.ndarray]) -> bool:
        """Insert one decoded image; False (and no write) when the
        record is already cached or the byte bound is reached."""
        record_idx = int(record_idx)
        if record_idx in self._index:
            return False
        image = np.ascontiguousarray(image, np.uint8)
        h, w = image.shape[:2]
        off = self._data.tell()
        if self.limit_bytes and off + image.nbytes > self.limit_bytes:
            if not self._full_logged:
                self._full_logged = True
                log.warning(
                    "decode cache shard %d is full (%d bytes); further "
                    "records decode every epoch", self.shard, off)
            return False
        # payload first, durably, THEN the index entry that blesses it
        self._data.write(image.tobytes())
        self._data.flush()
        has_bbox = bbox is not None and len(bbox)
        b = (np.asarray(bbox, np.float32)[0] if has_bbox
             else np.zeros((4,), np.float32))
        self._idx.write(_ENTRY.pack(record_idx, off, h, w, int(label),
                                    1 if has_bbox else 0,
                                    float(b[0]), float(b[1]),
                                    float(b[2]), float(b[3])))
        self._idx.flush()
        self._index[record_idx] = (
            off, h, w, int(label),
            np.array([b], np.float32) if has_bbox else None)
        return True

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass  # a caller still holds a view; the GC reclaims it
            self._mm = None
        for f in (self._data, self._idx):
            try:
                f.close()
            except OSError:
                pass
