"""Sharded deterministic ImageNet reader — batch (shard, k) is a pure
function of position (a copy of ``dtf_tpu/data/service/reader.py``).

The legacy threaded pipeline (data/imagenet.py) gets its throughput
from a shuffle buffer drained by racing decode workers — which makes
batch composition depend on thread timing, so a killed run cannot
replay its exact stream.  This reader inverts the design: the TFRecord
file set is partitioned into ``num_shards`` STATIC shards
(``files[shard::num_shards]``, the same positional rule as
process sharding), each shard builds a byte-offset index of its records
once (header seeks only, no payload I/O), and every batch is computed
from position-derived RNGs, mirroring the cifar scheme:

    shuffle order of shard-local epoch e:  SeedSequence([seed, pid,
                                           shard, e])
    augmentation draws of batch (e, j):    SeedSequence([seed, pid,
                                           shard, e, j, 1])

so ``batch(k)`` — shard-local batch number ``k = e * batches_per_epoch
+ j`` — depends on nothing but ``(seed, process, shard, k)``.  A run
resumed at any position recomputes the exact batches the uninterrupted
run would have produced; a respawned worker re-enters the stream at its
recorded position with zero drift.

Decode path: full JPEG decode (native libjpeg-turbo when it builds, else
PIL) →
numpy window crop → flip → PIL bilinear resize — ONE code path whether
or not the decode-once cache serves the pixels, so cached and uncached
runs are bit-identical by construction.  (The legacy pipeline's fused
decode-crop C++ op cannot feed a decode-once cache: its output already
has the epoch's crop baked in.)
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from dtf_tpu_torch.data.imagenet import (CHANNEL_MEANS, DEFAULT_IMAGE_SIZE,
                                   NUM_CHANNELS, _resize_bilinear, _round_u8,
                                   decode_jpeg, get_filenames,
                                   parse_example_record,
                                   sample_distorted_bbox)
from dtf_tpu_torch.data.base import shard_for_process
from dtf_tpu_torch.data.service.cache import DecodeCache


def index_tfrecord_file(path: str) -> List[Tuple[int, int]]:
    """[(payload_offset, payload_length), ...] for one TFRecord file —
    header seeks only (the framing stores the length up front), so
    indexing costs O(records) tiny reads, not a full pass over pixels."""
    out: List[Tuple[int, int]] = []
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
            if pos + 12 + length + 4 > end:
                raise IOError(f"{path}: truncated record body")
            out.append((pos + 12, length))
            pos += 12 + length + 4
    return out


class ShardReader:
    """One static shard of the TFRecord file set, served as
    position-derived batches.

    ``files`` is the PER-PROCESS file list (multi-host runs shard files
    across processes first, exactly like the legacy pipeline); this
    reader takes the ``shard``-th positional slice of it.
    """

    def __init__(self, files: List[str], shard: int, num_shards: int,
                 batch_size: int, seed: int = 0, process_id: int = 0,
                 wire: str = "uint8", cache: Optional[DecodeCache] = None):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} outside [0, {num_shards})")
        if wire not in ("float32", "uint8"):
            raise ValueError(f"wire must be 'float32' or 'uint8', got "
                             f"{wire!r}")
        self.shard = int(shard)
        self.num_shards = int(num_shards)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.process_id = int(process_id)
        self.u8 = wire == "uint8"
        self.cache = cache
        self.files = files[shard::num_shards]
        if not self.files:
            raise ValueError(
                f"shard {shard}: num_shards {num_shards} exceeds the "
                f"{len(files)} input files — each shard needs at least "
                f"one file (lower --input_num_shards; it is part of "
                f"the stream identity, so pick it once per run)")
        # global record index: (file number, payload offset, length)
        self.index: List[Tuple[int, int, int]] = []
        for fi, path in enumerate(self.files):
            for off, length in index_tfrecord_file(path):
                self.index.append((fi, off, length))
        self.batches_per_epoch = len(self.index) // self.batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"shard {shard} holds {len(self.index)} records, fewer "
                f"than the batch size {batch_size}; use fewer shards")
        self._handles: Dict[int, object] = {}
        # (epoch, permutation) memo: order() is pure, so one entry
        # suffices — sequential consumption regenerates the (on real
        # ImageNet, ~320k-element) permutation once per epoch, not once
        # per batch (the cifar pipeline keeps the same memo)
        self._order: Optional[Tuple[int, np.ndarray]] = None

    # -- record access --------------------------------------------------
    def _raw(self, record_idx: int) -> bytes:
        fi, off, length = self.index[record_idx]
        f = self._handles.get(fi)
        if f is None:
            f = self._handles[fi] = open(self.files[fi], "rb")
        f.seek(off)
        return f.read(length)

    def _decoded(self, record_idx: int):
        """(full decoded uint8 image, label, bbox) — decode-once cache
        tier first, libjpeg/PIL on miss (populating the cache)."""
        if self.cache is not None:
            hit = self.cache.get(record_idx)
            if hit is not None:
                return hit
        buf, label, bbox = parse_example_record(self._raw(record_idx))
        image = decode_jpeg(buf)
        if self.cache is not None:
            self.cache.put(record_idx, image, label, bbox)
        return image, label, bbox

    # -- position-derived batches ---------------------------------------
    def order(self, epoch: int) -> np.ndarray:
        """Shuffle order of shard-local epoch ``epoch`` — a pure
        function of (seed, process, shard, epoch), memoized for the
        epoch the caller is currently consuming."""
        epoch = int(epoch)
        if self._order is None or self._order[0] != epoch:
            self._order = (epoch, np.random.default_rng(
                np.random.SeedSequence(
                    [self.seed, self.process_id, self.shard,
                     epoch])).permutation(len(self.index)))
        return self._order[1]

    def batch(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Shard-local batch ``k`` — images [B, 224, 224, 3] (uint8 raw
        pixels or mean-subtracted f32, per ``wire``) + int32 labels.
        Pure in ``k``: calling it twice, in any order, from any process
        lifetime, yields bit-identical arrays."""
        epoch, j = divmod(int(k), self.batches_per_epoch)
        sel = self.order(epoch)[j * self.batch_size:
                                (j + 1) * self.batch_size]
        brng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, self.process_id, self.shard, epoch, j, 1]))
        images = np.empty((self.batch_size, DEFAULT_IMAGE_SIZE,
                           DEFAULT_IMAGE_SIZE, NUM_CHANNELS),
                          np.uint8 if self.u8 else np.float32)
        labels = np.empty((self.batch_size,), np.int32)
        for i, ridx in enumerate(sel):
            image, label, bbox = self._decoded(int(ridx))
            h, w = image.shape[:2]
            y, x, ch, cw = sample_distorted_bbox(brng, h, w, bbox)
            crop = image[y:y + ch, x:x + cw]
            if brng.random() < 0.5:
                crop = crop[:, ::-1]
            out = _resize_bilinear(np.ascontiguousarray(crop),
                                   DEFAULT_IMAGE_SIZE, DEFAULT_IMAGE_SIZE)
            images[i] = _round_u8(out) if self.u8 else out - CHANNEL_MEANS
            labels[i] = label
        return images, labels

    def cache_stats(self) -> Tuple[int, int]:
        """(hits, lookups) of the cache tier; (0, 0) when disabled."""
        if self.cache is None:
            return (0, 0)
        return (self.cache.hits, self.cache.lookups)

    def close(self) -> None:
        for f in self._handles.values():
            try:
                f.close()
            except OSError:
                pass
        self._handles.clear()
        if self.cache is not None:
            self.cache.close()


def make_reader(data_dir: str, shard: int, num_shards: int,
                batch_size: int, seed: int = 0, process_id: int = 0,
                process_count: int = 1, wire: str = "uint8",
                cache_dir: str = "", cache_limit_bytes: int = 0
                ) -> ShardReader:
    """ShardReader over the production train-file layout, with the
    per-process file split applied first (multi-host parity with the
    legacy pipeline) and the decode-once cache attached when
    ``cache_dir`` is set."""
    files = get_filenames(True, data_dir)
    if process_count > 1:
        files = shard_for_process(files, process_id, process_count) or files
    cache = (DecodeCache(cache_dir, shard, cache_limit_bytes,
                         num_shards=num_shards, process_id=process_id,
                         process_count=process_count)
             if cache_dir else None)
    return ShardReader(files, shard, num_shards, batch_size, seed=seed,
                       process_id=process_id, wire=wire, cache=cache)
