"""ImageNet TFRecord input pipeline -- a copy of
``dtf_tpu/data/imagenet.py`` (numpy, PIL and the port's native library;
no torch, so the data service's spawned readers stay off the card),
with the process index and count as arguments.

Parity with reference imagenet_preprocessing.py:
  - shards train-%05d-of-01024 / validation-%05d-of-00128 (:144-153)
  - Example proto fields image/encoded, image/class/label (shifted to
    [0,1000), :254-255), image/object/bbox/{ymin,xmin,ymax,xmax}
    (:156-223)
  - train: sample a distorted bounding box (min_object_covered 0.1,
    aspect ∈ [0.75, 1.33], area ∈ [0.05, 1.0], 100 attempts, whole
    image on failure — :345-361), crop, random flip, bilinear resize to
    224×224 (:362-372, :483-500)
  - eval: aspect-preserving resize to shorter-side 256 then central
    224×224 crop (:375-394, :464-480)
  - both: channel-mean subtraction (123.68, 116.78, 103.94) without
    scaling (:397-430)
  - file-level shard per process, shuffle files each epoch, interleaved
    reads, shuffle buffer 10k, multi-threaded map
    (process_record_dataset :65-141)

JPEG decode uses the native C++ library (dtf_tpu_torch/native,
libjpeg-turbo) when it builds, else PIL.  The legacy pipeline's
decode+augment runs on a thread pool (the
`datasets_num_private_threads` equivalent) feeding a bounded queue.
"""

from __future__ import annotations

import io
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from dtf_tpu_torch.data import records
from dtf_tpu_torch.data.base import shard_for_process

DEFAULT_IMAGE_SIZE = 224
NUM_CHANNELS = 3
NUM_TRAIN_FILES = 1024
NUM_VAL_FILES = 128
SHUFFLE_BUFFER = 10_000
CHANNEL_MEANS = np.array([123.68, 116.78, 103.94], np.float32)  # R, G, B
RESIZE_MIN = 256


def get_filenames(is_training: bool, data_dir: str):
    if is_training:
        names = [os.path.join(data_dir, f"train-{i:05d}-of-01024")
                 for i in range(NUM_TRAIN_FILES)]
    else:
        names = [os.path.join(data_dir, f"validation-{i:05d}-of-00128")
                 for i in range(NUM_VAL_FILES)]
    present = [n for n in names if os.path.exists(n)]
    if not present:
        raise FileNotFoundError(
            f"no ImageNet TFRecord shards found under {data_dir}")
    return present


def _load_native_jpeg():
    try:
        from PIL import Image
        from dtf_tpu_torch.native import jpeg as native_jpeg
        probe = io.BytesIO()
        Image.new("RGB", (2, 2)).save(probe, format="JPEG")
        if native_jpeg.shape(probe.getvalue()) != (2, 2):
            return None
        return native_jpeg
    except Exception:
        return None

_native_jpeg = None
_native_probed = False


def native_jpeg_module():
    global _native_jpeg, _native_probed
    if not _native_probed:
        _native_jpeg = _load_native_jpeg()
        _native_probed = True
    return _native_jpeg


def decode_jpeg(buf: bytes) -> np.ndarray:
    """RGB uint8 HWC decode; native lib if built, else PIL."""
    nj = native_jpeg_module()
    if nj is not None:
        try:
            return nj.decode(buf)
        except ValueError:
            pass  # e.g. progressive/CMYK edge cases → PIL
    from PIL import Image
    img = Image.open(io.BytesIO(buf))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def _resize_bilinear(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize (half-pixel centers, like tf.image.resize v2)."""
    from PIL import Image
    return np.asarray(
        Image.fromarray(image).resize((out_w, out_h), Image.BILINEAR),
        dtype=np.float32)


def _round_u8(images: np.ndarray) -> np.ndarray:
    """Round-half-up to the uint8 wire — the native StoreU8 policy
    (floor(v + 0.5)); bilinear samples of uint8 sources stay in
    [0, 255], the clip only guards fp drift."""
    return np.clip(np.floor(images + 0.5), 0, 255).astype(np.uint8)


def sample_distorted_bbox(rng: np.random.Generator, height: int, width: int,
                          bbox: Optional[np.ndarray],
                          min_object_covered: float = 0.1,
                          aspect_ratio_range=(0.75, 1.33),
                          area_range=(0.05, 1.0),
                          max_attempts: int = 100):
    """Numpy re-derivation of tf.image.sample_distorted_bounding_box
    with the reference's constants (:354-361).  Returns (y, x, h, w);
    whole image when no attempt satisfies the constraints."""
    if bbox is None or len(bbox) == 0:
        bbox = np.array([[0.0, 0.0, 1.0, 1.0]], np.float32)
    for _ in range(max_attempts):
        aspect = rng.uniform(*aspect_ratio_range)
        area_frac = rng.uniform(*area_range)
        target_area = area_frac * height * width
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if w > width or h > height or h <= 0 or w <= 0:
            continue
        y = rng.integers(0, height - h + 1)
        x = rng.integers(0, width - w + 1)
        # object coverage: fraction of a ground-truth box inside the crop
        by0, bx0, by1, bx1 = bbox[0] * [height, width, height, width]
        inter_h = max(0.0, min(y + h, by1) - max(y, by0))
        inter_w = max(0.0, min(x + w, bx1) - max(x, bx0))
        box_area = max((by1 - by0) * (bx1 - bx0), 1e-6)
        if inter_h * inter_w / box_area >= min_object_covered:
            return int(y), int(x), int(h), int(w)
    return 0, 0, height, width


def preprocess_train(buf: bytes, bbox, rng: np.random.Generator,
                     as_u8: bool = False) -> np.ndarray:
    nj = native_jpeg_module()
    if nj is not None:
        try:
            # fused decode-and-crop: read the shape from the header, then
            # decode only the sampled window (decode_and_crop_jpeg parity,
            # imagenet_preprocessing.py:363-368)
            h, w = nj.shape(buf)
            y, x, ch, cw = sample_distorted_bbox(rng, h, w, bbox)
            cropped = nj.decode_crop(buf, y, x, ch, cw)
        except ValueError:
            cropped = None
    else:
        cropped = None
    if cropped is None:
        image = decode_jpeg(buf)
        h, w = image.shape[:2]
        y, x, ch, cw = sample_distorted_bbox(rng, h, w, bbox)
        cropped = image[y:y + ch, x:x + cw]
    if rng.random() < 0.5:
        cropped = cropped[:, ::-1]
    out = _resize_bilinear(np.ascontiguousarray(cropped),
                           DEFAULT_IMAGE_SIZE, DEFAULT_IMAGE_SIZE)
    return _round_u8(out) if as_u8 else out - CHANNEL_MEANS


def preprocess_eval(buf: bytes, as_u8: bool = False) -> np.ndarray:
    """Aspect-preserving resize to shorter side RESIZE_MIN (:438-480) +
    central crop (:375-394) + mean subtract (or the raw-pixel uint8
    wire with ``as_u8``).  Dispatches to the fused native pass (decode
    window → one tf-bilinear sampling) when built; Python/PIL fallback
    below."""
    nj = native_jpeg_module()
    if nj is not None:
        out, ok = nj.eval_batch([buf], RESIZE_MIN, DEFAULT_IMAGE_SIZE,
                                DEFAULT_IMAGE_SIZE, CHANNEL_MEANS,
                                num_threads=1, out_u8=as_u8)
        if ok[0]:
            return out[0]
    image = decode_jpeg(buf)
    h, w = image.shape[:2]
    scale = RESIZE_MIN / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = _resize_bilinear(image, nh, nw)
    oy = (nh - DEFAULT_IMAGE_SIZE) // 2
    ox = (nw - DEFAULT_IMAGE_SIZE) // 2
    crop = resized[oy:oy + DEFAULT_IMAGE_SIZE, ox:ox + DEFAULT_IMAGE_SIZE]
    return _round_u8(crop) if as_u8 else crop - CHANNEL_MEANS


def parse_example_record(raw: bytes):
    """Returns (jpeg_bytes, label_int, bbox or None) — the
    _parse_example_proto contract (:156-223)."""
    feats = records.parse_example(raw)
    buf = feats["image/encoded"][0]
    label = int(np.asarray(feats["image/class/label"])[0]) - 1  # → [0,1000)
    bbox = None
    if "image/object/bbox/ymin" in feats and len(feats["image/object/bbox/ymin"]):
        bbox = np.stack([
            np.asarray(feats["image/object/bbox/ymin"], np.float32),
            np.asarray(feats["image/object/bbox/xmin"], np.float32),
            np.asarray(feats["image/object/bbox/ymax"], np.float32),
            np.asarray(feats["image/object/bbox/xmax"], np.float32),
        ], axis=1)
    return buf, label, bbox


def _record_stream(files, is_training: bool, rng: np.random.Generator,
                   interleave: int = 10):
    """File-shuffled, interleaved raw-record stream (≈ tf.data
    interleave(cycle_length=10), :290-310)."""
    while True:
        order = rng.permutation(len(files)) if is_training else range(len(files))
        readers: list = []
        it = iter(order)
        def refill():
            while len(readers) < interleave:
                try:
                    readers.append(records.read_tfrecord_file(files[next(it)]))
                except StopIteration:
                    return
        refill()
        while readers:
            for r in list(readers):
                try:
                    yield next(r)
                except StopIteration:
                    readers.remove(r)
            refill()
        if not is_training:
            return


def imagenet_input_fn(data_dir: str, is_training: bool, batch_size: int,
                      seed: int = 0, num_threads: Optional[int] = None,
                      process_id: int = 0, process_count: int = 1,
                      drop_remainder: bool = True,
                      fast_dct: bool = False,
                      scaled_decode: bool = False,
                      wire: str = "float32", start_step: int = 0) -> Iterator:
    """Yields (images [B,224,224,3], labels int32 [B]) — plus a
    float32 validity mask [B] for eval with ``drop_remainder=False``.

    ``wire``: host→device batch format.  ``"float32"`` = mean-subtracted
    f32; ``"uint8"`` = raw post-resize pixels rounded half-up — 4x
    fewer bytes per batch — with mean subtraction deferred to the
    step on the device (data/normalize.py imagenet_mean_subtract).

    Eval modes:
      - ``drop_remainder=False`` (config default): eval FILES are
        sharded across processes, each host counts its records via
        header-seek (no payload I/O), hosts agree on the max batch
        count, and final/short batches are zero-padded with mask=0 —
        full 50k coverage, each example exactly once, no duplicated
        multi-host decode work.
      - ``drop_remainder=True``: every host reads the full eval set and
        drops the final partial batch (2-tuples).
    """
    if is_training and start_step:
        # This pipeline's batch composition depends on decode-worker
        # timing (the shuffle buffer drains nondeterministically across
        # threads), so a bit-exact replay from step N is not defined —
        # and silently re-keying (the pre-data-service behavior) broke
        # the crash-exact guarantee on the flagship workload.  The
        # position-deterministic path exists: refuse loudly instead.
        raise ValueError(
            f"imagenet mid-stream resume (start_step={start_step}) is "
            f"not supported by the legacy threaded pipeline — its batch "
            f"order is decode-timing-dependent, so the resumed stream "
            f"cannot replay bit-exactly.  Use the sharded deterministic "
            f"data service (--input_service, the default), which makes "
            f"batch n a pure function of (seed, process, n)")
    if wire not in ("float32", "uint8"):
        raise ValueError(f"wire must be 'float32' or 'uint8', got {wire!r}")
    u8 = wire == "uint8"
    files = get_filenames(is_training, data_dir)
    pad_eval = (not is_training) and (not drop_remainder)
    # drop-mode eval must yield the same batch count on every host or
    # the collective eval_step deadlocks, so only padded eval shards its
    # files (train always shards, cifar_preprocessing.py:147-152)
    if (is_training or pad_eval) and process_count > 1:
        files = shard_for_process(files, process_id, process_count)
        if is_training and not files:
            files = get_filenames(is_training, data_dir)
    eval_batches = None
    if pad_eval:
        local_count = sum(records.count_tfrecord_records(f) for f in files)
        # the process group's max (torch.distributed); lazy: this
        # module stays torch-free for the spawned readers
        from dtf_tpu_torch.data.pipeline import all_processes_max
        eval_batches = all_processes_max(-(-local_count // batch_size))
    num_threads = num_threads or min(8, (os.cpu_count() or 1) * 4)
    rng = np.random.default_rng(seed + 7919 * process_id)

    raw_q: queue.Queue = queue.Queue(maxsize=SHUFFLE_BUFFER // 4)
    out_q: queue.Queue = queue.Queue(maxsize=64)
    stop = threading.Event()

    # Batched native fast path (train only): the reader's shuffle buffer
    # emits whole-batch CHUNKS of raw records, and each Python worker
    # owns a full batch end-to-end in ONE fused C++ call -- parse, crop
    # sampling, decode-crop-flip-resize with the GIL released
    # (dtf_native.cpp dtf_train_example_batch).  Parallelism
    # is across batches; queue traffic is 2 hops per BATCH, not per
    # record (the per-record design lost ~half its throughput to queue
    # and GIL ping-pong).
    nj = native_jpeg_module()
    batch_native = is_training and nj is not None

    def reader():
        # shuffle buffer over raw records (:114-120)
        buffer: list = []
        chunk: list = []
        try:
            for raw in _record_stream(files, is_training, rng):
                if stop.is_set():
                    return
                if is_training:
                    buffer.append(raw)
                    if len(buffer) >= SHUFFLE_BUFFER:
                        idx = rng.integers(0, len(buffer))
                        buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                        if batch_native:
                            chunk.append(buffer.pop())
                            if len(chunk) == batch_size:
                                raw_q.put(chunk)
                                chunk = []
                        else:
                            raw_q.put(buffer.pop())
                else:
                    raw_q.put(raw)
            for raw in buffer:
                if batch_native:
                    chunk.append(raw)
                    if len(chunk) == batch_size:
                        raw_q.put(chunk)
                        chunk = []
                else:
                    raw_q.put(raw)
            # a final sub-batch chunk is dropped: training repeats
            # forever, so this only ever cuts the very tail of the
            # stream's last epoch pass
        finally:
            for _ in range(num_threads):
                raw_q.put(None)

    def _slow_item(buf, crop, flip):
        """Python fallback for images the batch decoder rejects."""
        image = decode_jpeg(buf)
        y, x, ch, cw = crop
        cropped = image[y:y + ch, x:x + cw]
        if flip:
            cropped = cropped[:, ::-1]
        out = _resize_bilinear(np.ascontiguousarray(cropped),
                               DEFAULT_IMAGE_SIZE, DEFAULT_IMAGE_SIZE)
        return _round_u8(out) if u8 else out - CHANNEL_MEANS

    # Fully-native batch path: parse + crop-sample + decode all happen
    # in ONE C++ call (dtf_train_example_batch) -- the per-record Python
    # work (Example parse, header reads, numpy sampling) was the
    # pipeline's measured GIL-held serial fraction.  The port's library
    # always has the op, so the JAX package's two-step fallback for a
    # stale library is not copied.
    def _python_record(raw, wrng):
        """Whole-record Python fallback (parse failures)."""
        buf, label, bbox = parse_example_record(raw)
        return preprocess_train(buf, bbox, wrng, as_u8=u8), label

    def batch_worker(wid: int):
        """One whole batch per iteration, end-to-end in C++."""
        wrng = np.random.default_rng(seed + 104729 * (process_id + 1) + wid)
        while True:
            chunk = raw_q.get()
            if chunk is None or stop.is_set():
                out_q.put(None)
                return
            try:
                batch_seed = int(wrng.integers(0, 2**63))
                images, labels, crops, flips, statuses = \
                    nj.train_example_batch(
                        chunk, batch_seed, DEFAULT_IMAGE_SIZE,
                        DEFAULT_IMAGE_SIZE, CHANNEL_MEANS,
                        num_threads=1, fast_dct=fast_dct,
                        scaled_decode=scaled_decode, out_u8=u8)
                for j in np.nonzero(statuses)[0]:
                    if statuses[j] == 1:  # parse/header failure
                        images[j], labels[j] = _python_record(chunk[j],
                                                              wrng)
                    else:  # decode failure: same crop/flip
                        buf, _, _ = parse_example_record(chunk[j])
                        images[j] = _slow_item(
                            buf, tuple(crops[j]), bool(flips[j]))
                out_q.put((images, labels))
            except Exception as e:
                out_q.put(e)
                return

    def worker(wid: int):
        wrng = np.random.default_rng(seed + 104729 * (process_id + 1) + wid)
        while True:
            raw = raw_q.get()
            if raw is None or stop.is_set():
                out_q.put(None)
                return
            try:
                buf, label, bbox = parse_example_record(raw)
                img = (preprocess_train(buf, bbox, wrng, as_u8=u8)
                       if is_training else preprocess_eval(buf, as_u8=u8))
                out_q.put((img, label))
            except Exception as e:
                out_q.put(e)
                return

    threads = [threading.Thread(target=reader, daemon=True)]
    threads += [threading.Thread(target=batch_worker if batch_native
                                 else worker, args=(w,), daemon=True)
                for w in range(num_threads)]
    for t in threads:
        t.start()

    def _stop_pipeline():
        """Stop threads and join them.  Order matters: DRAIN the queues
        first (unblocking producers stuck on put()), THEN put the None
        wake-up sentinels — draining after would consume our own
        sentinels (or ones an exited reader left) and leave workers
        blocked on raw_q.get() past the join timeout."""
        stop.set()
        for q in (raw_q, out_q):  # unblock producers stuck on put()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for _ in range(num_threads):  # wake workers stuck on get()
            try:
                raw_q.put_nowait(None)
            except queue.Full:
                break
        for t in threads:
            t.join(timeout=5.0)

    def _shutdown():
        """Interpreter-exit backstop: if the process exits while a
        daemon worker is inside the GIL-released C++ decode, CPython
        force-unwinds the thread (pthread_exit) when the foreign call
        returns — which aborts through the C++ frames (glibc
        'FATAL: exception not rethrown').  Stop the pipeline and wait
        for in-flight decodes instead."""
        _stop_pipeline()

    # Registered per pipeline, unregistered when the consuming
    # generator is exhausted or closed — a long test session creating
    # many iterators must not accumulate handlers (each pins its
    # queues/threads until process exit).
    import atexit
    atexit.register(_shutdown)

    def _teardown():
        # Same joins as _shutdown BEFORE unregistering it: an in-flight
        # GIL-released decode at interpreter exit is force-unwound
        # through the C++ frames the moment no one waits for it —
        # dropping the backstop without joining would re-open exactly
        # the crash it exists to prevent.
        _stop_pipeline()
        if not any(t.is_alive() for t in threads):
            atexit.unregister(_shutdown)  # else keep the backstop

    def gen_native():
        done_workers = 0
        try:
            while done_workers < num_threads:
                item = out_q.get()
                if item is None:
                    done_workers += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            _teardown()

    def gen():
        images = np.empty((batch_size, DEFAULT_IMAGE_SIZE, DEFAULT_IMAGE_SIZE,
                           NUM_CHANNELS), np.uint8 if u8 else np.float32)
        labels = np.empty((batch_size,), np.int32)
        filled = 0
        done_workers = 0
        yielded = 0
        try:
            while done_workers < num_threads:
                item = out_q.get()
                if item is None:
                    done_workers += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                images[filled], labels[filled] = item
                filled += 1
                if filled == batch_size:
                    if pad_eval:
                        yield (images.copy(), labels.copy(),
                               np.ones((batch_size,), np.float32))
                    else:
                        yield images.copy(), labels.copy()
                    filled = 0
                    yielded += 1
            if pad_eval:
                # final partial batch zero-padded + fully-masked filler
                # batches up to the agreed cross-host count
                while yielded < eval_batches:
                    mask = np.zeros((batch_size,), np.float32)
                    mask[:filled] = 1.0
                    images[filled:] = 0.0
                    labels[filled:] = 0
                    yield images.copy(), labels.copy(), mask
                    filled = 0
                    yielded += 1
        finally:
            _teardown()

    return gen_native() if batch_native else gen()
