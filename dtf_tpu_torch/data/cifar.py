"""CIFAR-10 binary input pipeline -- a copy of ``dtf_tpu/data/cifar.py``
(numpy only), with the process index and count as arguments.

  - fixed-length records: 1 label byte + 3072 CHW image bytes, files
    ``data_batch_{1..5}.bin`` / ``test_batch.bin`` under
    ``cifar-10-batches-bin``;
  - train augmentation: pad to 40x40, random 32x32 crop, random
    horizontal flip;
  - per_image_standardization on the host (float32 wire) or on the
    device (uint8 wire, ``data/normalize.py``);
  - a per-process shard of the files, a full-dataset shuffle.

The dataset (150 MB) is read once into host memory and batches are
gathered with numpy.  Batch *n* of the training stream is a pure
function of (seed, process, n), bit-identical to the JAX package's --
except that the float32 wire here is float32: the JAX package's yields
float64 batches under NumPy 2 (the same values before the cast).
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from dtf_tpu_torch.data.pipeline import shard_for_process

HEIGHT = WIDTH = 32
NUM_CHANNELS = 3
RECORD_BYTES = HEIGHT * WIDTH * NUM_CHANNELS + 1
NUM_DATA_FILES = 5


def get_filenames(is_training: bool, data_dir: str):
    """The five train files or the test file, under
    ``cifar-10-batches-bin``; raises when that directory is missing."""
    if "cifar-10-batches-bin" not in data_dir:
        data_dir = os.path.join(data_dir, "cifar-10-batches-bin")
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(
            f"CIFAR-10 binary directory not found: {data_dir}; download and "
            f"extract cifar-10-binary.tar.gz")
    if is_training:
        return [os.path.join(data_dir, f"data_batch_{i}.bin")
                for i in range(1, NUM_DATA_FILES + 1)]
    return [os.path.join(data_dir, "test_batch.bin")]


def write_binary_file(path: str, images: np.ndarray,
                      labels: np.ndarray) -> None:
    """Write records in the CIFAR binary wire format: 1 label byte +
    3072 CHW image bytes each; the inverse of :func:`load_records`."""
    images = np.asarray(images, np.uint8)
    labels = np.asarray(labels)
    n = len(labels)
    recs = np.zeros((n, RECORD_BYTES), np.uint8)
    recs[:, 0] = labels
    recs[:, 1:] = images.transpose(0, 3, 1, 2).reshape(n, -1)
    with open(path, "wb") as f:
        f.write(recs.tobytes())


def load_records(filenames, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Parses fixed-length records -> (images HWC ``dtype``, labels
    int32).  ``dtype=np.uint8`` keeps the raw pixels."""
    blobs = []
    for fn in filenames:
        raw = np.fromfile(fn, dtype=np.uint8)
        if raw.size % RECORD_BYTES:
            raise IOError(f"{fn}: size {raw.size} not a multiple of "
                          f"{RECORD_BYTES}")
        blobs.append(raw.reshape(-1, RECORD_BYTES))
    records = np.concatenate(blobs)
    labels = records[:, 0].astype(np.int32)
    images = (records[:, 1:]
              .reshape(-1, NUM_CHANNELS, HEIGHT, WIDTH)
              .transpose(0, 2, 3, 1)
              .astype(dtype, copy=False))
    return images, labels


def augment_batch(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """pad-4 -> random crop -> random flip; moves pixels without
    arithmetic, so uint8 in gives uint8 out, bit-identical to
    augmenting the same pixels in float32."""
    n = images.shape[0]
    padded = np.zeros((n, HEIGHT + 8, WIDTH + 8, NUM_CHANNELS),
                      images.dtype)
    padded[:, 4:4 + HEIGHT, 4:4 + WIDTH] = images
    ys = rng.integers(0, 9, n)
    xs = rng.integers(0, 9, n)
    flips = rng.random(n) < 0.5
    out = np.empty_like(images)
    for i in range(n):
        crop = padded[i, ys[i]:ys[i] + HEIGHT, xs[i]:xs[i] + WIDTH]
        out[i] = crop[:, ::-1] if flips[i] else crop
    return out


def standardize(images: np.ndarray) -> np.ndarray:
    """tf.image.per_image_standardization: per-image zero mean, unit
    stddev with the 1/sqrt(N) floor."""
    n_elems = float(np.prod(images.shape[1:]))
    mean = images.mean(axis=(1, 2, 3), keepdims=True)
    std = images.std(axis=(1, 2, 3), keepdims=True)
    adjusted = np.maximum(std, 1.0 / np.sqrt(n_elems))
    return (images - mean) / adjusted


def cifar_input_fn(data_dir: str, is_training: bool, batch_size: int,
                   seed: int = 0, process_id: int = 0,
                   process_count: int = 1, drop_remainder: bool = True,
                   wire: str = "float32", start_step: int = 0) -> Iterator:
    """Yields (images, labels) numpy batches; infinite for training.

    The shuffle order of epoch *e* and the augmentation draws of batch
    *(e, k)* are each seeded from ``(seed, process_id, e[, k])``, so a
    stream started at ``start_step=n`` yields exactly the batches an
    uninterrupted one yields from position n on.

    ``wire``: ``"float32"`` standardizes on the host; ``"uint8"`` ships
    the raw augmented pixels and leaves the standardization to the
    step (``data/normalize.py`` ``cifar_standardize``).

    Eval with ``drop_remainder=False`` strides the examples over the
    processes and zero-pads the last batch, flagged by a mask:
    ``(images, labels, mask)`` batches that cover each test example
    exactly once.  ``drop_remainder=True`` yields full 2-tuple batches
    only.
    """
    if wire not in ("float32", "uint8"):
        raise ValueError(f"wire must be 'float32' or 'uint8', got {wire!r}")
    u8 = wire == "uint8"

    files = get_filenames(is_training, data_dir)
    if is_training and process_count > 1:
        files = shard_for_process(files, process_id, process_count) or files
    images, labels = load_records(files, dtype=np.uint8)
    if is_training and len(images) < batch_size:
        raise ValueError(
            f"process {process_id}'s file shard holds {len(images)} images, "
            f"fewer than the per-host batch {batch_size}; reduce batch_size "
            f"or process count")
    # nonnegative per-process base entropy for the counter-derived RNGs
    seed_base = (int(seed) + 7919 * int(process_id)) & 0xFFFFFFFF

    def finalize(batch: np.ndarray) -> np.ndarray:
        if u8:
            return batch
        # standardize's 1/sqrt(N) floor is a float64 scalar, which
        # NumPy 2 lets promote the batch: the wire is float32
        return standardize(batch.astype(np.float32)).astype(np.float32)

    def gen():
        if is_training:
            per_epoch = len(images) // batch_size
            step = int(start_step)
            cur_epoch, order = -1, None
            while True:
                epoch, k = divmod(step, per_epoch)
                if epoch != cur_epoch:
                    cur_epoch = epoch
                    order = np.random.default_rng(
                        np.random.SeedSequence(
                            [seed_base, epoch])).permutation(len(images))
                idx = order[k * batch_size:(k + 1) * batch_size]
                brng = np.random.default_rng(
                    np.random.SeedSequence([seed_base, epoch, k, 1]))
                yield finalize(augment_batch(images[idx], brng)), labels[idx]
                step += 1
        elif drop_remainder:
            for i in range(0, len(images) - batch_size + 1, batch_size):
                yield (finalize(images[i:i + batch_size].copy()),
                       labels[i:i + batch_size])
        else:
            total = len(images)
            local_idx = np.arange(process_id, total, process_count)
            max_local = -(-total // process_count)
            nbatches = -(-max_local // batch_size)
            for b in range(nbatches):
                sel = local_idx[b * batch_size:(b + 1) * batch_size]
                imgs = np.zeros((batch_size, HEIGHT, WIDTH, NUM_CHANNELS),
                                np.uint8 if u8 else np.float32)
                lbls = np.zeros((batch_size,), np.int32)
                mask = np.zeros((batch_size,), np.float32)
                if len(sel):
                    imgs[:len(sel)] = finalize(images[sel].copy())
                    lbls[:len(sel)] = labels[sel]
                    mask[:len(sel)] = 1.0
                yield imgs, lbls, mask

    return gen()
