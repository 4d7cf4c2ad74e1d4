"""ImageNet-format TFRecord shards made from a seed, for tests and the
smoke script: real JPEG payloads in the reference's Example layout
(``image/encoded``, ``image/class/label`` in [1, 1000], one
``image/object/bbox`` box), written with ``data/records.py`` under the
reference's file names, so ``--data_dir`` reads them as it would read
ImageNet.  Nothing is downloaded.
"""

from __future__ import annotations

import io
import os
from typing import Tuple

import numpy as np


def make_jpeg(rng: np.random.Generator, height: int, width: int,
              smooth: bool = False, quality: int = 90) -> bytes:
    """One RGB JPEG.  ``smooth``: a coarse random field upsampled
    bilinearly plus a little noise, which compresses like a photograph
    (pure noise, the default, is the smallest-image test payload)."""
    from PIL import Image

    if smooth:
        coarse = rng.integers(0, 256, (max(height // 16, 2),
                                       max(width // 16, 2), 3),
                              dtype=np.uint8)
        field = np.asarray(Image.fromarray(coarse).resize(
            (width, height), Image.BILINEAR), np.int16)
        noise = rng.integers(-6, 7, (height, width, 3), dtype=np.int16)
        arr = np.clip(field + noise, 0, 255).astype(np.uint8)
    else:
        arr = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_shard_file(path: str, count: int, size: Tuple[int, int],
                     seed: int, smooth: bool = False,
                     label_base: int = 0) -> int:
    """One TFRecord file of ``count`` Examples of ``size`` (height,
    width) JPEGs drawn from ``seed``, labels ``1 + (label_base + i) %
    1000``, each with a box; returns the JPEG bytes written."""
    from dtf_tpu_torch.data import records

    rng = np.random.default_rng(seed)
    recs, nbytes = [], 0
    for i in range(count):
        jpeg = make_jpeg(rng, *size, smooth=smooth)
        y0, x0 = rng.uniform(0.0, 0.4, 2)
        y1, x1 = rng.uniform(0.6, 1.0, 2)
        recs.append(records.build_example({
            "image/encoded": jpeg,
            "image/class/label": [1 + (label_base + i) % 1000],
            "image/object/bbox/ymin": [float(y0)],
            "image/object/bbox/xmin": [float(x0)],
            "image/object/bbox/ymax": [float(y1)],
            "image/object/bbox/xmax": [float(x1)],
        }))
        nbytes += len(jpeg)
    records.write_tfrecord_file(path, recs)
    return nbytes


def shard_files(root: str, num_train_files: int, per_train_file: int,
                num_val_files: int, per_val_file: int):
    """[(path, count, label_base, k)] of the train and validation files
    under the reference's names; file k is drawn from seed ``seed *
    1000 + k`` (validation files from k = 500), so any file can be
    written alone -- the smoke script writes them in parallel."""
    out = []
    for name, files, per, off in (
            ("train-{:05d}-of-01024", num_train_files, per_train_file, 0),
            ("validation-{:05d}-of-00128", num_val_files, per_val_file,
             500)):
        for f in range(files):
            out.append((os.path.join(root, name.format(f)), per, f * per,
                        off + f))
    return out


def write_shards(root: str, num_train_files: int = 2, per_train_file: int = 6,
                 num_val_files: int = 2, per_val_file: int = 6,
                 size: Tuple[int, int] = (64, 80), seed: int = 0,
                 smooth: bool = False) -> int:
    """Write ``train-%05d-of-01024`` and ``validation-%05d-of-00128``
    shards of ``size`` (height, width) JPEGs under ``root``; returns the
    JPEG bytes written."""
    os.makedirs(root, exist_ok=True)
    return sum(write_shard_file(path, count, size, seed * 1000 + k,
                                smooth=smooth, label_base=base)
               for path, count, base, k in shard_files(
                   root, num_train_files, per_train_file, num_val_files,
                   per_val_file))
