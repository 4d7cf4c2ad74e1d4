"""Synthetic data backend -- a copy of ``dtf_tpu/data/synthetic.py``.

One random batch -- truncated normal images (mean 127, std 60, the raw
pixel range) and uniform integer labels, or uniform token ids with
next-token labels -- repeated forever.  numpy only, drawn from
``np.random.default_rng(seed)`` in the same order as the JAX package,
so both packages train on bit-identical batches.
"""

from __future__ import annotations

import numpy as np

from dtf_tpu_torch.data.base import DatasetSpec


def _truncated_normal(rng, shape, mean, std):
    """Resample outside +-2 sigma, like tf.random.truncated_normal."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (x * std + mean).astype(np.float32)


def synthetic_input_fn(spec: DatasetSpec, is_training: bool, batch_size: int,
                       seed: int = 0, dtype=np.float32,
                       start_step: int = 0):
    """Yields the same (images, labels) batch forever (train) or for one
    eval pass.  labels are int32 class ids.  ``start_step`` is accepted
    for the real pipelines' signature: every position of this stream is
    the same batch."""
    del start_step
    rng = np.random.default_rng(seed)
    if spec.is_sequence:
        # token LM: random ids, next-token labels (shift left; the final
        # position wraps -- harmless for synthetic data)
        tokens = rng.integers(0, spec.num_classes,
                              size=(batch_size, spec.seq_len), dtype=np.int32)
        images = tokens
        labels = np.roll(tokens, -1, axis=1)
    else:
        images = _truncated_normal(
            rng, (batch_size,) + spec.image_shape, 127.0, 60.0).astype(dtype)
        labels = rng.integers(0, spec.num_classes - 1, size=(batch_size,),
                              dtype=np.int32)

    def gen():
        if is_training:
            while True:
                yield images, labels
        else:
            n = max(1, spec.num_eval // batch_size)
            for _ in range(n):
                yield images, labels

    return gen()
