"""On-device input normalization -- the step half of the uint8 wire, the
PyTorch counterpart of ``dtf_tpu/data/normalize.py``.

A pipeline on the uint8 wire ships raw NHWC pixels, a quarter of the
float32 wire's bytes over PCIe, and the Trainer runs the dataset's
normalization in float32 as the first op of its train and eval steps,
on the batch's device.  The uint8 -> float32 conversion is exact and
the arithmetic is the host pipelines', so the two wires agree to the
order of the per-image reductions (about 1e-6 relative).
"""

from __future__ import annotations

import numpy as np
import torch

# R, G, B -- the value of dtf_tpu/data/imagenet.py CHANNEL_MEANS
CHANNEL_MEANS = np.array([123.68, 116.78, 103.94], np.float32)


def cifar_standardize(images: torch.Tensor) -> torch.Tensor:
    """tf.image.per_image_standardization over the last three dims:
    per-image zero mean, unit stddev with the 1/sqrt(N) floor (the host
    twin is ``data/cifar.py`` ``standardize``)."""
    x = images.float()
    dims = (-3, -2, -1)
    n_elems = torch.tensor(float(x.shape[-1] * x.shape[-2] * x.shape[-3]),
                           dtype=torch.float32, device=x.device)
    mean = x.mean(dims, keepdim=True)
    std = x.std(dims, correction=0, keepdim=True)
    adjusted = torch.maximum(std, 1.0 / torch.sqrt(n_elems))
    return (x - mean) / adjusted


def imagenet_mean_subtract(images: torch.Tensor) -> torch.Tensor:
    """Channel-mean subtraction without scaling, channels last."""
    return images.float() - torch.from_numpy(CHANNEL_MEANS).to(images.device)


def for_dataset(name: str):
    """The on-device normalize fn a uint8-wire pipeline defers to."""
    fns = {"cifar10": cifar_standardize,
           "imagenet": imagenet_mean_subtract}
    if name not in fns:
        raise ValueError(f"no on-device normalization for dataset {name!r}")
    return fns[name]


def for_config(cfg, spec):
    """The step's normalization a config's input wire implies, or None
    when batches arrive host-normalized: the float32 wire, synthetic
    data, no ``data_dir``, or a token dataset -- the JAX package's
    predicate."""
    if (cfg.input_wire != "uint8" or cfg.use_synthetic_data
            or not cfg.data_dir or spec.is_sequence):
        return None
    return for_dataset(spec.name)
