"""Dataset contract -- a copy of ``dtf_tpu/data/base.py``.

An ``input_fn`` returns a Python iterator of host-side numpy
``(images, labels)`` batches -- infinite (repeating) for training,
one-pass for eval -- and a :class:`DatasetSpec` describes the
cardinalities, so the loop can do the reference's epoch math
(steps_per_epoch, eval steps).  Token datasets carry ``seq_len`` > 0:
[B, S] int32 inputs with next-token labels.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    image_size: int
    num_channels: int
    num_classes: int       # for token datasets: the vocabulary size
    num_train: int
    num_eval: int
    one_hot: bool          # cifar uses one-hot + categorical CE; imagenet sparse
    mean_subtract: bool = False
    seq_len: int = 0       # >0 => token-sequence dataset ([B, S] int32
                           # inputs, next-token labels)

    @property
    def image_shape(self):
        return (self.image_size, self.image_size, self.num_channels)

    @property
    def is_sequence(self) -> bool:
        return self.seq_len > 0


# Cardinalities of the reference: cifar 50_000 / 10_000; imagenet
# 1_281_167 / 50_000 with 1001 classes (label 0 = background).
CIFAR10 = DatasetSpec("cifar10", 32, 3, 10, 50_000, 10_000, one_hot=True)
IMAGENET = DatasetSpec("imagenet", 224, 3, 1001, 1_281_167, 50_000,
                       one_hot=False, mean_subtract=True)
# Language modelling: next-token prediction over [B, seq_len] int32 ids.
LM = DatasetSpec("lm", 0, 0, num_classes=32_768, num_train=100_000,
                 num_eval=1_000, one_hot=False, seq_len=2048)

_SPECS = {"cifar10": CIFAR10, "cifar": CIFAR10, "imagenet": IMAGENET,
          "lm": LM}


def shard_for_process(items, process_id: int, process_count: int):
    """Disjoint 1/N split by position -- the reference's shard-by-file
    rule (kept here, torch-free, for the data service's readers)."""
    return items[process_id::process_count]


def get_dataset_spec(name: str) -> DatasetSpec:
    if name not in _SPECS:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(_SPECS)}")
    return _SPECS[name]
