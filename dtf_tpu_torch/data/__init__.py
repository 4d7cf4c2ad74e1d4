"""Datasets: the spec contract, the synthetic backend and the
host-to-device prefetcher."""

from dtf_tpu_torch.data.base import (DatasetSpec,  # noqa: F401
                                     get_dataset_spec)
from dtf_tpu_torch.data.synthetic import synthetic_input_fn  # noqa: F401
