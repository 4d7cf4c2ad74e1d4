"""ImageNet ResNet-50 entry point -- the PyTorch counterpart of
``dtf_tpu/cli/imagenet_main.py``, on one device or data-parallel over
many (``--distribution_strategy``, ``runtime/mesh.py``).

It trains ResNet-50 v1.5 (or, with ``--use_trivial_model``, the input
probe) on ``--device`` (default ``cuda``; with no CUDA it raises unless
``--device cpu`` is given) through the port's Trainer, Keras-momentum
SGD and the ImageNet warmup schedule.  Only synthetic data is ported:
the ImageNet record pipeline is not, and ``--data_dir`` raises.

Examples:
  # one H100, ResNet-50 in bf16 at the JAX main's batch of 256:
  python -m dtf_tpu_torch.cli.imagenet_main --use_synthetic_data \\
      --dtype bf16 --train_steps 30 --skip_eval

  # the input probe on the CPU:
  python -m dtf_tpu_torch.cli.imagenet_main --use_synthetic_data \\
      --device cpu --use_trivial_model --batch_size 4 --train_steps 2 \\
      --skip_eval
"""

from __future__ import annotations

import logging
import sys

from dtf_tpu_torch.cli.runner import main_run

# the JAX main's defaults (the reference's 90 epochs)
IMAGENET_DEFAULTS = dict(
    model="resnet50",
    dataset="imagenet",
    train_epochs=90,
    batch_size=256,
    epochs_between_evals=1,
)


def main(argv=None) -> dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    return main_run("dtf_tpu_torch.cli.imagenet_main",
                    argv if argv is not None else sys.argv[1:], IMAGENET_DEFAULTS)


if __name__ == "__main__":
    main()
