"""ImageNet ResNet-50 entry point -- the PyTorch counterpart of
``dtf_tpu/cli/imagenet_main.py``, on one device or data-parallel over
many (``--distribution_strategy``, ``runtime/mesh.py``).

It trains ResNet-50 v1.5 (or, with ``--use_trivial_model``, the input
probe) on ``--device`` (default ``cuda``; with no CUDA it raises unless
``--device cpu`` is given) through the port's Trainer, Keras-momentum
SGD and the ImageNet warmup schedule (``--use_tensor_lr``: the
step-boundary piecewise one), in fp32, bf16 or fp16 (a static loss
scale of 128 unless ``--loss_scale`` says otherwise).  Input: the
reference's TFRecord shards under ``--data_dir`` (``train-*-of-01024``,
``validation-*-of-00128``), trained from the data service
(``--input_num_shards``, ``--input_workers``, ``--input_cache_dir``)
and evaluated in one masked pass, or ``--use_synthetic_data``.  JPEG
decode runs in the native library built at first use from
``dtf_tpu_torch/native`` (libjpeg-turbo), else PIL.

Examples:
  # one H100, ResNet-50 in bf16 at the JAX main's batch of 256:
  python -m dtf_tpu_torch.cli.imagenet_main --data_dir /data/imagenet \\
      --dtype bf16 --train_steps 30 --skip_eval
  python -m dtf_tpu_torch.cli.imagenet_main --use_synthetic_data \\
      --dtype bf16 --train_steps 30 --skip_eval

  # the input probe on the CPU, on shards written by the tests:
  python -m dtf_tpu_torch.cli.imagenet_main --data_dir <shards> \\
      --device cpu --use_trivial_model --batch_size 4 --train_steps 2 \\
      --input_num_shards 2 --input_workers 0 --skip_eval \\
      --skip_checkpoint
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
