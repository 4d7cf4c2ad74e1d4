"""CIFAR-10 ResNet entry point -- the PyTorch counterpart of
``dtf_tpu/cli/cifar_main.py``, on one device or data-parallel over many
(``--distribution_strategy``, ``runtime/mesh.py``).

It trains a CIFAR ResNet (resnet20/32/56/110/662, default resnet56) on
``--device`` (default ``cuda``; with no CUDA it raises unless ``--device
cpu`` is given) through the port's Trainer, Keras-momentum SGD and the
CIFAR schedule, on synthetic data or the CIFAR-10 binary files under
``--data_dir`` (the uint8 wire by default: raw pixels to the device,
standardized there).

Examples:
  # one H100, ResNet-56 in bf16 on synthetic data:
  python -m dtf_tpu_torch.cli.cifar_main --use_synthetic_data \\
      --dtype bf16 --train_steps 50 --skip_eval

  # the CIFAR-10 binary files (cifar-10-batches-bin under the dir):
  python -m dtf_tpu_torch.cli.cifar_main --data_dir /data/cifar --dtype bf16

  # on the CPU, two steps of ResNet-20:
  python -m dtf_tpu_torch.cli.cifar_main --use_synthetic_data --device cpu \\
      --model resnet20 --batch_size 4 --train_steps 2 --skip_eval

  # two gloo ranks on the CPU with sync BN (cli/launch.py):
  python -m dtf_tpu_torch.cli.launch --num_processes 2 -- \\
      python -m dtf_tpu_torch.cli.cifar_main --use_synthetic_data \\
      --device cpu --model resnet20 --batch_size 8 --train_steps 3 \\
      --skip_eval --distribution_strategy multi_worker_mirrored --sync_bn
"""

from __future__ import annotations

import logging
import sys

from dtf_tpu_torch.cli.runner import main_run

# the JAX main's defaults (the reference's: epochs 182, batch 128)
CIFAR_DEFAULTS = dict(
    model="resnet56",
    dataset="cifar10",
    train_epochs=182,
    batch_size=128,
    epochs_between_evals=10,
)


def main(argv=None) -> dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    return main_run("dtf_tpu_torch.cli.cifar_main",
                    argv if argv is not None else sys.argv[1:], CIFAR_DEFAULTS)


if __name__ == "__main__":
    main()
