"""Language-model training entry point -- the PyTorch counterpart of
``dtf_tpu/cli/lm_main.py``, on one device or data-parallel over many
(``--distribution_strategy``, ``runtime/mesh.py``).

It trains a registry transformer on ``--device`` (default ``cuda``;
with no CUDA it raises unless ``--device cpu`` is given) through the
port's Trainer and its attention kernels: the flash forward (K1) and
the flash backward (K3, or K2a + K2b), with AdamW under the warmup +
cosine LM schedule.

Examples:
  # one H100, the flagship at full width and depth in bf16:
  python -m dtf_tpu_torch.cli.lm_main --use_synthetic_data \\
      --model transformer_tpu --dtype bf16 --batch_size 8 --train_steps 30

  # on the CPU (the kernels' plain versions), a small width:
  python -m dtf_tpu_torch.cli.lm_main --use_synthetic_data --device cpu \\
      --model transformer_small --seq_len 32 --num_classes 256 \\
      --batch_size 4 --train_steps 3 --log_steps 1

  # eight H100s of one host, one rank each over NCCL:
  python -m dtf_tpu_torch.cli.launch --num_processes 8 -- \\
      python -m dtf_tpu_torch.cli.lm_main --use_synthetic_data \\
      --model transformer_tpu --distribution_strategy multi_worker_mirrored
"""

from __future__ import annotations

import logging
import sys

from dtf_tpu_torch.cli.runner import main_run

LM_DEFAULTS = dict(
    model="transformer",
    dataset="lm",
    train_epochs=1,
    batch_size=8,
    dtype="bf16",
    optimizer="adamw",     # warmup + cosine LM recipe (schedules.lm_schedule)
    skip_eval=True,
)


def main(argv=None) -> dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    return main_run("dtf_tpu_torch.cli.lm_main",
                    argv if argv is not None else sys.argv[1:], LM_DEFAULTS)


if __name__ == "__main__":
    main()
