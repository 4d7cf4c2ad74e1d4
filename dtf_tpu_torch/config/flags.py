"""Typed configuration + CLI flags for the port's serving path.

The PyTorch counterpart of ``dtf_tpu/config/flags.py``, cut to the
fields the serving entry (``cli/serve_main.py``) reads: the model and
its dtype, the seed, the device, the ``serve_*`` and ``kv_*`` knobs and
the benchmark log.  Parsing is the same absl style: ``--name value``,
``--name=value`` or ``-name value``.

Two fields are new: ``device`` (``cuda`` or ``cpu``; the port never
picks the CPU on its own) and ``serve_params_npz`` (flax params saved
as an ``.npz``, see ``serve/bridge.py``).  Flags of features not ported
yet (``--serve_tp``, ``--serve_prefix_sharing``) are unknown flags here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# fp16 is not offered: the attention kernels take float32 and bfloat16
DTYPES = {"fp32": torch.float32, "float32": torch.float32,
          "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Config:
    """Every knob of a serving run."""

    model: str = "transformer_small"
    num_classes: Optional[int] = None   # vocabulary; None = the model's
    dtype: str = "fp32"                 # fp32 | bf16
    seed: int = 0
    device: str = "cuda"                # cuda | cpu; never a silent fallback
    benchmark_log_dir: str = ""         # writes metric.log when set
    benchmark_test_id: str = ""

    # --- serving (cli/serve_main.py over dtf_tpu_torch/serve) ---
    serve_max_batch: int = 8            # decode slots = max concurrent sequences
    serve_max_delay_ms: float = 5.0     # batch-fill window after first arrival
    serve_queue_size: int = 64          # bounded admission queue (backpressure)
    serve_max_seq_len: Optional[int] = None  # cache capacity; None = model max
    serve_max_new_tokens: int = 32      # per-request generation budget (demo)
    serve_temperature: float = 0.0      # 0 = greedy
    serve_requests: int = 16            # synthetic-traffic demo request count
    serve_prompt_len: int = 8           # synthetic prompt length (max; varied)
    # chunked-prefill unit in tokens (multiple of kv_page_size); 0 =
    # whole-prompt single chunk; None = 4 pages
    serve_prefill_chunk: Optional[int] = None
    serve_params_npz: str = ""          # flax params as .npz ("" = none)
    # paged KV cache: tokens per page (the contiguous cache is not
    # ported, so 0 is refused) and total pool pages incl. the scratch
    # page (0 = the full reservation, 1 + slots x pages-per-slot)
    kv_page_size: int = 16
    kv_pool_pages: int = 0

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; choose from "
                             f"{sorted(DTYPES)}")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}; use cuda "
                             f"or cpu")
        if self.serve_max_batch < 1 or self.serve_queue_size < 1:
            raise ValueError(
                "serve_max_batch and serve_queue_size must be >= 1")
        if self.kv_page_size < 1:
            raise ValueError(
                f"kv_page_size must be >= 1 (the contiguous KV cache is "
                f"not ported), got {self.kv_page_size}")
        if self.kv_pool_pages < 0 or (self.serve_prefill_chunk is not None
                                      and self.serve_prefill_chunk < 0):
            raise ValueError(
                "kv_pool_pages and serve_prefill_chunk must be >= 0")
        if (self.serve_prefill_chunk
                and self.serve_prefill_chunk % self.kv_page_size):
            raise ValueError(
                f"serve_prefill_chunk ({self.serve_prefill_chunk}) must be "
                f"a multiple of kv_page_size ({self.kv_page_size})")

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _coerce(field: dataclasses.Field, raw: str) -> Any:
    t = str(field.type)
    if raw.lower() in ("none", "null"):
        return None
    if "int" in t:
        return int(raw)
    if "float" in t:
        return float(raw)
    return raw


def parse_flags(argv=None) -> Config:
    """absl-style parsing into a :class:`Config`: ``--name value``,
    ``--name=value`` or ``-name value``."""
    names = {f.name: f for f in dataclasses.fields(Config)}
    kw = {}
    argv = list(argv or [])
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-"):
            raise ValueError(f"unexpected argument {tok!r}")
        name, eq, val = tok.lstrip("-").partition("=")
        if name not in names:
            raise ValueError(f"unknown flag --{name}")
        if not eq:
            if i + 1 == len(argv):
                raise ValueError(f"flag --{name} needs a value")
            i += 1
            val = argv[i]
        kw[name] = _coerce(names[name], val)
        i += 1
    return Config(**kw)
