"""Weights for serving -- the PyTorch counterpart of
``dtf_tpu/serve/bridge.py``.

Four sources:

  random init -- ``random_init(model, seed)``: every parameter drawn
      from one ``torch.Generator(seed)`` on the CPU, with flax's default
      initializers for the same leaves (lecun truncated-normal Dense
      kernels, zero biases, fan-in normal embeddings, N(0, 0.02)
      positions, unit LayerNorm scales), so a random-init run behaves
      like the JAX package's.  The numbers differ from JAX's: torch does
      not reproduce threefry.
  flax params -- ``load_flax_npz(path)``: an ``.npz`` whose keys are the
      flax param paths joined by "/" (``block0/attn/qkv/kernel``), as
      ``np.savez(path, **flat)`` writes them, carried into the model by
      ``convert.from_flax_params``.
  a training checkpoint -- ``--model_dir``: the newest usable step the
      port's ``train/checkpoint.py`` wrote (a torn newest step falls
      back to the one before, as the trainer's restore does); the
      optimizer state is not read.
  an export -- ``--export_dir``: what ``--export_dir`` training wrote
      (inference variables only); it wins over ``--model_dir``.

Orbax checkpoints of the JAX package are not read here (the port
imports no JAX package); ``convert.py`` carries a JAX state across.
``serving_memory_plan`` is the byte accounting serve_main logs.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from dtf_tpu_torch import convert
from dtf_tpu_torch.models.initializers import variance_scaling_

log = logging.getLogger("dtf_tpu_torch")


@torch.no_grad()
def random_init(model, seed: int):
    """Fill ``model``'s parameters from ``torch.Generator(seed)``, in
    place; returns the model.  Draws on the CPU in float32 (so the
    numbers do not depend on the device), then copies into each
    parameter's device and dtype."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    for name, p in model.named_parameters():
        w = torch.empty(p.shape, dtype=torch.float32)
        leaf = name.rsplit(".", 1)[-1]
        if name == "pos_embed":
            nn.init.normal_(w, std=0.02, generator=gen)
        elif name == "embed.weight":
            nn.init.normal_(w, std=1.0 / math.sqrt(p.shape[1]),
                            generator=gen)
        elif ".ln" in f".{name}" and leaf == "weight":
            w.fill_(1.0)
        elif leaf == "bias":
            w.zero_()
        else:                                   # Linear weight [out, in]
            variance_scaling_(w, 1.0, p.shape[1], gen)   # lecun_normal
        p.copy_(w)
    return model


def load_flax_npz(path: str) -> dict:
    """Nested dict of numpy arrays from an ``.npz`` of "/"-joined flax
    param paths."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return tree


def load_inference_variables(model_dir: str = "", export_dir: str = "",
                             step: Optional[int] = None) -> dict:
    """``{"params", "batch_stats"}`` from an export (``export_dir``,
    which wins) or a training checkpoint (``model_dir``; ``step`` None
    is the newest usable one).  Raises FileNotFoundError when neither
    holds one: serving random weights would silently answer noise."""
    from dtf_tpu_torch.train import checkpoint

    if export_dir and os.path.isfile(os.path.join(
            os.path.abspath(export_dir), "model", checkpoint.PAYLOAD)):
        log.info("serve bridge: loading exported model from %s", export_dir)
        return checkpoint.load_exported_model(export_dir)
    if model_dir:
        variables = checkpoint.load_train_checkpoint(model_dir, step=step)
        if variables is not None:
            return variables
    raise FileNotFoundError(
        f"no checkpoint to serve: export_dir={export_dir!r} has no "
        f"model/, model_dir={model_dir!r} has no checkpoints/")


def load_for_serving(model, npz_path: str = "", model_dir: str = "",
                     export_dir: str = ""):
    """Load weights into ``model`` from flax params in ``npz_path``, else
    from ``export_dir`` or ``model_dir``; returns the model."""
    if npz_path:
        params = load_flax_npz(npz_path)
        log.info("serve bridge: loaded flax params from %s", npz_path)
    else:
        params = load_inference_variables(model_dir, export_dir)["params"]
    model.load_state_dict(convert.from_flax_params(params, model))
    return model


def serving_memory_plan(model, *, num_slots: int, max_seq_len: int,
                        kv_page_size: int = 0,
                        kv_pool_pages: int = 0) -> dict:
    """Byte accounting of the KV cache: the contiguous layout reserves
    ``num_slots x max_seq_len`` tokens, the paged pool
    ``(kv_pool_pages - 1) x kv_page_size`` (``kv_pool_pages`` of 0 is
    the full reservation, 1 + slots x pages-per-slot; ``kv_page_size``
    0 is the contiguous layout)."""
    head_dim = model.d_model // model.num_heads
    elem = torch.empty((), dtype=model.dtype).element_size()
    per_token = 2 * model.num_layers * model.num_heads * head_dim * elem
    pages_per_slot = -(-max_seq_len // max(kv_page_size, 1))
    pool_pages = int(kv_pool_pages) or 1 + num_slots * pages_per_slot
    contiguous = num_slots * max_seq_len
    paged = (pool_pages - 1) * kv_page_size if kv_page_size else 0
    plan = {"per_token_kv_bytes": per_token,
            "kv_bytes_contiguous": contiguous * per_token,
            "kv_bytes_paged": paged * per_token,
            "kv_tokens_capacity": paged or contiguous,
            "pages_per_slot": pages_per_slot if kv_page_size else 0,
            "pool_pages": pool_pages if kv_page_size else 0}
    log.info("serving memory plan: %d slots x %d tokens; KV contiguous "
             "%.1f MB%s", num_slots, max_seq_len,
             plan["kv_bytes_contiguous"] / 2**20,
             (f", paged pool {plan['kv_bytes_paged'] / 2**20:.1f} MB "
              f"({pool_pages} pages x {kv_page_size} tokens)"
              if kv_page_size else " (paged cache off)"))
    return plan
