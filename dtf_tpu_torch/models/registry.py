"""Model registry -- the transformer LM entries of
``dtf_tpu/models/registry.py``, with the same names, widths and default
vocabulary.  The ResNet, MoE and pipeline families are not ported yet.
"""

from __future__ import annotations

import functools

import torch

from dtf_tpu_torch.models import transformer

_REGISTRY = {
    "transformer": (transformer.TransformerLM, 32_768),
    "transformer_small": (
        functools.partial(transformer.TransformerLM, num_layers=4,
                          d_model=256, num_heads=4, d_ff=1024),
        32_768),
    # GPT-2-small-sized flagship with 6 heads x d_head 128 (the same
    # parameter shapes and count as GPT-2's 12 x 64)
    "transformer_tpu": (
        functools.partial(transformer.TransformerLM, num_layers=12,
                          d_model=768, num_heads=6, d_ff=3072),
        32_768),
}


def build_model(name: str, num_classes: int | None = None,
                dtype=torch.float32, **model_kw):
    """Returns (module, l2_weight); the LM family has no L2 term, so
    l2_weight is always 0.0.  The module's parameters are left as
    constructed (see ``serve.bridge`` for the serving initialization)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    ctor, default_classes = _REGISTRY[name]
    module = ctor(vocab_size=num_classes or default_classes, dtype=dtype,
                  **model_kw)
    return module, 0.0
