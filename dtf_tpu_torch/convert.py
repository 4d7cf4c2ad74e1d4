"""flax parameter tree -> PyTorch state dict, for the transformer LM.

``from_flax_params`` takes the ``params`` collection of a
``dtf_tpu`` TransformerLM as a nested dict of numpy arrays (never JAX
arrays: the port does not import jax; a caller that holds JAX arrays
converts them with ``jax.tree_util.tree_map(np.asarray, params)``) and
returns a state dict for ``dtf_tpu_torch.models.transformer
.TransformerLM`` in the model's dtype.

Layout rules:
  ``embed/embedding`` [V, d]       -> ``embed.weight`` as is
  ``pos_embed`` [max_seq, d]       -> ``pos_embed`` as is
  ``qkv/kernel`` [d, 3, H, Dh]     -> ``qkv.weight`` [3*H*Dh, d]
  ``qkv/bias`` [3, H, Dh]          -> ``qkv.bias`` [3*H*Dh]
  Dense ``kernel`` [in, out]       -> Linear ``weight`` [out, in]
  LayerNorm ``scale``/``bias``     -> ``weight``/``bias``
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _leaf(tree, path: str) -> np.ndarray:
    node = tree
    for key in path.split("/"):
        if key not in node:
            raise KeyError(f"flax params have no {path!r} (missing {key!r})")
        node = node[key]
    return np.asarray(node)


def from_flax_params(params, model) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` holding the flax ``params``' values;
    raises KeyError on a missing leaf and ValueError on a shape that
    does not fit."""
    d = model.d_model
    out: Dict[str, np.ndarray] = {
        "embed.weight": _leaf(params, "embed/embedding"),
        "pos_embed": _leaf(params, "pos_embed"),
    }

    def dense(dst: str, src: str, bias: bool = True):
        out[f"{dst}.weight"] = _leaf(params, f"{src}/kernel").T
        if bias:
            out[f"{dst}.bias"] = _leaf(params, f"{src}/bias")

    def layer_norm(dst: str, src: str):
        out[f"{dst}.weight"] = _leaf(params, f"{src}/scale")
        out[f"{dst}.bias"] = _leaf(params, f"{src}/bias")

    for i in range(model.num_layers):
        blk = f"block{i}"
        layer_norm(f"{blk}.ln1", f"{blk}/ln1")
        qkv = _leaf(params, f"{blk}/attn/qkv/kernel")      # [d, 3, H, Dh]
        out[f"{blk}.attn.qkv.weight"] = qkv.reshape(d, -1).T
        out[f"{blk}.attn.qkv.bias"] = _leaf(
            params, f"{blk}/attn/qkv/bias").reshape(-1)
        dense(f"{blk}.attn.out", f"{blk}/attn/out", bias=False)
        layer_norm(f"{blk}.ln2", f"{blk}/ln2")
        dense(f"{blk}.fc1", f"{blk}/fc1")
        dense(f"{blk}.fc2", f"{blk}/fc2", bias=False)
    layer_norm("ln_f", "ln_f")
    dense("lm_head", "lm_head")

    want = model.state_dict()
    if set(out) != set(want):
        raise ValueError(f"converted keys differ from the model's: "
                         f"{sorted(set(out) ^ set(want))}")
    sd = {}
    for name, arr in out.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: flax shape {tuple(arr.shape)} does "
                             f"not fit {tuple(want[name].shape)}")
        # a copy: arrays handed over from JAX are read-only
        sd[name] = torch.from_numpy(np.array(
            arr, dtype=np.float32, order="C")).to(want[name].dtype)
    return sd
