"""flax trees <-> PyTorch state dicts, for the transformer LM and the
vision models.

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

``from_flax_vision`` / ``to_flax_vision`` carry a ResNet's or the
trivial model's ``params`` and ``batch_stats`` both ways; the flax path
of a leaf is the torch module path with "/" for ".":
  Conv ``kernel`` HWIO             -> ``weight`` OIHW (transpose 3, 2, 0, 1)
  Dense ``kernel`` [in, out]       -> ``weight`` [out, in]; ``bias`` as is
  BatchNorm ``scale``/``bias``     -> ``weight``/``bias``
  batch_stats ``mean``/``var``     -> ``running_mean``/``running_var``
Both directions raise KeyError on a missing leaf and ValueError on a
shape that does not fit or a leaf the model has no place for.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


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


# flax leaf -> torch layout, and back, by the kind of module
_FROM_FLAX = {"conv": lambda a: a.transpose(3, 2, 0, 1),   # HWIO -> OIHW
              "dense": lambda a: a.T, None: lambda a: a}
_TO_FLAX = {"conv": lambda a: a.transpose(2, 3, 1, 0),     # OIHW -> HWIO
            "dense": lambda a: a.T, None: lambda a: a}


def _vision_leaves(model):
    """(state-dict key, flax collection, flax path, layout kind) for
    each leaf of a vision model."""
    from dtf_tpu_torch.models.resnet import BatchNorm

    out = []
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, nn.Conv2d):
            out.append((f"{name}.weight", "params", f"{path}/kernel", "conv"))
        elif isinstance(mod, nn.Linear):
            out += [(f"{name}.weight", "params", f"{path}/kernel", "dense"),
                    (f"{name}.bias", "params", f"{path}/bias", None)]
        elif isinstance(mod, BatchNorm):
            out += [(f"{name}.{t}", coll, f"{path}/{f}", None)
                    for t, coll, f in (
                        ("weight", "params", "scale"),
                        ("bias", "params", "bias"),
                        ("running_mean", "batch_stats", "mean"),
                        ("running_var", "batch_stats", "var"))]
    return out


def _flat_paths(tree, prefix=""):
    out = set()
    for key, node in tree.items():
        path = f"{prefix}{key}"
        out |= (_flat_paths(node, path + "/") if isinstance(node, dict)
                else {path})
    return out


def from_flax_vision(params, batch_stats, model) -> Dict[str, torch.Tensor]:
    """The state dict (parameters and BN buffers) of a vision ``model``
    holding the flax ``params`` and ``batch_stats`` (nested dicts of
    numpy arrays), in float32."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    want = model.state_dict()
    sd, used = {}, {"params": set(), "batch_stats": set()}
    for key, coll, path, kind in _vision_leaves(model):
        arr = _FROM_FLAX[kind](_leaf(trees[coll], path))
        used[coll].add(path)
        if tuple(arr.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: flax {coll} {path!r} of shape "
                             f"{tuple(arr.shape)} does not fit "
                             f"{tuple(want[key].shape)}")
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                            order="C"))
    for coll, tree in trees.items():
        extra = _flat_paths(tree) - used[coll]
        if extra:
            raise ValueError(f"flax {coll} leaves the model has no place "
                             f"for: {sorted(extra)}")
    return sd


def to_flax_vision(model) -> Tuple[dict, dict]:
    """(params, batch_stats) of a vision ``model`` as the flax trees, as
    nested dicts of float32 numpy arrays."""
    trees: dict = {"params": {}, "batch_stats": {}}
    sd = model.state_dict()
    for key, coll, path, kind in _vision_leaves(model):
        arr = _TO_FLAX[kind](sd[key].detach().to("cpu", torch.float32)
                             .numpy())
        node = trees[coll]
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(arr)
    return trees["params"], trees["batch_stats"]
