"""flax trees <-> PyTorch state, for the transformer LM and the vision
models: parameters, batch statistics and a whole training state.

Everything here takes numpy in and gives numpy out on the flax side
(never JAX arrays: the port does not import jax; a caller that holds
JAX arrays converts them with ``jax.tree_util.tree_map(np.asarray,
tree)``), so a test can carry a JAX run's state into the port and
back.  Every leaf is mapped by its flax path (``leaves``); the layout
rules:

  ``embed/embedding`` [V, d]       -> ``embed.weight`` as is
  ``pos_embed`` [max_seq, d]       -> ``pos_embed`` as is
  ``qkv/kernel`` [d, 3, H, Dh]     -> ``qkv.weight`` [3*H*Dh, d]
  ``qkv/bias`` [3, H, Dh]          -> ``qkv.bias`` [3*H*Dh]
  Conv ``kernel`` HWIO             -> ``weight`` OIHW (transpose 3, 2, 0, 1)
  Dense ``kernel`` [in, out]       -> Linear ``weight`` [out, in]
  LayerNorm/BatchNorm ``scale``    -> ``weight``; ``bias`` as is
  batch_stats ``mean``/``var``     -> ``running_mean``/``running_var``

A vision model's flax path of a leaf is its torch module path with "/"
for "."; the transformer's names follow the flax module tree
(``block{i}/attn/qkv``, ...).

A training state (:func:`train_state_to_flax`,
:func:`train_state_from_flax`) is the JAX package's ``TrainState`` as
a nested dict: ``step``, ``params``, ``batch_stats``, ``opt_state``
(optax AdamW ``{"adam": {"count", "mu", "nu"}}`` or Keras SGD
``{"velocity"}``, each moment tree in its parameter's flax layout),
``loss_scale`` and ``good_steps`` (None under static scaling).  The
checkpoint payload (``train/checkpoint.py``) is that dict flattened to
"/"-joined keys.

The async parameter server's wire (:func:`wire_layout`,
:func:`to_wire`, :func:`from_wire`) is the JAX package's flat vector,
``jax.flatten_util.ravel_pytree(params)[0]``: the ``params`` leaves in
``jax.tree_util``'s order (dict keys sorted level by level), each
raveled in its flax layout (conv kernels HWIO, dense kernels [in,
out]).  So a store's state is one bit pattern whichever package's
workers push to it, and snapshots move between them.

Conversions raise KeyError on a missing leaf and ValueError on a shape
that does not fit or a leaf the model has no place for.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for key, node in tree.items():
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            out.update(flatten(node, path + "/"))
        else:
            out[path] = node
    return out


def unflatten(flat: dict) -> dict:
    """The nested dict of "/"-joined keys."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def _lm_leaves(model):
    """(state-dict key, flax collection, flax path, layout) of each
    transformer leaf."""
    out = [("embed.weight", "params", "embed/embedding", None),
           ("pos_embed", "params", "pos_embed", None)]

    def dense(dst, src, bias=True):
        out.append((f"{dst}.weight", "params", f"{src}/kernel", "dense"))
        if bias:
            out.append((f"{dst}.bias", "params", f"{src}/bias", None))

    def norm(dst, src):
        out.extend([(f"{dst}.weight", "params", f"{src}/scale", None),
                    (f"{dst}.bias", "params", f"{src}/bias", None)])

    for i in range(model.num_layers):
        blk = f"block{i}"
        norm(f"{blk}.ln1", f"{blk}/ln1")
        out += [(f"{blk}.attn.qkv.weight", "params",
                 f"{blk}/attn/qkv/kernel", "qkv"),
                (f"{blk}.attn.qkv.bias", "params",
                 f"{blk}/attn/qkv/bias", "qkv_bias")]
        dense(f"{blk}.attn.out", f"{blk}/attn/out", bias=False)
        norm(f"{blk}.ln2", f"{blk}/ln2")
        dense(f"{blk}.fc1", f"{blk}/fc1")
        dense(f"{blk}.fc2", f"{blk}/fc2", bias=False)
    norm("ln_f", "ln_f")
    dense("lm_head", "lm_head")
    return out


def _vision_leaves(model):
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


def leaves(model):
    """(state-dict key, flax collection, flax path, layout) for every
    leaf of a transformer LM or a vision model."""
    from dtf_tpu_torch.models.transformer import TransformerLM

    if isinstance(model, TransformerLM):
        return _lm_leaves(model)
    return _vision_leaves(model)


def _from_flax(t: torch.Tensor, layout, model) -> torch.Tensor:
    if layout == "conv":
        return t.permute(3, 2, 0, 1)                # HWIO -> OIHW
    if layout == "dense":
        return t.t()
    if layout == "qkv":                             # [d, 3, H, Dh]
        return t.reshape(t.shape[0], -1).t()
    if layout == "qkv_bias":
        return t.reshape(-1)
    return t


def _to_flax(t: torch.Tensor, layout, model) -> torch.Tensor:
    if layout == "conv":
        return t.permute(2, 3, 1, 0)                # OIHW -> HWIO
    if layout == "dense":
        return t.t()
    if layout in ("qkv", "qkv_bias"):
        heads = (3, model.num_heads, model.d_model // model.num_heads)
        if layout == "qkv":                         # [3*H*Dh, d]
            return t.t().reshape(model.d_model, *heads)
        return t.reshape(heads)
    return t


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    # a copy (arrays handed over from JAX are read-only), floats as
    # float32
    arr = np.array(leaf, order="C")
    return torch.from_numpy(arr.astype(np.float32) if arr.dtype.kind == "f"
                            else arr)


def _numpy(flat: dict) -> dict:
    return {k: v.numpy() for k, v in flat.items()}


def _flat_from_tree(tree) -> dict:
    """"/"-joined leaves of a nested dict as tensors; None leaves
    dropped."""
    return {k: _tensor(v) for k, v in flatten(tree).items()
            if v is not None}


# ---------------------------------------------------------------------------
# flat flax state: {"params/block0/ln1/scale": tensor, ...}
# ---------------------------------------------------------------------------

def model_to_flat(model) -> Dict[str, torch.Tensor]:
    """``model``'s parameters and BN buffers in their flax layout as
    contiguous float32 CPU tensors keyed "params/<path>" and
    "batch_stats/<path>" (the layout change runs on the model's
    device)."""
    sd = model.state_dict()
    return {f"{coll}/{path}": _to_flax(sd[key].detach().float(), layout,
                                       model).contiguous().cpu()
            for key, coll, path, layout in leaves(model)}


def model_from_flat(flat: dict, model, device=None) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` holding the "params/..." and
    "batch_stats/..." leaves of ``flat`` (tensors or numpy arrays), on
    ``device`` (default: the CPU), in each leaf's dtype."""
    want = model.state_dict()
    sd = {}
    used = set()
    for key, coll, path, layout in leaves(model):
        name = f"{coll}/{path}"
        if name not in flat:
            raise KeyError(f"flax tree has no {path!r} in {coll}")
        used.add(name)
        t = _from_flax(_tensor(flat[name]).to(device), layout, model)
        if tuple(t.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: flax {coll} {path!r} of shape "
                             f"{tuple(t.shape)} does not fit "
                             f"{tuple(want[key].shape)}")
        sd[key] = t.to(want[key].dtype).contiguous()
    extra = {k for k in flat if k.split("/")[0] in ("params", "batch_stats")
             } - used
    if extra:
        raise ValueError(f"flax leaves the model has no place for: "
                         f"{sorted(extra)}")
    return sd


def from_flax(params, batch_stats, model) -> Dict[str, torch.Tensor]:
    """The state dict (parameters and BN buffers) of ``model`` holding
    the flax ``params`` and ``batch_stats`` (nested dicts of numpy
    arrays)."""
    return model_from_flat(_flat_from_tree(
        {"params": params, "batch_stats": batch_stats or {}}), model)


def to_flax(model) -> Tuple[dict, dict]:
    """(params, batch_stats) of ``model`` as the flax trees, nested
    dicts of float32 numpy arrays (batch_stats empty for the LM)."""
    tree = unflatten(_numpy(model_to_flat(model)))
    return tree.get("params", {}), tree.get("batch_stats", {})


def from_flax_params(params, model) -> Dict[str, torch.Tensor]:
    """The state dict of a transformer ``model`` holding the flax
    ``params``' values."""
    return from_flax(params, None, model)


def to_flax_params(model) -> dict:
    """A transformer ``model``'s parameters as the flax ``params``
    tree."""
    return to_flax(model)[0]


def from_flax_vision(params, batch_stats, model) -> Dict[str, torch.Tensor]:
    """The state dict (parameters and BN buffers) of a vision ``model``
    holding the flax ``params`` and ``batch_stats``, in float32."""
    return from_flax(params, batch_stats, model)


def to_flax_vision(model) -> Tuple[dict, dict]:
    """(params, batch_stats) of a vision ``model`` as the flax trees."""
    return to_flax(model)


# ---------------------------------------------------------------------------
# training state
# ---------------------------------------------------------------------------

def _param_leaves(model):
    """[(index in model.parameters(), flax path, layout)]: the order of
    ``TrainState.params`` and of the optimizer's moment lists."""
    index = {name: i for i, (name, _) in enumerate(model.named_parameters())}
    return [(index[key], path, layout)
            for key, coll, path, layout in leaves(model)
            if coll == "params"]


def _moments_to_flat(model, prefix: str, tensors) -> dict:
    return {f"{prefix}/{path}": _to_flax(tensors[i].detach().float(), layout,
                                         model).contiguous().cpu()
            for i, path, layout in _param_leaves(model)}


def _moments_from_flat(model, prefix: str, flat: dict, device):
    params = list(model.parameters())
    out = [None] * len(params)
    for i, path, layout in _param_leaves(model):
        t = _from_flax(_tensor(flat[f"{prefix}/{path}"]).to(device), layout,
                       model)
        if tuple(t.shape) != tuple(params[i].shape):
            raise ValueError(f"{prefix}/{path} of shape {tuple(t.shape)} "
                             f"does not fit {tuple(params[i].shape)}")
        out[i] = t.float().contiguous()
    return out


def state_to_flat(model, state) -> Dict[str, torch.Tensor]:
    """The JAX ``TrainState`` of ``model`` and the port's ``state``
    (``train/loop.py`` TrainState) as a flat dict of CPU tensors keyed
    by flax path: the checkpoint payload."""
    from dtf_tpu_torch.train.optimizer import AdamWState, KerasSGDState

    flat = model_to_flat(model)
    opt = state.opt_state
    if isinstance(opt, AdamWState):
        flat["opt_state/adam/count"] = torch.tensor(opt.count,
                                                    dtype=torch.int32)
        flat.update(_moments_to_flat(model, "opt_state/adam/mu", opt.mu))
        flat.update(_moments_to_flat(model, "opt_state/adam/nu", opt.nu))
    elif isinstance(opt, KerasSGDState):
        flat.update(_moments_to_flat(model, "opt_state/velocity",
                                     opt.velocity))
    else:
        raise ValueError(f"no flax layout for optimizer state "
                         f"{type(opt).__name__}")
    flat["step"] = torch.tensor(state.step, dtype=torch.int32)
    if state.loss_scale is not None:
        flat["loss_scale"] = torch.tensor(state.loss_scale,
                                          dtype=torch.float32)
        flat["good_steps"] = torch.tensor(state.good_steps,
                                          dtype=torch.int32)
    return flat


def state_from_flat(flat: dict, model):
    """Load the flat flax training state ``flat`` (tensors or numpy
    arrays) into ``model`` -- parameters and BN buffers, in place, so
    their tensors stay the ones the optimizer holds -- and return the
    port's TrainState, its moments on the model's device."""
    from dtf_tpu_torch.train.loop import TrainState
    from dtf_tpu_torch.train.optimizer import AdamWState, KerasSGDState

    device = next(model.parameters()).device
    model.load_state_dict(model_from_flat(flat, model, device))
    if "opt_state/adam/count" in flat:
        opt_state = AdamWState(
            count=int(flat["opt_state/adam/count"]),
            mu=_moments_from_flat(model, "opt_state/adam/mu", flat, device),
            nu=_moments_from_flat(model, "opt_state/adam/nu", flat, device))
    elif any(k.startswith("opt_state/velocity/") for k in flat):
        opt_state = KerasSGDState(velocity=_moments_from_flat(
            model, "opt_state/velocity", flat, device))
    else:
        raise ValueError("the state holds neither AdamW nor Keras SGD "
                         "optimizer state")
    scale = flat.get("loss_scale")
    return TrainState(
        step=int(flat["step"]), params=list(model.parameters()),
        opt_state=opt_state,
        loss_scale=None if scale is None else float(scale),
        good_steps=None if scale is None else int(flat["good_steps"]))


def train_state_to_flax(model, state) -> dict:
    """The JAX ``TrainState`` of ``model`` and the port's ``state`` as
    nested numpy dicts (``loss_scale``/``good_steps`` None under static
    scaling)."""
    tree = unflatten(_numpy(state_to_flat(model, state)))
    tree.setdefault("batch_stats", {})
    tree.setdefault("loss_scale", None)
    tree.setdefault("good_steps", None)
    return tree


def train_state_from_flax(tree, model):
    """Load the JAX ``TrainState`` ``tree`` (nested numpy dicts) into
    ``model`` and return the port's TrainState."""
    return state_from_flat(_flat_from_tree(tree), model)


# ---------------------------------------------------------------------------
# the async parameter server's flat wire vector
# ---------------------------------------------------------------------------

class WireLeaf(NamedTuple):
    key: str                 # the parameter's name in the model
    path: str                # its flax path in ``params``
    layout: Optional[str]    # the _to_flax / _from_flax rule
    shape: Tuple[int, ...]   # its flax shape
    offset: int              # where it starts in the flat vector
    size: int


def wire_layout(model) -> List[WireLeaf]:
    """The leaves of ``ravel_pytree(params)[0]`` in order: sorted by
    their flax path's components (``jax.tree_util`` sorts each dict
    level; comparing "/"-joined strings would put "a-b" before "a/c")."""
    params = dict(model.named_parameters())
    rows = sorted(((key, path, layout) for key, coll, path, layout
                   in leaves(model) if coll == "params"),
                  key=lambda r: r[1].split("/"))
    out, offset = [], 0
    for key, path, layout in rows:
        with torch.no_grad():
            shape = tuple(_to_flax(params[key].detach(), layout,
                                   model).shape)
        size = params[key].numel()
        out.append(WireLeaf(key, path, layout, shape, offset, size))
        offset += size
    return out


def to_wire(model, tensors: Optional[dict] = None,
            layout: Optional[List[WireLeaf]] = None,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The flat float32 wire vector of ``model``'s parameters, or of
    ``tensors`` ({parameter name: tensor}, e.g. the gradients), on
    their device; into ``out`` when given."""
    layout = layout or wire_layout(model)
    src = tensors if tensors is not None else dict(
        model.named_parameters())
    if out is None:
        first = src[layout[0].key]
        out = torch.empty(layout[-1].offset + layout[-1].size,
                          dtype=torch.float32, device=first.device)
    with torch.no_grad():
        for leaf in layout:
            # one copy a leaf, its layout change folded in
            out[leaf.offset:leaf.offset + leaf.size].view(leaf.shape).copy_(
                _to_flax(src[leaf.key].detach(), leaf.layout, model))
    return out


def from_wire(flat, model, layout: Optional[List[WireLeaf]] = None) -> None:
    """Write the wire vector ``flat`` (a tensor or a numpy array, on any
    device) into ``model``'s parameters, in place."""
    layout = layout or wire_layout(model)
    params = dict(model.named_parameters())
    if isinstance(flat, np.ndarray) and flat.flags.writeable:
        flat = torch.from_numpy(flat)    # a pulled buffer: no copy
    elif not isinstance(flat, torch.Tensor):
        flat = _tensor(flat)
    total = layout[-1].offset + layout[-1].size if layout else 0
    if flat.numel() != total:
        raise ValueError(f"wire vector of {flat.numel()} floats does not "
                         f"fit the model's {total}")
    # one copy to the parameters' device (asynchronous from a pinned
    # buffer), then each leaf's layout change on that device
    flat = flat.to(next(iter(params.values())).device, non_blocking=True)
    with torch.no_grad():
        for leaf in layout:
            t = flat[leaf.offset:leaf.offset + leaf.size].view(leaf.shape)
            params[leaf.key].copy_(_from_flax(t, leaf.layout, model))
