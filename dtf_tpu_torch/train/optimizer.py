"""Optimizers -- the PyTorch counterpart of ``dtf_tpu/train/optimizer.py``.

Each optimizer is an ``(init, update)`` pair over a list of parameters,
the contract of the JAX package's optax transformations:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step=step)
    apply_updates(params, updates)

``step`` is the caller's global step (``TrainState.step``); the learning
rate is ``schedule(step)``, read before the step counts up.  State is
float32 whatever the parameters' dtype, and ``update`` returns new
tensors: the caller decides whether to apply them (dynamic loss scaling
skips a step by keeping the old parameters and state).

``keras_sgd`` is the reference's optimizer, Keras momentum:

    v_t = momentum * v_{t-1} - lr_t * g_t;   w_t = w_{t-1} + v_t

which differs from the trace form ``w -= lr * (g + m * trace)`` whenever
the LR changes between steps.  ``adamw`` is the transformer recipe:
optax ``scale_by_adam`` (b1 0.9, b2 0.95, eps 1e-8 added outside the
square root, bias correction by the 1-based count) followed by
``-lr * (u + 0.1 * p)`` on every parameter, with no mask.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


class KerasSGDState(NamedTuple):
    velocity: List[torch.Tensor]


class AdamWState(NamedTuple):
    count: int                      # updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def _zeros_f32(params):
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def keras_sgd(learning_rate: Callable, momentum: float = 0.9) -> Optimizer:
    """SGD with Keras-style momentum; ``learning_rate`` is fn(step)."""

    def init(params):
        return KerasSGDState(velocity=_zeros_f32(params))

    def update(grads, state, params=None, *, step):
        lr = float(learning_rate(step))
        velocity = [momentum * v - lr * g.float()
                    for v, g in zip(state.velocity, grads)]
        return velocity, KerasSGDState(velocity=velocity)

    return Optimizer(init, update)


def adamw(learning_rate: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    """AdamW with decoupled weight decay and a step-dependent LR."""

    def init(params):
        return AdamWState(count=0, mu=_zeros_f32(params),
                          nu=_zeros_f32(params))

    def update(grads, state, params=None, *, step):
        count = state.count + 1
        mu = [(1 - b1) * g.float() + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * g.float().square() + b2 * v
              for g, v in zip(grads, state.nu)]
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        lr = float(learning_rate(step))
        updates = [
            (-lr * ((m / bc1) / ((v / bc2).sqrt() + eps)
                    + weight_decay * p.float())).to(p.dtype)
            for m, v, p in zip(mu, nu, params)]
        return updates, AdamWState(count=count, mu=mu, nu=nu)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """p += u, in place (the parameters are the model's own tensors)."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))


def build_optimizer(name: str, learning_rate: Callable,
                    momentum: float = 0.9) -> Optimizer:
    if name in ("sgd", "momentum"):
        return keras_sgd(learning_rate, momentum)
    if name == "adamw":
        return adamw(learning_rate)
    raise ValueError(f"unknown optimizer {name!r}")
