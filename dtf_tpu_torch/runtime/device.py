"""Device selection for the port's entry points.

Every entry point takes an explicit device and goes through
:func:`resolve_device`: asking for CUDA where there is none raises --
the port never falls back to the CPU on its own, since a run that
silently measured the CPU would report numbers under the card's name.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"`` -> a torch.device.

    For CUDA it also turns TF32 off for float32 matrix products and
    convolutions: TF32 keeps about three decimal digits, and the port's
    float32 path is held to the JAX reference at 1e-5 (kernels) and
    1e-4 (logits).  bf16 runs are unaffected."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available; "
                f"pass --device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}; use cuda or cpu")
    return dev
