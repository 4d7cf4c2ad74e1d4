"""Synthetic-data smoke harness -- ``integration.run_synthetic``, the
PyTorch counterpart of ``dtf_tpu/testing/integration.py``.

The reference's end-to-end tests funnel through
``run_synthetic(main, extra_flags)``: parse the extra flags, force the
synthetic data backend, call the real ``run()``, and count "did not
crash" as the assertion.  The same contract over the port's flags,
strategy flags and the ``DTF_*`` topology included (``parse_flags``
applies them), so a rank started by ``cli/launch.py`` joins its group.
Checkpoints are off, as in the JAX helper: smoke cells leave nothing
behind.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from dtf_tpu_torch.config import Config, parse_flags


def run_synthetic(main: Callable[[Config], dict],
                  extra_flags: Optional[Sequence[str]] = None,
                  synth: bool = True,
                  defaults: Optional[dict] = None) -> dict:
    """Run ``main`` (a ``run(cfg) -> stats`` callable) with synthetic
    data (unless ``synth=False``) and the given extra CLI flags over
    ``defaults`` (an entry point's, e.g. ``CIFAR_DEFAULTS``); returns
    the stats dict."""
    argv = list(extra_flags or [])
    if synth:
        argv += ["--use_synthetic_data", "true"]
    base = dict(skip_checkpoint=True, model_dir="")
    base.update(defaults or {})
    return main(parse_flags(argv, defaults=base))
