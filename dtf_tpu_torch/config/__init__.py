"""Run configuration and CLI flags."""

from dtf_tpu_torch.config.flags import Config, parse_flags  # noqa: F401
