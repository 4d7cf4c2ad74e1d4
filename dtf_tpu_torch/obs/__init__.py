"""Observability: the metrics registry (``registry``), structured JSONL
tracing (``trace``, vocabulary in ``vocab``) and the training loop's
watchdogs and launcher heartbeat (``watchdog``).  Pure Python; each
submodule is imported where it is used, so importing one costs no
torch import."""
