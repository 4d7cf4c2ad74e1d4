"""Observability: the metrics registry (``registry``), structured JSONL
tracing (``trace``, vocabulary in ``vocab``), the training loop's
watchdogs and the launcher heartbeat (``watchdog``), the MFU/cost
ledger (``ledger``) and the Prometheus endpoint (``prom``).  Pure
Python; each submodule is imported where it is used, so importing one
costs no torch import (``ledger`` imports torch only to count)."""
