"""Collectives over a process group (data parallelism)."""
