"""Collectives over a process group (data, sequence and tensor
parallelism), ring attention, and the async parameter server."""
