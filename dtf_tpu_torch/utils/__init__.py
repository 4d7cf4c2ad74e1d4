"""Benchmark logging."""
