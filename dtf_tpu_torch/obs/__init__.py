"""Metrics registry (counters, gauges, histograms)."""
