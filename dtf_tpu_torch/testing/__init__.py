"""Test helpers for code that drives the port's entry points."""
