"""Measurement scripts for the port's kernels (run on a card)."""
