"""Pruning, compressed formats and the sparse linear and conv layers."""
