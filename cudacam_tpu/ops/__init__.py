"""Compute ops: the NumPy golden oracle and the XLA implementation."""
