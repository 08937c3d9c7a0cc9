"""Logging helpers (copied from the JAX package)."""
