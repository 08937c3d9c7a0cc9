"""Utilities: logging, file IO, fault injection, the phase timer and the
threefry stream (the port's copies of the JAX package's)."""
