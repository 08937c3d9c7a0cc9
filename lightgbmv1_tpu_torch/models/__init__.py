"""Host trees, the serving engine and the weight carry-over from the JAX package."""
