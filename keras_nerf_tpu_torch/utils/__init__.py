"""Checkpoint reading and parameter interchange with the JAX package."""
