"""Checkpoints: manifest-verified, atomic, async; the JAX package's layout."""
