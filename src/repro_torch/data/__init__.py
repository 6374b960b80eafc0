"""Deterministic synthetic data: batches as pure functions of (seed, step)."""
