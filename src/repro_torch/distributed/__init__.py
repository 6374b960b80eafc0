"""Sharding geometry of the paged KV pool."""
