"""Sharding geometry of the paged KV pool, and the liveness helpers
(heartbeats, straggler detection) the chaos harness wires in."""
