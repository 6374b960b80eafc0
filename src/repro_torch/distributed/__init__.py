"""Sharding geometry of the paged KV pool, the liveness helpers
(heartbeats, straggler detection, failure injection) the chaos harness and
the training runner wire in, and the int8 error-feedback gradient mean."""
