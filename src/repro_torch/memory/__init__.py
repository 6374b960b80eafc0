"""The paged multi-port KV pool (``paged_kv.py``)."""
