"""Serving: the multi-port engine (``engine.py``), its macro-cycle port
scheduler (``scheduler.py``) and host-side admission (``admission.py``)."""
