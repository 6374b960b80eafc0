"""Serving: the multi-port engine (``engine.py``), its macro-cycle port
scheduler (``scheduler.py``), host-side admission (``admission.py``),
open-loop traffic (``traffic.py``) and the fault-injection harness
(``chaos.py``)."""
