"""Named ranges of the serving path on the profiler's timeline.

``span(name)`` opens a host range named ``name`` while a ``torch.profiler``
profile is recording: the range then lies on the device trace's clock
(Kineto puts CPU ranges and CUPTI activity on one timeline), so a trace
can put each idle stretch of the device under the host phase that caused
it. The range is of the profiler's operator kind, not a user annotation:
Kineto draws a device-side copy of every user annotation, from the first
to the last device operation launched under it, gaps included, and a
reduction of the trace that does not know these names would count that
copy as device work. An operator range has no such copy. With no profile
recording ``span`` returns one shared no-op context and calls nothing in
the profiler, so a span costs a flag check.

The serving engine (``serve/engine.py``) and its pool
(``memory/paged_kv.py``) open these spans, one per phase of a macro-cycle:

- ``engine.retire`` (waiting on the in-flight decode and folding its
  results back), around ``staging.retire`` (the download of the new KV
  words and tokens);
- ``engine.evict``, ``engine.prefill``, ``engine.decode``,
  ``engine.status``: the FSM's four port phases; ``staging.prefill``
  (stage fill, upload, chunk compute and whole-cache download) lies in
  ``engine.prefill``;
- ``engine.schedule``: hazard analysis and the port-mix plan;
- ``engine.commit``: the cycle's pool traversals, each around
  ``staging.pool`` (the host-built port requests and their upload) and
  ``pool.step`` (the pool-step kernel);
- ``engine.dispatch``: the decode launch, around ``staging.decode`` (the
  gathers' download, the stage fill and its upload).
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def _range(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


def span(name: str):
    """A profiler operator range named ``name`` while a profile records,
    else a no-op context."""
    if torch.autograd._profiler_enabled():
        return _range(name)
    return _OFF
