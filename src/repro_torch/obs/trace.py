"""Monotonic-clock spans with one naming scheme for JSONL and profiler, port
of ``repro.obs.trace``.

The federated engine wraps each round phase in a span::

    spans = SpanCollector()
    with span("client_pass", spans):
        ...
    spans.ms  # {"client_pass": 12.3, ...}

Span names are the phase vocabulary shared by the ``phase_ms`` field of
round events, the ``span`` event kind, and (when enabled) the
``torch.profiler.record_function`` ranges -- a profile and a run log line up
by construction.  Canonical engine phase names: ``client_pass``,
``encode``, ``uplink``, ``fold``, ``decode``, ``apply``; plus the
SUB-phases of the reference's streamed client pass, ``backward`` and
``encode_overlap``, which nest inside ``client_pass``, so aggregations that
sum phases exclude :data:`SUB_PHASES`.

Overhead: with ``collector=None`` and annotations off, ``span`` is two
``time.monotonic()`` calls -- cheap enough to leave in place permanently.
Profiler ranges engage only when REPRO_TRACE_ANNOTATIONS=1 is set in the
environment (read once, at import, into :data:`ANNOTATE`), so the default
path never touches the profiler.

Timing caveat: spans measure host wall-clock.  CUDA launches return before
the device finishes, so a span around device work measures the enqueue
unless the caller synchronises; the engine synchronises at the end of each
phase when its recorder is active, which lands each phase's device time in
its own span.
"""

from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager
from typing import Dict, Optional

__all__ = ["SpanCollector", "span", "traced", "ANNOTATE", "SUB_PHASES"]

# Read once at import: profiler ranges are opt-in by environment.
ANNOTATE = os.environ.get("REPRO_TRACE_ANNOTATIONS", "") == "1"

# Phases that time a slice of another phase (they nest inside client_pass):
# excluded when summing phase_ms into a round total.
SUB_PHASES = frozenset({"backward", "encode_overlap"})


class SpanCollector:
    """Accumulates span durations by name (ms, summed over re-entries)."""

    def __init__(self) -> None:
        self.ms: Dict[str, float] = {}

    def add(self, name: str, ms: float) -> None:
        self.ms[name] = self.ms.get(name, 0.0) + ms

    def drain(self) -> Dict[str, float]:
        """Returns the accumulated timings and resets the collector."""
        out, self.ms = self.ms, {}
        return out


@contextmanager
def span(name: str, collector: Optional[SpanCollector] = None):
    """Times a block; records into ``collector`` (None = annotation only).
    With :data:`ANNOTATE`, the block also runs inside a
    ``torch.profiler.record_function(name)`` range."""
    if ANNOTATE:
        from torch.profiler import record_function

        with record_function(name):
            t0 = time.monotonic()
            try:
                yield
            finally:
                if collector is not None:
                    collector.add(name, (time.monotonic() - t0) * 1e3)
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        if collector is not None:
            collector.add(name, (time.monotonic() - t0) * 1e3)


def traced(name: Optional[str] = None, collector: Optional[SpanCollector] = None):
    """Decorator form of :func:`span`; name defaults to the function name."""

    def wrap(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(label, collector):
                return fn(*args, **kwargs)

        return inner

    return wrap
