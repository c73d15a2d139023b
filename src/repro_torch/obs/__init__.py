"""Unified telemetry layer, port of ``repro.obs``.

Three small pieces, composable and individually optional:

  * recorder -- the MetricsRecorder protocol and its three sinks
    (NullRecorder / InMemoryRecorder / JsonlRecorder).  Engines take a
    recorder at construction; ``recorder.active`` is a *static* property,
    read once.
  * schema -- the versioned event envelope and the validators, the
    reference's (``SCHEMA_VERSION`` 1): a run written by either package
    validates under the other.
  * trace -- monotonic-clock spans (contextmanager + decorator) with an
    optional ``torch.profiler.record_function`` range per span, so profiler
    traces and JSONL phase timings share one naming scheme.

The reader/CLI toolchain lives in reader.py and runs as
``python -m repro_torch.obs summarize|tail|compare|validate <run_dir>``.

This package imports nothing from repro_torch.fed / repro_torch.core --
observability sits *below* the layers it instruments.
"""

from repro_torch.obs.recorder import (
    NULL_RECORDER,
    InMemoryRecorder,
    JsonlRecorder,
    MetricsRecorder,
    NullRecorder,
)
from repro_torch.obs.schema import SCHEMA_VERSION, validate_event, validate_meta
from repro_torch.obs.trace import SpanCollector, span, traced

__all__ = [
    "MetricsRecorder",
    "NullRecorder",
    "InMemoryRecorder",
    "JsonlRecorder",
    "NULL_RECORDER",
    "SCHEMA_VERSION",
    "validate_event",
    "validate_meta",
    "SpanCollector",
    "span",
    "traced",
]
