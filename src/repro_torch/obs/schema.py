"""Versioned event schema for run logs, port of ``repro.obs.schema`` (the
same version, envelope, kinds and validators, so a run written by either
package validates under the other).

Every line of ``events.jsonl`` is one JSON object -- the *envelope* plus the
event's payload merged flat:

    {"v": 1, "kind": "round", "seq": 0, "t": 12.034, ...payload...}

  v     int    SCHEMA_VERSION the writer spoke
  kind  str    event type (see KIND_REQUIRED for the known kinds)
  seq   int    0-based monotone sequence number within the run
  t     float  seconds since the recorder was opened (monotonic clock)

Known kinds and their required payload fields:

  round   per-round record from the federated engine -- requires
          round / cohort / participating; everything else (nmse, wire bytes,
          gamp health, buffer stats, phase_ms, ...) is optional so the
          schema survives engines that don't compute a given counter.
  span    one timed phase -- requires name / ms.
  eval    an evaluation snapshot (accuracy, loss) -- requires round.
  note    freeform annotation -- no required fields.

Readers must ignore unknown payload fields (writers may add counters
without a version bump); unknown *kinds* are skipped with a warning.  The
version bumps only when an envelope field or a required payload field
changes meaning.

``meta.json`` (one per run directory) requires run_id / schema_version /
created_unix; the writer also records config, git SHA, and the runtime it
ran on (the reference: jax/jaxlib versions and backend; the port: torch and
CUDA versions, backend, device name and count).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping

__all__ = [
    "SCHEMA_VERSION",
    "ENVELOPE_FIELDS",
    "KIND_REQUIRED",
    "META_REQUIRED",
    "validate_event",
    "validate_meta",
    "validate_run",
]

SCHEMA_VERSION = 1

ENVELOPE_FIELDS = ("v", "kind", "seq", "t")

# kind -> payload fields that must be present (beyond the envelope)
KIND_REQUIRED: Dict[str, tuple] = {
    "round": ("round", "cohort", "participating"),
    "span": ("name", "ms"),
    "eval": ("round",),
    "note": (),
}

META_REQUIRED = ("run_id", "schema_version", "created_unix")


def validate_event(event: Mapping[str, Any]) -> List[str]:
    """Returns a list of problems (empty == valid).

    Unknown payload fields never fail validation; unknown kinds do, since a
    reader can't know their required fields."""
    problems: List[str] = []
    for f in ENVELOPE_FIELDS:
        if f not in event:
            problems.append(f"missing envelope field {f!r}")
    if problems:
        return problems
    if event["v"] != SCHEMA_VERSION:
        problems.append(f"schema version {event['v']!r} != {SCHEMA_VERSION}")
    kind = event["kind"]
    if kind not in KIND_REQUIRED:
        problems.append(f"unknown kind {kind!r}")
        return problems
    for f in KIND_REQUIRED[kind]:
        if f not in event:
            problems.append(f"kind {kind!r} missing required field {f!r}")
    if not isinstance(event["seq"], int) or event["seq"] < 0:
        problems.append(f"seq must be a non-negative int, got {event['seq']!r}")
    return problems


def validate_meta(meta: Mapping[str, Any]) -> List[str]:
    problems = [f"missing meta field {f!r}" for f in META_REQUIRED if f not in meta]
    if not problems and meta["schema_version"] != SCHEMA_VERSION:
        problems.append(
            f"meta schema_version {meta['schema_version']!r} != {SCHEMA_VERSION}"
        )
    return problems


def validate_run(meta: Mapping[str, Any], events: Iterable[Mapping[str, Any]]):
    """Validates a whole run: meta, every event, and seq monotonicity."""
    problems = [f"meta: {p}" for p in validate_meta(meta)]
    prev = -1
    for i, ev in enumerate(events):
        for p in validate_event(ev):
            problems.append(f"event {i}: {p}")
        seq = ev.get("seq")
        if isinstance(seq, int):
            if seq <= prev:
                problems.append(f"event {i}: seq {seq} not monotone (prev {prev})")
            prev = seq
    return problems
