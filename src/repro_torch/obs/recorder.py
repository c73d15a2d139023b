"""MetricsRecorder protocol and its sinks, port of ``repro.obs.recorder``.

Contract with the engines:

  * ``recorder.active`` is read ONCE, at engine construction, and treated as
    static: an active recorder makes the engine compute the decode-health
    auxiliaries and block at the end of each timed phase; the null recorder
    costs nothing on the hot path (no auxiliaries, no device syncs, and
    ``record`` is a constant no-op).
  * ``record(kind, payload)`` is called on the HOST, at round boundaries,
    with plain-Python payloads (floats/ints/strs/lists); 0-d tensors and
    numpy scalars are coerced.  Callers pull device values before recording.
  * ``close()`` is idempotent; JsonlRecorder flushes per event so a crashed
    run still leaves a readable prefix.

Sinks:

  NullRecorder      active=False; every method a no-op.  Module singleton
                    NULL_RECORDER is the default everywhere.
  InMemoryRecorder  active=True; keeps the enveloped events in ``.events``
                    (tests, notebooks).
  JsonlRecorder     active=True; appends one JSON line per event to
                    ``<run_dir>/events.jsonl`` and writes ``meta.json``
                    (run id, schema version, config, git SHA, the torch and
                    CUDA versions, backend, device name and count) at
                    construction.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
import uuid
from typing import Any, Dict, List, Mapping, Optional, Protocol, runtime_checkable

from repro_torch.obs.schema import SCHEMA_VERSION

__all__ = [
    "MetricsRecorder",
    "NullRecorder",
    "InMemoryRecorder",
    "JsonlRecorder",
    "NULL_RECORDER",
]


@runtime_checkable
class MetricsRecorder(Protocol):
    """Anything with a static ``active`` flag and a host-side ``record``."""

    @property
    def active(self) -> bool: ...

    def record(self, kind: str, payload: Mapping[str, Any]) -> None: ...

    def close(self) -> None: ...


class NullRecorder:
    """The do-nothing sink; ``active`` is False so engines skip aux work."""

    active = False

    def record(self, kind: str, payload: Mapping[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


NULL_RECORDER = NullRecorder()


def _jsonable(v: Any) -> Any:
    """Coerces numpy scalars, tensors and arrays into JSON-native values."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, Mapping):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 1) == 0:
        return item()
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return tolist()
    return str(v)


class _EnvelopingRecorder:
    """Shared envelope logic: v / kind / seq / t stamped on every event."""

    active = True

    def __init__(self) -> None:
        self._seq = 0
        self._t0 = time.monotonic()

    def _envelope(self, kind: str, payload: Mapping[str, Any]) -> Dict[str, Any]:
        ev = {
            "v": SCHEMA_VERSION,
            "kind": kind,
            "seq": self._seq,
            "t": round(time.monotonic() - self._t0, 6),
        }
        for k, v in payload.items():
            if k not in ev:  # payload may not shadow the envelope
                ev[k] = _jsonable(v)
        self._seq += 1
        return ev


class InMemoryRecorder(_EnvelopingRecorder):
    """Keeps enveloped events in a list -- tests and notebooks."""

    def __init__(self) -> None:
        super().__init__()
        self.events: List[Dict[str, Any]] = []

    def record(self, kind: str, payload: Mapping[str, Any]) -> None:
        self.events.append(self._envelope(kind, payload))

    def close(self) -> None:
        pass


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def _runtime_meta() -> Dict[str, Any]:
    """The runtime the run wrote from: torch and CUDA versions, the backend
    (``cuda`` when a card is visible, else ``cpu``), and the card's name and
    count (None without one)."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
    }


class JsonlRecorder(_EnvelopingRecorder):
    """Appends events to ``<run_dir>/events.jsonl``; meta.json at open.

    ``run_dir`` is created (parents included).  ``config`` is any
    JSON-able mapping describing the run (typically dataclass asdict()s);
    ``extra`` merges additional top-level meta fields.
    """

    def __init__(
        self,
        run_dir: str,
        config: Optional[Mapping[str, Any]] = None,
        extra: Optional[Mapping[str, Any]] = None,
    ) -> None:
        super().__init__()
        self.run_dir = str(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.run_id = os.path.basename(os.path.normpath(self.run_dir)) or uuid.uuid4().hex[:12]
        meta: Dict[str, Any] = {
            "run_id": self.run_id,
            "schema_version": SCHEMA_VERSION,
            "created_unix": time.time(),
            "git_sha": _git_sha(),
            **_runtime_meta(),
        }
        if config is not None:
            meta["config"] = _jsonable(config)
        if extra:
            meta.update({str(k): _jsonable(v) for k, v in extra.items()})
        with open(os.path.join(self.run_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
            f.write("\n")
        self._fh = open(os.path.join(self.run_dir, "events.jsonl"), "a")

    def record(self, kind: str, payload: Mapping[str, Any]) -> None:
        if self._fh is None:
            raise ValueError("record() after close()")
        self._fh.write(json.dumps(self._envelope(kind, payload)) + "\n")
        self._fh.flush()  # crashed runs keep a readable prefix

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
