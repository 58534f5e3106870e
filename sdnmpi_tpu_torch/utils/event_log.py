"""Structured control-plane event log (JSONL).

SURVEY §5 calls for a structured event log alongside the reference's
three observability channels (logging split, Monitor TSV, WebSocket
mirror — reference: logging.ini, sdnmpi/monitor.py:87-88,
sdnmpi/rpc_interface.py:42-72). This module is that fourth channel: a
bus tap serializing EVERY published event to one JSON line — the full
causal record of what the control plane saw and did, greppable and
replayable offline.

Events are dataclasses; fields serialize compactly (entities through
their ``to_dict``, arrays as shape summaries, packets as header
tuples), so an alltoall's block install is one line, not 16.7M.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Optional, TextIO

from sdnmpi_tpu_torch.utils.metrics import REGISTRY

_events_total = REGISTRY.counter(
    "event_log_events_total", "control-plane events written to the JSONL log"
)
_rotations_total = REGISTRY.counter(
    "event_log_rotations_total",
    "event-log rotations (file reached Config.event_log_max_bytes)",
)


def _compact(value: Any) -> Any:
    """JSON-safe, size-bounded rendering of an event field."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if hasattr(value, "to_dict"):
        try:
            return value.to_dict()
        except Exception:
            return repr(value)
    if hasattr(value, "shape"):  # arrays: never inline the data
        return {"shape": list(getattr(value, "shape", [])),
                "dtype": str(getattr(value, "dtype", "?"))}
    if dataclasses.is_dataclass(value):
        return {
            f.name: _compact(getattr(value, f.name))
            for f in dataclasses.fields(value)
        }
    if isinstance(value, bytes):
        return {"bytes": len(value)}
    if isinstance(value, (list, tuple, set)):
        seq = list(value)
        if len(seq) > 16:
            return {"len": len(seq), "head": [_compact(x) for x in seq[:4]]}
        return [_compact(x) for x in seq]
    if isinstance(value, dict):
        if len(value) > 16:
            return {"len": len(value)}
        return {str(k): _compact(v) for k, v in value.items()}
    return repr(value)


class EventLogger:
    """Bus tap writing one JSON line per control-plane event.

    Attach with ``bus.tap(EventLogger(path))`` (the Controller does this
    when ``Config.event_log`` is set). ``close()`` flushes; the file is
    line-buffered so a crash loses at most the current line.

    ``max_bytes`` > 0 caps the file: when a write pushes it past the
    cap, the file rotates to ``<path>.1`` (replacing any previous
    rotation) and a fresh ``<path>`` opens — a long-running controller
    keeps at most ~2x ``max_bytes`` of event history instead of growing
    the JSONL unboundedly. ``n_events`` counts across rotations.
    """

    def __init__(
        self, path: str, clock=time.time, max_bytes: int = 0
    ) -> None:
        self.path = path
        self.clock = clock
        self.max_bytes = int(max_bytes)
        self._fh: Optional[TextIO] = open(path, "a", buffering=1)
        self._size = self._fh.tell()
        self.n_events = 0
        self.n_rotations = 0

    def __call__(self, event) -> None:
        if self._fh is None:
            return
        record = {"t": round(self.clock(), 6), "event": type(event).__name__}
        if dataclasses.is_dataclass(event):
            for f in dataclasses.fields(event):
                record[f.name] = _compact(getattr(event, f.name))
        line = json.dumps(record) + "\n"
        self._fh.write(line)
        self._size += len(line)
        self.n_events += 1
        _events_total.inc()
        if self.max_bytes > 0 and self._size >= self.max_bytes:
            self._rotate()

    def _rotate(self) -> None:
        """Move the full file to ``<path>.1`` and reopen fresh. One
        rotation slot is deliberate: the log is a flight recorder, not
        an archive — the current plus previous windows bound disk use
        while keeping at least ``max_bytes`` of trailing history."""
        self._fh.close()
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a", buffering=1)
        self._size = 0
        self.n_rotations += 1
        _rotations_total.inc()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
