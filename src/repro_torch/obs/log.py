"""Structured JSON-lines logging, correlated by per-request trace_id.

A print statement cannot be grepped by request, shipped to a collector,
or joined against a flight dump. This module's :class:`StructuredLog`
emits one JSON object per event with a fixed envelope:

    {"ts": <unix wall seconds>, "mono_s": <perf_counter seconds>,
     "level": "info"|"warning"|"error", "event": "serve.slo.breach",
     "trace_id": "lenet/req-42" | null, ...caller fields}

* ``trace_id`` defaults to :func:`obs.current_trace_id` — a log call
  made inside a span inherits the request's id automatically, so a
  breach log, the flight dump that follows it, and the Chrome-trace
  lane for that request all join on one key.
* ``mono_s`` is the same monotonic clock spans use (seconds), so log
  lines can be placed *inside* a dumped timeline.
* Records go to an in-memory bounded deque (``recent()``, served by
  ``/statusz`` debugging) and, when a path is configured, to a
  JSON-lines file via the concurrency-safe :func:`obs.write_jsonl`.

Thread-safe: one lock guards the deque + counters; file appends are
serialized by ``write_jsonl``'s own sink lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from repro_torch.obs.export import write_jsonl
from repro_torch.obs.trace import current_trace_id

LEVELS = ("debug", "info", "warning", "error")


class StructuredLog:
    """A JSON-lines event log with an in-memory tail."""

    def __init__(self, path: Optional[str] = None, keep: int = 256):
        self.path = str(path) if path is not None else None
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=keep)
        self._counts: Dict[str, int] = {lvl: 0 for lvl in LEVELS}

    def log(self, event: str, level: str = "info",
            trace_id: Optional[str] = None, **fields) -> Dict:
        """Record one event; returns the record dict."""
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r}; expected one of "
                             f"{LEVELS}")
        if trace_id is None:
            trace_id = current_trace_id()
        rec = {"ts": time.time(), "mono_s": time.perf_counter(),
               "level": level, "event": event, "trace_id": trace_id}
        rec.update(fields)
        with self._lock:
            self._recent.append(rec)
            self._counts[level] = self._counts[level] + 1
        if self.path is not None:
            write_jsonl(self.path, [rec], append=True)
        return rec

    def info(self, event: str, **fields) -> Dict:
        return self.log(event, level="info", **fields)

    def warning(self, event: str, **fields) -> Dict:
        return self.log(event, level="warning", **fields)

    def error(self, event: str, **fields) -> Dict:
        return self.log(event, level="error", **fields)

    def recent(self, n: Optional[int] = None,
               level: Optional[str] = None) -> List[Dict]:
        """The newest ``n`` records (all retained when ``n`` is None)."""
        with self._lock:
            records = list(self._recent)
        if level is not None:
            records = [r for r in records if r["level"] == level]
        if n is not None:
            records = records[-n:]
        return records

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)
