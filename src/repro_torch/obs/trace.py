"""Thread-safe tracing: spans, instant events, Chrome-trace export.

The serving claims are rates (frames/s at saturation), but a rate does
not say where a frame's time goes: plan-cache miss, the eager run that
precedes a graph capture, batcher hold-open, device, result split. This
module records that decomposition:

    with obs.span("plan.compile", attrs={"model": "lenet"}):
        ...                                  # nested spans parent here
    obs.event("plan.cache.miss")             # zero-duration instant

* **Off by default** — ``span()``/``event()`` first check a module-level
  collector reference and the flight recorder; with neither installed
  they return a shared no-op immediately (no allocation, no lock).
* **Monotonic clock** — every timestamp is ``time.perf_counter_ns()``
  (the clock ``serve.Clock.now()`` reads, in seconds), so spans recorded
  from serving timestamps line up exactly.
* **Nested parenting** — spans opened on one thread stack up in a
  thread-local; a child records its parent's id. Spans on one ``tid``
  therefore always nest and never interleave.
* **Cross-thread request timelines** — a request's life crosses three
  threads (submitter → scheduler → completer). The serving runtime
  stitches it back together with :meth:`Trace.add_span` (explicit begin/
  end timestamps, explicit ``trace_id``, a synthetic per-request lane
  ``tid``), so one request's queue-wait → batch-assembly → device →
  split spans reassemble into one timeline in the exported trace.
* **Chrome-trace export** — :meth:`Trace.export` writes the Trace Event
  Format JSON that ``chrome://tracing`` and Perfetto open directly, in
  the reference package's schema (``scripts/check_trace.py`` reads both).

The port reads no environment variable: the ambient trace mode is
``auto``, and ``Options(trace=)`` / :func:`use_mode` pin it per thread.
Tracing never touches a tensor: every hook is read-only observation
built from Python ints and host timestamps.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

TRACE_MODES = ("auto", "on", "off")

_TID_META_PID = 1          # chrome-trace process id (single-process runtime)


def now_ns() -> int:
    """The one trace clock: monotonic nanoseconds (``perf_counter_ns``)."""
    return time.perf_counter_ns()


class Trace:
    """A thread-safe collection of finished spans and instant events.

    Spans/events are plain dicts (JSON-able as recorded):

        {"name", "ph": "X"|"i", "t0_ns", "t1_ns", "tid", "id",
         "parent", "trace_id", "attrs"}
    """

    def __init__(self, name: str = "repro"):
        self.name = name
        self._lock = threading.Lock()
        self._records: List[Dict] = []
        self._next_id = 1
        self._lanes: Dict[object, int] = {}      # synthetic tid -> lane name
        self.t0_ns = now_ns()

    # -- recording ---------------------------------------------------------

    def add_span(self, name: str, t0_ns: int, t1_ns: int,
                 attrs: Optional[Dict] = None, trace_id: Optional[str] = None,
                 tid: Optional[int] = None, parent: Optional[int] = None,
                 lane: Optional[str] = None) -> int:
        """Record a finished span with explicit timestamps.

        ``tid`` defaults to the calling thread; pass a synthetic lane id
        (+ a human ``lane`` name) to place retrospective spans — e.g. a
        request's queue-wait reconstructed after the fact — on their own
        timeline row instead of overlapping the recording thread's live
        spans.
        """
        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            if lane is not None:
                self._lanes[tid] = lane
            self._records.append({
                "name": name, "ph": "X", "t0_ns": int(t0_ns),
                "t1_ns": int(t1_ns), "tid": tid, "id": sid,
                "parent": parent, "trace_id": trace_id,
                "attrs": dict(attrs) if attrs else {}})
        return sid

    def add_event(self, name: str, t_ns: Optional[int] = None,
                  attrs: Optional[Dict] = None,
                  trace_id: Optional[str] = None,
                  tid: Optional[int] = None) -> None:
        """Record an instant event."""
        if t_ns is None:
            t_ns = now_ns()
        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            self._records.append({
                "name": name, "ph": "i", "t0_ns": int(t_ns),
                "t1_ns": int(t_ns), "tid": tid, "id": self._next_id,
                "parent": None, "trace_id": trace_id,
                "attrs": dict(attrs) if attrs else {}})
            self._next_id += 1

    # -- reading -----------------------------------------------------------

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._records)

    def spans(self, name: Optional[str] = None) -> List[Dict]:
        return [r for r in self.records()
                if r["ph"] == "X" and (name is None or r["name"] == name)]

    def events(self, name: Optional[str] = None) -> List[Dict]:
        return [r for r in self.records()
                if r["ph"] == "i" and (name is None or r["name"] == name)]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name {count, total_ms} rollup (the stats table rows)."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.records():
            if r["ph"] != "X":
                continue
            e = out.setdefault(r["name"], {"count": 0, "total_ms": 0.0})
            e["count"] += 1
            e["total_ms"] += (r["t1_ns"] - r["t0_ns"]) / 1e6
        return out

    # -- export ------------------------------------------------------------

    def to_chrome(self) -> Dict:
        """Chrome Trace Event Format (``chrome://tracing`` / Perfetto).

        Durations use complete ("X") events with microsecond timestamps
        relative to the trace epoch; instants are "i" events; synthetic
        request lanes get ``thread_name`` metadata so the viewer labels
        each request's row with its ``trace_id``.
        """
        events = []
        with self._lock:
            records = list(self._records)
            lanes = dict(self._lanes)
        for tid, lane in sorted(lanes.items(), key=lambda kv: kv[0]):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": _TID_META_PID, "tid": tid,
                           "args": {"name": lane}})
        for r in records:
            args = dict(r["attrs"])
            if r["trace_id"] is not None:
                args["trace_id"] = r["trace_id"]
            ev = {"name": r["name"], "ph": r["ph"],
                  "cat": r["name"].split(".", 1)[0],
                  "pid": _TID_META_PID, "tid": r["tid"],
                  "ts": (r["t0_ns"] - self.t0_ns) / 1e3, "args": args}
            if r["ph"] == "X":
                ev["dur"] = (r["t1_ns"] - r["t0_ns"]) / 1e3
            else:
                ev["s"] = "t"                      # instant scope: thread
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"trace": self.name}}

    def export(self, path) -> str:
        """Write the Chrome-trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return str(path)


# ---------------------------------------------------------------------------
# Module-level collector + the no-op fast path
# ---------------------------------------------------------------------------

_active: Optional[Trace] = None
_active_lock = threading.Lock()
_tls = threading.local()           # .stack (open spans), .mode, .trace_id

# The process flight recorder (obs.flight.FlightRecorder), if installed.
# Managed by obs.flight.install/uninstall; read here on the hot path so
# span()/event()/span_at() feed the always-on black box even when the
# Options(trace=) tri-state has recording off.
_flight = None


def enable(trace: Optional[Trace] = None) -> Trace:
    """Install ``trace`` (or a fresh one) as the process collector."""
    global _active
    with _active_lock:
        _active = trace if trace is not None else Trace()
        return _active


def disable() -> Optional[Trace]:
    """Remove the collector; returns it (for export) or None."""
    global _active
    with _active_lock:
        trace, _active = _active, None
        return trace


def get_trace() -> Optional[Trace]:
    """The active collector, if any."""
    return _active


def trace_mode() -> str:
    """The ambient trace mode: always ``auto`` (no environment variable is
    read; pin a mode per thread with :func:`use_mode`)."""
    return "auto"


class _UseMode:
    """Per-thread trace-mode pin (what ``Options(trace=...)`` maps to).

    ``off`` suppresses recording on this thread even while a collector is
    installed; ``on`` forces recording (installing a collector if none);
    ``auto`` follows the collector. Re-entrant; restores on exit.
    """

    __slots__ = ("mode", "_prev")

    def __init__(self, mode: str):
        if mode not in TRACE_MODES:
            raise ValueError(f"unknown trace mode {mode!r}; expected one of "
                             f"{TRACE_MODES}")
        self.mode = mode

    def __enter__(self):
        self._prev = getattr(_tls, "mode", None)
        _tls.mode = self.mode
        return self

    def __exit__(self, *exc):
        _tls.mode = self._prev


def use_mode(mode: str) -> _UseMode:
    """Context manager pinning the trace mode for the current thread."""
    return _UseMode(mode)


def enabled() -> bool:
    """Is recording active for this thread? (The one hot-path check.)

    Resolution: the thread-local ``use_mode`` pin, else ``auto`` =
    record iff a collector is installed. ``on`` lazily installs a
    collector so forced spans are never lost.
    """
    mode = getattr(_tls, "mode", None)
    if mode is None:
        return _active is not None           # the common fast path
    if mode == "off":
        return False
    if mode == "on":
        if _active is None:
            enable()
        return True
    return _active is not None


def recording() -> bool:
    """Is *any* sink live — the trace collector or the flight recorder?

    Guard call sites that build attrs dicts / timestamps with this (not
    :func:`enabled`) so the always-on flight recorder still captures
    serving history while ``Options(trace=)`` is off. :func:`enabled`
    keeps governing the export-on-demand :class:`Trace` collector only.
    """
    return _flight is not None or enabled()


def current_trace_id() -> Optional[str]:
    """The thread's inherited trace id (set by an enclosing span)."""
    return getattr(_tls, "trace_id", None)


class _NullSpan:
    """The shared disabled-path span: enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span: records into the collector and/or flight on exit.

    ``to_trace`` is resolved at ``span()`` time (the :func:`enabled`
    tri-state); the flight recorder is consulted again on exit so a
    recorder installed mid-span still sees the record.
    """

    __slots__ = ("name", "attrs", "trace_id", "to_trace", "_t0",
                 "_prev_trace_id", "_parent")

    def __init__(self, name: str, attrs: Optional[Dict],
                 trace_id: Optional[str], to_trace: bool = True):
        self.name = name
        self.attrs = attrs
        self.trace_id = trace_id
        self.to_trace = to_trace

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._parent = stack[-1][1] if stack else None
        self._prev_trace_id = getattr(_tls, "trace_id", None)
        if self.trace_id is None:
            self.trace_id = self._prev_trace_id
        else:
            _tls.trace_id = self.trace_id
        # reserve the span id up front so children opened inside can
        # point at it; the record itself lands on exit
        trace = _active if self.to_trace else None
        sid = None
        if trace is not None:
            with trace._lock:
                sid = trace._next_id
                trace._next_id += 1
        stack.append((self, sid))
        self._t0 = now_ns()
        return self

    def __exit__(self, *exc):
        t1 = now_ns()
        stack = _tls.stack
        _, sid = stack.pop()
        _tls.trace_id = self._prev_trace_id
        trace = _active if self.to_trace else None
        if trace is not None and sid is not None:
            with trace._lock:
                trace._records.append({
                    "name": self.name, "ph": "X", "t0_ns": self._t0,
                    "t1_ns": t1, "tid": threading.get_ident(), "id": sid,
                    "parent": self._parent, "trace_id": self.trace_id,
                    "attrs": dict(self.attrs) if self.attrs else {}})
        flight = _flight
        if flight is not None:
            flight.record_span(self.name, self._t0, t1,
                               trace_id=self.trace_id, attrs=self.attrs)
        return False


def span(name: str, attrs: Optional[Dict] = None,
         trace_id: Optional[str] = None):
    """Open a span context manager; a shared no-op when nothing records.

    The span feeds the :class:`Trace` collector when :func:`enabled`
    says so, and *always* feeds the flight recorder when one is
    installed — black-box capture ignores the trace tri-state.
    """
    to_trace = enabled()
    if not to_trace and _flight is None:
        return _NULL_SPAN
    return _Span(name, attrs, trace_id, to_trace=to_trace)


def event(name: str, attrs: Optional[Dict] = None,
          trace_id: Optional[str] = None) -> None:
    """Record an instant event; no-op when nothing records."""
    to_trace = enabled()
    flight = _flight
    if not to_trace and flight is None:
        return
    if trace_id is None:
        trace_id = getattr(_tls, "trace_id", None)
    trace = _active if to_trace else None
    if trace is not None:
        trace.add_event(name, attrs=attrs, trace_id=trace_id)
    if flight is not None:
        flight.record_event(name, trace_id=trace_id, attrs=attrs)


def span_at(name: str, t0_s: float, t1_s: float,
            attrs: Optional[Dict] = None, trace_id: Optional[str] = None,
            lane_tid: Optional[int] = None,
            lane: Optional[str] = None) -> None:
    """Record a retrospective span from ``perf_counter()`` *seconds*.

    The serving runtime's request timelines use this: timestamps were
    taken with the server's ``Clock.now()`` (the same monotonic clock, in
    seconds) on whatever thread held the request at the time, and the
    span is stitched in afterwards on a synthetic per-request lane.
    """
    to_trace = enabled()
    flight = _flight
    if not to_trace and flight is None:
        return
    t0_ns, t1_ns = int(t0_s * 1e9), int(t1_s * 1e9)
    trace = _active if to_trace else None
    if trace is not None:
        trace.add_span(name, t0_ns, t1_ns, attrs=attrs,
                       trace_id=trace_id, tid=lane_tid, lane=lane)
    if flight is not None:
        flight.record_span(name, t0_ns, t1_ns, trace_id=trace_id,
                           attrs=attrs, lane_tid=lane_tid, lane=lane)
