"""Always-on flight recorder: fixed-size per-thread span/event rings.

The :class:`~repro_torch.obs.trace.Trace` collector is export-on-demand:
a timeline exists only if the operator installed it *before* the
anomaly. This module keeps the last N records per thread in a
preallocated ring buffer that records **even when tracing is off**, so
:meth:`FlightRecorder.dump` reconstructs the final moments before a
trigger (SLO breach, ``WorkerError``, stop-timeout stranding) as the
Chrome-trace JSON that ``scripts/check_trace.py --flight`` validates.

Design constraints, in order:

* **No allocation on the hot path.** Every ring slot is a fixed-shape
  list preallocated at ring creation; ``put`` mutates the slot fields in
  place under a per-ring lock: one lock, nine list stores and two
  integer adds per record.
* **Overwrite-oldest.** The ring wraps; a monotonically increasing
  per-ring ``seq`` stamps every record so a dump can prove the retained
  history is gap-free (``check_trace.py --flight`` checks seq
  contiguity per ring).
* **Per-thread rings.** One ring per recording OS thread: no
  cross-thread contention on the hot path. Rings are registered by
  thread id; a thread-local caches the calling thread's ring so the
  registry lock is only taken on first use per thread.
* **Host memory only.** A record holds names, ints and the caller's
  attrs dict; a dump touches no tensor, so it works after a sticky CUDA
  error has made every device call fail.

Installation is process-global (``install()`` / ``uninstall()``), and
``repro_torch.obs`` installs a default recorder of
:data:`DEFAULT_CAPACITY` slots per thread at import. No environment
variable is read: ``uninstall()`` turns it off and
``install(FlightRecorder(capacity=...))`` resizes it.
``obs.span``/``obs.event``/``obs.span_at`` feed the recorder from
``trace.py`` whenever one is installed, independent of the
``Options(trace=)`` tri-state.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from repro_torch.obs import trace as _trace_mod
from repro_torch.obs.trace import _TID_META_PID, now_ns

DEFAULT_CAPACITY = 2048

# slot field indices (a slot is a fixed 9-element list, mutated in place)
_SEQ, _PH, _NAME, _T0, _T1, _TRACE_ID, _ATTRS, _LANE_TID, _LANE = range(9)


class _Ring:
    """One thread's preallocated record ring.

    ``slots`` is a list of ``capacity`` fixed-shape lists; ``head`` is
    the next slot to (over)write and ``seq`` the total records ever
    written — so ``seq - capacity`` is the oldest retained sequence
    number once the ring has wrapped.
    """

    __slots__ = ("tid", "lane", "slots", "head", "seq", "lock")

    def __init__(self, tid: int, lane: str, capacity: int):
        self.tid = tid
        self.lane = lane
        self.slots: List[list] = [
            [0, "", "", 0, 0, None, None, None, None]
            for _ in range(capacity)]
        self.head = 0
        self.seq = 0
        self.lock = threading.Lock()

    def put(self, ph: str, name: str, t0_ns: int, t1_ns: int,
            trace_id: Optional[str], attrs: Optional[Dict],
            lane_tid: Optional[int], lane: Optional[str]) -> None:
        """Overwrite the oldest slot with one record. No allocation."""
        with self.lock:
            slot = self.slots[self.head]
            slot[_SEQ] = self.seq
            slot[_PH] = ph
            slot[_NAME] = name
            slot[_T0] = t0_ns
            slot[_T1] = t1_ns
            slot[_TRACE_ID] = trace_id
            slot[_ATTRS] = attrs
            slot[_LANE_TID] = lane_tid
            slot[_LANE] = lane
            self.head = (self.head + 1) % len(self.slots)
            self.seq = self.seq + 1

    def snapshot(self) -> List[list]:
        """Retained records oldest -> newest (copies; safe post-return)."""
        with self.lock:
            n = len(self.slots)
            count = min(self.seq, n)
            start = (self.head - count) % n
            out = []
            for i in range(count):
                out.append(list(self.slots[(start + i) % n]))
            return out


class FlightRecorder:
    """Process-wide black box: per-thread rings + Chrome-trace dumps."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 name: str = "flight"):
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.name = name
        self._lock = threading.Lock()
        self._rings: Dict[int, _Ring] = {}
        self._tls = threading.local()
        self._dumps = 0

    # -- recording (hot path) ----------------------------------------------

    def _ring(self) -> _Ring:
        """The calling thread's ring (registered on first use)."""
        ring = getattr(self._tls, "ring", None)
        if ring is not None:
            return ring
        tid = threading.get_ident()
        lane = threading.current_thread().name
        ring = _Ring(tid, lane, self.capacity)
        with self._lock:
            # a reused OS tid replaces the dead thread's ring: one ring
            # per live tid keeps per-ring seq contiguity meaningful
            self._rings[tid] = ring
        self._tls.ring = ring
        return ring

    def record_span(self, name: str, t0_ns: int, t1_ns: int,
                    trace_id: Optional[str] = None,
                    attrs: Optional[Dict] = None,
                    lane_tid: Optional[int] = None,
                    lane: Optional[str] = None) -> None:
        self._ring().put("X", name, t0_ns, t1_ns, trace_id, attrs,
                         lane_tid, lane)

    def record_event(self, name: str, t_ns: Optional[int] = None,
                     trace_id: Optional[str] = None,
                     attrs: Optional[Dict] = None) -> None:
        if t_ns is None:
            t_ns = now_ns()
        self._ring().put("i", name, t_ns, t_ns, trace_id, attrs, None, None)

    # -- dumping -----------------------------------------------------------

    def dump(self, reason: Optional[str] = None) -> Dict:
        """All retained history as Chrome-trace JSON (a plain dict).

        Same shape as :meth:`obs.Trace.to_chrome`: complete ("X") and
        instant ("i") events with microsecond ``ts`` relative to the
        dump epoch (the earliest retained timestamp), ``thread_name``
        metadata per lane, and per-record ``args`` carrying the ring's
        ``seq``/``ring`` so ``check_trace.py --flight`` can prove the
        retained history is gap-free.
        """
        with self._lock:
            rings = list(self._rings.values())
            self._dumps = self._dumps + 1
        ring_snaps = [(r, r.snapshot()) for r in rings]

        epoch = None
        for _, snap in ring_snaps:
            for rec in snap:
                if epoch is None or rec[_T0] < epoch:
                    epoch = rec[_T0]
        if epoch is None:
            epoch = now_ns()

        events = []
        lanes: Dict[int, str] = {}
        total = 0
        dropped = 0
        for ring, snap in ring_snaps:
            total += len(snap)
            dropped += max(0, ring.seq - len(snap))
            lanes.setdefault(ring.tid, f"flight:{ring.lane}")
            for rec in snap:
                tid = ring.tid
                if rec[_LANE_TID] is not None:
                    tid = rec[_LANE_TID]
                    if rec[_LANE] is not None:
                        lanes.setdefault(tid, rec[_LANE])
                args = dict(rec[_ATTRS]) if rec[_ATTRS] else {}
                args["seq"] = rec[_SEQ]
                args["ring"] = ring.tid
                if rec[_TRACE_ID] is not None:
                    args["trace_id"] = rec[_TRACE_ID]
                ev = {"name": rec[_NAME], "ph": rec[_PH],
                      "cat": rec[_NAME].split(".", 1)[0],
                      "pid": _TID_META_PID, "tid": tid,
                      "ts": (rec[_T0] - epoch) / 1e3, "args": args}
                if rec[_PH] == "X":
                    ev["dur"] = (rec[_T1] - rec[_T0]) / 1e3
                else:
                    ev["s"] = "t"
                events.append(ev)

        meta = [{"name": "thread_name", "ph": "M", "pid": _TID_META_PID,
                 "tid": tid, "args": {"name": lane}}
                for tid, lane in sorted(lanes.items(), key=lambda kv: kv[0])]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"flight": self.name,
                              "reason": reason,
                              "capacity": self.capacity,
                              "rings": len(ring_snaps),
                              "records": total,
                              "dropped_total": dropped}}

    def stats(self) -> Dict:
        with self._lock:
            rings = list(self._rings.values())
            dumps = self._dumps
        retained = sum(min(r.seq, self.capacity) for r in rings)
        total = sum(r.seq for r in rings)
        return {"rings": len(rings), "capacity": self.capacity,
                "retained": retained, "recorded_total": total,
                "dropped_total": total - retained, "dumps": dumps}


# ---------------------------------------------------------------------------
# Process-global installation (mirrors trace.enable/disable)
# ---------------------------------------------------------------------------

_install_lock = threading.Lock()


def install(recorder: Optional[FlightRecorder] = None) -> FlightRecorder:
    """Install ``recorder`` (or a fresh one) as the process flight box."""
    with _install_lock:
        if recorder is None:
            recorder = FlightRecorder()
        _trace_mod._flight = recorder
        return recorder


def uninstall() -> Optional[FlightRecorder]:
    """Remove the flight recorder; returns it (for a final dump) or None."""
    with _install_lock:
        recorder = _trace_mod._flight
        _trace_mod._flight = None
        return recorder


def get_flight() -> Optional[FlightRecorder]:
    """The installed flight recorder, if any."""
    return _trace_mod._flight


def install_default() -> FlightRecorder:
    """The import-time default: a recorder of :data:`DEFAULT_CAPACITY`
    slots per thread. Called once from ``repro_torch.obs``; explicit
    ``install()``/``uninstall()`` calls afterwards win."""
    return install(FlightRecorder(capacity=DEFAULT_CAPACITY))
