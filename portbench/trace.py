"""The traced run's device trace: capture over a steady sub-window of the
measured window, and the reductions the per-layer metrics read.

``Profiler`` prepares ``torch.profiler`` (CPU and CUDA activities, CUPTI
underneath) before the traffic starts, records a given stretch under the
host range ``portbench.window`` and stops; the trace is exported once
the measured window has closed.

``DeviceTrace`` holds that window's device events (kernels, copies,
memsets), clipped to the window. A bound view runs each batch as one
host-to-device copy of its frames, one graph replay and one copy back, in
order on its own stream; so each host-to-device copy whose size is a
whole number of frames starts a batch, and the batch's bucket is that
number (``batches``).
"""

from __future__ import annotations

import bisect
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def short_name(name: str) -> str:
    """A kernel symbol without ``void``, namespaces and its argument list,
    template arguments kept (at most 120 characters)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    name = re.sub(r"\b[A-Za-z_]\w*::", "", name)
    return re.sub(r"\s+", " ", name)[:120]


class DeviceTrace:
    """The device events of one traced window (times in µs, the trace's
    clock)."""

    def __init__(self, events: List[Dict]):
        found = [e for e in events if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if len(found) != 1:
            raise ValueError(f"trace: {len(found)} ranges named {WINDOW}")
        self.lo = float(found[0]["ts"])
        self.hi = self.lo + float(found[0]["dur"])
        self.device = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if b <= self.lo or a >= self.hi:
                continue
            self.device.append({"name": e["name"], "cat": e["cat"],
                                "ts": a, "end": b,
                                "bytes": e.get("args", {}).get("bytes")})
        self.device.sort(key=lambda e: e["ts"])
        self.host = sorted(
            ((float(e["ts"]), e["name"]) for e in events
             if e.get("cat") in HOST_CATS and e.get("name") != WINDOW
             and "ts" in e), key=lambda t: t[0])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def _clipped(self, e) -> Tuple[float, float]:
        return max(e["ts"], self.lo), min(e["end"], self.hi)

    def busy_s(self) -> float:
        """The union of the device intervals inside the window."""
        busy, end = 0.0, None
        for e in self.device:
            a, b = self._clipped(e)
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The window's stretches with nothing on the device (µs)."""
        gaps, end = [], self.lo
        for e in self.device:
            a, b = self._clipped(e)
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.hi > end:
            gaps.append((end, self.hi))
        return gaps

    def kernel_seconds(self, pattern: str, events=None) -> float:
        rx = re.compile(pattern)
        return sum(e["end"] - e["ts"] for e in (self.device if events is None else events)
                   if e["cat"] == "kernel" and rx.search(e["name"])) / 1e6

    def batches(self, frame_bytes: int) -> List[Tuple[int, List[Dict]]]:
        """(bucket, device events) of each batch that starts and ends
        inside the window: from one host-to-device copy of a whole number
        of frames to the next."""
        starts = [i for i, e in enumerate(self.device)
                  if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]
                  and e["bytes"] and e["bytes"] % frame_bytes == 0
                  and e["ts"] >= self.lo]
        out = []
        for i, j in zip(starts, starts[1:]):
            out.append((self.device[i]["bytes"] // frame_bytes,
                        self.device[i:j]))
        return out

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took the most time, by short name."""
        by = {}
        for e in self.device:
            a, b = self._clipped(e)
            key = short_name(e["name"])
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_by_host(self, top: int = 10) -> List[List]:
        """The idle time, by the host call last begun before each gap's
        middle (``host: untraced`` where the trace has none)."""
        starts = [t for t, _ in self.host]
        by = {}
        for a, b in self.idle_gaps():
            i = bisect.bisect_right(starts, (a + b) / 2) - 1
            key = ("host: " + self.host[i][1][:100]) if i >= 0 \
                else "host: untraced"
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]


class Profiler:
    """``torch.profiler`` recording [at, at + seconds] of ``clock()``.

    :meth:`prepare` starts it in its warm-up step (CUPTI attached, nothing
    kept) before the traffic starts; :meth:`run` sleeps until ``at``,
    records ``seconds`` under the host range ``portbench.window`` and
    stops. Both run in the main thread: the profiler's CUPTI client must
    start in the thread that registered it. ``host_window`` is when the
    range ran, by ``clock()``."""

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds, self.clock = seconds, clock
        self.at = 0.0
        self.prof = None
        self.host_window: Optional[Tuple[float, float]] = None

    def prepare(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.prof.start()

    def run(self) -> None:
        from torch.profiler import record_function
        time.sleep(max(self.at - self.clock(), 0.0))
        self.prof.step()                       # warm-up -> recording
        with record_function(WINDOW):
            lo = self.clock()
            time.sleep(self.seconds)
            hi = self.clock()
        self.prof.stop()
        self.host_window = (lo, hi)

    def export(self, path: Path) -> DeviceTrace:
        """Write the Chrome trace to ``path``, read it back, delete it."""
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                return DeviceTrace(json.load(f)["traceEvents"])
        finally:
            path.unlink()
