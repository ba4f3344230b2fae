"""repro_torch.obs — tracing, metrics, flight recorder, SLOs, structured log.

The port's copy of the reference package's observability layer (same
names, same Chrome-trace and Prometheus schemas, so
``scripts/check_trace.py`` validates the port's traces and dumps). It is
threaded through the compile pass (``core.plan``), kernel dispatch
(``kernels.dispatch``), the program front door (``Options(trace=)``) and
the serving runtime (``repro_torch.serve``).

    from repro_torch import obs

    trace = obs.enable()                  # install a collector
    ...                                   # compile / run / serve
    trace.export("out.json")              # open in chrome://tracing
    print(obs.prometheus_text())          # metrics exposition dump

The on-demand :class:`Trace` collector is **off by default**: with no
collector installed and no flight recorder, ``obs.span``/``obs.event``
return a shared no-op immediately. Recording never touches a tensor:
hooks observe Python ints and host timestamps only.

The **flight recorder** (``obs.flight``) is installed at import (2048
slots per thread) and keeps the last records per thread in preallocated
ring buffers regardless of the trace mode, so ``FlightRecorder.dump()``
can reconstruct the moments before an incident. Per-program :class:`SLO`
objectives (``obs.slo``) and the structured JSON-lines log (``obs.log``)
build on it: a breach or a worker failure triggers a dump inside
``repro_torch.serve``.

Unlike the reference, the port reads no environment variable: the trace
mode is ``Options(trace=)`` / :func:`use_mode` (ambient ``auto``), and
:func:`uninstall` / :func:`install` switch or resize the recorder.
"""

from repro_torch.obs.export import export_metrics, prometheus_text, write_jsonl
from repro_torch.obs.metrics import (RATIO_BUCKETS, REGISTRY, Counter, Gauge,
                                     Histogram, Registry, counter, gauge,
                                     histogram)
from repro_torch.obs.trace import (TRACE_MODES, Trace, current_trace_id,
                                   disable, enable, enabled, event, get_trace,
                                   now_ns, recording, span, span_at,
                                   trace_mode, use_mode)
from repro_torch.obs.flight import (FlightRecorder, get_flight, install,
                                    install_default, uninstall)
from repro_torch.obs.log import StructuredLog
from repro_torch.obs.slo import SLO, SLOMonitor

__all__ = [
    "Counter", "FlightRecorder", "Gauge", "Histogram", "RATIO_BUCKETS",
    "REGISTRY", "Registry", "SLO", "SLOMonitor", "StructuredLog",
    "TRACE_MODES", "Trace", "counter", "current_trace_id", "disable",
    "enable", "enabled", "event", "export_metrics", "gauge", "get_flight",
    "get_trace", "histogram", "install", "install_default", "now_ns",
    "prometheus_text", "recording", "span", "span_at", "trace_mode",
    "uninstall", "use_mode", "write_jsonl",
]

# the always-on black box
install_default()
