"""Exporters: JSON-lines sink + Prometheus-style text exposition.

Chrome-trace export lives on :meth:`obs.Trace.export`; this module
covers the two other shapes operators consume:

* :func:`write_jsonl` — append records (span dicts, stats snapshots,
  load reports) to a JSON-lines file, one object per line — the format
  log shippers and ``jq`` pipelines eat directly.
* :func:`prometheus_text` — dump a :class:`obs.Registry` in the
  Prometheus text exposition format (``# TYPE`` headers, ``_bucket``/
  ``_sum``/``_count`` histogram series), so a scrape endpoint or a
  node-exporter textfile collector can pick the metrics up without any
  new dependency.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Iterable, Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram, Registry, REGISTRY

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

# One process-wide sink lock: concurrent write_jsonl callers (the serving
# threads' structured log, periodic stats exporters) interleave whole
# *records*, never partial lines. Appends under a single lock are cheap
# relative to json.dumps; a per-path lock table would only matter with
# many distinct high-rate sinks, which the runtime does not have.
_jsonl_lock = threading.Lock()


def _prom_name(name: str) -> str:
    """Dotted registry name -> a fully legal Prometheus metric name.

    Every character outside ``[a-zA-Z0-9_:]`` becomes ``_`` (dots,
    dashes, slashes, spaces — e.g. ``slo.breach.edge-detect`` ->
    ``slo_breach_edge_detect``), and a name starting with a digit gets a
    leading ``_`` because the exposition grammar forbids a digit first.
    """
    pname = _NAME_RE.sub("_", name)
    if pname and pname[0].isdigit():
        pname = "_" + pname
    return pname


def write_jsonl(path, records: Iterable[dict], append: bool = True) -> str:
    """Write ``records`` to ``path`` as JSON lines; returns the path.

    Safe for concurrent writers: each call serializes its records first,
    then appends them under a process-wide lock, so readers never see a
    torn line even when several serving threads log at once.
    """
    lines = [json.dumps(rec) + "\n" for rec in records]
    with _jsonl_lock:
        with open(path, "a" if append else "w") as f:
            f.writelines(lines)
    return str(path)


def prometheus_text(registry: Optional[Registry] = None) -> str:
    """The registry in Prometheus text exposition format.

    Each metric gets ``# HELP`` (carrying the original dotted registry
    name, since escaping is lossy) and ``# TYPE`` headers; histograms
    expose cumulative ``_bucket{le=}`` series plus ``_sum``/``_count``.
    The text is the reference package's, byte for byte (its ``repro
    metric`` help prefix included), so one scrape config reads both.
    """
    registry = registry if registry is not None else REGISTRY
    lines = []
    with registry._lock:
        metrics = dict(registry._metrics)
    for name in sorted(metrics):
        m = metrics[name]
        pname = _prom_name(name)
        if isinstance(m, Counter):
            lines.append(f"# HELP {pname} repro metric '{name}'")
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {m.get()}")
        elif isinstance(m, Gauge):
            lines.append(f"# HELP {pname} repro metric '{name}'")
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {m.get()}")
        elif isinstance(m, Histogram):
            lines.append(f"# HELP {pname} repro metric '{name}'")
            lines.append(f"# TYPE {pname} histogram")
            with m._lock:
                acc = 0
                for le, c in zip(m.buckets, m.counts):
                    acc += c
                    lines.append(f'{pname}_bucket{{le="{le:g}"}} {acc}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {m.sum}")
                lines.append(f"{pname}_count {m.count}")
    return "\n".join(lines) + "\n"


def export_metrics(path, registry: Optional[Registry] = None) -> str:
    """Write :func:`prometheus_text` to ``path``; returns the path."""
    with open(path, "w") as f:
        f.write(prometheus_text(registry))
    return str(path)
