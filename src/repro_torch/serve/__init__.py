"""repro_torch.serve — the micro-batching serving runtime over a device pool.

A multi-program router with an async micro-batching scheduler (collect up
to ``max_batch`` / ``max_wait_ms``, pad to a batch bucket, split results
per request — bitwise equal to per-request ``run_per_frame``), a pool of
device workers (one bound view of every program per device: its own
stream, a pinned staging ring, one CUDA graph per bucket; least-loaded
placement, work stealing, per-device pipelining; ``devices``), bounded
admission with backpressure, deadline shedding, load generators and a
stats snapshot (p50/p95/p99 latency, achieved frames/s, padding waste,
per-device occupancy), and the operability layer over ``repro_torch.obs``:
per-request trace spans, SLOs, triggered flight dumps, a structured log
and the admin endpoint (``AdminServer``: ``/healthz`` ``/readyz``
``/metrics`` ``/statusz`` ``/tracez``).

    from repro_torch import Program, serve

    server = serve.Server(serve.ServeConfig(max_batch=8))
    server.register("lenet", Program.from_model("lenet"))
    server.start()                 # binds, warms, captures the graphs
    logits = server.submit("lenet", frame).result()
    server.stop()
"""

from repro_torch.serve.admin import AdminServer
from repro_torch.serve.batcher import (padded_slots, pick_bucket,
                                       power_of_two_buckets,
                                       should_close_early, split_results)
from repro_torch.serve.clock import Clock, VirtualClock
from repro_torch.serve.loadgen import LoadReport, poisson_load, saturate
from repro_torch.serve.metrics import (ProgramMetrics, format_stats,
                                       latency_summary)
from repro_torch.serve.pool import (PLACEMENTS, LeastLoaded, Pool,
                                    RoundRobin, WorkerError)
from repro_torch.serve.server import (AdmissionError, DeadlineExceeded, Hooks,
                                      HostedProgram, ServeConfig, Server,
                                      ServerClosed)

__all__ = [
    "AdminServer", "AdmissionError", "Clock", "DeadlineExceeded", "Hooks", "HostedProgram",
    "LeastLoaded", "LoadReport", "PLACEMENTS", "Pool", "ProgramMetrics",
    "RoundRobin", "ServeConfig", "Server", "ServerClosed", "VirtualClock",
    "WorkerError", "format_stats", "latency_summary", "padded_slots",
    "pick_bucket", "poisson_load", "power_of_two_buckets", "saturate",
    "should_close_early", "split_results",
]
