"""repro_torch.serve — the micro-batching serving runtime, on one device.

A multi-program router with an async micro-batching scheduler (collect up
to ``max_batch`` / ``max_wait_ms``, pad to a batch bucket, split results
per request — bitwise equal to per-request ``run_per_frame``), bounded
admission with backpressure, deadline shedding, and a stats snapshot
(p50/p95/p99 latency, achieved frames/s, padding waste).

    from repro_torch import Program, serve

    server = serve.Server(serve.ServeConfig(max_batch=8))
    server.register("lenet", Program.from_model("lenet"))
    server.start()
    logits = server.submit("lenet", frame).result()
    server.stop()
"""

from repro_torch.serve.batcher import (padded_slots, pick_bucket,
                                       power_of_two_buckets,
                                       should_close_early, split_results)
from repro_torch.serve.clock import Clock, VirtualClock
from repro_torch.serve.metrics import ProgramMetrics, latency_summary
from repro_torch.serve.pool import Pool, WorkerError
from repro_torch.serve.server import (AdmissionError, DeadlineExceeded, Hooks,
                                      HostedProgram, ServeConfig, Server,
                                      ServerClosed)

__all__ = [
    "AdmissionError", "Clock", "DeadlineExceeded", "Hooks", "HostedProgram",
    "Pool", "ProgramMetrics", "ServeConfig", "Server", "ServerClosed",
    "VirtualClock", "WorkerError", "latency_summary", "padded_slots",
    "pick_bucket", "power_of_two_buckets", "should_close_early",
    "split_results",
]
