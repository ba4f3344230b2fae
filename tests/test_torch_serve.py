"""repro_torch.serve on the CPU: the scheduler's contracts.

The load-bearing one: micro-batched serving of two programs, with
interleaved requests of odd sizes (router, padding, chunking), is bitwise
equal to direct ``run_per_frame`` calls. Plus admission control with
backpressure, deadline shedding and drain/stop, on a ``VirtualClock`` where
timing matters, and the batch-close reasons.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from repro_torch import Options, Program, serve

CPU = Options(device="cpu")


@pytest.fixture(scope="module")
def progs():
    return {name: Program.from_model(name, torch.Generator().manual_seed(i))
            for i, name in enumerate(("lenet", "vgg9"))}


def _frames(prog, n, seed):
    f = np.random.default_rng(seed).random(
        (n, *prog.input_hwc)).astype(np.float32)
    f[::2] *= 0.1
    return f


def test_thirty_interleaved_requests_bitwise_equal_to_direct_runs(progs):
    server = serve.Server(serve.ServeConfig(max_batch=8, max_wait_ms=5.0,
                                            device="cpu"))
    for name, prog in progs.items():
        server.register(name, prog, CPU)
    server.start()
    sizes = [1, 3, 2, 5, 1, 9]          # 9 > the largest bucket: chunked
    reqs = []
    try:
        for i in range(30):
            name = ("lenet", "vgg9")[i % 2]
            reqs.append((name, _frames(progs[name], sizes[i % 6], seed=i)))
        futs = [server.submit(name, f) for name, f in reqs]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        server.stop()
    direct = {name: prog.compile(CPU) for name, prog in progs.items()}
    for (name, f), out in zip(reqs, outs):
        np.testing.assert_array_equal(
            out, direct[name].run_per_frame(f).numpy())
    st = server.stats()
    assert st["requests"]["served"] == 30
    assert st["frames_served"] == sum(f.shape[0] for _, f in reqs)
    for p in st["programs"].values():
        assert p["latency_ms"]["count"] == 15
        assert 0.0 <= p["padding_waste"] < 1.0
        assert p["model"]["kfps_per_w"] > 0
    # the CPU runs the kernels' plain versions: nothing was launched
    assert set(st["kernel_launches"].values()) == {0}


def test_close_reasons_speculative_and_window(progs):
    lenet = progs["lenet"]
    for speculative, want in ((True, "speculative"), (False, "window")):
        clk = serve.VirtualClock()
        closes = []
        server = serve.Server(
            serve.ServeConfig(max_batch=8, max_wait_ms=400.0, device="cpu",
                              speculative_close=speculative),
            clock=clk, hooks=serve.Hooks(
                batch_close=lambda n, r, k: closes.append((n, r, k))))
        server.register("lenet", lenet, CPU)
        server.start(warm=False)
        try:
            t0 = clk.now()
            server.submit("lenet", _frames(lenet, 1, 0)).result(timeout=60)
            held = clk.now() - t0
        finally:
            server.stop()
        assert closes[0] == ("lenet", want, 1)
        assert (held < 0.4) if speculative else (held >= 0.4)


def test_admission_control_and_backpressure(progs):
    lenet = progs["lenet"]
    clk = serve.VirtualClock()
    server = serve.Server(serve.ServeConfig(max_batch=2, max_queue=2,
                                            max_wait_ms=0.0, device="cpu"),
                          clock=clk)
    server.register("lenet", lenet, CPU)
    f = _frames(lenet, 3, 1)
    # not started: nothing drains the queue, so the bound must bite
    f1, f2 = server.submit("lenet", f[0]), server.submit("lenet", f[1])
    with pytest.raises(serve.AdmissionError, match="queue full"):
        server.submit("lenet", f[2], block=False)
    t0 = clk.now()
    with pytest.raises(serve.AdmissionError, match="backpressure"):
        server.submit("lenet", f[2], block=True, timeout=0.05)
    assert clk.now() - t0 >= 0.05         # waited it out, virtually
    server.start(warm=False)
    try:
        assert f1.result(timeout=60).shape == (1, 10)
        assert f2.result(timeout=60).shape == (1, 10)
        assert server.stats()["programs"]["lenet"]["requests"]["rejected"] == 2
    finally:
        server.stop()


def test_backpressure_unblocks_when_queue_drains(progs):
    lenet = progs["lenet"]
    server = serve.Server(serve.ServeConfig(max_batch=1, max_queue=1,
                                            max_wait_ms=0.0, device="cpu"))
    server.register("lenet", lenet, CPU)
    server.start(warm=False)
    futs = []
    f = _frames(lenet, 4, 2)

    def producer():
        for i in range(4):
            futs.append(server.submit("lenet", f[i], block=True))

    t = threading.Thread(target=producer)
    t.start()
    t.join(timeout=60)
    try:
        assert not t.is_alive()
        assert all(fu.result(timeout=60).shape == (1, 10) for fu in futs)
    finally:
        server.stop()


def test_deadline_shed_on_virtual_clock(progs):
    lenet = progs["lenet"]
    clk = serve.VirtualClock()
    server = serve.Server(serve.ServeConfig(max_batch=4, max_wait_ms=0.0,
                                            device="cpu"), clock=clk)
    server.register("lenet", lenet, CPU)
    f = _frames(lenet, 2, 3)
    expired = server.submit("lenet", f[0], deadline_ms=50.0)
    clk.advance(0.051)                    # past due before the server runs
    server.start(warm=False)
    try:
        ok = server.submit("lenet", f[1], deadline_ms=60_000.0)
        with pytest.raises(serve.DeadlineExceeded, match="deadline missed"):
            expired.result(timeout=60)
        assert ok.result(timeout=60).shape == (1, 10)
        p = server.stats()["programs"]["lenet"]["requests"]
        assert p["shed_deadline"] == 1 and p["served"] == 1
    finally:
        server.stop()


def test_stop_drains_backlog_then_rejects(progs):
    lenet = progs["lenet"]
    server = serve.Server(serve.ServeConfig(max_batch=4, max_wait_ms=5.0,
                                            device="cpu"))
    server.register("lenet", lenet, CPU)
    server.start(warm=False)
    f = _frames(lenet, 6, 4)
    futs = [server.submit("lenet", f[i]) for i in range(6)]
    server.stop(drain=True)
    assert all(fu.result(timeout=1).shape == (1, 10) for fu in futs)
    with pytest.raises(serve.ServerClosed):
        server.submit("lenet", f[0])


def test_stop_without_drain_fails_pending_and_resets_accounting(progs):
    lenet = progs["lenet"]
    server = serve.Server(serve.ServeConfig(max_batch=4, device="cpu"))
    server.register("lenet", lenet, CPU)
    futs = [server.submit("lenet", _frames(lenet, 2, i)) for i in range(3)]
    assert server.stats()["queue_depth"] == 6
    server.stop(drain=False)              # never started: fail the backlog
    for fu in futs:
        with pytest.raises(serve.ServerClosed):
            fu.result(timeout=1)
    st = server.stats()
    assert st["queue_depth"] == 0
    assert st["programs"]["lenet"]["requests"]["failed"] == 3


def test_worker_failure_fails_only_that_batch(progs):
    lenet = progs["lenet"]
    server = serve.Server(serve.ServeConfig(max_batch=4, max_wait_ms=0.0,
                                            device="cpu"))
    hosted = server.register("lenet", lenet, CPU)
    real = hosted.executable.run_padded
    calls = []

    def flaky(frames, bucket):
        calls.append(bucket)
        if len(calls) == 1:
            raise RuntimeError("injected device fault")
        return real(frames, bucket)

    hosted.executable.run_padded = flaky
    server.start(warm=False)
    try:
        f = _frames(lenet, 2, 5)
        with pytest.raises(serve.WorkerError, match="injected") as info:
            server.submit("lenet", f[0]).result(timeout=60)
        assert isinstance(info.value.__cause__, RuntimeError)
        np.testing.assert_array_equal(
            server.submit("lenet", f[1]).result(timeout=60),
            lenet.compile(CPU).run_per_frame(f[1:]).numpy())
        st = server.stats()
        assert st["programs"]["lenet"]["requests"]["failed"] == 1
        assert st["pool"]["failures"] == 1
    finally:
        server.stop()


def test_validation(progs):
    lenet = progs["lenet"]
    server = serve.Server(serve.ServeConfig(max_queue=4, device="cpu"))
    server.register("lenet", lenet, CPU)
    with pytest.raises(ValueError, match="unknown program"):
        server.submit("nope", _frames(lenet, 1, 0))
    with pytest.raises(ValueError, match="do not match"):
        server.submit("lenet", np.zeros((1, 8, 8, 1), np.float32))
    with pytest.raises(ValueError, match="exceeds max_queue"):
        server.submit("lenet", _frames(lenet, 5, 0))
    with pytest.raises(ValueError, match="already registered"):
        server.register("lenet", lenet, CPU)
    with pytest.raises(RuntimeError, match="no programs"):
        serve.Server(serve.ServeConfig(device="cpu")).start()
    with pytest.raises(NotImplementedError, match="multi-device"):
        serve.ServeConfig(devices=2, device="cpu")


def test_bucket_helpers():
    assert serve.power_of_two_buckets(8) == (1, 2, 4, 8)
    assert serve.power_of_two_buckets(6) == (1, 2, 4, 6)
    assert serve.pick_bucket(3, (1, 2, 4, 8)) == 4
    assert serve.pick_bucket(9, (1, 2, 4, 8)) == 8
    assert serve.padded_slots(9, 8) == 16
    assert serve.should_close_early(3, 8, 0)
    assert not serve.should_close_early(3, 8, 1)
    parts = serve.split_results(np.arange(6), [1, 2, 3])
    assert [p.tolist() for p in parts] == [[0], [1, 2], [3, 4, 5]]
