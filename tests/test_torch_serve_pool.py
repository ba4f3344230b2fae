"""repro_torch's device pool and bound views on the CPU: the counterparts
of the reference's ``tests/test_serve_pool.py``, plus the load generators
and the stats table.

* Thread-free units: the placement policies, config validation and the
  zero-copy result split.
* Pool mechanics through the ``execute`` hook (no program runs): work
  stealing, fault isolation, stop flushing, reclaiming a wedged worker.
* Bound CPU views: bitwise equal to the unbound executable, the staging
  ring reused and rotated, pipelined dispatch intact.
* The property suite: random programs x batch sizes x bucket ladders
  across 4 emulated CPU workers (``ServeConfig(device="cpu", devices=4)``,
  the port's counterpart of the reference's four virtual XLA devices)
  are bitwise equal to direct ``run_per_frame`` and to a one-device
  server, under both placements.

Why bit-identity holds: every worker runs the same per-frame-calibrated
executor over a bound view of one compiled plan, so placement, stealing,
padding and batch composition cannot change a frame's answer.
"""

from __future__ import annotations

import queue
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch import Options, Program, serve
from repro_torch.serve import batcher
from repro_torch.serve import pool as pool_mod

CPU = Options(device="cpu")


@pytest.fixture(scope="module")
def lenet():
    prog = Program.from_model("lenet", torch.Generator().manual_seed(0))
    return prog, prog.compile(CPU)


@pytest.fixture(scope="module")
def frames28():
    f = np.random.default_rng(0).random((9, 28, 28, 1)).astype(np.float32)
    f[::3] *= 0.1
    return f


def _singles(exe, frames):
    return np.concatenate([exe.run_per_frame(frames[i:i + 1]).numpy()
                           for i in range(len(frames))])


# -- placement policies, validation, result split (thread-free) ---------------

def test_least_loaded_picks_minimum_and_rotates_ties():
    p = serve.LeastLoaded()
    assert p.choose([5, 2, 7]) == 1
    assert p.choose([0, 9, 9]) == 0
    q = serve.LeastLoaded()
    assert [q.choose([0, 0, 0, 0]) for _ in range(8)] == [0, 1, 2, 3] * 2


def test_round_robin_ignores_load():
    p = serve.RoundRobin()
    assert [p.choose([9, 0, 0]) for _ in range(4)] == [0, 1, 2, 0]


def test_placement_registry_and_config_validation():
    assert set(serve.PLACEMENTS) == {"least_loaded", "round_robin"}
    with pytest.raises(ValueError, match="unknown placement"):
        serve.ServeConfig(device="cpu", placement="bogus")
    with pytest.raises(ValueError, match="devices"):
        serve.ServeConfig(device="cpu", devices=0)
    with pytest.raises(ValueError, match="device"):
        pool_mod.Pool(0, serve.RoundRobin(), queue.Queue())
    with pytest.raises(ValueError, match="names"):
        pool_mod.Pool(2, serve.RoundRobin(), queue.Queue(), names=["a"])


def test_split_results_returns_zero_copy_views():
    out = np.arange(24, dtype=np.float32).reshape(6, 4)
    parts = batcher.split_results(out, [1, 2, 3])
    assert [p.shape[0] for p in parts] == [1, 2, 3]
    assert all(np.shares_memory(p, out) for p in parts)
    with pytest.raises(ValueError, match="sum of request sizes"):
        batcher.split_results(out, [1, 2])


# -- pool mechanics through the execute hook ----------------------------------

def _hosted_stub(name="p", n_devices=2):
    # the execute hook replaces the device call: the bound views go unused
    return types.SimpleNamespace(name=name, bound=(None,) * n_devices)


def _batch(hosted, fill, n=2):
    frames = np.full((n, 2, 2, 1), fill, np.float32)
    return pool_mod.Batch(hosted, [], frames, n, n, 0.0)


def test_pool_work_stealing_drains_a_blocked_devices_backlog():
    """Every placement pinned to device 0 and the worker that takes the
    first batch blocked: the idle peer steals the second."""
    done: queue.Queue = queue.Queue()
    gate, started = threading.Event(), threading.Event()

    def execute(program, device, frames, bucket, default):
        if frames[0, 0, 0, 0] == 1.0:
            started.set()
            assert gate.wait(30)
        return frames * 2.0

    class PinZero:
        def choose(self, loads):
            return 0

    pool = pool_mod.Pool(2, PinZero(), done, execute_hook=execute,
                         pipeline=1)
    pool.start()
    hosted = _hosted_stub()
    try:
        pool.dispatch(_batch(hosted, 1.0))
        assert started.wait(30)
        pool.dispatch(_batch(hosted, 2.0))
        first = done.get(timeout=30)
        assert first.error is None
        np.testing.assert_array_equal(first.out,
                                      np.full((2, 2, 2, 1), 4.0, np.float32))
        gate.set()
        second = done.get(timeout=30)
        assert second.error is None
    finally:
        gate.set()
        pool.stop(timeout=30)
    st = pool.stats()
    assert st["steals"] == 1
    assert sum(d["batches"] for d in st["per_device"]) == 2
    assert sum(d["steals"] for d in st["per_device"]) == 1
    assert {first.device, second.device} == {0, 1}
    assert all(d["queued_frames"] == 0 and d["inflight_frames"] == 0
               for d in st["per_device"])
    assert st["placement_us"]["count"] == 2
    assert not pool.alive() and not pool.healthy()


def test_pool_fault_isolated_to_one_batch():
    done: queue.Queue = queue.Queue()

    def execute(program, device, frames, bucket, default):
        if frames[0, 0, 0, 0] == 13.0:
            raise RuntimeError("kaboom")
        return torch.from_numpy(frames + 1.0)     # a device-like result

    pool = pool_mod.Pool(2, serve.RoundRobin(), done, execute_hook=execute,
                         pipeline=2, names=["cpu#0", "cpu#1"])
    pool.start()
    assert pool.healthy() and pool.workers_alive() == 2
    hosted = _hosted_stub()
    try:
        pool.dispatch(_batch(hosted, 13.0))
        pool.dispatch(_batch(hosted, 5.0))
        results = [done.get(timeout=30) for _ in range(2)]
    finally:
        pool.stop(timeout=30)
    failed = [d for d in results if d.error is not None]
    ok = [d for d in results if d.error is None]
    assert len(failed) == 1 and len(ok) == 1
    err = failed[0].error
    assert isinstance(err, serve.WorkerError)
    assert err.program == "p" and err.device == failed[0].device
    assert f"cpu#{err.device}" in str(err)
    assert isinstance(err.__cause__, RuntimeError)
    np.testing.assert_array_equal(ok[0].out,
                                  np.full((2, 2, 2, 1), 6.0, np.float32))
    st = pool.stats()
    assert sum(d["failures"] for d in st["per_device"]) == 1
    assert all(d["inflight_frames"] == 0 for d in st["per_device"])


def test_pool_stop_flushes_pending_completions():
    done: queue.Queue = queue.Queue()
    pool = pool_mod.Pool(2, serve.LeastLoaded(), done,
                         execute_hook=lambda *a: a[2] * 3.0, pipeline=2)
    pool.start()
    hosted = _hosted_stub()
    for i in range(8):
        pool.dispatch(_batch(hosted, float(i)))
    pool.stop(timeout=30)
    assert done.qsize() == 8
    while not done.empty():
        assert done.get().error is None


def test_pool_take_outstanding_reclaims_wedged_work():
    done: queue.Queue = queue.Queue()
    gate, entered = threading.Event(), threading.Event()

    def execute(program, device, frames, bucket, default):
        entered.set()
        assert gate.wait(30)
        return frames

    pool = pool_mod.Pool(1, serve.RoundRobin(), done, execute_hook=execute,
                         pipeline=1)
    pool.start()
    hosted = _hosted_stub(n_devices=1)
    b1, b2 = _batch(hosted, 1.0), _batch(hosted, 2.0)
    try:
        pool.dispatch(b1)
        assert entered.wait(30)
        pool.dispatch(b2)
        pool.stop(timeout=0.2)
        assert pool.alive()
        queued, inflight = pool.take_outstanding()
        assert queued == [b2] and inflight == [b1]
        assert pool.stats()["per_device"][0]["queued_frames"] == 0
        assert pool.take_outstanding()[0] == []
    finally:
        gate.set()
        pool.stop(timeout=30)
    assert not pool.alive()
    assert done.get(timeout=30).error is None


# -- server-level faults -------------------------------------------------------

def test_server_fault_injection_fails_only_that_batch(lenet, frames28):
    prog, exe = lenet
    fired = []

    def execute(program, device, frames, bucket, default):
        if not fired:
            fired.append((program, device))
            raise RuntimeError("injected device fault")
        return default()

    server = serve.Server(serve.ServeConfig(max_batch=4, max_wait_ms=0.0,
                                            device="cpu", devices=2),
                          hooks=serve.Hooks(execute=execute))
    server.register("lenet", prog, CPU)
    server.start(warm=False)
    try:
        with pytest.raises(serve.WorkerError) as ei:
            server.submit("lenet", frames28[:2]).result(timeout=120)
        assert ei.value.program == "lenet"
        assert ei.value.device == fired[0][1]
        assert isinstance(ei.value.__cause__, RuntimeError)
        ok = server.submit("lenet", frames28[2:4]).result(timeout=120)
        np.testing.assert_array_equal(ok, _singles(exe, frames28[2:4]))
        st = server.stats()
        assert st["programs"]["lenet"]["requests"]["failed"] == 1
        assert st["programs"]["lenet"]["requests"]["served"] == 1
        assert sum(d["failures"] for d in st["pool"]["per_device"]) == 1
    finally:
        server.stop()
    assert server.stats()["queue_depth"] == 0


def test_stop_timeout_fails_stranded_batches_instead_of_hanging(lenet,
                                                                frames28):
    prog, _ = lenet
    gate, entered = threading.Event(), threading.Event()

    def execute(program, device, frames, bucket, default):
        entered.set()
        assert gate.wait(30)
        return default()

    server = serve.Server(serve.ServeConfig(max_batch=4, max_wait_ms=0.0,
                                            device="cpu"),
                          hooks=serve.Hooks(execute=execute))
    server.register("lenet", prog, CPU)
    server.start(warm=False)
    try:
        fut = server.submit("lenet", frames28[:2])
        assert entered.wait(30)
        server.stop(drain=False, timeout=0.2)
        with pytest.raises(serve.ServerClosed, match="outstanding"):
            fut.result(timeout=30)
        st = server.stats()
        assert st["programs"]["lenet"]["requests"]["failed"] == 1
        assert st["queue_depth"] == 0
    finally:
        gate.set()


# -- bound views on the CPU ----------------------------------------------------

def test_bound_cpu_view_bitwise_equal_and_staging_reused(lenet, frames28):
    _, exe = lenet
    bound = exe.bind("cpu")
    assert bound._binding is not None and exe._binding is None
    assert bound.device == torch.device("cpu")
    ref = exe.run_per_frame(frames28).numpy()
    np.testing.assert_array_equal(bound.run_per_frame(frames28).numpy(), ref)
    np.testing.assert_array_equal(bound.run(frames28[:1]).numpy(),
                                  exe.run(frames28[:1]).numpy())
    # the weights were quantized once, with the eager executor's call
    from repro_torch.core.plan import quantized_weights
    for name, (wq, ws, _) in quantized_weights(
            exe.plan.steps, exe.params(), exe.plan.consts).items():
        assert torch.equal(bound._binding.weights[name][0], wq)
        assert torch.equal(bound._binding.weights[name][1], ws)
    a = np.asarray(bound.run_padded(frames28[:3], bucket=4))
    b = np.asarray(bound.run_padded(frames28[:3], bucket=4))
    c = np.asarray(bound.run_padded(frames28, bucket=4))  # 3 chunks
    np.testing.assert_array_equal(a, ref[:3])
    np.testing.assert_array_equal(b, ref[:3])
    np.testing.assert_array_equal(c, ref)
    (ring,) = bound._binding.staging.values()
    assert len(ring) == 2                   # two slots, reused in turn
    bound.warm((1, 4))
    assert set(bound._binding.staging) == {(1, (28, 28, 1)), (4, (28, 28, 1))}
    assert bound._binding.graphs == {}      # nothing is captured on the CPU


def test_staging_ring_survives_pipelined_dispatch(lenet, frames28):
    """Batches dispatched back to back before the first is read: the ring
    hands out distinct slots in turn, and each answer is its own."""
    _, exe = lenet
    bound = exe.bind("cpu", staging_slots=2)
    refs = [exe.run_per_frame(frames28[i:i + 3]).numpy() for i in (0, 3, 6)]
    pending = [bound.run_padded(frames28[i:i + 3], bucket=4)
               for i in (0, 3, 6)]
    for p, ref in zip(pending, refs):
        np.testing.assert_array_equal(np.asarray(p), ref)
    (ring,) = bound._binding.staging.values()
    assert len(ring) == 2
    assert not np.shares_memory(ring[0].array, ring[1].array)
    outs = [p.wait() for p in pending]
    assert not any(np.shares_memory(o, s.array) for o in outs for s in ring)
    with pytest.raises(ValueError, match="staging_slots"):
        exe.bind("cpu", staging_slots=0)
    with pytest.raises(ValueError, match="do not match"):
        bound.run_padded(np.zeros((1, 8, 8, 1), np.float32), 1)


def test_server_binds_every_program_to_every_device(lenet):
    prog, _ = lenet
    server = serve.Server(serve.ServeConfig(device="cpu", devices=3,
                                            max_inflight=4))
    hosted = server.register("lenet", prog, CPU)
    server.start(warm=False)
    try:
        assert len(hosted.bound) == 3
        assert all(b._binding.staging_slots == 4 for b in hosted.bound)
        names = [d["name"] for d in server.stats()["pool"]["per_device"]]
        assert names == ["cpu#0", "cpu#1", "cpu#2"]
    finally:
        server.stop()


def test_server_devices_exceeding_local_raises(lenet, monkeypatch):
    prog, _ = lenet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    server = serve.Server(serve.ServeConfig(device="cuda", devices=3))
    server.register("lenet", prog, CPU)
    with pytest.raises(ValueError, match="only 2 local CUDA device"):
        server.start()
    server = serve.Server(serve.ServeConfig(device="cuda:1", devices=2))
    server.register("lenet", prog, CPU)
    with pytest.raises(ValueError, match="local CUDA device"):
        server.start()


# -- the property suite: 4 emulated CPU workers ---------------------------------

@pytest.mark.parametrize("placement", ["least_loaded", "round_robin"])
def test_pool_dispatch_bit_identity_property(placement):
    rng = np.random.default_rng(11)
    progs = {"lenet": Program.from_model("lenet",
                                         torch.Generator().manual_seed(0)),
             "edge": Program.from_pipeline("edge_detect", 16, 16, 3),
             "sharpen": Program.from_pipeline("sharpen", 16, 16, 3)}
    ladders = {"lenet": (1, 2, 4, 8), "edge": (2, 8), "sharpen": (1, 3, 5)}
    server = serve.Server(serve.ServeConfig(
        max_batch=8, max_wait_ms=1.0, device="cpu", devices=4,
        placement=placement))
    hosted = {name: server.register(name, prog, CPU, buckets=ladders[name])
              for name, prog in progs.items()}
    server.start()
    try:
        subs = []
        for _ in range(30):
            name = ("lenet", "edge", "sharpen")[rng.integers(3)]
            n = int(rng.integers(1, 7))
            f = rng.random((n, *progs[name].input_hwc)).astype(np.float32)
            subs.append((name, f, server.submit(name, f)))
        for name, f, fut in subs:
            np.testing.assert_array_equal(
                fut.result(timeout=300),
                _singles(hosted[name].executable, f))
        st = server.stats()
        assert st["pool"]["devices"] == 4
        used = [d for d in st["pool"]["per_device"] if d["batches"]]
        assert len(used) >= 2, f"the pool never spread load: {st['pool']}"
        assert st["requests"]["served"] == 30
    finally:
        server.stop()
    assert all(d["inflight_frames"] == 0 and d["queued_frames"] == 0
               for d in server.stats()["pool"]["per_device"])


@pytest.mark.parametrize("placement", ["least_loaded", "round_robin"])
def test_pool_matches_single_device_server_bitwise(frames28, placement):
    prog = Program.from_model("lenet", torch.Generator().manual_seed(0))
    outs = {}
    for ndev in (1, 4):
        server = serve.Server(serve.ServeConfig(
            max_batch=4, max_wait_ms=0.5, device="cpu", devices=ndev,
            placement=placement))
        server.register("lenet", prog, CPU)
        server.start()
        try:
            futs = [server.submit("lenet", frames28[i % 9][None])
                    for i in range(16)]
            outs[ndev] = [f.result(timeout=300) for f in futs]
        finally:
            server.stop()
    for a, b in zip(outs[1], outs[4]):
        np.testing.assert_array_equal(a, b)


# -- load generators and the stats table -----------------------------------------

def test_poisson_load_accounting_and_sheds_on_virtual_clock(lenet, frames28):
    """On a VirtualClock every batch waits out its 400 ms window in virtual
    time at once: its head request is always past a 100 ms deadline (so
    each batch sheds), while no request waits past a 1 s one (all served).
    The generator's accounting matches the server's."""
    prog, exe = lenet
    for deadline, served in ((100.0, False), (1000.0, True)):
        server = serve.Server(
            serve.ServeConfig(max_batch=8, max_wait_ms=400.0, device="cpu",
                              speculative_close=False),
            clock=serve.VirtualClock())
        server.register("lenet", prog, CPU)
        server.start(warm=False)
        try:
            rep = serve.poisson_load(server, "lenet", frames28,
                                     rate_rps=2000.0, n_requests=12, seed=3,
                                     deadline_ms=deadline)
            st = server.stats()["programs"]["lenet"]["requests"]
        finally:
            server.stop()
        assert rep.submitted + rep.rejected == 12
        assert rep.served + rep.shed == rep.submitted
        assert (st["served"], st["shed_deadline"]) == (rep.served, rep.shed)
        assert rep.served == rep.latency_ms.get("count", 0)
        if served:
            assert rep.served == 12
        else:
            assert rep.shed >= 1
    with pytest.raises(ValueError, match="rate_rps"):
        serve.poisson_load(server, "lenet", frames28, rate_rps=0,
                           n_requests=1)


def test_saturate_serves_everything_bitwise(lenet, frames28):
    prog, exe = lenet
    server = serve.Server(serve.ServeConfig(max_batch=4, max_queue=8,
                                            device="cpu", devices=2))
    server.register("lenet", prog, CPU)
    server.start()
    try:
        rep = serve.saturate(server, "lenet", frames28, n_requests=20,
                             frames_per_request=2)
        st = server.stats()
    finally:
        server.stop()
    assert rep.served == rep.submitted == 20 and rep.shed == 0
    assert rep.achieved_fps == pytest.approx(2 * rep.achieved_rps)
    assert st["frames_served"] == 40


def test_format_stats_renders_every_section(lenet, frames28):
    prog, _ = lenet
    server = serve.Server(serve.ServeConfig(max_batch=4, device="cpu",
                                            devices=2))
    server.register("lenet", prog, CPU)
    server.start()
    try:
        for i in range(3):
            server.submit("lenet", frames28[i:i + 2]).result(timeout=60)
        stats = server.stats(verbose=True)
    finally:
        server.stop()
    hist = stats["programs"]["lenet"]["histograms"]
    assert hist["batch_occupancy"]["count"] == 3
    assert hist["padding_waste"]["count"] == 3
    assert stats["programs"]["lenet"]["kfps_per_w_drift"] > 0
    text = serve.format_stats(stats)
    lines = text.splitlines()
    assert lines[0].split()[:3] == ["program", "served", "shed"]
    assert any(l.startswith("lenet") and l.split()[1] == "3" for l in lines)
    assert any("occupancy mean=" in l for l in lines)
    assert any(l.startswith("pool: 2 device(s) [LeastLoaded]")
               for l in lines)
    assert any(l.startswith("plan cache:") for l in lines)
    assert any(l.startswith("kernel launches:") for l in lines)
