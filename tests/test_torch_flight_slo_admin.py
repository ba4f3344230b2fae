"""repro_torch.serve's operability layer on the CPU, against the reference.

* A traced server (``device="cpu"``, ``devices=2``) records the same
  per-request span names, each request's four phases under one
  ``trace_id``, as the reference server does for the same requests;
  ``serve_vision --device cpu --trace`` writes a trace that
  ``scripts/check_trace.py`` accepts with two device lanes.
* An SLO breach, a ``WorkerError`` and a stop that strands a batch each
  leave a triggered flight dump that passes ``check_trace.py --flight
  --require-trigger``; the dump rate limit and ``flight_dump_keep`` hold.
* The admin endpoint answers its five routes on an ephemeral port, and
  flips ``/healthz`` when the pool loses a worker.
* Served answers are bitwise equal with the recorder off, on, and on with
  a trace collector.
"""

from __future__ import annotations

import importlib.util
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import repro
from repro import obs as jobs
from repro import serve as jserve
from repro_torch import Options, Program, obs, serve

ROOT = Path(__file__).resolve().parent.parent
CPU = Options(device="cpu")
PHASES = ("serve.request.queue_wait", "serve.request.batch_assembly",
          "serve.request.device", "serve.request.split")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def check_trace():
    return _load_script("check_trace")


@pytest.fixture()
def flight():
    """A fresh recorder for the test; the previous one restored after."""
    prev = obs.get_flight()
    recorder = obs.install(obs.FlightRecorder(capacity=512, name="test"))
    try:
        yield recorder
    finally:
        if prev is not None:
            obs.install(prev)
        else:
            obs.uninstall()


@pytest.fixture(scope="module")
def edge():
    return Program.from_pipeline("edge_detect", 16, 16, 3)


def _frames(n, seed, hwc=(16, 16, 3)):
    f = np.random.default_rng(seed).random((n, *hwc)).astype(np.float32)
    f[::2] *= 0.1
    return f


def _get(url, expect=200):
    try:
        r = urllib.request.urlopen(url, timeout=30)
        code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    assert code == expect, f"{url}: {code} != {expect}: {body[:200]}"
    return body


# -- the per-request timeline against the reference --------------------------

def _traced_serve(mod, server, name, frames):
    """Submit ``frames`` one request at a time under a fresh collector;
    returns (answers, records)."""
    trace = mod.enable()
    try:
        server.start()
        try:
            outs = [np.asarray(server.submit(name, f).result(timeout=120))
                    for f in frames]
        finally:
            server.stop()
    finally:
        mod.disable()
    return outs, trace.records()


def _timelines(records):
    """{trace_id: [serve.request.* span names in time order]}, and the set
    of serving record names (steals left out: they depend on timing)."""
    lines = {}
    for r in sorted(records, key=lambda r: r["t0_ns"]):
        if r["ph"] == "X" and r["name"] in PHASES:
            lines.setdefault(r["trace_id"], []).append(r["name"])
    names = {r["name"] for r in records
             if r["name"].split(".")[0] in ("serve", "batcher")
             and r["name"] != "serve.pool.steal"}
    return lines, names


def test_request_spans_and_trace_ids_match_the_reference(edge):
    frames = [_frames(n, 10 + i) for i, n in enumerate((1, 2, 1, 3, 1))]
    jserver = jserve.Server(jserve.ServeConfig(max_batch=4, max_wait_ms=0.0))
    jserver.register("edge", repro.Program.from_pipeline("edge_detect", 16,
                                                         16, 3),
                     repro.Options(backend="reference"))
    server = serve.Server(serve.ServeConfig(max_batch=4, max_wait_ms=0.0,
                                            device="cpu", devices=2))
    server.register("edge", edge, CPU)
    jouts, jrecs = _traced_serve(jobs, jserver, "edge", frames)
    outs, recs = _traced_serve(obs, server, "edge", frames)
    for a, b in zip(outs, jouts):
        np.testing.assert_array_equal(a, b)
    mine, mine_names = _timelines(recs)
    theirs, their_names = _timelines(jrecs)
    assert mine == theirs
    assert sorted(mine) == [f"edge/req-{i}" for i in range(5)]
    assert all(v == list(PHASES) for v in mine.values())
    assert mine_names == their_names
    submits = [r["trace_id"] for r in recs if r["name"] == "serve.submit"]
    assert submits == sorted(mine)
    # the device phase names the pool device; both devices ran something
    devices = {r["attrs"]["device"] for r in recs
               if r["name"] == "serve.device.execute"}
    assert devices <= {0, 1}
    lanes = {r["tid"] for r in recs if r["name"] == "serve.request.device"}
    assert len(lanes) == 5                        # a lane per request


def test_serve_vision_trace_passes_check_trace(tmp_path, check_trace,
                                               capsys):
    from repro_torch.launch import serve_vision
    out = tmp_path / "trace.json"
    log = tmp_path / "serve.jsonl"
    serve_vision.main(["--device", "cpu", "--model", "lenet", "--load",
                       "400", "--requests", "24", "--devices", "2",
                       "--trace", str(out), "--admin-port", "0",
                       "--log", str(log)])
    printed = capsys.readouterr().out
    assert "admin endpoint at http://127.0.0.1:" in printed
    assert "[serve_vision] trace:" in printed and "conv dispatch:" in printed
    assert check_trace.check(str(out), min_devices=2) == []
    assert check_trace.main([str(out), "--min-devices", "2"]) == 0
    events = [json.loads(ln)["event"] for ln in log.read_text().splitlines()]
    assert events[0] == "serve.start" and events[-1] == "serve.stop"


# -- incidents: SLO breach, worker error, stop timeout ----------------------

def test_slo_breach_on_shed_spike_dumps_flight(flight, edge, tmp_path,
                                               check_trace):
    """A shed spike on a VirtualClock breaches the SLO: the breach counter,
    a structured log line and a triggered dump with the healthy request's
    timeline in it."""
    counter = obs.counter("slo.breach.edge")
    n0 = counter.get()
    clk = serve.VirtualClock()
    server = serve.Server(serve.ServeConfig(
        max_batch=4, max_wait_ms=100.0, speculative_close=False,
        device="cpu", flight_dump_dir=str(tmp_path)), clock=clk)
    server.register("edge", edge, CPU,
                    slo=obs.SLO(max_shed_rate=0.3, window_s=1000.0,
                                eval_every_s=0.0))
    server.start()
    try:
        ok = server.submit("edge", _frames(1, 0))
        assert ok.result(timeout=120).shape == (1, 16, 16, 1)
        doomed = server.submit("edge", _frames(1, 1), deadline_ms=50.0)
        with pytest.raises(serve.DeadlineExceeded):
            doomed.result(timeout=120)
    finally:
        server.stop()
    assert counter.get() == n0 + 1
    stats = server.stats()
    assert stats["flight"]["dumps"] == 1
    assert stats["flight"]["last_reason"] == "slo:edge:shed_rate"
    assert stats["programs"]["edge"]["slo"]["breaches"]["shed_rate"] == 1
    dumps = server.flight_dumps()
    assert check_trace.flight_check(dumps[0]["path"],
                                    require_trigger=True) == []
    events = json.loads(Path(dumps[0]["path"]).read_text())["traceEvents"]
    assert any(e["name"] == "serve.request.device" for e in events)
    logged = [r for r in server.log.recent()
              if r["event"] == "serve.slo.breach"]
    assert logged and logged[0]["objective"] == "shed_rate"
    assert "slo edge:" in serve.format_stats(stats)


def test_p99_breach_on_a_tight_slo(flight, edge, check_trace, tmp_path):
    """``SLO(p99_ms=0.001, min_count=1)``, as the card's smoke registers
    it: the first answered request breaches."""
    server = serve.Server(serve.ServeConfig(max_batch=2, device="cpu"))
    server.register("edge", edge, CPU,
                    slo=obs.SLO(p99_ms=0.001, min_count=1))
    server.start()
    try:
        server.submit("edge", _frames(2, 3)).result(timeout=120)
    finally:
        server.stop()
    (dump,) = server.flight_dumps()
    assert dump["reason"] == "slo:edge:p99_ms" and dump["path"] is None
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump["dump"]))
    assert check_trace.flight_check(str(path), require_trigger=True) == []


def test_worker_error_dumps_flight_with_history(flight, edge, tmp_path,
                                                check_trace):
    calls = []

    def execute(program, device, frames, bucket, default):
        calls.append(bucket)
        if len(calls) >= 2:
            raise ValueError("injected device fault")
        return default()

    server = serve.Server(serve.ServeConfig(
        max_batch=2, max_wait_ms=0.0, device="cpu",
        flight_dump_dir=str(tmp_path)), hooks=serve.Hooks(execute=execute))
    server.register("edge", edge, CPU)
    server.start()
    try:
        assert server.submit("edge", _frames(1, 0)).result(
            timeout=120).shape == (1, 16, 16, 1)
        with pytest.raises(serve.WorkerError, match="injected"):
            server.submit("edge", _frames(1, 1)).result(timeout=120)
    finally:
        server.stop()
    stats = server.stats()
    assert stats["flight"]["last_reason"] == "worker_error:edge"
    assert stats["programs"]["edge"]["requests"]["failed"] == 1
    (dump,) = server.flight_dumps()
    assert check_trace.flight_check(dump["path"], require_trigger=True) == []
    events = json.loads(Path(dump["path"]).read_text())["traceEvents"]
    trigger = min(e["ts"] for e in events if e["name"] == "flight.trigger")
    assert any(e["ph"] == "X" and e["ts"] + e["dur"] <= trigger
               and e["name"].startswith("serve.request.") for e in events)
    assert any(e["name"] == "serve.pool.failure" for e in events)
    assert any(r["event"] == "serve.worker.failure"
               for r in server.log.recent())


def test_stop_timeout_stranding_triggers_dump(flight, edge):
    gate, entered = threading.Event(), threading.Event()

    def execute(program, device, frames, bucket, default):
        entered.set()
        assert gate.wait(30)
        return default()

    server = serve.Server(serve.ServeConfig(max_batch=4, max_wait_ms=0.0,
                                            device="cpu"),
                          hooks=serve.Hooks(execute=execute))
    server.register("edge", edge, CPU)
    server.start()
    try:
        fut = server.submit("edge", _frames(1, 0))
        assert entered.wait(30)
        server.stop(drain=False, timeout=0.2)
        with pytest.raises(serve.ServerClosed):
            fut.result(timeout=30)
        assert server.stats()["flight"]["last_reason"] == "stop_timeout"
        assert len(server.flight_dumps()) == 1
        assert any(r["event"] == "serve.stop.stranded"
                   for r in server.log.recent())
    finally:
        gate.set()


def test_dump_rate_limit_and_keep(flight, edge):
    clk = serve.VirtualClock()
    server = serve.Server(serve.ServeConfig(
        device="cpu", flight_dump_interval_s=30.0, flight_dump_keep=2),
        clock=clk)
    server.register("edge", edge, CPU)
    assert server._flight_dump("first") is not None
    assert server._flight_dump("too_soon") is None
    for reason in ("second", "third"):
        clk.advance(31.0)
        assert server._flight_dump(reason) is not None
    st = server.stats()["flight"]
    assert st["dumps"] == 3 and st["suppressed"] == 1
    assert [d["reason"] for d in server.flight_dumps()] == ["second",
                                                            "third"]
    assert [d["reason"] for d in st["retained"]] == ["second", "third"]
    assert st["recorder"]["capacity"] == 512
    prev = obs.uninstall()
    try:
        clk.advance(31.0)
        assert server._flight_dump("no recorder") is None
    finally:
        obs.install(prev)


def test_config_validation():
    for kw, msg in ((dict(admin_port=70000), "admin_port"),
                    (dict(flight_dump_interval_s=-1.0),
                     "flight_dump_interval_s"),
                    (dict(flight_dump_keep=0), "flight_dump_keep")):
        with pytest.raises(ValueError, match=msg):
            serve.ServeConfig(device="cpu", **kw)


# -- the admin endpoint ------------------------------------------------------

@pytest.fixture()
def admin_server(flight, edge, tmp_path):
    server = serve.Server(serve.ServeConfig(
        max_batch=4, admin_port=0, device="cpu",
        log_path=str(tmp_path / "serve.jsonl")))
    server.register("edge", edge, CPU, slo=obs.SLO(p99_ms=60_000.0))
    # never sees traffic: its latency stays {"count": 0} through /statusz
    server.register("idle", Program.from_pipeline("sharpen", 16, 16, 3), CPU)
    server.start()
    try:
        yield server
    finally:
        server.stop()


def test_admin_routes(admin_server):
    url = admin_server.admin.url
    assert url.startswith("http://127.0.0.1:")
    out = admin_server.submit("edge", _frames(1, 0)).result(timeout=120)
    assert out.shape == (1, 16, 16, 1)

    health = json.loads(_get(url + "/healthz"))
    assert health["healthy"] and health["checks"]["pool_workers"] == 1
    ready = json.loads(_get(url + "/readyz"))
    assert ready["ready"] and ready["checks"]["warmed"]

    metrics = _get(url + "/metrics").decode()
    assert "# HELP serve_edge_served repro metric 'serve.edge.served'" \
        in metrics
    assert "serve_edge_served 1" in metrics
    assert "serve_idle_served 0" in metrics
    assert "serve_pool_device0_batches" in metrics
    assert "plan_cache_" in metrics

    status = json.loads(_get(url + "/statusz"))
    assert status["programs"]["edge"]["requests"]["served"] == 1
    assert status["programs"]["edge"]["slo"]["objectives"]["p99_ms"][
        "limit"] == 60_000.0
    assert "fused_segments" in status["programs"]["edge"]
    assert status["programs"]["idle"]["latency_ms"] == {"count": 0}
    assert "conv_dispatch" in status and "obs" in status
    assert any(r["event"] == "serve.start" for r in status["log_tail"])

    text = _get(url + "/statusz?format=text").decode()
    assert "edge" in text and "flight:" in text

    dump = json.loads(_get(url + "/tracez"))
    assert dump["otherData"]["reason"] == "tracez"
    assert any(e.get("name") == "serve.request.device"
               for e in dump["traceEvents"])
    _get(url + "/nonsense", expect=404)


def test_tracez_503_without_recorder(admin_server):
    prev = obs.uninstall()
    try:
        body = json.loads(_get(admin_server.admin.url + "/tracez",
                               expect=503))
        assert "no flight recorder" in body["error"]
    finally:
        obs.install(prev)


def test_admin_stops_last_and_the_thread_joins(flight, edge):
    server = serve.Server(serve.ServeConfig(admin_port=0, device="cpu"))
    server.register("edge", edge, CPU)
    server.start()
    admin = server.admin
    server.stop()
    assert not admin._thread.is_alive()
    with pytest.raises(OSError):
        urllib.request.urlopen(admin.url + "/healthz", timeout=5)
    assert not server.health()["healthy"]


def test_healthz_flips_when_the_pool_loses_a_worker(flight, edge):
    class KillWorker(BaseException):
        pass

    armed = threading.Event()

    def execute(program, device, frames, bucket, default):
        if armed.is_set():
            raise KillWorker()
        return default()

    server = serve.Server(serve.ServeConfig(max_batch=2, max_wait_ms=0.0,
                                            admin_port=0, device="cpu"),
                          hooks=serve.Hooks(execute=execute))
    server.register("edge", edge, CPU)
    prev_hook = threading.excepthook
    threading.excepthook = lambda a: None     # the worker's death is quiet
    try:
        server.start()
        url = server.admin.url
        _get(url + "/healthz", expect=200)
        armed.set()
        server.submit("edge", _frames(1, 0))
        t0 = time.monotonic()
        while server._pool.healthy():
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        h = server.health()
        assert not h["healthy"] and h["checks"]["pool_workers"] == 0
        assert json.loads(_get(url + "/healthz", expect=503))[
            "healthy"] is False
        _get(url + "/readyz", expect=503)
    finally:
        threading.excepthook = prev_hook
        server.stop(drain=False, timeout=1.0)


def test_readiness_needs_warm(flight, edge):
    server = serve.Server(serve.ServeConfig(device="cpu"))
    server.register("edge", edge, CPU)
    server.start(warm=False)
    try:
        r = server.readiness()
        assert r["checks"]["warmed"] is False and not r["ready"]
    finally:
        server.stop()


# -- answers do not depend on the recorder or the trace ----------------------

def test_answers_bitwise_equal_recorder_off_on_and_traced(edge):
    lenet = Program.from_model("lenet")
    reqs = [("edge", _frames(n, 20 + n)) for n in (1, 3, 2)] + \
        [("lenet", _frames(n, 30 + n, (28, 28, 1))) for n in (2, 1, 5)]
    prev = obs.get_flight()

    def serve_all():
        server = serve.Server(serve.ServeConfig(max_batch=4, device="cpu",
                                                devices=2))
        server.register("edge", edge, CPU)
        server.register("lenet", lenet, CPU)
        server.start()
        try:
            futs = [server.submit(name, f) for name, f in reqs]
            return [np.asarray(f.result(timeout=120)) for f in futs]
        finally:
            server.stop()
    try:
        obs.uninstall()
        off = serve_all()
        obs.install(obs.FlightRecorder(capacity=64))
        on = serve_all()
        trace = obs.enable()
        try:
            traced = serve_all()
        finally:
            obs.disable()
    finally:
        obs.install(prev)
    assert trace.spans("serve.request.device")
    for a, b, c in zip(off, on, traced):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
