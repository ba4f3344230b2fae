"""repro_torch.obs against the reference's repro.obs, on the CPU.

The port keeps its own copy of the observability layer; these tests hold
it to the reference, exactly (tolerance: none, every comparison is
equality), on explicit timestamps:

* the same operations on a fresh ``Registry`` give byte-equal Prometheus
  text;
* the same ``add_span`` / ``add_event`` calls give an equal Chrome trace;
* the same puts past a ring's wrap-around give an equal flight dump, and
  it passes ``scripts/check_trace.py``'s ``flight_check``;
* the same observation stream gives the same SLO breaches;
* ``StructuredLog`` records are equal apart from their wall-clock fields;
* the same ``run_padded`` / ``run`` calls move the ``dispatch.conv.*`` and
  ``dispatch.fused.fallback`` counters by the same deltas (the reference
  on its Pallas backend in interpret mode), once per trace family;
* the trace mode: ``Options(trace=)``, ``use_mode`` and the ambient
  ``auto`` (the port reads no environment variable);
* the reference's concurrency lint finds nothing in the port's ``serve``
  and ``obs`` packages.
"""

from __future__ import annotations

import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest

import repro
from repro import obs as jobs
from repro_torch import Options, Program, obs

ROOT = Path(__file__).resolve().parent.parent


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_thread(fn, name="obs-parity"):
    """Run ``fn`` on a fresh named thread (its own flight ring) and return
    its result."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()), name=name)
    t.start()
    t.join(30)
    assert not t.is_alive()
    return out[0]


# -- metrics and the Prometheus text ------------------------------------------

def _drive_registry(mod):
    reg = mod.Registry()
    reg.counter("plan.cache.hit").inc()
    reg.counter("plan.cache.hit").inc(4)
    reg.counter("slo.breach.edge-detect").inc(2)
    reg.counter("9lives").inc()
    g = reg.gauge("serve.lenet.queued_frames")
    g.add(7)
    g.add(-2.5)
    h = reg.histogram("serve.lenet.batch_occupancy")
    for v in (0.1, 0.125, 0.5, 0.99, 1.0, 3.0):
        h.observe(v)
    u = reg.histogram("serve.pool.placement_us", buckets=(50.0, 1.0, 5.0))
    for v in (0.5, 2.0, 7.0, 60.0):
        u.observe(v)
    reg.gauge("serve.pool.device0.busy_s").set(0.25)
    return reg


def test_prometheus_text_byte_equal_to_reference():
    mine = obs.prometheus_text(_drive_registry(obs))
    theirs = jobs.prometheus_text(_drive_registry(jobs))
    assert mine == theirs
    assert "slo_breach_edge_detect 2" in mine and "_9lives 1" in mine


def test_registry_snapshot_and_type_clash_as_reference():
    assert _drive_registry(obs).snapshot() == _drive_registry(jobs).snapshot()
    for mod in (obs, jobs):
        reg = mod.Registry()
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x")


# -- the trace collector ------------------------------------------------------

def _drive_trace(mod):
    t = mod.Trace(name="parity")
    t.t0_ns = 1_000_000
    t.add_span("serve.request.queue_wait", 1_000_500, 1_003_000,
               attrs={"program": "lenet", "frames": 2}, trace_id="lenet/req-0",
               tid=(1 << 20), lane="lenet/req-0")
    t.add_span("serve.device.execute", 1_003_000, 1_009_250,
               attrs={"device": 1, "queued_ms": 0.0}, tid=(1 << 21) + 1,
               lane="device1")
    t.add_event("serve.pool.place", t_ns=1_002_000, attrs={"device": 1},
                tid=7)
    t.add_event("flight.trigger", t_ns=1_010_000, trace_id="lenet/req-0",
                tid=7)
    t.add_span("plan.compile", 1_000_000, 1_000_100, tid=7, parent=None)
    return t


def test_chrome_trace_equal_to_reference():
    mine, theirs = _drive_trace(obs), _drive_trace(jobs)
    assert mine.to_chrome() == theirs.to_chrome()
    assert mine.summary() == theirs.summary()
    assert mine.records() == theirs.records()


def test_span_nesting_and_modes_as_reference():
    """Live spans on one thread nest (a child records its parent's id), an
    event inherits the enclosing span's trace_id, and ``use_mode('off')``
    suppresses recording into a live collector: the same records in both
    packages, timestamps aside."""
    def drive(mod):
        trace = mod.enable(mod.Trace(name="nest"))
        try:
            with mod.span("outer", attrs={"k": 1}, trace_id="t-1"):
                with mod.span("inner"):
                    mod.event("mark")
            with mod.use_mode("off"):
                with mod.span("hidden"):
                    pass
        finally:
            mod.disable()
        return [{k: v for k, v in r.items()
                 if k not in ("t0_ns", "t1_ns", "tid")}
                for r in trace.records()]
    assert _in_thread(lambda: drive(obs)) == _in_thread(lambda: drive(jobs))


def test_trace_modes_and_no_environment(monkeypatch):
    """``auto`` records iff a collector is installed, ``on`` installs one,
    ``off`` records nothing; the port's ambient mode is ``auto`` whatever
    the reference's ``REPRO_TRACE`` variable says."""
    monkeypatch.setenv("REPRO_TRACE", "on")
    assert obs.trace_mode() == "auto"
    assert obs.get_trace() is None and not obs.enabled()
    with pytest.raises(ValueError, match="unknown trace mode"):
        obs.use_mode("loud")
    try:
        with obs.use_mode("on"):
            assert obs.enabled() and obs.get_trace() is not None
        with obs.use_mode("off"):
            assert not obs.enabled()
        assert obs.enabled()                      # auto, collector live
    finally:
        obs.disable()
    assert not obs.enabled()


def test_options_trace_validated_described_and_out_of_the_cache_key():
    with pytest.raises(ValueError, match="unknown trace mode"):
        Options(device="cpu", trace="loud")
    assert Options(device="cpu").resolve().trace == "auto"
    assert "trace=off" in Options(device="cpu", trace="off").describe()
    assert "trace=" not in Options(device="cpu").describe()
    prog = Program.from_pipeline("sharpen", 16, 16, 3)
    a = prog.compile(Options(device="cpu", trace="off"))
    b = prog.compile(Options(device="cpu", trace="on"))
    obs.disable()                                 # "on" installed one
    assert a.plan is b.plan


def test_options_trace_on_records_compile_and_fused_segments():
    """``trace='on'`` pins recording for compile and run: a cache miss's
    ``plan.compile`` span and, in a family's first run, the
    ``plan.trace.fused_segment`` span; ``trace='off'`` records neither
    into a live collector."""
    prog = Program.from_pipeline("edge_detect", 16, 16, 3)
    f = np.random.default_rng(0).random((1, 16, 16, 3)).astype(np.float32)
    trace = obs.enable()
    try:
        exe = prog.compile(Options(device="cpu", trace="off",
                                   act_sram_kb=255.0))
        exe.run_per_frame(f)
        assert trace.records() == []
        exe = prog.compile(Options(device="cpu", trace="on",
                                   act_sram_kb=254.0))
        exe.run_per_frame(f)
        exe.run_per_frame(f)                      # a repeat: no new span
    finally:
        obs.disable()
    assert len(trace.spans("plan.compile")) == 1
    seg = trace.spans("plan.trace.fused_segment")
    assert len(seg) == 1 and seg[0]["attrs"]["names"] == ["grad", "edge_mag"]


# -- the flight recorder ------------------------------------------------------

def _drive_flight(mod):
    rec = mod.FlightRecorder(capacity=8, name="parity")

    def puts():
        for i in range(13):
            rec.record_span(f"s.{i % 3}", 5_000 + 100 * i, 5_050 + 100 * i,
                            trace_id=f"p/req-{i}" if i % 2 else None,
                            attrs={"i": i})
            rec.record_event("e.tick", t_ns=5_060 + 100 * i, attrs={"i": i})
        rec.record_span("serve.request.device", 6_400, 6_500,
                        trace_id="p/req-99", attrs={"device": 0},
                        lane_tid=(1 << 20) + 99, lane="p/req-99")
        rec.record_event("flight.trigger", t_ns=6_600,
                         attrs={"reason": "unit"})
        return rec.dump(reason="unit"), rec.stats()
    return _in_thread(puts)


def test_flight_dump_past_wraparound_equal_and_valid(tmp_path):
    (mine, mstats), (theirs, tstats) = _drive_flight(obs), \
        _drive_flight(jobs)
    ring = {e["args"]["ring"] for e in mine["traceEvents"] if e["ph"] != "M"}
    ring_t = {e["args"]["ring"] for e in theirs["traceEvents"]
              if e["ph"] != "M"}
    # one ring each, of the thread that put; the thread ids differ
    assert len(ring) == 1 and len(ring_t) == 1

    def normal(d, ring_id):
        out = json.loads(json.dumps(d))
        for e in out["traceEvents"]:
            if e["tid"] == ring_id:
                e["tid"] = "RING"
            if "ring" in e["args"]:
                e["args"]["ring"] = "RING"
            if e["ph"] == "M" and e["args"]["name"].startswith("flight:"):
                e["args"]["name"] = "flight:"     # the thread's name
        return out
    assert normal(mine, ring.pop()) == normal(theirs, ring_t.pop())
    assert mine["otherData"]["records"] == 8
    assert mine["otherData"]["dropped_total"] == 20
    mstats.pop("rings"), tstats.pop("rings")
    assert mstats == tstats
    path = tmp_path / "flight.json"
    path.write_text(json.dumps(mine))
    check_trace = _load_script("check_trace")
    assert check_trace.flight_check(str(path), require_trigger=True) == []


def test_flight_recorder_feeds_with_tracing_off_and_switches():
    """The import-time recorder records spans while no collector is
    installed; ``uninstall`` stops it and ``install`` resizes it."""
    prev = obs.get_flight()
    assert prev is not None and prev.capacity == 2048
    try:
        small = obs.install(obs.FlightRecorder(capacity=4))
        with obs.use_mode("off"):
            with obs.span("t.black_box"):
                obs.event("t.instant")
        names = {e["name"] for e in small.dump()["traceEvents"]
                 if e["ph"] != "M"}
        assert {"t.black_box", "t.instant"} <= names
        assert obs.uninstall() is small and obs.get_flight() is None
        assert not obs.recording()
        with pytest.raises(ValueError, match="capacity"):
            obs.FlightRecorder(capacity=0)
    finally:
        obs.install(prev)


# -- SLOs ---------------------------------------------------------------------

def _observe_stream(mod, slo_kw):
    rng = np.random.default_rng(3)
    mon = mod.SLOMonitor("p", mod.SLO(**slo_kw))
    out = []
    t = 0.0
    for _ in range(400):
        t += float(rng.exponential(0.01))
        kind = ("served", "served", "served", "shed", "failed")[
            int(rng.integers(5))]
        lat = float(rng.gamma(2.0, 3.0)) if kind == "served" else None
        out.append(mon.observe(kind, t, latency_ms=lat))
    return out, mon.state(t)


@pytest.mark.parametrize("slo_kw", [
    dict(p99_ms=15.0, window_s=0.5, eval_every_s=0.0),
    dict(max_shed_rate=0.2, max_error_rate=0.2, window_s=1.0, min_count=5),
    dict(p99_ms=30.0, max_shed_rate=0.15, window_s=2.0, eval_every_s=0.1),
])
def test_slo_monitor_breaches_equal_to_reference(slo_kw):
    mine, theirs = _observe_stream(obs, slo_kw), _observe_stream(jobs, slo_kw)
    assert mine == theirs
    assert any(mine[0])                           # the stream does breach


def test_slo_validation_as_reference():
    for kw in ({}, {"p99_ms": -1.0}, {"max_shed_rate": 1.5},
               {"p99_ms": 1.0, "window_s": 0.0}, {"p99_ms": 1.0,
                                                    "min_count": 0}):
        errs = []
        for mod in (obs, jobs):
            with pytest.raises(ValueError) as e:
                mod.SLO(**kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# -- the structured log -------------------------------------------------------

def test_structured_log_records_equal_but_wall_time(tmp_path):
    def drive(mod, path):
        log = mod.StructuredLog(path=path, keep=3)
        log.info("serve.start", programs=["a"])
        with mod.span("x", trace_id="p/req-3"):
            log.warning("serve.slo.breach", objective="p99_ms", value=2.0)
        log.error("serve.worker.failure", trace_id="given", device=1)
        log.info("serve.stop", drain=True)
        with pytest.raises(ValueError, match="unknown log level"):
            log.log("e", level="loud")
        return log
    mine = drive(obs, tmp_path / "mine.jsonl")
    theirs = drive(jobs, tmp_path / "theirs.jsonl")

    def strip(recs):
        return [{k: v for k, v in r.items() if k not in ("ts", "mono_s")}
                for r in recs]
    assert strip(mine.recent()) == strip(theirs.recent())
    assert mine.counts() == theirs.counts()
    assert [r["trace_id"] for r in mine.recent()] == ["p/req-3", "given",
                                                      None]
    lines = [json.loads(ln) for ln in
             (tmp_path / "mine.jsonl").read_text().splitlines()]
    want = [json.loads(ln) for ln in
            (tmp_path / "theirs.jsonl").read_text().splitlines()]
    assert strip(lines) == strip(want) and len(lines) == 4


# -- trace-family counters ----------------------------------------------------

def _dispatch(reg):
    return {k: v for k, v in reg.snapshot().items()
            if k.startswith("dispatch.")}


def _delta(reg, before):
    now = _dispatch(reg)
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("name,make,calls", [
    ("lenet", lambda P: P.from_model("lenet"),
     [("padded", 1), ("padded", 8), ("padded", 8), ("padded", 1),
      ("run", 2), ("run", 2)]),
    ("edge_detect", lambda P: P.from_pipeline("edge_detect", 32, 32, 3),
     [("padded", 1), ("padded", 2), ("padded", 1), ("run", 2)]),
])
def test_dispatch_counter_deltas_equal_to_reference(name, make, calls):
    """The same calls on fresh plans (an ``act_sram_kb`` no other test
    compiles with) move the counters by the same deltas: once per trace
    family (backend, calibration, batch shape), nothing on a repeat."""
    jexe = make(repro.Program).compile(repro.Options(
        backend="pallas", interpret=True, act_sram_kb=257.0))
    texe = make(Program).compile(Options(device="cpu", act_sram_kb=257.0))
    hwc = texe.program.input_hwc
    seen = []
    for kind, b in calls:
        f = np.random.default_rng(b).random((b, *hwc)).astype(np.float32)
        j0, t0 = _dispatch(jobs.REGISTRY), _dispatch(obs.REGISTRY)
        if kind == "padded":
            np.asarray(jexe.run_padded(f, b))
            texe.run_padded(f, b)
        else:
            np.asarray(jexe.run(f))
            texe.run(f)
        want = _delta(jobs.REGISTRY, j0)
        assert _delta(obs.REGISTRY, t0) == want, (name, kind, b)
        seen.append(want)
    assert seen[0] and not seen[2]                # first run counts, repeat not
    assert any("dispatch.fused.fallback" in d for d in seen)


def test_direct_conv_call_counts_every_time():
    """Outside a plan executor every dispatch call counts, as an
    un-jitted call to the reference's does."""
    import torch
    from repro_torch.kernels import dispatch
    x = torch.randint(0, 16, (1, 8, 8, 2)).float()
    w = torch.randint(-7, 8, (3, 3, 2, 4)).float()
    before = _dispatch(obs.REGISTRY)
    for backend in ("kernel", "kernel", "reference"):
        dispatch.conv_int(x, w, 1, ((1, 1), (1, 1)), backend=backend)
    assert _delta(obs.REGISTRY, before) == {"dispatch.conv.resident": 2,
                                            "dispatch.conv.reference": 1}
    with dispatch.repeat_family(True):
        dispatch.conv_int(x, w, 1, ((1, 1), (1, 1)))
    assert _delta(obs.REGISTRY, before)["dispatch.conv.resident"] == 2


def test_bound_cpu_view_counts_once_per_bucket():
    """A bound view's buckets are trace families of their own: warming
    counts each once, and the batches after it count nothing (on the card
    the capture and every replay are those batches:
    ``test_torch_gpu.py::test_trace_time_counters_tick_once_per_bucket``)."""
    prog = Program.from_model("lenet")
    view = prog.compile(Options(device="cpu", act_sram_kb=252.0)).bind("cpu")
    f = np.random.default_rng(0).random((4, 28, 28, 1)).astype(np.float32)
    before = _dispatch(obs.REGISTRY)
    view.warm((1, 2, 4))
    for _ in range(3):
        for b in (1, 2, 4):
            view.run_padded(f[:b], b).wait()
    assert _delta(obs.REGISTRY, before) == {"dispatch.conv.fused": 6}


def test_plan_cache_counters_and_events():
    prog = Program.from_pipeline("sharpen", 16, 16, 3)
    hit0 = obs.counter("plan.cache.hit").get()
    miss0 = obs.counter("plan.cache.miss").get()
    trace = obs.enable()
    try:
        prog.compile(Options(device="cpu", act_sram_kb=253.0))
        prog.compile(Options(device="cpu", act_sram_kb=253.0))
    finally:
        obs.disable()
    assert obs.counter("plan.cache.miss").get() == miss0 + 1
    assert obs.counter("plan.cache.hit").get() == hit0 + 1
    assert len(trace.spans("plan.compile")) == 1
    assert len(trace.events("plan.cache.hit")) == 1


# -- the concurrency lint -----------------------------------------------------

def test_reference_concurrency_lint_finds_nothing_in_serve_and_obs():
    from repro.analysis.lint import lint_paths
    port = ROOT / "src" / "repro_torch"
    findings = lint_paths([port / "serve", port / "obs"])
    assert findings == [], "\n".join(str(d) for d in findings)
