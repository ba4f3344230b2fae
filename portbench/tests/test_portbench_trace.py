"""The trace reductions and the per-layer metrics' arithmetic on a
synthetic device trace: the busy union, the idle gaps, the batches by
their frame copies, the roofline shares, ``step_mfu`` and the torch ops'
time a frame."""

import numpy as np
import pytest

from portbench import manifest, work
from portbench.harness import Run
from portbench.trace import WINDOW, DeviceTrace, short_name
from portbench.traffic.loops import Outcome

CFG = {"input_hwc": [4, 4, 1],
       "layers": [{"kind": "conv", "name": "c1", "c_in": 1, "c_out": 2,
                   "kernel": 3, "stride": 1, "padding": "SAME",
                   "act": "relu", "pool": None},
                  {"kind": "flatten"},
                  {"kind": "dense", "name": "d1", "fan_in": 32,
                   "fan_out": 3, "act": "none"}]}
FRAME_BYTES = 4 * 4 * 1 * 4
PEAKS = {"int8_ops_per_s": 1e9, "hbm_bytes_per_s": 1e8}
INT = "void (anonymous namespace)::conv_igemm_wgmma_kernel<64>(Igemm)"
MVM = "void (anonymous namespace)::mvm_stream_kernel<1>(Mvm)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, Add>(int, Add)"


def ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def batch(t, frames):
    """One batch from t (µs): copy in, the int conv, a torch op, the mvm,
    copy out: 10 + 100 + 20 + 50 + 10 µs, back to back."""
    return [ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t, 10,
               bytes=frames * FRAME_BYTES),
            ev(INT, "kernel", t + 10, 100),
            ev(TORCH, "kernel", t + 110, 20),
            ev(MVM, "kernel", t + 130, 50),
            ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", t + 180, 10,
               bytes=64)]


def events():
    out = [ev(WINDOW, "user_annotation", 1000, 1000),
           ev("cudaGraphLaunch", "cuda_runtime", 1150, 5),
           ev(INT, "kernel", 900, 120)]            # starts before the window
    for t, frames in ((1100, 2), (1400, 4), (1700, 4)):
        out += batch(t, frames)
    out.append(ev(MVM, "kernel", 1990, 30))       # runs past the window
    out.append(ev(TORCH, "kernel", 2500, 10))     # after the window
    return out


def test_busy_union_and_idle_gaps_are_clipped_to_the_window():
    tr = DeviceTrace(events())
    assert tr.window_s == pytest.approx(1e-3)
    # 900..1020, 1100..1290, 1400..1590, 1700..1890, 1990..2000
    assert tr.busy_s() == pytest.approx((20 + 190 * 3 + 10) / 1e6)
    assert tr.idle_gaps() == [(1020, 1100), (1290, 1400), (1590, 1700),
                              (1890, 1990)]
    idle = tr.idle_by_host()
    assert sum(v for _, v in idle) == pytest.approx((1000 - 600) / 1e6)
    assert idle[0][0] == "host: cudaGraphLaunch"


def test_batches_run_from_one_frame_copy_to_the_next():
    tr = DeviceTrace(events())
    got = tr.batches(FRAME_BYTES)
    assert [b for b, _ in got] == [2, 4]          # the last one is cut off
    assert [len(evs) for _, evs in got] == [5, 5]
    assert tr.kernel_seconds(r"conv_igemm", got[0][1]) == \
        pytest.approx(100e-6)
    assert tr.kernel_seconds(r"conv_igemm", []) == 0.0
    ops = tr.device_ops()
    assert ops[0] == ["conv_igemm_wgmma_kernel<64>", pytest.approx(320e-6)]
    assert short_name(TORCH) == "vectorized_elementwise_kernel<4, Add>"


def _run(trace=None, frames=40, window=(0.0, 2.0), profiled=(0.45, 1.45)):
    n = 10
    done = np.linspace(0.1, 1.9, n)
    outcome = Outcome(t0=window[0], t1=window[1], due=done - 0.05,
                      sent=done - 0.05, done=done, ok=np.ones(n, bool),
                      refused=np.zeros(n, bool), frames=np.full(n, frames // n), payload=np.zeros(n))
    return Run(CFG, 12.5, outcome, (36, 40),
               {"c1": "conv_strip_int", "d1": "photonic_mvm"}, FRAME_BYTES,
               PEAKS, trace, profiled, [])


def test_roofline_share_is_least_time_over_device_time():
    run = _run(DeviceTrace(events()))
    conv, dense = work.layers(CFG)
    assert (conv.m, conv.k, conv.n) == (16, 9, 2)
    assert (dense.m, dense.k, dense.n) == (1, 32, 3)

    def least(layer, b, im2col=False):
        ops = 2 * layer.m * layer.k * layer.n * b
        inputs = (layer.m * layer.k if im2col else layer.in_bytes) * b
        nbytes = inputs + layer.k * layer.n + layer.out_bytes * b
        return max(ops / 1e9, nbytes / 1e8)

    share = manifest.reader("conv_strip_int_roofline")(run)
    assert share == pytest.approx(
        100 * (least(conv, 2) + least(conv, 4)) / 200e-6)
    share = manifest.reader("photonic_mvm_roofline")(run)
    assert share == pytest.approx(
        100 * (least(dense, 2, True) + least(dense, 4, True)) / 100e-6)
    assert manifest.reader("conv_strip_int_roofline")(_run()) is None


def test_step_mfu_torch_ops_idle_and_fill():
    run = _run(DeviceTrace(events()))
    ops = 2 * (16 * 9 * 2 + 32 * 3)
    # the profiled [0.45, 1.45) left out: 5 requests of 4 frames in 1 s
    assert manifest.reader("step_mfu")(run) == pytest.approx(
        100 * ops * 20 / 1.0 / 1e9)
    # torch ops in the window: 3 x 20 µs; frames answered in [0.45, 1.45):
    # 5 requests of 4
    assert manifest.reader("torch_ops_us_per_frame")(run) == \
        pytest.approx(60.0 / 20)
    assert manifest.reader("idle_share.closed")(run) == pytest.approx(40.0)
    assert manifest.reader("batch_fill.closed")(run) == pytest.approx(0.9)
    assert manifest.reader("frames_per_s")(run) == pytest.approx(20.0)
    assert manifest.reader("setup_s")(run) == 12.5


def test_queue_wait_median_reads_the_windows_spans():
    run = _run()
    run.spans = [{"name": "serve.request.queue_wait", "t0_ns": int(t * 1e9),
                  "t1_ns": int(t * 1e9) + int(w * 1e6)}
                 for t, w in ((0.5, 1.0), (0.7, 3.0), (1.0, 2.0),
                              (2.5, 50.0))]
    assert manifest.reader("queue_wait_p50_ms.open")(run) == \
        pytest.approx(2.0)


def test_p95_counts_a_failed_request_as_the_longest_wait():
    run = _run()
    run.outcome.ok[:] = True
    run.outcome.ok[-1] = False
    p95 = manifest.reader("p95_ms")(run)
    lat = np.full(10, 50.0)
    lat[-1] = (2.0 + 60.0) * 1e3
    assert p95 == pytest.approx(np.percentile(lat, 95))
