"""chip_smoke.py's reading of profiler traces, on synthetic Chrome traces.

Device events are attributed to a host range by the CUPTI correlation id
of the runtime call that issued them, not by timestamp: a kernel whose
device clock reads outside the range still counts, and a kernel issued
from another range does not.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 2, "args": {"correlation": corr}}


def _device(cat, name, corr, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _timing_trace(smoke):
    port = "void (anonymous namespace)::conv_dense_kernel<3, 8, 1>(float*)"
    torch_op = "void at::native::vectorized_elementwise_kernel<4>(int)"
    return [
        _range(smoke.DEVICE_RANGE + "conv_strip", 100, 100),
        _launch(1, 110), _launch(2, 120),
        # the device clock runs ahead of the host's: outside the range
        _device("kernel", port, 1, 5000, 40),
        _device("kernel", torch_op, 2, 5050, 20),
        _range(smoke.DEVICE_RANGE + "ca_pool", 300, 50),
        _launch(3, 310),
        _device("kernel", "(anonymous namespace)::ca_gray_kernel(float*)", 3,
                150, 10),
    ]


def _serve_trace(smoke):
    port = "void (anonymous namespace)::mvm_skinny_kernel<4>(signed char*)"
    torch_op = "void at::native::reduce_kernel<128, 4>(float*)"
    return [
        _range(smoke.SERVE_WINDOW, 0, 1000),
        _launch(7, 10), _launch(8, 20), _launch(9, 30),
        _device("gpu_memcpy", "Memcpy HtoD", 7, 100, 200),
        _device("kernel", port, 8, 250, 100),       # overlaps the copy
        _device("kernel", torch_op, 9, 600, 100),
        _launch(10, 2000),                           # after the window
        _device("kernel", port, 10, 700, 50),
    ]


def test_busy_share_counts_the_window_calls_by_correlation(smoke):
    got = smoke.busy_share(_serve_trace(smoke))
    assert got["window_ms"] == pytest.approx(1.0)
    # copy 100-300 and kernel 250-350 overlap: busy 250 us + 100 us
    assert got["busy_ms"] == pytest.approx(0.35)
    assert got["busy_share"] == pytest.approx(0.35)
    assert got["device_ms_by_kind"] == pytest.approx(
        {"gpu_memcpy": 0.2, "port kernels": 0.1, "torch ops": 0.1})


def test_reread_attributes_kernels_by_correlation(smoke, tmp_path):
    for name, events in ((smoke.DEVICE_TRACE, _timing_trace(smoke)),
                         (smoke.SERVE_TRACE, _serve_trace(smoke))):
        (tmp_path / name).write_text(json.dumps({"traceEvents": events}))
    got = smoke.reread(str(tmp_path))
    per_batch = 1e-3 / smoke.DEVICE_ITERS         # 1 us of one range
    strip = got["device_time"]["conv_strip"]
    assert (strip["launches"], strip["kernel_records"]) == (2, 2)
    assert strip["ms_per_batch"] == pytest.approx({
        "conv_dense_kernel<3, 8, 1>": 40 * per_batch,
        "at::native::vectorized_elementwise_kernel<4>": 20 * per_batch})
    ca = got["device_time"]["ca_pool"]
    assert ca["ms_per_batch"] == pytest.approx(
        {"ca_gray_kernel": 10 * per_batch})
    assert got["imaging_busy_share"]["busy_ms"] == pytest.approx(0.35)


def test_reread_reads_the_bound_windows_where_the_run_left_them(smoke,
                                                               tmp_path):
    for name, events in ((smoke.DEVICE_TRACE, _timing_trace(smoke)),
                         (smoke.SERVE_TRACE, _serve_trace(smoke))):
        (tmp_path / name).write_text(json.dumps({"traceEvents": events}))
    assert set(smoke.reread(str(tmp_path))) == {"device_time",
                                                "imaging_busy_share"}
    for name in (smoke.BOUND_SERVE_TRACE, smoke.VGG16_TRACE):
        (tmp_path / name).write_text(
            json.dumps({"traceEvents": _serve_trace(smoke)}))
    got = smoke.reread(str(tmp_path))
    for key in ("imaging_bound_busy_share", "vgg16_bound_busy_share"):
        assert got[key] == got["imaging_busy_share"]
        assert "torch_ops_by_name" in got[key]


def test_busy_share_names_the_torch_ops_and_the_epilogue(smoke):
    quant = ("void (anonymous namespace)::epi_quant_kernel<4, true>"
             "((anonymous namespace)::Epi, (anonymous namespace)::Quant)")
    reduce = ("void (anonymous namespace)::epi_reduce_kernel<1>"
              "((anonymous namespace)::Epi)")
    add = ("void at::native::vectorized_elementwise_kernel<4, "
           "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, "
           "3> >(int, at::native::CUDAFunctor_add<float>, "
           "at::detail::Array<char*, 3>)")
    trace = [_range(smoke.SERVE_WINDOW, 0, 1000)]
    for i, (name, dur) in enumerate([(quant, 30), (reduce, 20)] +
                                    [(add, 10)] * 3 + [
            (f"void at::native::op{j}_kernel(float*)", 9 - j)
            for j in range(9)]):
        trace += [_launch(i, 10 + i), _device("kernel", name, i, 100 + 40 * i,
                                              dur)]
    got = smoke.busy_share(trace)
    assert got["port_kernel_ms"] == pytest.approx({"epilogue": 0.05})
    ops = got["torch_ops_by_name"]
    assert len(ops) == 8 and got["torch_op_launches"] == 12
    assert ops[0]["name"] == ("vectorized_elementwise_kernel<4, "
                              "CUDAFunctor_add<float>, Array<char*, 3> >")
    assert (ops[0]["launches"], ops[0]["ms"]) == (3, pytest.approx(0.03))
    assert [o["name"] for o in ops[1:]] == [f"op{j}_kernel"
                                            for j in range(7)]
