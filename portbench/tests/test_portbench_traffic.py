"""The load loops on fake servers: the open loop times each request from
its due time (a stall shows in the tail), the closed loop keeps one
request a client outstanding and counts the window's frames."""

import threading
import time
from concurrent.futures import Future

import numpy as np

from portbench.traffic import loops


class FakeServer:
    """Answers each request after ``service_s`` on one worker thread;
    ``submit`` itself blocks for ``stall_s`` on request ``stall_at`` (as a
    server under backpressure would)."""

    def __init__(self, service_s=0.001, stall_at=None, stall_s=0.0):
        self.service_s, self.stall_at, self.stall_s = \
            service_s, stall_at, stall_s
        self.n = 0
        self.inflight = 0
        self.most_inflight = 0
        self.lock = threading.Lock()

    def submit(self, frames):
        with self.lock:
            k = self.n
            self.n += 1
            self.inflight += 1
            self.most_inflight = max(self.most_inflight, self.inflight)
        if k == self.stall_at:
            time.sleep(self.stall_s)
        fut = Future()

        def answer():
            time.sleep(self.service_s)
            with self.lock:
                self.inflight -= 1
            fut.set_result(frames.sum(axis=(1, 2, 3))[:, None])
        threading.Thread(target=answer).start()
        return fut


PAYLOADS = [np.full((n, 2, 2, 1), float(i), np.float32)
            for i, n in enumerate((1, 2, 3, 4))]


def test_open_loop_times_requests_from_their_due_time():
    rate, lead, window, stall = 200.0, 0.05, 0.6, 0.15
    offsets = np.arange(1, int(rate * (lead + window)) + 1) / rate
    server = FakeServer(stall_at=40, stall_s=stall)
    out = loops.open_loop(server.submit, PAYLOADS, offsets,
                          np.arange(len(offsets)) % 4, lead, window,
                          keep=5, seed=1)
    lat = out.latencies_ms()
    assert np.isfinite(lat).all() and len(lat) == out.in_window().sum()
    # the requests due while submit was stalled waited for it: from their
    # due times the wait shows; from their submit times it would not
    due = out.due[out.in_window()]
    sent = out.sent[out.in_window()]
    late = (sent - due) * 1e3
    assert late.max() > 0.8 * stall * 1e3
    assert lat.max() >= late.max()
    from_sent = (out.done[out.in_window()] - sent) * 1e3
    assert np.percentile(lat, 95) > np.percentile(from_sent, 95) + 20.0
    assert len(out.sample) == 5
    for k, pay, answer in out.sample:
        assert answer.shape == (len(PAYLOADS[pay]), 1)
        assert np.all(answer == PAYLOADS[pay].sum(axis=(1, 2, 3))[:, None])


def test_open_loop_counts_a_refusal_as_failed():
    calls = []

    def submit(frames):
        calls.append(len(frames))
        if len(calls) % 3 == 0:
            raise RuntimeError("queue full")
        fut = Future()
        fut.set_result(frames)
        return fut

    offsets = np.arange(1, 61) / 100.0
    out = loops.open_loop(submit, PAYLOADS, offsets, np.zeros(60, int),
                          0.0, 0.6, keep=2, seed=0,
                          refused=(RuntimeError,))
    lat = out.latencies_ms()
    assert np.isinf(lat).sum() == len(calls) // 3
    assert (~out.ok[out.in_window()]).sum() == len(calls) // 3


def test_closed_loop_keeps_one_request_a_client_outstanding():
    server = FakeServer(service_s=0.005)
    out = loops.closed_loop(server.submit, PAYLOADS, [3, 1, 0, 2],
                            clients=3, lead_s=0.05, window_s=0.3, keep=4,
                            seed=2)
    assert server.most_inflight == 3
    assert out.ok.all() and np.isfinite(out.done).all()
    in_window = (out.done >= out.t0) & (out.done < out.t1)
    assert out.frames_answered() == out.frames[in_window].sum() > 0
    assert list(out.payload[:4]) == [3, 1, 0, 2]
    assert len(out.sample) == 4


def test_open_schedule_gives_every_seed_the_same_work():
    o1, s1, _ = loops.open_schedule(500.0, 2.0, [1, 2, 3, 4, 5, 6, 7, 8], 1)
    o2, s2, _ = loops.open_schedule(500.0, 2.0, [1, 2, 3, 4, 5, 6, 7, 8],
                                    2**35 + 1)
    assert np.allclose(np.sort(np.diff(o1, prepend=0)),
                       np.sort(np.diff(o2, prepend=0)))
    assert np.isclose(o1[-1], o2[-1])
    assert sorted(s1) == sorted(s2) and list(s1) != list(s2)
    assert abs(o1[-1] - 2.0) < 0.05
