"""One run of one cell, start to result line.

1. Set-up: the weights on the device and the frames from ``--seed``; the
   program compiled, registered on ``repro_torch.serve.Server`` with the
   configuration's ``ServeConfig`` (bound views: their own stream, a
   pinned staging ring, one CUDA graph per bucket, captured while the
   server starts), and a lead-in of the cell's own traffic.
2. The measured window: the cell's loop for ``--seconds`` (with
   ``--trace 1``, ``torch.profiler`` over a steady part of it and the
   program's request spans on).
3. The window closed: the peak memory read, the server stopped, its
   state freed; then a seeded sample of the answered requests held
   against the plain reference (``reference/cnn.py``). ``run.py`` then
   refuses to print a result while a JAX module is loaded.
4. The result: the cell's metrics, each by its reader in ``metrics/``.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import manifest, model, work
from portbench.reference.cnn import Reference
from portbench.trace import DeviceTrace, Profiler
from portbench.traffic import loops

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROGRAM = "cell"                # the name the program is served under
TRACE_DIR = Path("build") / "portbench"


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def program_families(plan) -> Dict[str, str]:
    """Which kernel family each conv and dense layer of the compiled plan
    runs on: ``conv_strip_int`` (a dense conv on the int8 strip route),
    ``conv_strip`` (another strip conv), ``photonic_mvm`` (a resident conv
    through im2col, a dense layer)."""
    out = {}
    for step in plan.steps:
        name = getattr(step, "name", None)
        if name is None:
            continue
        strategy = getattr(step, "strategy", None)
        if strategy is None:
            out[name] = "photonic_mvm"
        elif plan.strip_routes.get(name) == "int":
            out[name] = "conv_strip_int"
        elif strategy.kind == "strip":
            out[name] = "conv_strip"
        else:
            out[name] = "photonic_mvm"
    return out


class Session:
    """A cell's set-up: weights, frames, the served program, payloads."""

    def __init__(self, cfg: Dict, wl: Dict, seed: int, device: str):
        from repro_torch import Options
        from repro_torch.core.quant import WASpec
        from repro_torch.serve import ServeConfig, Server
        self.cfg, self.wl, self.seed = cfg, wl, seed
        self.device = torch.device(device)
        self.steps: Dict[str, float] = {}
        t = time.perf_counter()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(model.torch_seed(seed))
        self.params = model.make_weights(cfg, gen, self.device)
        self.pool = model.make_frames(cfg, wl["pool"], gen, self.device)
        self.steps["weights_and_frames_s"] = time.perf_counter() - t
        t = time.perf_counter()
        serve = dict(cfg["serve"])
        serve["batch_buckets"] = tuple(serve["batch_buckets"])
        self.server = Server(ServeConfig(device=device, devices=1, **serve))
        scheme = cfg["scheme"]
        self.hosted = self.server.register(
            PROGRAM, model.make_program(cfg, self.params),
            options=Options(device=device,
                            scheme=WASpec(scheme["w_bits"], scheme["a_bits"])))
        self.steps["compile_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.server.start()
        self.steps["bind_and_capture_s"] = time.perf_counter() - t
        self.families = program_families(self.hosted.executable.plan)
        self.frame_bytes = int(np.prod(cfg["input_hwc"])) * 4
        self.payloads: List[np.ndarray] = []

    def payload(self, offset: int, size: int) -> np.ndarray:
        """``size`` pool entries from ``offset`` as one request's frames
        (a view of the pool)."""
        x = self.pool[offset:offset + size]
        return x.reshape((-1,) + tuple(self.cfg["input_hwc"]))

    def submit(self, block: bool):
        server = self.server

        def submit(frames):
            return server.submit(PROGRAM, frames, block=block)
        return submit

    def window_counts(self) -> Tuple[int, int]:
        """(frames served, bucket slots) so far, from ``Server.stats()``."""
        snap = self.server.stats()["programs"][PROGRAM]
        frames = snap["frames_served"]
        waste = snap["padding_waste"]
        return frames, (round(frames / (1.0 - waste)) if frames else 0)

    def drive(self, seconds: float, t_begin: float,
              rate_rps: Optional[float] = None) -> loops.Outcome:
        """The cell's loop from ``t_begin``: the lead-in, then ``seconds``
        measured."""
        wl, seed = self.wl, model.torch_seed(self.seed)
        rng = np.random.default_rng(seed)
        lead = float(wl["lead_s"])
        if wl["loop"] == "closed":
            size = int(wl["sizes"][0])
            payloads = [self.payload(o, size) for o in
                        range(0, len(self.pool) - size + 1, size)]
            order = rng.permutation(len(payloads))
            self.payloads = payloads
            return loops.closed_loop(
                self.submit(block=True), payloads, order, wl["clients"],
                lead, seconds, wl["check_requests"], seed, t_begin=t_begin)
        from repro_torch.serve import AdmissionError
        rate = float(rate_rps if rate_rps is not None else wl["rate_rps"])
        offsets, sizes, rng = loops.open_schedule(rate, lead + seconds,
                                                  wl["sizes"], seed)
        payloads = [self.payload(int(rng.integers(0, len(self.pool) - s + 1)),
                                 int(s)) for s in sizes]
        self.payloads = payloads
        return loops.open_loop(
            self.submit(block=False), payloads, offsets,
            np.arange(len(payloads)), lead, seconds, wl["check_requests"],
            seed, refused=(AdmissionError,), t_begin=t_begin)

    def close(self) -> None:
        """Stop the server and free the program's state (the weights and
        frames, the benchmark's own, stay)."""
        self.server.stop(drain=True, timeout=120.0)
        self.server = self.hosted = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Run:
    """A finished run, as a metric's reader sees it."""

    cfg: Dict
    setup_s: float
    outcome: loops.Outcome
    counts: Tuple[int, int]         # (frames, slots) served in the window
    families: Dict[str, str]
    frame_bytes: int
    peaks: Optional[Dict]
    trace: Optional[DeviceTrace] = None
    profiled: Optional[Tuple[float, float]] = None   # host clock
    spans: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.outcome.t1 - self.outcome.t0

    def frames_per_s(self) -> float:
        return self.outcome.frames_answered() / self.window_s

    def unprofiled_frames_per_s(self) -> float:
        """Frames a second over the window less its profiled part (the
        profiler slows the host)."""
        if self.profiled is None:
            return self.frames_per_s()
        lo, hi = self.profiled
        o = self.outcome
        frames = o.frames_answered(o.t0, lo) + o.frames_answered(hi, o.t1)
        return frames / (self.window_s - (hi - lo))

    def roofline_share(self, family: str, symbols: str,
                       im2col: bool = False) -> Optional[float]:
        """Percent: the family's least time over its measured device time,
        summed over the traced window's whole batches (each batch's
        bucket, padding slots included: the kernels compute them)."""
        if self.trace is None or self.peaks is None:
            return None
        layers = [l for l in work.layers(self.cfg)
                  if self.families.get(l.name) == family]
        if not layers:
            return None
        least = measured = 0.0
        for bucket, events in self.trace.batches(self.frame_bytes):
            t = self.trace.kernel_seconds(symbols, events)
            if t <= 0.0:
                continue
            measured += t
            least += sum(work.least_seconds(l, bucket, self.peaks,
                                            im2col=im2col and l.kind == "conv")
                         for l in layers)
        return 100.0 * least / measured if measured > 0.0 else None


def logit_gap(cfg: Dict, params: Dict, frames: np.ndarray,
              answers: np.ndarray, device: torch.device, block: int
              ) -> float:
    """The largest gap, over ``frames``, of an answer's logit from the
    plain reference's, over the frame's largest reference logit
    (magnitude); the reference runs ``block`` frames at a time."""
    if len(frames) == 0:
        return float("inf")
    ref = Reference(cfg["layers"], params, cfg["scheme"]["w_bits"],
                    cfg["scheme"]["a_bits"])
    gaps = []
    for lo in range(0, len(frames), block):
        x = torch.from_numpy(frames[lo:lo + block]).to(device)
        r = ref.logits(x).cpu().numpy()
        scale = np.maximum(np.abs(r).max(axis=1), 1e-30)
        gaps.append(np.abs(answers[lo:lo + block] - r).max(axis=1) / scale)
    # a NaN answer reads NaN here, which no limit passes
    return float(np.concatenate(gaps).max())


def limits(cfg: Dict) -> Dict[str, float]:
    """Each number compared, with its limit."""
    return {"logit_gap": float(cfg["check"]["logit_gap"]), "unanswered": 0}


def is_correct(numbers: Dict[str, float], cfg: Dict) -> bool:
    return all(numbers[k] <= v for k, v in limits(cfg).items())


def check(outcome: loops.Outcome, session: Session, block: int
          ) -> Dict[str, float]:
    """The sampled answers against the plain reference -> the numbers
    compared: ``logit_gap`` (see ``logit_gap``) and ``unanswered``,
    requests of the window that got no answer or an error (a refusal is
    not one)."""
    sent = outcome.in_window() & ~outcome.refused
    unanswered = int((sent & ~outcome.ok).sum())
    frames = np.concatenate([session.payloads[p]
                             for _, p, _ in outcome.sample]) \
        if outcome.sample else np.zeros((0,))
    answers = np.concatenate([a for _, _, a in outcome.sample]) \
        if outcome.sample else np.zeros((0,))
    return {"logit_gap": logit_gap(session.cfg, session.params, frames,
                                   answers, session.device, block),
            "unanswered": unanswered, "frames_compared": int(len(frames))}


class _Snapshots(threading.Thread):
    """Calls ``fn`` at each of ``times`` (``perf_counter`` seconds) and
    keeps what it returns."""

    def __init__(self, times, fn):
        super().__init__(name="portbench-snapshots")
        self.times, self.fn, self.values = times, fn, []

    def run(self) -> None:
        for t in self.times:
            time.sleep(max(t - time.perf_counter(), 0.0))
            self.values.append(self.fn())


def card(device: torch.device) -> Dict:
    """The device's platform, name and count."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def _drive(session: Session, seconds: float, t_begin: float,
           prof: Optional[Profiler]) -> loops.Outcome:
    """The cell's loop; under ``prof``, on a thread of its own while the
    profiler runs in this one."""
    if prof is None:
        return session.drive(seconds, t_begin)
    box = {}

    def drive():
        try:
            box["outcome"] = session.drive(seconds, t_begin)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            box["error"] = e
    loop = threading.Thread(target=drive, name="portbench-loop")
    loop.start()
    try:
        prof.run()
    finally:
        loop.join()
    if "error" in box:
        raise box["error"]
    return box["outcome"]


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        root: Path = manifest.ROOT, device: str = "cuda",
        cfg: Optional[Dict] = None, wl: Optional[Dict] = None,
        t_start: Optional[float] = None) -> Dict:
    """One run of ``cell_name`` -> the result line's object. ``cfg`` and
    ``wl`` replace the cell's files (the tests' small sizes)."""
    from repro_torch import obs
    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest.load(root)
    cell = manifest.cell(bench, cell_name)
    cfg = cfg if cfg is not None else manifest.config(cell["config"], root)
    wl = wl if wl is not None else manifest.workload(cell_name, root)
    dev = torch.device(device)
    t_imports = time.perf_counter()
    info = card(dev)
    t_card = time.perf_counter()
    section = "per_layer" if trace else "end_to_end"
    wanted = manifest.metrics_of(bench, section, cell_name)
    # the program's request spans only where a metric reads them
    spans_read = any(m["source"] == "program_span" for m in wanted)
    if spans_read:
        obs.enable()
    session = Session(cfg, wl, seed, device)
    prof = None
    if trace and dev.type == "cuda":
        prof = Profiler(min(float(wl["trace_s"]), seconds / 2))
        prof.prepare()
    t_begin = time.perf_counter()
    t0 = t_begin + float(wl["lead_s"])
    if prof is not None:
        # the window's last seconds: the profiler's stop holds the
        # interpreter while it collects, and falls after the window
        prof.at = t0 + seconds - prof.seconds
    snaps = _Snapshots((t0, t0 + seconds), session.window_counts)
    snaps.start()
    try:
        outcome = _drive(session, seconds, t_begin, prof)
    finally:
        snaps.join()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    spans = obs.disable().spans() if spans_read else []
    (f0, s0), (f1, s1) = snaps.values
    log(f"set-up {t0 - t_start:.3f} s: imports {t_imports - t_start:.3f}, "
        f"CUDA start and card query {t_card - t_imports:.3f}, " + ", ".join(
            f"{k} {v:.3f}" for k, v in session.steps.items())
        + f", lead-in {wl['lead_s']} s")
    session.close()
    t_check = time.perf_counter()
    numbers = check(outcome, session, int(cfg["check"]["block"]))
    log(f"check: {numbers['frames_compared']} frames against the reference "
        f"in {time.perf_counter() - t_check:.3f} s")
    dtrace = None
    if prof is not None:
        dtrace = prof.export(Path(root) / TRACE_DIR
                             / f"{cell_name}.{seed}.trace.json")
    done = Run(cfg, t0 - t_start, outcome, (f1 - f0, s1 - s0),
               session.families, session.frame_bytes,
               work.peaks_for(info["kind"]) if dev.type == "cuda" else None,
               dtrace, prof.host_window if prof is not None else None, spans)
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"], root)(done)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    in_window = outcome.in_window()
    device_out = {k: info[k] for k in ("platform", "kind", "count")}
    device_out["memory_peak_bytes"] = int(memory)
    result = {"correct": is_correct(numbers, cfg),
              "attempted": int(in_window.sum()),
              "failed": int((in_window & ~outcome.ok).sum()),
              "metrics": metrics, "device": device_out}
    if dtrace is not None:
        device_out["busy_s"] = dtrace.busy_s()
        device_out["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.device_ops(),
                               "idle_gaps": dtrace.idle_by_host()}
    log(f"window: {seconds} s, {result['attempted']} requests, "
        f"{outcome.frames_answered()} frames answered, {f1 - f0} frames "
        f"in {s1 - s0} bucket slots, "
        f"{int(outcome.refused[in_window].sum())} refused")
    result["checks"] = {k: {"value": numbers[k], "limit": v}
                        for k, v in limits(cfg).items()}
    return result
