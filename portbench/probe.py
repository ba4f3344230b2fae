"""Where a cell's host time goes: the cell's traffic for ``--seconds``,
with the frames served, each thread's CPU time and the machine's CPU
time (steal included) sampled every ``--every`` seconds, and a
single-thread copy bandwidth read before the set-up and after the
window. Not a benchmark run: it prints no result line and checks no
answers.

    python3 portbench/probe.py --workload vgg16-w4a4.burst8-closed \
        --seed 1 --seconds 30

One JSON line a sample (``wall`` is ``time.time()``, to line it up with
``nvidia-smi``'s timestamps), then a summary line.
"""

import argparse
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TICK = 100.0                # clock ticks a second in /proc


def copy_gbps(nbytes: int = 19 << 20, seconds: float = 1.0) -> float:
    """One thread copying an ``nbytes`` buffer into another, GB/s."""
    import numpy as np
    src = np.ones(nbytes // 4, np.float32)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        np.copyto(dst, src)
        n += 1
    return n * nbytes / (time.perf_counter() - t0) / 1e9


def thread_cpu_s() -> dict:
    """{thread name (or native id): user + system CPU seconds}."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    out = {}
    for task in Path("/proc/self/task").iterdir():
        try:
            stat = (task / "stat").read_text()
        except OSError:
            continue
        rest = stat[stat.rindex(")") + 2:].split()
        tid = int(task.name)
        name = names.get(tid, f"tid{tid}")
        out[name] = out.get(name, 0.0) + (int(rest[11]) + int(rest[12])) / TICK
    return out


def machine_cpu() -> dict:
    """The machine's CPU time by kind (seconds, all cores), /proc/stat."""
    fields = Path("/proc/stat").read_text().splitlines()[0].split()[1:]
    kinds = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
             "steal")
    return {k: int(v) / TICK for k, v in zip(kinds, fields)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--every", type=float, default=1.0)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness, manifest
    cell = manifest.cell(manifest.load(ROOT), args.workload)
    cfg = manifest.config(cell["config"], ROOT)
    wl = manifest.workload(args.workload, ROOT)
    before = copy_gbps()
    session = harness.Session(cfg, wl, args.seed, "cuda")
    samples, stop = [], threading.Event()

    def sample():
        last = None
        while not stop.wait(args.every):
            now = {"wall": time.time(), "t": time.perf_counter(),
                   "frames": session.window_counts()[0],
                   "threads": thread_cpu_s(), "machine": machine_cpu()}
            if last is not None:
                dt = now["t"] - last["t"]
                samples.append({
                    "wall": now["wall"],
                    "frames_per_s": (now["frames"] - last["frames"]) / dt,
                    "threads_cores": {k: round((v - last["threads"].get(k, 0))
                                               / dt, 3)
                                      for k, v in now["threads"].items()
                                      if v - last["threads"].get(k, 0) > 0},
                    "machine_cores": {k: round((v - last["machine"][k]) / dt,
                                               3)
                                      for k, v in now["machine"].items()}})
                print(json.dumps(samples[-1]), flush=True)
            last = now
    sampler = threading.Thread(target=sample, name="probe-sampler")
    sampler.start()
    try:
        outcome = session.drive(args.seconds, time.perf_counter())
    finally:
        stop.set()
        sampler.join()
        session.close()
    after = copy_gbps()
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "frames_per_s": outcome.frames_answered()
        / (outcome.t1 - outcome.t0),
        "copy_gbps_before": before, "copy_gbps_after": after}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
