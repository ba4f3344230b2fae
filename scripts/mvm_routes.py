"""Time photonic_mvm's routes on the card at the served paths' shapes.

    python scripts/mvm_routes.py --time [--src DIR] [--label NAME]
    python scripts/mvm_routes.py --alternatives

The shapes are every photonic_mvm launch of the served programs' compiled
plans (``analysis.verifier.mvm_launches``: each dense layer and resident
conv at batch 1 and 8) for LeNet, VGG9-CA, VGG16 at 224x224 and the eight
imaging pipelines at 256x256, read from this checkout's package.
``--time`` gives each shape's device ms a call: 50 calls captured in a
CUDA graph, replayed 5 times between CUDA events (the L2 warm, as in a
bound window), the median; on levels laid out once (``mvm_int_laid``, a
bound view's call) and on [K, N] levels laid out on each call
(``mvm_int``, an unbound run's call), and the host microseconds a call of
each, issued eagerly. ``--src`` times the package under another
checkout's ``src`` (the parent's, unpacked with ``git archive``), so two
versions are compared within one call; where that package has no laid-out
form, both columns are its ``mvm_int``. ``--alternatives`` times every
launch the kernel takes at each shape but the imaging path's (the skinny
route's). Bitwise checks are ``chip_smoke.py``'s and
``tests/test_torch_gpu.py``'s. Results go to ``--out``
(``build/mvm_routes_<label>.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def plan_shapes():
    """(label, M, K, N) of every photonic_mvm launch of the served plans,
    one a shape, from this checkout's package on the CPU."""
    from repro_torch import Options, Program
    from repro_torch.analysis.verifier import mvm_launches
    from repro_torch.imaging import PIPELINES
    from repro_torch.models.vision import MODEL_INPUT_HWC
    progs = [(name, Program.from_model(name, params={}))
             for name in ("lenet", "vgg9", "vgg16")]
    progs += [("imaging", Program.from_pipeline(name, 256, 256, 3))
              for name in sorted(PIPELINES)]
    assert set(MODEL_INPUT_HWC) == {"lenet", "vgg9", "vgg16"}
    seen, out = set(), []
    for what, prog in progs:
        plan = prog.compile(Options(device="cpu", verify="off")).plan
        for step, b, m, k, n, _ in mvm_launches(plan):
            if (m, k, n) not in seen:
                seen.add((m, k, n))
                out.append((f"{what}.{step}.b{b}", m, k, n))
    return out


def shapes_from_this_checkout():
    """:func:`plan_shapes` in a child process on this checkout's ``src``,
    so ``--src`` may point the timed package elsewhere."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, __file__, "--shapes"], env=env,
                         capture_output=True, text=True, check=True)
    return [tuple(s) for s in json.loads(out.stdout)]


def operands(m, k, n, seed, device):
    import torch
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(0, 16, (m, k), generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8)
    return a.to(device), w.to(device)


def graph_ms(fn, calls=50, reps=5):
    """Device ms a call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events; all the replays'
    figures, the median first."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                           # the capture's allocations, warm
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1) / calls)
    return statistics.median(ms), ms


def host_us(fn, calls=100):
    """Host microseconds a call of ``fn``: ``calls`` calls issued back to
    back (too few to fill the launch queue), then one synchronize."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def time_shapes(shapes, device, label):
    from repro_torch.kernels.photonic_mvm import ops
    laid = hasattr(ops, "mvm_weights")
    rows = []
    for i, (what, m, k, n) in enumerate(shapes):
        a, w = operands(m, k, n, i, device)
        per_call = lambda a=a, w=w: ops.mvm_int(a, w)
        if laid:
            mw = ops.mvm_weights(w)
            fn = lambda a=a, mw=mw: ops.mvm_int_laid(a, mw)
        else:
            fn = per_call
        med, ms = graph_ms(fn)
        med_pc, ms_pc = graph_ms(per_call) if laid else (med, ms)
        cfg = ops.mvm_config(m, k, n)
        row = dict(shape=what, M=m, K=k, N=n, route=cfg.route,
                   tile=[cfg.bm, cfg.bn], ctas=cfg.ctas, ms=med, ms_all=ms,
                   ms_per_call_layout=med_pc, ms_per_call_layout_all=ms_pc,
                   laid=laid, host_us=host_us(fn),
                   host_us_per_call_layout=host_us(per_call))
        rows.append(row)
        print(f"[{label}] {what:24s} M,K,N={m},{k},{n} {cfg.route}"
              f" {cfg.bm}x{cfg.bn} ctas {cfg.ctas}: {med:.5f} ms "
              f"({med_pc:.5f} laid out per call); host "
              f"{row['host_us']:.1f} us a call "
              f"({row['host_us_per_call_layout']:.1f} laid out per call)",
              flush=True)
    return rows


def candidates(m, k, n):
    """Every launch the kernel takes at M x K x N (the skinny route
    aside): the route rule picks one of these."""
    from repro_torch.kernels.photonic_mvm import ops
    if m <= ops.STREAM_MAX_M:
        return [ops.MvmConfig("stream", 8 if m <= 8 else 16, 16)]
    out = [ops.MvmConfig("gemm", *ops.GEMM_TILE)]
    if k > 0 and k % 16 == 0:
        out.append(ops.MvmConfig("wgmma", 64, 64))
    return out


def time_alternatives(shapes, device, label):
    from repro_torch.kernels.photonic_mvm import ops
    rows = []
    for i, (what, m, k, n) in enumerate(shapes):
        if what.startswith("imaging"):
            continue
        a, w = operands(m, k, n, i, device)
        mw = ops.mvm_weights(w)
        rule = ops.mvm_config(m, k, n)
        times = []
        for cfg in candidates(m, k, n):
            med, _ = graph_ms(lambda: ops.launch(a, mw, cfg),
                              calls=20, reps=3)
            times.append((med, cfg))
        times.sort(key=lambda t: t[0])
        ranked = [dict(ms=t, route=c.route, tile=[c.bm, c.bn])
                  for t, c in times]
        rows.append(dict(shape=what, M=m, K=k, N=n, rule=dict(
            route=rule.route, tile=[rule.bm, rule.bn]), ranked=ranked))
        best = ", ".join(f"{r['route']} {r['tile'][0]}x{r['tile'][1]} "
                         f"{r['ms']:.5f}" for r in ranked)
        print(f"[alt] {what:24s} M,K,N={m},{k},{n} rule {rule.route} "
              f"{rule.bm}x{rule.bn}; fastest first: {best}", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", help="the results' JSON file (default "
                    "build/mvm_routes_<label>.json)")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--alternatives", action="store_true",
                    help="time every launch the kernel takes at each "
                         "shape")
    ap.add_argument("--shapes", action="store_true",
                    help="print the served plans' shapes as JSON and exit "
                         "(no card)")
    args = ap.parse_args()
    if args.shapes:
        print(json.dumps(plan_shapes()))
        return
    shapes = shapes_from_this_checkout()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mvm_routes: needs a CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[{args.label}] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; src {args.src}; {len(shapes)} shapes",
          flush=True)
    from repro_torch.kernels import _build
    built = _build.build(["photonic_mvm"])
    print(f"[{args.label}] build s: {built}", flush=True)
    out = {"label": args.label, "device": smi, "src": args.src}
    if args.time:
        out["rows"] = time_shapes(shapes, device, args.label)
    if args.alternatives:
        out["alternatives"] = time_alternatives(shapes, device, args.label)
    dest = Path(args.out or
                ROOT / "build" / f"mvm_routes_{args.label}.json")
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
