#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py              # on a machine with the card
    python3 chip_smoke.py --rehearse   # the same phases on the CPU, with the
                                       # kernels' plain versions; exits 2
    python3 chip_smoke.py --details PATH   # where the detail JSON goes
                                           # (default build/chip_smoke.json)

Phases, each fatal on failure:

  1. device: the card's name and count, and ``nvidia-smi``'s name and
     power limit;
  2. build: ``nvcc`` compiles every kernel of the port's path from
     ``src/repro_torch/csrc`` (one process per source, all at once);
  3. kernels: each kernel's wrapper runs on the card at the shapes the
     serving path gives it (plus ragged and extra shapes) and is held
     bitwise equal to its plain PyTorch version on the same inputs;
  4. timing: each kernel at its serving-path shapes, beside its plain
     version, one library call as a yardstick where PyTorch has one, and
     the least time the card could take (bytes over 3.35 TB/s, operations
     over the dense tensor-core peak for their type: int8 for the integer
     MACs of photonic_mvm and conv_chain, TF32 for ca_pool's float MACs);
  5. serve: ``serve.Server`` on the card hosts LeNet and VGG9-CA (full
     width, seeded random weights from numpy, W4A4) and answers mixed
     requests. The launch counts are zeroed just before the requests and
     read just after; every kernel of the path must have launched. Every
     answer must be finite, of the right shape, and bitwise equal to
     batch-1 ``run_per_frame`` on the card, to the reference backend on
     the card, and to the port's CPU run on the first frames.

The last three lines of standard output are the ``kernels`` JSON object,
``nvidia-smi``'s name and power limit, and the result object
``{"ok": true, "device": {...}}``. Longer detail (per-call times, serving
stats) goes to the ``--details`` file. The script imports nothing of JAX
or of the reference package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BUCKET = 8
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"int8": 1979e12,       # dense tensor-core int8
            "tf32": 495e12}        # dense tensor-core TF32
RAGGED_MVM = [(1, 1, 1), (37, 101, 53), (130, 777, 129), (300, 2304, 257)]
# random fused chains: (h, w, c_in, [(c_out, k, stride, padding, depthwise,
# act, pool, bias)])
CHAINS = [
    (12, 12, 3, [(8, 3, 1, "SAME", False, "relu", ("max", 2), True),
                 (8, 3, 1, "SAME", True, "abs", None, False)]),
    (16, 16, 4, [(4, 3, 1, "SAME", True, "sign", ("avg", 2), True),
                 (6, 5, 1, "VALID", False, "none", None, True)]),
    (15, 15, 2, [(5, 3, 2, "SAME", False, "relu", None, False),
                 (7, 3, 1, "VALID", False, "abs", ("max", 2), True)]),
    (20, 20, 1, [(6, 5, 1, "SAME", False, "relu", ("avg", 2), True),
                 (6, 3, 1, "SAME", True, "relu", ("max", 2), True),
                 (10, 3, 1, "SAME", False, "sign", None, False)]),
]


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    need(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs, made from a seed with numpy
# ---------------------------------------------------------------------------

def numpy_params(layers, seed):
    """{layer: {"w", "b"}}: N(0, 1/fan_in) weights, small non-zero biases."""
    import numpy as np
    from repro_torch.core.accelerator import ConvSpec, DenseSpec
    rng = np.random.default_rng(seed)
    params = {}
    for layer in layers:
        if isinstance(layer, ConvSpec):
            shape = (layer.kernel, layer.kernel, layer.c_in, layer.c_out)
            fan_in, n = layer.kernel * layer.kernel * layer.c_in, layer.c_out
        elif isinstance(layer, DenseSpec):
            shape, fan_in, n = (layer.fan_in, layer.fan_out), layer.fan_in, \
                layer.fan_out
        else:
            continue
        w = rng.standard_normal(shape) / math.sqrt(fan_in)
        b = rng.standard_normal(n) * 0.05
        params[layer.name] = {"w": w.astype(np.float32),
                              "b": b.astype(np.float32)}
    return params


def programs():
    from repro_torch import Program
    from repro_torch.models.vision import MODEL_INPUT_HWC, VISION_MODELS
    from repro_torch.weights import params_from_numpy
    out = {}
    for i, name in enumerate(("lenet", "vgg9")):
        layers = tuple(VISION_MODELS[name]())
        out[name] = Program(layers, params_from_numpy(
            numpy_params(layers, SEED + i), "cpu"), MODEL_INPUT_HWC[name],
            name=name)
    return out


def frames_for(name, n, seed):
    import numpy as np
    from repro_torch.models.vision import MODEL_INPUT_HWC
    rng = np.random.default_rng(seed)
    f = rng.random((n, *MODEL_INPUT_HWC[name])).astype(np.float32)
    f[::3] *= 0.1                  # dim frames: per-frame scales matter
    return f


# ---------------------------------------------------------------------------
# the kernels' calls on the serving path, from the compiled plans
# ---------------------------------------------------------------------------

def path_calls(exes, device):
    """The inputs each kernel gets for one bucket-8 batch of each model:
    photonic_mvm (a, wq, ws), conv_chain (codes, scale, stages, aq) and
    ca_pool (img, pool). Codes are random 0..15, weights the programs'
    own quantized levels."""
    import torch
    from repro_torch.core.plan import ConvStep, DenseStep, CAStep
    from repro_torch.core.quant import quantize_weight
    gen = torch.Generator().manual_seed(SEED)
    mvm, chain, ca = [], [], []
    for name, exe in exes.items():
        plan, params = exe.plan, exe.params()
        seg_at = {s.start: s for s in plan.fused_segments}
        h, w, c = plan.frame_shape
        i = 0
        while i < len(plan.steps):
            step = plan.steps[i]
            seg = seg_at.get(i)
            if seg is not None:
                stages = []
                for s in plan.steps[i:i + seg.length]:
                    wq, ws = quantize_weight(params[s.name]["w"], s.wa)
                    stages.append((s.geom, wq, ws, params[s.name]["b"]))
                g0 = stages[0][0]
                codes = torch.randint(0, 16, (BUCKET, g0.h_in, g0.w_in,
                                              g0.c_in), generator=gen)
                scale = torch.rand((BUCKET, 1, 1, 1), generator=gen) + 0.01
                chain.append((codes.float().to(device), scale.to(device),
                              stages, float(plan.consts["a_qmax"])))
                i += seg.length
                continue
            if isinstance(step, CAStep):
                need(i == 0, f"{name}: a CA step after step 0")
                img = torch.rand((BUCKET, h, w, c), generator=gen)
                ca.append((img.to(device), step.pool))
            elif isinstance(step, ConvStep):
                g = step.geom
                hc, wc = g.conv_hw()
                wq, _ = quantize_weight(params[step.name]["w"], step.wa)
                k = g.kernel * g.kernel * g.c_in
                a = torch.randint(0, 16, (BUCKET * hc * wc, k), generator=gen)
                mvm.append((a.to(torch.int8).to(device),
                            wq.reshape(k, g.c_out)))
            elif isinstance(step, DenseStep):
                wq, _ = quantize_weight(params[step.name]["w"], step.wa)
                a = torch.randint(0, 16, (BUCKET, wq.shape[0]), generator=gen)
                mvm.append((a.to(torch.int8).to(device), wq))
            i += 1
    return mvm, chain, ca


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(device, mvm_calls, chain_calls, ca_calls):
    """Every kernel against its plain version, bitwise."""
    import torch
    from repro_torch.core.accelerator import ConvSpec
    from repro_torch.core.compressive import compressive_acquire
    from repro_torch.core.plan import padtype_to_pads
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ca_pool.ops import ca_pool
    from repro_torch.kernels.conv_bank.fused import conv_chain
    from repro_torch.kernels.conv_bank.ref import conv_chain_ref
    from repro_torch.kernels.photonic_mvm.ops import mvm_int
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    gen = torch.Generator().manual_seed(SEED + 7)
    errs = {"photonic_mvm": [], "conv_chain": [], "ca_pool": []}

    def compare(kernel, got, want, what):
        need(got.shape == want.shape, f"{kernel} {what}: shape "
             f"{tuple(got.shape)} != {tuple(want.shape)}")
        need(bool(torch.isfinite(got).all()), f"{kernel} {what}: not finite")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        errs[kernel].append(err)
        need(torch.equal(got, want), f"{kernel} {what}: differs from its "
             f"plain version (max abs err {err})")

    ragged = []
    for m, k, n in RAGGED_MVM:
        a = torch.randint(0, 16, (m, k), generator=gen).to(torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen).to(torch.int8)
        ragged.append((a.to(device), w.to(device)))
    for a, w in mvm_calls + ragged:
        ws = (torch.rand((w.shape[1],), generator=gen) + 0.5).to(device)
        for act_scale, scales in ((1.0, None), (0.37, ws)):
            compare("photonic_mvm", mvm_int(a, w, scales, act_scale),
                    mvm_int_ref(a, w, scales, act_scale),
                    f"M,K,N={a.shape[0]},{a.shape[1]},{w.shape[1]}")

    chains = list(chain_calls)
    for ci, (h, w, c, specs) in enumerate(CHAINS):
        stages, hh, ww, cc = [], h, w, c
        for j, (co, k, s, pad, dw, act, pool, bias) in enumerate(specs):
            layer = ConvSpec(f"s{j}", cc, cc if dw else co, k, s, pad, act,
                             pool, depthwise=dw)
            pads = padtype_to_pads((hh, ww), k, s, pad)
            geom = dispatch.ChainGeom(layer.name, hh, ww, cc, layer.c_out,
                                      k, s, pads, groups=cc if dw else 1,
                                      act=act, pool=pool)
            wq = torch.randint(-7, 8, (k, k, 1 if dw else cc, layer.c_out),
                               generator=gen).to(torch.int8)
            ws = torch.rand((layer.c_out,), generator=gen) * 0.1 + 0.01
            b = (torch.randn((layer.c_out,), generator=gen) * 0.1
                 if bias else None)
            stages.append((geom, wq.to(device), ws.to(device),
                           None if b is None else b.to(device)))
            hh, ww = geom.out_hw()
            cc = layer.c_out
        codes = torch.randint(0, 16, (3, h, w, c), generator=gen).float()
        scale = torch.rand((3, 1, 1, 1), generator=gen) + 0.01
        chains.append((codes.to(device), scale.to(device), stages, 15.0))
        # per-tensor batch-1 form: a 0-d incoming scale
        chains.append((codes[:1].to(device), scale[0, 0, 0, 0].to(device),
                       stages, 15.0))
    for codes, scale, stages, aq in chains:
        got = conv_chain(codes, scale, stages, aq)
        want = conv_chain_ref(codes, scale, stages, aq)
        names = "+".join(g.name for g, _, _, _ in stages)
        compare("conv_chain", got[0], want[0], f"{names} codes")
        compare("conv_chain", got[1], want[1], f"{names} scales")

    cases = [(img, p, True) for img, p in ca_calls]
    for shape, p in (((8, 32, 32, 3), 4), ((8, 32, 32, 1), 2),
                     ((5, 28, 28, 1), 4), ((4, 16, 24, 3), 2)):
        img = torch.rand(shape, generator=gen).to(device)
        cases += [(img, p, True), (img, p, False)]
    for img, p, gray in cases:
        compare("ca_pool", ca_pool(img, p, gray),
                compressive_acquire(img, p, gray),
                f"{tuple(img.shape)} p={p} gray={gray}")
    return {k: max(v) for k, v in errs.items()}, {
        k: len(v) for k, v in errs.items()}


def timer(device):
    import torch

    def time_ms(fn, iters=50):
        for _ in range(3):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    return time_ms


def bound_ms(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(device, mvm_calls, chain_calls, ca_calls):
    """Per kernel: its calls for one bucket-8 batch of each model, summed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.compressive import ca_coefficients
    from repro_torch.core.compressive import compressive_acquire
    from repro_torch.kernels.ca_pool.ops import ca_pool
    from repro_torch.kernels.conv_bank.fused import conv_chain
    from repro_torch.kernels.conv_bank.ref import conv_chain_ref
    from repro_torch.kernels.photonic_mvm.ops import mvm_int
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    time_ms = timer(device)
    rows, detail = {}, {"photonic_mvm": [], "conv_chain": [], "ca_pool": []}

    def add(kernel, ms, plain, lib, nbytes, ops, kind, **shape):
        b, by = bound_ms(nbytes, ops, kind)
        detail[kernel].append(dict(shape, ms=ms, plain_ms=plain,
                                   library_ms=lib, bound_ms=b, bound_by=by,
                                   bytes=nbytes, ops=ops))
        r = rows.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0,
                                     "library_ms": 0.0, "bound_ms": 0.0,
                                     "t_bytes": 0.0, "t_ops": 0.0})
        r["ms"] += ms
        r["plain_ms"] += plain
        r["library_ms"] = None if lib is None or r["library_ms"] is None \
            else r["library_ms"] + lib
        r["bound_ms"] += b
        r["t_bytes"] += nbytes / HBM_BYTES_PER_S * 1e3
        r["t_ops"] += ops / PEAK_OPS[kind] * 1e3

    for a, w in mvm_calls:          # the path's form: raw accumulate, no ws
        m, k = a.shape
        n = w.shape[1]
        if device.type == "cuda" and m > 16 and k % 8 == 0 and n % 8 == 0:
            lib_fn, lib_name = (lambda a=a, w=w: torch._int_mm(a, w)), \
                "torch._int_mm"
        else:
            af, wf = a.float(), w.float()
            lib_fn, lib_name = (lambda af=af, wf=wf: af @ wf), "f32 matmul"
        add("photonic_mvm", time_ms(lambda: mvm_int(a, w)),
            time_ms(lambda: mvm_int_ref(a, w)), time_ms(lib_fn),
            m * k + k * n + 4 * m * n, 2 * m * n * k, "int8",
            M=m, K=k, N=n, library=lib_name)

    for codes, scale, stages, aq in chain_calls:
        b = codes.shape[0]
        nbytes = codes.numel() * 4 + b * 4 * 2
        ops = 0
        for g, wq, ws, bias in stages:
            hc, wc = g.conv_hw()
            ops += 2 * b * hc * wc * g.c_out * g.kernel * g.kernel * (
                g.c_in // g.groups)
            nbytes += wq.numel() * 4 + 4 * g.c_out * (2 if bias is not None
                                                      else 1)
        h, w = stages[-1][0].out_hw()
        nbytes += b * h * w * stages[-1][0].c_out * 4
        add("conv_chain",
            time_ms(lambda: conv_chain(codes, scale, stages, aq)),
            time_ms(lambda: conv_chain_ref(codes, scale, stages, aq)), None,
            nbytes, ops, "int8", B=b,
            stages="+".join(g.name for g, _, _, _ in stages))

    for img, p in ca_calls:
        b, h, w, c = img.shape
        coef = ca_coefficients(p, c, device=device)
        bank = coef.permute(2, 0, 1)[None].contiguous()   # [1, C, p, p]
        nchw = img.permute(0, 3, 1, 2)
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
        out_n = b * (h // p) * (w // p)
        add("ca_pool", time_ms(lambda: ca_pool(img, p, True)),
            time_ms(lambda: compressive_acquire(img, p, True)),
            time_ms(lambda: F.conv2d(nchw, bank, stride=p)),
            img.numel() * 4 + coef.numel() * 4 + out_n * 4,
            2 * out_n * p * p * c, "tf32", B=b, H=h, W=w, C=c, pool=p,
            library="F.conv2d with the coefficient bank")
    return rows, detail


KERNEL_SYMBOLS = {"photonic_mvm": ("mvm_int_kernel",),
                  "conv_chain": ("conv_chain_kernel",),
                  "ca_pool": ("ca_gray_kernel", "ca_mean_kernel")}


def phase_device_time(device, mvm_calls, chain_calls, ca_calls, iters=20):
    """Device time of each kernel per bucket-8 batch (all its path calls),
    from ``torch.profiler``'s CUDA activity; None where the profiler shows
    no device time for the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ca_pool.ops import ca_pool
    from repro_torch.kernels.conv_bank.fused import conv_chain
    from repro_torch.kernels.photonic_mvm.ops import mvm_int
    if device.type != "cuda":
        return {k: None for k in KERNEL_SYMBOLS}

    def batch():
        for a, w in mvm_calls:
            mvm_int(a, w)
        for codes, scale, stages, aq in chain_calls:
            conv_chain(codes, scale, stages, aq)
        for img, p in ca_calls:
            ca_pool(img, p, True)

    batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            batch()
        torch.cuda.synchronize()
    totals = {k: 0.0 for k in KERNEL_SYMBOLS}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        for k, syms in KERNEL_SYMBOLS.items():
            if any(sym in ev.key for sym in syms):
                totals[k] += t
    # microseconds over `iters` batches -> ms per batch
    return {k: (v / iters / 1e3 if v > 0 else None)
            for k, v in totals.items()}


def phase_serve(device, progs):
    """LeNet and VGG9-CA behind one Server on the card."""
    import numpy as np
    import torch
    from repro_torch import Options
    from repro_torch import serve
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels import launch_counts, reset_launch_counts
    dev = str(device)
    server = serve.Server(serve.ServeConfig(max_batch=BUCKET, max_wait_ms=2.0,
                                            device=dev))
    for name, prog in progs.items():
        server.register(name, prog, Options(scheme=W4A4, device=dev))
    server.start()
    sizes = [1, 2, 3, 1, 5, 1, 2, 8]
    reqs = []
    for i in range(32):
        name = ("lenet", "vgg9")[i % 2]
        reqs.append((name, frames_for(name, sizes[(i // 2) % len(sizes)],
                                      100 + i)))
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        futs = [server.submit(name, f) for name, f in reqs]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        server.stop()
    stats = server.stats()

    n_classes = {"lenet": 10, "vgg9": 100}
    by_prog = {"lenet": ([], []), "vgg9": ([], [])}
    for (name, f), out in zip(reqs, outs):
        need(out.shape == (f.shape[0], n_classes[name]),
             f"{name}: answer shape {out.shape}")
        need(bool(np.isfinite(out).all()), f"{name}: non-finite answer")
        by_prog[name][0].append(f)
        by_prog[name][1].append(out)
    for name, (fs, os_) in by_prog.items():
        frames, served = np.concatenate(fs), np.concatenate(os_)
        exe = progs[name].compile(Options(scheme=W4A4, device=dev))
        singles = np.concatenate([exe.run_per_frame(frames[i:i + 1]).cpu()
                                  .numpy() for i in range(len(frames))])
        need(np.array_equal(served, singles),
             f"{name}: served answers differ from batch-1 run_per_frame")
        ref = progs[name].compile(Options(scheme=W4A4, device=dev,
                                          backend="reference"))
        need(np.array_equal(served, ref.run_per_frame(frames).cpu().numpy()),
             f"{name}: served answers differ from the reference backend")
        cpu = progs[name].compile(Options(scheme=W4A4, device="cpu"))
        need(np.array_equal(served[:4], cpu.run_per_frame(frames[:4])
                            .numpy()),
             f"{name}: served answers differ from the port's CPU run")
    return counts, stats, wall, sum(f.shape[0] for _, f in reqs)


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU; exits 2, no result")
    ap.add_argument("--details", default=os.path.join(HERE, "build",
                                                      "chip_smoke.json"),
                    help="where to write the detail JSON")
    args = ap.parse_args(argv)
    rehearse = args.rehearse
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test needs the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not next to this "
              f"script ({e})", file=sys.stderr)
        return 1
    device = torch.device("cpu" if rehearse else "cuda")
    t_start = time.perf_counter()
    try:
        if rehearse:
            smi, kind, count = "rehearsal (no card)", "cpu", 0
        else:
            smi = nvidia_smi()
            kind, count = torch.cuda.get_device_name(0), \
                torch.cuda.device_count()
            log(f"[device] {kind} x{count}; nvidia-smi: {smi}; torch "
                f"{torch.__version__} cuda {torch.version.cuda}")
            t0 = time.perf_counter()
            built = _build.build()
            log(f"[build] {time.perf_counter() - t0:.1f}s wall for "
                f"{sorted(built)} (per kernel: "
                f"{ {k: round(v, 1) for k, v in built.items()} })")
            for name in _build.KERNELS:
                log_path = _build.library_path(name).with_suffix(".log")
                info = [l for l in log_path.read_text().splitlines()
                        if "registers" in l or "spill" in l]
                log(f"[build] {name}: {' | '.join(info)}")

        progs = programs()
        from repro_torch import Options
        from repro_torch.core.quant import W4A4
        exes = {n: p.compile(Options(scheme=W4A4, device=str(device)))
                for n, p in progs.items()}
        mvm_calls, chain_calls, ca_calls = path_calls(exes, device)
        log(f"[path] bucket {BUCKET}: photonic_mvm "
            f"{[(a.shape[0], a.shape[1], w.shape[1]) for a, w in mvm_calls]}"
            f"; conv_chain {[tuple(c.shape) for c, _, _, _ in chain_calls]}"
            f"; ca_pool {[tuple(i.shape) for i, _ in ca_calls]}")

        max_err, n_cmp = phase_kernels(device, mvm_calls, chain_calls,
                                       ca_calls)
        log(f"[kernels] bitwise equal to their plain versions: {n_cmp} "
            f"comparisons, max abs err {max_err}")

        rows, detail = phase_timing(device, mvm_calls, chain_calls, ca_calls)
        device_ms = phase_device_time(device, mvm_calls, chain_calls,
                                      ca_calls)
        for k, r in rows.items():
            log(f"[timing] {k}: {r['ms']:.4f} ms per call sequence (plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.6f}, device {device_ms[k]})")

        counts, stats, wall, n_frames = phase_serve(device, progs)
        for name, p in stats["programs"].items():
            lat = p["latency_ms"]
            log(f"[serve] {name}: {p['requests']['served']} requests, "
                f"{p['frames_served']} frames in {p['batches']} batches; "
                f"p50 {lat.get('p50', 0):.3f} ms p99 {lat.get('p99', 0):.3f}"
                f" ms; {p['achieved_fps']:.1f} frames/s")
        log(f"[serve] {n_frames} frames in {wall:.3f}s wall; launches "
            f"{counts}")

        sources = {"photonic_mvm": (
            "src/repro_torch/csrc/photonic_mvm.cu",
            "src/repro/kernels/photonic_mvm/kernel.py:81"),
            "conv_chain": ("src/repro_torch/csrc/conv_chain.cu",
                           "src/repro/kernels/conv_bank/fused_kernel.py:167"),
            "ca_pool": ("src/repro_torch/csrc/ca_pool.cu",
                        "src/repro/kernels/ca_pool/kernel.py:52")}
        kernels = []
        for name, (src, replaces) in sources.items():
            r = rows[name]
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": max_err[name],
                "bitwise_equal": max_err[name] == 0.0, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                             else "operations"),
                "library_ms": r["library_ms"],
                "device_ms": device_ms[name]})
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "kernels": kernels,
                       "per_call": detail, "serve_stats": stats,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1, default=str)
        if not rehearse:
            for k in kernels:
                need(k["launches"] > 0, f"{k['name']} never launched on the "
                     f"serving path")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    if rehearse:
        log(f"[rehearsal] all phases ran on the CPU in "
            f"{time.perf_counter() - t_start:.1f}s; no card, no result")
        return 2
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
