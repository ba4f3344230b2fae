#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py              # on a machine with the card
    python3 chip_smoke.py --rehearse   # the same phases on the CPU, with the
                                       # kernels' plain versions; exits 2
    python3 chip_smoke.py --details PATH   # where the detail JSON goes
                                           # (default build/chip_smoke.json)
    python3 chip_smoke.py --reread DIR     # re-read the profiler traces a
                                           # run left in DIR; no card

Three served paths, each driven through ``serve.Server`` with the kernel
launch counts zeroed just before its requests and read just after:

  vision   LeNet (28x28x1) and VGG9-CA (32x32x3), full width, seeded random
           weights from numpy, W4A4: 32 mixed requests of 1-8 frames;
  imaging  the eight imaging pipelines at 256x256x3 (their fixed filter
           weights), W4A4: 3 requests of 1, 3 and 8 frames each;
  chain    the reference's acceptance chain denoise_gauss -> edge_detect
           -> sharpen at 256x256x3 as one program (``Program.then``): 3
           requests of 1, 3 and 8 frames;
  vgg16    VGG16 at 224x224x3, full width, seeded random weights from
           numpy, W4A4: 3 requests of 1, 3 and 8 frames, eager and bound.

Phases, each fatal on failure:

  1. device: the card's name and count, and ``nvidia-smi``'s name and
     power limit;
  2. build: ``nvcc`` compiles every kernel from ``src/repro_torch/csrc``
     (one process per source, all at once);
  3. kernels: each kernel's wrapper runs on the card at the shapes the two
     paths give it at bucket 8, plus extra shapes (the edge lists of
     ``kernels/edge_shapes.py``: ragged GEMMs, strip tiles, depthwise
     tiles, fused chains and every ca_pool route; random chains,
     edge_detect's fused segment at 64x64, the 512x512 multi-strip
     geometries, a stride-2 VALID and a grouped conv, a VGG16-like layer,
     the conv_bank op in both strategies at k = 3, 5, 7), and is held
     bitwise equal to its plain PyTorch version on the same inputs. The
     conv_bank op, which no served path reaches, is driven once on its own
     with the counts zeroed around it;
  4. timing: each kernel at its path shapes (the conv_bank op at its own),
     beside its plain version, one library call as a yardstick where
     PyTorch has one (with TF32 off, and whether its answer was exact), the
     profiler's device time, the launch configuration (the chain kernel's
     cluster and CTAs, the depthwise kernel's tile, run, channel block and
     CTAs, ca_pool's route, run, threads and CTAs, the CTAs of the others),
     one ca_pool p = 1 call with the L2 cache flushed before each launch
     (``ca_pool.cold``; the path's calls find their input in L2), and the
     least time the card could take (bytes over 3.35 TB/s, operations over
     the dense tensor-core peak for their type: int8 for integer MACs,
     TF32 for ca_pool's float MACs); the device times come from one
     profiler session, written as a Chrome trace beside the details file,
     with a range per path shape of photonic_mvm, the strip convs and
     ca_pool (kernel and library call);
  5. serve, eager: vision and imaging through each program's unbound
     executable (the ``Hooks.execute`` seam: eager ``run_padded``,
     pageable copies), every answer finite, of the right shape and bitwise
     equal to batch-1 ``run_per_frame`` on the card, to the reference
     backend on the card and to the port's CPU run on the first frames;
     every kernel of a path must have launched in it. The imaging answers'
     PSNR against the float oracle ``apply_float`` is printed, and the
     imaging burst is served once more under the profiler for the device's
     busy share;
  6. serve, bound: all three paths behind one Server with ``devices=1``,
     ``max_inflight=2``, through ``Executable.bind`` views (own stream,
     pinned staging ring, one CUDA graph per bucket, captured at start),
     each path in its own window: answers held as in 5, each window's
     launch counts equal to what the graph replays credited (every kernel
     of the path launched), three batches of different content in flight
     on one bound view each giving its own answers; the imaging burst's
     busy share again, bound;
  7. load: LeNet, VGG9-CA, edge_detect, compress_recon and the chain,
     bound and eager: ``loadgen.saturate`` frames/s (single-frame
     requests, ~2 s) and ``loadgen.poisson_load`` p50/p99 at half the
     bound path's saturation rate (~2 s);
  8. obs: LeNet, VGG9-CA and edge_detect behind one bound server with a
     ``Trace`` enabled and the admin endpoint up: answers bitwise as in 5;
     the exported trace passes ``scripts/check_trace.py --min-devices 1``
     (run as a subprocess); ``/healthz`` ``/readyz`` ``/metrics``
     ``/statusz`` (JSON and text) answer 200, ``/metrics`` has each
     program's ``serve_`` lines, ``/tracez`` passes ``--flight``; LeNet's
     tight SLO (``p99_ms=0.001``) is breached, counted, logged and dumped,
     an injected ``WorkerError`` dumps, both dumps pass ``--flight
     --require-trigger``. The bound imaging burst once more under the
     profiler and a ``Trace``: the ``serve.device.execute`` spans sum to
     at least the card's busy time. Then what observability costs:
     ``loadgen.saturate`` frames/s of LeNet and edge_detect, bound, under
     A (no recorder), B (the default recorder), C (recorder + ``Trace``)
     and D (recorder, admin endpoint polled every 100 ms), in the order
     A B C D D C B A in one call (``[obs]`` lines: frames/s, the ratio to
     A, the recorder's records per request).
  9. vgg16: VGG16 compiled under W4A4 and MX_43 with ``Options(verify=
     "on")``, each report clean, the per-step accumulator headroom printed
     and the ``plan.verify`` span's time on the cold compile; the strip and
     photonic_mvm kernels bitwise equal to their plain versions at every
     distinct VGG16 shape (``edge_shapes.VGG16_SHAPES``) at buckets 1 and
     8; served eager and bound (``devices=1``, ``max_inflight=2``), every
     answer bitwise equal to batch-1 ``run_per_frame``, the reference
     backend on the card and the port's CPU run on the first 2 frames, the
     bound window's launch counts equal to the replays' credits; each conv
     and dense step timed at bucket 8 beside its plain version, its
     library call and its bound (each strip step also forced resident);
     the bound window's device busy share and a short saturation run's
     frames/s (``[vgg16]`` lines).

``--rehearse`` runs every phase on the CPU with the plain versions: no
graphs, the bound phase on 2 emulated CPU workers, VGG16 at 32x32x3
(``vgg16_ir(in_hw=32)``, full channel widths, a conv budget that splits
its convs into strip and resident as 224x224x3 does).

The last three lines of standard output are the ``kernels`` JSON object,
``nvidia-smi``'s name and power limit, and the result object
``{"ok": true, "device": {...}}``. Longer detail (per-call times, serving
stats) goes to the ``--details`` file. The script imports nothing of JAX
or of the reference package.

``--reread DIR`` reads the Chrome traces that a run of this script (of
this commit or an earlier one) wrote beside its details file, and prints
as JSON each timing range's device time per batch by kernel function and
the imaging serving windows' busy shares (eager, and bound where the run
wrote that trace), attributed as a run of this commit attributes them:
one yardstick for runs of different commits.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BUCKET = 8
IMAGING_HW = 256
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"int8": 1979e12,       # dense tensor-core int8
            "tf32": 495e12}        # dense tensor-core TF32
RAGGED_MVM = [(1, 1, 1), (37, 101, 53), (130, 777, 129), (300, 2304, 257)]
# the conv_bank op's own calls: x [B, H, W, Cin] -> Cout, k x k, W4A4 with
# relu and bias, in both strategies
CONV_BANK = [(BUCKET, 32, 32, 16, 32, k) for k in (3, 5, 7)]
# extra strip convs through dispatch.conv_int: (name, x shape, w shape,
# stride, padding, groups)
STRIP_CONVS = [("stride2_valid", (2, 65, 63, 8), (3, 3, 8, 16), 2, "VALID", 1),
               ("groups2", (2, 40, 40, 8), (3, 3, 4, 12), 1, "SAME", 2),
               ("vgg16_like", (2, 56, 56, 64), (3, 3, 64, 128), 1, "SAME", 1)]
SERVE_WINDOW = "chip_smoke.serve_window"
DEVICE_RANGE = "chip_smoke.device_time."
DEVICE_ITERS = 20                   # batches in each device-time range
L2_FLUSH_BYTES = 128 << 20          # written before each cold launch (the
                                    # H100's L2 holds 50 MB)
DEVICE_TRACE = "device_time_trace.json"
SERVE_TRACE = "imaging_serve_trace.json"
BOUND_SERVE_TRACE = "imaging_bound_serve_trace.json"
BUCKETS = (1, 2, 4, 8)
VISION_REQUESTS = 32
# the reference's acceptance chain: (pipeline, input channels)
CHAIN = (("denoise_gauss", 3), ("edge_detect", 3), ("sharpen", 1))
# the programs whose served frames/s and latency are measured, and for how
# long (seconds; the rehearsal's on the CPU)
LOAD_PROGRAMS = ("lenet", "vgg9", "edge_detect", "compress_recon", "chain")
LOAD_S = {"saturate": 2.0, "poisson": 2.0}
REHEARSAL_LOAD_S = {"saturate": 0.2, "poisson": 0.2}
# the [obs] phase: its exported trace, the profiler trace of its bound
# imaging burst, the programs and variant order of its cost runs (A no
# recorder, B the default recorder, C recorder + Trace, D recorder + the
# admin endpoint polled every ADMIN_POLL_S), and each run's length
OBS_TRACE = "obs_serve_trace.json"
OBS_BUSY_TRACE = "obs_imaging_bound_serve_trace.json"
OBS_COST_PROGRAMS = ("lenet", "edge_detect")
OBS_VARIANTS = "ABCDDCBA"
ADMIN_POLL_S = 0.1
OBS_COST_S = 2.0
REHEARSAL_OBS_COST_S = 0.2
# the [vgg16] phase: frame size (the rehearsal's, with the conv budget that
# gives it 224x224x3's split: conv1-conv10 strip, conv11-13 resident), the
# frames of its requests, how many frames the CPU port is held to, the
# buckets its shapes are held at, the timing iterations a layer, its
# saturation run and its profiler trace
VGG16_HW = 224
REHEARSAL_VGG16_HW = 32
REHEARSAL_VGG16_BUDGET = 100_000
VGG16_REQUESTS = (1, 3, 8)
VGG16_CPU_FRAMES = 2
VGG16_SHAPE_BUCKETS = (1, BUCKET)
VGG16_ITERS = 10
VGG16_DEVICE_ITERS = 3
VGG16_WARM_LAUNCHES = 64
VGG16_SATURATE_S = 2.0
REHEARSAL_VGG16_SATURATE_S = 0.2
VGG16_TRACE = "vgg16_bound_serve_trace.json"
VGG16_DEVICE_TRACE = "vgg16_device_time_trace.json"
# the port's kernels are top-level functions of an anonymous namespace
PORT_KERNEL = r"^(void )?\(anonymous namespace\)::"
KERNELS = ("photonic_mvm", "conv_chain", "ca_pool", "conv_strip",
           "conv_strip_depthwise", "conv_bank")
# the kernels each served path must launch
PATH_KERNELS = {"vision": ("photonic_mvm", "conv_chain", "ca_pool"),
                "imaging": ("photonic_mvm", "ca_pool", "conv_strip",
                            "conv_strip_depthwise"),
                "chain": ("photonic_mvm", "ca_pool", "conv_strip_depthwise"),
                "vgg16": ("photonic_mvm", "conv_strip")}
SOURCES = {
    "photonic_mvm": ("src/repro_torch/csrc/photonic_mvm.cu",
                     "src/repro/kernels/photonic_mvm/kernel.py:81"),
    "conv_chain": ("src/repro_torch/csrc/conv_chain.cu",
                   "src/repro/kernels/conv_bank/fused_kernel.py:167"),
    "ca_pool": ("src/repro_torch/csrc/ca_pool.cu",
                "src/repro/kernels/ca_pool/kernel.py:52"),
    "conv_strip": ("src/repro_torch/csrc/conv_strip.cu",
                   "src/repro/kernels/conv_bank/strip_kernel.py:206"),
    "conv_strip_depthwise": ("src/repro_torch/csrc/conv_strip.cu",
                             "src/repro/kernels/conv_bank/strip_kernel.py:289"),
    "conv_bank": ("src/repro_torch/csrc/conv_strip.cu",
                  "src/repro/kernels/conv_bank/kernel.py:85")}
# device-time symbols (space-free regexes over the profiler's kernel names)
KERNEL_SYMBOLS = {"photonic_mvm": r"mvm_(gemm|reduce|skinny)_kernel",
                  "conv_chain": r"conv_chain_kernel",
                  "ca_pool": r"ca_(gray|mean|generic)_kernel",
                  "conv_strip": r"conv_dense_kernel",
                  "conv_strip_depthwise": r"conv_dw_kernel",
                  "conv_bank": r"conv_dense_kernel"}


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


def ptxas_report(log_text):
    """Per kernel function in an ``nvcc -Xptxas -v`` log: registers, static
    shared memory and spill bytes. Names are demangled enough to read:
    ``mvm_gemm_kernel<16,64,1,4>``."""
    out, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            base = re.search(r"\d+([a-z_]+_kernel)", name)
            args = re.findall(r"Li(\d+)E", name)
            label = (base.group(1) if base else name) + (
                f"<{','.join(args)}>" if args else "")
            cur = {"function": label, "registers": None, "smem_bytes": 0,
                   "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    return out


# ---------------------------------------------------------------------------
# programs and inputs, made from a seed with numpy
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


def vision_programs():
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


def imaging_programs(hw=IMAGING_HW):
    from repro_torch import Program
    from repro_torch.imaging import PIPELINES
    return {name: Program.from_pipeline(name, hw, hw, 3)
            for name in sorted(PIPELINES)}


def frames_for(prog, n, seed):
    """Frames in [0, 1]: uniform noise for the CNNs; for the imaging
    pipelines, smooth gradients and waves with noise on top, so the filters
    see edges and texture. Every third frame is dimmed, so per-frame
    calibration matters."""
    import numpy as np
    rng = np.random.default_rng(seed)
    h, w, c = prog.input_hwc
    if prog.name in ("lenet", "vgg9", "vgg16"):
        f = rng.random((n, h, w, c))
    else:
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        f = np.empty((n, h, w, c))
        for i in range(n):
            fx, fy, ph = rng.uniform(2, 12, 2).tolist() + [rng.uniform(0, 6)]
            base = 0.5 + 0.3 * np.sin(2 * np.pi * (fx * xx + ph)) \
                * np.cos(2 * np.pi * fy * yy) + 0.2 * (xx - yy)
            for ch in range(c):
                f[i, ..., ch] = base * (0.8 + 0.2 * ch / max(c - 1, 1))
        f = np.clip(f + rng.normal(0, 0.05, f.shape), 0, 1)
    f = f.astype(np.float32)
    f[::3] *= 0.1
    return f


# ---------------------------------------------------------------------------
# the kernels' calls on the served paths, from the compiled plans
# ---------------------------------------------------------------------------

def path_calls(exes, device, batch=BUCKET):
    """The inputs each kernel gets for one batch of each program, by kernel:
    photonic_mvm (a, wq), conv_chain (codes, scale, stages, aq), ca_pool
    (img, pool), conv_strip (x_padded, w, stride, strip_h, conv) and
    conv_strip_depthwise (x_padded, w_taps, stride, strip_h, conv). Codes
    are random 0..15, weights the programs' own quantized levels, and a
    strip conv's input is padded as dispatch pads it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.plan import CAStep, ConvStep, DenseStep
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels.conv_bank.strip import pad_rows_for_strips
    gen = torch.Generator().manual_seed(SEED + batch)
    calls = {k: [] for k in KERNELS if k != "conv_bank"}
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
                    stages.append((s.geom, wq, ws, params[s.name].get("b")))
                g0 = stages[0][0]
                codes = torch.randint(0, 16, (batch, g0.h_in, g0.w_in,
                                              g0.c_in), generator=gen)
                scale = torch.rand((batch, 1, 1, 1), generator=gen) + 0.01
                calls["conv_chain"].append((
                    codes.float().to(device), scale.to(device), stages,
                    float(plan.consts["a_qmax"])))
                i += seg.length
                continue
            if isinstance(step, CAStep):
                need(i == 0, f"{name}: a CA step after step 0")
                img = torch.rand((batch, h, w, c), generator=gen)
                calls["ca_pool"].append((img.to(device), step.pool))
            elif isinstance(step, ConvStep):
                g = step.geom
                wq, _ = quantize_weight(params[step.name]["w"], step.wa)
                need(g.groups == 1 or g.depthwise,
                     f"{name}.{step.name}: a grouped conv on the path")
                if step.strategy.kind == "strip":
                    codes = torch.randint(0, 16, (batch, g.h_in, g.w_in,
                                                  g.c_in), generator=gen)
                    (plo, phi), (qlo, qhi) = g.pads
                    sh = step.strategy.strip_rows
                    xp = pad_rows_for_strips(
                        F.pad(codes.float(), (0, 0, qlo, qhi, plo, phi)),
                        g.kernel, g.stride, sh, step.strategy.n_strips)
                    wf = wq.float()
                    key = "conv_strip"
                    if g.depthwise:
                        key = "conv_strip_depthwise"
                        wf = wf.reshape(g.kernel * g.kernel, g.c_out)
                    calls[key].append((xp.to(device), wf, g.stride, sh,
                                       f"{name}.{step.name}"))
                else:
                    need(g.groups == 1, f"{name}.{step.name}: a resident "
                         f"depthwise conv")
                    hc, wc = g.conv_hw()
                    k = g.kernel * g.kernel * g.c_in
                    a = torch.randint(0, 16, (batch * hc * wc, k),
                                      generator=gen)
                    calls["photonic_mvm"].append((
                        a.to(torch.int8).to(device),
                        wq.reshape(k, g.c_out)))
            elif isinstance(step, DenseStep):
                wq, _ = quantize_weight(params[step.name]["w"], step.wa)
                a = torch.randint(0, 16, (batch, wq.shape[0]), generator=gen)
                calls["photonic_mvm"].append((a.to(torch.int8).to(device),
                                              wq))
            i += 1
    return calls


def conv_bank_calls(device):
    """(x, w, bias) of the conv_bank op's own calls."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 11)
    out = []
    for b, h, w, ci, co, k in CONV_BANK:
        x = torch.rand((b, h, w, ci), generator=gen)
        wt = torch.randn((k, k, ci, co), generator=gen) * 0.2
        bias = torch.randn((co,), generator=gen) * 0.1
        out.append((x.to(device), wt.to(device), bias.to(device)))
    return out


def run_conv_bank_op(calls, strategies=("resident", "strip")):
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels.conv_bank.ops import conv_bank
    return [conv_bank(x, w, spec=W4A4, strategy=s, act="relu", bias=b)
            for x, w, b in calls for s in strategies]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(device, vision, imaging):
    """Every kernel against its plain version, bitwise."""
    import torch
    from repro_torch import Options, Program
    from repro_torch.core.compressive import compressive_acquire
    from repro_torch.core.plan import padtype_to_pads
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ca_pool.ops import ca_pool
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.fused import conv_chain
    from repro_torch.kernels.conv_bank.ops import conv_bank, conv_bank_plain
    from repro_torch.kernels.conv_bank.ref import conv_chain_ref, conv_int_ref
    from repro_torch.kernels.edge_shapes import (CA_EDGES, CHAIN_EDGES,
                                                 CHAINS, DW_EDGES, MVM_EDGES,
                                                 STRIP_EDGES, chain_case,
                                                 odd_offset)
    from repro_torch.kernels.photonic_mvm.ops import mvm_int
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    gen = torch.Generator().manual_seed(SEED + 7)
    errs = {k: [] for k in KERNELS}
    dev = str(device)

    def compare(kernel, got, want, what):
        need(got.shape == want.shape, f"{kernel} {what}: shape "
             f"{tuple(got.shape)} != {tuple(want.shape)}")
        need(bool(torch.isfinite(got).all()), f"{kernel} {what}: not finite")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        errs[kernel].append(err)
        need(torch.equal(got, want), f"{kernel} {what}: differs from its "
             f"plain version (max abs err {err})")

    # extra geometries from compiled plans: edge_detect's fused segment at
    # 64x64, and the 512x512 multi-strip convs (batch 2)
    extra = path_calls({
        "edge64": Program.from_pipeline("edge_detect", 64, 64).compile(
            Options(device=dev)),
        **{f"{n}512": Program.from_pipeline(n, 512, 512).compile(
            Options(device=dev))
           for n in ("denoise_gauss", "compress_recon_deconv")}},
        device, batch=2)
    need(len(extra["conv_chain"]) == 1, "edge_detect at 64x64 did not fuse")
    strips = {c[4]: c[3] for k in ("conv_strip", "conv_strip_depthwise")
              for c in extra[k]}
    for conv, n_strips in (("denoise_gauss512.gauss", 2),
                           ("compress_recon_deconv512.rec2", 3)):
        rows = strips[conv]
        need(-(-512 // rows) == n_strips,
             f"{conv}: {rows}-row strips, expected {n_strips} strips")
    calls = {k: vision.get(k, []) + imaging.get(k, []) + extra.get(k, [])
             for k in KERNELS}

    ragged = []
    for m, k, n in RAGGED_MVM + [e[:3] for e in MVM_EDGES]:
        a = torch.randint(0, 16, (m, k), generator=gen).to(torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen).to(torch.int8)
        ragged.append((a.to(device), w.to(device)))
        # the same operands one byte past an allocation: no aligned copy
        ragged.append((odd_offset(a.to(device)), odd_offset(w.to(device))))
    for a, w in calls["photonic_mvm"] + ragged:
        ws = (torch.rand((w.shape[1],), generator=gen) + 0.5).to(device)
        for act_scale, scales in ((1.0, None), (0.37, ws)):
            compare("photonic_mvm", mvm_int(a, w, scales, act_scale),
                    mvm_int_ref(a, w, scales, act_scale),
                    f"M,K,N={a.shape[0]},{a.shape[1]},{w.shape[1]}")

    chains = list(calls["conv_chain"])
    for h, w, c, specs in CHAINS:
        codes, scale, stages = chain_case(3, h, w, c, specs, gen, device)
        chains.append((codes, scale, stages, 15.0))
        # per-tensor batch-1 form: a 0-d incoming scale
        chains.append((codes[:1], scale[0, 0, 0, 0], stages, 15.0))
    for b, h, w, c, specs in CHAIN_EDGES:
        codes, scale, stages = chain_case(b, h, w, c, specs, gen, device)
        chains.append((codes, scale, stages, 15.0))
    for codes, scale, stages, aq in chains:
        got = conv_chain(codes, scale, stages, aq)
        want = conv_chain_ref(codes, scale, stages, aq)
        names = "+".join(g.name for g, _, _, _ in stages)
        compare("conv_chain", got[0], want[0], f"{names} codes")
        compare("conv_chain", got[1], want[1], f"{names} scales")

    cases = [(img, p, True) for img, p in calls["ca_pool"]]
    for shape, p in (((8, 32, 32, 3), 4), ((8, 32, 32, 1), 2),
                     ((5, 28, 28, 1), 4), ((4, 16, 24, 3), 2)):
        img = torch.rand(shape, generator=gen).to(device)
        cases += [(img, p, True), (img, p, False)]
    for b, h, w, c, p, gray, odd, _ in CA_EDGES:
        img = torch.rand((b, h, w, c), generator=gen).to(device)
        cases.append((odd_offset(img) if odd else img, p, gray))
    for img, p, gray in cases:
        compare("ca_pool", ca_pool(img, p, gray),
                compressive_acquire(img, p, gray),
                f"{tuple(img.shape)} p={p} gray={gray}")

    # the strip kernels: raw accumulate (the path's form) and the fused
    # epilogue with act_scale != 1, relu and bias
    for kernel, run, plain in (
            ("conv_strip", strip.conv_strip, strip.conv_strip_ref),
            ("conv_strip_depthwise", strip.conv_strip_depthwise,
             strip.conv_strip_depthwise_ref)):
        for xp, wf, stride, sh, conv in calls[kernel]:
            kw = dict(stride=stride, strip_h=sh)
            compare(kernel, run(xp, wf, **kw), plain(xp, wf, **kw), conv)
            co = wf.shape[-1]
            ws = (torch.rand((co,), generator=gen) + 0.5).to(device)
            bias = torch.randn((co,), generator=gen).to(device)
            kw.update(act_scale=0.37, act="relu", bias=bias)
            compare(kernel, run(xp, wf, ws, **kw), plain(xp, wf, ws, **kw),
                    f"{conv} with epilogue")
    for b, h_out, w_out, ci, co, k, stride in STRIP_EDGES:
        xp = torch.randint(0, 16, (b, (h_out - 1) * stride + k,
                                   (w_out - 1) * stride + k, ci),
                           generator=gen).float().to(device)
        wq = torch.randint(-127, 128, (k, k, ci, co),
                           generator=gen).float().to(device)
        ws = (torch.rand((co,), generator=gen) + 0.5).to(device)
        bias = torch.randn((co,), generator=gen).to(device)
        what = f"edge {xp.shape[1:3]} {ci}->{co} k{k} s{stride}"
        kw = dict(stride=stride, strip_h=h_out)
        compare("conv_strip", strip.conv_strip(xp, wq, **kw),
                strip.conv_strip_ref(xp, wq, **kw), what)
        for act in ("relu", "abs", "sign"):
            kw.update(act_scale=0.37, act=act, bias=bias)
            compare("conv_strip", strip.conv_strip(xp, wq, ws, **kw),
                    strip.conv_strip_ref(xp, wq, ws, **kw), f"{what} {act}")
    for b, h_out, w_out, c, k, stride in DW_EDGES:
        xp = torch.randint(0, 16, (b, (h_out - 1) * stride + k,
                                   (w_out - 1) * stride + k, c),
                           generator=gen).float().to(device)
        taps = torch.randint(-127, 128, (k * k, c),
                             generator=gen).float().to(device)
        ws = (torch.rand((c,), generator=gen) + 0.5).to(device)
        bias = torch.randn((c,), generator=gen).to(device)
        what = f"edge {xp.shape[1:3]} c{c} k{k} s{stride}"
        for x in (xp, odd_offset(xp)):      # aligned rows, then none
            kw = dict(stride=stride, strip_h=h_out)
            compare("conv_strip_depthwise",
                    strip.conv_strip_depthwise(x, taps, **kw),
                    strip.conv_strip_depthwise_ref(x, taps, **kw), what)
            kw.update(act_scale=0.37, act="sign", bias=bias)
            compare("conv_strip_depthwise",
                    strip.conv_strip_depthwise(x, taps, ws, **kw),
                    strip.conv_strip_depthwise_ref(x, taps, ws, **kw),
                    f"{what} sign")
    for name, xs, wshape, stride, padding, groups in STRIP_CONVS:
        x = torch.randint(0, 16, xs, generator=gen).float().to(device)
        wq = torch.randint(-7, 8, wshape, generator=gen).float().to(device)
        pads = padtype_to_pads(xs[1:3], wshape[0], stride, padding)
        h_out = (xs[1] + sum(pads[0]) - wshape[0]) // stride + 1
        w_out = (xs[2] + sum(pads[1]) - wshape[0]) // stride + 1
        strat = dispatch.select_conv_strategy(
            h_out, w_out, xs[3], wshape[3], wshape[0], stride, groups,
            mode="strip")
        compare("conv_strip", dispatch.conv_int(x, wq, stride, pads, groups,
                                                strat),
                conv_int_ref(x, wq, stride, pads, groups),
                f"{name} {xs}x{wshape}")

    bank_calls = conv_bank_calls(device)
    float_err = 0.0
    for x, w, b in bank_calls:
        for strategy in ("resident", "strip"):
            kw = dict(spec=W4A4, strategy=strategy, act="relu", bias=b)
            kernel = "conv_bank" if strategy == "resident" else "conv_strip"
            compare(kernel, conv_bank(x, w, **kw), conv_bank_plain(x, w, **kw),
                    f"conv_bank {strategy} k={w.shape[0]}")
            got = conv_bank(x, w, strategy=strategy)
            want = conv_bank_plain(x, w, strategy=strategy)
            float_err = max(float_err, float((got - want).abs().max()))
            need(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                 f"conv_bank float mode {strategy} k={w.shape[0]}: off its "
                 f"plain version by {float_err}")
    return ({k: max(v) for k, v in errs.items()},
            {k: len(v) for k, v in errs.items()}, float_err)


def phase_conv_bank_op(device):
    """The conv_bank op's entry point on its own calls, counts zeroed
    around it (no served path reaches it)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    calls = conv_bank_calls(device)
    reset_launch_counts()
    outs = run_conv_bank_op(calls)
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = launch_counts()
    for out, (x, w, _) in zip(outs, [c for c in calls for _ in range(2)]):
        need(out.shape == (*x.shape[:3], w.shape[-1])
             and bool(torch.isfinite(out).all()),
             f"conv_bank op: bad answer {tuple(out.shape)}")
    return counts


def timer(device):
    import torch

    def time_ms(fn, iters=50 if device.type == "cuda" else 2):
        for _ in range(3 if device.type == "cuda" else 1):
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


def mvm_library(a, w):
    """One PyTorch call for photonic_mvm's raw accumulate: ``torch._int_mm``
    where it is legal (M > 16, K and N multiples of 8), else a float32
    matmul of the same integers (exact: the sums stay below 2^24)."""
    import torch
    m, k = a.shape
    n = w.shape[1]
    if a.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return (lambda: torch._int_mm(a, w)), "torch._int_mm"
    af, wf = a.float(), w.float()
    return (lambda: af @ wf), "f32 matmul"


def strip_library(xp, wf, stride, dw):
    """``F.conv2d`` on the same padded codes (NCHW views; groups=C for the
    depthwise kernel): the strip kernels' one-call yardstick."""
    import torch.nn.functional as F
    co = wf.shape[-1]
    k = math.isqrt(wf.shape[0]) if dw else wf.shape[0]
    w_oihw = (wf.t().reshape(co, 1, k, k) if dw
              else wf.permute(3, 2, 0, 1)).contiguous()
    nchw = xp.permute(0, 3, 1, 2)
    groups = co if dw else 1
    return lambda: F.conv2d(nchw, w_oihw, stride=stride, groups=groups)


def phase_timing(device, vision, imaging):
    """Per kernel, its calls for one bucket-8 batch summed: the slice-1
    kernels on the vision path, the strip kernels on the imaging path, the
    conv_bank op on its own calls."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.compressive import ca_coefficients
    from repro_torch.core.compressive import compressive_acquire
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels.ca_pool.ops import ca_config, ca_pool
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.fused import conv_chain
    from repro_torch.kernels.conv_bank.ops import conv_bank, conv_bank_plain
    from repro_torch.kernels.conv_bank.ref import conv_chain_ref, float32_convs
    from repro_torch.kernels.photonic_mvm.ops import mvm_int
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    time_ms = timer(device)
    rows, detail = {}, {k: [] for k in KERNELS}
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 132)

    def add(kernel, ms, plain, lib, nbytes, ops, kind, path=None, **shape):
        b, by = bound_ms(nbytes, ops, kind)
        detail[kernel].append(dict(shape, path=path, ms=ms, plain_ms=plain,
                                   library_ms=lib, bound_ms=b, bound_by=by,
                                   bytes=nbytes, ops=ops))
        r = rows.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0,
                                     "library_ms": 0.0, "bound_ms": 0.0,
                                     "t_bytes": 0.0, "t_ops": 0.0,
                                     "library_exact": None, "by_path": {}})
        p = r["by_path"].setdefault(path, {"ms": 0.0, "plain_ms": 0.0,
                                           "library_ms": 0.0,
                                           "bound_ms": 0.0, "calls": 0})
        for acc in (r, p):
            acc["ms"] += ms
            acc["plain_ms"] += plain
            acc["library_ms"] = None if lib is None or \
                acc["library_ms"] is None else acc["library_ms"] + lib
            acc["bound_ms"] += b
        p["calls"] += 1
        r["t_bytes"] += nbytes / HBM_BYTES_PER_S * 1e3
        r["t_ops"] += ops / PEAK_OPS[kind] * 1e3
        if "library_exact" in shape:       # None: not the same function
            r["library_exact"] = shape["library_exact"] and \
                r["library_exact"] is not False

    from repro_torch.kernels.conv_bank.fused import (chain_config,
                                                     max_active_clusters)
    from repro_torch.kernels.conv_bank.strip import dw_config, strip_config
    from repro_torch.kernels.photonic_mvm.ops import mvm_config
    mvm_calls = [("vision", a, w) for a, w in vision["photonic_mvm"]] + \
        [("imaging", a, w) for a, w in imaging["photonic_mvm"]]
    for path, a, w in mvm_calls:          # the path's form: no ws
        m, k = a.shape
        n = w.shape[1]
        cfg = mvm_config(m, k, n)
        lib_fn, lib_name = mvm_library(a, w)
        add("photonic_mvm", time_ms(lambda: mvm_int(a, w)),
            time_ms(lambda: mvm_int_ref(a, w)), time_ms(lib_fn),
            m * k + k * n + 4 * m * n, 2 * m * n * k, "int8", path,
            M=m, K=k, N=n, library=lib_name, route=cfg.route,
            tile=[cfg.bm, cfg.bn], split=cfg.split, ctas=cfg.ctas)

    for codes, scale, stages, aq in vision["conv_chain"]:
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
        cfg = chain_config(b, [g for g, _, _, _ in stages])
        active = (max_active_clusters(cfg.cluster, cfg.smem)
                  if device.type == "cuda" else None)
        add("conv_chain",
            time_ms(lambda: conv_chain(codes, scale, stages, aq)),
            time_ms(lambda: conv_chain_ref(codes, scale, stages, aq)), None,
            nbytes, ops, "int8", "vision", B=b,
            stages="+".join(g.name for g, _, _, _ in stages),
            cluster=cfg.cluster, ctas=cfg.ctas, splits=list(cfg.splits),
            weights_in_smem=[o >= 0 for o in cfg.w_offsets], smem=cfg.smem,
            active_clusters=active)

    ca_calls = [("vision", img, p) for img, p in vision["ca_pool"]] + \
        [("imaging", img, p) for img, p in imaging["ca_pool"]]
    for path, img, p in ca_calls:
        b, h, w, c = img.shape
        coef = ca_coefficients(p, c, device=device)
        bank = coef.permute(2, 0, 1)[None].contiguous()   # [1, C, p, p]
        nchw = img.permute(0, 3, 1, 2)
        out_n = b * (h // p) * (w // p)
        cfg = ca_config(b, h, w, c, p, True, sms, img.data_ptr() % 16 == 0)
        with float32_convs():
            lib = time_ms(lambda: F.conv2d(nchw, bank, stride=p))
        add("ca_pool", time_ms(lambda: ca_pool(img, p, True)),
            time_ms(lambda: compressive_acquire(img, p, True)), lib,
            img.numel() * 4 + coef.numel() * 4 + out_n * 4,
            2 * out_n * p * p * c, "tf32", path, B=b, H=h, W=w, C=c,
            pool=p, library="F.conv2d with the coefficient bank",
            route=cfg.route, r=cfg.r, threads=cfg.threads, ctas=cfg.ctas)

    # the strip kernels: F.conv2d (TF32 off; groups=C for depthwise) on the
    # same padded codes is the yardstick; record whether cuDNN was exact
    for kernel, run, plain in (
            ("conv_strip", strip.conv_strip, strip.conv_strip_ref),
            ("conv_strip_depthwise", strip.conv_strip_depthwise,
             strip.conv_strip_depthwise_ref)):
        for xp, wf, stride, sh, conv in imaging[kernel]:
            b, hp, wp, c_in = xp.shape
            dw = kernel == "conv_strip_depthwise"
            k = math.isqrt(wf.shape[0]) if dw else wf.shape[0]
            co = wf.shape[-1]
            lib_fn = strip_library(xp, wf, stride, dw)
            kw = dict(stride=stride, strip_h=sh)
            out = run(xp, wf, **kw)
            with float32_convs():
                lib = time_ms(lib_fn)
                exact = torch.equal(lib_fn().permute(0, 2, 3, 1), out)
            n_out = out.numel()
            macs = n_out * k * k * (1 if dw else c_in)
            if dw:
                cfg = dw_config(b, out.shape[1], out.shape[2], c_in, k,
                                stride)
                launch = dict(tile=[cfg.tx, cfg.tyt * cfg.run], run=cfg.run,
                              cb=cfg.cb, ctas=cfg.ctas)
            else:
                launch = dict(ctas=strip_config(
                    b, out.shape[1], out.shape[2], c_in, co, k, stride).ctas)
            add(kernel, time_ms(lambda: run(xp, wf, **kw)),
                time_ms(lambda: plain(xp, wf, **kw)), lib,
                (xp.numel() + wf.numel() + n_out) * 4, 2 * macs, "int8",
                "imaging", conv=conv, x_padded=list(xp.shape),
                w=list(wf.shape), stride=stride, library="F.conv2d" + (
                    f" groups={co}" if dw else ""), library_exact=exact,
                **launch)

    for x, w, bias in conv_bank_calls(device):
        b, h, ww, ci = x.shape
        k, co = w.shape[0], w.shape[-1]
        kw = dict(spec=W4A4, strategy="resident", act="relu", bias=bias)
        nchw = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def lib_fn(nchw=nchw, w_oihw=w_oihw, k=k, bias=bias):
            return torch.relu(F.conv2d(nchw, w_oihw, bias, padding=k // 2))
        with float32_convs():
            lib = time_ms(lib_fn)
        n_out = b * h * ww * co
        add("conv_bank", time_ms(lambda: conv_bank(x, w, **kw)),
            time_ms(lambda: conv_bank_plain(x, w, **kw)), lib,
            (x.numel() + w.numel() + 2 * co + n_out) * 4,
            2 * n_out * k * k * ci, "int8", "conv_bank_op", x=list(x.shape),
            w=list(w.shape), strategy="resident",
            library="F.conv2d + bias + relu (float)",
            ctas=strip_config(b, h, ww, ci, co, k, 1).ctas)
    return rows, detail


def load_trace(prof, path):
    """Export a finished profiler session as a Chrome trace at ``path``
    and return its events."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def host_range(events, name):
    """(start, end) in µs of the one host annotation ``name``."""
    found = [e for e in events if e.get("name") == name
             and e.get("cat") == "user_annotation"]
    need(len(found) == 1, f"trace: {len(found)} ranges named {name}")
    return found[0]["ts"], found[0]["ts"] + found[0]["dur"]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_work(events, name, cats=DEVICE_CATS):
    """The device events (of the categories ``cats``) that the host called
    for inside the host range ``name``, and how many launches of a kernel
    it made there. Matched by CUPTI correlation id to the runtime or
    driver call that issued them, not by timestamp: the trace's device
    clock can sit further from the host clock than a range is long."""
    lo, hi = host_range(events, name)
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and lo <= e["ts"] <= hi and "correlation" in e.get("args", {})]
    ids = {e["args"]["correlation"] for e in calls}
    launches = sum("LaunchKernel" in e["name"] for e in calls)
    return [e for e in events if e.get("cat") in cats
            and e.get("args", {}).get("correlation") in ids], launches


def phase_device_time(device, vision, imaging, trace_path,
                      iters=DEVICE_ITERS):
    """Device time of each kernel per bucket-8 batch (all its calls), from
    one ``torch.profiler`` session: each kernel's batches run in a host
    range that ends in a synchronize, so its device work lies inside the
    range; the kernel's own device time there is summed. photonic_mvm's
    imaging calls are their own range (``photonic_mvm.imaging``), and each
    path shape of photonic_mvm and of the dense strip conv is timed alone,
    beside its library call (``<kernel>.shape<i>``, ``library.<kernel>.
    shape<i>``: every kernel the library launched); ``ca_pool.cold`` is
    the first p = 1 imaging call with ``L2_FLUSH_BYTES`` written before
    each launch, so it reads its input from HBM. None where the profiler
    shows no device time."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.compressive import ca_coefficients
    from repro_torch.kernels.ca_pool.ops import ca_pool
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.fused import conv_chain
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.kernels.photonic_mvm.ops import mvm_int
    if device.type != "cuda":
        return {k: None for k in KERNELS + ("photonic_mvm.imaging",
                                          "ca_pool.imaging", "ca_pool.cold")}
    bank = conv_bank_calls(device)
    batches = {
        "photonic_mvm": lambda: [mvm_int(a, w) for a, w in
                                 vision["photonic_mvm"]],
        "photonic_mvm.imaging": lambda: [mvm_int(a, w) for a, w in
                                         imaging["photonic_mvm"]],
        "conv_chain": lambda: [conv_chain(*c) for c in vision["conv_chain"]],
        "ca_pool": lambda: [ca_pool(img, p, True)
                            for img, p in vision["ca_pool"]],
        "ca_pool.imaging": lambda: [ca_pool(img, p, True)
                                    for img, p in imaging["ca_pool"]],
        "conv_strip": lambda: [strip.conv_strip(xp, w, stride=s, strip_h=sh)
                               for xp, w, s, sh, _ in imaging["conv_strip"]],
        "conv_strip_depthwise": lambda: [
            strip.conv_strip_depthwise(xp, w, stride=s, strip_h=sh)
            for xp, w, s, sh, _ in imaging["conv_strip_depthwise"]],
        "conv_bank": lambda: run_conv_bank_op(bank, ("resident",))}
    # per path shape of the two redesigned kernels: the kernel, and the
    # library call on the same inputs (all of its kernels)
    mvm_calls = vision["photonic_mvm"] + imaging["photonic_mvm"]
    for i, (a, w) in enumerate(mvm_calls):
        batches[f"photonic_mvm.shape{i}"] = lambda a=a, w=w: mvm_int(a, w)
        batches[f"library.photonic_mvm.shape{i}"] = mvm_library(a, w)[0]
    for kernel, run in (("conv_strip", strip.conv_strip),
                        ("conv_strip_depthwise", strip.conv_strip_depthwise)):
        for i, (xp, w, s, sh, _) in enumerate(imaging[kernel]):
            batches[f"{kernel}.shape{i}"] = \
                lambda xp=xp, w=w, s=s, sh=sh, run=run: run(
                    xp, w, stride=s, strip_h=sh)
            batches[f"library.{kernel}.shape{i}"] = strip_library(
                xp, w, s, kernel == "conv_strip_depthwise")
    for i, (img, p) in enumerate(vision["ca_pool"] + imaging["ca_pool"]):
        coef = ca_coefficients(p, img.shape[-1], device=device)
        coef_bank = coef.permute(2, 0, 1)[None].contiguous()
        batches[f"ca_pool.shape{i}"] = lambda img=img, p=p: ca_pool(img, p,
                                                                   True)
        batches[f"library.ca_pool.shape{i}"] = \
            lambda nchw=img.permute(0, 3, 1, 2), cb=coef_bank, p=p: F.conv2d(
                nchw, cb, stride=p)
    img1 = next(img for img, p in imaging["ca_pool"] if p == 1)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)
    batches["ca_pool.cold"] = lambda: (flush.zero_(), ca_pool(img1, 1, True))
    with float32_convs():                # F.conv2d without TF32
        for batch in batches.values():
            batch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for name, batch in batches.items():
                with record_function(DEVICE_RANGE + name):
                    for _ in range(iters):
                        batch()
                    torch.cuda.synchronize()
    events = load_trace(prof, trace_path)
    out = {}
    for name in batches:
        kernels, launches = device_work(events, DEVICE_RANGE + name,
                                        ("kernel",))
        head = name.split(".")[0]
        symbol = ".*" if head == "library" else KERNEL_SYMBOLS[head]
        total = sum(e["dur"] for e in kernels
                    if re.search(symbol, e["name"].replace(" ", "")))
        if len(kernels) < launches:       # the profiler lost a record
            log(f"[device time] {name}: {len(kernels)} kernel records for "
                f"{launches} launches; not measured")
            total = 0
        # microseconds over `iters` batches -> ms per batch
        out[name] = total / iters / 1e3 if total > 0 else None
    return out


def check_served(name, prog, frames, served, dev, out_shape):
    """Served answers against batch-1 runs, the reference backend and the
    CPU port, all bitwise."""
    import numpy as np
    from repro_torch import Options
    from repro_torch.core.quant import W4A4
    need(served.shape == (frames.shape[0], *out_shape),
         f"{name}: answer shape {served.shape}")
    need(bool(np.isfinite(served).all()), f"{name}: non-finite answer")
    exe = prog.compile(Options(scheme=W4A4, device=dev))
    singles = np.concatenate([exe.run_per_frame(frames[i:i + 1]).cpu()
                              .numpy() for i in range(len(frames))])
    need(np.array_equal(served, singles),
         f"{name}: served answers differ from batch-1 run_per_frame")
    ref = prog.compile(Options(scheme=W4A4, device=dev, backend="reference"))
    need(np.array_equal(served, ref.run_per_frame(frames).cpu().numpy()),
         f"{name}: served answers differ from the reference backend")
    cpu = prog.compile(Options(scheme=W4A4, device="cpu"))
    need(np.array_equal(served[:4], cpu.run_per_frame(frames[:4]).numpy()),
         f"{name}: served answers differ from the port's CPU run")


def make_server(device, progs, bound, devices=1, hooks=None, slo=None,
                options=None, **config):
    """A ``serve.Server`` on ``device`` with buckets 1/2/4/8 and two batches
    in flight per device, hosting ``progs``; returns it started, with its
    hosted programs by name. ``bound``: every batch goes through the bound
    views (pinned staging ring, one CUDA graph per bucket, captured while
    the server warms), past ``hooks`` if given. Otherwise every batch goes,
    through the ``Hooks.execute`` seam, to the unbound executable's eager
    ``run_padded``, as the port served before ``Executable.bind`` (each
    bucket warmed; pageable copies). ``slo`` maps program names to their
    SLOs; ``options`` replaces the W4A4 ``Options`` on ``device``;
    ``config`` adds ``ServeConfig`` fields."""
    from repro_torch import Options, serve
    from repro_torch.core.quant import W4A4
    dev = str(device)
    hosted = {}

    def eager(program, index, frames, bucket, default):
        return hosted[program].executable.run_padded(frames, bucket)

    server = serve.Server(
        serve.ServeConfig(max_batch=BUCKET, max_wait_ms=2.0, device=dev,
                          devices=devices, max_inflight=2,
                          batch_buckets=BUCKETS, **config),
        hooks=hooks if bound else serve.Hooks(execute=eager))
    for name, prog in progs.items():
        hosted[name] = server.register(
            name, prog, options or Options(scheme=W4A4, device=dev),
            slo=(slo or {}).get(name))
    server.start(warm=bound)
    if not bound:
        for h in hosted.values():
            h.executable.warm(BUCKETS)
    return server, hosted


def credited(hosted):
    """Launches credited so far by the replays of every captured graph of
    the hosted programs' bound views, by kernel."""
    out = dict.fromkeys(KERNELS, 0)
    for h in hosted.values():
        for exe in h.bound:
            for g in exe._binding.graphs.values():
                for k, n in g.launches.items():
                    out[k] += g.replays * n
    return out


def serve_window(server, reqs, window=SERVE_WINDOW):
    """The requests submitted at once, the launch counts zeroed just before
    and read just after. Returns (answers, counts, wall seconds)."""
    import torch.profiler
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    t0 = time.perf_counter()
    # the window a profiler trace reads the device's busy share in
    with torch.profiler.record_function(window):
        futs = [server.submit(name, f) for name, f in reqs]
        outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    return outs, launch_counts(), wall


def serve_path(device, progs, reqs, bound=False, devices=1):
    """``reqs`` served once by a fresh :func:`make_server`. Returns
    (answers, counts, stats, wall seconds)."""
    server, _ = make_server(device, progs, bound, devices)
    try:
        outs, counts, wall = serve_window(server, reqs)
    finally:
        server.stop()
    return outs, counts, server.stats(), wall


def by_program(reqs, outs):
    import numpy as np
    grouped = {}
    for (name, f), out in zip(reqs, outs):
        fs, os_ = grouped.setdefault(name, ([], []))
        fs.append(f)
        os_.append(np.asarray(out))
    return {name: (np.concatenate(fs), np.concatenate(os_))
            for name, (fs, os_) in grouped.items()}


def vision_requests(progs, n=VISION_REQUESTS):
    sizes = [1, 2, 3, 1, 5, 1, 2, 8]
    return [(("lenet", "vgg9")[i % 2],
             frames_for(progs[("lenet", "vgg9")[i % 2]],
                        sizes[(i // 2) % len(sizes)], 100 + i))
            for i in range(n)]


def out_shape(name, prog):
    """The answer's per-frame shape: classes, or the output image."""
    if name in ("lenet", "vgg9", "vgg16"):
        return {"lenet": (10,), "vgg9": (100,), "vgg16": (1000,)}[name]
    return prog.output_hwc


def phase_serve_vision(device, progs):
    """LeNet and VGG9-CA behind one Server on the card, eager (unbound)."""
    reqs = vision_requests(progs)
    outs, counts, stats, wall = serve_path(device, progs, reqs)
    for name, (frames, served) in by_program(reqs, outs).items():
        check_served(name, progs[name], frames, served, str(device),
                     out_shape(name, progs[name]))
    return counts, stats, wall, sum(f.shape[0] for _, f in reqs)


def imaging_requests(progs, sizes=(1, 3, 8)):
    return [(name, frames_for(progs[name], n, 200 + 10 * i + j))
            for i, n in enumerate(sizes)
            for j, name in enumerate(progs)]


def psnr_db(prog, frames, served, device):
    from repro_torch.imaging import apply_float, psnr
    ref = apply_float(prog.layers, prog.params, frames_on(frames, device))
    return float(psnr(ref, frames_on(served, device)))


def phase_serve_imaging(device, progs):
    """The eight imaging pipelines at 256x256x3 behind one Server on the
    card, eager (unbound); PSNR of the served answers against the float
    oracle."""
    reqs = imaging_requests(progs)
    outs, counts, stats, wall = serve_path(device, progs, reqs)
    quality = {}
    for name, (frames, served) in by_program(reqs, outs).items():
        prog = progs[name]
        check_served(name, prog, frames, served, str(device),
                     out_shape(name, prog))
        quality[name] = psnr_db(prog, frames, served, device)
    return counts, stats, wall, sum(f.shape[0] for _, f in reqs), quality


def chain_program(hw=IMAGING_HW):
    """The reference's acceptance chain, denoise_gauss -> edge_detect ->
    sharpen, as one program at hw x hw x 3."""
    from repro_torch import Program
    first, second, third = (Program.from_pipeline(n, hw, hw, c)
                            for n, c in CHAIN)
    return first.then(second).then(third)


def triple_in_flight(hosted):
    """Three batches of different content at bucket 4 through the hosted
    program's bound view, none waited on until all three are enqueued: the
    static output is overwritten twice and a staging slot reused before
    the first answer is read. Each must be its own batch-1 answers."""
    import numpy as np
    prog, exe = hosted.program, hosted.executable
    frames = [frames_for(prog, 4, 900 + i) for i in range(3)]
    pending = [hosted.bound[0].run_padded(f, 4) for f in frames]
    outs = [np.asarray(p) for p in pending]
    for i, (f, out) in enumerate(zip(frames, outs)):
        want = np.concatenate([exe.run_per_frame(f[j:j + 1]).cpu().numpy()
                               for j in range(len(f))])
        need(np.array_equal(out, want), f"{hosted.name}: batch {i} of three "
             f"in flight differs from its batch-1 answers")
    need(not any(np.shares_memory(a, b) for a in outs for b in outs
                 if a is not b), f"{hosted.name}: two answers share memory")
    need(not np.array_equal(outs[0], outs[1]),
         f"{hosted.name}: different frames gave one answer")


def phase_serve_bound(device, vision_progs, imaging_progs, chain, devices):
    """Every path through bound views: LeNet, VGG9-CA, the eight pipelines
    and the chain behind one Server (``devices`` workers, two batches in
    flight each), each path in its own window with the launch counts
    zeroed before and read after. Every answer is held against batch-1
    runs, the reference backend and the CPU port; each window's counts must
    equal what the replays of the captured graphs credited; three batches
    in flight on one bound view must each give their own answers."""
    progs = {**vision_progs, **imaging_progs, "chain": chain}
    windows = {"vision": vision_requests(vision_progs),
               "imaging": imaging_requests(imaging_progs),
               "chain": imaging_requests({"chain": chain})}
    t0 = time.perf_counter()
    server, hosted = make_server(device, progs, True, devices)
    bind_s = time.perf_counter() - t0
    out = {"bind_and_capture_s": bind_s, "windows": {}}
    try:
        for path, reqs in windows.items():
            before = credited(hosted)
            outs, counts, wall = serve_window(server, reqs)
            after = credited(hosted)
            need(counts == {k: after[k] - before[k] for k in KERNELS},
                 f"bound {path}: launch counts {counts} are not the "
                 f"replays' credits")
            quality = {}
            for name, (frames, served) in by_program(reqs, outs).items():
                check_served(name, progs[name], frames, served, str(device),
                             out_shape(name, progs[name]))
                if path != "vision":
                    quality[name] = psnr_db(progs[name], frames, served,
                                            device)
            out["windows"][path] = {
                "counts": counts, "wall_s": wall, "psnr_db": quality,
                "frames": sum(f.shape[0] for _, f in reqs)}
        for name in ("lenet", "edge_detect", "chain"):
            triple_in_flight(hosted[name])
        out["graphs"] = {name: {
            str(b): g.launches
            for b, g in h.bound[0]._binding.graphs.items()}
            for name, h in hosted.items()}
    finally:
        server.stop()
    out["stats"] = server.stats()
    return out


def saturate_for(server, name, pool, seconds, cap=200000):
    """``loadgen.saturate`` with single-frame requests, the count grown
    until one run lasts at least 0.8 * ``seconds`` (or reaches ``cap``);
    returns that run's report."""
    from repro_torch import serve
    n = 64
    while True:
        rep = serve.saturate(server, name, pool, n_requests=n)
        need(rep.served == n, f"{name}: saturate served {rep.served} of {n}")
        if rep.duration_s >= 0.8 * seconds or n >= cap:
            return rep
        n = min(cap, max(2 * n, int(n * seconds / rep.duration_s)))


def phase_load(device, progs, saturate_s, poisson_s):
    """Served frames/s at saturation (``loadgen.saturate``, single-frame
    requests for about ``saturate_s`` seconds) and p50/p99 under open-loop
    Poisson load at half the bound path's saturation rate (about
    ``poisson_s`` seconds), each program bound (graphs) and eager
    (unbound), bound first."""
    from repro_torch import serve
    out = {name: {} for name in progs}
    for mode in ("bound", "eager"):
        server, _ = make_server(device, progs, mode == "bound")
        try:
            for i, (name, prog) in enumerate(progs.items()):
                pool = frames_for(prog, 16, 700 + i)
                sat = saturate_for(server, name, pool, saturate_s)
                n = sat.submitted
                rate = 0.5 * out[name]["bound"]["saturate_fps"] \
                    if mode == "eager" else 0.5 * sat.achieved_fps
                m = int(min(max(rate * poisson_s, 32), 20000))
                load = serve.poisson_load(server, name, pool, rate_rps=rate,
                                          n_requests=m, seed=i)
                out[name][mode] = {
                    "saturate_fps": sat.achieved_fps,
                    "saturate_requests": n,
                    "poisson_rate_rps": rate, "poisson_requests": m,
                    "poisson_served": load.served,
                    "poisson_shed": load.shed,
                    "poisson_rejected": load.rejected,
                    "poisson_behind_schedule": load.behind_schedule,
                    "poisson_achieved_fps": load.achieved_fps,
                    "latency_ms": load.latency_ms}
        finally:
            server.stop()
    return out


def phase_busy_share(device, progs, trace_path, bound=False):
    """The imaging requests served once more under ``torch.profiler``, eager
    or through the bound views: the share of the serving window in which
    the card ran anything (the union of the kernel, copy and memset
    intervals that the window's host calls issued, over the window's
    length), with the device time summed by kind of work. None on the
    CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return None
    reqs = imaging_requests(progs)
    server, _ = make_server(device, progs, bound)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve_window(server, reqs)
            torch.cuda.synchronize()
    finally:
        server.stop()
    return dict(busy_share(load_trace(prof, trace_path)),
                frames=sum(f.shape[0] for _, f in reqs))


def busy_share(events):
    """The serving window's length, the union of the device intervals its
    host calls issued, their share of the window, and the device time by
    kind of work (copies, memsets, the port's kernels, torch ops) and by
    port kernel."""
    lo, hi = host_range(events, SERVE_WINDOW)
    spans, by_kind, by_kernel = [], {}, {}
    for e in device_work(events, SERVE_WINDOW)[0]:
        a, b = e["ts"], e["ts"] + e["dur"]
        spans.append((a, b))
        kind = e["cat"] if e["cat"] != "kernel" else (
            "port kernels" if re.search(PORT_KERNEL, e["name"])
            else "torch ops")
        by_kind[kind] = by_kind.get(kind, 0.0) + (b - a) / 1e3
        if kind == "port kernels":
            name = e["name"].replace(" ", "")
            k = next((k for k in KERNELS[:-1]
                      if re.search(KERNEL_SYMBOLS[k], name)), "other")
            by_kernel[k] = by_kernel.get(k, 0.0) + (b - a) / 1e3
    busy, end = 0.0, None
    for a, b in sorted(spans):
        busy += max(0.0, b - (a if end is None else max(a, end)))
        end = b if end is None else max(end, b)
    return {"window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (hi - lo), "device_ms_by_kind": by_kind,
            "port_kernel_ms": by_kernel}


def check_trace_cli(path, *flags):
    """``scripts/check_trace.py`` on ``path`` in a subprocess (the script
    is stdlib only and not imported here); fails unless it exits 0."""
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "scripts", "check_trace.py"),
         path, *flags], capture_output=True, text=True, timeout=300)
    need(out.returncode == 0, f"check_trace.py {os.path.basename(path)} "
         f"{' '.join(flags)}: {(out.stderr or out.stdout).strip()}")


def http_get(url):
    """(status, body) of a GET on the admin endpoint (loopback)."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def phase_obs_serve(device, vision_progs, imaging_progs, out_dir):
    """LeNet, VGG9-CA and edge_detect behind one bound server with a
    ``Trace`` enabled, the admin endpoint up, LeNet under a tight SLO and
    an execute hook that can fail one batch: the answers bitwise as in the
    serve phases; the five admin routes answer 200, ``/metrics`` has each
    program's ``serve_`` lines and ``/tracez`` passes ``check_trace.py
    --flight``; the SLO breach is counted, logged and dumped, an injected
    ``WorkerError`` dumps, both dumps pass ``--flight --require-trigger``;
    the exported trace passes ``check_trace.py --min-devices 1``."""
    from repro_torch import obs, serve
    progs = {**vision_progs, "edge_detect": imaging_progs["edge_detect"]}
    armed = {"edge_detect": False}

    def execute(program, index, frames, bucket, default):
        if armed.get(program):
            armed[program] = False
            raise RuntimeError("injected device fault")
        return default()

    out = {}
    breaches0 = obs.counter("slo.breach.lenet").get()
    dump_dir = os.path.join(out_dir, "flight")
    trace = obs.enable()
    try:
        server, _ = make_server(
            device, progs, True, hooks=serve.Hooks(execute=execute),
            slo={"lenet": obs.SLO(p99_ms=0.001, min_count=1)},
            admin_port=0, flight_dump_dir=dump_dir,
            flight_dump_interval_s=0.0, flight_dump_keep=16)
        try:
            ready = server.readiness()
            need(ready["ready"], f"[obs] not ready after start: {ready}")
            reqs = vision_requests(vision_progs) + imaging_requests(
                {"edge_detect": progs["edge_detect"]})
            outs, counts, wall = serve_window(server, reqs)
            for name, (frames, served) in by_program(reqs, outs).items():
                check_served(name, progs[name], frames, served, str(device),
                             out_shape(name, progs[name]))
            out["window"] = {"frames": sum(f.shape[0] for _, f in reqs),
                             "wall_s": wall, "launches": counts}

            url = server.admin.url
            sizes = {}
            for route in ("/healthz", "/readyz", "/metrics", "/statusz",
                          "/statusz?format=text"):
                code, body = http_get(url + route)
                need(code == 200, f"[obs] {route} answered {code}")
                sizes[route] = len(body)
            metrics = http_get(url + "/metrics")[1].decode()
            for name in progs:
                need(f"serve_{name}_served " in metrics,
                     f"[obs] /metrics has no serve_{name}_served line")
            tracez = os.path.join(out_dir, "obs_tracez.json")
            with open(tracez, "wb") as f:
                f.write(http_get(url + "/tracez")[1])
            check_trace_cli(tracez, "--flight")
            out["admin"] = {"url": url, "bytes": sizes}

            need(obs.counter("slo.breach.lenet").get() > breaches0,
                 "[obs] the tight SLO was not breached")
            need(any(r["event"] == "serve.slo.breach"
                     and r["program"] == "lenet"
                     for r in server.log.recent()),
                 "[obs] no structured-log line for the SLO breach")
            slo_dump = next((d for d in server.flight_dumps()
                             if d["reason"].startswith("slo:lenet:")), None)
            need(slo_dump is not None and slo_dump["path"] is not None,
                 "[obs] the SLO breach left no dump")
            check_trace_cli(slo_dump["path"], "--flight",
                            "--require-trigger")

            armed["edge_detect"] = True
            fut = server.submit("edge_detect",
                                frames_for(progs["edge_detect"], 1, 999))
            try:
                fut.result(timeout=120)
                need(False, "[obs] the injected fault did not fail a batch")
            except serve.WorkerError:
                pass
            t0 = time.perf_counter()
            while not any(d["reason"] == "worker_error:edge_detect"
                          for d in server.flight_dumps()):
                need(time.perf_counter() - t0 < 60,
                     "[obs] the WorkerError left no dump")
                time.sleep(0.01)
            err_dump = next(d for d in server.flight_dumps()
                            if d["reason"] == "worker_error:edge_detect")
            check_trace_cli(err_dump["path"], "--flight",
                            "--require-trigger")
            out["dumps"] = [{k: v for k, v in d.items() if k != "dump"}
                            for d in server.flight_dumps()]
            out["stats"] = server.stats(verbose=True)
        finally:
            server.stop()
    finally:
        obs.disable()
    path = os.path.join(out_dir, OBS_TRACE)
    trace.export(path)
    check_trace_cli(path, "--min-devices", "1")
    summary = trace.summary()
    out["trace"] = {"records": len(trace.records()),
                    "device_spans": summary.get("serve.device.execute"),
                    "request_device_spans": summary.get(
                        "serve.request.device")}
    return out


def phase_obs_busy(device, progs, trace_path):
    """The bound imaging burst once more, under ``torch.profiler`` and a
    ``Trace`` at once: the ``serve.device.execute`` spans (each ends when
    the worker's wait on the batch's answer returned) must sum to at least
    the card's busy time in the window. None on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    if device.type != "cuda":
        return None
    reqs = imaging_requests(progs)
    server, _ = make_server(device, progs, True)
    try:
        trace = obs.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                serve_window(server, reqs)
                torch.cuda.synchronize()
        finally:
            obs.disable()
    finally:
        server.stop()
    busy = busy_share(load_trace(prof, trace_path))
    spans = trace.spans("serve.device.execute")
    span_ms = sum(s["t1_ns"] - s["t0_ns"] for s in spans) / 1e6
    need(span_ms >= busy["busy_ms"],
         f"[obs] device spans sum to {span_ms:.3f} ms, less than the "
         f"{busy['busy_ms']:.3f} ms the card was busy")
    return {"device_span_ms": span_ms, "device_spans": len(spans),
            "cupti_busy_ms": busy["busy_ms"], "window_ms": busy["window_ms"]}


def run_variant(server, name, pool, n, variant, recorder):
    """One ``loadgen.saturate`` run of ``n`` single-frame requests under an
    observability variant: A no recorder, B the default recorder, C the
    recorder and a ``Trace``, D the recorder with the admin endpoint
    polled every ``ADMIN_POLL_S``. Returns (frames/s, recorder records
    per request)."""
    import threading
    from repro_torch import obs, serve
    stop, errors = threading.Event(), []

    def poll():
        while not stop.wait(ADMIN_POLL_S):
            for route in ("/metrics", "/healthz"):
                try:
                    code, _ = http_get(server.admin.url + route)
                    if code != 200:
                        errors.append(f"{route}: {code}")
                except OSError as e:
                    errors.append(f"{route}: {e}")

    if variant == "A":
        obs.uninstall()
    trace = obs.enable() if variant == "C" else None
    poller = threading.Thread(target=poll) if variant == "D" else None
    if poller is not None:
        poller.start()
    rec0 = recorder.stats()["recorded_total"]
    try:
        rep = serve.saturate(server, name, pool, n_requests=n)
    finally:
        stop.set()
        if poller is not None:
            poller.join(60)
        if trace is not None:
            obs.disable()
        obs.install(recorder)
    need(not errors, f"[obs] admin polling failed: {errors[:3]}")
    need(poller is None or not poller.is_alive(), "[obs] poller hung")
    need(rep.served == n, f"[obs] {name} {variant}: served {rep.served} of "
         f"{n}")
    per_req = (recorder.stats()["recorded_total"] - rec0) / n
    return rep.achieved_fps, per_req


def phase_obs_cost(device, progs, seconds):
    """What observability costs the bound path: for each program,
    ``loadgen.saturate`` with single-frame requests under the variants in
    the order ``OBS_VARIANTS`` (A B C D D C B A), every run the same
    request count (sized once to last about ``seconds`` with the default
    recorder); frames/s per run and each variant's mean over A's."""
    from repro_torch import obs
    recorder = obs.get_flight()
    need(recorder is not None, "[obs] no default flight recorder")
    server, _ = make_server(device, progs, True, admin_port=0)
    out = {}
    try:
        for i, (name, prog) in enumerate(progs.items()):
            pool = frames_for(prog, 16, 800 + i)
            n = saturate_for(server, name, pool, seconds).submitted
            runs = {v: [] for v in "ABCD"}
            per_req = {v: [] for v in "ABCD"}
            for v in OBS_VARIANTS:
                fps, puts = run_variant(server, name, pool, n, v, recorder)
                runs[v].append(fps)
                per_req[v].append(puts)
            mean = {v: sum(r) / len(r) for v, r in runs.items()}
            out[name] = {"requests": n, "fps": runs,
                         "records_per_request": per_req,
                         "ratio_to_A": {v: mean[v] / mean["A"]
                                        for v in "BCD"}}
    finally:
        server.stop()
        obs.install(recorder)
    return out


# ---------------------------------------------------------------------------
# the [vgg16] phase
# ---------------------------------------------------------------------------

def vgg16_program(hw=VGG16_HW):
    """VGG16 at hw x hw x 3, full channel widths, seeded numpy weights."""
    from repro_torch import Program
    from repro_torch.models.vision import vgg16_ir
    from repro_torch.weights import params_from_numpy
    layers = tuple(vgg16_ir(in_hw=hw))
    return Program(layers, params_from_numpy(numpy_params(layers, SEED + 2),
                                             "cpu"), (hw, hw, 3),
                   name="vgg16")


def plan_kernels(plan):
    """The kernels a plan's steps launch through the kernel backend."""
    from repro_torch.core.plan import CAStep, ConvStep, DenseStep
    fused = {i for s in plan.fused_segments
             for i in range(s.start, s.start + s.length)}
    out = {"conv_chain"} if fused else set()
    for i, step in enumerate(plan.steps):
        if i in fused:
            continue
        if isinstance(step, CAStep):
            out.add("ca_pool")
        elif isinstance(step, ConvStep) and step.strategy.kind == "strip":
            out.add("conv_strip_depthwise" if step.geom.depthwise
                    else "conv_strip")
        elif isinstance(step, (ConvStep, DenseStep)):
            out.add("photonic_mvm")
    return out


def vgg16_compile(prog, device, budget):
    """VGG16 compiled cold under W4A4 and MX_43 with ``verify="on"``: each
    report clean and the plan's kernels ``PATH_KERNELS["vgg16"]``; the
    ``plan.verify`` span's time, and the per-step headroom
    (``verify_plan(include_info=True)``'s LTR003 findings)."""
    from repro_torch import Options, analysis, obs
    from repro_torch.core.quant import MX_43, W4A4
    out, exes = {}, {}
    for label, scheme in (("w4a4", W4A4), ("mx43", MX_43)):
        opts = Options(scheme=scheme, device=str(device),
                       conv_vmem_budget=budget, verify="on")
        trace = obs.enable()
        try:
            t0 = time.perf_counter()
            exe = prog.compile(opts)
            compile_ms = (time.perf_counter() - t0) * 1e3
        finally:
            obs.disable()
        span = trace.summary().get("plan.verify")
        need(span is not None and span["count"] == 1,
             f"[vgg16] {label}: the cold compile ran {span} plan.verify spans")
        need(exe.report.verification == [],
             f"[vgg16] {label}: verification {exe.report.verification}")
        need(exe.plan.exact_proven, f"[vgg16] {label}: not proven exact")
        kernels = plan_kernels(exe.plan)
        need(kernels == set(PATH_KERNELS["vgg16"]),
             f"[vgg16] {label}: the plan launches {sorted(kernels)}")
        diags = analysis.verify_plan(exe.plan, budget=budget)
        need(not analysis.errors(diags), f"[vgg16] {label}: errors")
        out[label] = {
            "compile_ms": compile_ms, "verify_span_ms": span["total_ms"],
            "headroom_bits": {
                d.step: float(d.message.split("headroom ")[1].split(" ")[0])
                for d in diags if d.code == "LTR003"},
            "strategies": {n: v["kind"] for n, v in
                           exe.report.conv_strategy.items()}}
        exes[label] = (exe, opts)
    return out, exes


def vgg16_kernels(device, buckets):
    """The strip and photonic_mvm kernels at every ``VGG16_SHAPES`` entry
    and bucket, raw and with the epilogue, bitwise against their plain
    versions. Returns ({kernel: max abs err}, {kernel: comparisons})."""
    import torch
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.edge_shapes import VGG16_SHAPES, vgg16_case
    from repro_torch.kernels.photonic_mvm.ops import mvm_int
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    errs = {"conv_strip": [], "photonic_mvm": []}

    def compare(kernel, got, want, what):
        need(got.shape == want.shape and bool(torch.isfinite(got).all()),
             f"[vgg16] {kernel} {what}: shape {tuple(got.shape)} or not "
             f"finite")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        errs[kernel].append(err)
        need(torch.equal(got, want), f"[vgg16] {kernel} {what}: differs "
             f"from its plain version (max abs err {err})")

    for kernel, shapes in VGG16_SHAPES.items():
        for shape in shapes:
            for b in buckets:
                args = vgg16_case(kernel, shape, b, gen, device)
                what = f"{shape[0]} batch {b}"
                if kernel == "conv_strip":
                    xp, w, stride, sh = args
                    kw = dict(stride=stride, strip_h=sh)
                    compare(kernel, strip.conv_strip(xp, w, **kw),
                            strip.conv_strip_ref(xp, w, **kw), what)
                    co = w.shape[-1]
                    ws = torch.rand((co,), generator=gen, device=device) + .5
                    bias = torch.randn((co,), generator=gen, device=device)
                    kw.update(act_scale=0.37, act="relu", bias=bias)
                    compare(kernel, strip.conv_strip(xp, w, ws, **kw),
                            strip.conv_strip_ref(xp, w, ws, **kw),
                            f"{what} with epilogue")
                else:
                    a, wq = args
                    compare(kernel, mvm_int(a, wq), mvm_int_ref(a, wq), what)
                    ws = torch.rand((wq.shape[1],), generator=gen,
                                    device=device) + 0.5
                    compare(kernel, mvm_int(a, wq, ws, 0.37),
                            mvm_int_ref(a, wq, ws, 0.37),
                            f"{what} with epilogue")
    return ({k: max(v) for k, v in errs.items()},
            {k: len(v) for k, v in errs.items()})


def vgg16_expected(prog, frames, device, options):
    """VGG16's answers to ``frames`` by the three oracles: batch-1
    ``run_per_frame`` on the card, the reference backend on the card, and
    the port's CPU run of the first ``VGG16_CPU_FRAMES`` frames."""
    import dataclasses
    import numpy as np
    exe = prog.compile(options)
    singles = np.concatenate([exe.run_per_frame(frames[i:i + 1]).cpu()
                              .numpy() for i in range(len(frames))])
    ref = prog.compile(dataclasses.replace(options, backend="reference"))
    cpu = prog.compile(dataclasses.replace(options, device="cpu"))
    return (singles, ref.run_per_frame(frames).cpu().numpy(),
            cpu.run_per_frame(frames[:VGG16_CPU_FRAMES]).numpy())


def vgg16_check(window, frames, served, expected):
    import numpy as np
    singles, ref, cpu = expected
    need(served.shape == (frames.shape[0], 1000)
         and bool(np.isfinite(served).all()),
         f"[vgg16] {window}: answers {served.shape}, or not finite")
    need(np.array_equal(served, singles), f"[vgg16] {window}: answers "
         f"differ from batch-1 run_per_frame")
    need(np.array_equal(served, ref), f"[vgg16] {window}: answers differ "
         f"from the reference backend")
    need(np.array_equal(served[:VGG16_CPU_FRAMES], cpu), f"[vgg16] "
         f"{window}: answers differ from the port's CPU run")


def vgg16_timing(device, exe, trace_path):
    """Each conv and dense step of VGG16 at bucket 8 on random codes and
    its own levels: the kernel, its route through dispatch (pads and
    slicing included), its plain version and its library call, timed by
    CUDA events over ``VGG16_ITERS`` calls (``<name>_ms``); the kernel, the
    library call and the forced-resident route also by their device time
    in one profiler session (``<name>_device_ms``: every kernel the call
    launched); and the bound (the conv's own output, not the strip
    padding's surplus rows; bytes over 3.35 TB/s or operations over the
    int8 peak). Each strip step is also forced resident (im2col +
    photonic_mvm: the route, and the GEMM alone)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.plan import ConvStep, DenseStep
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.kernels.photonic_mvm.ops import mvm_config, mvm_int
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    cuda = device.type == "cuda"
    time_ms = timer(device)
    iters = VGG16_ITERS if cuda else 1
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    plan, params = exe.plan, exe.params()
    b, rows = BUCKET, []
    resident = dispatch.ConvStrategy("resident")
    for step in plan.steps:
        if not isinstance(step, (ConvStep, DenseStep)):
            continue
        wq, _ = quantize_weight(params[step.name]["w"], step.wa)
        if isinstance(step, DenseStep):
            a = torch.randint(0, 16, (b, wq.shape[0]), generator=gen,
                              device=device, dtype=torch.int8)
            w2 = wq.to(torch.int8)
            m, k, n = a.shape[0], wq.shape[0], wq.shape[1]
            lib_fn, lib_name = mvm_library(a, w2)
            kernel = lambda a=a, w2=w2: mvm_int(a, w2)
            row = dict(layer=step.name, kernel="photonic_mvm",
                       library=lib_name, fns=dict(
                           kernel=kernel, route=kernel, library=lib_fn,
                           plain=lambda a=a, w2=w2: mvm_int_ref(a, w2)))
            nbytes, macs = m * k + k * n + 4 * m * n, m * n * k
        else:
            g = step.geom
            codes = torch.randint(0, 16, (b, g.h_in, g.w_in, g.c_in),
                                  generator=gen, device=device).float()
            hc, wc = g.conv_hw()
            macs = b * hc * wc * g.c_out * g.kernel * g.kernel * g.c_in
            nbytes = (codes.numel() + wq.numel() + b * hc * wc * g.c_out) * 4
            (plo, phi), (qlo, qhi) = g.pads
            xp_real = F.pad(codes, (0, 0, qlo, qhi, plo, phi))
            wf = wq.float()
            a = dispatch._im2col(codes, g.kernel, g.stride, g.pads)[0] \
                .to(torch.int8)
            w2 = wq.reshape(-1, g.c_out).to(torch.int8)
            m, k, n = a.shape[0], a.shape[1], g.c_out
            fns = dict(
                route=lambda codes=codes, wq=wq, g=g, st=step.strategy:
                dispatch.conv_int(codes, wq, g.stride, g.pads, strategy=st),
                library=strip_library(xp_real, wf, g.stride, False),
                resident=lambda codes=codes, wq=wq, g=g: dispatch.conv_int(
                    codes, wq, g.stride, g.pads, strategy=resident),
                resident_gemm=lambda a=a, w2=w2: mvm_int(a, w2))
            row = dict(layer=step.name, strategy=step.strategy.kind,
                       x=[b, g.h_in, g.w_in, g.c_in], c_out=g.c_out,
                       library="F.conv2d (TF32 off)", fns=fns)
            if step.strategy.kind == "strip":
                st = step.strategy
                xp = strip.pad_rows_for_strips(xp_real, g.kernel, g.stride,
                                               st.strip_rows, st.n_strips)
                kw = dict(stride=g.stride, strip_h=st.strip_rows)
                launch_rows = (xp.shape[1] - g.kernel) // g.stride + 1
                cfg = strip.strip_config(b, launch_rows, wc, g.c_in, g.c_out,
                                         g.kernel, g.stride)
                fns.update(
                    kernel=lambda xp=xp, wf=wf, kw=kw: strip.conv_strip(
                        xp, wf, **kw),
                    plain=lambda xp=xp, wf=wf, kw=kw: strip.conv_strip_ref(
                        xp, wf, **kw))
                row.update(kernel="conv_strip", launch_rows=launch_rows,
                           ctas=cfg.ctas, tile=[cfg.tx, cfg.tyt * cfg.run],
                           co_b=cfg.co_b, cc=cfg.cc)
            else:
                fns.update(kernel=fns["resident_gemm"],
                           plain=lambda a=a, w2=w2: mvm_int_ref(a, w2))
                row.update(kernel="photonic_mvm")
            with float32_convs():
                row["library_exact"] = torch.equal(
                    fns["library"]().permute(0, 2, 3, 1), fns["route"]())
        if row["kernel"] == "photonic_mvm":
            cfg = mvm_config(m, k, n)
            row.update(tile=[cfg.bm, cfg.bn], split=cfg.split)
        row.update(M=m, K=k, N=n, macs=macs)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2 * macs, "int8")
        with float32_convs():
            for name, fn in row["fns"].items():
                row[f"{name}_ms"] = time_ms(fn, iters)
        rows.append(row)
    for row in rows:
        row["ms"] = row.pop("kernel_ms")
    if cuda:
        from torch.profiler import ProfilerActivity, profile, record_function
        timed = ("kernel", "library", "resident")
        with float32_convs(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # a range nobody reads first: on the card this session lost
            # the kernel records of its first ~10 launches (conv1's range
            # had none with one warm launch before it)
            with record_function(f"{DEVICE_RANGE}vgg16.warm"):
                for _ in range(VGG16_WARM_LAUNCHES):
                    torch.zeros(1, device=device)
                rows[0]["fns"]["kernel"]()
                torch.cuda.synchronize()
            for row in rows:
                for name in timed:
                    if name in row["fns"]:
                        with record_function(
                                f"{DEVICE_RANGE}vgg16.{row['layer']}.{name}"):
                            for _ in range(VGG16_DEVICE_ITERS):
                                row["fns"][name]()
                            torch.cuda.synchronize()
        events = load_trace(prof, trace_path)
        for row in rows:
            for name in timed:
                if name not in row["fns"]:
                    continue
                kernels, launches = device_work(
                    events, f"{DEVICE_RANGE}vgg16.{row['layer']}.{name}",
                    ("kernel",))
                measured = kernels and len(kernels) >= launches
                if not measured:
                    log(f"[vgg16] {row['layer']} {name}: {len(kernels)} "
                        f"kernel records for {launches} launches; not "
                        f"measured")
                row[f"{name}_device_ms"] = (
                    sum(e["dur"] for e in kernels) / VGG16_DEVICE_ITERS / 1e3
                    if measured else None)
    for row in rows:
        del row["fns"]
    return rows


def phase_vgg16(device, rehearse, out_dir):
    """VGG16 end to end (the module docstring's phase 9). Returns its
    detail, the launch counts of its eager and bound windows, and its
    kernels' max abs errors and comparison counts."""
    import numpy as np
    hw = REHEARSAL_VGG16_HW if rehearse else VGG16_HW
    budget = REHEARSAL_VGG16_BUDGET if rehearse else None
    prog = vgg16_program(hw)
    out = {"hw": hw}
    out["compile"], exes = vgg16_compile(prog, device, budget)
    for label, c in out["compile"].items():
        log(f"[vgg16] {label} at {hw}x{hw}x3: verify=on clean, compile "
            f"{c['compile_ms']:.2f} ms of which plan.verify "
            f"{c['verify_span_ms']:.3f} ms; strategies {c['strategies']}")
    log(f"[vgg16] accumulator headroom, bits (w4a4): "
        f"{out['compile']['w4a4']['headroom_bits']}")
    exe, opts = exes["w4a4"]
    # MX_43 on two frames; W4A4 is served below
    mx_exe, mx_opts = exes["mx43"]
    f2 = frames_for(prog, 2, 1600)
    vgg16_check("mx43 run_per_frame", f2,
                mx_exe.run_per_frame(f2).cpu().numpy(),
                vgg16_expected(prog, f2, device, mx_opts))

    t0 = time.perf_counter()
    err, n_cmp = vgg16_kernels(device, (1,) if rehearse
                               else VGG16_SHAPE_BUCKETS)
    log(f"[vgg16] kernels at VGG16_SHAPES, buckets "
        f"{(1,) if rehearse else VGG16_SHAPE_BUCKETS}: bitwise equal to "
        f"their plain versions ({n_cmp} comparisons, max abs err {err}) in "
        f"{time.perf_counter() - t0:.1f}s")

    reqs = imaging_requests({"vgg16": prog}, VGG16_REQUESTS)
    frames = np.concatenate([f for _, f in reqs])
    expected = vgg16_expected(prog, frames, device, opts)
    counts = {}
    for window, bound in (("vgg16", False), ("bound vgg16", True)):
        t0 = time.perf_counter()
        server, hosted = make_server(device, {"vgg16": prog}, bound,
                                     options=opts)
        start_s = time.perf_counter() - t0
        try:
            before = credited(hosted)
            outs, c, wall = serve_window(server, reqs)
            after = credited(hosted)
        finally:
            server.stop()
        if bound:
            need(c == {k: after[k] - before[k] for k in KERNELS},
                 f"[vgg16] bound: launch counts {c} are not the replays' "
                 f"credits")
        vgg16_check(window, frames, np.concatenate(
            [np.asarray(o) for o in outs]), expected)
        counts[window] = c
        out[window] = {"start_s": start_s, "wall_s": wall, "counts": c,
                       "frames": len(frames)}
        log(f"[vgg16] served {window}: {len(frames)} frames in {wall:.3f}s "
            f"wall (start {start_s:.2f}s), bitwise equal to batch-1 "
            f"run_per_frame, the reference backend and the CPU port "
            f"({VGG16_CPU_FRAMES} frames); launches {c}")

    out["layers"] = vgg16_timing(device, exe, os.path.join(
        out_dir, VGG16_DEVICE_TRACE))
    for r in out["layers"]:
        extra = (f"; forced resident: route {r['resident_ms']:.4f} "
                 f"(device {r.get('resident_device_ms')}) gemm "
                 f"{r['resident_gemm_ms']:.4f}; library exact "
                 f"{r['library_exact']}" if "strategy" in r else "")
        log(f"[vgg16] {r['layer']} {r['kernel']}: {r['ms']:.4f} ms "
            f"(device {r.get('kernel_device_ms')}; route "
            f"{r['route_ms']:.4f}, plain {r['plain_ms']:.4f}, library "
            f"{r['library']} {r['library_ms']:.4f} device "
            f"{r.get('library_device_ms')}, bound {r['bound_ms']:.6f} by "
            f"{r['bound_by']}){extra}")

    def total(rows, key):
        vals = [r.get(key) for r in rows]
        return None if None in vals else sum(vals)

    out["by_kernel"] = {}
    for k in PATH_KERNELS["vgg16"]:
        rows = [r for r in out["layers"] if r["kernel"] == k]
        out["by_kernel"][k] = {
            key: total(rows, key)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        out["by_kernel"][k].update(
            calls=len(rows), device_ms=total(rows, "kernel_device_ms"),
            library_device_ms=total(rows, "library_device_ms"))
    strips = [r for r in out["layers"] if r["kernel"] == "conv_strip"]
    log(f"[vgg16] per bucket-8 batch: {out['by_kernel']}; strip layers "
        f"strip {total(strips, 'ms'):.4f} ms (device "
        f"{total(strips, 'kernel_device_ms')}) against forced resident "
        f"{total(strips, 'resident_ms'):.4f} ms (device "
        f"{total(strips, 'resident_device_ms')}; gemm "
        f"{total(strips, 'resident_gemm_ms'):.4f})")

    progs = {"vgg16": prog}
    out["busy"] = None
    if device.type == "cuda":
        server, _ = make_server(device, progs, True, options=opts)
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                serve_window(server, reqs)
                torch.cuda.synchronize()
        finally:
            server.stop()
        out["busy"] = busy_share(load_trace(
            prof, os.path.join(out_dir, VGG16_TRACE)))
    log(f"[vgg16] bound window, profiled: {out['busy']}")

    server, _ = make_server(device, progs, True, options=opts)
    try:
        rep = saturate_for(server, "vgg16", frames_for(prog, 16, 1700),
                           REHEARSAL_VGG16_SATURATE_S if rehearse
                           else VGG16_SATURATE_S)
    finally:
        server.stop()
    out["saturate"] = {"fps": rep.achieved_fps, "requests": rep.submitted,
                       "seconds": rep.duration_s}
    log(f"[vgg16] bound saturate: {rep.achieved_fps:.2f} frames/s "
        f"({rep.submitted} single-frame requests in {rep.duration_s:.2f}s)")
    return out, counts, err, n_cmp


def reread(trace_dir):
    """Each device-time range of the run whose traces lie in ``trace_dir``:
    its launches, kernel records and device ms per batch by kernel
    function; and the imaging serving window's busy share."""
    def events(name):
        with open(os.path.join(trace_dir, name)) as f:
            return json.load(f)["traceEvents"]
    timed = events(DEVICE_TRACE)
    ranges = sorted({e["name"] for e in timed
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith(DEVICE_RANGE)})
    out = {}
    for name in ranges:
        kernels, launches = device_work(timed, name, ("kernel",))
        by_fn = {}
        for e in kernels:
            fn = e["name"].replace("(anonymous namespace)::", "")
            fn = fn.removeprefix("void ").split("(")[0]
            by_fn[fn] = by_fn.get(fn, 0.0) + e["dur"] / DEVICE_ITERS / 1e3
        out[name[len(DEVICE_RANGE):]] = {
            "launches": launches, "kernel_records": len(kernels),
            "ms_per_batch": by_fn}
    shares = {"imaging_busy_share": busy_share(events(SERVE_TRACE))}
    if os.path.exists(os.path.join(trace_dir, BOUND_SERVE_TRACE)):
        shares["imaging_bound_busy_share"] = busy_share(
            events(BOUND_SERVE_TRACE))
    return {"device_time": out, **shares}


def call_label(d):
    """A per-call detail's shape, as the timing lines print it."""
    if "stages" in d:
        return f"{d['stages']} B={d['B']}"
    if "pool" in d:
        return f"{d['B']}x{d['H']}x{d['W']}x{d['C']} p={d['pool']}"
    return d.get("conv") or d.get("x") or (d["M"], d["K"], d["N"])


def launch_label(d):
    """A per-call detail's launch configuration: cluster and CTAs of the
    chain kernel, tile, run, channel block and CTAs of the depthwise one,
    route, run, threads and CTAs of ca_pool, CTAs of the others."""
    keys = ("cluster", "splits", "weights_in_smem", "smem",
            "active_clusters", "tile", "run", "cb", "route", "r", "threads",
            "split", "ctas")
    return ", ".join(f"{k} {d[k]}" for k in keys if k in d) or "-"


def frames_on(a, device):
    import torch
    return torch.from_numpy(a).to(device)


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU; exits 2, no result")
    ap.add_argument("--details", default=os.path.join(HERE, "build",
                                                      "chip_smoke.json"),
                    help="where to write the detail JSON")
    ap.add_argument("--reread", metavar="DIR",
                    help="print the device times and busy share of the "
                         "traces a run left in DIR, and exit")
    args = ap.parse_args(argv)
    if args.reread:
        print(json.dumps(reread(args.reread), indent=1))
        return 0
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
    os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
    t_start = time.perf_counter()
    try:
        ptxas = {}
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
            ptxas = {name: ptxas_report(_build.library_path(name)
                                        .with_suffix(".log").read_text())
                     for name in _build.KERNELS}
            for name, fns in ptxas.items():
                log(f"[build] {name}: " + "; ".join(
                    f"{f['function']} {f['registers']} regs, "
                    f"{f['smem_bytes']} B smem, spills "
                    f"{f['spill_stores']}/{f['spill_loads']} B"
                    for f in fns))

        from repro_torch import Options
        from repro_torch.core.quant import W4A4
        vision_progs, imaging_progs = vision_programs(), imaging_programs()
        opts = Options(scheme=W4A4, device=str(device))
        vision = path_calls({n: p.compile(opts)
                             for n, p in vision_progs.items()}, device)
        imaging = path_calls({n: p.compile(opts)
                              for n, p in imaging_progs.items()}, device)
        for path, calls in (("vision", vision), ("imaging", imaging)):
            log(f"[path] {path}, bucket {BUCKET}: photonic_mvm "
                f"{[(a.shape[0], a.shape[1], w.shape[1]) for a, w in calls['photonic_mvm']]}"
                f"; conv_chain {[tuple(c.shape) for c, _, _, _ in calls['conv_chain']]}"
                f"; ca_pool {[(tuple(i.shape), p) for i, p in calls['ca_pool']]}"
                f"; conv_strip {[(c[4], tuple(c[0].shape)) for c in calls['conv_strip']]}"
                f"; conv_strip_depthwise "
                f"{[(c[4], tuple(c[0].shape)) for c in calls['conv_strip_depthwise']]}")

        max_err, n_cmp, bank_float_err = phase_kernels(device, vision,
                                                       imaging)
        log(f"[kernels] bitwise equal to their plain versions: {n_cmp} "
            f"comparisons, max abs err {max_err}; conv_bank float mode "
            f"within {bank_float_err:.3g} of its plain version")
        bank_counts = phase_conv_bank_op(device)
        log(f"[conv_bank op] launches {bank_counts}")

        rows, detail = phase_timing(device, vision, imaging)
        out_dir = os.path.dirname(os.path.abspath(args.details))
        device_ms = phase_device_time(device, vision, imaging, os.path.join(
            out_dir, DEVICE_TRACE))
        ca_cold = device_ms.pop("ca_pool.cold")
        # photonic_mvm's and ca_pool's rows are both paths' calls; each
        # path's device time is its own profiler range
        for k in ("photonic_mvm", "ca_pool"):
            dev = (device_ms[k], device_ms.pop(f"{k}.imaging"))
            rows[k]["by_path"]["vision"]["device_ms"] = dev[0]
            rows[k]["by_path"]["imaging"]["device_ms"] = dev[1]
            device_ms[k] = None if None in dev else sum(dev)
        for k, r in rows.items():
            log(f"[timing] {k}: {r['ms']:.4f} ms per call sequence (plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']} exact "
                f"{r['library_exact']}, bound {r['bound_ms']:.6f}, device "
                f"{device_ms[k]}); by path {r['by_path']}")
        for k in ("photonic_mvm", "conv_strip", "conv_strip_depthwise",
                  "ca_pool"):
            for i, d in enumerate(detail[k]):
                d["device_ms"] = device_ms.pop(f"{k}.shape{i}", None)
                d["library_device_ms"] = device_ms.pop(
                    f"library.{k}.shape{i}", None)
        for k in KERNELS:
            for d in detail[k]:
                log(f"[timing] {k} {d['path']} {call_label(d)}: device "
                    f"{d.get('device_ms')} ms (library "
                    f"{d.get('library_device_ms')}), per call {d['ms']:.4f} "
                    f"ms, plain {d['plain_ms']:.4f}, library "
                    f"{d['library_ms']}, bound {d['bound_ms']:.6f}; launch "
                    f"{launch_label(d)}")
        cold = next(d for d in detail["ca_pool"] if d["path"] == "imaging"
                    and d["pool"] == 1)
        log(f"[timing] ca_pool cold L2 ({L2_FLUSH_BYTES >> 20} MiB written "
            f"before each launch) {call_label(cold)}: device {ca_cold} ms, "
            f"warm {cold.get('device_ms')} ms, bound {cold['bound_ms']:.6f}")

        served = {}
        counts, stats, wall, n_frames = phase_serve_vision(device,
                                                           vision_progs)
        served["vision"] = counts
        log(f"[serve vision] {n_frames} frames in {wall:.3f}s wall; "
            f"launches {counts}")
        for name, p in stats["programs"].items():
            lat = p["latency_ms"]
            log(f"[serve vision] {name}: {p['requests']['served']} requests,"
                f" {p['frames_served']} frames in {p['batches']} batches; "
                f"p50 {lat.get('p50', 0):.3f} ms p99 {lat.get('p99', 0):.3f}"
                f" ms; {p['achieved_fps']:.1f} frames/s")
        counts, istats, iwall, n_iframes, quality = phase_serve_imaging(
            device, imaging_progs)
        served["imaging"] = counts
        log(f"[serve imaging] {n_iframes} frames in {iwall:.3f}s wall; "
            f"launches {counts}")
        for name, p in istats["programs"].items():
            lat = p["latency_ms"]
            log(f"[serve imaging] {name}: {p['requests']['served']} "
                f"requests, {p['frames_served']} frames in {p['batches']} "
                f"batches; p50 {lat.get('p50', 0):.3f} ms p99 "
                f"{lat.get('p99', 0):.3f} ms; {p['achieved_fps']:.1f} "
                f"frames/s; PSNR vs apply_float {quality[name]:.2f} dB")

        busy = phase_busy_share(device, imaging_progs, os.path.join(
            out_dir, SERVE_TRACE))
        log(f"[serve imaging, profiled] device busy share {busy}")

        chain = chain_program()
        t0 = time.perf_counter()
        bound = phase_serve_bound(device, vision_progs, imaging_progs, chain,
                                  devices=2 if rehearse else 1)
        log(f"[serve bound] bind and capture "
            f"{bound['bind_and_capture_s']:.2f}s for "
            f"{len(bound['graphs'])} programs x {len(BUCKETS)} buckets; "
            f"phase {time.perf_counter() - t0:.1f}s")
        for path, w in bound["windows"].items():
            served[f"bound {path}"] = w["counts"]
            log(f"[serve bound] {path}: {w['frames']} frames in "
                f"{w['wall_s']:.3f}s wall, bitwise equal to batch-1 "
                f"run_per_frame; launches {w['counts']} (= the replays' "
                f"credits); PSNR {w['psnr_db']}")
        log("[serve bound] three batches in flight on one bound view: each "
            "its own answer (lenet, edge_detect, chain)")
        bound_busy = phase_busy_share(device, imaging_progs, os.path.join(
            out_dir, BOUND_SERVE_TRACE), bound=True)
        log(f"[serve imaging bound, profiled] device busy share "
            f"{bound_busy}")

        load_s = REHEARSAL_LOAD_S if rehearse else LOAD_S
        load = phase_load(device, {
            name: {**vision_progs, **imaging_progs, "chain": chain}[name]
            for name in LOAD_PROGRAMS}, load_s["saturate"],
            load_s["poisson"])
        for name, modes in load.items():
            b, e = modes["bound"], modes["eager"]
            log(f"[load] {name}: saturate {e['saturate_fps']:.1f} -> "
                f"{b['saturate_fps']:.1f} frames/s (eager -> bound); "
                f"poisson at {b['poisson_rate_rps']:.1f} req/s: eager p50 "
                f"{e['latency_ms'].get('p50', float('nan')):.3f} p99 "
                f"{e['latency_ms'].get('p99', float('nan')):.3f} ms (served "
                f"{e['poisson_served']}/{e['poisson_requests']}, rejected "
                f"{e['poisson_rejected']}, behind {e['poisson_behind_schedule']})"
                f", bound p50 {b['latency_ms'].get('p50', float('nan')):.3f} "
                f"p99 {b['latency_ms'].get('p99', float('nan')):.3f} ms "
                f"(served {b['poisson_served']}/{b['poisson_requests']}, "
                f"rejected {b['poisson_rejected']}, behind "
                f"{b['poisson_behind_schedule']})")

        obs_out = {"serve": phase_obs_serve(device, vision_progs,
                                            imaging_progs, out_dir)}
        o = obs_out["serve"]
        log(f"[obs] traced bound server (LeNet, VGG9-CA, edge_detect): "
            f"{o['window']['frames']} frames bitwise equal to batch-1 "
            f"run_per_frame; trace {o['trace']['records']} records, device "
            f"spans {o['trace']['device_spans']}; check_trace.py "
            f"--min-devices 1 passed")
        log(f"[obs] admin {o['admin']['url']}: /healthz /readyz /metrics "
            f"/statusz /statusz?format=text answered 200 "
            f"({o['admin']['bytes']} bytes); /tracez passed --flight")
        log(f"[obs] dumps (each passed --flight --require-trigger where "
            f"triggered): {[(d['reason'], d['records']) for d in o['dumps']]}")
        obs_out["busy"] = phase_obs_busy(device, imaging_progs, os.path.join(
            out_dir, OBS_BUSY_TRACE))
        log(f"[obs] bound imaging burst, traced and profiled: "
            f"serve.device.execute spans vs CUPTI busy {obs_out['busy']}")
        obs_out["cost"] = phase_obs_cost(device, {
            name: {**vision_progs, **imaging_progs}[name]
            for name in OBS_COST_PROGRAMS},
            REHEARSAL_OBS_COST_S if rehearse else OBS_COST_S)
        for name, c in obs_out["cost"].items():
            fps = {v: sum(r) / len(r) for v, r in c["fps"].items()}
            recs = {v: sum(r) / len(r)
                    for v, r in c["records_per_request"].items()}
            log(f"[obs] {name} bound, saturate x{c['requests']} single-frame"
                f" requests, {OBS_VARIANTS}: A (no recorder) {fps['A']:.1f}"
                f" frames/s; " + "; ".join(
                    f"{v} {fps[v]:.1f} ({c['ratio_to_A'][v]:.4f} of A, "
                    f"{recs[v]:.2f} records/request)" for v in "BCD")
                + f"; runs {c['fps']}")

        vgg16, vgg16_counts, vgg16_err, vgg16_cmp = phase_vgg16(
            device, rehearse, out_dir)
        served.update(vgg16_counts)
        for k in vgg16_err:
            max_err[k] = max(max_err[k], vgg16_err[k])
            n_cmp[k] += vgg16_cmp[k]
            rows[k]["by_path"]["vgg16"] = vgg16["by_kernel"][k]

        launches = {k: {path: served[path][k] for path in served}
                    for k in KERNELS}
        for k in KERNELS:
            launches[k]["conv_bank_op"] = bank_counts[k]
        kernels = []
        for name in KERNELS:
            src, replaces = SOURCES[name]
            r = rows[name]
            n = bank_counts[name] if name == "conv_bank" else \
                sum(served[path][name] for path in served)
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n,
                "launches_by_path": launches[name],
                "max_abs_err": max_err[name],
                "bitwise_equal": max_err[name] == 0.0, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                             else "operations"),
                "library_ms": r["library_ms"],
                "library_exact": r["library_exact"],
                "device_ms": device_ms[name], "by_path": r["by_path"]})
        with open(args.details, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "kernels": kernels,
                       "ptxas": ptxas,
                       "per_call": detail, "serve_stats": stats,
                       "imaging_serve_stats": istats, "psnr_db": quality,
                       "imaging_busy_share": busy,
                       "serve_bound": bound,
                       "imaging_bound_busy_share": bound_busy,
                       "load": load, "obs": obs_out, "vgg16": vgg16,
                       "ca_pool_cold_device_ms": ca_cold,
                       "comparisons": n_cmp,
                       "conv_bank_float_err": bank_float_err,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1, default=str)
        if not rehearse:
            # the eager windows and the bound ones (counted through the
            # captured graphs' credited replays)
            for path, names in PATH_KERNELS.items():
                for window in (path, f"bound {path}"):
                    for k in names:
                        if window in served:
                            need(served[window][k] > 0, f"{k} never "
                                 f"launched on the {window} serving path")
                need(f"bound {path}" in served, f"no bound {path} window")
            need(bank_counts["conv_bank"] > 0,
                 "conv_bank never launched by the conv_bank op")
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
