"""Vision and imaging serving driver over the ``repro_torch.serve`` runtime.

    # CNN classification throughput (closed-loop saturation), on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --model lenet --batch 8 --batches 50

    # VGG16 at 224x224x3 (seeded weights; --device cpu runs, slowly)
    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --model vgg16 --batch 8 --batches 10

    # an imaging pipeline (repro_torch.imaging)
    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --pipeline edge_detect --size 256 --batch 8

    # open-loop Poisson load: latency at an offered rate
    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --model lenet --load 500 --requests 200 --deadline-ms 100

    # the device pool: 4 cards, or 4 emulated workers with --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --model lenet --load 500 --requests 64 --devices 4

    # a traced run (Chrome trace; check with scripts/check_trace.py), the
    # admin endpoint on an ephemeral port and a structured log
    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --model lenet --load 500 --requests 200 --trace out.json \
        --admin-port 0 --log serve.jsonl

Each run compiles once (``Server.register``), binds the program to each
pool device and warms every batch bucket (which captures the bound views'
CUDA graphs), then streams single-frame requests through the micro-batching
scheduler: coalesced up to ``--batch`` / ``--max-wait-ms``, padded to a
bucket, run with per-frame CRC calibration (bitwise equal to per-request
``run_per_frame``).

The default mode reports sustained frames/s under full backlog beside the
power model's device FPS and kFPS/W and, for imaging pipelines, the PSNR
of the quantized answer against the float oracle. ``--load`` switches to
the open-loop Poisson generator and reports p50/p95/p99 latency, the
achieved rate and the sheds. Runs on ``cuda`` unless ``--device cpu``.
``--trace`` records the run (``repro_torch.obs``), writes the Chrome trace
and prints the verbose stats table and a summary line.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs, serve
from repro_torch.core.program import Options
from repro_torch.core.quant import MX_42, MX_43, W2A4, W3A4, W4A4
from repro_torch.kernels import dispatch
from repro_torch.models.vision import MODEL_INPUT_HWC, vision_program

SCHEMES = {"w4a4": W4A4, "w3a4": W3A4, "w2a4": W2A4,
           "mx43": MX_43, "mx42": MX_42}
# the IRs the executable path runs, as the reference's --model offers them
MODELS = tuple(sorted(MODEL_INPUT_HWC))


def frame_pool(prog, n: int, seed: int) -> np.ndarray:
    """``n`` procedural frames for ``prog``: digits for a one-channel
    input, textures for a three-channel one."""
    from repro_torch.data.synthetic import synthetic_digits, \
        synthetic_textures
    h, w, c = prog.input_hwc
    if c == 1:
        imgs, _ = synthetic_digits(n, seed=seed, hw=h)
    else:
        imgs, _ = synthetic_textures(n, seed=seed, hw=h)
    return np.ascontiguousarray(imgs[..., :c], np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="lenet", choices=MODELS)
    ap.add_argument("--pipeline", default=None,
                    help="serve a repro_torch.imaging pipeline instead")
    ap.add_argument("--scheme", default="mx43", choices=sorted(SCHEMES))
    ap.add_argument("--batch", type=int, default=8,
                    help="scheduler max_batch (largest micro-batch)")
    ap.add_argument("--batches", type=int, default=50,
                    help="device batches worth of frames to stream "
                         "(total frames = batch * batches)")
    ap.add_argument("--size", type=int, default=64,
                    help="imaging frame height and width (pipeline mode)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batch collection window")
    ap.add_argument("--load", type=float, default=None,
                    help="open-loop Poisson mode: offered requests/s")
    ap.add_argument("--requests", type=int, default=64,
                    help="requests to offer in --load mode")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (late requests are shed)")
    ap.add_argument("--backend", default="kernel",
                    choices=sorted(dispatch.BACKENDS))
    ap.add_argument("--conv-strategy", default=None,
                    choices=sorted(dispatch.CONV_STRATEGIES))
    ap.add_argument("--devices", type=int, default=1,
                    help="pool width: one bound view per device")
    ap.add_argument("--placement", default="least_loaded",
                    choices=sorted(serve.PLACEMENTS))
    ap.add_argument("--shard-batch", action="store_true",
                    help="shard Executable.run's batch over the local "
                         "CUDA devices (no-op on 1 device; the served "
                         "per-frame path has no cross-frame reduction)")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="per-device pipeline depth")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where --devices are "
                         "emulated workers")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record spans and events and write a Chrome trace "
                         "(chrome://tracing, Perfetto); also prints the "
                         "verbose stats table")
    ap.add_argument("--admin-port", type=int, default=None,
                    help="serve the admin endpoint (/metrics /healthz "
                         "/readyz /statusz /tracez) on this port while the "
                         "run lasts; 0 binds an ephemeral port")
    ap.add_argument("--log", default=None, metavar="OUT.jsonl",
                    help="structured JSON-lines event log (serve start and "
                         "stop, SLO breaches, worker failures, flight dumps)")
    ap.add_argument("--no-flight", action="store_true",
                    help="run with the flight recorder uninstalled "
                         "(obs.uninstall()); it is restored on exit")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.batch < 1 or args.batches < 1 or args.requests < 1:
        ap.error("--batch, --batches and --requests must be >= 1")
    if args.devices < 1:
        ap.error("--devices must be >= 1")
    if args.load is not None and args.load <= 0:
        ap.error("--load must be > 0 requests/s")

    trace = obs.enable() if args.trace is not None else None
    options = Options(scheme=SCHEMES[args.scheme], fc_batch=args.batch,
                      backend=args.backend, device=args.device,
                      conv_strategy=args.conv_strategy,
                      shard_batch=args.shard_batch)
    if args.pipeline is not None:
        from repro_torch.imaging import PIPELINES
        if args.pipeline not in PIPELINES:
            ap.error(f"unknown pipeline {args.pipeline!r}; "
                     f"choose from {sorted(PIPELINES)}")
        prog = PIPELINES[args.pipeline].program(args.size, args.size, 3)
        label = f"pipeline={prog.name}"
    else:
        prog = vision_program(
            args.model, generator=torch.Generator().manual_seed(args.seed))
        label = f"model={args.model}"
    pool = frame_pool(prog, max(2 * args.batch, 8), args.seed + 1)

    server = serve.Server(serve.ServeConfig(
        max_batch=args.batch, max_wait_ms=args.max_wait_ms,
        max_queue=max(8 * args.batch, 64), max_inflight=args.max_inflight,
        default_deadline_ms=args.deadline_ms, devices=args.devices,
        placement=args.placement, device=args.device,
        admin_port=args.admin_port, log_path=args.log))
    t0 = time.perf_counter()
    hosted = server.register(prog.name, prog, options)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    server.start(warm=True)
    t_warm = time.perf_counter() - t0
    if server.admin is not None:
        print(f"[serve_vision] admin endpoint at {server.admin.url} "
              f"(/metrics /healthz /readyz /statusz /tracez)")
    where = (torch.cuda.get_device_name(torch.device(args.device))
             if torch.device(args.device).type == "cuda" else "cpu")

    r = hosted.executable.report
    print(f"[serve_vision] {label} max_batch={args.batch} "
          f"buckets={list(hosted.buckets)} wait={args.max_wait_ms}ms "
          f"devices={args.devices} compile={t_compile * 1e3:.1f}ms "
          f"bind+warm={t_warm * 1e3:.1f}ms")
    print(f"[serve_vision] options: {options.describe()}")
    if r.conv_strategy:
        seg_of = {n: i for i, seg in enumerate(r.fused_segments)
                  for n in seg["names"]}
        print("[serve_vision] conv strategy: " + " ".join(
            f"{n}={v['kind']}"
            + (f"({v['n_strips']}x{v['strip_rows']}rows)"
               if v["kind"] == "strip" else "")
            + (f"[fused#{seg_of[n]}]" if n in seg_of else "")
            for n, v in r.conv_strategy.items()))

    recorder = obs.uninstall() if args.no_flight else None
    try:
        if args.load is not None:
            rep = serve.poisson_load(server, prog.name, pool,
                                     rate_rps=args.load,
                                     n_requests=args.requests,
                                     seed=args.seed,
                                     deadline_ms=args.deadline_ms)
            if rep.submitted + rep.rejected != args.requests or \
                    rep.served + rep.shed != rep.submitted:
                raise RuntimeError(f"unaccounted requests: {rep}")
            lat = rep.latency_ms
            print(f"[serve_vision] offered {rep.offered_rps:,.0f} req/s x "
                  f"{args.requests}: served {rep.served} (shed {rep.shed}, "
                  f"rejected {rep.rejected}, behind schedule "
                  f"{rep.behind_schedule}) at {rep.achieved_rps:,.0f} req/s")
            if lat.get("count"):
                print(f"[serve_vision] latency p50={lat['p50']:.3f}ms "
                      f"p95={lat['p95']:.3f}ms p99={lat['p99']:.3f}ms "
                      f"max={lat['max']:.3f}ms")
        else:
            rep = serve.saturate(server, prog.name, pool,
                                 n_requests=args.batches * args.batch)
        fps = rep.achieved_fps
        stats = server.stats(verbose=trace is not None)
        snap = stats["programs"][prog.name]
        print(f"[serve_vision] measured {fps:,.0f} frames/s on {where} "
              f"(avg_batch {snap['avg_batch']:.1f}, padding waste "
              f"{snap['padding_waste']:.1%}) | device model: "
              f"{r.fps:,.0f} FPS, {r.avg_power_w:.2f} W, "
              f"{r.kfps_per_w:.1f} kFPS/W")
        if args.devices > 1:
            p = stats["pool"]
            occ = " ".join(f"{d['name']}={d['occupancy']:.0%}"
                           for d in p["per_device"])
            print(f"[serve_vision] pool: {p['devices']} devices "
                  f"[{p['placement']}] steals={p['steals']} "
                  f"occupancy {occ}")
        if args.pipeline is not None:
            from repro_torch.imaging import apply_float, psnr
            frames = pool[:args.batch]
            out = hosted.executable.run_per_frame(frames)
            ref = apply_float(prog.layers, prog.params,
                              torch.from_numpy(frames).to(out.device))
            print(f"[serve_vision] quantized-vs-float PSNR "
                  f"{float(psnr(ref, out)):.2f} dB (per-frame calibration)")
    finally:
        server.stop()
        if trace is not None:
            obs.disable()
        if recorder is not None:
            obs.install(recorder)
    if trace is not None:
        trace.export(args.trace)
        dev = trace.summary().get("serve.device.execute",
                                  {"count": 0, "total_ms": 0.0})
        print("[serve_vision] stats breakdown:")
        print(serve.format_stats(stats))
        print(f"[serve_vision] trace: {len(trace.records())} records "
              f"({dev['count']} device spans, {dev['total_ms']:.1f} ms "
              f"device time) -> {args.trace}")
    return fps


if __name__ == "__main__":
    main()
