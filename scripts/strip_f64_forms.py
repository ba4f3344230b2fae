"""Time both forms of the dense float strip conv on the card: the evidence
of the rule that picks between them (``strip.dense_form``) and of the
tensor-core form's launch rule (``strip.f64mma_config``).

    python scripts/strip_f64_forms.py [--out PATH] [--quick]

At the conv_bank op's calls (``edge_shapes.CONV_BANK_CALLS``) at batches
8 and 1, the imaging path's float64 convs at bucket 8 (the eight
pipelines at 256x256, for information) and, unless ``--quick``, the
tensor-core form's edges (``edge_shapes.F64MMA_EDGES``): every launch of
the tensor-core form (each tile of ``strip.f64mma_launches`` at every
chunk of 8-channel steps that fits a CTA) and the CUDA-core form's
(``strip.strip_config``), each forced, checked against the plain version
(bitwise on W4A4's codes and levels; within 1e-5 on float operands), then
timed beside ``F.conv2d`` on the same float operands (TF32 off) and the
bound (the bytes over 3.35 TB/s, the operations over the FP64 tensor
cores' 67 TFLOP/s: the larger). The launch ``strip.dense_config`` picks
is marked. A time is the device ms a call: 20 calls captured in one CUDA
graph, replayed 3 times between CUDA events (the L2 warm), the median.
The build's ptxas line of each tensor-core instantiation is printed.
Results go to ``--out`` (``build/strip_f64_forms.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
FP64_TENSOR_FLOPS = 67e12           # H100 SXM FP64 tensor cores


def bound_ms(b, h, w, ci, co, k, stride):
    h_out, w_out = (h - k) // stride + 1, (w - k) // stride + 1
    n_out = b * h_out * w_out * co
    t_bytes = (b * h * w * ci + k * k * ci * co + n_out) * 4 / \
        HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_out * k * k * ci / FP64_TENSOR_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def imaging_convs():
    """(name, b, hp, wp, c_in, c_out, k, stride) of the imaging path's
    dense float64 convs at bucket 8 on their padded frames (every strip
    step the rule does not route to the int8 kernel)."""
    from repro_torch import Options, Program
    from repro_torch.core.plan import ConvStep
    from repro_torch.core.quant import W4A4
    from repro_torch.imaging import PIPELINES
    from repro_torch.kernels.conv_bank import strip
    out = []
    for name in sorted(PIPELINES):
        plan = Program.from_pipeline(name, 256, 256, 3).compile(
            Options(scheme=W4A4, device="cpu")).plan
        for step in plan.steps:
            if not isinstance(step, ConvStep) or step.strategy is None or \
                    step.strategy.kind != "strip" or step.geom.depthwise:
                continue
            g = step.geom
            if strip.dense_route(g.c_in, g.c_out, g.kernel,
                                 g.stride) != "float":
                continue
            (plo, phi), (qlo, qhi) = g.pads
            out.append((f"{name}.{step.name}", 8, g.h_in + plo + phi,
                        g.w_in + qlo + qhi, g.c_in // g.groups,
                        g.c_out // g.groups, g.kernel, g.stride))
    return out


def f64_alternatives(b, n_rows, w_out, ci, co, k, stride):
    """Each tile the tensor-core form takes at every chunk (8 channels up
    to C_in rounded up to 8) whose stage fits a CTA."""
    from repro_torch.kernels.conv_bank import strip
    out = []
    for cfg in strip.f64mma_launches(b, n_rows, w_out, ci, co, k, stride):
        for cc in range(8, -(-ci // 8) * 8 + 1, 8):
            smem = strip.f64mma_stage_bytes(cfg.th, cfg.bn, cc, k)
            if smem <= strip.SMEM_MAX:
                out.append(dataclasses.replace(cfg, cc=cc, smem=smem))
    return out


def cfg_label(cfg):
    if cfg.form == "f64mma":
        return f"f64mma {cfg.th}x{cfg.tw} bn{cfg.bn} cc{cfg.cc}"
    return (f"fma {cfg.tx}x{cfg.tyt * cfg.run} co_b{cfg.co_b} "
            f"cc{cfg.cc}")


def time_shape(name, b, hp, wp, ci, co, k, stride, seed, with_time=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from strip_int_forms import graph_ms
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    xq = torch.randint(0, 16, (b, hp, wp, ci), generator=g).float().to(dev)
    wq = torch.randint(-7, 8, (k, k, ci, co), generator=g).float().to(dev)
    xf = torch.rand((b, hp, wp, ci), generator=g).to(dev)
    wf = (torch.randn((k, k, ci, co), generator=g) * 0.2).to(dev)
    n_rows = (hp - k) // stride + 1
    w_out = (wp - k) // stride + 1
    want_q = strip.conv_strip_ref(xq, wq, stride=stride, strip_h=n_rows)
    want_f = strip.conv_strip_ref(xf, wf, stride=stride, strip_h=n_rows)
    pick = strip.dense_config(b, n_rows, w_out, ci, co, k, stride)
    cfgs = [strip.strip_config(b, n_rows, w_out, ci, co, k, stride),
            *f64_alternatives(b, n_rows, w_out, ci, co, k, stride)]
    rows = []
    for cfg in cfgs:
        def run(x, w, cfg=cfg):
            return strip.launch(x, w, None, None, 1.0, "none", stride, False,
                                strip.LAUNCHES, cfg=cfg)
        got = run(xq, wq)
        torch.cuda.synchronize()
        assert torch.equal(got, want_q), (name, b, cfg_label(cfg))
        err = float((run(xf, wf) - want_f).abs().max())
        assert torch.allclose(run(xf, wf), want_f, rtol=1e-5, atol=1e-5), \
            (name, b, cfg_label(cfg), err)
        rows.append(dict(dataclasses.asdict(cfg), label=cfg_label(cfg),
                         picked=cfg == pick, float_err=err,
                         ms=graph_ms(lambda run=run: run(xf, wf))
                         if with_time else None))
    lib_ms = None
    if with_time:
        nchw = xf.permute(0, 3, 1, 2)
        w_oihw = wf.permute(3, 2, 0, 1).contiguous()
        with float32_convs():
            lib_ms = graph_ms(lambda: F.conv2d(nchw, w_oihw, stride=stride))
    bound, by = bound_ms(b, hp, wp, ci, co, k, stride)
    form = strip.dense_form(b, n_rows, w_out, ci, co, k, stride)
    times = "; ".join(
        f"{r['label']}{' (picked)' if r['picked'] else ''} "
        f"{r['ms'] if r['ms'] is None else round(r['ms'], 5)}"
        for r in rows)
    print(f"[f64] {name} b{b} {hp}x{wp} {ci}->{co} k{k} s{stride}: rule "
          f"{form}; {times}; F.conv2d {lib_ms if lib_ms is None else round(lib_ms, 5)}; "
          f"bound {bound:.6f} ({by}); float err "
          f"{max(r['float_err'] for r in rows):.3g}", flush=True)
    return dict(name=name, batch=b, hp=hp, wp=wp, c_in=ci, c_out=co, k=k,
                stride=stride, form=form, launches=rows, library_ms=lib_ms,
                library="F.conv2d (float, TF32 off)", bound_ms=bound,
                bound_by=by)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "strip_f64_forms.json"))
    ap.add_argument("--quick", action="store_true",
                    help="the conv_bank op's calls alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("strip_f64_forms: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    from chip_smoke import ptxas_report
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_shapes import CONV_BANK_CALLS, F64MMA_EDGES
    built = _build.build(["conv_strip", "conv_strip_f64mma"])
    ptxas = ptxas_report(_build.library_path("conv_strip_f64mma")
                         .with_suffix(".log").read_text())
    print(f"[f64] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; build s {built}", flush=True)
    for f in ptxas:
        print(f"[f64] ptxas {f['function']}: {f['registers']} regs, "
              f"{f['smem_bytes']} B smem, spills {f['spill_stores']}/"
              f"{f['spill_loads']} B", flush=True)
    rows = []
    for i, (b, h, w, ci, co, k) in enumerate(CONV_BANK_CALLS):
        for bb in (8, 1):
            rows.append(time_shape(f"conv_bank_op_k{k}", bb, h + k - 1,
                                   w + k - 1, ci, co, k, 1, 10 * i + bb))
    if not args.quick:
        for i, shape in enumerate(imaging_convs()):
            rows.append(time_shape(*shape, 100 + i))
        for i, (b, h, w, ci, co, k) in enumerate(F64MMA_EDGES):
            rows.append(time_shape("edge", b, h + k - 1, w + k - 1, ci, co,
                                   k, 1, 200 + i, with_time=False))
    dest = Path(args.out)
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(dict(device=smi, ptxas=ptxas, rows=rows),
                               indent=1, default=str))


if __name__ == "__main__":
    main()
