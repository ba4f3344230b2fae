"""Time every launch of the int8 strip conv's wgmma form on the card: the
evidence of its launch rule (``strip.wgmma_config``, ``WG_RATE``).

    python scripts/strip_int_forms.py [--out PATH]

At each ``edge_shapes.INT_FORM_SHAPES`` entry (VGG16's conv2-conv10 as
the int route launches them, conv11-13 forced onto the int8 kernel, the
conv_bank op's calls) and batches 1 and 8, on W4A4's codes (0..15) and
levels (-7..7): every tile, channel block, chunk and stage count the
wgmma form takes that fits a CTA (2 stages and the most that fit), each
checked bitwise against the plain version, then timed raw and with the
requant's first pass folded into the store (the path's form), ranked by
the folded time; the launch
``strip.igemm_config(form="wgmma")`` picks among them is marked, beside
the form ``strip.int_form`` gives the shape. Both forms' times at these
shapes, side by side, are ``chip_smoke.py``'s ``[vgg16] int8 forms``
lines. A time is the device ms a call: 20 calls captured in one CUDA
graph, replayed 3 times between CUDA events (the L2 warm, as in a bound
window), the median. Results go to ``--out``
(``build/strip_int_forms.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def graph_ms(fn, calls=20, reps=3):
    """Device ms a call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events; the median."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
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
    return statistics.median(ms)


def wgmma_alternatives(b, h, ci, co, k):
    """Every wgmma launch that fits a CTA at this shape: each tile of
    ``WG_TILES``, block of ``WG_BN`` (64 alone up to 64 channels), chunk
    of ``WG_CH`` (no larger than C_in's k-steps) and stage count (2 at
    least over several chunks; 2 and the most that fit)."""
    from repro_torch.kernels.conv_bank import strip
    out = []
    for th, tw in strip.WG_TILES:
        for bn in strip.WG_BN:
            if bn > 64 and co <= 64:
                continue
            for ch in strip.WG_CH:
                if ch > -(-ci // 32) * 32:
                    continue
                chunks = -(-ci // ch)
                fits = [s for s in range(1, min(strip.WG_MAX_STAGES,
                                                chunks) + 1)
                        if (chunks == 1 or s >= 2) and
                        strip.wgmma_smem(th, tw, bn, k, ch, s) +
                        strip.IGEMM_FOLD_RED <= strip.SMEM_MAX]
                for s in sorted({fits[0], fits[-1]} if fits else ()):
                    ctas = b * -(-h // th) * -(-h // tw) * -(-co // bn)
                    out.append(strip.IgemmConfig(
                        0, th, tw, bn, s,
                        strip.wgmma_smem(th, tw, bn, k, ch, s), ctas, 0,
                        "wgmma", ch))
    return out


def label(cfg):
    return (f"{cfg.th}x{cfg.tw} bn{cfg.bn} ch{cfg.ch} s{cfg.stages} "
            f"({cfg.ctas} CTAs, {cfg.smem} B)")


def time_shape(layer, h, ci, co, k, b, seed):
    import torch
    from repro_torch.kernels.conv_bank import strip
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    x8 = torch.randint(0, 16, (b, h + k - 1, h + k - 1, ci),
                       generator=g).to(torch.uint8).to(dev)
    w8 = torch.randint(-7, 8, (k, k, ci, co), generator=g).to(
        torch.int8).to(dev)
    iw = strip.int_weights(w8, form="wgmma")
    fold = strip.Fold(torch.rand((b, 1, 1, 1), generator=g).to(dev) * 0.01
                      + 1e-3, torch.rand((co,), generator=g).to(dev) * 0.1,
                      torch.randn((co,), generator=g).to(dev), "relu")
    want = strip.conv_strip_int_ref(x8, w8)
    pick = strip.igemm_config(b, h, h, ci, co, k, 1, form="wgmma")
    ranked = []
    for cfg in wgmma_alternatives(b, h, ci, co, k):
        got = strip.launch_int(x8, iw, 1.0, "none", 1, cfg=cfg)
        assert torch.equal(got, want), (layer, b, label(cfg))
        ranked.append(dict(
            ms=graph_ms(lambda cfg=cfg: strip.launch_int(
                x8, iw, 1.0, "none", 1, cfg=cfg)),
            fold_ms=graph_ms(lambda cfg=cfg: strip.launch_int(
                x8, iw, 1.0, "none", 1, fold, cfg=cfg)),
            picked=cfg == pick, **dataclasses.asdict(cfg)))
    ranked.sort(key=lambda r: r["fold_ms"])
    at = next(i for i, r in enumerate(ranked) if r["picked"])
    best = "; ".join(f"{r['th']}x{r['tw']} bn{r['bn']} ch{r['ch']} "
                     f"s{r['stages']} {r['fold_ms']:.5f} (raw "
                     f"{r['ms']:.5f})" for r in ranked[:6])
    print(f"[alt] {layer:22s} b{b}: the rule's form "
          f"{strip.int_form(ci, co, k, 1)}; the wgmma pick {label(pick)} "
          f"{ranked[at]['fold_ms']:.5f} folded, {at + 1} of {len(ranked)}, "
          f"{ranked[at]['fold_ms'] / ranked[0]['fold_ms']:.3f} of the "
          f"fastest; fastest folded first: {best}", flush=True)
    return dict(layer=layer, batch=b, h=h, c_in=ci, c_out=co, k=k,
                form=strip.int_form(ci, co, k, 1), alternatives=ranked)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "strip_int_forms.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("strip_int_forms: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_shapes import INT_FORM_SHAPES
    built = _build.build(["conv_strip_wgmma"])
    print(f"[alt] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; build s {built}", flush=True)
    rows = []
    for i, (layer, h, ci, co, k) in enumerate(INT_FORM_SHAPES):
        for b in (1, 8):
            rows.append(time_shape(layer, h, ci, co, k, b, 100 * i + b))
    dest = Path(args.out)
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(dict(device=smi, rows=rows), indent=1))


if __name__ == "__main__":
    main()
