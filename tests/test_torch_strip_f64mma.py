"""The dense float strip conv's tensor-core form (``csrc/
conv_strip_f64mma.cu::conv_f64mma_kernel``, chosen by ``strip.dense_form``
and launched as ``strip.f64mma_config`` picks) on the CPU.

The kernel runs only on the card (``test_torch_gpu.py``); here the Python
that surrounds it is held: each launch covers every output pixel and
channel in a CTA's shared memory at the conv_bank op's calls and at
ragged edges; the rule gives the form the op's calls and keeps every
imaging path conv and every registered plan's float-route conv on the
CUDA-core form; the kernel's walk over its grid, its chunks, its k-steps
and the shifted patch views its fragments read (``strip.f64mma_fragments``
and ``f64mma_stores``), gathered from stages filled as the kernel fills
them, reproduces the conv bitwise on integer operands; the JAX package's
``conv_bank`` in float mode agrees with the port's at the op's widths
within its 1e-5; the verifier audits the form's launches.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_bank import ops as jops
from repro_torch import Options, Program, analysis
from repro_torch.analysis import verifier
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import ConvStep
from repro_torch.core.quant import W4A4
from repro_torch.imaging import PIPELINES
from repro_torch.kernels.conv_bank import ops, strip
from repro_torch.kernels.edge_shapes import (CONV_BANK_CALLS,
                                             CONV_BANK_NARROW, F64MMA_EDGES,
                                             STRIP_EDGES)

CPU = Options(scheme=W4A4, device="cpu", verify="off")


def _cdiv(a, b):
    return -(-a // b)


# ragged edges besides F64MMA_EDGES': widths not a multiple of the tile,
# C_in 8, 9, 15, 16 and 17, C_out 8, 12 and 32, batch 1 and 13
RAGGED = [(1, 7, 9, 8, 8, 3), (13, 30, 17, 9, 12, 5), (1, 5, 31, 15, 32, 7),
          (13, 33, 33, 16, 8, 3), (1, 17, 10, 17, 12, 5),
          (13, 3, 100, 16, 32, 7), (1, 1, 1, 9, 8, 3)]
ENTRIES = ([("op", b, h, w, ci, co, k) for b in (8, 1)
            for _, h, w, ci, co, k in CONV_BANK_CALLS]
           + [("edge", *e) for e in F64MMA_EDGES]
           + [("ragged", *e) for e in RAGGED])


@pytest.mark.parametrize("entry", ENTRIES)
def test_f64mma_config_covers_the_output_in_shared_memory(entry):
    what, b, h, w, ci, co, k = entry
    pick = strip.dense_config(b, h, w, ci, co, k, 1, form="f64mma")
    assert pick == strip.f64mma_config(b, h, w, ci, co, k, 1)
    launches = strip.f64mma_launches(b, h, w, ci, co, k, 1)
    assert pick in launches
    for cfg in launches:
        assert cfg.form == "f64mma"
        # whole warps of an m16n8 block (2 rows x 8 columns x 8
        # channels), 16 at most
        assert cfg.tw == strip.F64_TW == 8
        assert (cfg.th, cfg.bn) in strip.F64_TILES
        assert strip.f64mma_warps(cfg) == cfg.th // 2 * (cfg.bn // 8) <= 16
        assert cfg.bn == 16 or co > 16
        # the chunk: 8-channel steps, no more than C_in's, the most whose
        # stage fits a CTA (half of the SM, where 8 channels allow it and
        # the launch has more CTAs than SMs)
        assert cfg.cc % 8 == 0 and 8 <= cfg.cc <= _cdiv(ci, 8) * 8
        assert cfg.smem == strip.f64mma_stage_bytes(cfg.th, cfg.bn, cfg.cc,
                                                    k)
        assert cfg.smem == verifier._f64mma_smem(cfg, k)
        budget = strip.SMEM_MAX
        if cfg.ctas > strip.SMS and strip.f64mma_stage_bytes(
                cfg.th, cfg.bn, 8, k) <= strip.F64_HALF:
            budget = strip.F64_HALF
        assert cfg.smem <= budget <= strip.SMEM_MAX == 232448
        assert cfg.cc == _cdiv(ci, 8) * 8 or strip.f64mma_stage_bytes(
            cfg.th, cfg.bn, cfg.cc + 8, k) > budget
        # every output pixel and channel in exactly one CTA's tile and block
        row_tiles, col_tiles = _cdiv(h, cfg.th), _cdiv(w, cfg.tw)
        blocks = _cdiv(co, cfg.bn)
        assert cfg.ctas == b * row_tiles * col_tiles * blocks
        assert (row_tiles - 1) * cfg.th < h <= row_tiles * cfg.th
        assert (col_tiles - 1) * cfg.tw < w <= col_tiles * cfg.tw
        assert (blocks - 1) * cfg.bn < co <= blocks * cfg.bn
    # the least work an SM takes in the last wave, then the taller tile,
    # then the fewest CTAs
    cost = {c: _cdiv(c.ctas, strip.SMS) * c.th * c.tw * c.bn
            for c in launches}
    assert cost == {c: strip.f64mma_cost(c) for c in launches}
    assert pick == min(launches, key=lambda c: (cost[c], -c.th, c.ctas))
    if what == "op":      # one wave: at batch 8 16 x 8 tiles, 16 warps;
        # at batch 1 8 x 8 tiles, 8 warps; 16 channels
        assert (pick.th, pick.bn) == ((16 if b == 8 else 8), 16)
        assert pick.ctas <= strip.SMS
        assert strip.f64mma_warps(pick) == pick.th


def test_dense_form_gives_the_op_the_tensor_cores_and_keeps_the_imaging_path():
    """The rule: the tensor-core form from 8 input and 8 output channels
    at stride 1 and k 3, 5, 7 (the conv_bank op's calls at batch 8 and 1,
    its edges); the CUDA-core form at every imaging pipeline's dense conv
    (64 and 256 frames), the narrow op call, below 8 channels, at stride
    2 and at any other k. Of ``STRIP_EDGES`` (the CUDA-core form's own
    edges, forced onto it by the gpu tests) the two from 8 channels at
    stride 1 take the tensor cores."""
    for b in (8, 1):
        for _, h, w, ci, co, k in CONV_BANK_CALLS:
            assert strip.dense_form(b, h, w, ci, co, k, 1) == "f64mma"
    for b, h, w, ci, co, k in F64MMA_EDGES:
        assert strip.dense_form(b, h, w, ci, co, k, 1) == "f64mma"
    for b, h, w, ci, co, k in CONV_BANK_NARROW:
        assert strip.dense_form(b, h, w, ci, co, k, 1) == "fma"
    moved = set()
    for b, h, w, ci, co, k, s in STRIP_EDGES:
        form = strip.dense_form(b, h, w, ci, co, k, s)
        assert form == ("f64mma" if ci >= 8 and co >= 8 and s == 1 and
                        k in (3, 5, 7) else "fma")
        if form == "f64mma":
            moved.add((ci, co, k))
    assert moved == {(40, 10, 5), (64, 33, 3)}
    for shape in [(8, 32, 32, 7, 32, 3), (8, 32, 32, 16, 7, 5),
                  (8, 32, 32, 16, 32, 4), (8, 32, 32, 16, 32, 9),
                  (8, 16, 16, 16, 32, 3, 2)]:
        shape = (*shape, 1)[:7]
        assert strip.dense_form(*shape) == "fma"
        if shape[3] >= 8 and shape[4] >= 8:      # the form cannot take it
            with pytest.raises(ValueError, match="f64mma form"):
                strip.dense_config(*shape, form="f64mma")
    for hw in (64, 256):
        for name in sorted(PIPELINES):
            plan = Program.from_pipeline(name, hw, hw, 3).compile(CPU).plan
            for step in plan.steps:
                if isinstance(step, ConvStep) and step.strategy is not None \
                        and step.strategy.kind == "strip" and \
                        not step.geom.depthwise:
                    g = step.geom
                    assert strip.dense_form(
                        8, hw, hw, g.c_in // g.groups, g.c_out // g.groups,
                        g.kernel, g.stride) == "fma", (name, step.name)
    with pytest.raises(ValueError, match="form"):
        strip.dense_config(8, 32, 32, 16, 32, 3, 1, form="wgmma")
    xp = torch.zeros((1, 17, 17, 16))
    with pytest.raises(ValueError, match="f64mma form"):
        strip.conv_strip(xp, torch.zeros((3, 3, 16, 16)), stride=2,
                         strip_h=8, form="f64mma")


def test_no_registered_plan_launches_the_tensor_core_form():
    """Every strip launch the verifier audits in the served plans (LeNet,
    VGG9-CA, VGG16 at 224, the eight pipelines at 64 and 256) keeps its
    form: the int8 kernel's or the float kernel's CUDA-core one."""
    plans = [Program.from_model(m, params={}).compile(CPU).plan
             for m in ("lenet", "vgg9", "vgg16")]
    plans += [Program.from_pipeline(n, hw, hw, 3).compile(CPU).plan
              for n in sorted(PIPELINES) for hw in (64, 256)]
    forms = set()
    for plan in plans:
        for step in plan.steps:
            if isinstance(step, ConvStep) and step.strategy is not None \
                    and step.strategy.kind == "strip":
                for launch in verifier._strip_launches(
                        step.geom, step.strategy,
                        plan.strip_routes.get(step.name)):
                    forms.add((launch[0], getattr(launch[-1], "form", "dw")))
    assert ("dense", "f64mma") not in forms
    assert ("dense", "fma") in forms and ("int", "wgmma") in forms


# -- the kernel's walk, emulated ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _fragments(cfg, k, q, di, dj):
    """Index arrays [warp, nb, lane] of the A (4) and B (2) operands
    each lane reads at this k-step and tap, from strip.f64mma_fragments."""
    warps = strip.f64mma_warps(cfg)
    a = np.zeros((warps, 32, 4), np.int64)
    b = np.zeros((warps, 32, 2), np.int64)
    for wi in range(warps):
        for lane in range(32):
            a[wi, lane], b[wi, lane] = strip.f64mma_fragments(
                cfg, k, wi, lane, q, di, dj)
    return a, b


def emulate_f64mma(xp: np.ndarray, w: np.ndarray, cfg) -> np.ndarray:
    """``conv_f64mma_kernel`` in numpy: each CTA (tile-major, channel
    blocks fastest, a frame a grid row) stages each chunk of C_in as the
    kernel does (the patch [rows_in][cols_in][cc + pad] and the weights
    [k*k][cc][bn + pad] in float64, zero past the input, C_in and C_out,
    NaN where it writes nothing), runs each k-step of 8 channels and each
    tap as mma.sync.m16n8k8 on the fragments its lanes gather, and stores
    each lane's accumulator where ``f64mma_stores`` says; an output no
    lane writes stays NaN."""
    b, hp, wp, ci = xp.shape
    k, co = w.shape[0], w.shape[-1]
    n_rows, w_out = hp - k + 1, wp - k + 1
    th, tw, bn, cc = cfg.th, cfg.tw, cfg.bn, cfg.cc
    rows_in, cols_in = th + k - 1, tw + k - 1
    ps, wsd = cc + strip.F64_PAD, bn + strip.F64_PAD
    tiles_w, n_blocks = _cdiv(w_out, tw), _cdiv(co, bn)
    tiles = _cdiv(n_rows, th) * tiles_w
    assert cfg.ctas == b * tiles * n_blocks
    warps = strip.f64mma_warps(cfg)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    xz = np.zeros((b, hp + rows_in, wp + cols_in, ci + cc))
    xz[:, :hp, :wp, :ci] = xp
    wz = np.zeros((k * k, ci + cc, n_blocks * bn + bn))
    wz[:, :ci, :co] = w.reshape(k * k, ci, co)
    out = np.full((b, n_rows, w_out, co), np.nan, np.float32)
    for f in range(b):
        for item in range(tiles * n_blocks):
            blk, tile = item % n_blocks, item // n_blocks
            tr, tc = divmod(tile, tiles_w)
            oh0, ow0, n0 = tr * th, tc * tw, blk * bn
            acc = np.zeros((warps, 16, 8))
            for cb in range(0, ci, cc):
                cc8 = _cdiv(min(cc, ci - cb), 8) * 8
                patch = np.full((rows_in, cols_in, ps), np.nan)
                patch[:, :, :cc8] = xz[f, oh0:oh0 + rows_in,
                                       ow0:ow0 + cols_in, cb:cb + cc8]
                wts = np.full((k * k, cc, wsd), np.nan)
                wts[:, :cc8, :bn] = wz[:, cb:cb + cc8, n0:n0 + bn]
                patch, wts = patch.reshape(-1), wts.reshape(-1)
                for q in range(0, cc8, 8):
                    for dj in range(k):
                        for di in range(k):
                            ia, ib = _fragments(cfg, k, q, di, dj)
                            for wi in range(warps):
                                va, vb = patch[ia[wi]], wts[ib[wi]]
                                a = np.zeros((16, 8))
                                a[g, t], a[g + 8, t] = va[:, 0], va[:, 1]
                                a[g, t + 4], a[g + 8, t + 4] = va[:, 2], \
                                    va[:, 3]
                                bm = np.zeros((8, 8))
                                bm[t, g], bm[t + 4, g] = vb[:, 0], vb[:, 1]
                                acc[wi] += a @ bm
            for wi in range(warps):
                d = acc[wi]
                for lane in range(32):
                    gl, tl = divmod(lane, 4)
                    vals = (d[gl, 2 * tl], d[gl, 2 * tl + 1],
                            d[gl + 8, 2 * tl], d[gl + 8, 2 * tl + 1])
                    for v, (r, c, ch) in zip(vals, strip.f64mma_stores(
                            cfg, wi, lane)):
                        oh, ow, oc = oh0 + r, ow0 + c, n0 + ch
                        if oh < n_rows and ow < w_out and oc < co:
                            assert np.isnan(out[f, oh, ow, oc])
                            out[f, oh, ow, oc] = np.float32(v)
    return out


# (b, h_out, w_out, c_in, c_out, k): ragged tiles, C_in 9 and 17 (steps of
# zeros past C_in), several chunks at k = 7, C_out 12 and 33 (blocks past
# C_out), both tile heights and both blocks among the launches
EMULATED = [(1, 9, 11, 9, 12, 3), (2, 5, 9, 16, 20, 5), (1, 6, 9, 17, 33, 3),
            (1, 4, 8, 24, 16, 7)]


@pytest.mark.parametrize("shape", EMULATED)
def test_f64mma_walk_reproduces_the_conv_bitwise(shape):
    b, h, w, ci, co, k = shape
    rng = np.random.default_rng(b + h + w + ci + co + k)
    xp = rng.integers(0, 16, (b, h + k - 1, w + k - 1, ci)).astype(
        np.float32)
    wq = rng.integers(-127, 128, (k, k, ci, co)).astype(np.float32)
    want = strip.conv_strip_ref(torch.from_numpy(xp), torch.from_numpy(wq),
                                strip_h=h).numpy()
    launches = strip.f64mma_launches(b, h, w, ci, co, k, 1)
    assert {(c.th, c.bn) for c in launches} >= {(8, 16), (16, 16)}
    if k == 7:
        assert all(c.cc < ci for c in launches)       # several chunks
    for cfg in launches:
        np.testing.assert_array_equal(emulate_f64mma(xp, wq, cfg), want,
                                      err_msg=str(cfg))


def test_f64mma_fragments_follow_the_mma_layout():
    """Each lane's A elements: rows g and g + 8 of the m16 block (two
    output rows of the warp, column g) at channels t and t + 4 of the
    k-step, shifted by the tap; B: channels t, t + 4 of the tap's weight
    row at the block's column g. Within a half-warp the 8-byte loads hit
    16 different bank pairs."""
    k = 5
    for cfg in strip.f64mma_launches(8, 32, 32, 16, 32, k, 1):
        cols_in = cfg.tw + k - 1
        ps, wsd = cfg.cc + strip.F64_PAD, cfg.bn + strip.F64_PAD
        wpn = cfg.bn // 8
        for warp in range(strip.f64mma_warps(cfg)):
            for lane in range(32):
                g, t = divmod(lane, 4)
                (a0, a1, a2, a3), (b0, b1) = strip.f64mma_fragments(
                    cfg, k, warp, lane, 8, 2, 3)
                row = 2 * (warp // wpn) + 2
                assert divmod(a0, ps) == (row * cols_in + g + 3, 8 + t)
                assert a1 - a0 == cols_in * ps and a2 - a0 == 4
                assert a3 - a1 == 4
                col = 8 * (warp % wpn) + g
                assert divmod(b0, wsd) == ((2 * k + 3) * cfg.cc + 8 + t, col)
                assert b1 - b0 == 4 * wsd
        for half in (range(16), range(16, 32)):
            for e in range(4):
                banks = {strip.f64mma_fragments(cfg, k, 0, lane, 0, 0,
                                                0)[0][e] % 16
                         for lane in half}
                assert len(banks) == 16
            for e in range(2):
                banks = {strip.f64mma_fragments(cfg, k, 0, lane, 0, 0,
                                                0)[1][e] % 16
                         for lane in half}
                assert len(banks) == 16


# -- the conv_bank op's float mode at its own widths, against the JAX package

@pytest.mark.parametrize("strategy", ["resident", "strip"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_conv_bank_float_mode_at_the_op_widths_within_reference_tolerance(
        k, strategy):
    rng = np.random.default_rng(40 + k)
    x = rng.random((2, 10, 12, 16)).astype(np.float32)
    w = (rng.standard_normal((k, k, 16, 32)) * 0.2).astype(np.float32)
    want = np.asarray(jops.conv_bank(jnp.asarray(x), jnp.asarray(w),
                                     strategy=strategy))
    got = ops.conv_bank(torch.from_numpy(x), torch.from_numpy(w),
                        strategy=strategy).numpy()
    assert got.shape == want.shape == (2, 10, 12, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- the verifier's audit ----------------------------------------------------

def test_audit_sizes_the_f64mma_launches_and_catches_a_bad_tile(monkeypatch):
    """VGG16 compiled onto the float kernel's route: conv2-conv10 launch
    the tensor-core form at both audited batches, each sized as its
    launcher lays it out and clean; planted tiles its launcher refuses (9
    rows, a block of 24 channels, 16 columns) and a chunk off the
    8-channel steps are LTR020 errors."""
    monkeypatch.setattr(strip, "dense_route", lambda *a: "float")
    plan_mod.clear_plan_cache()
    try:
        plan = Program.from_model("vgg16", params={}).compile(CPU).plan
    finally:
        plan_mod.clear_plan_cache()
    assert analysis.verify_plan(plan, include_info=False) == ()
    f64 = {f"conv{i}" for i in range(2, 11)}
    for st in plan.steps:
        if getattr(st, "name", None) in f64:
            launches = verifier._strip_launches(st.geom, st.strategy,
                                                "float")
            assert len(launches) == 2
            for kind, b, rows, cols, ci, co, cfg in launches:
                assert kind == "dense" and cfg.form == "f64mma"
                assert verifier._f64mma_smem(cfg, 3) == cfg.smem
    real = strip.f64mma_config

    def codes(change):
        monkeypatch.setattr(strip, "f64mma_config", lambda *a: (
            lambda cfg: cfg and change(cfg))(real(*a)))
        found = {(d.code, d.severity, d.step)
                 for d in analysis.verify_plan(plan, include_info=False)}
        monkeypatch.setattr(strip, "f64mma_config", real)
        return found

    for change in (lambda c: dataclasses.replace(c, th=9),
                   lambda c: dataclasses.replace(c, bn=24),
                   lambda c: dataclasses.replace(c, cc=c.cc + 4),
                   lambda c: dataclasses.replace(c, tw=16)):
        assert codes(change) == {("LTR020", "error", s) for s in f64}
