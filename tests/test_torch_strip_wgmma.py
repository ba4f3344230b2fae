"""The int8 strip conv's wgmma form (``csrc/conv_strip_wgmma.cu::
conv_igemm_wgmma_kernel``, chosen by ``strip.igemm_config``) on the CPU.

The kernel runs only on the card (``test_torch_gpu.py``); here the
Python that surrounds it is held: the launch rule covers every output
pixel and channel in a CTA's shared memory at VGG16's shapes and at
ragged edges, and leaves stride 2 and conv1 on the mma.sync forms; the
shared-memory addressing of its wgmma operands (``strip.
wgmma_descriptors``: each tap's A start, LBO and SBO in the staged patch,
B's in the staged levels), gathered from stages filled as its TMA boxes
fill them, reproduces the conv bitwise; the folded store's partial maxima
follow its CTA order; the verifier sizes its launches and catches one that
does not cover; and the kernels' build rehashes a shared header.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import Options, Program, analysis
from repro_torch.analysis import verifier
from repro_torch.core.quant import W4A4
from repro_torch.kernels import _build
from repro_torch.kernels.conv_bank import strip
from repro_torch.kernels.edge_shapes import (CONV_BANK_CALLS,
                                             INT_FORM_SHAPES,
                                             INT_WGMMA_EDGES, VGG16_SHAPES)

CPU = Options(scheme=W4A4, device="cpu", verify="off")


def _vgg16_entries():
    for name, _, _, w_out, ci, co, k, s in VGG16_SHAPES["conv_strip"]:
        if ci >= 16:
            for b in (1, 8, 13):
                yield (name, b, w_out, w_out, ci, co, k)


# ragged edges besides INT_WGMMA_EDGES': widths and heights not a multiple
# of 8, C_in 16, batch 1 and 13, one row, a tile taller than the output
RAGGED = [(1, 7, 9, 16, 64, 3), (13, 30, 17, 16, 33, 3),
          (1, 1, 100, 32, 128, 3), (13, 5, 5, 64, 256, 3),
          (2, 57, 43, 128, 96, 3), (1, 3, 250, 16, 16, 7)]


@pytest.mark.parametrize("entry", [*_vgg16_entries(),
                                   *[("edge", *e) for e in INT_WGMMA_EDGES],
                                   *[("ragged", *e) for e in RAGGED]])
def test_wgmma_config_covers_the_output_in_shared_memory(entry):
    _, b, h, w, ci, co, k = entry
    cfg = strip.igemm_config(b, h, w, ci, co, k, 1, form="wgmma")
    assert cfg.form == "wgmma" and cfg.kf == 0
    assert cfg == strip.wgmma_config(b, h, w, ci, co, k, 1)
    # the stages, the barriers and the fold's warp maxima fit a CTA
    assert cfg.smem + strip.IGEMM_FOLD_RED <= strip.SMEM_MAX == 232448
    assert cfg.smem == strip.wgmma_smem(cfg.th, cfg.tw, cfg.bn, k, cfg.ch,
                                        cfg.stages)
    assert verifier._int_smem(cfg, k, 1) == cfg.smem
    assert verifier._int_smem(cfg, k, 1, True) == \
        cfg.smem + strip.IGEMM_FOLD_RED
    # 8 x 8 blocks: one or two m64 blocks for each of two warpgroups
    assert cfg.th % 8 == 0 and cfg.tw % 8 == 0
    assert cfg.th * cfg.tw in (128, 256)
    assert cfg.bn in strip.WG_BN and (cfg.bn == 64 or co > 64)
    chunks = -(-ci // cfg.ch)
    assert 1 <= cfg.stages <= min(chunks, strip.WG_MAX_STAGES)
    assert chunks == 1 or cfg.stages >= 2       # a ring needs two
    # every output pixel and channel in exactly one CTA's tile and block
    row_tiles, col_tiles = -(-h // cfg.th), -(-w // cfg.tw)
    blocks = -(-co // cfg.bn)
    assert cfg.ctas == b * row_tiles * col_tiles * blocks
    assert (row_tiles - 1) * cfg.th < h <= row_tiles * cfg.th
    assert (col_tiles - 1) * cfg.tw < w <= col_tiles * cfg.tw
    assert (blocks - 1) * cfg.bn < co <= blocks * cfg.bn
    # a TMA box's dimensions: at most 256 each
    assert cfg.th + k - 1 <= 256 and cfg.tw + k - 1 <= 256 and k * k <= 256
    assert strip.fold_partials(b, cfg) == row_tiles * col_tiles * blocks


def test_igemm_config_keeps_the_mma_forms_off_the_wgmma_form():
    # stride 2, C_in off a multiple of 16, under WG_MIN_C input or output
    # channels (the conv_bank op's 16 -> 32 among them) and conv1's 3
    # channels take the mma.sync kernels; VGG16's conv2-conv10 the wgmma
    # form, at any batch
    assert strip.igemm_config(8, 27, 31, 32, 16, 3, 2).form == "mma"
    assert strip.igemm_config(8, 27, 31, 64, 64, 3, 2).form == "mma"
    assert strip.igemm_config(1, 24, 24, 40, 10, 5, 1).form == "mma"
    assert strip.WG_MIN_C == 64
    for b, h, w, ci, co, k in CONV_BANK_CALLS:
        for batch in (1, b, 13):
            assert strip.igemm_config(batch, h, w, ci, co, k, 1).form == \
                "mma"
        assert strip.int_form(ci, co, k, 1) == "mma"
        assert strip.igemm_config(b, h, w, ci, co, k, 1,
                                  form="wgmma").form == "wgmma"
    for ci, co in ((48, 512), (512, 48), (64, 64), (64, 32), (32, 64)):
        want = "wgmma" if min(ci, co) >= strip.WG_MIN_C else "mma"
        assert strip.int_form(ci, co, 3, 1) == want
        assert strip.igemm_config(4, 20, 20, ci, co, 3, 1).form == want
    conv1 = strip.igemm_config(8, 224, 224, 4, 64, 3, 1)
    assert conv1.form == "taps" and conv1.kf == 64
    for _, _, _, w_out, ci, co, k, s in VGG16_SHAPES["conv_strip"]:
        for b in (1, 8):
            form = strip.igemm_config(b, w_out, w_out, strip.igemm_c_in(
                ci, k), co, k, s).form
            assert form == ("taps" if ci < 16 else "wgmma")
    # a forced form: the mma.sync one anywhere, the wgmma one where it
    # applies
    mma = strip.igemm_config(8, 56, 56, 128, 256, 3, 1, form="mma")
    assert mma.form == "mma" and mma.ch == strip.IGEMM_CH
    assert mma.th * mma.tw <= strip.IGEMM_BM and mma.bn in strip.IGEMM_BN
    assert strip.igemm_config(8, 56, 56, 128, 256, 3, 1,
                              form="wgmma") == \
        strip.igemm_config(8, 56, 56, 128, 256, 3, 1)
    with pytest.raises(ValueError, match="wgmma form does not take"):
        strip.igemm_config(8, 27, 31, 32, 16, 3, 2, form="wgmma")
    with pytest.raises(ValueError, match="form"):
        strip.igemm_config(8, 27, 31, 32, 16, 3, 1, form="tiles")


# -- the kernel's shared-memory addressing, emulated ------------------------

def _core_matrix_index(start, lbo, sbo, rows):
    """Byte offsets of a no-swizzle K-major wgmma operand of ``rows`` x 32
    bytes: row m, byte kk at start + (m // 8) * sbo + (m % 8) * 16 +
    (kk // 16) * lbo + kk % 16 (core matrices of 8 rows x 16 bytes)."""
    m = np.arange(rows)[:, None]
    kk = np.arange(32)[None, :]
    return start + (m // 8) * sbo + (m % 8) * 16 + (kk // 16) * lbo + kk % 16


def _emulate(x, wp, c_out, k, cfg):
    """The wgmma form's product over its CTAs, in int64: each chunk's
    stage filled as the kernel's TMA boxes fill it (patch planes u8
    [rows_in][cols_in][16], zero past the input and C_in; the weight
    planes s8 [k*k][bn][16] in one box of the plane-major levels ``wp``
    (``IntWeights.wp``: [C_k / 16, k*k, C_out, 16]), zero past C_out and
    C_in), each wgmma's
    operands gathered through :func:`strip.wgmma_descriptors`, its rows
    stored at the pixels the kernel's store gives them."""
    b, hp, wp_, c_k = x.shape
    h, w = hp - k + 1, wp_ - k + 1
    th, tw, bn, ch = cfg.th, cfg.tw, cfg.bn, cfg.ch
    rows_in, cols_in = th + k - 1, tw + k - 1
    box, pitch, wplane = strip.wgmma_planes(th, tw, bn, k)
    planes = ch // 16
    stage_bytes = planes * (pitch + wplane)
    tiles_w = -(-w // tw)
    tiles = -(-h // th) * tiles_w
    n_blocks = -(-c_out // bn)
    assert cfg.ctas == b * tiles * n_blocks
    mb = th * tw // 128                       # m64 blocks a warpgroup
    # zero-padded sources: whatever a box reads past the data is zero
    xz = np.zeros((b, hp + rows_in, wp_ + cols_in, c_k + ch), np.int64)
    xz[:, :hp, :wp_, :c_k] = x
    wz = np.zeros((c_k // 16 + planes, k * k, c_out + bn, 16), np.int64)
    wz[:c_k // 16, :, :c_out] = wp
    out = np.full((b, h, w, c_out), -1, np.int64)
    for cta in range(cfg.ctas):
        nb, mtile = cta % n_blocks, cta // n_blocks
        f, t = divmod(mtile, tiles)
        oh0, ow0 = (t // tiles_w) * th, (t % tiles_w) * tw
        n0 = nb * bn
        acc = np.zeros((2 * mb, 64, bn), np.int64)
        for c in range(-(-c_k // ch)):
            stage = np.zeros(stage_bytes, np.int64)
            np_ = 2 * -(-min(ch, c_k - c * ch) // 32)
            for j in range(np_):
                c0 = c * ch + 16 * j
                patch = xz[f, oh0:oh0 + rows_in, ow0:ow0 + cols_in,
                           c0:c0 + 16]
                stage[j * pitch:j * pitch + box] = patch.reshape(-1)
            stage[planes * pitch:] = wz[c * planes:(c + 1) * planes, :,
                                        n0:n0 + bn].reshape(-1)
            for tap in range(k * k):
                for q in range(np_ // 2):
                    for blk in range(2 * mb):
                        a, bb = strip.wgmma_descriptors(cfg, k, q, tap, blk)
                        av = stage[_core_matrix_index(*a, 64)]
                        bv = stage[_core_matrix_index(*bb, bn)]
                        acc[blk] += av @ bv.T
        # the store: block blk = wg * mb + i at 8 x 8 block blk of the tile
        # (tw / 8 a row); its row m at tile row 8 br + m // 8, column
        # 8 bc + m % 8
        for blk in range(2 * mb):
            br, bc = divmod(blk, tw // 8)
            for m in range(64):
                oh = oh0 + 8 * br + m // 8
                ow = ow0 + 8 * bc + m % 8
                if oh < h and ow < w:
                    cols = slice(n0, min(n0 + bn, c_out))
                    out[f, oh, ow, cols] = acc[blk, m, :cols.stop - n0]
    return out


@pytest.mark.parametrize("b,h,w,ci,co,k", [
    (2, 11, 13, 48, 70, 3), (1, 9, 17, 16, 64, 3), (3, 8, 8, 96, 20, 1),
    (1, 10, 9, 32, 130, 5), (1, 6, 20, 160, 8, 3)])
def test_wgmma_operands_reproduce_the_conv_bitwise(b, h, w, ci, co, k):
    rng = np.random.default_rng(b * 100 + ci + co + k)
    x = rng.integers(0, 256, (b, h + k - 1, w + k - 1, ci)).astype(np.uint8)
    wq = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    iw = strip.int_weights(torch.from_numpy(wq), form="wgmma")
    # the plane-major levels: plane j, tap (di, dj), output channel n holds
    # input channels 16j .. 16j + 15 of w[di, dj, :, n]
    assert iw.wt is None
    wp = iw.wp.numpy().astype(np.int64)
    assert wp.shape == (ci // 16, k * k, co, 16)
    np.testing.assert_array_equal(
        wp, wq.reshape(k * k, ci // 16, 16, co).transpose(1, 0, 3, 2))
    cfg = strip.igemm_config(b, h, w, ci, co, k, 1, form="wgmma")
    assert cfg.form == "wgmma"
    got = _emulate(x.astype(np.int64), wp, co, k, cfg)
    want = strip.conv_strip_int_ref(torch.from_numpy(x), torch.from_numpy(wq))
    np.testing.assert_array_equal(got.astype(np.float32), want.numpy())
    # the same with every other tile and block the form has
    for th, tw in strip.WG_TILES:
        for bn in strip.WG_BN:
            alt = dataclasses.replace(
                cfg, th=th, tw=tw, bn=bn,
                ctas=b * -(-h // th) * -(-w // tw) * -(-co // bn))
            if (th, tw, bn) != (cfg.th, cfg.tw, cfg.bn) and ci == 48:
                np.testing.assert_array_equal(
                    _emulate(x.astype(np.int64), wp, co, k,
                             alt).astype(np.float32), want.numpy())


@pytest.mark.parametrize("ci,co,k,stride,form", [
    (64, 128, 3, 1, None), (512, 512, 3, 1, None), (16, 32, 5, 1, None),
    (64, 64, 3, 2, None), (3, 64, 3, 1, None), (16, 32, 7, 1, "wgmma"),
    (512, 512, 3, 1, "mma"), (3, 64, 3, 1, "mma")])
def test_int_weights_lays_out_only_its_forms_levels(ci, co, k, stride, form):
    """The levels laid out once, for the form the rule gives the conv at
    its stride (whatever the batch) or the form forced: the wgmma form's
    plane-major ``wp``, or the mma.sync forms' ``wt`` (folded where the
    taps fold), never both; a launch on the other form's layout raises."""
    rng = np.random.default_rng(ci + co + k + stride)
    wq = torch.from_numpy(rng.integers(-7, 8, (k, k, ci, co)).astype(
        np.int8))
    c_k = strip.igemm_c_in(ci, k)
    iw = strip.int_weights(wq, stride=stride, form=form)
    want = form or strip.int_form(c_k, co, k, stride)
    if want == "wgmma":
        assert iw.wt is None and iw.wp.shape == (c_k // 16, k * k, co, 16)
    elif strip.igemm_fold_k(c_k, k):
        assert iw.wp is None
        assert iw.wt.shape == (co, strip.igemm_fold_k(c_k, k))
    else:
        assert iw.wp is None and iw.wt.shape == (k * k, co, c_k)
        np.testing.assert_array_equal(
            iw.wt.numpy(), wq.numpy().reshape(k * k, ci, co).transpose(
                0, 2, 1))
    assert torch.equal(iw.w8[:, :, :ci], wq)
    # the rule's form at any batch is int_form's
    for batch in (1, 8, 13):
        assert strip.igemm_config(batch, 12, 12, c_k, co, k,
                                  stride).form == strip.int_form(
                                      c_k, co, k, stride)
    # a forced launch on the other layout refuses before any kernel
    other = "mma" if want == "wgmma" else "wgmma"
    if other == "wgmma" and not strip.wgmma_launches(c_k, co, k, 1):
        return
    x = torch.zeros((1, 12 + k - 1, 12 + k - 1, c_k), dtype=torch.uint8)
    cfg = strip.igemm_config(1, 12, 12, c_k, co, k, 1, form=other)
    with pytest.raises(ValueError, match="not laid out"):
        strip.launch_int(x, iw, 1.0, "none", 1, cfg=cfg)


def test_int_weights_refuses_a_form_the_conv_cannot_take():
    # conv1's 3 channels carry 4 (the folded taps'), off a 16-byte plane
    w = torch.zeros((3, 3, 3, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="wgmma form does not take"):
        strip.int_weights(w, form="wgmma")
    with pytest.raises(ValueError, match="form"):
        strip.int_weights(w, form="taps")


def test_int_form_shapes_cover_the_served_convs_and_the_conv_bank_op():
    """The forced-form shapes both forms are held to and timed at: every
    VGG16 int8 strip conv past conv1, conv11-13 and each conv_bank op
    call, each taken by both forms."""
    names = [s[0] for s in INT_FORM_SHAPES]
    assert names[:7] == [s[0] for s in VGG16_SHAPES["conv_strip"][1:]]
    assert names[7] == "conv11+conv12+conv13"
    assert len(names) == 8 + len(CONV_BANK_CALLS) == len(set(names))
    for name, h, ci, co, k in INT_FORM_SHAPES:
        for form in ("wgmma", "mma"):
            assert strip.igemm_config(8, h, h, ci, co, k, 1,
                                      form=form).form == form
        assert strip.int_form(ci, co, k, 1) == (
            "mma" if name.startswith("conv_bank") else "wgmma")


def test_wgmma_descriptors_fit_the_hardware_fields():
    """Each start, LBO and SBO is a multiple of 16 bytes inside the 14-bit
    fields of a descriptor (addresses >> 4 below 2^14: 256 KB), at every
    VGG16 entry's largest offsets."""
    for _, b, h, w, ci, co, k in _vgg16_entries():
        cfg = strip.igemm_config(b, h, w, ci, co, k, 1)
        _, pitch, wplane = strip.wgmma_planes(cfg.th, cfg.tw, cfg.bn, k)
        # the last stage's start, past the alignment's slack
        last = strip.WG_ALIGN + (cfg.stages - 1) * cfg.ch // 16 * (
            pitch + wplane)
        for q in (0, cfg.ch // 32 - 1):
            for tap in (0, k * k - 1):
                for blk in (0, cfg.th * cfg.tw // 64 - 1):
                    for d in strip.wgmma_descriptors(cfg, k, q, tap, blk):
                        for v in (d[0] + last, d[1], d[2]):
                            assert v % 16 == 0 and v >> 4 < 1 << 14


# -- the folded store's partial maxima --------------------------------------

@pytest.mark.parametrize("b,h,w,c", [(3, 20, 27, 130), (1, 28, 28, 512),
                                     (2, 56, 56, 64)])
def test_fold_partials_follow_the_wgmma_cta_order(b, h, w, c):
    """fold_ref's maxima against each work item's own max over the pixels
    its warps store (two warpgroups of 4 warps, each warp rows 2 wq and 2
    wq + 1 of its m64 blocks, column lane / 4) and its channel block, in
    the kernel's item order (channel blocks fastest, then the frame's
    tiles row-major, then the frames)."""
    rng = np.random.default_rng(h + w + c)
    acc = torch.from_numpy(rng.integers(-3000, 3000, (b, h, w, c))).float()
    fold = strip.Fold(torch.from_numpy(rng.random((b, 1, 1, 1)) * 0.01 +
                                       1e-3).float(),
                      torch.from_numpy(rng.random(c) * 0.2).float(),
                      torch.from_numpy(rng.standard_normal(c)).float(),
                      "relu")
    cfg = strip.igemm_config(b, h, w, 16 * (1 + c % 3), c, 3, 1,
                             form="wgmma")
    assert cfg.form == "wgmma"
    y, partials = strip.fold_ref(acc, fold, cfg)
    per = strip.fold_partials(b, cfg)
    assert partials.shape == (b, per)
    tiles_w = -(-w // cfg.tw)
    n_blocks = -(-c // cfg.bn)
    mb = cfg.th * cfg.tw // 128
    # every consumer thread's stored pixels, as tile rows and columns
    wg, wq, lane, i, hh = np.meshgrid(range(2), range(4), range(32),
                                      range(mb), range(2), indexing="ij")
    br, bc = np.divmod(wg * mb + i, cfg.tw // 8)
    tr = (8 * br + 2 * wq + hh).reshape(-1)
    tc = (8 * bc + lane // 4).reshape(-1)
    assert len(set(zip(tr, tc))) == cfg.th * cfg.tw
    yp = torch.nn.functional.pad(y, (0, -c % cfg.bn, 0, cfg.tw, 0, cfg.th))
    for cta in range(cfg.ctas):
        nb, mtile = cta % n_blocks, cta // n_blocks
        f, t = divmod(mtile, per // n_blocks)
        oh = (t // tiles_w) * cfg.th + tr
        ow = (t % tiles_w) * cfg.tw + tc
        vals = yp[f, oh, ow, nb * cfg.bn:(nb + 1) * cfg.bn]
        assert partials[f, cta - f * per] == vals.max(), cta


# -- the verifier's audit ----------------------------------------------------

def test_audit_sizes_the_wgmma_launches_and_catches_one_that_does_not_cover(
        monkeypatch):
    """VGG16's conv2-conv10 launch the wgmma form at both audited batches,
    sized with the fold's maxima (their requants fold into the store);
    planted launches: half the CTAs (LTR020 on each of them, none on
    conv1), a tile off the 8 x 8 blocks (LTR020), and stages past a CTA's
    shared memory (LTR022)."""
    plan = Program.from_model("vgg16", params={}).compile(CPU).plan
    assert analysis.verify_plan(plan, include_info=False) == ()
    wgmma = {f"conv{i}" for i in range(2, 11)}
    for st in plan.steps:
        if getattr(st, "name", None) in wgmma:
            launches = verifier._strip_launches(
                st.geom, st.strategy, "int",
                st.name in plan.folded_epilogues)
            assert [lt[0] for lt in launches] == ["int_folded"] * 2
            for kind, b, rows, cols, ci, co, cfg in launches:
                assert cfg.form == "wgmma"
                assert verifier._int_smem(cfg, 3, 1, True) == \
                    cfg.smem + strip.IGEMM_FOLD_RED <= strip.SMEM_MAX
    real = strip.igemm_config

    def codes(change):
        def planted(*a, **kw):
            cfg = real(*a, **kw)
            return change(cfg) if cfg.form == "wgmma" else cfg
        monkeypatch.setattr(strip, "igemm_config", planted)
        found = {(d.code, d.severity, d.step)
                 for d in analysis.verify_plan(plan, include_info=False)}
        monkeypatch.setattr(strip, "igemm_config", real)
        return found

    found = codes(lambda cfg: dataclasses.replace(cfg, ctas=cfg.ctas // 2))
    assert found == {("LTR020", "error", s) for s in wgmma}
    found = codes(lambda cfg: dataclasses.replace(cfg, th=12, tw=16))
    assert ("LTR020", "error", "conv5") in found
    found = codes(lambda cfg: dataclasses.replace(cfg, ch=128, stages=4))
    assert ("LTR022", "warning", "conv10") in found
    assert not {d for d in found if d[0] != "LTR022"}


# -- the build ---------------------------------------------------------------

def test_library_path_rehashes_a_shared_header(tmp_path, monkeypatch):
    """A library's name digests its .cu and every header it includes by
    quotes, recursively: editing the Hopper header renames the two
    libraries that include it (a stale one is never loaded), editing the
    int8 store's renames both int8 libraries, and a kernel that includes
    neither keeps its name."""
    for name in ("conv_strip.cu", "conv_strip_wgmma.cu", "photonic_mvm.cu",
                 "ca_pool.cu", "hopper.cuh", "int_store.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("conv_strip_wgmma")] == [
        "conv_strip_wgmma.cu", "hopper.cuh", "int_store.cuh"]
    assert [p.name for p in _build.sources("conv_strip")] == [
        "conv_strip.cu", "int_store.cuh"]
    names = ("conv_strip", "conv_strip_wgmma", "photonic_mvm", "ca_pool")

    def paths():
        return {n: _build.library_path(n) for n in names}

    def edit(header, text=b"\n// edited\n"):
        path = tmp_path / header
        path.write_bytes(path.read_bytes() + text)

    before = paths()
    edit("hopper.cuh")
    after = paths()
    assert {n for n in names if after[n] != before[n]} == {
        "conv_strip_wgmma", "photonic_mvm"}
    edit("int_store.cuh")
    again = paths()
    assert {n for n in names if again[n] != after[n]} == {
        "conv_strip", "conv_strip_wgmma"}
    # a header the header includes counts too
    (tmp_path / "inner.cuh").write_text("// one\n")
    edit("hopper.cuh", b'#include "inner.cuh"\n')
    mid = _build.library_path("photonic_mvm")
    (tmp_path / "inner.cuh").write_text("// two\n")
    assert _build.library_path("photonic_mvm") != mid
    assert [p.name for p in _build.sources("photonic_mvm")] == [
        "photonic_mvm.cu", "hopper.cuh", "inner.cuh"]
