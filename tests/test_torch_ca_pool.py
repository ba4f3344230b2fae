"""The ca_pool kernel's launch configuration (``ca_pool.ops.ca_config``),
on the CPU.

Pinned here:

* every edge of ``CA_EDGES`` picks the route it is listed for, with the run
  length its (p, C) is instantiated at, a CTA of one of ``THREADS`` and no
  grid dimension above its limit;
* the kernel's walk over that grid, emulated with its own index formulas
  (runs along a row, rows down the grid-stride loop, a row's 64-bit start
  offset, the masked tail of a scalar run), writes every output exactly once
  and, with each output's taps in the kernel's order, equals
  ``compressive_acquire`` bitwise;
* the served path shapes get the launches ``PERF.md`` reports, and shapes
  past 2^31 floats or 65535 row blocks stay within the grid's limits;
* the (p, C, R) instantiated in ``csrc/ca_pool.cu`` are the ones the
  wrapper lists.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.compressive import (ca_coefficients,
                                          compressive_acquire, fma_f32)
from repro_torch.core.quant import true_div
from repro_torch.kernels.ca_pool import ops
from repro_torch.kernels.edge_shapes import CA_EDGES

CSRC = Path(ops.__file__).resolve().parents[2] / "csrc" / "ca_pool.cu"


def _img(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).random(shape).astype(np.float32))


def _assert_legal(cfg, b, h, w, p):
    rows, wo = b * (h // p), w // p
    assert cfg.threads in ops.THREADS
    assert cfg.tx & (cfg.tx - 1) == 0 and cfg.ty >= 1
    gx, gy = cfg.grid
    assert 1 <= gx <= ops.INT_MAX and 1 <= gy <= ops.MAX_GRID_Y
    # x covers a row's runs with no CTA left idle; y covers the rows, or
    # walks them in a grid-stride loop of at most one wave of CTAs
    assert (gx - 1) * cfg.tx * cfg.r < wo <= gx * cfg.tx * cfg.r
    if gy * cfg.ty < rows:
        assert gy == ops.MAX_GRID_Y or cfg.ctas <= ops.SMS * (
            ops.THREADS_PER_SM // cfg.threads)
    else:
        assert (gy - 1) * cfg.ty < rows


def _emulate(img, p, gray, cfg):
    """The kernel's walk over ``cfg``'s grid on the CPU: each thread's run
    start ``j0`` along the row, the rows it takes in the grid-stride loop,
    the flat input offsets it loads (a row's start, then ``j0 * p * C``)
    and the flat outputs it writes, each output's taps in the kernel's
    order. Returns the output and how often each element was written."""
    b, h, w, c = img.shape
    ho, wo = h // p, w // p
    rows, row_len, r = b * ho, p * wo * c, cfg.r
    gx, gy = cfg.grid
    j0 = (torch.arange(gx)[:, None] * cfg.tx + torch.arange(cfg.tx)) \
        .reshape(-1) * r
    j0 = j0[j0 < wo]
    start = (torch.arange(gy)[:, None] * cfg.ty + torch.arange(cfg.ty)) \
        .reshape(-1)
    walked = [start + i * gy * cfg.ty
              for i in range(-(-rows // (gy * cfg.ty)))]
    rr = torch.cat(walked)
    rr = rr[rr < rows]
    # every (row, output) a thread computes: its run's first `valid`
    q = torch.arange(r)
    jj = (j0[:, None] + q).reshape(-1)
    jj = jj[jj < wo]
    R, J = torch.meshgrid(rr, jj, indexing="ij")
    R, J = R.reshape(-1), J.reshape(-1)
    flat = img.reshape(-1)
    n_out = rows * wo * (1 if gray else c)
    out = torch.full((n_out,), float("nan"))
    writes = torch.zeros(n_out, dtype=torch.int64)

    def tap(di, dj, ch):
        return flat[(p * R + di) * row_len + J * p * c + dj * c + ch]

    if gray:
        coef = ca_coefficients(p, c)
        acc = torch.zeros(R.shape)
        for ch in range(c):
            for di in range(p):
                for dj in range(p):
                    acc = fma_f32(tap(di, dj, ch), coef[di, dj, ch], acc)
        dst = R * wo + J
        out[dst] = acc
        writes.index_add_(0, dst, torch.ones_like(dst))
    else:
        for ch in range(c):
            acc = torch.zeros(R.shape)
            for di in range(p):
                for dj in range(p):
                    acc = acc + tap(di, dj, ch)
            dst = (R * wo + J) * c + ch
            out[dst] = true_div(acc, float(p * p))
            writes.index_add_(0, dst, torch.ones_like(dst))
    shape = (b, ho, wo) if gray else (b, ho, wo, c)
    return out.reshape(shape), writes


@pytest.mark.parametrize("b,h,w,c,p,gray,odd,route", CA_EDGES)
def test_ca_config_picks_the_listed_route_and_a_legal_grid(b, h, w, c, p,
                                                           gray, odd, route):
    cfg = ops.ca_config(b, h, w, c, p, gray, ops.SMS, not odd)
    assert cfg.route == route
    shapes = ops.GRAY_SHAPES if gray else ops.MEAN_SHAPES
    assert cfg.r == (1 if route == "generic" else shapes[(p, c)])
    if route == "vector":                         # whole 16-byte loads
        assert (w // p) % cfg.r == 0 and (p * cfg.r * c) % 4 == 0
        assert (w * c) % 4 == 0
    _assert_legal(cfg, b, h, w, p)


@pytest.mark.parametrize("b,h,w,c,p,gray,odd,route", CA_EDGES)
def test_ca_kernel_walk_covers_every_output_once_and_equals_plain(
        b, h, w, c, p, gray, odd, route):
    img = _img((b, h, w, c), seed=b + h + w + c + p)
    cfg = ops.ca_config(b, h, w, c, p, gray, ops.SMS, not odd)
    got, writes = _emulate(img, p, gray, cfg)
    assert bool((writes == 1).all())
    assert torch.equal(got, compressive_acquire(img, p, gray))


def test_ca_config_launches_at_the_path_shapes():
    # imaging p = 1: 64 runs of 4 a row, 4 rows a CTA -> 512 CTAs of 256
    cfg = ops.ca_config(8, 256, 256, 3, 1, True)
    assert (cfg.route, cfg.r, cfg.tx, cfg.ty, cfg.grid) == \
        ("vector", 4, 64, 4, (1, 512))
    # imaging p = 2: 32 runs a row; 256 threads would give 128 CTAs, fewer
    # than the SMs, so 128 threads -> 256 CTAs
    cfg = ops.ca_config(8, 256, 256, 3, 2, True)
    assert (cfg.route, cfg.r, cfg.tx, cfg.ty, cfg.grid) == \
        ("vector", 4, 32, 4, (1, 256))
    # VGG9's CA: 2048 outputs in 512 runs, spread over 16 CTAs of a warp
    cfg = ops.ca_config(8, 32, 32, 3, 2, True)
    assert (cfg.route, cfg.threads, cfg.ctas) == ("vector", 32, 16)
    assert cfg.ctas > 8
    # the SM count is the device's: fewer SMs, fewer CTAs needed
    assert ops.ca_config(8, 256, 256, 3, 2, True, 100).threads == 256


@pytest.mark.parametrize("b,h,w,c,p,gray", [
    (64, 4096, 4096, 3, 1, True),       # 3.2e9 floats: 64-bit row starts
    (64, 4096, 4096, 3, 2, False),
    (4096, 1024, 4, 1, 2, True),        # 2M rows of one run each
    (1, 2, 2**22, 3, 2, True),          # one row of 2^21 outputs
    (2, 4, 3000, 1, 2, True),           # 375 runs a row: a ragged second CTA
    (32768, 8, 8, 4, 1, False)])        # generic, 262144 rows
def test_ca_config_stays_within_the_grid_limits_past_32_bits(b, h, w, c, p,
                                                             gray):
    cfg = ops.ca_config(b, h, w, c, p, gray)
    _assert_legal(cfg, b, h, w, p)
    if b * h >= 2048:
        assert cfg.grid[1] * cfg.ty < b * (h // p)     # a grid-stride walk


def test_ca_instantiations_match_the_wrapper():
    src = CSRC.read_text()
    for mode, table in (("GRAY", ops.GRAY_SHAPES), ("MEAN", ops.MEAN_SHAPES)):
        line = re.search(rf"#define CA_{mode}_SHAPES\(X\) (.*)", src).group(1)
        found = {(int(p), int(c)): int(r) for p, c, r in
                 re.findall(r"X\((\d+), (\d+), (\d+)\)", line)}
        assert found == table
