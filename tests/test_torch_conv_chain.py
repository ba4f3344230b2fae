"""repro_torch fused conv chain: the plain version against both JAX oracles.

The port's ``conv_chain_ref`` (the CPU path of the chain kernel's wrapper)
must give the same codes and the same per-frame scales, bit for bit, as the
reference package's ``conv_chain_ref`` and its Pallas ``conv_chain_kernel``
in interpret mode: on LeNet's fused segment and on chains covering
depthwise stages, stride 2, max and avg pools, every fusable activation,
with and without bias, and both forms of the incoming scale.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels.conv_bank.fused_kernel import conv_chain_kernel
from repro.kernels.conv_bank.ref import conv_chain_ref as jax_chain_ref
from repro.kernels.conv_bank.ref import conv_taps_int as jax_taps
from repro_torch.core.plan import padtype_to_pads
from repro_torch.kernels import dispatch
from repro_torch.kernels.conv_bank.fused import (check_exact, conv_chain,
                                                 smem_layout)
from repro_torch.kernels.conv_bank.ref import (conv_chain_ref, conv_int_ref,
                                               conv_taps_int)

# (h, w, c_in, [(c_out, k, stride, padding, depthwise, act, pool, bias)])
CHAINS = {
    "lenet_like": (28, 28, 1, [(6, 5, 1, "SAME", False, "relu", ("avg", 2),
                                True),
                               (16, 5, 1, "VALID", False, "relu",
                                ("avg", 2), True)]),
    "dw_abs_max": (12, 12, 3, [(8, 3, 1, "SAME", False, "relu", ("max", 2),
                                True),
                               (8, 3, 1, "SAME", True, "abs", None, False)]),
    "dw_sign_avg": (16, 16, 4, [(4, 3, 1, "SAME", True, "sign", ("avg", 2),
                                 True),
                                (6, 5, 1, "VALID", False, "none", None,
                                 True)]),
    "stride2": (15, 15, 2, [(5, 3, 2, "SAME", False, "relu", None, False),
                            (7, 3, 1, "VALID", False, "abs", ("max", 2),
                             True)]),
    "three_stage": (16, 16, 1, [(6, 5, 1, "SAME", False, "relu", ("avg", 2),
                                 True),
                                (6, 3, 1, "SAME", True, "relu", ("max", 2),
                                 True),
                                (10, 3, 1, "SAME", False, "sign", None,
                                 False)]),
    "single_none": (9, 11, 3, [(4, 1, 1, "SAME", False, "none", None,
                                True)]),
    "stride2_avg": (16, 16, 3, [(4, 3, 2, "SAME", False, "abs", ("avg", 2),
                                 False),
                                (4, 3, 1, "SAME", True, "sign", None,
                                 True)]),
    "even_kernel": (10, 10, 2, [(3, 2, 1, "SAME", False, "relu", None, True),
                                (5, 3, 1, "VALID", False, "relu",
                                 ("max", 2), False)]),
}


def _build(spec, seed, batch=2):
    """The chain as (numpy stages, port geoms, jax geoms, codes, scale)."""
    h, w, c, stages_spec = spec
    rng = np.random.default_rng(seed)
    stages, geoms, jgeoms = [], [], []
    hh, ww, cc = h, w, c
    for j, (co, k, s, pad, dw, act, pool, bias) in enumerate(stages_spec):
        co = cc if dw else co
        pads = padtype_to_pads((hh, ww), k, s, pad)
        kw = dict(name=f"s{j}", h_in=hh, w_in=ww, c_in=cc, c_out=co,
                  kernel=k, stride=s, pads=pads, groups=cc if dw else 1,
                  act=act, pool=pool)
        geoms.append(dispatch.ChainGeom(**kw))
        jgeoms.append(jdispatch.ChainGeom(**kw))
        wq = rng.integers(-7, 8, (k, k, 1 if dw else cc, co)).astype(np.int8)
        ws = (rng.random(co) * 0.1 + 0.01).astype(np.float32)
        b = (rng.standard_normal(co) * 0.1).astype(np.float32) if bias \
            else None
        stages.append((wq, ws, b))
        hh, ww = geoms[-1].out_hw()
        cc = co
    codes = rng.integers(0, 16, (batch, h, w, c)).astype(np.float32)
    scale = (rng.random((batch, 1, 1, 1)) + 0.01).astype(np.float32)
    return stages, geoms, jgeoms, codes, scale


def _port_stages(stages, geoms):
    return [(g, torch.from_numpy(wq), torch.from_numpy(ws),
             None if b is None else torch.from_numpy(b))
            for g, (wq, ws, b) in zip(geoms, stages)]


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_ref_bitwise_equal_to_jax_oracles(name, per_frame):
    stages, geoms, jgeoms, codes, scale = _build(CHAINS[name],
                                                 seed=len(name))
    if not per_frame:                  # per-tensor form: batch 1, 0-d scale
        codes, scale = codes[:1], scale[0, 0, 0, 0]
    got_codes, got_scale = conv_chain_ref(
        torch.from_numpy(codes), torch.as_tensor(scale),
        _port_stages(stages, geoms), 15.0)
    operands = [(jnp.asarray(wq), jnp.asarray(ws),
                 None if b is None else jnp.asarray(b))
                for wq, ws, b in stages]
    oracles = [jax_chain_ref]
    if per_frame:                      # the Pallas kernel is slow to interpret
        oracles.append(lambda *a: conv_chain_kernel(*a, interpret=True))
    for oracle in oracles:
        # jitted, as the reference's executor runs it; geometry is static
        run = jax.jit(lambda c, s, ops, aq, oracle=oracle: oracle(
            c, s, [(g, *o) for g, o in zip(jgeoms, ops)], aq))
        want_codes, want_scale = run(jnp.asarray(codes), jnp.asarray(scale),
                                     operands, jnp.float32(15.0))
        np.testing.assert_array_equal(got_codes.numpy(),
                                      np.asarray(want_codes))
        np.testing.assert_array_equal(got_scale.numpy(),
                                      np.asarray(want_scale))


def test_chain_wrapper_on_cpu_is_the_plain_version():
    stages, geoms, _, codes, scale = _build(CHAINS["three_stage"], seed=1)
    st = _port_stages(stages, geoms)
    got = conv_chain(torch.from_numpy(codes), torch.from_numpy(scale), st,
                     15.0)
    want = conv_chain_ref(torch.from_numpy(codes), torch.from_numpy(scale),
                          st, 15.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", ["dw_abs_max", "stride2", "even_kernel"])
def test_tap_loop_equals_conv_and_jax_taps(name):
    stages, geoms, _, codes, _ = _build(CHAINS[name], seed=2)
    g, (wq, _, _) = geoms[0], stages[0]
    x, w = torch.from_numpy(codes), torch.from_numpy(wq)
    taps = conv_taps_int(x, w, g.kernel, g.stride, g.pads, g.depthwise)
    np.testing.assert_array_equal(
        taps.numpy(), conv_int_ref(x, w, g.stride, g.pads, g.groups).numpy())
    np.testing.assert_array_equal(
        taps.numpy(), np.asarray(jax_taps(jnp.asarray(codes),
                                          jnp.asarray(wq), g.kernel,
                                          g.stride, g.pads, g.depthwise)))


def test_dispatch_chain_scale_shapes_follow_calibration():
    stages, geoms, _, codes, scale = _build(CHAINS["lenet_like"], seed=4)
    st = _port_stages(stages, geoms)
    x = torch.from_numpy(codes)
    _, s = dispatch.conv_chain(x, torch.from_numpy(scale), st, 15.0,
                               per_frame=True)
    assert s.shape == (2, 1, 1, 1)
    _, s = dispatch.conv_chain(x[:1], torch.tensor(0.5), st, 15.0,
                               per_frame=False)
    assert s.shape == ()
    with pytest.raises(ValueError, match="batch 1"):
        dispatch.conv_chain(x, torch.tensor(0.5), st, 15.0, per_frame=False)


def test_smem_layout_fits_lenet_and_ping_pongs():
    _, geoms, _, _, _ = _build(CHAINS["three_stage"], seed=0)
    buf1, red, total = smem_layout(geoms)
    frames = [16 * 16 * 1] + [math.prod(g.out_hw()) * g.c_out for g in geoms]
    assert buf1 == max(frames[0::2]) and red == buf1 + max(frames[1::2])
    assert total == red * 4 + 128 <= 232448
    # a frame too large for one block's shared memory is refused up front
    big = dataclasses.replace(geoms[0], h_in=256, w_in=256, c_in=3)
    assert smem_layout([big])[2] > 232448


def test_check_exact_bounds_the_float32_accumulate():
    """a_qmax * max|level| * k*k*c_in/groups must stay below 2^24."""
    stages, geoms, _, _, _ = _build(CHAINS["lenet_like"], seed=0)
    check_exact(_port_stages(stages, geoms), 15.0)    # LeNet's segment
    # fan-in 3*3*1000 = 9000: past the int8 dtype's bound (15*128*9000 >
    # 2^24), so the levels are read; W4 levels (7) keep it exact
    wide = dataclasses.replace(geoms[0], c_in=1000, c_out=2, kernel=3)
    small = torch.full((3, 3, 1000, 2), 7, dtype=torch.int8)
    check_exact([(wide, small, None, None)], 15.0)
    full = torch.full((3, 3, 1000, 2), 127, dtype=torch.int8)
    with pytest.raises(ValueError, match="2\\^24"):
        check_exact([(wide, full, None, None)], 15.0)
    # float-carried levels are always read: 15 * 200 * 9000 > 2^24
    with pytest.raises(ValueError, match="stage s0"):
        check_exact([(wide, torch.full((3, 3, 1000, 2), -200.0), None,
                      None)], 15.0)
    # depthwise fan-in is k*k: 15 * 127 * 9 is far inside
    dw = dataclasses.replace(geoms[0], c_in=1000, c_out=1000, groups=1000)
    check_exact([(dw, torch.full((5, 5, 1, 1000), 127.0), None, None)], 15.0)


def test_fused_segment_selection_matches_reference():
    """Same rules and budget: the segments equal the reference's."""
    for name, spec in CHAINS.items():
        _, geoms, jgeoms, _, _ = _build(spec, seed=0)
        for mode in ("auto", "on", "off"):
            mine = dispatch.select_fused_segments(geoms, mode=mode)
            theirs = jdispatch.select_fused_segments(jgeoms, mode=mode)
            assert [dataclasses.asdict(s) for s in mine] == \
                [dataclasses.asdict(s) for s in theirs], (name, mode)
