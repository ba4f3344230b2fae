"""repro_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the ``gpu``
marker; run them on the card with ``pytest -m gpu tests/test_torch_gpu.py``).
On the card each kernel's wrapper must launch its kernel, count the launch,
and be bitwise equal to its plain PyTorch version on the same inputs; the
whole serving path on the card must equal the port's CPU run.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import Options, Program
from repro_torch.core.compressive import compressive_acquire
from repro_torch.core.plan import padtype_to_pads
from repro_torch.kernels import dispatch, launch_counts, reset_launch_counts
from repro_torch.kernels.ca_pool.ops import ca_pool
from repro_torch.kernels.conv_bank.fused import conv_chain
from repro_torch.kernels.conv_bank.ref import conv_chain_ref
from repro_torch.kernels.photonic_mvm.ops import mvm_int
from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (8, 400, 120), (2048, 576, 64),
                                   (128, 2304, 256), (37, 101, 53)])
def test_mvm_kernel_bitwise_equal_to_plain(cuda, m, k, n):
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-15, 16, (m, k), generator=g).to(torch.int8).to(cuda)
    w = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8).to(cuda)
    ws = (torch.rand((n,), generator=g) + 0.5).to(cuda)
    reset_launch_counts()
    got = mvm_int(a, w, ws, 0.37)
    assert launch_counts()["photonic_mvm"] == 1
    assert torch.equal(got, mvm_int_ref(a, w, ws, 0.37))


@pytest.mark.parametrize("dw,act,pool,stride", [
    (False, "relu", ("avg", 2), 1), (True, "abs", ("max", 2), 1),
    (False, "sign", None, 2), (True, "none", ("avg", 2), 1)])
def test_chain_kernel_bitwise_equal_to_plain(cuda, dw, act, pool, stride):
    g = torch.Generator().manual_seed(3)
    h, c = 16, 4
    stages, hh, cc = [], h, c
    for j in range(2):
        co = cc if dw else 6
        pads = padtype_to_pads((hh, hh), 3, stride, "SAME")
        geom = dispatch.ChainGeom(f"s{j}", hh, hh, cc, co, 3, stride, pads,
                                  groups=cc if dw else 1, act=act,
                                  pool=pool if j == 0 else None)
        wq = torch.randint(-7, 8, (3, 3, 1 if dw else cc, co), generator=g)
        stages.append((geom, wq.to(torch.int8).to(cuda),
                       (torch.rand((co,), generator=g) * 0.1).to(cuda),
                       torch.randn((co,), generator=g).to(cuda)))
        hh, _ = geom.out_hw()
        cc = co
    codes = torch.randint(0, 16, (3, h, h, c), generator=g).float().to(cuda)
    scale = (torch.rand((3, 1, 1, 1), generator=g) + 0.01).to(cuda)
    reset_launch_counts()
    got = conv_chain(codes, scale, stages, 15.0)
    assert launch_counts()["conv_chain"] == 1
    want = conv_chain_ref(codes, scale, stages, 15.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_chain_kernel_refuses_frames_beyond_shared_memory(cuda):
    geom = dispatch.ChainGeom("big", 256, 256, 3, 8, 3, 1, ((1, 1), (1, 1)))
    stage = (geom, torch.ones((3, 3, 3, 8), device=cuda),
             torch.ones((8,), device=cuda), None)
    with pytest.raises(ValueError, match="shared memory"):
        conv_chain(torch.zeros((1, 256, 256, 3), device=cuda),
                   torch.ones((1, 1, 1, 1), device=cuda), [stage], 15.0)


@pytest.mark.parametrize("shape,pool,gray", [
    ((8, 32, 32, 3), 2, True), ((8, 32, 32, 3), 4, True),
    ((4, 28, 28, 1), 2, True), ((4, 28, 28, 1), 2, False),
    ((2, 16, 24, 3), 2, False)])
def test_ca_kernel_bitwise_equal_to_plain(cuda, shape, pool, gray):
    g = torch.Generator().manual_seed(5)
    img = torch.rand(shape, generator=g).to(cuda)
    reset_launch_counts()
    got = ca_pool(img, pool, gray)
    assert launch_counts()["ca_pool"] == 1
    assert torch.equal(got, compressive_acquire(img, pool, gray))


def test_strip_conv_raises_on_cuda(cuda):
    codes = torch.zeros((1, 8, 8, 2), device=cuda)
    wq = torch.zeros((3, 3, 2, 2), dtype=torch.int8, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dispatch.conv_int(codes, wq, 1, ((1, 1), (1, 1)),
                          strategy=dispatch.ConvStrategy("strip", 8, 1))


@pytest.mark.parametrize("name", ["lenet", "vgg9"])
def test_model_on_card_equals_cpu_and_reference(cuda, name):
    prog = Program.from_model(name, torch.Generator().manual_seed(1))
    hwc = prog.input_hwc
    f = np.random.default_rng(2).random((5, *hwc)).astype(np.float32)
    cpu = prog.compile(Options(device="cpu")).run_per_frame(f).numpy()
    reset_launch_counts()
    card = prog.compile(Options(device="cuda")).run_per_frame(f)
    counts = launch_counts()
    assert counts["photonic_mvm"] > 0
    assert counts["conv_chain" if name == "lenet" else "ca_pool"] == 1
    np.testing.assert_array_equal(card.cpu().numpy(), cpu)
    ref = prog.compile(Options(device="cuda", backend="reference"))
    np.testing.assert_array_equal(ref.run_per_frame(f).cpu().numpy(), cpu)
    np.testing.assert_array_equal(ref.run(f).cpu().numpy(),
                                  prog.compile(Options(device="cpu"))
                                  .run(f).numpy())
