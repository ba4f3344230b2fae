"""The plain reference against the program's per-frame executor on the CPU
at a small input (every width as configured), and the configurations
against the program's own models."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import manifest, model
from portbench.reference.cnn import Reference
from portbench.tests.conftest import small_config

CONFIGS = ("vgg16-w4a4", "vgg9-ca-w4a4")
MODELS = {"vgg16-w4a4": "vgg16", "vgg9-ca-w4a4": "vgg9"}


def _frames(cfg, n, gen):
    cfg = dict(cfg, frames={"kind": "uniform", "dim_every": 3, "dim": 0.1})
    return model.make_frames(cfg, n, gen, torch.device("cpu"))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_bitwise_the_programs_per_frame_answers(name):
    from repro_torch import Options
    from repro_torch.core.quant import WASpec
    cfg = small_config(manifest.config(name))
    gen = torch.Generator().manual_seed(model.torch_seed(2**40 + 3))
    params = model.make_weights(cfg, gen, torch.device("cpu"))
    frames = _frames(cfg, 6, gen)
    exe = model.make_program(cfg, params).compile(
        Options(device="cpu", scheme=WASpec(4, 4)))
    served = exe.run_per_frame(frames).numpy()
    ref = Reference(cfg["layers"], params, 4, 4).logits(
        torch.from_numpy(frames)).numpy()
    assert np.array_equal(served, ref)
    # the logits are not degenerate: each frame's are spread
    assert (np.abs(ref).max(axis=1) > 0).all()
    assert len(np.unique(ref.round(8))) > ref.size // 2


@pytest.mark.parametrize("name", CONFIGS)
def test_configurations_are_the_programs_models(name):
    from repro_torch.models.vision import MODEL_INPUT_HWC, VISION_MODELS
    cfg = manifest.config(name)
    key = MODELS[name]
    assert model.program_layers(cfg) == tuple(VISION_MODELS[key]())
    assert tuple(cfg["input_hwc"]) == MODEL_INPUT_HWC[key]


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_and_frames_follow_the_seed(name):
    cfg = small_config(manifest.config(name))

    def draw(seed):
        gen = torch.Generator().manual_seed(model.torch_seed(seed))
        p = model.make_weights(cfg, gen, torch.device("cpu"))
        return p, model.make_frames(cfg, 2, gen, torch.device("cpu"))

    (p1, f1), (p2, f2), (p3, _) = draw(5), draw(5), draw(2**33 + 5)
    first = next(iter(p1))
    assert torch.equal(p1[first]["w"], p2[first]["w"])
    assert np.array_equal(f1, f2)
    assert not torch.equal(p1[first]["w"], p3[first]["w"])
    assert f1.min() >= 0.0 and f1.max() < 1.0


def test_reference_imports_only_torch():
    path = Path(manifest.HERE) / "reference" / "cnn.py"
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "typing", "torch"}
