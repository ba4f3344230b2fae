"""repro_torch stands alone: it imports torch, never JAX or ``repro``.

* a fresh interpreter imports every module of the port, and no ``jax*`` or
  ``repro``/``repro.*`` module is loaded;
* an AST scan of every source file of the port, of ``chip_smoke.py`` and
  of ``scripts/verify_plan_torch.py`` finds no import of either;
* with no GPU, the entry points (serving, training, the LM's and the
  MoE's) raise unless the caller asks for the CPU.
"""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax_or_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "scripts" / "verify_plan_torch.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_refuse_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import Options, Program
    from repro_torch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Options()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ServeConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Program.from_model("lenet").compile()
    # the CPU, asked for explicitly, works
    assert Options(device="cpu").device == "cpu"


def test_training_entry_points_refuse_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np
    from repro_torch.imaging import PIPELINES, fit_recon_head
    from repro_torch.launch import train_vision
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vision.main(["--steps", "1"])
    layers, params = PIPELINES["compress_recon_deconv"].build(8, 8, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_recon_head(layers, params, np.zeros((1, 8, 8, 1), np.float32),
                       steps=1)
    # the CPU, asked for explicitly, works
    run = train_vision.train("lenet", None, 1, 4, device="cpu")
    assert len(run.losses) == 1


def test_lm_entry_points_refuse_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import smoke_variant
    from repro_torch.launch import serve_lm
    from repro_torch.models import lm
    cfg = smoke_variant("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--smoke", "--gen", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 4)
    # the CPU, asked for explicitly, works
    toks, = serve_lm.main(["--smoke", "--gen", "2", "--batch", "1",
                           "--quant", "w4a4", "--device", "cpu"])
    assert toks.shape == (1, serve_lm.PROMPT_LEN + 2)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"


def test_moe_entry_points_refuse_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import smoke_variant
    from repro_torch.launch import serve_lm
    from repro_torch.models import lm
    from repro_torch.nn import moe
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_model=8, d_ff=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.init_moe(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_lm(torch.Generator().manual_seed(0),
                   smoke_variant("grok-1-314b"))
    # the CPU, asked for explicitly, works
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert p["router"].device.type == "cpu"
    toks, = serve_lm.main(["--arch", "kimi-k2-1t-a32b", "--smoke", "--gen",
                           "2", "--batch", "1", "--quant", "w4a4",
                           "--device", "cpu"])
    assert toks.shape == (1, serve_lm.PROMPT_LEN + 2)


def test_lm_training_entry_points_refuse_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.examples import imaging_demo, quickstart, train_lm_100m
    from repro_torch.launch import train
    args = ["--smoke", "--steps", "1", "--batch", "1", "--seq", "8",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--device", "cuda"] + args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(args)                     # the default is the card
    for example in (quickstart, imaging_demo):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm_100m.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    # the CPU, asked for explicitly, works
    assert len(train.main(["--device", "cpu"] + args)) == 1


def test_importing_the_port_starts_no_process_group():
    """The distributed modules (rules, meshes, the dry run, the checks)
    touch no process group and no device when imported."""
    code = (
        "import importlib, torch.distributed as dist\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "print('PG', dist.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "PG False" in out.stdout, out.stdout


def test_distributed_entry_points_refuse_what_they_cannot_run():
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="needs a process group"):
        train.train(["--smoke", "--device", "cpu", "--mesh", "1x2",
                     "--steps", "1"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import Options
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Options(device="cpu", shard_batch=True, mesh=("cuda:0", "cuda:0"))
