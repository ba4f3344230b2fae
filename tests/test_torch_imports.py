"""repro_torch stands alone: it imports torch, never JAX or ``repro``.

* a fresh interpreter imports every module of the port, and no ``jax*`` or
  ``repro``/``repro.*`` module is loaded;
* an AST scan of every source file of the port, of ``chip_smoke.py`` and
  of ``scripts/verify_plan_torch.py`` finds no import of either;
* with no GPU, the entry points raise unless the caller asks for the CPU.
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
