"""Nothing the harness loads is JAX or the JAX package (module names
compared by their whole top-level name: ``repro_torch`` is not
``repro``), and ``run.py`` prints no result where it cannot run."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import manifest

ROOT = manifest.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted((ROOT / "portbench").rglob("*.py"))
A_CELL = manifest.load()["workloads"][0]["name"]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_a_whole_run_loads_no_jax_module():
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from portbench import harness, manifest
from portbench.tests.conftest import small_config, small_workload
import portbench.run, portbench.control, portbench.sweep
cell = "vgg9-ca-w4a4.tiles256-closed"
bench = manifest.load()
for m in bench["end_to_end"] + bench["per_layer"]:
    manifest.reader(m["name"])
out = harness.run(cell, 3, 1.0, True, device="cpu",
                  cfg=small_config(manifest.config("vgg9-ca-w4a4")),
                  wl=small_workload(manifest.workload(cell)))
print(json.dumps({{"correct": out["correct"],
                  "bad": harness.forbidden_modules(),
                  "loaded": sorted({{n.split(".")[0] for n in sys.modules}})}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["bad"] == []
    assert not FORBIDDEN & set(got["loaded"])
    assert "repro_torch" in got["loaded"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "reprox", sys)
    monkeypatch.setitem(sys.modules, "jaxified.sub", sys)
    assert harness.forbidden_modules() == [
        n for n in sorted(sys.modules) if n.split(".")[0] in FORBIDDEN]
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro.fake" in harness.forbidden_modules()


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops = {node.module.split(".")[0]}
        else:
            continue
        assert not tops & FORBIDDEN, (path, ast.dump(node))


def test_run_prints_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         A_CELL, "--seed", "2147483700", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
        env=_env(), cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_prints_no_result_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         A_CELL, "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env=_env(), cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_prints_no_result_with_a_jax_module_loaded(monkeypatch, capsys):
    import torch

    import portbench.run as cli
    from portbench import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", sys)
    rc = cli.main(["--workload", A_CELL, "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err
