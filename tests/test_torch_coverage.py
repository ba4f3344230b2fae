"""The port does all that the reference package does, by name.

An ``ast`` walk over both packages: every public top-level name of each
``src/repro/`` module (functions, classes, assigned constants) and every
public method of its public classes has its counterpart in the same
module of ``src/repro_torch/``, apart from the exceptions below, each
with its reason. A whole module is an exception only where the port has
no file of its name.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

KERNEL_BODY = "a Pallas kernel body: the port's is CUDA C++ in csrc/*.cu"
PYTREE = ("a typing alias of Any for annotations; the port annotates with "
          "its own types")
SWITCH = ("a process-wide switch of the reference's dispatch (environment "
          "variables, Pallas interpret mode); the port takes Options' "
          "fields and constructor arguments")

# modules of the reference with no same-named module in the port
MODULE_EXCEPTIONS = {
    "kernels/ca_pool/kernel.py": KERNEL_BODY,
    "kernels/conv_bank/fused_kernel.py": KERNEL_BODY,
    "kernels/conv_bank/kernel.py": KERNEL_BODY,
    "kernels/conv_bank/strip_kernel.py": KERNEL_BODY,
    "kernels/photonic_mvm/kernel.py": KERNEL_BODY,
    "launch/hlo_analysis.py": "parses XLA's HLO text; the port counts "
                              "collectives from torch's dispatcher in "
                              "launch/comm_analysis.py",
}

# (module, name) of the reference with no counterpart in the port's module
NAME_EXCEPTIONS = {
    ("launch/dryrun.py", "lower_cell"): "lowers a cell to XLA's HLO; the "
        "port's dry run executes the step under FakeTensorMode",
    ("launch/dryrun.py", "collective_bytes_from_hlo"): "reads collective "
        "bytes from HLO text; the port's come from comm_analysis",
    ("launch/dryrun.py", "COLLECTIVE_OPS"): "the HLO op names "
        "collective_bytes_from_hlo matches",
    ("launch/hillclimb.py", "lower_variant"): "lowers a variant to XLA's "
        "HLO; the port runs each variant's step on a fake group",
    ("launch/roofline.py", "NOTES"): "the reference's notes on TPU "
        "lowering; the port's roofline reads its constants from "
        "launch/mesh.py",
    ("launch/mesh.py", "ICI_BW"): "the TPU's inter-chip interconnect "
        "rate; the port divides collectives by NVLink's",
    ("distributed/sharding.py", "named_sharding"): "builds a jax "
        "NamedSharding; the port's placements are DTensor's",
    **{(m, "PyTree"): PYTREE for m in (
        "checkpoint/ckpt.py", "distributed/collectives.py",
        "distributed/pipeline.py", "launch/shardings.py", "launch/steps.py",
        "models/lm.py", "nn/module.py", "optim/adamw.py")},
    **{("kernels/dispatch.py", n): SWITCH for n in (
        "conv_strategy_mode", "conv_vmem_budget", "default_interpret",
        "get_backend", "set_backend", "set_interpret", "use_backend",
        "use_interpret")},
}


def public_names(path: pathlib.Path) -> set:
    """Public top-level defs, classes and assigned names of a module, and
    ``Class.method`` for the public methods of its public classes."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, (ast.FunctionDef,
                                               ast.AsyncFunctionDef))
                           and not sub.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                out.update(e.id for e in elts if isinstance(e, ast.Name)
                           and not e.id.startswith("_"))
    return out


def ref_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", ref_modules())
def test_every_public_name_has_its_counterpart(module):
    port = PORT / module
    if module in MODULE_EXCEPTIONS:
        assert not port.exists(), f"{module} is ported: drop its exception"
        return
    assert port.exists(), f"the port has no {module}"
    missing = sorted(public_names(REF / module) - public_names(port)
                     - {n for m, n in NAME_EXCEPTIONS if m == module})
    assert not missing, f"{module}: the port lacks {missing}"


def test_every_exception_is_still_needed():
    """An exception whose name the port now has, or the reference no longer
    has, is stale."""
    for (module, name), reason in NAME_EXCEPTIONS.items():
        assert reason
        assert name in public_names(REF / module), (module, name)
        port = PORT / module
        assert not port.exists() or name not in public_names(port), \
            f"{module}::{name} is ported: drop its exception"
    for module, reason in MODULE_EXCEPTIONS.items():
        assert reason and (REF / module).exists(), module
