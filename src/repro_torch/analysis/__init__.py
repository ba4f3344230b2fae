"""repro_torch.analysis — static verification of the invariants the kernels
assert (the reference's ``repro.analysis``, on the port's plans).

Two legs (the code glossary is the reference's ``docs/analysis.md``):

* :mod:`repro_torch.analysis.verifier` — a compile-time pass over a
  ``CompiledPlan`` proving the ``|acc| < 2^24`` integer-exactness window,
  shape legality across ``Program.then`` chains, and auditing the strip
  and fusion geometry, the Hopper launches' included, with an independent
  re-derivation. Wired into ``Program.compile`` via ``Options(verify=)``
  ("auto" | "on" | "off"; no environment variable: the default is
  "auto").
* :mod:`repro_torch.analysis.lint` — an AST concurrency lint over
  ``src/repro_torch/serve`` and ``src/repro_torch/obs`` (unlocked shared
  mutation, unjoined threads, futures settled outside ``_settle``):
  ``python -m repro_torch.analysis.lint src/repro_torch/serve
  src/repro_torch/obs``.

The package imports neither torch nor the core at import time;
``verify_plan`` imports the core lazily.
"""

from repro_torch.analysis.diagnostics import (Diagnostic,
                                              PlanVerificationError,
                                              SEVERITIES, errors,
                                              format_diagnostics,
                                              worst_severity)
from repro_torch.analysis.verifier import (ACC_EXACT_LIMIT, VERIFY_MODES,
                                           acc_bound, audit_fused_segments,
                                           headroom_bits, raise_on_errors,
                                           verify_mode, verify_plan)


def __getattr__(name):
    # lazy: `python -m repro_torch.analysis.lint` must not find the module
    # pre-imported by its own package (runpy's double-import warning)
    if name in ("lint_paths", "lint_source"):
        from repro_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(
        f"module 'repro_torch.analysis' has no attribute {name!r}")


__all__ = [
    "ACC_EXACT_LIMIT", "Diagnostic", "PlanVerificationError", "SEVERITIES",
    "VERIFY_MODES", "acc_bound", "audit_fused_segments", "errors",
    "format_diagnostics", "headroom_bits", "lint_paths", "lint_source",
    "raise_on_errors", "verify_mode", "verify_plan", "worst_severity",
]
