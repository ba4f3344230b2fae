"""Structured diagnostics for the static-analysis passes.

The reference package's ``repro.analysis.diagnostics``, copied whole (the
port imports nothing of it): same codes, severities and message text.

Every finding the plan verifier (:mod:`repro_torch.analysis.verifier`) or
the concurrency lint (:mod:`repro_torch.analysis.lint`) emits is a
:class:`Diagnostic`: a stable code (``LTR…`` for plan/runtime invariants,
``LTC…`` for concurrency rules — the glossary lives in
``docs/analysis.md``), a severity, the step/site it anchors to, a message
stating the violated invariant, and a fix hint. Codes are API: tests and
CI match on them, so a code is never renamed or reused once shipped.

Severities:

``error``    a proven invariant violation — the compile pass raises
             :class:`PlanVerificationError` (under ``Options(verify=)``
             "auto"/"on") and the gates fail.
``warning``  suspicious but not provably wrong (e.g. a *forced* resident
             conv exceeding the VMEM budget); surfaced in
             ``ModelReport.verification`` and the CLI, never raised.
``info``     per-step facts worth reporting (accumulator headroom in
             bits); returned by :func:`repro_torch.analysis.verify_plan`
             and printed by ``scripts/verify_plan_torch.py``, but kept out of
             ``ModelReport`` so clean eager/compiled reports stay
             field-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence, Tuple

SEVERITIES = ("info", "warning", "error")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding from a static-analysis pass.

    ``step`` is the plan step / layer name for verifier findings, or
    ``path:line`` for lint findings. ``hint`` is the suggested fix —
    always actionable, never a restatement of the message.
    """

    code: str                      # stable, e.g. "LTR001"
    severity: str                  # "info" | "warning" | "error"
    step: str
    message: str
    hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; expected "
                             f"one of {SEVERITIES}")

    def asdict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        hint = f" (hint: {self.hint})" if self.hint else ""
        return f"{self.code} [{self.severity}] {self.step}: " \
               f"{self.message}{hint}"


def errors(diags: Iterable[Diagnostic]) -> Tuple[Diagnostic, ...]:
    """The error-severity subset, in order."""
    return tuple(d for d in diags if d.severity == "error")


def worst_severity(diags: Iterable[Diagnostic]) -> str:
    """The highest severity present ("info" for an empty sequence)."""
    rank = {s: i for i, s in enumerate(SEVERITIES)}
    worst = "info"
    for d in diags:
        if rank[d.severity] > rank[worst]:
            worst = d.severity
    return worst


def format_diagnostics(diags: Sequence[Diagnostic],
                       min_severity: str = "info") -> str:
    """One line per diagnostic at or above ``min_severity``."""
    floor = SEVERITIES.index(min_severity)
    return "\n".join(str(d) for d in diags
                     if SEVERITIES.index(d.severity) >= floor)


class PlanVerificationError(ValueError):
    """A compiled plan failed verification at error severity.

    Raised by ``Program.compile`` under ``Options(verify=)`` "auto"/"on"
    (and by :func:`repro_torch.analysis.verify_plan` callers that choose
    to).
    Carries the full diagnostic list — error *and* lower severities — so
    callers can render the complete report, not just the fatal line.
    """

    def __init__(self, diags: Sequence[Diagnostic]):
        self.diagnostics: Tuple[Diagnostic, ...] = tuple(diags)
        errs = errors(self.diagnostics)
        lines = "\n".join(f"  {d}" for d in errs)
        super().__init__(
            f"plan verification failed with {len(errs)} error(s):\n{lines}\n"
            f"(compile with Options(verify=\"off\") to bypass — the kernels "
            f"only assert these invariants, they do not enforce them)")
