"""Concurrency lint for the serving and observability runtime (AST-based).

The reference package's ``repro.analysis.lint``, copied (the port imports
nothing of it): the same three rules, codes and suppression. It checks
mechanical properties of the source tree that review would otherwise
have to catch by hand: shared mutable state touched without its lock,
and a future settled directly instead of through the idempotent
``_settle`` helper (an ``InvalidStateError`` when the other settler wins
the race).

``LTC101`` (error) — an augmented assignment whose target reaches through
    an attribute (``self._total += n``, ``worker.inflight -= k``) outside
    any enclosing ``with <lock>:`` block. Attribute state is shared state
    in this codebase (every runtime object is touched from >= 2 threads);
    a read-modify-write outside the lock is a lost-update race.
    Lock-holding blocks are recognized syntactically: a ``with`` whose
    context expression mentions a name matching ``lock``/``cond``/
    ``mutex`` (``self._lock``, ``self._cond``, ``trace._lock``, a bare
    ``lock``). ``__init__``/``__post_init__``/``__new__`` are exempt (the
    object is not yet published), as are plain-name targets (locals).
    A nested function resets the lock context: its body runs when
    *called*, not where it is defined.

``LTC102`` (error) — a ``threading.Thread`` that is started but never
    joined. Matching is by dotted handle: ``x.thread =
    threading.Thread(...)`` + ``x.thread.start()`` with no
    ``x.thread.join(...)`` anywhere in the file, or an anonymous
    ``threading.Thread(...).start()`` chain. A daemon flag does not
    exempt: the stop path must bound shutdown, not abandon it.

``LTC103`` (error) — ``fut.set_result(...)`` / ``fut.set_exception(...)``
    called anywhere except inside a function named ``_settle``. Both
    sides of every settle race (completer vs timed-out stop vs deadline
    shed) must go through the idempotent helper so whichever runs second
    is a recorded no-op.

Suppression: append ``# lint: ok`` (optionally ``# lint: ok[LTC101]``)
to the flagged line. Use it for a documented single-threaded invariant,
not to mute a race.

Run as a CLI::

    python -m repro_torch.analysis.lint src/repro_torch/serve src/repro_torch/obs

or programmatically via :func:`lint_paths` / :func:`lint_source`.
"""

from __future__ import annotations

import ast
import re
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis.diagnostics import Diagnostic, errors

_LOCKISH = re.compile(r"lock|cond|mutex", re.IGNORECASE)
_SUPPRESS = re.compile(r"#\s*lint:\s*ok(?:\[(?P<codes>[A-Z0-9, ]+)\])?")

_EXEMPT_FUNCS = ("__init__", "__post_init__", "__new__")


def _dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> "a.b.c"; None for anything not a pure name/attr chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _mentions_lock(expr: ast.AST) -> bool:
    """Does any name/attribute inside ``expr`` look like a lock?"""
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and _LOCKISH.search(node.attr):
            return True
        if isinstance(node, ast.Name) and _LOCKISH.search(node.id):
            return True
    return False


def _is_thread_ctor(call: ast.AST) -> bool:
    """``threading.Thread(...)`` / ``Thread(...)`` (any module alias)."""
    if not isinstance(call, ast.Call):
        return False
    fn = call.func
    return (isinstance(fn, ast.Name) and fn.id == "Thread") or \
        (isinstance(fn, ast.Attribute) and fn.attr == "Thread")


class _FileLint:
    """One file's lint pass: a recursive walk carrying lock context."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.findings: List[Diagnostic] = []
        # LTC102 bookkeeping, file-global: start() in one method is
        # legitimately joined from another (start/stop pairs)
        self._thread_handles: dict = {}      # dotted name -> assign lineno
        self._started: dict = {}             # dotted name -> start lineno
        self._joined: set = set()

    # -- reporting ---------------------------------------------------------

    def _suppressed(self, lineno: int, code: str) -> bool:
        if not 1 <= lineno <= len(self.lines):
            return False
        m = _SUPPRESS.search(self.lines[lineno - 1])
        if not m:
            return False
        codes = m.group("codes")
        return codes is None or code in [c.strip()
                                         for c in codes.split(",")]

    def _flag(self, code: str, node: ast.AST, message: str,
              hint: str) -> None:
        lineno = getattr(node, "lineno", 0)
        if self._suppressed(lineno, code):
            return
        self.findings.append(Diagnostic(
            code, "error", f"{self.path}:{lineno}", message, hint))

    # -- the walk ----------------------------------------------------------

    def run(self) -> List[Diagnostic]:
        for stmt in self.tree.body:
            self._walk(stmt, locked=False, func_stack=())
        for handle, lineno in sorted(self._started.items(),
                                     key=lambda kv: kv[1]):
            if handle in self._joined:
                continue
            node = ast.Module(body=[], type_ignores=[])
            node.lineno = lineno
            self._flag(
                "LTC102", node,
                f"thread {handle!r} is start()ed but never join()ed in "
                f"this file: the stop path cannot bound its shutdown",
                "join it (with the stop timeout) wherever the owner "
                "stops, or suppress with a documented '# lint: ok' if "
                "its lifetime is provably process-long")
        return self.findings

    def _walk(self, node: ast.AST, locked: bool,
              func_stack: tuple) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def's body runs at call time — outside the lock
            inner = func_stack + (node.name,)
            for child in node.body:
                self._walk(child, locked=False, func_stack=inner)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            holds = any(_mentions_lock(item.context_expr)
                        for item in node.items)
            for item in node.items:
                self._visit_expr(item.context_expr, locked, func_stack)
            for child in node.body:
                self._walk(child, locked or holds, func_stack)
            return
        if isinstance(node, ast.AugAssign):
            self._check_augassign(node, locked, func_stack)
            self._visit_expr(node.value, locked, func_stack)
            return
        if isinstance(node, ast.Assign):
            self._check_thread_assign(node)
        # generic recursion: statements walk statements, expressions are
        # scanned for calls (start/join/settle)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._walk(child, locked, func_stack)
            elif isinstance(child, ast.expr):
                self._visit_expr(child, locked, func_stack)

    def _visit_expr(self, expr: ast.AST, locked: bool,
                    func_stack: tuple) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._check_call(node, func_stack)
            elif isinstance(node, (ast.Lambda,)):
                pass

    # -- LTC101 ------------------------------------------------------------

    def _check_augassign(self, node: ast.AugAssign, locked: bool,
                         func_stack: tuple) -> None:
        if locked or (func_stack and func_stack[-1] in _EXEMPT_FUNCS):
            return
        target = node.target
        # reach through subscripts: self.counts[i] += 1 mutates shared
        # attribute state just like self.count += 1
        while isinstance(target, ast.Subscript):
            target = target.value
        if not isinstance(target, ast.Attribute):
            return                          # plain local: not shared
        name = _dotted(node.target) or _dotted(target) or "<attr>"
        self._flag(
            "LTC101", node,
            f"augmented assignment to shared attribute {name!r} outside "
            f"a 'with <lock>:' block — a read-modify-write race",
            "hold the owning lock around the mutation (or route it "
            "through a locked helper like obs.Counter.inc)")

    # -- LTC102 ------------------------------------------------------------

    def _check_thread_assign(self, node: ast.Assign) -> None:
        if not _is_thread_ctor(node.value):
            return
        for tgt in node.targets:
            name = _dotted(tgt)
            if name:
                self._thread_handles[name] = node.lineno

    def _check_call(self, call: ast.Call, func_stack: tuple) -> None:
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return
        if fn.attr == "start":
            if _is_thread_ctor(fn.value):
                self._flag(
                    "LTC102", call,
                    "anonymous threading.Thread(...).start(): no handle "
                    "survives, so nothing can ever join it",
                    "keep the handle and join it on the stop path")
                return
            name = _dotted(fn.value)
            if name and name in self._thread_handles:
                self._started.setdefault(name, call.lineno)
        elif fn.attr == "join":
            name = _dotted(fn.value)
            if name:
                self._joined.add(name)
        elif fn.attr in ("set_result", "set_exception"):
            if "_settle" in func_stack:
                return
            self._flag(
                "LTC103", call,
                f"future.{fn.attr}() outside the idempotent _settle "
                f"helper: if the other settler (completer / timed-out "
                f"stop / shed) wins the race this raises "
                f"InvalidStateError on a runtime thread",
                "settle via _settle(future, ...) and count metrics only "
                "when it returns True")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> List[Diagnostic]:
    """Lint one file's source text."""
    return _FileLint(path, source).run()


def lint_paths(paths: Sequence) -> List[Diagnostic]:
    """Lint every ``.py`` file under ``paths`` (files or directories)."""
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    findings: List[Diagnostic] = []
    for f in files:
        findings.extend(lint_source(f.read_text(), str(f)))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Concurrency lint: unlocked shared mutation, "
                    "unjoined threads, futures settled outside _settle.")
    ap.add_argument("paths", nargs="+", help=".py files or directories")
    args = ap.parse_args(argv)
    findings = lint_paths(args.paths)
    for d in findings:
        print(d)
    errs = errors(findings)
    n_files = sum(1 for p in args.paths)
    if errs:
        print(f"lint: FAIL — {len(errs)} error(s)", file=sys.stderr)
        return 1
    print(f"lint: OK ({n_files} path(s) clean)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
