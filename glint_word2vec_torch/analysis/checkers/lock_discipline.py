"""lock-discipline: shared mutable attributes are accessed under their
owning lock, or declared atomic on purpose (counterpart of
``glint_word2vec_tpu/analysis/checkers/lock_discipline.py``).

The port's threaded modules (``serving.py``, ``fleet.py``, ``obs/``,
``parallel/supervisor.py``, ``streaming/``, the checkpoint writer) run
writer, producer, heartbeat, prober and supervisor threads against state
the request or fit thread also touches. The convention is one
``threading.Lock`` per class guarding its mutable attributes; a new
access added outside the ``with self._mu:`` block is a data race that
no test reliably catches (CPython makes many of them benign until the
attribute becomes a compound update). This is a *static race heuristic*
via guarded-by inference:

- a class owns locks (attributes assigned ``threading.Lock()`` /
  ``RLock()`` / ``Condition()`` / ``_TrackedLock()``);
- for each plain data attribute, if SOME access runs under a ``with
  self.<lock>:`` block AND the attribute is written outside
  ``__init__``, then EVERY access outside ``__init__`` must either hold
  the lock or the attribute must be listed in the class-level
  ``_ATOMIC_ATTRS`` allowlist (a set of attribute names whose
  lock-free access is deliberate: monotonic counters read for
  telemetry, thread handles touched only by the owning thread, ...).

``__init__`` is exempt (construction precedes thread start), a method
named ``*_locked`` is treated as running with the lock held (the
guarded-by-caller naming convention this rule also canonizes), and a
nested function body does NOT inherit an enclosing ``with`` (the thread
target defined inside ``start()`` runs after the lock is released).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from glint_word2vec_torch.analysis.core import Finding, ModuleCache, checker
from glint_word2vec_torch.analysis.checkers.common import (
    call_name,
    is_self_attr,
    literal_str_collection,
)

RULE = "lock-discipline"

_LOCK_CTORS = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition", "_TrackedLock",
}

#: (attr, method, line, is_store, under_lock)
_Access = Tuple[str, str, int, bool, bool]


def _class_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = call_name(node.value)
            if name in _LOCK_CTORS:
                for t in node.targets:
                    if is_self_attr(t):
                        locks.add(t.attr)
    return locks


def _atomic_attrs(cls: ast.ClassDef) -> Set[str]:
    for node in cls.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if any(isinstance(t, ast.Name) and t.id == "_ATOMIC_ATTRS"
               for t in targets):
            vals = literal_str_collection(node.value)
            if vals is not None:
                return set(vals)
    return set()


def _data_attrs(cls: ast.ClassDef, locks: Set[str],
                methods: Set[str]) -> Set[str]:
    """Attributes ever assigned on self, minus locks and methods."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            stack = list(targets)
            while stack:
                t = stack.pop()
                if isinstance(t, (ast.Tuple, ast.List)):
                    stack.extend(t.elts)
                elif is_self_attr(t):
                    out.add(t.attr)
    return out - locks - methods


def _collect_accesses(method: ast.AST, method_name: str,
                      locks: Set[str]) -> List[_Access]:
    accesses: List[_Access] = []

    def rec(node: ast.AST, under: bool) -> None:
        if isinstance(node, ast.With):
            holds = under or any(
                is_self_attr(item.context_expr) and
                item.context_expr.attr in locks
                for item in node.items
            )
            for item in node.items:
                rec(item.context_expr, under)
            for stmt in node.body:
                rec(stmt, holds)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node is not method:
            # A nested def runs later, on its own thread, without the
            # lexically-enclosing lock.
            for stmt in node.body:
                rec(stmt, False)
            return
        if isinstance(node, ast.Attribute) and is_self_attr(node):
            is_store = isinstance(node.ctx, (ast.Store, ast.Del)) or \
                False
            accesses.append(
                (node.attr, method_name, node.lineno, is_store, under)
            )
        elif isinstance(node, ast.AugAssign) and is_self_attr(node.target):
            accesses.append(
                (node.target.attr, method_name, node.target.lineno,
                 True, under)
            )
        for child in ast.iter_child_nodes(node):
            rec(child, under)
        return

    # The guarded-by-caller convention: a method named *_locked is
    # specified to be called with the lock already held.
    held_on_entry = method_name.endswith("_locked")
    for stmt in ast.iter_child_nodes(method):
        rec(stmt, held_on_entry)
    return accesses


@checker(RULE,
         "attributes guarded by a lock somewhere must be accessed "
         "under it everywhere (or declared in _ATOMIC_ATTRS)")
def check_lock_discipline(cache: ModuleCache) -> List[Finding]:
    findings: List[Finding] = []
    for mod in cache.modules():
        if mod.tree is None:
            continue
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _class_lock_attrs(cls)
            if not locks:
                continue
            methods = [n for n in ast.walk(cls)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            method_names = {m.name for m in methods}
            atomic = _atomic_attrs(cls)
            data = _data_attrs(cls, locks, method_names)
            accesses: List[_Access] = []
            for m in [n for n in cls.body
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))]:
                accesses.extend(_collect_accesses(m, m.name, locks))
            by_attr: Dict[str, List[_Access]] = {}
            for a in accesses:
                if a[0] in data and a[0] not in atomic:
                    by_attr.setdefault(a[0], []).append(a)
            for attr, accs in sorted(by_attr.items()):
                locked_any = any(a[4] for a in accs)
                written_live = any(
                    a[3] and a[1] != "__init__" for a in accs
                )
                if not (locked_any and written_live):
                    continue
                seen_lines: Set[int] = set()
                for _, meth, line, _, under in accs:
                    if under or meth == "__init__" or line in seen_lines:
                        continue
                    seen_lines.add(line)
                    findings.append(mod.finding(
                        RULE, line,
                        f"{cls.name}.{meth} accesses self.{attr} "
                        f"without holding the owning lock "
                        f"({', '.join(sorted('self.' + lk for lk in locks))}) "
                        f"that guards it elsewhere",
                        hint="wrap the access in `with self.<lock>:`, "
                             "or declare the attribute in "
                             f"{cls.name}._ATOMIC_ATTRS with a comment "
                             "saying why lock-free access is safe",
                    ))
    return findings
