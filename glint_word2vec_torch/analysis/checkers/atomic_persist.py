"""atomic-persist: every persisted artifact goes through an atomic
write, the port's ``utils.atomic_write_*`` or a temp path + ``os.replace``
commit (counterpart of
``glint_word2vec_tpu/analysis/checkers/atomic_persist.py``).

Every run and checkpoint artifact is crash-safe: a SIGKILL mid-write
leaves the previous complete file, never a torn one. A bare
``open(path, "w") + json.dump`` on a persistence path reintroduces torn
files. The rule flags write-mode ``open()``, ``np.save``/``np.savez``/
``np.savetxt``, ``torch.save``, ``pickle.dump`` and
``Path.write_text/_bytes``, UNLESS the enclosing function itself calls
``os.replace``/``os.rename`` (it implements the commit protocol: the
``utils`` helpers, the engine's snapshot writer, the kernel builder's
library commit, the publisher's generation rename, the transform's shard
commit) or appends (``"a"`` modes: JSONL event sinks are append-only by
design).

Sites that are fine non-atomic (process-private temp files, debug dumps)
carry an inline ``# graftlint: ignore[atomic-persist] <why>``.

Granularity: the bless is function-level. A function that calls
``os.replace`` owns all its raw writes (they are taken to be the temp
side of its commit), so a bare write added to an existing committing
function is invisible to this rule; new code paths start without a
commit protocol and are flagged until they grow one.
"""

from __future__ import annotations

import ast
from typing import List, Set

from glint_word2vec_torch.analysis.core import Finding, ModuleCache, checker
from glint_word2vec_torch.analysis.checkers.common import (
    call_name,
    const_str,
    enclosing_map,
    walk_functions,
)

RULE = "atomic-persist"

#: Dotted call names that persist bytes to a path-like destination.
_PERSIST_CALLS = {
    "np.save", "numpy.save", "np.savez", "numpy.savez",
    "np.savez_compressed", "numpy.savez_compressed",
    "np.savetxt", "numpy.savetxt",
    "pickle.dump",
    "torch.save",
}

def _open_write_mode(node: ast.Call) -> bool:
    """True for ``open(path, "w"/"wb"/"x"...)`` — not append, not
    read."""
    if call_name(node) != "open":
        return False
    mode = None
    if len(node.args) >= 2:
        mode = const_str(node.args[1])
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = const_str(kw.value)
    if mode is None:
        return False
    return mode.startswith(("w", "x"))


def _commits_atomically(fn: ast.AST) -> bool:
    """Does this function itself perform the atomic commit (os.replace /
    os.rename)? If so, its raw writes ARE the protocol's temp side, not
    a violation (see the module docstring's granularity note)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            # Match through import aliases (`import os as _os`) without
            # catching str.replace(): the receiver must be the os
            # module under its conventional names.
            root, _, tail = name.rpartition(".")
            if root in ("os", "_os", "os.path") and \
                    tail in ("replace", "rename", "renames"):
                return True
    return False


@checker(RULE,
         "persisted artifacts must go through utils.atomic_write_* or a "
         "temp-dir + os.replace commit (append-only sinks exempt)")
def check_atomic_persist(cache: ModuleCache) -> List[Finding]:
    findings: List[Finding] = []
    for mod in cache.modules():
        if mod.tree is None:
            continue
        # Functions that implement the commit protocol themselves.
        atomic_fns: Set[str] = {
            qn for qn, fn in walk_functions(mod.tree)
            if _commits_atomically(fn)
        }
        # A nested function inherits its parent's blessing: the engine
        # snapshot writer builds per-file closures inside the committing
        # function.
        enclosing = enclosing_map(mod.tree)

        def blessed(node: ast.AST) -> bool:
            qn = enclosing.get(id(node), "")
            while True:
                if qn in atomic_fns:
                    return True
                if "." not in qn:
                    return False
                qn = qn.rsplit(".", 1)[0]

        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            if _open_write_mode(node):
                if blessed(node):
                    continue
                findings.append(mod.finding(
                    RULE, node,
                    "bare write-mode open() outside an atomic commit "
                    "protocol",
                    hint="route through utils.atomic_write_json/"
                         "_text/_npy, or write into a temp path and "
                         "os.replace() it in this function",
                ))
            elif name in _PERSIST_CALLS:
                # np.save(f, arr) into an open handle is governed by the
                # open() that produced the handle; only flag path-like
                # first arguments (string constants, joins, f-strings,
                # names — everything except an obvious handle is
                # indistinguishable statically, so flag unless blessed).
                if blessed(node):
                    continue
                findings.append(mod.finding(
                    RULE, node,
                    f"{name}() persists outside an atomic commit "
                    f"protocol",
                    hint="use utils.atomic_write_npy / atomic_write_json "
                         "or confine to a temp dir committed by one "
                         "os.replace()",
                ))
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("write_text", "write_bytes"):
                if blessed(node):
                    continue
                findings.append(mod.finding(
                    RULE, node,
                    f"Path.{node.func.attr}() persists outside an "
                    f"atomic commit protocol",
                    hint="use utils.atomic_write_text or temp + "
                         "os.replace()",
                ))
    return findings
