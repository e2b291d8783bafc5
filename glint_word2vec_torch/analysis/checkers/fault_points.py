"""fault-point: every ``faults.fire("name")`` literal must name a point
declared in the ``POINTS`` registry of the port's ``utils/faults.py``,
and every declared point must have at least one live call site
(counterpart of ``glint_word2vec_tpu/analysis/checkers/fault_points.py``).

The registry (name -> docstring) is the single source of truth: ``arm()``
validates specs against it at run time, and this checker closes the
static side, so a typo'd name cannot arm a fault that never fires and a
point the port stops firing cannot linger in the registry (the port once
lost three of the JAX package's points that way).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from glint_word2vec_torch.analysis.core import (
    Finding,
    ModuleCache,
    checker,
    default_targets,
)
from glint_word2vec_torch.analysis.checkers.common import call_name, const_str

FAULTS_REL = "glint_word2vec_torch/utils/faults.py"

RULE = "fault-point"


def declared_points(cache: ModuleCache) -> Optional[Dict[str, int]]:
    """Extract the POINTS registry statically: name -> declaration line.
    Supports the dict (name -> docstring) form; returns None when the
    registry cannot be found or is not statically evaluable."""
    mod = cache.module(FAULTS_REL)
    if mod is None or mod.tree is None:
        return None
    for node in mod.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if not any(isinstance(t, ast.Name) and t.id == "POINTS"
                   for t in targets):
            continue
        value = node.value
        if isinstance(value, ast.Dict):
            out = {}
            for k in value.keys:
                s = const_str(k)
                if s is None:
                    return None
                out[s] = k.lineno
            return out
        if isinstance(value, (ast.Tuple, ast.List)):
            out = {}
            for e in value.elts:
                s = const_str(e)
                if s is None:
                    return None
                out[s] = e.lineno
            return out
    return None


@checker(RULE,
         "faults.fire(...) literals and the utils/faults.py POINTS "
         "registry must match exactly, in both directions")
def check_fault_points(cache: ModuleCache) -> List[Finding]:
    findings: List[Finding] = []
    points = declared_points(cache)
    faults_mod = cache.module(FAULTS_REL)
    if points is None:
        if faults_mod is not None:
            findings.append(faults_mod.finding(
                RULE, 1,
                "POINTS registry missing or not statically evaluable "
                "in utils/faults.py",
                hint="declare POINTS = {\"name\": \"docstring\", ...} "
                     "with literal keys",
            ))
        return findings

    fired: Dict[str, int] = {}  # name -> count of call sites
    for mod in cache.modules():
        if mod.tree is None or mod.rel == FAULTS_REL:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None or not (name == "faults.fire"
                                    or name.endswith(".faults.fire")):
                continue
            if not node.args:
                continue
            point = const_str(node.args[0])
            if point is None:
                findings.append(mod.finding(
                    RULE, node,
                    "faults.fire() argument must be a string literal so "
                    "the point name is statically checkable",
                    hint="pass the point name directly, not through a "
                         "variable",
                ))
                continue
            fired[point] = fired.get(point, 0) + 1
            if point not in points:
                findings.append(mod.finding(
                    RULE, node,
                    f"faults.fire({point!r}) names an undeclared "
                    f"injection point",
                    hint="declare it in utils/faults.py POINTS (with a "
                         "docstring) or fix the typo; valid: "
                         + ", ".join(sorted(points)),
                ))
    # The declared-but-never-fired direction is only meaningful over the
    # full target set: a partial run (explicit CLI paths) cannot see the
    # other files' call sites.
    full_run = set(default_targets(cache.root)) <= set(cache.targets)
    if not full_run:
        return findings
    for point, line in sorted(points.items()):
        if point not in fired and faults_mod is not None:
            findings.append(faults_mod.finding(
                RULE, line,
                f"declared injection point {point!r} has no "
                f"faults.fire() call site in the analysis target set",
                hint="wire the point in, or drop it from POINTS (and "
                     "the README table)",
            ))
    return findings
