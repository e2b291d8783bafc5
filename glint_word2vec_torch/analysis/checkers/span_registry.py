"""span-registry: every request-path phase span literal must name an
entry in the ``REQUEST_SPANS`` registry of the port's ``obs/events.py``,
and every registered span must have at least one live call site
(counterpart of ``glint_word2vec_tpu/analysis/checkers/span_registry.py``).

The balancer, the replica request threads and the coalescer leader tag
their phases with the same names, and ``trace-merge`` and the per-span
latency rollups key on them: a typo'd name at one hop would drop that
phase silently. Call sites are ``tr.phase(...)``, ``tr.add_phase(...)``
and ``obs_events.phase_span(...)``.
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

EVENTS_REL = "glint_word2vec_torch/obs/events.py"

RULE = "span-registry"


def declared_spans(cache: ModuleCache) -> Optional[Dict[str, int]]:
    """Extract the REQUEST_SPANS registry statically: name ->
    declaration line. Supports the dict (name -> docstring) form;
    returns None when the registry cannot be found or is not statically
    evaluable."""
    mod = cache.module(EVENTS_REL)
    if mod is None or mod.tree is None:
        return None
    for node in mod.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if not any(isinstance(t, ast.Name) and t.id == "REQUEST_SPANS"
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
    return None


def _is_phase_call(name: str) -> bool:
    """True for ``<trace>.phase(...)``, ``<trace>.add_phase(...)`` and
    ``[obs_events.]phase_span(...)`` call shapes."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf in ("phase", "add_phase", "phase_span")


@checker(RULE,
         "request-path span literals and the obs/events.py "
         "REQUEST_SPANS registry must match exactly, in both directions")
def check_span_registry(cache: ModuleCache) -> List[Finding]:
    findings: List[Finding] = []
    spans = declared_spans(cache)
    events_mod = cache.module(EVENTS_REL)
    if spans is None:
        if events_mod is not None:
            findings.append(events_mod.finding(
                RULE, 1,
                "REQUEST_SPANS registry missing or not statically "
                "evaluable in obs/events.py",
                hint="declare REQUEST_SPANS = {\"req.x\": \"docstring\", "
                     "...} with literal keys",
            ))
        return findings

    used: Dict[str, int] = {}  # name -> count of call sites
    for mod in cache.modules():
        # events.py itself defines phase()/add_phase()/phase_span() and
        # documents the registry — its own bodies are not call sites.
        if mod.tree is None or mod.rel == EVENTS_REL:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None or not _is_phase_call(name):
                continue
            if not node.args:
                continue
            span = const_str(node.args[0])
            if span is None:
                findings.append(mod.finding(
                    RULE, node,
                    "phase span name must be a string literal so the "
                    "registry membership is statically checkable",
                    hint="pass the REQUEST_SPANS key directly, not "
                         "through a variable",
                ))
                continue
            used[span] = used.get(span, 0) + 1
            if span not in spans:
                findings.append(mod.finding(
                    RULE, node,
                    f"phase span {span!r} is not a REQUEST_SPANS "
                    f"registry entry",
                    hint="add it to obs/events.py REQUEST_SPANS (with a "
                         "docstring) or fix the typo; valid: "
                         + ", ".join(sorted(spans)),
                ))
    # The registered-but-never-recorded direction is only meaningful
    # over the full target set: a partial run (explicit CLI paths)
    # cannot see the other files' call sites.
    full_run = set(default_targets(cache.root)) <= set(cache.targets)
    if not full_run:
        return findings
    for span, line in sorted(spans.items()):
        if span not in used and events_mod is not None:
            findings.append(events_mod.finding(
                RULE, line,
                f"registered span {span!r} has no phase call site in "
                f"the analysis target set",
                hint="record the phase somewhere on the request path, "
                     "or drop it from REQUEST_SPANS (and the README "
                     "span table)",
            ))
    return findings
