"""prom-consistency: the Prometheus renderers must stay statically
consistent with each other and with the snapshot builders feeding them
(counterpart of ``glint_word2vec_tpu/analysis/checkers/prometheus.py``).

The port's ``obs/prometheus.py`` renders four expositions (training,
gang, serving, fleet) from the JSON snapshots the HTTP layers serve. The
drift modes: a renderer referencing a snapshot key the builder stopped
producing (it renders NaN or 0 forever), a metric emitted under two
different TYPEs by two renderers (the gang endpoint concatenates
expositions, so a collision corrupts the scrape), and a name violating
the text-format rules, caught only at run time by
``lint_prometheus_text``. This checker closes them at lint time:

- every ``p.head``/``p.sample`` metric name must be a string literal
  (statically checkable), match the name charset, carry the ``glint_``
  prefix, and counters (and only counters) end ``_total``;
- every sample needs a prior head in the same renderer (modulo the
  ``_sum``/``_count``/``_bucket`` suffixes of summary/histogram
  families), and no duplicate heads;
- a name used by two renderers must have the identical (type, help):
  families are disjoint-or-identical, so concatenated scrapes lint;
- every snapshot key a renderer maps (``snap.get("k")``, ``x["k"]``,
  and the key element of the (name, key, help) mapping tuples) must be
  produced by the snapshot builders for that renderer (dict-literal
  keys, ``d["k"] = ...`` stores, or ``dict(k=...)`` keywords in the
  producer modules);
- the blocks only the port's documents carry (``PORT_ONLY_KEYS``: the
  server's ``kernel_launches`` and ``kernel_launches_warmup``, the
  rollout's ``step_seconds``; README's divergence list) must still be
  built by a producer module of the document that carries them. They are
  JSON only: no renderer maps them to a family.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from glint_word2vec_torch.analysis.core import Finding, ModuleCache, checker
from glint_word2vec_torch.analysis.checkers.common import const_str

RULE = "prom-consistency"

RENDERER_REL = "glint_word2vec_torch/obs/prometheus.py"

#: renderer function -> the modules that build the snapshot it maps.
PRODUCERS: Dict[str, Tuple[str, ...]] = {
    "training_to_prometheus": (
        "glint_word2vec_torch/obs/heartbeat.py",
        "glint_word2vec_torch/utils/metrics.py",
        "glint_word2vec_torch/obs/events.py",
        "glint_word2vec_torch/obs/canary.py",
        "glint_word2vec_torch/parallel/engine.py",
        "glint_word2vec_torch/obs/slo.py",
    ),
    "serving_to_prometheus": (
        "glint_word2vec_torch/utils/metrics.py",
        "glint_word2vec_torch/serving.py",
        "glint_word2vec_torch/parallel/engine.py",
        "glint_word2vec_torch/obs/slo.py",
    ),
    "gang_to_prometheus": (
        "glint_word2vec_torch/obs/aggregate.py",
        "glint_word2vec_torch/obs/heartbeat.py",
        "glint_word2vec_torch/utils/metrics.py",
        "glint_word2vec_torch/obs/slo.py",
    ),
    "fleet_to_prometheus": (
        "glint_word2vec_torch/fleet.py",
        "glint_word2vec_torch/obs/aggregate.py",
        "glint_word2vec_torch/utils/metrics.py",
    ),
}

#: Snapshot keys only the port's documents carry -> the renderer whose
#: document carries them.
PORT_ONLY_KEYS: Dict[str, str] = {
    "kernel_launches": "serving_to_prometheus",
    "kernel_launches_warmup": "serving_to_prometheus",
    "step_seconds": "fleet_to_prometheus",
}

_NAME_RE = re.compile(r"^[a-z_:][a-z0-9_:]*$")
_KEY_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")
_SUFFIXES = ("_bucket", "_sum", "_count")


def _producer_keys(cache: ModuleCache, rels: Tuple[str, ...]) -> Set[str]:
    """Every key the builder modules can put in a snapshot dict:
    dict-display keys, constant subscript stores, dict(k=...) kwargs."""
    keys: Set[str] = set()
    for rel in rels:
        mod = cache.module(rel)
        if mod is None or mod.tree is None:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    s = const_str(k) if k is not None else None
                    if s is not None:
                        keys.add(s)
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        s = const_str(t.slice)
                        if s is not None:
                            keys.add(s)
                # Key tables: a literal tuple/list of (out_key, src)
                # tuples later expanded by a comprehension
                # (`{out: 0 for out, _ in _SUM_COUNTERS}`) — collect
                # the first string of each inner tuple.
                value = getattr(node, "value", None)
                if isinstance(value, (ast.Tuple, ast.List)):
                    for e in value.elts:
                        if isinstance(e, (ast.Tuple, ast.List)) and e.elts:
                            s = const_str(e.elts[0])
                            if s is not None:
                                keys.add(s)
            elif isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Name) and fn.id == "dict":
                    keys.update(kw.arg for kw in node.keywords if kw.arg)
                elif isinstance(fn, ast.Attribute) and \
                        fn.attr in ("setdefault", "update"):
                    keys.update(kw.arg for kw in node.keywords if kw.arg)
                    if node.args:
                        s = const_str(node.args[0])
                        if s is not None and fn.attr == "setdefault":
                            keys.add(s)
    return keys


def _loop_envs(fn: ast.AST) -> Dict[int, Dict[str, Optional[Set[str]]]]:
    """Statically resolve loop variables bound over literal tuple
    lists — the renderers' ``for name, key, help_ in gauges:`` mapping
    idiom. Returns id(node) -> {var: possible constant values} with
    proper loop scoping (two loops reusing ``name`` don't bleed into
    each other); a value of None marks a loop-bound-but-unresolvable
    variable."""
    lists: Dict[str, list] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, (ast.List, ast.Tuple)):
            lists[node.targets[0].id] = node.value.elts

    envs: Dict[int, Dict[str, Optional[Set[str]]]] = {}

    def loop_bindings(node: ast.For) -> Dict[str, Optional[Set[str]]]:
        it = node.iter
        elems = None
        if isinstance(it, (ast.List, ast.Tuple)):
            elems = it.elts
        elif isinstance(it, ast.Name) and it.id in lists:
            elems = lists[it.id]
        targets = (node.target.elts
                   if isinstance(node.target, ast.Tuple)
                   else [node.target])
        bound: Dict[str, Optional[Set[str]]] = {}
        for i, t in enumerate(targets):
            if not isinstance(t, ast.Name):
                continue
            if elems is None:
                bound[t.id] = None
                continue
            vals: Set[str] = set()
            ok = True
            for e in elems:
                ee = (e.elts if isinstance(e, (ast.Tuple, ast.List))
                      else ([e] if len(targets) == 1 else None))
                if ee is None or i >= len(ee):
                    ok = False
                    break
                c = ee[i]
                if isinstance(c, ast.Constant):
                    if c.value is not None:
                        vals.add(c.value)
                else:
                    ok = False
                    break
            bound[t.id] = vals if ok else None
        return bound

    def rec(node: ast.AST, env: Dict[str, Optional[Set[str]]]) -> None:
        envs[id(node)] = env
        if isinstance(node, ast.For):
            inner = dict(env)
            inner.update(loop_bindings(node))
            for child in node.body:
                rec(child, inner)
            for child in node.orelse:
                rec(child, env)
            rec(node.iter, env)
            return
        for child in ast.iter_child_nodes(node):
            rec(child, env)

    rec(fn, {})
    return envs


def _renderer_calls(fn: ast.AST):
    """Yield (kind, call) for p.head / p.sample calls."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("head", "sample") and \
                isinstance(node.func.value, ast.Name):
            yield node.func.attr, node


def _mapped_keys(fn: ast.AST) -> List[Tuple[str, int]]:
    """Snapshot keys the renderer maps: .get("k") args, constant
    subscript reads, and the key element of (metric, key, help)
    mapping tuples."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and node.args:
            s = const_str(node.args[0])
            if s is not None and _KEY_RE.match(s):
                out.append((s, node.lineno))
        elif isinstance(node, ast.Subscript):
            s = const_str(node.slice)
            if s is not None and _KEY_RE.match(s):
                out.append((s, node.lineno))
        elif isinstance(node, ast.Tuple) and len(node.elts) >= 2:
            first = const_str(node.elts[0])
            second = const_str(node.elts[1])
            if first is not None and first.startswith("glint_") and \
                    second is not None and _KEY_RE.match(second):
                out.append((second, node.lineno))
            # ("0.5", "p50_ms")-style quantile->key pairs: the second
            # element is a snapshot key, the first fails _KEY_RE.
            elif first is not None and not _KEY_RE.match(first) and \
                    second is not None and _KEY_RE.match(second) and \
                    len(node.elts) == 2:
                out.append((second, node.lineno))
    return out


@checker(RULE,
         "Prometheus renderers: literal lint-clean metric names, "
         "disjoint-or-identical families across renderers, and every "
         "mapped snapshot key produced by the snapshot builders")
def check_prometheus(cache: ModuleCache) -> List[Finding]:
    findings: List[Finding] = []
    if RENDERER_REL not in cache.targets:
        # Partial run that does not cover the renderer module: nothing
        # to check (its producers are loaded on demand either way).
        return findings
    mod = cache.module(RENDERER_REL)
    if mod is None or mod.tree is None:
        return findings
    # name -> (renderer, type, help-or-None) for cross-renderer family
    # checks; help is None when the head's help arg is not a literal
    # (loop-carried), in which case only the type is compared.
    families: Dict[str, Tuple[str, str, Optional[str]]] = {}
    for key, renderer in sorted(PORT_ONLY_KEYS.items()):
        produced = _producer_keys(cache, PRODUCERS[renderer])
        if produced and key not in produced:
            findings.append(mod.finding(
                RULE, 1,
                f"port-only snapshot block {key!r} of {renderer}'s document "
                f"is built by no producer module "
                f"({', '.join(PRODUCERS[renderer])})",
                hint="restore the block, or drop it from PORT_ONLY_KEYS "
                     "and README's divergence list",
            ))
    for fn in mod.tree.body:
        if not isinstance(fn, ast.FunctionDef) or \
                not fn.name.endswith("_to_prometheus"):
            continue
        envs = _loop_envs(fn)
        heads: Dict[str, str] = {}

        def resolve(arg: ast.AST, call: ast.Call) -> Optional[Set[str]]:
            s = const_str(arg)
            if s is not None:
                return {s}
            if isinstance(arg, ast.Name):
                return envs.get(id(call), {}).get(arg.id)
            return None

        for kind, call in _renderer_calls(fn):
            if not call.args:
                continue
            names = resolve(call.args[0], call)
            if not names:
                findings.append(mod.finding(
                    RULE, call,
                    f"p.{kind}() metric name is not statically "
                    f"resolvable — graftlint cannot check it",
                    hint="use a literal, or loop over a literal list "
                         "of (name, ...) tuples",
                ))
                continue
            bad = [n for n in names
                   if not isinstance(n, str) or not _NAME_RE.match(n)
                   or not n.startswith("glint_")]
            if bad:
                findings.append(mod.finding(
                    RULE, call,
                    f"metric name {bad[0]!r} violates the naming rules "
                    f"(charset [a-z0-9_:], glint_ prefix)",
                ))
                continue
            if kind == "head":
                mtype = const_str(call.args[1]) if len(call.args) > 1 \
                    else None
                help_ = const_str(call.args[2]) if len(call.args) > 2 \
                    else None
                if mtype not in _TYPES:
                    findings.append(mod.finding(
                        RULE, call,
                        f"metric {sorted(names)[0]} declares invalid "
                        f"type {mtype!r}",
                    ))
                    continue
                for name in sorted(names):
                    if name in heads:
                        findings.append(mod.finding(
                            RULE, call,
                            f"duplicate head for metric {name} in "
                            f"{fn.name}",
                        ))
                    heads[name] = mtype
                    if mtype == "counter" and not name.endswith("_total"):
                        findings.append(mod.finding(
                            RULE, call,
                            f"counter {name} must end in _total",
                        ))
                    if mtype != "counter" and name.endswith("_total"):
                        findings.append(mod.finding(
                            RULE, call,
                            f"non-counter {name} must not end in _total",
                        ))
                    prior = families.get(name)
                    help_drift = (prior is not None
                                  and prior[2] is not None
                                  and help_ is not None
                                  and prior[2] != help_)
                    if prior is not None and (prior[1] != mtype
                                              or help_drift):
                        what = ("type" if prior[1] != mtype
                                else "HELP text")
                        findings.append(mod.finding(
                            RULE, call,
                            f"metric {name} declares a different "
                            f"{what} in {fn.name} than in {prior[0]} "
                            f"— families must be disjoint or identical "
                            f"(concatenated scrapes share one "
                            f"namespace)",
                        ))
                    else:
                        families.setdefault(name, (fn.name, mtype, help_))
            else:  # sample
                for name in sorted(names):
                    base = name
                    for suf in _SUFFIXES:
                        if name.endswith(suf) and \
                                name[: -len(suf)] in heads:
                            base = name[: -len(suf)]
                            break
                    if base not in heads:
                        findings.append(mod.finding(
                            RULE, call,
                            f"sample for {name} has no head "
                            f"(TYPE/HELP) in {fn.name}",
                            hint="p.head() the family before sampling "
                                 "it",
                        ))
                    elif base != name and heads[base] not in (
                            "summary", "histogram"):
                        findings.append(mod.finding(
                            RULE, call,
                            f"{name} uses a {'/'.join(_SUFFIXES)} "
                            f"suffix but {base} is a {heads[base]}",
                        ))
        produced = _producer_keys(cache, PRODUCERS.get(fn.name, ()))
        if not produced:
            continue
        seen: Set[str] = set()
        for key, lineno in _mapped_keys(fn):
            if key in produced or key in seen:
                continue
            seen.add(key)
            findings.append(mod.finding(
                RULE, lineno,
                f"{fn.name} maps snapshot key {key!r} that no producer "
                f"module builds "
                f"({', '.join(PRODUCERS[fn.name])})",
                hint="fix the key, or update the snapshot builder — a "
                     "renderer-only key scrapes as a permanent "
                     "NaN/0",
            ))
    return findings
