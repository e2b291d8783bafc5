"""table-tick: no mutation of an engine table outside a method that
ticks ``table_version`` (counterpart of
``glint_word2vec_tpu/analysis/checkers/table_mutation.py``, retargeted to
torch).

The serving result cache, the norms cache, the ANN index and every other
``table_version`` reader assume that every mutation of ``syn0``/``syn1``
goes through ``EmbeddingEngine._tick_tables``. JAX mutates a table only by
rebinding ``self.syn0``/``self.syn1``. The port also writes tables in
place and keeps them as model shards (``self._shards[i][m]``), so inside
any class that defines ``_tick_tables`` this rule flags, in each method
that does not call ``self._tick_tables(...)``:

- an assignment to ``self.syn0``, ``self.syn1``, ``self._shards`` or
  ``self._shards[...]``;
- a subscript assignment into a table expression (``t[ids] = rows``,
  ``t[ids] += upd``);
- a call of an in-place tensor method, a name ending in ``_`` such as
  ``index_add_``, ``copy_`` or ``zero_``, on a table expression;
- a call of one of the port's in-place kernel wrappers (the scatters of
  ``ops/rows.py`` and ``ops/fused_sgns.py``, which write their ``table``
  argument, and the engine's helpers over them) with a table expression
  as an argument.

A table expression is one rooted in ``self.syn0``, ``self.syn1``,
``self._shards``, ``self.logical_table(...)`` or ``self.shard_tables(...)``
through attributes and subscripts, or a local name bound to one (``s0,
s1 = self.syn0, self.syn1``; ``for t in self._shards[0]``). ``__init__``
and the tick helper are exempt: construction precedes any reader. A
method that runs only under a caller that ticks is baselined with a note
that names that caller.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from glint_word2vec_torch.analysis.core import Finding, ModuleCache, checker
from glint_word2vec_torch.analysis.checkers.common import call_name

RULE = "table-tick"

#: The device-resident table buffers the serving caches key on.
TABLE_ATTRS = ("syn0", "syn1", "_shards")

#: Engine methods that hand out the live table tensors.
TABLE_GETTERS = ("logical_table", "shard_tables")

#: Methods allowed to mutate tables without ticking: construction runs
#: before any reader exists, and the tick helper is the seam itself.
EXEMPT_METHODS = ("__init__", "_tick_tables")

#: The port's kernel wrappers (and their plain versions) that write the
#: ``table`` arguments they are given, and the engine's helpers over them.
INPLACE_WRAPPERS = frozenset({
    "_scatter_rows", "_apply_rank1_updates",
    "scatter_add_rows", "scatter_add_rows_sorted",
    "scatter_add_rows_reference",
    "scatter_add_rank1", "scatter_add_rank1_sorted",
    "scatter_add_rank1_reference",
    "scatter_add_rows_f32", "scatter_add_rows_f32_sorted",
    "scatter_add_rows_f32_reference",
    "scatter_add_rank1_hbm", "scatter_add_rank1_hbm_sorted",
    "scatter_add_rank1_hbm_reference",
    "fused_pair_step", "fused_pair_step_shared",
})


def _table_root(node: ast.AST, aliases: Set[str]) -> Optional[str]:
    """The table an expression is rooted in (``self.syn0``,
    ``self._shards``, a getter call, or an alias name), through
    attribute, subscript and starred links; None otherwise."""
    while True:
        if isinstance(node, (ast.Subscript, ast.Starred)):
            node = node.value
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr if node.attr in TABLE_ATTRS else None
            node = node.value
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr in TABLE_GETTERS
                    and isinstance(f.value, ast.Name) and f.value.id == "self"):
                return f.attr
            return None
        elif isinstance(node, ast.Name):
            return node.id if node.id in aliases else None
        else:
            return None


#: Builtins whose iteration yields (parts of) the items of their
#: arguments.
_ITER_WRAPPERS = ("enumerate", "zip", "reversed", "list", "tuple", "sorted")


def _bound_names(target: ast.AST) -> List[ast.Name]:
    if isinstance(target, ast.Name):
        return [target]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _bound_names(e)]
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    return []


def _aliases(method: ast.AST) -> Set[str]:
    """Local names bound to a table expression in ``method`` (to a
    fixpoint, so an alias of an alias counts)."""
    aliases: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(method):
            pairs = []
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, (ast.Tuple, ast.List))
                            and isinstance(node.value, (ast.Tuple, ast.List))
                            and len(t.elts) == len(node.value.elts)):
                        pairs.extend(zip(t.elts, node.value.elts))
                    else:
                        pairs.append((t, node.value))
            elif isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                        and it.func.id in _ITER_WRAPPERS):
                    # for k, t in enumerate(self._shards[0]): every name
                    # the loop binds may be a table.
                    for a in it.args:
                        pairs.append((node.target, a))
                else:
                    pairs.append((node.target, it))
            elif isinstance(node, ast.withitem) and node.optional_vars:
                pairs.append((node.optional_vars, node.context_expr))
            for target, value in pairs:
                if _table_root(value, aliases) is None:
                    continue
                for name in _bound_names(target):
                    if name.id not in aliases:
                        aliases.add(name.id)
                        changed = True
    return aliases


def _table_name_vars(method: ast.AST) -> Set[str]:
    """Loop variables that run over a literal collection naming a table
    attribute (``for i, name in enumerate(("syn0", "syn1"))``): a
    ``setattr(self, name, ...)`` with one of them rebinds a table."""
    out: Set[str] = set()
    for node in ast.walk(method):
        if not isinstance(node, (ast.For, ast.comprehension)):
            continue
        consts = {c.value for c in ast.walk(node.iter)
                  if isinstance(c, ast.Constant) and isinstance(c.value, str)}
        if consts & set(TABLE_ATTRS):
            out.update(n.id for n in _bound_names(node.target))
    return out


def _params(method: ast.AST) -> List[str]:
    a = method.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def _mutations(method: ast.AST, seed: Set[str] = frozenset(),
               writers: Optional[dict] = None):
    """Yield ``(node, description, root)`` for every table mutation in
    ``method``; ``seed`` names count as tables too (a helper's
    parameters, to learn which of them it writes), and ``writers`` maps
    each method of the class to the parameters it writes in place."""
    aliases = _aliases(method) | set(seed)
    table_vars = _table_name_vars(method)
    for node in ast.walk(method):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            stack = list(targets)
            while stack:
                t = stack.pop()
                if isinstance(t, (ast.Tuple, ast.List)):
                    stack.extend(t.elts)
                elif isinstance(t, ast.Starred):
                    stack.append(t.value)
                elif (isinstance(t, ast.Attribute)
                      and isinstance(t.value, ast.Name)
                      and t.value.id == "self" and t.attr in TABLE_ATTRS):
                    yield node, f"assigns self.{t.attr}", t.attr
                elif isinstance(t, ast.Subscript):
                    root = _table_root(t.value, aliases)
                    if root is not None:
                        yield node, f"assigns into {_describe(root)}", root
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr.endswith("_")
                    and not f.attr.startswith("_")):
                root = _table_root(f.value, aliases)
                if root is not None:
                    yield node, (f"calls the in-place .{f.attr}() on "
                                 f"{_describe(root)}"), root
                    continue
            name = call_name(node) or ""
            if (name == "setattr" and len(node.args) == 3
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == "self"):
                attr = node.args[1]
                if ((isinstance(attr, ast.Constant) and attr.value in TABLE_ATTRS)
                        or (isinstance(attr, ast.Name)
                            and attr.id in table_vars)):
                    yield node, "rebinds a table through setattr(self, ...)", \
                        "setattr"
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf in INPLACE_WRAPPERS:
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    root = _table_root(arg, aliases)
                    if root is not None:
                        yield node, (f"passes {_describe(root)} to the "
                                     f"in-place {leaf}()"), root
                        break
            elif writers and name.startswith("self.") and leaf in writers:
                params, written = writers[leaf]
                bound = dict(zip(params, node.args))
                bound.update((k.arg, k.value) for k in node.keywords if k.arg)
                for p in sorted(written):
                    root = (_table_root(bound[p], aliases)
                            if p in bound else None)
                    if root is not None:
                        yield node, (f"passes {_describe(root)} to "
                                     f"self.{leaf}(), which writes its "
                                     f"{p!r} in place"), root
                        break


def _describe(root: str) -> str:
    if root in TABLE_ATTRS:
        return f"table self.{root}"
    if root in TABLE_GETTERS:
        return f"table self.{root}(...)"
    return f"table alias {root!r}"


@checker(RULE,
         "mutations of engine tables (syn0/syn1 and model shards; "
         "assignment, in place, or through a scatter wrapper) must live "
         "in methods that call self._tick_tables(...)")
def check_table_mutation(cache: ModuleCache) -> List[Finding]:
    findings: List[Finding] = []
    for mod in cache.modules():
        if mod.tree is None:
            continue
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            if not any(m.name == "_tick_tables" for m in methods):
                continue
            # The methods that write a parameter in place, and which.
            writers = {}
            for m in methods:
                params = _params(m)[1:]  # without self
                written = {root for _, _, root in _mutations(m, set(params))
                           if root in params}
                if written:
                    writers[m.name] = (params, written)
            for m in methods:
                if m.name in EXEMPT_METHODS:
                    continue
                ticks = any(
                    isinstance(n, ast.Call)
                    and call_name(n) == "self._tick_tables"
                    for n in ast.walk(m)
                )
                if ticks:
                    continue
                seen: Set[int] = set()
                for node, what, _ in _mutations(m, writers=writers):
                    if node.lineno in seen:
                        continue
                    seen.add(node.lineno)
                    findings.append(mod.finding(
                        RULE, node,
                        f"{cls.name}.{m.name} {what} without calling "
                        f"self._tick_tables(...)",
                        hint="tick the version (invalidates norms, the "
                             "serving caches and the ANN index) or route "
                             "the mutation through a ticking method",
                    ))
    return findings
