"""Shared AST helpers for the port's graftlint checkers (copy of
``glint_word2vec_tpu/analysis/checkers/common.py``)."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple


def dotted_name(node: ast.AST) -> Optional[str]:
    """``np.save`` / ``self._tick_tables`` / ``open`` as a dotted string,
    or None for anything that is not a plain name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of an expression chain: the root of
    ``os.environ.get(...)[0]`` is ``os``."""
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def walk_functions(
    tree: ast.AST,
) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(qualname, node)`` for every function/method, including
    nested ones (``Class.method.<locals>.inner`` style collapsed to
    ``Class.method.inner``)."""

    def rec(node: ast.AST, prefix: str) -> Iterator[Tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                yield qn, child
                yield from rec(child, qn + ".")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
            else:
                yield from rec(child, prefix)

    yield from rec(tree, "")


def enclosing_map(tree: ast.AST) -> dict:
    """Map id(node) -> qualname of the innermost enclosing function for
    every node in the tree ('' at module level)."""
    out: dict = {}

    def rec(node: ast.AST, prefix: str, fn: str) -> None:
        out[id(node)] = fn
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                rec(child, qn + ".", qn)
            elif isinstance(child, ast.ClassDef):
                rec(child, f"{prefix}{child.name}.", fn)
            else:
                rec(child, prefix, fn)

    rec(tree, "", "")
    return out


def assign_target_attrs(node: ast.AST) -> List[ast.Attribute]:
    """``self.x`` attribute targets of an assignment statement,
    flattening tuple/list unpacking."""
    targets: List[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    out: List[ast.Attribute] = []
    stack = targets
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Attribute):
            out.append(t)
    return out


def is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and (attr is None or node.attr == attr)
    )


def literal_str_collection(node: ast.AST) -> Optional[List[str]]:
    """Statically evaluate a set/frozenset/tuple/list of string
    literals; None when the expression is anything else."""
    if isinstance(node, ast.Call) and call_name(node) in ("frozenset", "set",
                                                         "tuple", "list"):
        if len(node.args) != 1 or node.keywords:
            return None
        node = node.args[0]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for e in node.elts:
            s = const_str(e)
            if s is None:
                return None
            out.append(s)
        return out
    return None
