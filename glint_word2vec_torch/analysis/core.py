"""graftlint core: the parsed-module cache, the finding type, per-line
suppressions, and the checker registry (counterpart of
``glint_word2vec_tpu/analysis/core.py``).

Everything here is stdlib-only (``ast`` + ``tokenize``), so the whole
pass imports in milliseconds and never pulls torch, jax or numpy into the
lint run. All checkers run from a single :class:`ModuleCache`, so each
target file is read and parsed exactly once per invocation.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

#: Suppression comment grammar: "graftlint: ignore" + [rules] + reason.
_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*ignore\[([a-zA-Z0-9_,\- ]*)\]\s*(.*)$"
)

#: The meta-rule id for malformed suppressions (empty reason, unknown or
#: empty rule list). Not a registered checker: it is emitted by the
#: runner itself and cannot be suppressed or baselined away.
SUPPRESSION_RULE = "graftlint-suppression"

#: Rule id for files that fail to parse.
PARSE_RULE = "graftlint-parse"


@dataclasses.dataclass
class Finding:
    """One rule violation at one site.

    ``context`` (the stripped source line) plus an occurrence index — not
    the line number — is the identity used for baseline matching, so
    unrelated edits that shift lines do not stale the baseline while an
    edit to the flagged line itself does.
    """

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    hint: str = ""
    context: str = ""

    def identity(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.context)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        out = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclasses.dataclass
class _Suppression:
    rules: Tuple[str, ...]
    reason: str
    line: int  # line the comment sits on


class Module:
    """One parsed target file: source, AST, and suppression map."""

    def __init__(self, root: str, rel: str, source: str):
        self.root = root
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(source, filename=rel)
        except SyntaxError as e:  # surfaced as a PARSE_RULE finding
            self.parse_error = e
        #: effective line -> suppression (a standalone comment line
        #: covers the next line; a trailing comment covers its own).
        self.suppressions: Dict[int, _Suppression] = {}
        self._scan_suppressions()
        self._imports: Optional[set] = None

    def _scan_suppressions(self) -> None:
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.source).readline
            )
            comments = [
                (t.start[0], t.string)
                for t in tokens
                if t.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, SyntaxError, IndentationError):
            comments = [
                (i, line[line.index("#"):])
                for i, line in enumerate(self.lines, 1)
                if "#" in line
            ]
        for lineno, text in comments:
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = tuple(
                r.strip() for r in m.group(1).split(",") if r.strip()
            )
            reason = m.group(2).strip()
            src_line = self.lines[lineno - 1] if lineno <= len(self.lines) else ""
            standalone = src_line.strip().startswith("#")
            target = lineno + 1 if standalone else lineno
            self.suppressions[target] = _Suppression(rules, reason, lineno)

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node_or_line, message: str,
                hint: str = "") -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(rule=rule, path=self.rel, line=line,
                       message=message, hint=hint,
                       context=self.line_at(line))

    def imports(self) -> set:
        """Top-level-ish set of imported module roots (``torch``,
        ``numpy`` ...) — cheap taint signal for the sync-point checker."""
        if self._imports is None:
            mods = set()
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    if isinstance(node, ast.Import):
                        for a in node.names:
                            mods.add(a.name.split(".")[0])
                    elif isinstance(node, ast.ImportFrom) and node.module:
                        mods.add(node.module.split(".")[0])
            self._imports = mods
        return self._imports


class ModuleCache:
    """Loads and parses each file once; shared by every checker."""

    def __init__(self, root: str, targets: Sequence[str]):
        self.root = os.path.abspath(root)
        self.targets = list(targets)
        self._modules: Dict[str, Optional[Module]] = {}

    def module(self, rel: str) -> Optional[Module]:
        """Load one repo-relative file (whether or not it is a target).
        Returns None when the file does not exist."""
        rel = rel.replace(os.sep, "/")
        if rel not in self._modules:
            path = os.path.join(self.root, rel)
            if not os.path.isfile(path):
                self._modules[rel] = None
            else:
                with open(path, "r", encoding="utf-8") as f:
                    src = f.read()
                self._modules[rel] = Module(self.root, rel, src)
        return self._modules[rel]

    def modules(self) -> Iterable[Module]:
        for rel in self.targets:
            mod = self.module(rel)
            if mod is not None:
                yield mod


# ----------------------------------------------------------------------
# Checker registry
# ----------------------------------------------------------------------

CheckerFunc = Callable[[ModuleCache], List[Finding]]


@dataclasses.dataclass
class CheckerInfo:
    rule: str
    doc: str
    func: CheckerFunc


CHECKERS: Dict[str, CheckerInfo] = {}


def checker(rule: str, doc: str) -> Callable[[CheckerFunc], CheckerFunc]:
    """Register a checker under its rule id. ``doc`` is the one-line
    catalog entry ``--list-rules`` prints."""

    def wrap(func: CheckerFunc) -> CheckerFunc:
        if rule in CHECKERS:
            raise ValueError(f"duplicate checker rule id {rule!r}")
        CHECKERS[rule] = CheckerInfo(rule, doc, func)
        return func

    return wrap


# ----------------------------------------------------------------------
# Target discovery + the runner
# ----------------------------------------------------------------------

_EXCLUDE_DIRS = {"__pycache__", ".git", "tests", "_build"}

#: The port's package and its chip check script, the audited file set.
PACKAGE = "glint_word2vec_torch"
DRIVER = "chip_smoke.py"


def default_targets(root: str) -> List[str]:
    """The audited file set: every ``.py`` of the port's package and the
    chip check script ``chip_smoke.py``. ``scripts/`` belongs to the JAX
    package's linter and is never a target here."""
    out: List[str] = []
    basedir = os.path.join(root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(basedir):
        dirnames[:] = sorted(d for d in dirnames if d not in _EXCLUDE_DIRS)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rel = os.path.relpath(
                    os.path.join(dirpath, fn), root
                ).replace(os.sep, "/")
                out.append(rel)
    if os.path.isfile(os.path.join(root, DRIVER)):
        out.append(DRIVER)
    return out


def _apply_suppressions(
    findings: List[Finding], cache: ModuleCache
) -> Tuple[List[Finding], List[Finding]]:
    """Split raw findings into (kept, suppressed) per the inline
    ``# graftlint: ignore[...]`` comments, and emit meta-findings for
    malformed or unknown-rule suppressions."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        mod = cache.module(f.path)
        sup = mod.suppressions.get(f.line) if mod else None
        if sup and f.rule in sup.rules and sup.reason:
            suppressed.append(f)
        else:
            kept.append(f)
    # Malformed suppressions are findings in their own right, whether or
    # not they currently mask anything: an empty reason defeats the
    # audit trail, an unknown rule id is a typo that silently ignores
    # nothing.
    for mod in cache.modules():
        for target_line, sup in sorted(mod.suppressions.items()):
            if not sup.reason:
                kept.append(mod.finding(
                    SUPPRESSION_RULE, sup.line,
                    "suppression without a reason",
                    hint="write `# graftlint: ignore[rule] <why this "
                         "site is exempt>` — the reason is mandatory",
                ))
            for r in sup.rules:
                if r not in CHECKERS and r != SUPPRESSION_RULE:
                    kept.append(mod.finding(
                        SUPPRESSION_RULE, sup.line,
                        f"suppression names unknown rule {r!r}",
                        hint="see --list-rules for the catalog",
                    ))
            if not sup.rules:
                kept.append(mod.finding(
                    SUPPRESSION_RULE, sup.line,
                    "suppression with an empty rule list",
                    hint="name the rule(s): ignore[rule-a,rule-b] reason",
                ))
    return kept, suppressed


def run_analysis(
    root: str,
    targets: Optional[Sequence[str]] = None,
    rules: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Run every registered checker (or ``rules``) over ``targets``
    (default: :func:`default_targets`). Returns ``(findings,
    suppressed)`` both sorted by (path, line, rule)."""
    # Import for side effect: registers the built-in checkers exactly
    # once, without a hard import cycle at module load.
    from glint_word2vec_torch.analysis import checkers as _  # noqa: F401

    if targets is None:
        targets = default_targets(root)
    cache = ModuleCache(root, targets)
    raw: List[Finding] = []
    for mod in cache.modules():
        if mod.parse_error is not None:
            raw.append(mod.finding(
                PARSE_RULE, mod.parse_error.lineno or 1,
                f"file does not parse: {mod.parse_error.msg}",
            ))
    active = rules if rules is not None else sorted(CHECKERS)
    for rule in active:
        if rule not in CHECKERS:
            raise ValueError(
                f"unknown rule {rule!r} (valid: {', '.join(sorted(CHECKERS))})"
            )
        raw.extend(CHECKERS[rule].func(cache))
    kept, suppressed = _apply_suppressions(raw, cache)
    key = lambda f: (f.path, f.line, f.rule, f.message)  # noqa: E731
    return sorted(kept, key=key), sorted(suppressed, key=key)
