"""Baseline bookkeeping: the committed record of audited-and-accepted
findings, so the gate is zero-NEW-findings rather than zero-findings
(counterpart of ``glint_word2vec_tpu/analysis/baseline.py``).

Identity is ``(rule, path, context)`` plus an occurrence index — the
stripped source line, not the line number — so unrelated edits that
shift a file do not stale the baseline, while editing a flagged line
itself (or fixing it) does. Every entry must carry a non-empty ``note``
naming why the finding is accepted; ``--check-baseline`` fails on a
noteless entry just as it fails on a new finding.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Sequence, Tuple

from glint_word2vec_torch.analysis.core import (
    PARSE_RULE,
    SUPPRESSION_RULE,
    Finding,
)

#: Repo-relative path of the committed baseline.
BASELINE_REL = "glint_word2vec_torch/analysis/baseline.json"

#: Meta-rules that can NEVER be baselined: a malformed suppression or an
#: unparseable file must be fixed, not accepted — otherwise the
#: mandatory-reason audit trail launders itself through the baseline.
UNBASELINEABLE = frozenset({SUPPRESSION_RULE, PARSE_RULE})

_SCHEMA = 1


def load_baseline(path: str) -> List[dict]:
    if not os.path.isfile(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != _SCHEMA:
        raise ValueError(
            f"baseline {path}: unknown schema {doc.get('schema')!r}"
        )
    return list(doc.get("findings", []))


def write_baseline(path: str, findings: Sequence[Finding],
                   old_entries: Sequence[dict] = (),
                   preserved: Sequence[dict] = ()) -> List[dict]:
    """Serialize ``findings`` as the new baseline, carrying ``note``
    fields over from matching old entries (new entries get an empty note
    the check step will then demand be filled in). ``preserved`` entries
    are kept verbatim — the out-of-scope remainder of a partial
    (explicit-paths / ``--rules``) update, which the current findings
    say nothing about."""
    notes: Dict[Tuple[str, str, str], List[str]] = collections.defaultdict(list)
    for e in old_entries:
        notes[(e["rule"], e["path"], e["context"])].append(e.get("note", ""))
    entries = [dict(e) for e in preserved
               if e["rule"] not in UNBASELINEABLE]
    findings = [f for f in findings if f.rule not in UNBASELINEABLE]
    for f in findings:
        pool = notes.get(f.identity())
        note = pool.pop(0) if pool else ""
        entries.append({
            "rule": f.rule, "path": f.path, "line": f.line,
            "context": f.context, "note": note,
        })
    entries.sort(key=lambda e: (e["path"], e["line"], e["rule"],
                                e["context"]))
    doc = {"schema": _SCHEMA, "findings": entries}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return entries


def compare_to_baseline(
    findings: Sequence[Finding], entries: Sequence[dict]
) -> Tuple[List[Finding], List[dict], List[dict]]:
    """Match current findings against baseline entries by identity +
    occurrence index. Returns ``(new, stale, noteless)``:

    - ``new``: findings with no baseline entry — the gate's primary
      failure (someone broke an invariant).
    - ``stale``: entries that no longer match any site — the audited
      violation was fixed (or the line edited), so the entry must be
      dropped via ``--update-baseline`` to keep the record honest.
    - ``noteless``: matched entries whose ``note`` is empty — accepted
      findings must carry their justification in-repo.
    """
    by_id: Dict[Tuple[str, str, str], List[dict]] = collections.defaultdict(list)
    for e in entries:
        # An unbaselineable entry (hand-edited in) is treated as stale so
        # the gate forces it back out of the file.
        if e["rule"] not in UNBASELINEABLE:
            by_id[(e["rule"], e["path"], e["context"])].append(e)
    new: List[Finding] = []
    noteless: List[dict] = []
    for f in findings:
        pool = (by_id.get(f.identity())
                if f.rule not in UNBASELINEABLE else None)
        if pool:
            e = pool.pop(0)
            if not e.get("note", "").strip():
                noteless.append(e)
        else:
            new.append(f)
    stale = [e for pool in by_id.values() for e in pool]
    stale.extend(e for e in entries if e["rule"] in UNBASELINEABLE)
    return new, stale, noteless
