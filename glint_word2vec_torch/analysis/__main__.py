"""``python -m glint_word2vec_torch.analysis`` — the port's graftlint CLI.

Exit codes: 0 clean (or baseline-matched with ``--check-baseline``),
1 findings / gate failure, 2 usage error. Imports no torch, no jax and no
numpy: it runs on a bare interpreter.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from glint_word2vec_torch.analysis import core
from glint_word2vec_torch.analysis import baseline as bl


def _repo_root() -> str:
    # analysis/ lives at <root>/glint_word2vec_torch/analysis.
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir, os.pardir)
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m glint_word2vec_torch.analysis",
        description="graftlint for the port: AST-based invariant "
                    "checkers for the port's hand-enforced contracts.",
    )
    ap.add_argument("paths", nargs="*",
                    help="repo-relative files to analyze (default: the "
                         "port's package + chip_smoke.py)")
    ap.add_argument("--root", default=_repo_root(),
                    help="repo root (default: inferred from the package)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON document")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline path (default: <root>/{bl.BASELINE_REL})")
    ap.add_argument("--check-baseline", action="store_true",
                    help="the gate: fail on NEW findings, on stale "
                         "baseline entries, and on noteless entries")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings, "
                         "preserving notes of entries that still match")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    # Registers the checkers (side-effect import, kept out of module
    # scope so --help stays instant).
    from glint_word2vec_torch.analysis import checkers as _  # noqa: F401

    if args.list_rules:
        for rule in sorted(core.CHECKERS):
            print(f"{rule:22s} {core.CHECKERS[rule].doc}")
        return 0

    root = os.path.abspath(args.root)
    # Normalize CLI paths ("./x", absolute, backslashes) onto the
    # repo-relative posix form every checker and the baseline key on —
    # an unnormalized prefix would silently skip checks scoped by path.
    targets = []
    for p in args.paths:
        if not os.path.isabs(p) and \
                os.path.exists(os.path.join(root, os.path.normpath(p))):
            # Repo-relative (works from any cwd, "./" and all).
            rel = os.path.normpath(p)
        else:
            rel = os.path.relpath(os.path.abspath(p), root)
        if rel.startswith(os.pardir):
            print(f"error: path {p!r} is outside --root {root}",
                  file=sys.stderr)
            return 2
        targets.append(rel.replace(os.sep, "/"))
    targets = targets or None
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    t0 = time.time()
    try:
        findings, suppressed = core.run_analysis(root, targets, rules)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.time() - t0

    baseline_path = args.baseline or os.path.join(root, bl.BASELINE_REL)

    if args.update_baseline:
        old = bl.load_baseline(baseline_path)
        # Partial scope (explicit paths / --rules): only rewrite the
        # entries the current findings can speak for; everything out of
        # scope is preserved verbatim, notes included.
        tset = set(targets) if targets is not None else None
        rset = set(rules) if rules is not None else None

        def in_scope(e):
            return (tset is None or e["path"] in tset) and \
                   (rset is None or e["rule"] in rset)

        preserved = [e for e in old if not in_scope(e)]
        entries = bl.write_baseline(
            baseline_path, findings,
            [e for e in old if in_scope(e)], preserved,
        )
        empty = sum(1 for e in entries if not e["note"].strip())
        print(f"baseline: wrote {len(entries)} entries to "
              f"{os.path.relpath(baseline_path, root)}"
              + (f" ({empty} need a note before --check-baseline passes)"
                 if empty else ""))
        return 0

    if args.check_baseline:
        entries = bl.load_baseline(baseline_path)
        if targets is not None:
            # Partial run: entries for files outside the analyzed set
            # would all read as stale — only judge what was analyzed.
            analyzed = set(targets)
            entries = [e for e in entries if e["path"] in analyzed]
        if rules is not None:
            active = set(rules)
            entries = [e for e in entries if e["rule"] in active]
        new, stale, noteless = bl.compare_to_baseline(findings, entries)
        if args.as_json:
            print(json.dumps({
                "new": [f.to_dict() for f in new],
                "stale": stale, "noteless": noteless,
                "baselined": len(entries), "elapsed_seconds": elapsed,
            }, indent=1))
        else:
            for f in new:
                print(f.format())
            for e in stale:
                print(f"{e['path']}: [{e['rule']}] STALE baseline entry "
                      f"no longer matches any site: {e['context']!r}")
            for e in noteless:
                print(f"{e['path']}: [{e['rule']}] baseline entry has no "
                      f"note: {e['context']!r}")
            print(f"graftlint: {len(findings)} findings "
                  f"({len(entries)} baselined, {len(suppressed)} "
                  f"suppressed inline), {len(new)} new, {len(stale)} "
                  f"stale, {len(noteless)} noteless "
                  f"[{elapsed:.2f}s]")
        ok = not new and not stale and not noteless
        if not ok:
            print("graftlint: FAIL — fix the new findings, or audit "
                  "them into the baseline with --update-baseline and a "
                  "note per entry.", file=sys.stderr)
        return 0 if ok else 1

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "suppressed": len(suppressed),
            "elapsed_seconds": elapsed,
        }, indent=1))
    else:
        for f in findings:
            print(f.format())
        print(f"graftlint: {len(findings)} findings, "
              f"{len(suppressed)} suppressed inline [{elapsed:.2f}s]")
    return 0 if not findings else 1


if __name__ == "__main__":
    sys.exit(main())
