"""The comparisons that decide ``correct``: each number the program's
output gives against the plain reference, and its limit.

A number passes when it is finite and at most its limit; an exact
comparison has the limit 0. The limits live in each cell's workload file
(``limits``), set from the readings named in ``PERF.md``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


class Checks:
    """The numbers a run compared, in order, with their limits."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = dict(limits)
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for the check {name!r}")
        self.values[name] = float(value)

    def passed(self, name: str) -> bool:
        v = self.values[name]
        return math.isfinite(v) and v <= self.limits[name]

    @property
    def correct(self) -> bool:
        missing = set(self.limits) - set(self.values)
        return not missing and all(self.passed(n) for n in self.values)

    def as_line(self) -> dict:
        """Each number beside its limit; a number that is not finite as
        its name (``"nan"``), so that the line stays strict JSON."""
        return {n: {"value": v if math.isfinite(v) else str(v),
                    "limit": self.limits[n]}
                for n, v in self.values.items()}

    def lines(self) -> List[str]:
        out = [f"check {n} {v!r} limit {self.limits[n]!r} "
               f"{'ok' if self.passed(n) else 'FAILED'}"
               for n, v in self.values.items()]
        for n in sorted(set(self.limits) - set(self.values)):
            out.append(f"check {n} not computed limit {self.limits[n]!r} FAILED")
        return out


def worst(values) -> float:
    """The largest of ``values``, or NaN where any is NaN (``max`` would
    keep a number ahead of a NaN, and a NaN must fail its check)."""
    out = 0.0
    for v in values:
        v = float(v)
        if math.isnan(v):
            return math.nan
        out = max(out, v)
    return out


# ----------------------------------------------------------------------
# Training: a group of steps against the reference's
# ----------------------------------------------------------------------


def steps_mismatch(prog_pos: Sequence[int], prog_pairs: Sequence[int],
                   ref_pos: Sequence[int], ref_pairs: Sequence[int]) -> int:
    """Steps whose consumed position or live pair count differ."""
    if len(prog_pos) != len(ref_pos):
        return max(len(prog_pos), len(ref_pos))
    return sum(int(a != b or c != d) for a, b, c, d in
               zip(prog_pos, ref_pos, prog_pairs, ref_pairs))


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The worst step's ``|loss - reference| / |reference|``."""
    return worst(abs(float(p) - float(r)) / max(abs(float(r)), 1e-30)
                 for p, r in zip(prog, ref))


def leaf_numbers(prog_rows: torch.Tensor, ref_rows: torch.Tensor,
                 init_rows: torch.Tensor):
    """``(norm of the program's change, norm of the reference's, largest
    entry of the reference's change, largest gap between the two
    tables)`` over the rows either side changed, in float64."""
    p = prog_rows.double()
    r = ref_rows.double()
    i = init_rows.double()
    return (float(torch.linalg.vector_norm(p - i)),
            float(torch.linalg.vector_norm(r - i)),
            float((r - i).abs().max()) if r.numel() else 0.0,
            float((p - r).abs().max()) if r.numel() else 0.0)


def table_numbers(leaves: Dict[str, tuple]) -> Dict[str, float]:
    """``change_norm_gap`` and ``table_err`` over the leaves that move.

    ``change_norm_gap``: the worst leaf's gap between the program's norm
    of its change and the reference's, over the reference's norm of that
    leaf or of the median leaf, whichever is larger. ``table_err``: the
    worst leaf's largest entry gap over the largest entry of the
    reference's change. A leaf whose reference change is under a
    thousandth of the median leaf's is left out (it moves by round-off
    alone)."""
    norms = [v[1] for v in leaves.values()]
    med = float(np.median(norms)) if norms else 0.0
    gaps, errs = [], []
    for pn, rn, rmax, dmax in leaves.values():
        if rn < 1e-3 * med:
            continue
        gaps.append(abs(pn - rn) / max(rn, med, 1e-300))
        errs.append(dmax / max(rmax, 1e-300))
    return {"change_norm_gap": worst(gaps), "table_err": worst(errs)}


# ----------------------------------------------------------------------
# Queries: returned neighbours against the reference's scores
# ----------------------------------------------------------------------


def query_numbers(answers: List[List[tuple]], want: int, ref_scores,
                  ref_top: torch.Tensor, word_id) -> Dict[str, float]:
    """``answers[i]``: the program's ``(word, score)`` list for query
    ``i``; ``ref_scores(i, rows)``: the reference's float64 cosines of
    ``rows`` to query ``i``; ``ref_top[i]``: its ``want`` best scores,
    descending; ``word_id``: word -> row, or None for no word of the
    vocabulary.

    ``answers_missing``: queries answered with fewer than ``want``
    distinct words or with a word not in the vocabulary (a repeated word
    stands in for a missing one). ``score_gap``: the largest gap
    between a returned score and the reference's score of that word.
    ``rank_gap``: the largest amount by which the reference's score of the
    word returned at rank ``r`` lies below the reference's ``r``-th best
    score."""
    missing, sgaps, rgaps = 0, [], []
    for i, ans in enumerate(answers):
        ids = [word_id(w) for w, _ in ans]
        if (len(ans) < want or any(j is None for j in ids)
                or len(set(ids[:want])) < want):
            missing += 1
            continue
        ids_t = torch.tensor(ids[:want], dtype=torch.int64,
                             device=ref_top.device)
        got = torch.tensor([s for _, s in ans[:want]], dtype=torch.float64,
                           device=ref_top.device)
        true = ref_scores(i, ids_t)
        sgaps.append(float((got - true).abs().max()))
        rgaps.append(float((ref_top[i, :want] - true).max()))
    return {"answers_missing": missing, "score_gap": worst(sgaps),
            "rank_gap": worst(rgaps)}
