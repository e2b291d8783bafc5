"""Plain reference of the exact cosine top-k over a table.

A query is a row of the table, scaled to unit length; a row's score is
its cosine with the query (rows of norm 0 are never neighbours). The
scores run in float64 by default, in blocks of queries so that a block's
``(V, block)`` scores fit beside the table; ``dtype=torch.float32,
tf32=True`` runs the same code as the lower-precision control.
"""

from __future__ import annotations

import torch

BLOCK = 256


class Cosines:
    def __init__(self, table: torch.Tensor, dtype=torch.float64,
                 tf32: bool = False):
        self.table = table.to(dtype)
        self.norms = torch.linalg.vector_norm(self.table, dim=1)
        self.inv = torch.where(self.norms > 0, 1.0 / self.norms, 0.0)
        self.tf32 = tf32

    def _unit(self, rows: torch.Tensor) -> torch.Tensor:
        return self.table[rows] * self.inv[rows][:, None]

    def top(self, rows: torch.Tensor, k: int):
        """The ``k`` best scores and their rows for each query row, best
        first: ``(len(rows), k)`` values and ids."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            vals, ids = [], []
            masked = self.norms == 0
            for s in range(0, rows.shape[0], BLOCK):
                q = self._unit(rows[s:s + BLOCK])
                sc = (self.table @ q.T) * self.inv[:, None]
                sc[masked] = float("-inf")
                v, i = torch.topk(sc.T, k, dim=1)
                vals.append(v)
                ids.append(i)
                del sc
            return torch.cat(vals), torch.cat(ids)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def score(self, row: int, ids: torch.Tensor) -> torch.Tensor:
        """The cosines of rows ``ids`` with query row ``row``."""
        q = self._unit(torch.tensor([row], device=self.table.device))[0]
        return (self.table[ids] @ q) * self.inv[ids]
