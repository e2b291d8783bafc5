"""The benchmark's cells at a size the CPU runs in seconds.

``tiny_root(dir)`` writes a data root holding every cell of the benchmark
under its own name, with its driver and limits, but with its
configuration and traffic cut down: a vocabulary of 2,000, 16 columns, a
corpus of 40,000 tokens, small steps. Beside each training cell with a
shared pool it writes the same cell with per-pair negatives
(``<config>.train-pairs``), so that the per-pair path, which no cell of
the benchmark runs yet, is held to the reference too. ``run`` drives a
cell there on the CPU through the port's plain paths, past the harness's
look for a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

torch.set_num_threads(1)

CONFIG = {"vocab_size": 2000, "vector_size": 16, "corpus_tokens": 40000}
TRAFFIC = {
    "train_packed": {"batch_size": 64, "steps_per_call": 4,
                     "profile_groups": 2},
    "synonyms_bulk": {"block": 64, "checked_per_call": 4, "profile_calls": 2},
}


def cells() -> list:
    """The benchmark's cells."""
    return sorted(p.stem for p in (PB / "workloads").glob("*.json"))


def per_pair(name: str) -> str:
    return name.split(".")[0] + ".train-pairs"


def tiny_cells() -> list:
    """The benchmark's cells and the per-pair cells ``tiny_root`` adds."""
    out = cells()
    for name in cells():
        wl = json.loads((PB / "workloads" / f"{name}.json").read_text())
        tr = json.loads((PB / "traffic" / f"{wl['traffic']}.json").read_text())
        if tr.get("shared_negatives"):
            out.append(per_pair(name))
    return sorted(out)


def tiny_root(root: Path) -> Path:
    for sub in ("configs", "traffic", "workloads"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for name in cells():
        wl = json.loads((PB / "workloads" / f"{name}.json").read_text())
        cfg = json.loads((PB / "configs" / f"{wl['config']}.json").read_text())
        tr = json.loads((PB / "traffic" / f"{wl['traffic']}.json").read_text())
        cfg.update(CONFIG)
        tr.update(TRAFFIC[wl["driver"]])
        (root / "configs" / f"{wl['config']}.json").write_text(json.dumps(cfg))
        if tr.get("shared_negatives"):
            tr["shared_negatives"] = 64
            pairs = dict(wl, traffic="train-pairs")
            (root / "workloads" / f"{per_pair(name)}.json").write_text(
                json.dumps(pairs))
            (root / "traffic" / "train-pairs.json").write_text(
                json.dumps(dict(tr, shared_negatives=0)))
        (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        (root / "traffic" / f"{wl['traffic']}.json").write_text(json.dumps(tr))
    return root


def run(root: Path, name: str, *, seed: int = 2**31 + 11, seconds: float = 0.5,
        trace: bool = False, dtype=None) -> dict:
    """One run of cell ``name`` of ``root`` on the CPU; its result line
    as it would be printed."""
    line = harness.run_cell(harness.Cell(name, root), seed, seconds, trace,
                            torch.device("cpu"), dtype=dtype)
    return json.loads(json.dumps(line))
