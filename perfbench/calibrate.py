"""Readings that the limits of ``correct`` are set from, at a cell's own
size on the card.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults] [--seconds 3] [--out FILE]

For each seed it runs the cell as a run does, with a window of
``--seconds``, and prints the numbers compared against the reference (the
lower readings). With ``--control-seeds`` it prints, on those seeds, the
readings of the lower-precision controls: the program with bfloat16
tables (its own lower-precision path), and the reference put in the
program's place with its products in TF32 (the shared pool's, on the
first training group, and the query's; the per-pair step has none). With
``--faults`` it also plants, on the control seeds, each fault the cell can
have into the program (a training step that leaves the tables unchanged
reads 1 by construction and is not run) and prints its readings. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, _ROOT)

import gc  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import data, faults, harness  # noqa: E402


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


#: Query calls whose sampled answers the query's TF32 control gives.
CONTROL_CALLS = 64


def readings(ctx) -> dict:
    return ctx.cell.driver().run(ctx)["checks"].values


def train_reference_in_place(ctx) -> dict:
    """The reference in fp32 with TF32 products, in the program's place,
    on the first training group."""
    from perfbench.drivers import train_packed as tp

    corp = tp.make_corpus(ctx)
    reference = tp.Reference(ctx, corp)
    first = tp.ProgramGroup(None, None, None, None, "float32")
    syn0, syn1, steps = reference.follow(first, torch.float32, tf32=True)
    V, d = syn0.shape
    init0 = data.initial_syn0(ctx.seed, V, d, ctx.device)
    changed = tp.changed_rows((syn0, syn1), (init0, 0))
    del syn0, syn1, init0
    _free(ctx.device)
    prog = first._replace(
        losses=np.array([s.loss for s in steps]),
        pos_ends=np.array([s.pos_end for s in steps]),
        pairs=np.array([s.pairs for s in steps]), changed=changed)
    return tp.compare(ctx, reference, [prog]).values


def query_reference_in_place(ctx) -> dict:
    """The reference in fp32 with TF32 products answers the queries a
    window of this seed would have sampled."""
    from perfbench.drivers import synonyms_bulk as sb
    from perfbench.reference.synonyms import Cosines

    tr, V, d = ctx.traffic, ctx.config["vocab_size"], ctx.config["vector_size"]
    Q, want = int(tr["block"]), int(tr["num"]) + 1
    rng = np.random.default_rng(int(ctx.seed) & (2**63 - 1))
    offset = int(rng.integers(V))
    rows = []
    for c in range(CONTROL_CALLS):
        ids = (offset + c * Q + np.arange(Q)) % V
        rows.extend(int(ids[j]) for j in
                    rng.choice(Q, int(tr["checked_per_call"]), replace=False))
    rows = np.asarray(rows, np.int64)
    cos = Cosines(data.planted_table(ctx.seed, V, d, ctx.device),
                  dtype=torch.float32, tf32=True)
    vals, ids = cos.top(torch.from_numpy(rows).to(ctx.device), want)
    answers = [[(f"w{int(i)}", float(v)) for v, i in zip(vr, ir)]
               for vr, ir in zip(vals.cpu(), ids.cpu())]
    del cos, vals, ids
    _free(ctx.device)
    return sb.compare(ctx, rows, answers, want).values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the readings are the card's")
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(4)
    harness.log(f"card: {harness.nvidia_smi()}; torch {torch.__version__}")
    cell = harness.Cell(args.workload)
    train = cell.workload["driver"] == "train_packed"
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = []

    def ctx_for(seed, dtype=None):
        return harness.Context(cell, seed, args.seconds, False, device,
                               time.time(), dtype)

    def record(variant, seed, fn):
        t = time.time()
        vals = fn()
        row = {"variant": variant, "seed": seed, "seconds": time.time() - t,
               **vals}
        out.append(row)
        print(json.dumps(row), flush=True)

    for s in seeds:
        record("program", s, lambda: readings(ctx_for(s)))
    for s in controls:
        record("program-bf16", s, lambda: readings(ctx_for(s, "bfloat16")))
        if not train:
            record("reference-tf32", s, lambda: query_reference_in_place(ctx_for(s)))
        elif cell.traffic["shared_negatives"]:
            record("reference-tf32", s, lambda: train_reference_in_place(ctx_for(s)))
        if args.faults:
            kind = "train" if train else "query"
            for name in faults.FAULTS[kind]:
                if name == "unchanged":
                    continue
                with faults.planted(name, kind):
                    record("fault-" + name, s, lambda: readings(ctx_for(s)))
    summary = {}
    for row in out:
        for k, v in row.items():
            if k in ("variant", "seed", "seconds"):
                continue
            key = "lower" if row["variant"] == "program" else row["variant"]
            agg = summary.setdefault(k, {})
            if key == "lower":
                agg[key] = max(agg.get(key, v), v)
            else:
                agg[key] = min(agg.get(key, v), v)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": out,
                       "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
