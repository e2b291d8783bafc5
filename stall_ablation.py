#!/usr/bin/env python3
"""Which of the stall-free loop's three schedules moves a fit's time.

    python3 stall_ablation.py            # on a machine with one CUDA card

Runs the checkpointed two-epoch ``Word2Vec(subsample_ratio=1e-3)
.fit_file`` of ``chip_smoke.py`` phase 11 (its seeded 10M-token corpus,
1,000,000 x 300 fp32) six times in one process, in turns: every
schedule synchronous (``GLINT_SYNC_READBACK=1 GLINT_SYNC_CKPT=1
GLINT_NO_COMPACT_PREFETCH=1``), the defaults, the defaults with blocking
checkpoints only, the defaults with synchronous readbacks only, the
defaults, every schedule synchronous. Each run records only the
step-time ledger (no event log, heartbeat or canary) and prints its
words/s, ``device_stall_seconds`` and the ledger's phases; every run's
tables must equal the first's bitwise. Imports nothing of JAX; needs the
card (it exits 2 without one).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ALL_SYNC = {"GLINT_SYNC_READBACK": "1", "GLINT_SYNC_CKPT": "1",
            "GLINT_NO_COMPACT_PREFETCH": "1"}
RUNS = (
    ("all synchronous", ALL_SYNC),
    ("defaults", {}),
    ("blocking checkpoints only", {"GLINT_SYNC_CKPT": "1"}),
    ("synchronous readbacks only", {"GLINT_SYNC_READBACK": "1"}),
    ("defaults", {}),
    ("all synchronous", ALL_SYNC),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stall_ablation: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as cs
    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.kernels import build
    from glint_word2vec_torch.obs import ObsConfig

    build.build()
    cs.log(f"stall ablation on {cs.nvidia_smi_line()}")
    tmp = tempfile.mkdtemp(prefix="glint_stall_ablation_")
    try:
        path = os.path.join(tmp, "corpus.txt")
        cs.write_synthetic_corpus(np, path)
        width = dict(vector_size=cs.D, window=cs.W_TRAIN, batch_size=cs.B_TRAIN,
                     num_negatives=cs.N_NEG, min_count=cs.MIN_PER_WORD,
                     num_iterations=2, step_size=0.025, seed=1,
                     subsample_ratio=1e-3)
        first = None
        for i, (what, env) in enumerate(RUNS):
            os.environ.update(env)
            ck = os.path.join(tmp, f"ck-{i}")
            try:
                t0 = time.perf_counter()
                m = Word2Vec(**width, obs=ObsConfig(steptime_path=os.path.join(
                    tmp, "STEPTIME.json"))).fit_file(path, checkpoint_dir=ck)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                for k in env:
                    os.environ.pop(k, None)
            shutil.rmtree(ck)
            tm = m.training_metrics
            tables = (m.engine.syn0.cpu(), m.engine.syn1.cpu())
            if first is None:
                first = tables
            cs.expect(all(torch.equal(a, b) for a, b in zip(first, tables)),
                      f"run {i} ({what}): tables differ from run 0's")
            print(json.dumps({
                "run": i, "schedule": what, "env": env,
                "wall_seconds_in_all": round(wall, 3),
                "training_seconds": tm["wall_seconds"],
                "words_per_sec": tm["words_per_sec"],
                "device_stall_seconds": tm["device_stall_seconds"],
                "steptime": tm["steptime"],
            }), flush=True)
            m.stop()
            del m
            torch.cuda.empty_cache()
        cs.log("every run's tables equal run 0's bitwise")
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
