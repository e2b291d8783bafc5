"""Driver: exact synonyms of whole query blocks, the walk of
``synonyms-dump`` (``glint_word2vec_torch.batch.transform.synonyms_dump``).

Set-up plants a table from the seed, builds a ``Word2VecModel`` over it
(``convert.model_from_arrays``), and warms the call's shapes with two
calls. The window, one caller in a closed loop, takes consecutive blocks
of ``block`` vocabulary rows from a seed-chosen offset (wrapping at the
vocabulary's end): each call pulls the block's vectors to the host and
asks ``find_synonyms_batch`` for ``num + 1`` neighbours each (the word
itself among them), as the dump does. The answers of ``checked_per_call``
queries a call, drawn from the seed, are kept; a traced run then profiles
``profile_calls`` more calls, twice (``perfbench/trace.py``); once the window has closed
and the model is freed, the reference scores them.

Traffic keys: ``block``, ``num``, ``checked_per_call``, ``profile_calls``
(calls in the traced sub-window).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import checks as chk
from perfbench import data
from perfbench import trace as tracing
from perfbench.reference.synonyms import Cosines


def build(ctx):
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.utils.params import Word2VecParams

    V, d = ctx.config["vocab_size"], ctx.config["vector_size"]
    syn0 = data.planted_table(ctx.seed, V, d, ctx.device)
    params = Word2VecParams(vector_size=d, min_count=1, dtype=ctx.dtype)
    return model_from_arrays(
        [f"w{i}" for i in range(V)], syn0, torch.zeros_like(syn0),
        np.arange(V, 0, -1, dtype=np.int64), params, device=ctx.device)


def word_row(vocab_size: int):
    def parse(word: str):
        if not word.startswith("w") or not word[1:].isdigit():
            return None
        k = int(word[1:])
        return k if k < vocab_size else None
    return parse


def compare(ctx, rows: np.ndarray, answers: list, want: int) -> chk.Checks:
    V, d = ctx.config["vocab_size"], ctx.config["vector_size"]
    cos = Cosines(data.planted_table(ctx.seed, V, d, ctx.device))
    rows_t = torch.from_numpy(rows).to(ctx.device)
    top, _ = cos.top(rows_t, want)
    checks = chk.Checks(ctx.cell.limits)
    for k, v in chk.query_numbers(
            answers, want, lambda i, ids: cos.score(int(rows[i]), ids), top,
            word_row(V)).items():
        checks.add(k, v)
    return checks


def run(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    V = cfg["vocab_size"]
    Q, want = int(tr["block"]), int(tr["num"]) + 1
    rng = np.random.default_rng(int(ctx.seed) & (2**63 - 1))
    offset = int(rng.integers(V))
    ctx.stage("imports")
    model = build(ctx)
    ctx.stage("model")

    def call(c: int):
        ids = ((offset + c * Q + np.arange(Q)) % V).astype(np.int32)
        with torch.profiler.record_function("pb.call"):
            vecs = model.engine.pull(ids).cpu().numpy()
            return ids, model.find_synonyms_batch(vecs, want)

    for c in (-2, -1):
        call(c)
    ctx.synchronize()
    setup_s = time.time() - ctx.t_start

    call_ms, rows, answers, summary = [], [], [], None
    failed = calls = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while True:
        t = time.perf_counter()
        ids, hits = call(calls)
        call_ms.append((time.perf_counter() - t) * 1e3)
        failed += sum(len(h) < want for h in hits)
        for j in rng.choice(Q, int(tr["checked_per_call"]), replace=False):
            rows.append(int(ids[j]))
            answers.append(hits[j])
        calls += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    if ctx.trace:
        # Calls past the window's, each its own block.
        nxt = [calls]

        def body():
            for c in range(nxt[0], nxt[0] + int(tr["profile_calls"])):
                call(c)
            nxt[0] += int(tr["profile_calls"])

        summary = tracing.profile(ctx.device, body)
    model.stop()
    model.engine.destroy()
    del model
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    checks = compare(ctx, np.asarray(rows, np.int64), answers, want)
    record = {"kind": "query", "window_s": window_s, "calls": calls,
              "queries": calls * Q, "block": Q, "dim": cfg["vector_size"],
              "rows": V, "call_ms": call_ms, "trace": summary,
              "profiled_calls": int(tr["profile_calls"]) if ctx.trace else 0}
    return {
        "end_to_end": {"synonyms_per_s": (calls * Q / window_s, "queries/s"),
                       "setup_s": (setup_s, "s")},
        "record": record, "checks": checks, "attempted": calls * Q,
        "failed": failed, "memory_peak_bytes": peak, "trace": summary,
    }
