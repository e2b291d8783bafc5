"""Driver: word2vec training through the port's resident packed loop.

Set-up makes the corpus and the initial tables from the seed, builds the
engine that ``Word2Vec``'s resident route builds, uploads the corpus,
compacts the first epoch, and drives the first group of steps through the
window's own call; the tables' rows that group changed are kept aside
(that copy is not counted in ``setup_s``). The window then trains on,
epoch after epoch, on the fit's schedule (``perfbench/schedule.py``),
until ``--seconds`` have passed after a dispatch; it ends at the
synchronise after the last group. The schedule keeps the first group
after the first epoch boundary, with the tables before and after it; a
window too short to reach a boundary trains on, untimed, until it has
one. Once the program's state is freed, the reference follows both
groups, the first from the benchmark's initial tables and the other from
the tables the program handed it, and the two sides are compared.

Configuration keys, beside the model's: ``corpus_tokens``,
``sentence_length``, ``epochs`` (the anneal's length; a fresh fit starts
when they run out). Traffic keys: ``batch_size`` (centre positions a
step), ``steps_per_call``, ``shared_negatives`` (0: per-pair negatives),
``profile_groups`` (groups in each traced sub-window).
"""

from __future__ import annotations

import gc
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from perfbench import checks as chk
from perfbench import data, yardstick
from perfbench import trace as tracing
from perfbench.reference import counter_hash as ch
from perfbench.reference import sgns as ref
from perfbench.schedule import PackedSchedule


class ProgramGroup(NamedTuple):
    """What the program's checked group produced: per-step losses, end
    positions and live pairs, and for each table the rows it changed
    (``(ids, rows)``) against the tables it started from; where it
    started (epoch, stream position, step and grid step numbers), and
    from which tables: ``before`` (the program's, in its storage dtype)
    or, where None, the benchmark's initial tables."""

    losses: np.ndarray
    pos_ends: np.ndarray
    pairs: np.ndarray
    changed: Optional[dict]
    dtype: str
    epoch: int = 0
    start: int = 0
    step0: int = 0
    grid_step0: int = 0
    before: Optional[tuple] = None


def _geometry(ctx, corpus_words: int) -> ref.Geometry:
    cfg, tr = ctx.config, ctx.traffic
    return ref.Geometry(
        base_key=ch.seed_key(ctx.seed), window=cfg["window"],
        batch_size=tr["batch_size"],
        pair_slots=ref.packed_pairs(tr["batch_size"], cfg["window"]),
        negatives=cfg["num_negatives"], pool=tr["shared_negatives"],
        step_size=cfg["step_size"],
        total_words=cfg["epochs"] * corpus_words + 1,
        words_per_epoch=corpus_words,
    )


def make_corpus(ctx) -> data.Corpus:
    cfg = ctx.config
    return data.corpus(ctx.seed, cfg["vocab_size"], cfg["corpus_tokens"],
                       cfg["min_count"], cfg["sentence_length"], ctx.device)


def moved(table: torch.Tensor, start) -> torch.Tensor:
    """Ids of the rows of ``table`` that differ from ``start`` (a tensor,
    or 0 for a table that started at zero)."""
    return (table != start).any(dim=1).nonzero().squeeze(1)


def changed_rows(tables, starts) -> dict:
    """The rows of each table that differ from its start, as fp32
    copies: ``{"syn0": (ids, rows), "syn1": ...}``."""
    out = {}
    for name, table, start in zip(("syn0", "syn1"), tables, starts):
        idx = moved(table, start)
        out[name] = (idx, table[idx].float())
    return out


def first_changes(engine, seed: int, device) -> dict:
    """The rows the first group changed, against the benchmark's initial
    tables in the engine's storage dtype, as host copies."""
    start0 = data.initial_syn0(seed, engine.num_rows, engine.dim,
                               device).to(engine.syn0.dtype)
    out = changed_rows((engine.syn0, engine.syn1), (start0, 0))
    return {k: (i.cpu(), r.cpu()) for k, (i, r) in out.items()}


def boundary_group(ctx, sched) -> ProgramGroup:
    """The group the schedule kept after the first epoch boundary; a
    window that did not reach one trains on, untimed, until it does."""
    if sched.boundary is None:
        sched.run(lambda: sched.boundary is not None)
    sched.drain()
    b = sched.boundary
    sched.boundary = None
    g = b.group
    return ProgramGroup(
        g.losses, g.pos_ends, g.pairs, changed_rows(b.after, b.before),
        ctx.dtype, epoch=g.epoch, start=g.start, step0=g.step0,
        grid_step0=g.grid_step0, before=b.before)


def build(ctx, corp: data.Corpus):
    """The engine of ``Word2Vec``'s resident route, holding the
    benchmark's initial tables and the corpus, and the fit's schedule
    over it."""
    from glint_word2vec_torch.corpus.vocab import Vocabulary
    from glint_word2vec_torch.models.word2vec import Word2Vec
    from glint_word2vec_torch.utils.params import Word2VecParams

    cfg, tr = ctx.config, ctx.traffic
    V, d = cfg["vocab_size"], cfg["vector_size"]
    vocab = Vocabulary.from_sorted(data.words(V), corp.counts,
                                   min_count=cfg["min_count"])
    params = Word2VecParams(
        vector_size=d, window=cfg["window"], step_size=cfg["step_size"],
        batch_size=tr["batch_size"], num_negatives=cfg["num_negatives"],
        subsample_ratio=cfg["subsample_ratio"], min_count=cfg["min_count"],
        num_iterations=cfg["epochs"], seed=ctx.seed, dtype=ctx.dtype,
        steps_per_call=tr["steps_per_call"],
        shared_negatives=tr["shared_negatives"],
    )
    engine = Word2Vec(params, device=ctx.device)._make_engine(vocab)
    engine.set_tables(data.initial_syn0(ctx.seed, V, d, ctx.device),
                      torch.zeros((V, d), device=ctx.device))
    engine.upload_corpus(corp.ids, corp.offsets)
    sample = cfg["subsample_ratio"]
    if sample > 0:
        engine.set_keep_probs(vocab.device_keep_probabilities(sample))
    sched = PackedSchedule(
        engine, batch_size=tr["batch_size"], window=cfg["window"],
        steps_per_call=tr["steps_per_call"], step_size=cfg["step_size"],
        epochs=cfg["epochs"], seed=ctx.seed, offsets=corp.offsets,
        words_per_epoch=vocab.train_words_count, subsampling=sample > 0,
    )
    return engine, sched


def first_group(ctx, engine, sched) -> ProgramGroup:
    """Compact the first epoch and drive its first group through the
    window's call, read back at once."""
    sched.begin_epoch()
    sched.record = []
    sched.advance()
    sched.drain()
    g = sched.record[0]
    sched.record = None
    ctx.synchronize()
    return ProgramGroup(g.losses, g.pos_ends, g.pairs, None, ctx.dtype)


class Reference:
    """The reference's inputs, rebuilt from the seed after the program's
    state is freed: the noise table, the keep probabilities, the corpus
    on the device, and each epoch's stream on demand."""

    def __init__(self, ctx, corp: data.Corpus):
        dev = ctx.device
        self.ctx, self.corp = ctx, corp
        self.g = _geometry(ctx, int(corp.counts.sum()))
        prob, alias = ch.alias_table(corp.counts, 0.75)
        self.prob = torch.from_numpy(prob).to(dev)
        self.alias = torch.from_numpy(alias).to(dev)
        sample = ctx.config["subsample_ratio"]
        self.keep = (torch.from_numpy(ref.keep_probabilities(corp.counts, sample)).to(dev)
                     if sample > 0 else None)
        self.ids = torch.from_numpy(corp.ids).to(dev)
        self.offsets = torch.from_numpy(corp.offsets).to(dev)
        self._streams = {}

    def stream(self, epoch: int) -> ref.Stream:
        if epoch not in self._streams:
            self._streams[epoch] = ref.epoch_stream(
                self.ids, self.offsets, self.keep, self.g.base_key, epoch)
        return self._streams[epoch]

    def follow(self, prog: ProgramGroup, dtype=torch.float64, tf32=False):
        """The reference's tables after the steps of ``prog``'s group,
        from the tables it started from, and those steps."""
        ctx = self.ctx
        V, d = ctx.config["vocab_size"], ctx.config["vector_size"]
        start = prog.before
        if start is None:
            start = (data.initial_syn0(ctx.seed, V, d, ctx.device),
                     torch.zeros((V, d), device=ctx.device))
        syn0, syn1 = (t.to(dtype, copy=True) for t in start)
        steps = ref.follow_group(
            syn0, syn1, self.stream(prog.epoch), self.g, self.prob,
            self.alias, epoch=prog.epoch, pos=prog.start, step0=prog.step0,
            grid_step0=prog.grid_step0,
            n_steps=ctx.traffic["steps_per_call"], tf32=tf32)
        return syn0, syn1, steps


def group_numbers(ctx, reference: Reference, prog: ProgramGroup) -> dict:
    """The numbers of one checked group against the reference's."""
    syn0, syn1, steps = reference.follow(prog)
    n = len(steps)
    out = {
        "steps_mismatch": chk.steps_mismatch(
            prog.pos_ends[:n].tolist(), prog.pairs[:n].tolist(),
            [s.pos_end for s in steps], [s.pairs for s in steps]),
        "loss_gap": chk.loss_gap(prog.losses[:n], [s.loss for s in steps]),
    }
    store = {"float32": torch.float32, "bfloat16": torch.bfloat16}[prog.dtype]
    if prog.before is None:
        init0 = data.initial_syn0(ctx.seed, syn0.shape[0], syn0.shape[1],
                                  ctx.device)
        starts = (init0, torch.zeros_like(init0))
        p_starts = tuple(t.to(store) for t in starts)
    else:
        p_starts = prog.before
        starts = tuple(t.float() for t in p_starts)
    leaves = {}
    for name, table, init, p_init in zip(("syn0", "syn1"), (syn0, syn1),
                                         starts, p_starts):
        p_idx, p_rows = prog.changed[name]
        p_idx = p_idx.to(ctx.device)
        rows = torch.unique(torch.cat([moved(table, init.double()), p_idx]))
        prog_rows = p_init[rows].float()
        at = torch.searchsorted(rows, p_idx)
        prog_rows[at] = p_rows.to(ctx.device)
        leaves[name] = chk.leaf_numbers(prog_rows, table[rows], init[rows])
    out.update(chk.table_numbers(leaves))
    return out


def compare(ctx, reference: Reference, groups) -> chk.Checks:
    """Hold the program's checked groups against the reference's: each
    number is the worse of the groups'."""
    checks = chk.Checks(ctx.cell.limits)
    numbers: dict = {}
    for prog in groups:
        for k, v in group_numbers(ctx, reference, prog).items():
            numbers.setdefault(k, []).append(v)
    for k, v in numbers.items():
        checks.add(k, chk.worst(v))
    return checks


def roofline(reference: Reference, groups, dim: int) -> float:
    """The least seconds of the profiled groups' logical work."""
    g = reference.g
    rows_per_pair = 1 + (g.pool or g.negatives)
    least = 0.0
    for grp in groups:
        u0, u1, positions, pairs = ref.group_rows(
            reference.stream(grp.epoch), g, reference.prob, reference.alias,
            pos=grp.start, step0=grp.step0, grid_step0=grp.grid_step0,
            n_steps=grp.n_real)
        least += yardstick.least_seconds(
            yardstick.sgns_flops(pairs, rows_per_pair, dim),
            yardstick.group_bytes(u0, u1, dim, positions))
    return least


def profile(ctx, sched, per_group: int):
    """Profile ``profile_groups`` groups of the schedule twice
    (``perfbench/trace.py``), after the timed window, inside one epoch (the
    schedule first trains on to an epoch with room for them, so no epoch
    boundary falls inside). Returns the first pass's groups and the
    summary."""
    G = int(ctx.traffic["profile_groups"])
    need = (2 * G + 2) * max(per_group, 1)
    if sched.n_pos - sched.pos < need:
        sched.run(lambda: sched.n_pos - sched.pos >= need)
    passes = []

    def body():
        sched.record = []
        for _ in range(G):
            sched.advance()
        sched.drain()
        passes.append(sched.record)
        sched.record = None

    summary = tracing.profile(ctx.device, body)
    return passes[0], summary


def run(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    ctx.stage("imports")
    corp = make_corpus(ctx)
    ctx.stage("corpus")
    engine, sched = build(ctx, corp)
    ctx.stage("engine")
    prog = first_group(ctx, engine, sched)
    ctx.stage("first_group")
    t = time.time()
    prog = prog._replace(changed=first_changes(engine, ctx.seed, ctx.device))
    aside = time.time() - t

    ctx.synchronize()
    words0, sched.steps_done, sched.pairs_done = sched.words, 0, 0
    sched.dispatch_ms = []
    setup_s = time.time() - ctx.t_start - aside
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    sched.run(lambda: time.perf_counter() >= deadline)
    ctx.synchronize()
    window_s = time.perf_counter() - t0
    words, steps, pairs = sched.words - words0, sched.steps_done, sched.pairs_done
    failed, dispatch_ms = sched.bad_steps, list(sched.dispatch_ms)
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    profiled, summary = [], None
    if ctx.trace:
        profiled, summary = profile(ctx, sched, int(prog.pos_ends[-1]))
    checked = [prog, boundary_group(ctx, sched)]
    engine.destroy()
    del engine, sched
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    reference = Reference(ctx, corp)
    checks = compare(ctx, reference, checked)
    del checked
    record = {
        "kind": "train", "window_s": window_s, "words": words, "steps": steps,
        "pairs": pairs, "dim": cfg["vector_size"],
        "rows_per_pair": 1 + (tr["shared_negatives"] or cfg["num_negatives"]),
        "dispatch_ms": dispatch_ms, "trace": summary, "least_s": None,
        "profiled_steps": sum(g.n_real for g in profiled),
    }
    if summary is not None and summary.get("busy_s"):
        record["least_s"] = roofline(reference, profiled, cfg["vector_size"])
    return {
        "end_to_end": {"train_words_per_s": (words / window_s, "words/s"),
                       "setup_s": (setup_s, "s")},
        "record": record, "checks": checks, "attempted": steps,
        "failed": failed, "memory_peak_bytes": peak, "trace": summary,
    }
