"""Command line of the port: train, query and serve a model.

  python -m glint_word2vec_torch.cli train     --corpus c.txt --output m/ [--fasttext] [...]
  python -m glint_word2vec_torch.cli fit-stream --corpus c.txt|- --publish-dir P/ [...]
  python -m glint_word2vec_torch.cli serve     --model m/ --port 8801 [--ann]
  python -m glint_word2vec_torch.cli serve     --watch-checkpoint P/ [--watch-poll 1]
  python -m glint_word2vec_torch.cli transform-file --model m/ --input s.txt --out shards/
  python -m glint_word2vec_torch.cli synonyms-dump  --model m/ --out n.jsonl [--ann]
  python -m glint_word2vec_torch.cli synonyms  --model m/ --word w [-n 10]
  python -m glint_word2vec_torch.cli analogy   --model m/ --positive a b --negative c
  python -m glint_word2vec_torch.cli transform --model m/ --sentence "w1 w2 w3"
  python -m glint_word2vec_torch.cli eval      --model m/ --questions q.txt
  python -m glint_word2vec_torch.cli info      --model m/

The model directory may come from either package. Every command runs on
the CUDA card unless ``--device cpu`` is given. ``train`` takes the JAX
package's training and observability arguments except the mesh and
replica-exchange ones; a run the divergence canary aborts exits 2 with
one line. ``fit-stream`` trains on a sentence stream (a file, a followed
file or stdin) and publishes generations that ``serve --watch-checkpoint``
swaps in.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def _add_train(sub) -> None:
    p = sub.add_parser("train", help="train a model from a text corpus")
    p.add_argument("--corpus", required=True, help="text file, one sentence per line")
    p.add_argument("--output", required=True, help="model output directory")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    p.add_argument("--lowercase", action="store_true")
    p.add_argument("--vector-size", type=int, default=100)
    p.add_argument("--window", type=int, default=5)
    p.add_argument("--step-size", type=float, default=0.01875)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--negatives", type=int, default=5)
    p.add_argument("--subsample-ratio", type=float, default=0.0)
    p.add_argument("--min-count", type=int, default=5)
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--max-sentence-length", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="operand dtype of the composed step's products (the "
                        "host batcher); the fused step computes in fp32")
    p.add_argument("--steps-per-call", type=int, default=16,
                   help="packed steps between two readbacks to the host")
    p.add_argument("--shared-negatives", type=int, default=0,
                   help="negatives drawn once a step and shared by the "
                        "whole batch, weighted n/S each (0: n per-pair "
                        "draws)")
    p.add_argument("--packing", choices=["dense", "grid"], default="dense",
                   help="dispatch shape on the device corpus: dense pair "
                        "packing or grid batches (the host batcher always "
                        "trains grid batches)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="enable checkpoint/resume: at epoch ends, and "
                        "mid-epoch on the packed path when "
                        "GLINT_PACKED_STOP_AFTER_GROUPS stops it")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="epochs between checkpoints (default 1). Saves are "
                        "asynchronous: the fit waits for the copy of the "
                        "tables to host memory, and a background thread "
                        "writes and commits them (GLINT_SYNC_CKPT=1 forces "
                        "blocking saves)")
    p.add_argument("--metrics-out", default=None,
                   help="write the training metrics JSON here (atomic write)")
    p.add_argument("--fasttext", action="store_true",
                   help="train the subword (fastText-style) family")
    p.add_argument("--min-n", type=int, default=3,
                   help="min char-ngram length (fastText family)")
    p.add_argument("--max-n", type=int, default=6,
                   help="max char-ngram length (fastText family)")
    p.add_argument("--bucket", type=int, default=2_000_000,
                   help="subword hash-bucket rows (fastText family)")
    p.add_argument("--max-subwords", type=int, default=32,
                   help="max subword rows per word (fastText family)")
    obs = p.add_argument_group(
        "observability",
        "live heartbeat, span event log, divergence canary (all opt-in)",
    )
    obs.add_argument("--status-port", type=int, default=None,
                     help="serve a live training heartbeat on this port: "
                          "GET /healthz and /metrics (JSON, or "
                          "?format=prometheus); 0 binds an ephemeral port")
    obs.add_argument("--status-host", default="127.0.0.1",
                     help="heartbeat bind address (default 127.0.0.1)")
    obs.add_argument("--status-file", default=None,
                     help="atomically mirror the status snapshot JSON to "
                          "this path")
    obs.add_argument("--event-log", default=None,
                     help="JSONL span/event log of the fit's phases "
                          "(upload, subsample-compact, host batches, device "
                          "dispatch, readback, checkpoints) and engine "
                          "events (table mutations)")
    obs.add_argument("--event-capacity", type=int, default=65536,
                     help="in-memory event ring bound; overflow is counted "
                          "(default 65536)")
    obs.add_argument("--steptime-out", default=None,
                     help="write the step-time ledger (STEPTIME.json) here at "
                          "fit end: the fit thread's wall seconds by phase "
                          "(dispatch, readback_harvest, producer_wait, "
                          "compact, checkpoint, other) and each phase's "
                          "span-duration quantiles")
    obs.add_argument("--chrome-trace", default=None,
                     help="write the event log as chrome://tracing / "
                          "Perfetto JSON at run end")
    obs.add_argument("--canary", choices=["off", "warn", "abort"],
                     default="off",
                     help="divergence canary over a rolling loss window: "
                          "'warn' logs and records an event; 'abort' writes "
                          "a final ckpt-diverged snapshot, flushes the event "
                          "log and fails the run (exit 2)")
    obs.add_argument("--canary-window", type=int, default=64,
                     help="rolling loss window size (default 64)")
    obs.add_argument("--canary-factor", type=float, default=10.0,
                     help="trip when a loss exceeds factor x the window "
                          "median (default 10.0); NaN/Inf always trips")
    obs.add_argument("--canary-check-every", type=int, default=32,
                     help="steps between canary checks (default 32)")


def _add_fit_stream(sub) -> None:
    p = sub.add_parser(
        "fit-stream",
        help="incremental (ISGNS) training on an unbounded sentence stream: "
             "online vocabulary growth, adaptive distributions, and "
             "committed generations that `serve --watch-checkpoint` "
             "hot-swaps under load",
    )
    p.add_argument("--corpus", default="-",
                   help="sentence source, one per line: a file path, or '-' "
                        "(default) for stdin")
    p.add_argument("--follow", action="store_true",
                   help="tail the --corpus file (tail -f): keep polling for "
                        "appended lines instead of stopping at EOF")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    p.add_argument("--lowercase", action="store_true")
    p.add_argument("--publish-dir", default=None,
                   help="publish committed generations here (gen-NNNNNN "
                        "directories and the LATEST.json pointer)")
    p.add_argument("--publish-every", type=float, default=30.0,
                   help="seconds between publishes (default 30; whichever "
                        "of the time and word cadences fires first)")
    p.add_argument("--publish-words", type=int, default=None,
                   help="also publish every N trained words")
    p.add_argument("--output", default=None,
                   help="save the final model here when the stream ends")
    p.add_argument("--bootstrap-words", type=int, default=10000,
                   help="stream prefix scanned batch-style for the base "
                        "vocabulary (default 10000 words)")
    p.add_argument("--buffer-words", type=int, default=65536,
                   help="mini-epoch buffer capacity in words (default 65536)")
    p.add_argument("--extra-rows", type=int, default=1024,
                   help="spare table rows reserved for vocabulary growth, the "
                        "promotion budget (default 1024)")
    p.add_argument("--refresh-words", type=int, default=None,
                   help="kept-word cadence of the noise and subsample "
                        "refreshes (default: one buffer)")
    p.add_argument("--max-words", type=int, default=None,
                   help="stop after training this many words (default: run "
                        "until the stream ends)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop after this much wall time")
    p.add_argument("--vector-size", type=int, default=100)
    p.add_argument("--window", type=int, default=5)
    p.add_argument("--step-size", type=float, default=0.01875)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--negatives", type=int, default=5)
    p.add_argument("--subsample-ratio", type=float, default=0.0)
    p.add_argument("--min-count", type=int, default=5,
                   help="bootstrap admission and promotion threshold (a "
                        "candidate's guaranteed sketch count must clear it)")
    p.add_argument("--max-sentence-length", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--num-partitions", type=int, default=1,
                   help="data-parallel axis size: only 1 in the port so far")
    p.add_argument("--num-shards", type=int, default=1,
                   help="model-parallel axis size: only 1 in the port so far")
    p.add_argument("--steps-per-call", type=int, default=16)
    p.add_argument("--metrics-out", default=None,
                   help="write the final training metrics JSON here (atomic "
                        "write)")
    obs = p.add_argument_group(
        "observability",
        "live heartbeat with the streaming gauges (glint_stream_* in the "
        "Prometheus exposition)",
    )
    obs.add_argument("--status-port", type=int, default=None,
                     help="serve /healthz and /metrics for the trainer (0 "
                          "binds an ephemeral port)")
    obs.add_argument("--status-host", default="127.0.0.1")
    obs.add_argument("--status-file", default=None,
                     help="atomically mirror the status snapshot JSON here")
    obs.add_argument("--event-log", default=None,
                     help="JSONL span/event log (stream_fill, device_steps, "
                          "publish, table mutations)")


def _stream_sentences(path: str, follow: bool, lowercase: bool):
    """Tokenized sentences from a file, stdin (``-``) or a followed file
    (``cli.py:1044`` of the JAX package). Pull-based: a bounded trainer
    stops pulling. While stdin or a followed file is quiet it yields
    ``[]`` heartbeats, so the trainer keeps checking its stop bounds and
    publish cadence, and a half-written trailing line is held until its
    newline arrives."""

    def _toks(line):
        return (line.lower() if lowercase else line).split()

    if path != "-" and not follow:
        from glint_word2vec_torch.corpus.vocab import iter_text_file

        yield from iter_text_file(path, lowercase)
        return
    if path == "-":
        try:
            fd = sys.stdin.fileno()
        except (OSError, ValueError, AttributeError):
            fd = None
        if fd is None:
            # Not a real descriptor: plain blocking iteration.
            for line in sys.stdin:
                toks = _toks(line)
                if toks:
                    yield toks
            return
        import codecs
        import os
        import select

        dec = codecs.getincrementaldecoder("utf-8")("replace")
        pending = ""
        while True:
            ready, _, _ = select.select([fd], [], [], 0.2)
            if not ready:
                yield []  # idle heartbeat
                continue
            chunk = os.read(fd, 65536)
            if not chunk:  # EOF: flush a final newline-less line
                pending += dec.decode(b"", final=True)
                toks = _toks(pending)
                if toks:
                    yield toks
                return
            pending += dec.decode(chunk)
            *lines, pending = pending.split("\n")
            for line in lines:
                toks = _toks(line)
                if toks:
                    yield toks
    import time

    with open(path, encoding="utf-8") as f:
        pending = ""
        while True:
            line = f.readline()
            if not line:
                time.sleep(0.2)
                yield []  # idle heartbeat
                continue
            line = pending + line
            pending = ""
            if not line.endswith("\n"):
                pending = line
                continue
            toks = _toks(line)
            if toks:
                yield toks


def _run_fit_stream(args) -> int:
    from glint_word2vec_torch.models.word2vec import Word2Vec
    from glint_word2vec_torch.utils import atomic_write_json

    obs = None
    if args.status_port is not None or args.status_file or args.event_log:
        from glint_word2vec_torch.obs import ObsConfig

        obs = ObsConfig(event_log=args.event_log, status_port=args.status_port,
                        status_host=args.status_host,
                        status_file=args.status_file)
    w2v = Word2Vec(
        device=args.device,
        vector_size=args.vector_size,
        window=args.window,
        step_size=args.step_size,
        batch_size=args.batch_size,
        num_negatives=args.negatives,
        subsample_ratio=args.subsample_ratio,
        min_count=args.min_count,
        max_sentence_length=args.max_sentence_length,
        seed=args.seed,
        num_partitions=args.num_partitions,
        num_shards=args.num_shards,
        steps_per_call=args.steps_per_call,
        obs=obs,
    )
    model = w2v.fit_stream(
        _stream_sentences(args.corpus, args.follow, args.lowercase),
        publish_dir=args.publish_dir,
        bootstrap_words=args.bootstrap_words,
        buffer_words=args.buffer_words,
        extra_rows=args.extra_rows,
        refresh_words=args.refresh_words,
        publish_seconds=args.publish_every,
        publish_words=args.publish_words,
        max_words=args.max_words,
        max_seconds=args.max_seconds,
    )
    try:
        if args.output:
            model.save(args.output)
        print(json.dumps({**({"saved": args.output} if args.output else {}),
                          **model.training_metrics}))
        if args.metrics_out:
            atomic_write_json(args.metrics_out, model.training_metrics)
    finally:
        model.stop()
    return 0


def _obs_config(args):
    """The ``ObsConfig`` the train flags ask for, or None."""
    if not (args.status_port is not None or args.status_file
            or args.event_log or args.chrome_trace or args.steptime_out
            or args.canary != "off"):
        return None
    from glint_word2vec_torch.obs import ObsConfig

    return ObsConfig(
        event_log=args.event_log,
        event_capacity=args.event_capacity,
        chrome_trace=args.chrome_trace,
        status_port=args.status_port,
        status_host=args.status_host,
        status_file=args.status_file,
        canary=args.canary,
        canary_window=args.canary_window,
        canary_factor=args.canary_factor,
        canary_check_every=args.canary_check_every,
        steptime_path=args.steptime_out,
    )


def _train(args) -> int:
    from glint_word2vec_torch.models.fasttext import FastTextWord2Vec
    from glint_word2vec_torch.models.word2vec import Word2Vec
    from glint_word2vec_torch.utils import atomic_write_json

    kw = dict(
        device=args.device,
        vector_size=args.vector_size,
        window=args.window,
        step_size=args.step_size,
        batch_size=args.batch_size,
        num_negatives=args.negatives,
        subsample_ratio=args.subsample_ratio,
        min_count=args.min_count,
        num_iterations=args.iterations,
        max_sentence_length=args.max_sentence_length,
        seed=args.seed,
        dtype=args.dtype,
        compute_dtype=args.compute_dtype,
        steps_per_call=args.steps_per_call,
        shared_negatives=args.shared_negatives,
        batch_packing=args.packing,
    )
    obs = _obs_config(args)
    if args.fasttext:
        w2v = FastTextWord2Vec(
            **kw, obs=obs, min_n=args.min_n, max_n=args.max_n,
            bucket=args.bucket, max_subwords=args.max_subwords,
        )
    else:
        w2v = Word2Vec(**kw, obs=obs)
    model = w2v.fit_file(
        args.corpus, lowercase=args.lowercase,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every_epochs=args.checkpoint_every,
    )
    try:
        model.save(args.output)
        if args.metrics_out:
            atomic_write_json(args.metrics_out, model.training_metrics)
        print(json.dumps({"saved": args.output, **model.training_metrics}))
    finally:
        model.stop()
    return 0


def _add_ann_flags(p) -> None:
    ann = p.add_argument_group(
        "approximate top-k (ANN index)",
        "k-means centroids trained on the device from the table; coarse "
        "scores pick nprobe clusters, an exact rerank runs inside them; "
        "served only while its measured recall@10 against the exact path "
        'passes the gate (a request with {"exact": true} always takes the '
        "exact path)",
    )
    ann.add_argument("--ann", action="store_true",
                     help="answer through the ANN index (built, and for "
                          "serve gated, before the work starts)")
    ann.add_argument("--ann-clusters", type=int, default=-1,
                     help="coarse cluster count (-1: next_pow2(sqrt(rows)))")
    ann.add_argument("--ann-nprobe", type=int, default=8,
                     help="clusters probed a query (default 8)")
    ann.add_argument("--ann-iters", type=int, default=6,
                     help="k-means sweeps a build (default 6)")
    ann.add_argument("--ann-sample", type=int, default=65536,
                     help="rows sampled to train the centroids (default "
                          "65536; every row is assigned)")
    ann.add_argument("--ann-recall-gate", type=float, default=0.95,
                     help="least recall@10 against the exact path for the "
                          "index to serve (default 0.95)")
    ann.add_argument("--ann-recall-sample", type=int, default=64,
                     help="query rows a recall measurement samples "
                          "(default 64)")


def _add_transform_file(sub) -> None:
    p = sub.add_parser(
        "transform-file",
        help="embed a sentence file into resumable .npy vector shards")
    p.add_argument("--model", required=True, help="saved model directory")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    p.add_argument("--input", required=True,
                   help="one whitespace-tokenized sentence per line; blank "
                        "and all-OOV lines become zero vectors, so output "
                        "row i is input line i")
    p.add_argument("--out", required=True,
                   help="shard directory (rank-NNNN/ inside it under "
                        "--world > 1)")
    p.add_argument("--rows", type=int, default=1024,
                   help="sentences a packed device batch (default 1024)")
    p.add_argument("--max-len", type=int, default=256,
                   help="token cap a sentence (longer tails are truncated; "
                        "default 256)")
    p.add_argument("--shard-size", type=int, default=8192,
                   help="sentences an output shard, rounded up to a --rows "
                        "multiple (default 8192)")
    p.add_argument("--lowercase", action="store_true")
    p.add_argument("--prefetch", type=int, default=2,
                   help="producer batches buffered ahead (default 2)")
    p.add_argument("--no-deep-verify", action="store_true",
                   help="the resume scan checks shard sizes only instead of "
                        "re-hashing them")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip dispatching the stream's shapes before it starts")
    p.add_argument("--metrics-out", default=None,
                   help="write the run's stats JSON here too (always printed)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's rank: it embeds its contiguous span "
                        "of the input into <out>/rank-NNNN")
    p.add_argument("--world", type=int, default=None,
                   help="the number of ranks the input is split across")
    p.add_argument("--workers", type=int, default=1,
                   help="supervised rank-parallel workers: only 1 in the "
                        "port so far (run ranks with --rank/--world)")
    obs = p.add_argument_group("observability")
    obs.add_argument("--status-file", default=None,
                     help="atomically mirror the transform's status snapshot "
                          "JSON to this path")
    obs.add_argument("--status-port", type=int, default=None,
                     help="serve /healthz and /metrics for this run (0 binds "
                          "an ephemeral port)")
    obs.add_argument("--event-log", default=None,
                     help="JSONL span/event log of the run")


def _add_synonyms_dump(sub) -> None:
    p = sub.add_parser(
        "synonyms-dump",
        help="every vocabulary word's top-k neighbours (JSONL) and/or the "
             "k-NN graph arrays")
    p.add_argument("--model", required=True, help="saved model directory")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    p.add_argument("--out", default=None,
                   help='JSONL output (one {"word", "synonyms"} object a '
                        "word, the word itself excluded)")
    p.add_argument("--graph-out", default=None, metavar="PREFIX",
                   help="also write <PREFIX>.ids.npy, <PREFIX>.sims.npy and "
                        "<PREFIX>.json (int32 neighbour ids, -1 padded)")
    p.add_argument("-n", "--num", type=int, default=10)
    p.add_argument("--block", type=int, default=1024,
                   help="vocabulary rows pulled and queried a dispatch "
                        "(default 1024)")
    p.add_argument("--metrics-out", default=None)
    _add_ann_flags(p)


def _ann_kwargs(args) -> dict:
    return dict(
        ann=args.ann, ann_clusters=args.ann_clusters,
        ann_nprobe=args.ann_nprobe, ann_iters=args.ann_iters,
        ann_sample=args.ann_sample, ann_recall_gate=args.ann_recall_gate,
        ann_recall_sample=args.ann_recall_sample,
    )


def _run_transform_file(args, model) -> int:
    """One rank of a transform (or the whole run): derive the input span,
    wire the observability, stream the file."""
    import os

    from glint_word2vec_torch.batch.transform import count_lines, transform_file
    from glint_word2vec_torch.obs import ObsConfig, start_run

    rank, world = args.rank or 0, args.world or 1
    out_dir, start, end = args.out, 0, None
    if world > 1:
        from glint_word2vec_torch.parallel.distributed import shard_span

        start, end = shard_span(count_lines(args.input), rank, world)
        out_dir = os.path.join(args.out, f"rank-{rank:04d}")
    run = start_run(
        ObsConfig(status_file=args.status_file, status_port=args.status_port,
                  event_log=args.event_log),
        pipeline="transform", engine=model.engine,
    )
    failed = True
    try:
        stats = transform_file(
            model, args.input, out_dir, rows=args.rows, max_len=args.max_len,
            shard_size=args.shard_size, start=start, end=end,
            lowercase=args.lowercase, prefetch_depth=args.prefetch,
            deep_verify=not args.no_deep_verify, warmup=not args.no_warmup,
            obs_run=run,
        )
        failed = False
    finally:
        run.close(failed=failed)
    stats["rank"], stats["world"] = rank, world
    print(json.dumps(stats))
    if args.metrics_out:
        from glint_word2vec_torch.utils import atomic_write_json

        atomic_write_json(args.metrics_out, stats)
    return 0


def _run_synonyms_dump(args, model) -> int:
    from glint_word2vec_torch.batch.transform import synonyms_dump

    if args.ann:
        eng = model._query_engine()
        eng.configure_ann(clusters=args.ann_clusters, nprobe=args.ann_nprobe,
                          iters=args.ann_iters, sample=args.ann_sample)
        if eng.ann_index is None:
            eng.adopt_ann(eng.ann_build())
    stats = synonyms_dump(
        model, args.out, num=args.num, block=args.block,
        approximate=args.ann, graph_prefix=args.graph_out,
    )
    print(json.dumps(stats))
    if args.metrics_out:
        from glint_word2vec_torch.utils import atomic_write_json

        atomic_write_json(args.metrics_out, stats)
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="glint_word2vec_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_train(sub)
    _add_fit_stream(sub)
    _add_transform_file(sub)
    _add_synonyms_dump(sub)

    def add(name: str, help: str, model_required: bool = True
            ) -> argparse.ArgumentParser:
        p = sub.add_parser(name, help=help)
        p.add_argument("--model", required=model_required,
                       help="saved model directory")
        p.add_argument("--device", default="cuda",
                       help="cuda (default), cuda:N or cpu")
        return p

    p = add("synonyms", "nearest neighbours of a word")
    p.add_argument("--word", required=True)
    p.add_argument("-n", "--num", type=int, default=10)
    p = add("analogy", "a is to b as c is to ?")
    p.add_argument("--positive", nargs="+", required=True)
    p.add_argument("--negative", nargs="+", default=[])
    p.add_argument("-n", "--num", type=int, default=10)
    p = add("transform", "embed a sentence (mean of word vectors)")
    p.add_argument("--sentence", required=True, help="whitespace-tokenized")
    add("info", "model metadata")
    p = add("eval", "analogy accuracy on a standard question file")
    p.add_argument("--questions", required=True,
                   help="': section' headers and 'a b c d' rows")
    p.add_argument("--top-k", type=int, default=1)
    p.add_argument("--no-lowercase", action="store_true")
    p = add("serve", "serve a saved model over HTTP", model_required=False)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8801)
    p.add_argument("--watch-checkpoint", default=None, metavar="DIR",
                   help="follow a fit-stream publish directory: each new "
                        "committed generation (LATEST.json) is staged off "
                        "the request path and hot-swapped in (POST /reload "
                        "polls now); without --model the newest generation "
                        "boots the server")
    p.add_argument("--watch-poll", type=float, default=1.0,
                   help="seconds between LATEST.json polls (default 1)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="coalesced /synonyms dispatch cap (rounded up to a "
                        "power of two)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running the serving query shapes before the "
                        "port binds")
    p.add_argument("--cache-size", type=int, default=65536,
                   help="synonym result-cache entries (0 disables)")
    p.add_argument("--port-file", default=None, metavar="FILE",
                   help="write the bound {host, port} JSON here once the "
                        "server is warmed and listening")
    _add_ann_flags(p)
    return ap


def main(argv=None) -> int:
    from glint_word2vec_torch.obs.canary import TrainingDiverged

    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    if args.cmd == "train":
        try:
            return _train(args)
        except TrainingDiverged as e:
            # The canary already wrote ckpt-diverged and flushed the event
            # log: one line, no traceback.
            print(f"error: training diverged: {e}", file=sys.stderr)
            return 2
    if args.cmd == "fit-stream":
        return _run_fit_stream(args)
    if args.cmd == "serve":
        from glint_word2vec_torch.serving import serve_model_dir

        if args.model is None and args.watch_checkpoint is None:
            print("error: serve needs --model or --watch-checkpoint",
                  file=sys.stderr)
            return 1
        serve_model_dir(
            args.model, host=args.host, port=args.port,
            max_batch=args.max_batch, warmup=not args.no_warmup,
            cache_size=args.cache_size, port_file=args.port_file,
            device=args.device, watch_dir=args.watch_checkpoint,
            watch_poll=args.watch_poll, **_ann_kwargs(args),
        )
        return 0
    if args.cmd == "transform-file" and args.workers > 1:
        print("error: transform-file --workers > 1 needs the port's "
              "supervisor, which is not ported yet (ROADMAP Queue A item 8); "
              "run one process per rank with --rank R --world N instead",
              file=sys.stderr)
        return 2
    if args.cmd == "synonyms-dump" and args.out is None and args.graph_out is None:
        print("error: synonyms-dump needs --out and/or --graph-out",
              file=sys.stderr)
        return 1

    from glint_word2vec_torch.models import load_model

    model = load_model(args.model, device=args.device)
    try:
        if args.cmd == "transform-file":
            return _run_transform_file(args, model)
        if args.cmd == "synonyms-dump":
            return _run_synonyms_dump(args, model)
        if args.cmd == "synonyms":
            for w, s in model.find_synonyms(args.word, args.num):
                print(f"{w}\t{s:.4f}")
        elif args.cmd == "analogy":
            for w, s in model.analogy(args.positive, args.negative, args.num):
                print(f"{w}\t{s:.4f}")
        elif args.cmd == "transform":
            vec = model.transform_sentences([args.sentence.split()])[0]
            print(json.dumps([round(float(x), 6) for x in vec]))
        elif args.cmd == "eval":
            from glint_word2vec_torch.eval import (
                evaluate_analogies,
                parse_analogy_file,
            )

            questions = parse_analogy_file(
                args.questions, lowercase=not args.no_lowercase)
            result = evaluate_analogies(model, questions, top_k=args.top_k)
            print(json.dumps(result.to_dict()))
        elif args.cmd == "info":
            print(json.dumps({
                "family": type(model).__name__,
                "vocab_size": model.vocab.size,
                "vector_size": model.vector_size,
                "train_words_count": model.vocab.train_words_count,
                "params": json.loads(model.params.to_json()),
            }))
    finally:
        model.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
