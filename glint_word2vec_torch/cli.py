"""Command line of the port: train, query and serve a model.

  python -m glint_word2vec_torch.cli train     --corpus c.txt --output m/ [--fasttext] [...]
  python -m glint_word2vec_torch.cli supervise --workers 2 train --exchange sparse --checkpoint-dir ck/ [...]
  python -m glint_word2vec_torch.cli fit-stream --corpus c.txt|- --publish-dir P/ [...]
  python -m glint_word2vec_torch.cli serve     --model m/ --port 8801 [--ann] [--max-inflight 256]
  python -m glint_word2vec_torch.cli serve     --watch-checkpoint P/ [--watch-poll 1]
  python -m glint_word2vec_torch.cli serve     --model m/ --add-model b=m2/ --model-memory-budget 6gb
  python -m glint_word2vec_torch.cli serve-fleet --replicas 2 --watch-checkpoint P/ [--add-model b=m2/]
  python -m glint_word2vec_torch.cli serve-fleet --model m/ --balancer-procs 2 --warm-spares 1 --qos-tenant-rate 50 --trace-dir T/
  python -m glint_word2vec_torch.cli trace-merge T/ --out trace.json
  python -m glint_word2vec_torch.cli transform-file --model m/ --input s.txt --out shards/
  python -m glint_word2vec_torch.cli synonyms-dump  --model m/ --out n.jsonl [--ann]
  python -m glint_word2vec_torch.cli synonyms  --model m/ --word w [-n 10]
  python -m glint_word2vec_torch.cli analogy   --model m/ --positive a b --negative c
  python -m glint_word2vec_torch.cli transform --model m/ --sentence "w1 w2 w3"
  python -m glint_word2vec_torch.cli eval      --model m/ --questions q.txt
  python -m glint_word2vec_torch.cli info      --model m/

The model directory may come from either package. Every command runs on
the CUDA card unless ``--device cpu`` is given. ``train`` takes the JAX
package's training, replica-exchange, distributed and observability
arguments except the mesh ones; a run the divergence canary aborts exits
2 with one line. ``supervise`` runs a train command as a supervised gang
of ``--workers`` processes (rank ``r`` on ``cuda:{r % cards}``, a gloo
group between them), relaunching it from the last committed checkpoint
after a crash or a hang; ``transform-file --workers N`` runs N transform
ranks under the same supervisor. ``fit-stream`` trains on a sentence
stream (a file, a followed file or stdin) and publishes generations that
``serve --watch-checkpoint`` swaps in. ``serve --add-model`` serves more
models from one process (``/m/<id>/...``), under
``--model-memory-budget``; ``serve-fleet`` runs supervised ``serve``
replicas behind a breaker-aware balancer, with rolling rollout behind a
shadow canary (``--device`` goes to every replica), balancer shard
processes on the one port (``--balancer-procs``; each is a ``fleet-shard``
process, which touches no device), warm spares an autoscaler readmits
under load, QoS admission, and one trace directory that ``trace-merge``
stitches into a Chrome-trace timeline. ``supervise --join-serving`` adds
serving replicas to the gang's merged ``/metrics``.
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
    p.add_argument("--num-partitions", type=int, default=1,
                   help="data axis of the mesh (the reference's "
                        "numPartitions): every batch split over this many "
                        "ranks")
    p.add_argument("--num-shards", type=int, default=1,
                   help="model axis of the mesh (the reference's "
                        "numParameterServers): both tables split this many "
                        "ways")
    p.add_argument("--layout", choices=["rows", "dims"], default="rows",
                   help="how the model axis splits the tables: by vocabulary "
                        "rows or by embedding columns")
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
    p.add_argument("--exchange", choices=["none", "sparse", "dense"],
                   default="none",
                   help="replica reconciliation of a gang: sparse ships only "
                        "the touched rows' (id, delta) after every dispatch "
                        "group, dense full-table deltas; none trains one "
                        "process alone")
    p.add_argument("--exchange-capacity", type=int, default=0,
                   help="touched-row buffer capacity a round (0: sized from "
                        "the dispatch group and adapted from the observed "
                        "counts; nonzero pins it)")
    p.add_argument("--exchange-wire", choices=["fp32", "bf16", "int8"],
                   default="fp32",
                   help="sparse payload encoding: fp32 exact, bf16, or int8 "
                        "with per-row scales and an error-feedback carry; "
                        "dense, spill and flush rounds ship fp32")
    p.add_argument("--exchange-every", type=int, default=1,
                   help="dispatch groups coalesced into one exchange round")
    p.add_argument("--exchange-topology", choices=["flat", "twolevel"],
                   default="flat",
                   help="flat allgather, or twolevel: exact intra-node hop "
                        "and a leaders-only wire-encoded inter-node hop "
                        "(GLINT_RANKS_PER_NODE sets the node size)")
    p.add_argument("--exchange-shard", choices=["roundrobin", "locality"],
                   default="roundrobin",
                   help="corpus split across the gang: round-robin "
                        "sentences, or contiguous runs sorted by each "
                        "sentence's rarest word")
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
                   help="write the training metrics JSON here (atomic write; "
                        "in a gang rank R writes <stem>-rankR<ext>, with its "
                        "tables' sha256 and its kernel launch counts)")
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
    dist_g = p.add_argument_group(
        "distributed",
        "multi-process bring-up (supervise fills these in for each worker; "
        "set them by hand for a custom launcher)",
    )
    dist_g.add_argument("--coordinator", default=None,
                        help="host:port of the gloo rendezvous (rank 0 "
                             "binds it)")
    dist_g.add_argument("--num-processes", type=int, default=None,
                        help="worker processes in the gang")
    dist_g.add_argument("--process-id", type=int, default=None,
                        help="this worker's rank in [0, num-processes)")


def _add_supervise(sub) -> None:
    p = sub.add_parser(
        "supervise",
        help="run a train command as a supervised gang: launch, crash and "
             "hang detection, teardown, resume from the last committed "
             "checkpoint with capped backoff",
    )
    p.add_argument("--workers", type=int, default=1,
                   help="worker processes (1: a supervised one-process fit; "
                        "more: a gloo gang on a local rendezvous, rank r on "
                        "cuda:{r %% cards})")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="gang restarts before giving up")
    p.add_argument("--backoff-base", type=float, default=1.0,
                   help="first restart delay in seconds (doubles each "
                        "restart, capped at --backoff-cap)")
    p.add_argument("--backoff-cap", type=float, default=30.0)
    p.add_argument("--heartbeat-stale", type=float, default=120.0,
                   help="status-file age that counts as a hang (0 disables "
                        "hang detection)")
    p.add_argument("--startup-grace", type=float, default=600.0,
                   help="seconds a fresh worker may run before its first "
                        "heartbeat")
    p.add_argument("--supervise-dir", default=None,
                   help="status files and worker logs (default "
                        "<checkpoint-dir>/supervisor)")
    p.add_argument("--report-out", default=None,
                   help="also write the supervisor report JSON here (it is "
                        "always printed)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve the merged gang /metrics (JSON, or "
                        "?format=prometheus) and /healthz on this port (0: "
                        "ephemeral)")
    p.add_argument("--metrics-host", default="127.0.0.1")
    p.add_argument("--join-serving", action="append", default=[],
                   metavar="URL",
                   help="a serving replica's JSON /metrics URL joined into "
                        "the merged exposition (repeatable; scraped on each "
                        "request, a replica that does not answer reported, "
                        "never fatal)")
    p.add_argument("--rank-env", action="append", default=[],
                   metavar="R:KEY=VAL",
                   help="environment for rank R's first launch only "
                        "(repeatable): arms a GLINT_FAULTS schedule without "
                        "re-arming it on the relaunch")
    p.add_argument("--rank0-env", action="append", default=[],
                   metavar="KEY=VAL",
                   help="alias of --rank-env 0:KEY=VAL (the JAX CLI's flag)")
    p.add_argument(
        "train_args", nargs=argparse.REMAINDER,
        help="the train command: everything after the supervise flags, e.g. "
             "`supervise --workers 2 train --corpus c.txt --output m/ "
             "--exchange sparse --checkpoint-dir ck/`; --checkpoint-dir is "
             "required",
    )


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


def _argv_value(argv, flag):
    """Last value of ``--flag v`` or ``--flag=v`` in a raw argv list."""
    val = None
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            val = argv[i + 1]
        elif a.startswith(flag + "="):
            val = a.split("=", 1)[1]
    return val


def _parse_rank_env(args):
    """``{rank: {KEY: VAL}}`` from ``--rank0-env`` and ``--rank-env``, or
    a message naming the malformed entry."""
    out: dict = {}
    entries = [f"0:{kv}" for kv in args.rank0_env] + list(args.rank_env)
    for ent in entries:
        rank, sep, kv = ent.partition(":")
        if not sep or "=" not in kv or not rank.isdigit():
            return None, f"expected R:KEY=VAL (or KEY=VAL for --rank0-env), got {ent!r}"
        k, v = kv.split("=", 1)
        out.setdefault(int(rank), {})[k] = v
    return out, None


def _run_supervise(args) -> int:
    """``supervise``: a thin shell over ``parallel.supervisor.Supervisor``.
    The supervisor process touches no device; the workers own the cards."""
    import os

    train_args = list(args.train_args)
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if not train_args or train_args[0] != "train":
        print("error: supervise expects the train command to run, e.g. "
              "`supervise --workers 2 train --corpus c.txt --output m/ "
              "--exchange sparse --checkpoint-dir ck/`", file=sys.stderr)
        return 1
    rest = train_args[1:]
    checkpoint_dir = _argv_value(rest, "--checkpoint-dir")
    if checkpoint_dir is None:
        print("error: supervise requires --checkpoint-dir in the train "
              "arguments (recovery relaunches resume from it)",
              file=sys.stderr)
        return 1
    rank_env, err = _parse_rank_env(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    from glint_word2vec_torch.parallel.supervisor import (
        Supervisor,
        cli_train_build_argv,
    )

    report = Supervisor(
        cli_train_build_argv(rest), args.workers,
        status_dir=args.supervise_dir or os.path.join(checkpoint_dir,
                                                      "supervisor"),
        checkpoint_dir=checkpoint_dir,
        rank_env_first_launch=rank_env or None,
        heartbeat_stale_seconds=(args.heartbeat_stale
                                 if args.heartbeat_stale > 0 else None),
        startup_grace_seconds=args.startup_grace,
        max_restarts=args.max_restarts,
        backoff_base_seconds=args.backoff_base,
        backoff_cap_seconds=args.backoff_cap,
        metrics_port=args.metrics_port,
        metrics_host=args.metrics_host,
        serving_urls=args.join_serving,
    ).run()
    return _report(report, args.report_out)


def _report(report, path) -> int:
    out = report.to_dict()
    print(json.dumps(out))
    if path:
        from glint_word2vec_torch.utils import atomic_write_json

        atomic_write_json(path, out)
    return 0 if report.completed else 3


def _run_transform_fleet(args) -> int:
    """``transform-file --workers N``: a device-free supervisor shell. Each
    rank re-enters this CLI with ``--rank``/``--world``, embeds its
    contiguous input span into a private ``rank-NNNN/`` directory, and
    after a crash or a hang resumes from its own committed shards."""
    import os

    from glint_word2vec_torch.parallel.supervisor import (
        Supervisor,
        cli_transform_build_argv,
    )

    rest = [
        "--model", args.model, "--input", args.input, "--out", args.out,
        "--rows", str(args.rows), "--max-len", str(args.max_len),
        "--shard-size", str(args.shard_size), "--prefetch", str(args.prefetch),
        "--device", args.device,
    ]
    for flag, on in (("--lowercase", args.lowercase),
                     ("--no-deep-verify", args.no_deep_verify),
                     ("--no-warmup", args.no_warmup)):
        if on:
            rest.append(flag)
    report = Supervisor(
        cli_transform_build_argv(rest), args.workers,
        status_dir=args.supervise_dir or os.path.join(args.out, "supervisor"),
        heartbeat_stale_seconds=(args.heartbeat_stale
                                 if args.heartbeat_stale > 0 else None),
        startup_grace_seconds=args.startup_grace,
        max_restarts=args.max_restarts,
        metrics_port=args.metrics_port,
    ).run()
    return _report(report, args.report_out)


def _train(args) -> int:
    import os

    from glint_word2vec_torch.kernels import launch_counts
    from glint_word2vec_torch.models.fasttext import FastTextWord2Vec
    from glint_word2vec_torch.models.word2vec import Word2Vec
    from glint_word2vec_torch.parallel import distributed as dist
    from glint_word2vec_torch.utils import atomic_write_json

    device = args.device
    if args.coordinator or args.num_processes:
        dist.initialize(coordinator_address=args.coordinator,
                        num_processes=args.num_processes,
                        process_id=args.process_id)
        device = dist.rank_device(device, dist.process_index())
    kw = dict(
        device=device,
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
        num_partitions=args.num_partitions,
        num_shards=args.num_shards,
        layout=args.layout,
        dtype=args.dtype,
        compute_dtype=args.compute_dtype,
        steps_per_call=args.steps_per_call,
        shared_negatives=args.shared_negatives,
        batch_packing=args.packing,
        exchange=args.exchange,
        exchange_capacity=args.exchange_capacity,
        exchange_wire=args.exchange_wire,
        exchange_every=args.exchange_every,
        exchange_topology=args.exchange_topology,
        exchange_shard=args.exchange_shard,
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
        # In a replica-exchange gang every rank writes its row block of the
        # shared output; a mesh gang's ranks hold the same tables, and rank
        # 0 writes them. The barrier holds each rank until the directory
        # is whole.
        if args.exchange != "none" or dist.process_index() == 0:
            model.save(args.output)
        dist.barrier("model_save")
        metrics = dict(model.training_metrics)
        metrics["kernel_launches"] = launch_counts()
        metrics_out = args.metrics_out
        if dist.process_count() > 1:
            # Each rank reports its replica's digest in its own file.
            metrics["tables_sha256"] = model.engine.tables_digest()
            if metrics_out:
                root, ext = os.path.splitext(metrics_out)
                metrics_out = f"{root}-rank{dist.process_index()}{ext}"
        if metrics_out:
            atomic_write_json(metrics_out, metrics)
        print(json.dumps({"saved": args.output, **metrics}))
    finally:
        model.stop()
        dist.shutdown()
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
                   help="rank-parallel workers under the supervisor: each "
                        "rank embeds a contiguous input span into its own "
                        "shard directory, and a crashed rank relaunches and "
                        "resumes from its committed shards")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--heartbeat-stale", type=float, default=120.0,
                   help="status-file age that counts as a hang (0 disables "
                        "hang detection)")
    p.add_argument("--startup-grace", type=float, default=600.0)
    p.add_argument("--supervise-dir", default=None,
                   help="supervisor status and log directory (default "
                        "<out>/supervisor)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="merged gang /metrics and /healthz (0: ephemeral)")
    p.add_argument("--report-out", default=None,
                   help="also write the supervisor report JSON here")
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
    _add_supervise(sub)
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
    p.add_argument("--trace-log", default=None, metavar="FILE",
                   help="record the kept request traces and the dispatch "
                        "spans to this JSONL sink (also on GET /trace)")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="arm the anomaly flight recorder: a shed burst or "
                        "an SLO fast burn writes a postmortem bundle "
                        "(recent spans and the full metrics) here")
    _add_ann_flags(p)
    over = p.add_argument_group(
        "overload protection",
        "bounded admission, deadlines and degraded cache-only mode, so a "
        "traffic spike sheds load instead of queueing without bound "
        "(counters on /metrics)",
    )
    over.add_argument("--max-inflight", type=int, default=256,
                      help="admission high-water mark: device requests "
                           "past this many in flight answer 429 with "
                           "Retry-After (0 disables; default 256)")
    over.add_argument("--request-deadline", type=float, default=30.0,
                      help="seconds a request may wait for the device "
                           "before it answers 504 without a dispatch (0 "
                           "disables; default 30)")
    over.add_argument("--degraded-after", type=float, default=5.0,
                      help="device-lock hold seconds after which the "
                           "server answers from its cache alone and sheds "
                           "misses with 429, until the lock frees (0 "
                           "disables; default 5)")
    mm = p.add_argument_group(
        "model catalog",
        "one server holding several models behind one port: a request names "
        "its model with the /m/<id>/ path prefix or the X-Glint-Model header "
        "(neither: the default model); a same-shape model adds no query "
        "shapes to the process",
    )
    _add_catalog_flags(mm)
    mm.add_argument("--watch-models", default=None, metavar="DIR",
                    help="catalog root: each subdirectory with a LATEST.json "
                         "is one model's publish directory (the subdirectory "
                         "name is the model id), followed by a watcher of "
                         "its own")
    _add_serve_fleet(sub)
    return ap


def _add_catalog_flags(g) -> None:
    g.add_argument("--add-model", action="append", default=[],
                   metavar="ID=DIR",
                   help="serve another model (repeatable); DIR is a saved "
                        "model directory or a committed generation")
    g.add_argument("--model-memory-budget", default=None, metavar="BYTES",
                   help="device-memory budget of the resident tables "
                        "(suffixes kb, mb, gb): past it the least recently "
                        "used unpinned model is staged out to its snapshot "
                        "and staged back in on its next request")


def _add_serve_fleet(sub) -> None:
    p = sub.add_parser(
        "serve-fleet",
        help="run N supervised serve replicas of one model (or one publish "
             "directory) behind a breaker-aware load balancer, with rolling "
             "rollout behind a shadow canary and one merged /metrics",
    )
    p.add_argument("--model", default=None,
                   help="saved model directory every replica loads")
    p.add_argument("--watch-checkpoint", default=None, metavar="DIR",
                   help="publish directory whose generations are rolled out "
                        "to the replicas one at a time")
    p.add_argument("--watch-poll", type=float, default=1.0)
    p.add_argument("--replicas", type=int, default=2,
                   help="serving processes (default 2)")
    p.add_argument("--device", default="cuda",
                   help="the device every replica serves on: cuda (default), "
                        "cuda:N or cpu")
    p.add_argument("--host", default="127.0.0.1", help="balancer address")
    p.add_argument("--port", type=int, default=8800,
                   help="balancer port (0: ephemeral; replicas always bind "
                        "ephemeral ports)")
    p.add_argument("--port-file", default=None, metavar="FILE",
                   help="write the balancer's {host, port} here once the "
                        "fleet is up")
    p.add_argument("--replica-log-dir", default=None, metavar="DIR",
                   help="one replica-N.log a process (default: replicas "
                        "inherit stderr)")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="request tracing across the fleet: the balancer "
                        "records to balancer.jsonl, each shard process to "
                        "balancer-shard-K.jsonl, each replica to "
                        "replica-N.jsonl, flight bundles go under flight/ "
                        "(a replica's under flight/replica-N/); "
                        "stitch with `trace-merge DIR --out trace.json`")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--cache-size", type=int, default=65536)
    p.add_argument("--max-inflight", type=int, default=256)
    p.add_argument("--request-deadline", type=float, default=30.0)
    p.add_argument("--degraded-after", type=float, default=5.0)
    _add_ann_flags(p)
    heal = p.add_argument_group(
        "self-healing",
        "replica supervision (waitpid, and /healthz probes with a launch "
        "generation handshake), circuit breaking driven by the probes, and "
        "with --watch-checkpoint rolling rollout behind a shadow canary",
    )
    heal.add_argument("--max-restarts", type=int, default=3,
                      help="relaunches a replica before it is left down "
                           "(default 3)")
    heal.add_argument("--backoff-base", type=float, default=1.0,
                      help="first relaunch delay in seconds (doubles each "
                           "restart, capped at --backoff-cap)")
    heal.add_argument("--backoff-cap", type=float, default=30.0)
    heal.add_argument("--hang-kill-after", type=float, default=10.0,
                      help="seconds of failing probes after which a live "
                           "replica process is killed and relaunched")
    heal.add_argument("--probe-interval", type=float, default=0.5,
                      help="seconds between /healthz probes of a replica")
    heal.add_argument("--probe-timeout", type=float, default=2.0)
    heal.add_argument("--breaker-failures", type=int, default=3,
                      help="consecutive probe or connect failures that eject "
                           "a replica (the breaker opens)")
    heal.add_argument("--breaker-successes", type=int, default=2,
                      help="consecutive half-open successes that readmit it")
    heal.add_argument("--breaker-open-seconds", type=float, default=2.0,
                      help="open-breaker cooldown before half-open trials")
    heal.add_argument("--replica0-env", action="append", default=[],
                      metavar="KEY=VAL",
                      help="environment of replica 0's first launch only "
                           "(repeatable): arms a GLINT_FAULTS schedule "
                           "without re-arming it on the relaunch")
    heal.add_argument("--uncoordinated-watch", action="store_true",
                      help="every replica follows --watch-checkpoint itself "
                           "(the whole fleet swaps at once; no rolling "
                           "rollout, no canary)")
    can = p.add_argument_group(
        "shadow-canary promotion gate",
        "before a rolling rollout goes on, the candidate serves mirrored "
        "traffic on one held replica and must agree with the live fleet "
        "(top-k overlap); a regression is held back and counted, the "
        "candidate left on disk",
    )
    can.add_argument("--no-canary", action="store_true",
                     help="roll out without the canary gate")
    can.add_argument("--canary-mirror-every", type=int, default=4,
                     help="mirror every Nth live /synonyms or /analogy "
                          "request to the canary (default 4)")
    can.add_argument("--canary-min-scores", type=int, default=8,
                     help="responses to score before deciding (default 8)")
    can.add_argument("--canary-mirror-seconds", type=float, default=10.0,
                     help="most seconds to collect mirrored responses "
                          "(default 10)")
    can.add_argument("--canary-agreement", type=float, default=0.6,
                     help="mean top-k agreement the candidate must reach "
                          "(default 0.6)")
    can.add_argument("--canary-top-k", type=int, default=10)
    can.add_argument("--canary-probes", default=None, metavar="FILE",
                     help='JSON list of probe requests ([{"path": '
                          '"/synonyms", "body": {...}}, ...]) sent to the '
                          "live fleet and to the canary and scored for "
                          "agreement")
    fmm = p.add_argument_group(
        "model catalog",
        "every replica holds the same catalog behind the one balancer "
        "port; each watched model gets a rolling rollout and canary of its "
        "own",
    )
    _add_catalog_flags(fmm)
    fmm.add_argument("--watch-model", action="append", default=[],
                     metavar="ID=DIR",
                     help="publish directory of model ID, rolled out on its "
                          "own (repeatable; loads the model at its newest "
                          "generation unless --add-model names a start)")
    dp = p.add_argument_group(
        "demand-driven fleet",
        "balancer processes sharing the listen port, warm spares an "
        "autoscaler readmits on the shed rate, the p95 and the burn "
        "signals, and per-tenant QoS admission at the fleet's edge",
    )
    dp.add_argument("--balancer-procs", type=int, default=1,
                    help="balancer processes sharing the listen port "
                         "(SO_REUSEPORT, else an inherited listener fd); 1: "
                         "the balancer in the supervisor alone (default)")
    dp.add_argument("--warm-spares", type=int, default=0,
                    help="replicas more, launched and warmed at boot and "
                         "then held out of rotation; the autoscaler "
                         "readmits them under load (never a cold boot)")
    dp.add_argument("--autoscale-interval", type=float, default=0.5,
                    help="seconds between autoscaler evaluations "
                         "(default 0.5)")
    dp.add_argument("--autoscale-up-shed-rate", type=float, default=1.0,
                    help="fleet sheds a second (QoS sheds included) that "
                         "count as pressure (default 1)")
    dp.add_argument("--autoscale-up-p95-ms", type=float, default=None,
                    help="forward-path p95 in ms that counts as pressure "
                         "(default: GLINT_SLO_LATENCY_MS, else 250)")
    dp.add_argument("--autoscale-up-window", type=float, default=1.0,
                    help="seconds of pressure before a spare is readmitted "
                         "(default 1)")
    dp.add_argument("--autoscale-down-window", type=float, default=10.0,
                    help="seconds of calm before a live replica is parked "
                         "again (default 10)")
    dp.add_argument("--autoscale-cooldown", type=float, default=5.0,
                    help="least seconds between two autoscale transitions "
                         "(default 5)")
    dp.add_argument("--qos-tenant-rate", type=float, default=None,
                    help="per-tenant token bucket rate (requests a second "
                         "per balancer process; tenant from X-Glint-Tenant, "
                         "else 'default'); unset: no tenant quotas")
    dp.add_argument("--qos-tenant-burst", type=float, default=None,
                    help="per-tenant bucket depth (default twice the rate)")
    dp.add_argument("--qos-bulk-max-inflight", type=int, default=None,
                    help="in-flight cap of the bulk class (X-Glint-Priority: "
                         "bulk) per balancer process; unset: no cap")
    p = sub.add_parser(
        "fleet-shard",
        help="internal: one balancer process of `serve-fleet "
             "--balancer-procs N`, accepting on the shared fleet port and "
             "driven by the supervisor over a private control channel",
    )
    p.add_argument("--config", required=True, metavar="FILE",
                   help="the shard's configuration, written by the "
                        "supervisor")
    p = sub.add_parser(
        "trace-merge",
        help="stitch request-trace JSONL files (a serve-fleet --trace-dir, "
             "or any --trace-log and --event-log files) into one "
             "clock-anchored Chrome-trace / Perfetto timeline",
    )
    p.add_argument("inputs", nargs="+",
                   help="trace JSONL files, or directories (their *.jsonl "
                        "and rotated *.jsonl.1 files)")
    p.add_argument("--out", required=True,
                   help="the merged Chrome-trace JSON (ui.perfetto.dev or "
                        "chrome://tracing open it)")


def _parse_model_specs(pairs, flag: str):
    """``ID=DIR`` pairs of a repeatable flag (``cli.py:1187`` of the JAX
    package): a dict, or None after an error line (an id rides the
    ``/m/<id>/`` prefix, so it must be non-empty and /-free)."""
    out = {}
    for kv in pairs:
        mid, sep, d = kv.partition("=")
        if not sep or not mid or not d or "/" in mid:
            print(f"error: {flag} expects ID=DIR with a /-free id, got {kv!r}",
                  file=sys.stderr)
            return None
        out[mid] = d
    return out


def _run_serve_fleet(args) -> int:
    """``serve-fleet``: the JAX CLI's self-healing, canary, catalog and
    demand-driven groups. The process touches no device: the replicas
    load the tables."""
    from glint_word2vec_torch.fleet import (
        AutoscaleConfig,
        CanaryConfig,
        QosConfig,
        serve_fleet,
    )

    models = _parse_model_specs(args.add_model, "--add-model")
    if models is None:
        return 1
    model_watch_dirs = _parse_model_specs(args.watch_model, "--watch-model")
    if model_watch_dirs is None:
        return 1
    if args.model is None and args.watch_checkpoint is None:
        print("error: serve-fleet needs --model or --watch-checkpoint",
              file=sys.stderr)
        return 1
    flags = [
        "--max-batch", str(args.max_batch),
        "--cache-size", str(args.cache_size),
        "--max-inflight", str(args.max_inflight),
        "--request-deadline", str(args.request_deadline),
        "--degraded-after", str(args.degraded_after),
    ]
    if args.ann:
        flags += [
            "--ann",
            "--ann-clusters", str(args.ann_clusters),
            "--ann-nprobe", str(args.ann_nprobe),
            "--ann-iters", str(args.ann_iters),
            "--ann-sample", str(args.ann_sample),
            "--ann-recall-gate", str(args.ann_recall_gate),
            "--ann-recall-sample", str(args.ann_recall_sample),
        ]
    replica0_env = {}
    for kv in args.replica0_env:
        if "=" not in kv:
            print(f"error: --replica0-env expects KEY=VAL, got {kv!r}",
                  file=sys.stderr)
            return 1
        k, v = kv.split("=", 1)
        replica0_env[k] = v
    canary = None
    if ((args.watch_checkpoint is not None or model_watch_dirs)
            and not args.no_canary and not args.uncoordinated_watch):
        probes = None
        if args.canary_probes:
            with open(args.canary_probes) as f:
                probes = json.load(f)
            if not isinstance(probes, list):
                print('error: --canary-probes must be a JSON list of {"path", '
                      '"body"} objects', file=sys.stderr)
                return 1
        canary = CanaryConfig(
            mirror_every=args.canary_mirror_every,
            min_scores=args.canary_min_scores,
            mirror_seconds=args.canary_mirror_seconds,
            agreement_gate=args.canary_agreement,
            top_k=args.canary_top_k,
            probes=probes,
        )
    qos = None
    if (args.qos_tenant_rate is not None
            or args.qos_bulk_max_inflight is not None):
        qos = QosConfig(
            tenant_rate=args.qos_tenant_rate,
            tenant_burst=args.qos_tenant_burst,
            bulk_max_inflight=args.qos_bulk_max_inflight,
        )
    autoscale = None
    if args.warm_spares > 0:
        autoscale = AutoscaleConfig(
            min_live=args.replicas,
            max_live=args.replicas + args.warm_spares,
            interval=args.autoscale_interval,
            up_shed_per_sec=args.autoscale_up_shed_rate,
            up_p95_ms=args.autoscale_up_p95_ms,
            up_window_seconds=args.autoscale_up_window,
            down_window_seconds=args.autoscale_down_window,
            cooldown_seconds=args.autoscale_cooldown,
        )
    return serve_fleet(
        args.model,
        replicas=args.replicas,
        host=args.host,
        port=args.port,
        watch_dir=args.watch_checkpoint,
        watch_poll=args.watch_poll,
        replica_flags=flags,
        log_dir=args.replica_log_dir,
        trace_dir=args.trace_dir,
        port_file=args.port_file,
        max_restarts=args.max_restarts,
        backoff_base_seconds=args.backoff_base,
        backoff_cap_seconds=args.backoff_cap,
        hang_kill_seconds=args.hang_kill_after,
        probe_interval=args.probe_interval,
        probe_timeout=args.probe_timeout,
        breaker_failures=args.breaker_failures,
        breaker_successes=args.breaker_successes,
        breaker_open_seconds=args.breaker_open_seconds,
        canary=canary,
        coordinated=not args.uncoordinated_watch,
        replica_env_first_launch=({0: replica0_env} if replica0_env else None),
        models=models,
        model_watch_dirs=model_watch_dirs,
        model_memory_budget=args.model_memory_budget,
        device=args.device,
        warm_spares=args.warm_spares,
        autoscale=autoscale,
        balancer_procs=args.balancer_procs,
        qos=qos,
    )


def _run_fleet_shard(args) -> int:
    """``fleet-shard``: one balancer process of a multi-process data
    plane. It proxies bytes and touches no device."""
    from glint_word2vec_torch.fleet import run_balancer_shard

    return run_balancer_shard(args.config)


def _run_trace_merge(args) -> int:
    """``trace-merge``: directories expand to their (rotated included)
    ``.jsonl`` files, the merged document is written atomically, and the
    summary line says how many trace ids stitched across processes."""
    import glob
    import os

    from glint_word2vec_torch.obs.aggregate import merge_trace_logs
    from glint_word2vec_torch.utils import atomic_write_json

    paths = []
    for inp in args.inputs:
        if os.path.isdir(inp):
            paths += sorted(glob.glob(os.path.join(inp, "*.jsonl"))
                            + glob.glob(os.path.join(inp, "*.jsonl.1")))
        else:
            paths.append(inp)
    if not paths:
        print("error: no trace JSONL inputs found", file=sys.stderr)
        return 1
    doc = merge_trace_logs(paths)
    atomic_write_json(args.out, doc)
    other = doc["otherData"]
    print(json.dumps({
        "out": args.out,
        "events": len(doc["traceEvents"]),
        "trace_ids": other["trace_ids"],
        "stitched_traces": other["stitched_traces"],
        "sources": other["sources"],
    }))
    return 0


def _exit_on_sigterm() -> None:
    """Turn the SIGTERM a supervisor stops a replica with into an orderly
    exit: ``SystemExit`` in the main thread unwinds ``serve_model_dir``,
    whose ``finally`` closes the trace log's sink, so the spans it kept are
    on disk (the default action ends the process with the sink's buffer
    unwritten and skips ``atexit``). A second SIGTERM is ignored while the
    first unwinds; the supervisor's SIGKILL after its grace still ends a
    process that hangs there."""
    import signal

    def handler(signum, frame):
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, handler)


def main(argv=None) -> int:
    from glint_word2vec_torch.obs.canary import TrainingDiverged

    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    if args.cmd == "supervise":
        return _run_supervise(args)
    if args.cmd == "serve-fleet":
        # Device-free: only the replica processes load tables.
        return _run_serve_fleet(args)
    if args.cmd == "fleet-shard":
        # One balancer process: device-free like its parent.
        return _run_fleet_shard(args)
    if args.cmd == "trace-merge":
        # File stitching: no device, no model.
        return _run_trace_merge(args)
    if (args.cmd == "transform-file" and args.workers > 1
            and args.rank is None):
        return _run_transform_fleet(args)
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
        models = _parse_model_specs(args.add_model, "--add-model")
        if models is None:
            return 1
        _exit_on_sigterm()
        serve_model_dir(
            args.model, host=args.host, port=args.port,
            max_batch=args.max_batch, warmup=not args.no_warmup,
            cache_size=args.cache_size, port_file=args.port_file,
            device=args.device, watch_dir=args.watch_checkpoint,
            watch_poll=args.watch_poll, trace_log=args.trace_log,
            flight_dir=args.flight_dir, max_inflight=args.max_inflight,
            request_deadline=args.request_deadline,
            degraded_after=args.degraded_after, models=models,
            model_memory_budget=args.model_memory_budget,
            watch_models=args.watch_models, **_ann_kwargs(args),
        )
        return 0
    if args.cmd == "synonyms-dump" and args.out is None and args.graph_out is None:
        print("error: synonyms-dump needs --out and/or --graph-out",
              file=sys.stderr)
        return 1

    from glint_word2vec_torch.models import load_model

    device = args.device
    if args.cmd == "transform-file" and (args.world or 1) > 1:
        from glint_word2vec_torch.parallel.distributed import rank_device

        device = rank_device(device, args.rank or 0)
    model = load_model(args.model, device=device)
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
