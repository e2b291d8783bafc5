#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``glint_word2vec_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only 7      # phases 1, 2 and 7 (or "5,10", ...)

With ``--only`` it runs phases 1, 2 and the phases named, one after
another, prints their lines, and exits with code 4 without the kernels
line or the result line, so a partial run never passes for a whole one.

A whole run takes phases 1 and 2, then 3, 4, 5, 7 and 9 (a) one after
another on an otherwise idle card (the kernels line's times, the single
server's latencies), then two lanes at once: 9 (b) to (d) (printed as
``phase 9 (b)``), 6, 8, 10, 11, 12, 18 and 19 in this process, and 13 to 17 in a child process of its own (this
script with ``--lane-out``), whose lines are printed after lane A's.
Each process counts its own launches, so each phase's counts are its
own; the lanes' times, rates and latencies are taken beside the other
lane. A SIGTERM ends both lanes through their ``finally`` blocks.

Needs one CUDA card, ``nvcc`` and the repository's sources; imports
nothing of JAX. Phases, each of which fails the run on any error:

1. Device: the ``nvidia-smi`` name and power-limit line.
2. Build: every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``, one process
   per source, all started together.
3. Kernel against plain: ``gather_rows`` against ``gather_rows_reference``
   (bitwise) on fp32 and bf16 tables of 1,000,000 x 300 and an fp32 table
   of 10,000,000 x 300 (12 GB: row offsets past 2^31 elements), at
   N in {1, 64, 10,000} with duplicate ids and ids 0 and V-1; the
   kernel's, the plain version's and ``torch.index_select``'s median time
   beside the bound (bytes moved over 3.35 TB/s), and the launch's waves
   (its blocks over the blocks the card holds at once); at N = 10,000 on
   1,000,000 rows also the kernel and ``index_select`` after an L2 flush
   that reads instead of writes (no dirty lines to write back).
4. Serve: a planted 1,000,000 x 300 fp32 model (random rows, word pairs
   whose rows are near copies, one analogy quadruple), saved with the
   port, served by ``serve_model_dir`` on an ephemeral port and asked
   through every endpoint; the answers must be the planted ones, and the
   kernel's launch count must grow on that served path. Request latency
   with 1 and 16 clients (host clock), and the card's busy share under
   16 clients (``torch.profiler``). The server records request traces
   (``trace_log``); 16-client windows with and without the recorder, in
   turns, give what tracing costs. (a) ``/metrics`` counts every request
   the phase sent, per endpoint; (b) its Prometheus text passes
   ``lint_prometheus_text`` and carries exemplars; (c) a POST with
   ``X-Glint-Trace`` that answers 404 is on ``/trace``. Then a second
   server over the planted model: (d) 64 clients released together, 4
   cache-miss ``/synonyms`` each, against ``max_inflight=8``: 429s with
   ``Retry-After: 1``, the shed count on ``/metrics``, the admitted
   requests' p50 and p95, and ``gather_rows`` launched once a coalesced
   dispatch, never for a shed request; (e) ``serving.dispatch`` delayed
   2 s past a 0.5 s deadline: the requests behind it answer 504 without a
   dispatch; (f) the device lock held past ``degraded_after``: a cached
   word answers 200 from the cache, a miss 429, ``/healthz`` says
   ``degraded`` and then ``ok``.

5. Training kernels against plain, at full width (V = 1,000,000,
   d = 300, P = 3,277 pair slots, n = 5; fp32 and bf16), on Zipf-like ids
   that include 0 and V-1 and give long runs: ``pair_forward`` within
   rtol 1e-5 (its ``h`` rows bitwise, the loss within rel 1e-5, two calls
   bitwise equal), the scatters ``scatter_add_rank1_hbm`` and
   ``scatter_add_rows_f32`` bitwise against their plain versions run on a
   CPU copy of the touched rows, plus one fp32 scatter and one
   ``pair_forward`` (reading row V-1) on a 10,000,000 x 300 table. Each
   kernel's median time beside its plain version's, ``index_add_``'s
   where one call computes the same function, the bound, and the run
   count R; ``pair_forward``'s launch shape and waves, and
   ``scatter_add_rank1_hbm``'s longest run and its runs of 32 or more.
   For ``pair_forward`` also, each held and timed: (b) 4 x P pairs, (c)
   every id one row (reads from L2). For ``scatter_add_rank1_hbm`` also,
   each bitwise, two calls equal, and timed: (a) the runs of 32 or more
   sent to distinct rows, (b) those runs alone, (e) the runs under 32
   alone. For ``scatter_add_rows_f32`` also, each bitwise and timed
   beside ``index_add_``: (a) the runs of 32 or more sent to distinct
   rows, (b) those runs alone, (c) one update (the launch floor), (d)
   the shared step's pool update (``d_pool`` of ``pair_forward_shared``
   into syn1 at a Zipf pool of 4,096), (e) the centers of one packed
   step of phase 6's corpus. The counter-based draws of
   ``ops/random.py`` must come out bitwise the same on the card as on
   the CPU. ``pair_forward``'s tiled form (rows past the one-pass form's
   shared memory): at phase 5's shape bitwise the one-pass form's, and at
   d = 20,000, n = 5 (100,000-row tables) and d = 2,200, n = 25
   (1,000,000 rows), fp32 and bf16, entries at about 1/sqrt(d):
   ``pair_forward`` and ``pair_forward_tiled`` each within rtol 1e-5 of
   the plain version, two calls bitwise, the two bitwise equal, timed
   beside the plain version and the bound.
6. Train: (a) ``Word2Vec().fit_file`` on a seeded synthetic corpus of
   10,000,000 tokens over 1,000,000 words (each at least 5 times, the rest
   Zipf(1.0), sentences of 20 words) at d = 300, W = 5, B = 1024, n = 5,
   fp32, one epoch, with every launch counter zeroed just before; it must
   take the native host pass (its ingestion and alias build, by the
   counters of ``native.calls``); words/s, and the card's busy share and
   top kernels in a profiled window of 48 steps; the ingestion of the
   corpus's first 2,000,000 tokens and the alias build at 1,000,000
   words, native and Python, equal outputs; (b) the ``tiny_corpus`` quality gates of
   ``tests/test_model_e2e.py`` on the card, with fp32 and with bf16
   tables; (c) two epochs straight equal,
   bitwise, one epoch plus a resume from its checkpoint plus one epoch;
   (d) ``find_synonyms`` on the trained 1,000,000 x 300 model, which runs
   ``gather_rows``; (e) the reference's PySpark surface,
   ``ServerSideGlintWord2Vec`` at vectorSize 100 with 4 partitions x 2
   parameter servers, on the ``tiny_corpus``: the topology clamps to the
   one card with the JAX layer's warning, the fit launches
   ``pair_forward``, ``scatter_add_rank1_hbm`` and
   ``scatter_add_rows_f32``, passes the gates of ``tests/test_compat.py``
   and the vienna/berlin gates, and a save loads back equal.
7. The composed step's kernels against plain, at full fastText width
   (3,000,000 x 300 tables: 1,000,000 words and 2,000,000 n-gram
   buckets; fp32 and bf16): ``scatter_add_rows`` on the B·S = 32,768 syn0
   ids of 1,024 subword groups of 32 (padded slots at row 0) and
   ``scatter_add_rank1`` on the B·C·(1+n) syn1 ids of a grid step (C = 7
   at W = 5, and C = 10: N = 43,008 and 61,440; padded context slots at
   row 0 with zero coefficients), each bitwise against its plain version
   on a CPU copy of the touched rows; median times, the plain version's,
   ``index_add_``'s for ``scatter_add_rows`` in fp32, the bound, the run
   count R and the longest run. For ``scatter_add_rows`` also: the same
   ids with every update non-zero (magnitudes 1e-3, 1 and 100, so row 0's
   run of 9,262 adds rounds under bf16), bitwise; the time of the id sort
   (``sorted_runs``, which ``index_add_`` does without); and, each bitwise
   and timed, (a) the padded slots sent to distinct rows, (b) the longest
   run alone and (c) the syn1 ids of the shared-pool composed step (the
   context ids, then a pool of 4,096 draws: several long runs). For
   ``scatter_add_rank1`` also, each bitwise (signed zeros too), two calls
   equal, and timed: (a) the padded context slots sent to distinct rows,
   (b) one run of the longest run's length alone on row 0 (coefficients
   of magnitudes 1e-3, 1 and 100), (c) the C = 10 ids, (d) the runs of 32
   or more but row 0's, (e) the runs under 32, (f) the runs of 2 to 31;
   ``index_add_`` of the payload made beforehand (fp32) and the longest
   run's add chain at 4 cycles an add; and a run of zero and non-zero
   coefficients onto rows of -0.0, where skipping a zero-coefficient
   update would flip a sign. (g) ``train_step`` and ``train_step_grouped``
   (groups of 4) on copies of one 1,000,000 x 300 fp32 table pair: loss
   and tables bitwise ``train_steps_grouped`` with K = 1 on the same batch
   and draws, and ``gather_rows``, ``scatter_add_rank1`` and
   ``scatter_add_rows`` launched. (h) ``ops/sgns.py``'s step functions:
   ``train_step_pairs_fused`` on one full-width packed pair batch (fp32
   1,000,000 x 300 tables) against the port's composed
   ``train_step_pairs`` on the same draws (rtol 2e-5, atol 1e-6; loss
   rel 1e-5), launching ``pair_forward``, ``scatter_add_rank1_hbm`` and
   ``scatter_add_rows_f32``; ``train_step`` and ``sgns_loss`` on a
   (B, C) window batch on the card against their CPU runs on the same
   tables and draws (same tolerances).
8. fastText and the host batcher: (a) ``FastTextWord2Vec().fit_file`` on
   phase 6's corpus at that width, fp32, one epoch, with every launch
   counter zeroed just before (``scatter_add_rows`` and
   ``scatter_add_rank1`` once a step, ``gather_rows`` on every pull) and
   the native host pass taken (ingestion, alias build, batcher); its
   words/s, and steps/s, busy share and top kernels of 48 composed steps;
   a fit through the Python host pass (``GLINT_W2V_NO_NATIVE=1``) over the
   corpus's first 2,000,000 tokens, its words/s and the consumer's stall
   (``host`` seconds);
   (b) the ``tiny_corpus`` gates of ``tests/test_fasttext.py`` in fp32 and
   bf16 (OOV cosine, no bucket row in a top-k, save and ``load_model``
   keep the vectors); (c) word2vec through the host batcher (the script
   reports no free device memory): the vienna/berlin gates in fp32 and
   bf16, and bitwise resume; (d) the fp32 model of (b) served by
   ``serve_model_dir``: ``/vector`` of an OOV word equals ``transform``
   and ``/synonyms`` equals ``find_synonyms``.
9. The shared negative pool: (a) ``pair_forward_shared`` against its
   plain version (whose three products run through cuBLAS in fp32) at
   full width, P = 3,277, n = 5: 1,000,000 x 300 fp32 and bf16 tables at
   S = 4,096, fp32 at S = 5 and 257, and an fp32 10,000,000 x 300 table;
   Zipf ids with 0 and V-1, a pool with repeats and context collisions.
   ``h`` bitwise, ``c_pos`` within rtol 1e-5 (atol 1e-6 x max),
   ``d_center`` and ``d_pool`` within rtol 1e-4 and atol 1e-6 (sums of
   4,096 and 3,277 fp32 terms in another order), the loss within rel
   1e-5; median time, the plain version's and the bound (the split-TF32
   passes over 495 TFLOP/s, with the FFMA figure, fp32 operations over
   67 TFLOP/s, beside it); at S = 4,096 on 1,000,000 rows also each
   launch's device time, TFLOP/s (``torch.profiler``) and waves and
   ``torch.matmul`` on each of the three products, and in fp32 and bf16
   two calls bitwise equal and ``d_center`` and ``d_pool`` within 10
   times the plain version's norm-wise error against float64 on the card; (b) ``Word2Vec().set_shared_negatives(4096)
   .fit_file`` on the first 2,500,000 tokens of phase 6's corpus, every
   word kept (824,820 x 300), fp32, one epoch, with
   every launch counter zeroed just before: ``pair_forward_shared`` once
   a step, ``pair_forward`` never, ``scatter_add_rank1_hbm`` once and
   ``scatter_add_rows_f32`` twice a step; words/s, busy share and top
   kernels of 48 steps; (c) the ``tiny_corpus`` gates of
   ``tests/test_shared_negatives.py`` (germany -> berlin, france ->
   paris) with a pool of 256, in fp32 and bf16, on the resident route
   and through the host batcher (where ``gather_rows`` pulls the pool
   and ``scatter_add_rows`` lands both tables), and fastText's OOV gate
   with the pool; (d) bitwise resume with the pool.
10. Grid packing, mid-epoch resume and wide rows: (a)
   ``Word2Vec(batch_packing="grid").fit_file`` on the first 5,000,000
   tokens of phase 6's corpus at its width (every word kept), fp32, one
   epoch on the device corpus, every counter zeroed just before: ``gather_rows`` three times, ``scatter_add_rank1`` and
   ``scatter_add_rows`` once a step, ``pair_forward`` never; words/s, and
   steps/s, busy share and device time a step of 48 grid steps; (b) the
   ``tiny_corpus`` gates under grid packing; (c) the mid-epoch drill at
   d = 300 over the corpus's first 1,000,000 tokens, every word kept
   (``GLINT_PACKED_STOP_AFTER_GROUPS=3``, then a resume from the
   checkpoint's position) equal to the uninterrupted epoch bitwise; (d)
   ``Word2Vec().fit_file`` at d = 2,200, n = 25 and d = 20,000, n = 5
   over the first 100,000 tokens of phase 6's corpus (every word kept),
   one epoch, every ``pair_forward`` launch in the tiled form.
11. The stall-free loop and its hooks: a checkpointed two-epoch
   ``Word2Vec(subsample_ratio=1e-3).fit_file`` on the first 1,250,000
   tokens of phase 6's corpus, every word kept (569,250 x 300), twice, with every counter zeroed just before each: (a) the
   defaults (deferred readbacks, asynchronous checkpoints, the next
   epoch's compaction prefetched) with the event log, status file,
   heartbeat (polled for ``/healthz`` and the Prometheus ``/metrics``
   mid-fit), canary ``warn`` and step-time file on; (b)
   ``GLINT_SYNC_READBACK=1 GLINT_SYNC_CKPT=1 GLINT_NO_COMPACT_PREFETCH=1``
   with only the step-time ledger. ``pair_forward``,
   ``scatter_add_rank1_hbm`` and ``scatter_add_rows_f32`` launch 16 times
   a dispatched group (in (a) one zero-pair phantom group an epoch more
   than in (b)); the tables of (a) and (b) are equal bitwise, with equal
   steps, words and pairs; (c) a resume from (a)'s epoch-1 asynchronous
   checkpoint equals (a) bitwise; one packed group is enqueued from a
   device-scalar start with no host-device synchronization (CUDA sync
   debug mode "error"); and a canary ``abort`` drill on ``tiny_corpus``
   with NaN tables raises, writes ``ckpt-diverged`` and leaves no
   ``train_state.json``. Words/s, ``device_stall_seconds``, the
   ``ckpt_snapshot`` and ``ckpt_write`` seconds and the step-time
   ledger's phases of both runs. Phase 6 also measures the peak of a
   compaction prefetched while a compacted view is active, enqueued
   with no synchronization.
12. The ANN index and the bulk transform, on a 1,000,000 x 300 fp32
   model of 4,096 seeded Gaussian centres with spread 0.25: (a) the model
   built and saved; (b) ``configure_ann()`` at its defaults (1,024
   clusters x 2,048 slots, nprobe 8, 6 sweeps of 65,536 sampled rows) and
   ``ann_build`` with every counter zeroed just before (``gather_rows``
   must launch, ``scatter_add_rows`` once a sweep block), its seconds by
   stage, spilled rows and block bytes, a second build bitwise the
   first, the member blocks bitwise ``gather_rows_reference`` on the
   members' ids, and two sweep blocks' ``scatter_add_rows`` on the
   (1,024, 301) accumulator bitwise ``scatter_add_rows_reference``; (c)
   recall@10 against exact at nprobe 8 and 32 on 64 and 1,024
   sampled rows, nprobe = C equal to ``top_k_cosine_batch`` on a
   65,536-row prefix, the device time (CUDA events) of one search, of its
   block gather alone and of the exact path at Q = 1, 8, 16, k = 10, both
   entry points' host time, and a refresh through ``write_rows``; (d) the
   saved model served by ``serve_model_dir(ann=True)``: ``/healthz``'s gate
   fields against (c)'s recall and the 0.95 gate, ``exact=true`` answers
   equal to ``find_synonyms``, ``/synonyms`` latency over 200 cache misses
   with 1 and 16 clients for the ANN path and for ``exact=true``; (e) the
   CLI's ``transform-file`` over 100,000 seeded lines of 0 to 64 Zipf
   words with OOV tokens (rows 1,024, max_len 256, shards of 8,192):
   sentences/s and ``gather_rows`` launches, one batch's ``_pull_rows``
   bitwise ``index_select``, the first 4,096 rows bitwise
   ``transform_sentences``, a fault at the third shard commit then a
   resume bitwise the run without it, and ranks 0 and 1 of 2 concatenated
   bitwise the same; (f) ``synonyms_dump`` of the first 65,536 words,
   exact, then through an index built and adopted as ``synonyms-dump
   --ann`` does it (the queries ``ann.search`` takes are counted: none,
   then every word): words/s and the share of top-10 neighbours they
   agree on.
13. Streaming training and the serving hot swap, at phase 6's width on
   the first 5,000,000 tokens of its corpus (a prefix for the script's
   time limit): (a) a ``fit_stream`` trainer thread (bootstrap 3,500,000
   tokens, min_count 1, 65,536 spare rows, a 65,536-word buffer, a
   publish every 1,250,000 words, 2 generations kept), every counter
   zeroed just before, and in the same process a ``ModelServer`` booted
   from gen-000001 with ``ann=True`` that watches the publish directory
   (poll 0.5 s) and rebuilds and gates the index on every swap, under 4
   closed-loop ``/synonyms`` clients (a child process) asking distinct
   base words (cache misses) and, every eighth request, one word first
   seen after the bootstrap. The stream is held while
   the server lags more than one generation (so each generation is
   swapped in under load; the hold is printed and left out of words/s).
   At least 3 swaps and no failure, no 5xx or dropped response, the late
   word 404 then 200 for every client, no new query shape after the
   warmup, at least 10,000 promotions, ``queryable_rows`` equal to the
   vocabulary, finite tables, ``pair_forward``, ``scatter_add_rank1_hbm``
   and ``scatter_add_rows_f32`` launched, and ``gather_rows`` and
   ``scatter_add_rows`` launched by the swaps' index builds; words/s,
   rounds, fill seconds a round, ``device_stall_seconds``, each publish's
   snapshot and write seconds, each swap's stage, index, gate and flip
   seconds, and ``/synonyms`` p50/p95 over the run and inside the swap
   windows; (b) the last (partial) round's first packed group run again
   from its captured tables through the kernels and through a
   ``device="cpu"`` engine: pair counts and positions equal, tables within
   rtol 1e-4 and atol 1e-6, and in its first step that touches promoted
   rows ``pair_forward`` held as in phase 5 and the two scatters bitwise;
   (c) ``cli fit-stream`` on the card over the shifted ``tiny_corpus``,
   SIGKILLed by ``GLINT_FAULTS=publish.pre_pointer:kill@2``: LATEST stays
   on gen-000001, gen-000002 is complete and a watcher refuses it, a
   second run numbers past it and passes vienna in austria's top 10.
14. The replica-exchange gang, at ``configs[1]``'s width on phase 10
   (a)'s 5,000,000-token prefix (981,169 x 300, fp32): (a) two replica
   engines on the card, from identical tables, each training its
   round-robin shard in packed groups under its rank-folded key, through
   ``parallel/exchange.sync_group`` over 8 groups: fp32 sparse every
   group, with a dense pair beside it over the first 4 (equal then), bf16
   and int8 sparse every 4 groups; the replicas bitwise equal after every
   round; rank 1's first step holds B4, B7 and B6 as phase 5 does; a
   round's seconds by device stage (diff, encode, copy to host, apply;
   CUDA events), the touched rows against the capacity, the bytes by
   wire; one more fp32 round's payloads applied by the card (B3) and by a ``device="cpu"``
   engine on fp32 and bf16 tables, bitwise, and B3 alone at that shape
   (capacity rows, the padding a long zero run on row 0, an fp32
   accumulator) bitwise its plain version and timed beside
   ``index_add_``; (b) ``cli supervise --workers 2 train --exchange sparse
   --exchange-wire int8 --exchange-every 4`` over the corpus's first
   1,250,000 tokens (every word kept, 300 wide), two epochs, checkpointed, both ranks
   on the card, rank 1 SIGKILLed early in its second epoch
   (``GLINT_FAULTS=exchange.pre_send:kill@N``, first generation only):
   one restart from ``ckpt-1``, the ranks' table hashes equal, the model
   loads; words/s a rank, exchange bytes and ``exchange_sync`` seconds a
   round, the capacity's adaptation, ``device_stall_seconds``, and each
   rank's launches (B4, B6, B7 and B3 must launch), and phase 19 (f) on
   its files: each rank's event log of each generation opens with a clock
   anchor carrying that generation's gang trace id, and the gang scrape
   rebuilt from the ranks' status files has
   ``glint_gang_checkpoint_shard_verify_seconds`` and the id as its
   step-time exemplar; (c) a two-rank
   ``--exchange sparse`` gang on ``tiny_corpus`` held to the vienna and
   berlin gates; (d) ``transform-file --workers 2`` over phase 12's
   100,000 lines under the supervisor, bitwise ``--workers 1``. Each of
   (a), (b) and (c) with (d) prints its peak host memory (this process
   and its children, and the machine's used), (a) this process's pinned
   bytes before and after their release, (b) each rank's peak resident
   set, pinned peak and the bytes its exchange keeps.
15. The model catalog: three planted 1,000,000 x 300 fp32 models (phase
   4's construction with seeds 300, 301 and 302), each saved (2.4 GB with
   syn1); one in-process ``ModelServer`` with the first as its default
   model (pinned) and the other two added as ``s301`` and ``s302`` under a
   budget of 2.5 models' ``resident_bytes``, so at most two are resident.
   8 clients send 6 cache-miss ``/m/<id>/synonyms`` each, round robin
   over the three ids, with every counter zeroed just before: (a) every
   response 200; (b) each answer the top 10 of its own model's table,
   computed with the plain gather and plain products; (c) at least 2
   evictions and 2 stage-ins, no fewer cold hits than stage-ins, at most
   two models resident after every stage-in (each timed); (d)
   ``max_memory_allocated`` (reset before the drill) under the budget plus
   1 GiB, and an eviction lowering ``memory_allocated`` by the model's
   ``resident_bytes`` within 1 %; (e) ``query_program_builds`` unmoved as
   the two same-shape models load, their warmups all
   ``shared_program_hits``; (f) ``gather_rows`` launched once a coalesced
   dispatch. Also the default model's ``/synonyms`` p50/p95 alone and
   while another model stages in (its copies on a side stream), the
   ``/models`` document, and the Prometheus text lint-clean with the
   ``glint_model_*`` and ``glint_catalog_*`` families.
16. The self-healing fleet: ``cli serve-fleet --replicas 2
   --watch-checkpoint PUB --add-model b=<phase 15's seed-302 model>
   --canary-mirror-seconds 3`` on the card, generation 1 in PUB phase 15's
   seed-300 model (hard links), 4 closed-loop clients through the
   balancer throughout: (a) each replica's ``/healthz`` names the card
   and the catalog, and ``/m/b/synonyms`` through the balancer
   answers model b's top 10; (b) replica 1 SIGKILLed under traffic,
   relaunched under a new ``GLINT_FLEET_GEN``, its breaker opened and then
   closed again; (c) generation 2 (generation 1 plus 1 % noise) promoted
   by the canary and rolled out one replica at a time, the balancer never
   below one replica in rotation, both replicas on generation 2; (d)
   generation 3 (a fresh random table) held back by the canary, both
   replicas left on generation 2; every client request 200 with no
   connection error; (e) the merged ``/metrics`` lint-clean, and in each
   replica ``gather_rows``'s launches since its warmup equal to its
   coalesced dispatches. Prints the fleet's boot and the relaunch
   seconds, the kill window's client p95, each rollout step's seconds and
   the canary's agreement for generations 2 and 3. ``--only 16`` runs 15
   first.
17. The demand-driven fleet: ``cli serve-fleet --replicas 1 --warm-spares 1
   --balancer-procs 2 --model <phase 15's seed-300 model> --max-inflight 4
   --qos-tenant-rate 20 --qos-tenant-burst 10 --qos-bulk-max-inflight 2
   --autoscale-interval 0.25 --autoscale-up-shed-rate 1
   --autoscale-up-window 0.5 --autoscale-down-window 4
   --autoscale-cooldown 1 --trace-dir T`` on the card, every request on a
   new connection: (a) one live replica and one spare parked by the owner
   ``autoscale``, a ``fleet-shard`` process up, 200 cache-miss
   ``/synonyms`` all 200 and proxied by both balancer processes
   (``glint_fleet_shard_proxied_total``), and only the replicas hold
   ``/dev/nvidia*`` files (no shard, no supervisor; ``nvidia-smi``'s compute
   pids printed beside them); (b) 32 closed-loop clients past the
   replica's ``--max-inflight``: the shed rate readmits the spare
   (``scale_ups_total`` 1), whose ``gather_rows`` launches rise; then one
   slow client, and the spare is parked again (``scale_downs_total`` 1)
   and launches nothing more; the seconds from the surge to the
   readmission and from the calm to the parking; (c) 60 requests of one
   tenant at once: ``tenant_quota`` sheds, the admitted no more than 2 x
   (10 + 20 x the seconds); 8 ``X-Glint-Priority: bulk`` at once:
   ``bulk_inflight`` sheds; ``X-Glint-Deadline-Ms: 1``: ``deadline`` sheds
   with the replicas' dispatches unmoved (their p50 printed); (d) shard 1
   SIGKILLed under 4 clients, relaunched, and proxying fresh connections
   again (the kill window's connection errors and the seconds printed);
   (e) the merged ``/metrics`` lint-clean with the ``glint_fleet_shard_*``,
   ``glint_fleet_qos_*`` and ``glint_fleet_autoscale_*`` families, and
   each replica's ``gather_rows`` launches since its warmup equal to its
   dispatches; (f) ``POST /shutdown`` leaves no process of the fleet, then
   ``trace-merge T`` has a lane per balancer process and per replica and
   a trace stitched across a balancer and a replica lane. Every shed is a
   429 with ``Retry-After``, no answer is a 5xx, and no connection fails
   outside the kill window. ``--only 17`` runs 15 first.
18. The SPMD mesh on one card, every shard on it: (a) one group of steps
   on a (1, 2) ``rows`` and a (2, 2) ``dims`` mesh (grid batches: B1, B2,
   B3 shard by shard) and on a (2, 1) ``rows`` mesh (packed: B4, B7, B6,
   then B5 with a pool of 4,096), each from a 1 x 1 engine's tables at
   1,000,000 x 300 fp32 with the same draws and held against that
   engine's steps (rtol 1e-5, atol 1e-6), the counters zeroed just before
   each, every launch credited to the model shard whose table it ran on,
   and every shard launching every kernel of its path; each kernel against its
   plain version at the shards' shapes (column slices 150, 38 and 2
   wide); (b) ``Word2Vec(num_partitions=2, num_shards=2, layout="dims")
   .fit_file`` on the corpus's first 1,000,000 tokens, its column-block
   save reloaded onto 1 x 1 and onto (1, 2) ``rows`` with equal tables,
   and its synonyms and batched top-k against the 1 x 1 load's; (c) a
   supervised two-process mesh gang (``train --exchange none
   --num-partitions 2 --num-shards 2``, gloo) over the first 100,000
   tokens, rank 1 killed in its second epoch, resumed from ``ckpt-1``,
   the ranks' tables equal; the gang runs in processes of its own beside
   (a) and (b).
19. The route knobs and the last keywords, at ``configs[1]``'s width on
   the corpus's first 1,250,000 tokens (569,250 x 300, fp32), in lane A:
   (a) ``GLINT_HOST_BATCHER=1`` fits it through the host batcher (B1, B2,
   B3) with a checkpoint, ``GLINT_DEVICE_CORPUS_MAX_BYTES=1`` sends the
   tiny corpus to the host, and with neither it takes the resident packed
   path (B4, B6, B7), words/s of both routes printed; the first call of
   each kernel held against its plain version on its own inputs; (b) the
   checkpoint loaded three times, timed: with the deep check, under
   ``GLINT_CKPT_NO_VERIFY=1`` and with ``verify=False``; a copy with a
   byte flipped in a table file refused by the deep check alone, then
   truncated and refused by every check; (c) ``EmbeddingEngine.load(...,
   shared_negatives=4096)`` of it runs two packed groups (B5, B6, B7),
   and again with ``span=`` the default span, bitwise; (d) the tiny
   corpus's second epoch resumed from the legacy layout (``ckpt/syn0.npy``,
   ``ckpt/syn1.npy``, no ``"ckpt"`` in ``train_state.json``), bitwise the
   resume from the snapshot directory; (e) ``ModelServer(warm_ks=(16, 32,
   64))`` answers ``num=50`` with no new shape (B1), and
   ``serve_model_dir(..., ann=True, ann_nprobe=8)`` starts through its
   named keywords and builds the index; (f) is on phase 14 (b)'s gang.
   The counters are zeroed before each path and every kernel must launch.

After each phase it prints ``phase N: S s``, after lane B's lines its
seconds, and before the kernels line the whole script's seconds. It prints one JSON ``kernels`` line (each
kernel with ``launches_catalog``, ``launches_fleet`` and
``launches_demand``, its launches in phases 15, 16 and 17, and its
launches in phase 18's meshes, fit and gang, those of the meshes and the
fit also by model shard, and its launches in phase 19 with the error of
its held first call there), the
``nvidia-smi`` line, and as its last line ``{"ok": true, "device":
{...}}``. Without a CUDA device it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import multiprocessing
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12
V_SERVE, D = 1_000_000, 300
V_BIG = 10_000_000
GATHER_NS = (1, 64, 10_000)
TIMED_TRIALS = 25
#: Requests per latency sample: p95 of 200 has 10 samples beyond it.
SEQ_REQUESTS = 200
#: Phase 4 (d): clients of the overload burst, requests each, and the
#: drill server's admission bound.
DRILL_CLIENTS, DRILL_PER_CLIENT, DRILL_INFLIGHT = 64, 4, 8
#: H100 SXM fp32 rate outside the tensor cores (NVIDIA data sheet), flop/s.
FP32_FLOPS = 67e12
#: H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet), flop/s.
TF32_FLOPS = 495e12
#: Exit code of a partial run (``--only``): never that of a passing run.
PARTIAL_EXIT = 4
#: Full width of the training slice: BASELINE.json configs[1]
#: (en-Wikipedia, 1M vocab, 300-dim, 5 negatives), one card.
V_TRAIN, N_NEG, B_TRAIN, W_TRAIN = 1_000_000, 5, 1024, 5
CORPUS_TOKENS, MIN_PER_WORD, SENTENCE_LEN = 10_000_000, 5, 20
#: Packed groups (of steps_per_call = 16 steps) in the profiled window.
PROFILE_GROUPS = 3
#: fastText at the geometry of its published English vectors: fastText's
#: own defaults -bucket 2000000 -minn 3 -maxn 6, max_subwords 32, over the
#: same 1M-word vocabulary and d = 300.
FT_BUCKET, FT_SUBWORDS = 2_000_000, 32
#: The shared negative pool of the JAX package's throughput and quality
#: runs (``bench.py:105``, ``scripts/reference_quality.py:135``).
S_POOL = 4096
#: Tokens of phase 10's fits at d = 2,200 and 20,000 (a prefix of phase 6's
#: corpus).
WIDE_TOKENS = 100_000
#: Tokens of phase 6's and phase 8's Python host passes and of phase 10's
#: mid-epoch drill (prefixes of phase 6's corpus).
PY_PASS_TOKENS = 2_000_000
DRILL_TOKENS = 1_000_000
#: Tokens of phase 10 (a)'s grid fit: a prefix of phase 6's corpus.
GRID_TOKENS = 5_000_000
#: Phase 9 (b)'s shared-pool fit and phase 11's fits: the corpus's first
#: tokens.
SHARED_TOKENS = 2_500_000
STALL_TOKENS = 1_250_000
#: The whole run: after phases 1 and 2, SERIAL_PHASES one after another on
#: an otherwise idle card and host (the kernels line's own times, and the
#: single server's latencies), then two lanes at once, each a process of
#: its own with its own launch counters: LANE_A (after phase 9's fit) in
#: this process, LANE_B in a child (``--lane-out``), whose lines follow
#: lane A's. Every number of the lanes is taken beside the other lane.
SERIAL_PHASES = (3, 4, 5, 7, 9)
LANE_A = (6, 8, 10, 11, 12, 18, 19)
LANE_B = (13, 14, 15, 16, 17)
#: Seconds from the script's start after which lane B is given up.
LANE_DEADLINE = 1150.0
#: The card the script runs on; the port's entry points default to it.
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def python_host_pass():
    """Within the block the port's host pass runs in Python
    (``GLINT_W2V_NO_NATIVE=1``): the numpy batcher, the Python alias loop
    and the Python ingestion."""
    before = os.environ.get("GLINT_W2V_NO_NATIVE")
    os.environ["GLINT_W2V_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("GLINT_W2V_NO_NATIVE", None)
        else:
            os.environ["GLINT_W2V_NO_NATIVE"] = before


def native_calls_since(before: dict) -> dict:
    """The native host pass's calls, by wrapper, since ``before`` (a copy
    of ``native.calls``)."""
    from glint_word2vec_torch import native

    return {k: native.calls[k] - before.get(k, 0) for k in native.calls}


# ----------------------------------------------------------------------
# Phase 3: kernel against plain version
# ----------------------------------------------------------------------


def gather_ids(torch, n: int, v: int, gen):
    """``n`` int32 ids on the card with ids V-1 and 0, and duplicates."""
    ids = torch.randint(0, v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids[0] = v - 1
    if n > 2:
        ids[1] = 0
        ids[2] = v - 1
    if n > 8:
        ids[3:8] = ids[8]
    return ids


def median_ms(torch, fn, flush, clean=False) -> float:
    """Median device time of one ``fn()`` call over ``TIMED_TRIALS``
    calls, each after a write of ``flush`` that evicts the 50 MB L2, so
    the table rows come from device memory as a served query finds them.
    A ~1 ms device-side sleep ahead of the start event lets the host
    enqueue the whole call before the device reaches it, so the window
    holds device time only, not the wrapper's host time. With ``clean``
    the flush reads ``flush`` instead, which leaves the L2 holding clean
    lines: nothing ``fn`` brings in then has to write an evicted line
    back to device memory first."""
    fn()
    times = []
    for _ in range(TIMED_TRIALS):
        if clean:
            flush.view(torch.int32).amax()
        else:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_gather(torch, rows_mod) -> dict:
    """Phase 3. Returns the per-case results, keyed by (dtype, V, N)."""
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    cases = [(torch.float32, V_SERVE), (torch.bfloat16, V_SERVE),
             (torch.float32, V_BIG)]
    for dtype, v in cases:
        table = torch.randn((v, D), generator=gen, device="cuda").to(dtype)
        for n in GATHER_NS:
            ids = gather_ids(torch, n, v, gen)
            out = rows_mod.gather_rows(table, ids)
            torch.cuda.synchronize()
            ref = rows_mod.gather_rows_reference(table, ids)
            if out.shape != (n, D) or out.dtype != torch.float32:
                raise AssertionError(f"gather_rows gave {out.dtype} {tuple(out.shape)}")
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"gather_rows differs from its plain version at "
                    f"{dtype} V={v} N={n}: max |diff| "
                    f"{(out - ref).abs().max().item()}"
                )
            err = (out - ref).abs().max().item()
            ms = median_ms(torch, lambda: rows_mod.gather_rows(table, ids), flush)
            plain = median_ms(
                torch, lambda: rows_mod.gather_rows_reference(table, ids), flush
            )
            library = median_ms(
                torch, lambda: torch.index_select(table, 0, ids), flush
            )
            # Bytes the gather must move: each distinct row read once, the
            # ids read, the fp32 rows written. No arithmetic to count.
            uniq = int(torch.unique(ids).numel())
            nbytes = uniq * D * table.element_size() + 4 * n + n * D * 4
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            name = "f32" if dtype == torch.float32 else "bf16"
            blocks, per_sm, sms = rows_mod.gather_rows_grid(n, dtype)
            waves = blocks / (per_sm * sms)
            results[(name, v, n)] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "library_ms": library, "bound_ms": bound, "bytes": nbytes,
                "waves": waves,
            }
            log(f"gather_rows {name} V={v} d={D} N={n}: bitwise equal; "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"index_select {library:.4f} ms, bound {bound:.5f} ms "
                f"({nbytes} bytes at 3.35 TB/s); {blocks} blocks, "
                f"{per_sm} an SM on {sms} SMs: {waves:.3f} waves")
            if n == GATHER_NS[-1] and v == V_SERVE:
                # The same calls after an L2 flush that leaves no dirty
                # lines behind: what the write-flush costs them.
                clean = median_ms(
                    torch, lambda: rows_mod.gather_rows(table, ids), flush, True)
                clean_lib = median_ms(
                    torch, lambda: torch.index_select(table, 0, ids), flush, True)
                results[(name, v, n)].update(clean_ms=clean,
                                             clean_library_ms=clean_lib)
                log(f"gather_rows {name} V={v} N={n} after a read-only "
                    f"flush: kernel {clean:.4f} ms, index_select "
                    f"{clean_lib:.4f} ms")
        del table
        torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------
# Phase 4: serve a planted model end to end
# ----------------------------------------------------------------------


def planted_model(torch, np, seed: int = 300):
    """A 1,000,000 x 300 fp32 model on the card: random rows from
    ``seed``, 16 word pairs (2i, 2i+1) whose second row is the first plus
    1% noise, and one analogy quadruple b2 = b1 - a1 + a2 + 1% noise."""
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.utils.params import Word2VecParams

    gen = torch.Generator(device="cuda").manual_seed(seed)
    syn0 = torch.randn((V_SERVE, D), generator=gen, device="cuda")
    noise = lambda: 0.01 * torch.randn((D,), generator=gen, device="cuda")
    for i in range(16):
        syn0[2 * i + 1] = syn0[2 * i] + noise()
    a1, a2, b1, b2 = 100, 101, 102, 103
    syn0[b2] = syn0[b1] - syn0[a1] + syn0[a2] + noise()
    syn1 = torch.zeros((V_SERVE, D), device="cuda")
    words = [f"w{i}" for i in range(V_SERVE)]
    counts = np.arange(V_SERVE, 0, -1, dtype=np.int64)
    model = model_from_arrays(
        words, syn0, syn1, counts, Word2VecParams(vector_size=D, min_count=1),
        device="cuda",
    )
    return model, syn0[:200].cpu().numpy(), (a1, a2, b1, b2)


def summary(ms) -> str:
    """Median and p95 of request times, with the sample count."""
    xs = sorted(ms)
    return (f"p50 {xs[len(xs) // 2]:.3f} ms, p95 "
            f"{xs[min(len(xs) - 1, int(0.95 * len(xs)))]:.3f} ms, n={len(xs)}")


def expect(cond, what) -> None:
    """Fail the run unless ``cond`` holds (kept under ``python -O``)."""
    if not cond:
        raise AssertionError(what)


def get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def post(port: int, path: str, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def post_status(port: int, path: str, payload) -> int:
    try:
        post(port, path, payload)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def closed_loop(port: int, clients: int, per_client: int, first_word: int,
                exact: bool = False):
    """``clients`` threads, each sending ``per_client`` ``/synonyms``
    requests back to back for words no earlier request asked for (cache
    misses), with ``"exact": true`` if ``exact``. Returns every request's
    latency in ms and the wall seconds."""
    lat = [[] for _ in range(clients)]
    extra = {"exact": True} if exact else {}

    def client(c):
        for i in range(per_client):
            word = f"w{first_word + c * per_client + i}"
            t = time.perf_counter()
            post(port, "/synonyms", {"word": word, "num": 10, **extra})
            lat[c].append((time.perf_counter() - t) * 1e3)

    t = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t
    xs = [x for c in lat for x in c]
    expect(len(xs) == clients * per_client, "a closed-loop client failed")
    return xs, wall


def closed_loop_in_child(port: int, clients: int, per_client: int,
                         first_word: int, exact: bool = False):
    """:func:`closed_loop` in a child process, so the clients' Python does
    not take the server's interpreter lock from it."""
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(closed_loop,
                          (port, clients, per_client, first_word, exact))


def post_full(port: int, path: str, payload, headers=None):
    """``(status, Retry-After header, body or None)`` of one POST."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Retry-After"), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), None


def burst(port: int, clients: int, per_client: int, first_word: int):
    """``clients`` threads released together, each sending ``per_client``
    cache-miss ``/synonyms`` back to back, each on a new connection.
    Returns ``(status, Retry-After, ms, connect ms)`` of every request:
    the whole request, and the TCP connect alone."""
    import http.client

    out = [[] for _ in range(clients)]
    gate = threading.Barrier(clients)

    def client(c):
        gate.wait()
        for i in range(per_client):
            word = f"w{first_word + c * per_client + i}"
            body = json.dumps({"word": word, "num": 10})
            t = time.perf_counter()
            tc = t
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
                conn.connect()
                tc = time.perf_counter()
                conn.request("POST", "/synonyms", body,
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                st, retry, data = r.status, r.getheader("Retry-After"), r.read()
                conn.close()
                ok = st != 200 or (lambda h: len(h) == 10 and h[0][0] != word)(
                    json.loads(data))
                st = st if ok else "wrong answer"
            except OSError as e:  # a reset connection, reported as such
                st, retry = type(e).__name__, None
            done = time.perf_counter()
            out[c].append((st, retry, (done - t) * 1e3, (tc - t) * 1e3))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    return [x for c in out for x in c]


def burst_in_child(port: int, clients: int, per_client: int, first_word: int):
    """:func:`burst` in a child process, so the clients do not take the
    server's interpreter lock."""
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(burst, (port, clients, per_client, first_word))


def counting(sent, fn):
    """``fn(port, path, ...)`` that first counts the request in ``sent``
    under its path."""
    def call(port, path, *args):
        sent[urllib.parse.urlparse(path).path] += 1
        return fn(port, path, *args)
    return call


def dispatches(snap: dict) -> int:
    """Coalesced dispatches a ``/metrics`` snapshot counts."""
    return sum(snap["coalesced_batch_sizes"].values())


def overload_drills(torch, np, rows_mod, model) -> dict:
    """Phase 4 (d) to (f) on a second server over the planted model: the
    admission bound under a burst past it, a deadline passed while a
    dispatch is slow, and degraded cache-only mode. The ``gather_rows``
    launches of each drill must equal its coalesced dispatches (one pull
    a dispatch): a shed or timed-out request launches nothing."""
    from glint_word2vec_torch.serving import ModelServer
    from glint_word2vec_torch.utils import faults

    server = ModelServer(model, port=0, max_inflight=DRILL_INFLIGHT,
                         request_deadline=30.0, degraded_after=None)
    # Nothing else runs in the process meanwhile: serve as the CLI does
    # (serve_forever, which tightens the switch interval until stop()).
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.port
    try:
        def snap():
            return get_json(port, "/metrics")

        def launched_per_dispatch(s0, g0, what):
            s1, g1 = snap(), rows_mod.gather_rows.launches
            expect(g1 - g0 == dispatches(s1) - dispatches(s0),
                   f"{what}: {g1 - g0} gather_rows launches for "
                   f"{dispatches(s1) - dispatches(s0)} dispatches")
            return s1, g1 - g0

        # (d) A burst past the admission bound.
        s0, g0 = snap(), rows_mod.gather_rows.launches
        t0 = time.perf_counter()
        res = burst_in_child(port, DRILL_CLIENTS, DRILL_PER_CLIENT, 600_000)
        wall = time.perf_counter() - t0
        s1, launched = launched_per_dispatch(s0, g0, "(d) overload drill")
        shed = [r for r in res if r[0] == 429]
        ok = [r[2] for r in res if r[0] == 200]
        ok_connect = [r[3] for r in res if r[0] == 200]
        shed_ms = [r[2] for r in shed]
        expect(len(res) == DRILL_CLIENTS * DRILL_PER_CLIENT
               and len(shed) + len(ok) == len(res),
               f"(d) {len(res)} answers, other than 200/429: "
               f"{sorted({str(r[0]) for r in res} - {'200', '429'})}")
        expect(shed, f"(d) no 429 from {DRILL_CLIENTS} clients past "
                     f"max_inflight={DRILL_INFLIGHT}")
        expect(all(r[1] == "1" for r in shed), "(d) a 429 without Retry-After: 1")
        over = s1["overload"]
        expect(over["shed_admission_total"] - s0["overload"]["shed_admission_total"]
               == len(shed), f"(d) shed count {over} against {len(shed)} 429s")
        expect(over["inflight_peak"] <= DRILL_INFLIGHT, over)
        log(f"(d) overload drill, {DRILL_CLIENTS} clients x {DRILL_PER_CLIENT} "
            f"cache-miss /synonyms at max_inflight={DRILL_INFLIGHT} in "
            f"{wall:.3f} s: {len(shed)} shed with 429 (Retry-After 1), "
            f"{len(ok)} admitted; admitted {summary(ok)} (of which the TCP "
            f"connect {summary(ok_connect)}); shed {summary(shed_ms)}; "
            f"in-flight peak {over['inflight_peak']}; gather_rows launched "
            f"{launched} times for {dispatches(s1) - dispatches(s0)} "
            f"coalesced dispatches")
        drill = {"shed": len(shed), "admitted": len(ok), "launches": launched,
                 "p50_ms": sorted(ok)[len(ok) // 2],
                 "p95_ms": sorted(ok)[min(len(ok) - 1, int(0.95 * len(ok)))],
                 "connect_p95_ms": sorted(ok_connect)[
                     min(len(ok) - 1, int(0.95 * len(ok)))]}

        # (e) A dispatch slower than the deadline: a request behind it
        # answers 504 without a dispatch of its own.
        server.request_deadline = 0.5
        s0, g0 = s1, rows_mod.gather_rows.launches
        faults.arm("serving.dispatch:delay=2.0@1")
        slow = {}
        th = threading.Thread(target=lambda: slow.update(
            r=post_full(port, "/synonyms", {"word": "w700000", "num": 10})))
        th.start()
        time.sleep(0.15)
        t0 = time.perf_counter()
        late = [post_full(port, "/synonyms", {"word": "w700001", "num": 10}),
                post_full(port, "/vector", {"word": "w700002"})]
        waited = time.perf_counter() - t0
        th.join(timeout=60)
        faults.disarm()
        s1, launched_e = launched_per_dispatch(s0, g0, "(e) deadline drill")
        expect([r[0] for r in late] == [504, 504], f"(e) answers {late}")
        expect(slow["r"][0] == 200, f"(e) the slow dispatch answered {slow['r']}")
        expect(s1["overload"]["deadline_504_total"]
               - s0["overload"]["deadline_504_total"] == 2, s1["overload"])
        expect(server._coalescer._pending == [], "(e) a 504'd request stayed pending")
        log(f"(e) deadline drill: serving.dispatch delayed 2.0 s past the "
            f"0.5 s deadline; /synonyms and /vector behind it answered 504 in "
            f"{waited:.3f} s, deadline_504_total +2, gather_rows launched "
            f"{launched_e} time(s) for {dispatches(s1) - dispatches(s0)} "
            f"dispatch(es)")

        # (f) Degraded mode: the device lock held past degraded_after.
        server.request_deadline = 30.0
        server.degraded_after = 0.3
        hot = post_full(port, "/synonyms", {"word": "w700010", "num": 10})
        s0, g0 = snap(), rows_mod.gather_rows.launches
        faults.arm("serving.dispatch:delay=1.5@1")
        th = threading.Thread(target=lambda: slow.update(
            f=post_full(port, "/synonyms", {"word": "w700011", "num": 10})))
        th.start()
        time.sleep(0.6)
        during = get_json(port, "/healthz")["status"]
        hit = post_full(port, "/synonyms", {"word": "w700010", "num": 10})
        miss = post_full(port, "/synonyms", {"word": "w700012", "num": 10})
        th.join(timeout=60)
        faults.disarm()
        after = get_json(port, "/healthz")["status"]
        s1, launched_f = launched_per_dispatch(s0, g0, "(f) degraded drill")
        over0, over1 = s0["overload"], s1["overload"]
        expect((during, after) == ("degraded", "ok"), (during, after))
        expect(hit[0] == 200 and hit[2] == hot[2], f"(f) cache hit {hit[:2]}")
        expect(miss[:2] == (429, "1"), f"(f) miss answered {miss[:2]}")
        expect(over1["degraded_entered_total"] - over0["degraded_entered_total"] == 1
               and over1["shed_degraded_total"] - over0["shed_degraded_total"] == 1,
               over1)
        log(f"(f) degraded drill: lock held 1.5 s past degraded_after 0.3 s: "
            f"/healthz {during} then {after}; the cached word answered 200 "
            f"from the cache, a miss 429; gather_rows launched {launched_f} "
            f"time(s) for {dispatches(s1) - dispatches(s0)} dispatch(es)")
        drill["launches"] += launched_e + launched_f
        return drill
    finally:
        faults.disarm()
        server.stop()


def device_busy(torch, port: int) -> None:
    """Share of a 16-client ``/synonyms`` window in which the card was
    busy, from a ``torch.profiler`` trace of this process (the server's
    threads run here), and the kernels that took the most device time.
    A window of its own: the profiler slows the host side it traces."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        xs, wall = closed_loop_in_child(port, 16, 25, 300_000)
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:  # union of the device intervals, in microseconds
        if e > end:
            busy_us += e - max(s, end)
            end = e
    if not spans:
        log("device busy share: not measured (the profiler saw no device "
            "activity)")
        return
    log(f"device busy share, 16 clients (profiled, {len(xs)} requests in "
        f"{wall:.3f} s): {busy_us / (wall * 1e6):.4f}")
    top = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)
    for a in top[:6]:
        log(f"  {a.self_device_time_total / 1e3:9.3f} ms  x{a.count:<6d} "
            f"{a.key[:90]}")


def time_layers(torch, model) -> None:
    """Where one single-word synonym query spends its time below HTTP:
    the device work alone (one-row gather, the 1,000,000 x 300 scoring
    product, the masked ``topk``; L2 flushed) against the same query
    through ``Word2VecModel.find_synonyms`` on the host clock."""
    eng = model.engine
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ids = torch.zeros(1, dtype=torch.int32, device="cuda")
    inv, neg = eng._mask_terms()

    def device_work():
        q = eng._pull_rows(ids)
        torch.topk((eng.syn0 @ q.T).T * inv + neg, 16)

    dev = median_ms(torch, device_work, flush)
    xs = []
    for i in range(SEQ_REQUESTS):
        t = time.perf_counter()
        model.find_synonyms(f"w{3000 + i}", 10)
        xs.append((time.perf_counter() - t) * 1e3)
    log(f"find_synonyms in process: {summary(xs)}; its device work alone "
        f"{dev:.4f} ms")


def serve_end_to_end(torch, np, rows_mod) -> dict:
    """Phase 4. Returns the served-path counts and request times."""
    from collections import Counter

    from glint_word2vec_torch.obs import events
    from glint_word2vec_torch.obs.prometheus import lint_prometheus_text
    from glint_word2vec_torch.serving import serve_model_dir

    tmp = tempfile.mkdtemp(prefix="glint_chip_smoke_")
    model = None
    try:
        t0 = time.perf_counter()
        model, rows, (a1, a2, b1, b2) = planted_model(torch, np)
        model_dir = os.path.join(tmp, "model")
        model.save(model_dir)
        log(f"planted model built and saved in {time.perf_counter() - t0:.1f} s")
        time_layers(torch, model)

        port_file = os.path.join(tmp, "port.json")
        failure = []

        def run():
            try:
                serve_model_dir(model_dir, port=0, port_file=port_file,
                                device="cuda",
                                trace_log=os.path.join(tmp, "trace.jsonl"))
            except BaseException as e:  # reported by the main thread
                failure.append(e)

        # The served path starts here: every launch from now on is one the
        # server made for its load, warmup or requests.
        rows_mod.gather_rows.launches = 0
        t0 = time.perf_counter()
        th = threading.Thread(target=run, name="serve_model_dir", daemon=True)
        th.start()
        while not os.path.exists(port_file):
            if failure or not th.is_alive():
                raise RuntimeError(f"serve_model_dir failed: {failure}")
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("server not listening after 600 s")
            time.sleep(0.2)
        with open(port_file) as f:
            port = json.load(f)["port"]
        log(f"server loaded, warmed and listening in "
            f"{time.perf_counter() - t0:.1f} s (port {port})")

        # Every request this phase sends, by endpoint, for (a).
        sent = Counter()
        send, fetch, send_status = (counting(sent, f)
                                    for f in (post, get_json, post_status))

        health = fetch(port, "/healthz")
        expect(health["status"] == "ok", health)
        expect((health["vocab_size"], health["dim"]) == (V_SERVE, D), health)
        expect(health["device"] == torch.cuda.get_device_name(0), health)

        vec = np.asarray(send(port, "/vector", {"word": "w7"}), np.float32)
        expect(np.array_equal(vec, rows[7]), "/vector differs from the row")

        def unit(x):
            return x / np.linalg.norm(x)

        per_request = {}
        for i in range(16):
            a, b = f"w{2 * i}", f"w{2 * i + 1}"
            before = rows_mod.gather_rows.launches
            hits = send(port, "/synonyms", {"word": a, "num": 5})
            per_request.setdefault("/synonyms", rows_mod.gather_rows.launches - before)
            expect(len(hits) == 5 and hits[0][0] == b, (a, hits))
            cos = float(unit(rows[2 * i].astype(np.float64))
                        @ unit(rows[2 * i + 1].astype(np.float64)))
            expect(abs(hits[0][1] - cos) < 1e-5, (hits[0], cos))

        hits = send(port, "/synonyms_vector",
                    {"vector": rows[2].tolist(), "num": 3})
        expect([h[0] for h in hits[:2]] == ["w2", "w3"], hits)

        before = rows_mod.gather_rows.launches
        hits = send(port, "/analogy", {
            "positive": [f"w{b1}", f"w{a2}"], "negative": [f"w{a1}"], "num": 3,
        })
        per_request["/analogy"] = rows_mod.gather_rows.launches - before
        expect(hits[0][0] == f"w{b2}", hits)

        sents = [[f"w{a1}", f"w{a2}", f"w{b1}"], [f"w{b2}", "not_a_word"], []]
        before = rows_mod.gather_rows.launches
        means = np.asarray(send(port, "/transform", {"sentences": sents}))
        per_request["/transform"] = rows_mod.gather_rows.launches - before
        want = np.stack([
            rows[[a1, a2, b1]].astype(np.float64).mean(axis=0),
            rows[b2].astype(np.float64), np.zeros(D),
        ])
        expect(means.shape == (3, D) and np.isfinite(means).all(),
               f"/transform gave shape {means.shape}")
        # 1e-6 relative to the largest entry: an fp32 mean of three rows
        # rounds at that scale.
        err = np.abs(means - want).max()
        expect(err <= 1e-6 * max(1.0, np.abs(want).max()),
               f"/transform differs from the mean of the rows by {err}")

        expect(send_status(port, "/vector", {"word": "not_a_word"}) == 404,
               "an out-of-vocabulary /vector did not answer 404")
        expect(send_status(port, "/synonyms", {"word": "w1", "num": -1}) == 400,
               "/synonyms with num=-1 did not answer 400")

        # 16 concurrent /synonyms (new words, so no cache hits).
        results = [None] * 16

        def ask(i):
            results[i] = post(port, "/synonyms",
                              {"word": f"w{2 * i + 1}", "num": 3})

        stats0 = fetch(port, "/healthz")["coalescer"]
        sent["/synonyms"] += 16
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, hits in enumerate(results):
            expect(hits is not None and hits[0][0] == f"w{2 * i}", (i, hits))
        stats = fetch(port, "/healthz")["coalescer"]
        log(f"16 concurrent /synonyms: {stats['requests'] - stats0['requests']}"
            f" requests in {stats['dispatches'] - stats0['dispatches']} "
            f"dispatches (largest batch so far {stats['largest_batch']})")

        # Request latency on the host clock, every request a cache miss:
        # one client in a closed loop, then 16 clients in a closed loop
        # from a child process.
        lat = {"/synonyms": [], "/transform": []}
        for i in range(SEQ_REQUESTS):
            t = time.perf_counter()
            send(port, "/synonyms", {"word": f"w{1000 + i}", "num": 10})
            lat["/synonyms"].append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            send(port, "/transform",
                 {"sentences": [[f"w{5000 + 8 * i + j}" for j in range(8)]]})
            lat["/transform"].append((time.perf_counter() - t) * 1e3)
        for path, xs in lat.items():
            log(f"{path}, 1 client: {summary(xs)}")
        stats = fetch(port, "/healthz")["coalescer"]
        xs, wall = closed_loop_in_child(port, 16, SEQ_REQUESTS // 2, 100_000)
        sent["/synonyms"] += len(xs)
        stats1 = fetch(port, "/healthz")["coalescer"]
        log(f"/synonyms, 16 clients: {summary(xs)}; {len(xs) / wall:.1f} "
            f"requests/s; {stats1['requests'] - stats['requests']} requests in "
            f"{stats1['dispatches'] - stats['dispatches']} dispatches")
        # What request tracing costs: the same 16-client window with the
        # recorder the server installed, and with none (every request then
        # carries a null trace), in turns.
        t_added = time.perf_counter()
        rec = events.get_recorder()
        expect(rec is not None, "serve_model_dir(trace_log=) installed no recorder")
        tails = {"traced": [], "untraced": []}
        for i, mode in enumerate(("untraced", "traced", "untraced", "traced")):
            events.set_recorder(None if mode == "untraced" else rec)
            xs, wall = closed_loop_in_child(port, 16, SEQ_REQUESTS // 8,
                                            110_000 + 1_000 * i)
            sent["/synonyms"] += len(xs)
            tails[mode].append(xs)
        events.set_recorder(rec)
        for mode, runs in tails.items():
            log(f"/synonyms, 16 clients, {mode}: "
                + "; ".join(summary(xs) for xs in runs))
        device_busy(torch, port)
        sent["/synonyms"] += 16 * 25

        # (a) /metrics counts every request of the phase, per endpoint
        # (a request is counted just after its answer is sent, so poll).
        for _ in range(50):
            want = dict(sent)
            snap = fetch(port, "/metrics")
            counts = {p: e["count"] for p, e in snap["endpoints"].items()}
            if counts == want:
                break
            time.sleep(0.1)
        expect(counts == want, f"(a) /metrics counts {counts}, sent {want}")
        expect(snap["overload"]["shed_admission_total"] == 0, snap["overload"])
        log(f"(a) /metrics counts every request: {counts}; coalesced "
            f"dispatches {dispatches(snap)}; cache {snap['synonym_cache']}")
        # (b) The Prometheus text passes the linter, with exemplars.
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics?format=prometheus",
                timeout=60) as r:
            text = r.read().decode()
        lint_prometheus_text(text)
        expect(' # {trace_id="' in text, "(b) no exemplar in the Prometheus text")
        # (c) A traced request that answers 404 is kept and on /trace.
        tid = "c41b5e0d00000016"
        st = counting(sent, post_full)(port, "/vector", {"word": "not_a_word"},
                                       {"X-Glint-Trace": tid})
        expect(st[0] == 404, f"(c) traced /vector answered {st[0]}")
        doc = fetch(port, "/trace?seconds=600")
        mine = [e for e in doc["events"] if e.get("args", {}).get("trace") == tid]
        expect([e["name"] for e in mine][-1:] == ["req.accept"]
               and mine[-1]["args"]["status"] == 404, f"(c) /trace gave {mine}")
        log(f"(b) Prometheus text lint-clean, {len(text.splitlines())} lines; "
            f"(c) traced 404 on /trace: {[e['name'] for e in mine]}; the ring "
            f"holds {len(doc['events'])} events")
        t_added = time.perf_counter() - t_added

        expect(send(port, "/shutdown", {}) == {"status": "shutting down"},
               "/shutdown was not acknowledged")
        th.join(timeout=120)
        if th.is_alive():
            raise RuntimeError("server did not stop after /shutdown")
        if failure:
            raise RuntimeError(f"serve_model_dir failed: {failure[0]!r}")
        launches = rows_mod.gather_rows.launches
        log(f"served path: gather_rows launched {launches} times; per "
            f"request {per_request}")
        if launches <= 0:
            raise AssertionError("the served path never launched gather_rows")
        expect(events.get_recorder() is None,
               "serve_model_dir left its recorder installed")
        t_drill = time.perf_counter()
        drill = overload_drills(torch, np, rows_mod, model)
        log(f"phase 4 additions: tracing windows and (a) to (c) "
            f"{t_added:.1f} s, drills (d) to (f) "
            f"{time.perf_counter() - t_drill:.1f} s")
        return {"launches": launches, "per_request": per_request,
                "drill": drill}
    finally:
        if model is not None:
            model.stop()
            del model
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 5: training kernels against their plain versions, full width
# ----------------------------------------------------------------------


def zipf_ids(torch, gen, shape, v: int):
    """Zipf(1)-like int32 ids in [0, v) on the card: ``floor((v+1)^u) - 1``
    for ``u ~ U[0, 1)``, so id k comes with probability ~1/((k+1) ln v)."""
    u = torch.rand(shape, generator=gen, device=DEV, dtype=torch.float64)
    ids = torch.exp(u * math.log(v + 1)).floor() - 1
    return ids.clamp(0, v - 1).to(torch.int32)


def step_inputs(torch, np, gen, P=None, alias_table=None):
    """One full-width dense pair batch of ``P`` pair slots (by default the
    packed batch of B_TRAIN and W_TRAIN): Zipf centers and contexts (ids 0
    and V-1 among them), negatives drawn by the port's alias sampler over
    Zipf counts (so frequent words repeat into long runs), 13 padded slots
    at the end, and the negative mask. ``alias_table`` = (prob, alias)
    reuses a table this function returned."""
    from glint_word2vec_torch.corpus.alias import build_unigram_alias
    from glint_word2vec_torch.corpus.batching import packed_pair_batch
    from glint_word2vec_torch.ops import random as rnd
    from glint_word2vec_torch.ops.sampling import sample_negatives_per_row
    from glint_word2vec_torch.ops.sgns import negative_mask

    if P is None:
        P = packed_pair_batch(B_TRAIN, W_TRAIN)
    if alias_table is None:
        counts = (1e9 / np.arange(1, V_TRAIN + 1)).astype(np.int64) + MIN_PER_WORD
        t = build_unigram_alias(counts)
        alias_table = (torch.from_numpy(t.prob).to(DEV),
                       torch.from_numpy(t.alias).to(DEV))
    prob, alias = alias_table
    centers = zipf_ids(torch, gen, (P,), V_TRAIN)
    contexts = zipf_ids(torch, gen, (P,), V_TRAIN)
    centers[:3] = torch.tensor([V_TRAIN - 1, 0, V_TRAIN - 1], dtype=torch.int32)
    contexts[3] = V_TRAIN - 1
    rows = torch.arange(P, device=DEV)
    negs = sample_negatives_per_row(
        rnd.fold_in(rnd.seed_key(1), 7), prob, alias, rows, (N_NEG,)
    )
    negs[4, 0] = V_TRAIN - 1
    mask = (rows < P - 13).to(torch.float32)
    centers = torch.where(mask > 0, centers, 0)
    contexts = torch.where(mask > 0, contexts, 0)
    nmask = negative_mask(negs, contexts, mask)
    return (centers, contexts, mask, negs, nmask), (prob, alias)


def check_draws(torch, prob, alias) -> None:
    """The counter-based draws on the card equal the same draws on the
    CPU, bitwise: negatives, window shrinks, subsample keep masks."""
    from glint_word2vec_torch.ops import device_batching as dbat
    from glint_word2vec_torch.ops import random as rnd
    from glint_word2vec_torch.ops.sampling import sample_negatives_per_row

    key = rnd.fold_in(rnd.seed_key(11), 5)
    rows = torch.arange(100_000, device=DEV)
    pos = torch.arange(10**9, 10**9 + 100_000, device=DEV)
    kp = torch.rand(V_TRAIN, device=DEV)
    ids = (rows * 7919) % V_TRAIN
    pairs = [
        (sample_negatives_per_row(key, prob, alias, rows, (N_NEG,)),
         sample_negatives_per_row(key, prob.cpu(), alias.cpu(), rows.cpu(), (N_NEG,))),
        (dbat.grid_window_shrink(key, pos, B_TRAIN, 77, W_TRAIN),
         dbat.grid_window_shrink(key, pos.cpu(), B_TRAIN, 77, W_TRAIN)),
        (dbat.subsample_keep_mask(ids, kp, key),
         dbat.subsample_keep_mask(ids.cpu(), kp.cpu(), key)),
    ]
    for what, (on_card, on_cpu) in zip(("negatives", "shrinks", "keep masks"), pairs):
        expect(torch.equal(on_card.cpu(), on_cpu),
               f"ops/random.py {what} differ between the card and the CPU")
    log("ops/random.py draws: negatives, shrinks and keep masks bitwise "
        "equal on the card and on the CPU")


def touched_rows_check(torch, table, before_rows, ids, reference, what):
    """Hold a scatter on the card bitwise against its plain version run on
    a CPU copy of the rows it touches: ``reference(rows, local_ids)``
    updates that copy, the ids remapped to its rows (a monotone map, so
    runs and their order are unchanged). Returns the run count R."""
    uniq = torch.unique(ids.long())
    local = torch.searchsorted(uniq, ids.long()).to(torch.int32)
    want = reference(before_rows, local.cpu())
    got = table[uniq].cpu()
    expect(torch.equal(got, want),
           f"{what} differs from its plain version: max |diff| "
           f"{(got.float() - want.float()).abs().max().item()}")
    return int(uniq.numel())


def pair_forward_bound(P, n, d, s, uniq0, uniq1):
    """Least time of pair_forward on the card, ms: the distinct rows read
    once in storage dtype, ids and masks read, fp32 h and d_center and the
    coefficients and losses written, against 2 * (1 + n) * d multiply-adds
    for the dots and as many for d_center per pair."""
    nbytes = (uniq0 + uniq1) * d * s + P * (12 + 8 * n) + 2 * P * d * 4 + P * (8 + 4 * n)
    flops = 4 * (1 + n) * d * P
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3, nbytes


def scatter_bound(P, N, R, d, s, bytes_per_update, flops_per_value):
    """Least time of a run-summing scatter, ms: the P x d fp32 payload
    rows read (the update rows, or ``h`` for the rank-1 scatters, which
    form each update from a row of it), each of the R distinct table rows
    (s bytes a value) read and written once,
    and ``bytes_per_update`` of index data read per update (8 for the
    rows scatter: sorted id and permutation entry; 16 for the rank-1
    scatter: those, the coefficient and the h row index); against
    ``flops_per_value`` fp32 operations per update and column."""
    nbytes = P * d * 4 + 2 * R * d * s + N * bytes_per_update
    flops = flops_per_value * N * d
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3, nbytes


def packed_step_centers(torch, np):
    """The center ids of one packed step of phase 6's corpus, from the
    port's own packing (``pack_window_pairs`` with the grid's window
    shrinks) over the corpus's first 100,000 tokens. Word ``wk`` is id
    ``k`` here; the fit's vocabulary numbers the words by count instead,
    which changes which rows are touched but not one run's length."""
    from glint_word2vec_torch.corpus.batching import context_width, packed_pair_batch
    from glint_word2vec_torch.ops import device_batching as dbat
    from glint_word2vec_torch.ops import random as rnd

    toks = synthetic_tokens(np)[:100_000]
    ids, offsets = dbat.to_device_corpus(
        toks, np.arange(0, toks.size + 1, SENTENCE_LEN), DEV)
    P = packed_pair_batch(B_TRAIN, W_TRAIN)
    span = dbat.packed_span(P, context_width(W_TRAIN))
    shrink = dbat.grid_window_shrink(
        rnd.seed_key(1), torch.arange(span, device=DEV), B_TRAIN, 0, W_TRAIN)
    centers, _, _, _, _ = dbat.pack_window_pairs(
        ids, offsets, 0, shrink, window=W_TRAIN, pair_batch=P,
        n_valid=toks.size)
    return centers


def run_stats(torch, ids) -> tuple:
    """``(R, longest run)`` of a list of ids."""
    counts = torch.unique(ids, return_counts=True)[1]
    return int(counts.numel()), int(counts.max())


def scatter_f32_parts(torch, fs, table, ids, upd, pool_case, packed, flush,
                      name) -> dict:
    """``scatter_add_rows_f32`` beyond phase 5's own case, each case held
    bitwise against the plain version on ``table`` (syn0) and timed
    beside ``index_add_`` (fp32 only: on a bf16 table it rounds at every
    add, another function): (a) the runs of 32 or more sent to distinct
    rows; (b) those runs alone; (c) one update, the launch floor inside
    the timing window; (d) ``pool_case`` = (syn1, pool ids, d_pool), the
    shared step's pool update; (e) ``packed``, the centers of one packed
    step of phase 6's corpus, with ``upd`` as payload."""
    counts = torch.unique(ids, return_counts=True)
    inv = torch.searchsorted(counts[0], ids)
    long_slot = counts[1][inv] >= 32
    pads = (V_TRAIN // 2 + torch.arange(ids.numel(), device=DEV)).to(torch.int32)
    syn1, pool, d_pool = pool_case
    cases = {
        "a": (table, torch.where(long_slot, pads, ids), upd),
        "b": (table, ids[long_slot].contiguous(), upd[long_slot].contiguous()),
        "c": (table, ids[:1].contiguous(), upd[:1].contiguous()),
        "d": (syn1, pool, d_pool),
        "e": (table, packed, upd),
    }
    out = {}
    for key, (t, i, u) in cases.items():
        uniq = torch.unique(i.long())
        before = t[uniq].cpu()
        fs.scatter_add_rows_f32(t, i, u)
        torch.cuda.synchronize()
        touched_rows_check(
            torch, t, before, i,
            lambda rows, local: fs.scatter_add_rows_f32_reference(rows, local, u.cpu()),
            f"scatter_add_rows_f32 {name} ({key})")
        R, longest = run_stats(torch, i)
        sid, order = fs.sorted_runs(i)
        ms = median_ms(torch, lambda: fs.scatter_add_rows_f32_sorted(
            t, sid, order, u), flush)
        library = None
        if t.dtype == torch.float32:
            il = i.long()
            library = median_ms(torch, lambda: t.index_add_(0, il, u), flush)
        out[key] = dict(n=i.numel(), runs=R, longest=longest, ms=ms,
                        library_ms=library)
        lib_txt = f", index_add_ {library:.4f} ms" if library is not None else ""
        log(f"scatter_add_rows_f32 {name} ({key}) N={i.numel()}: bitwise "
            f"equal (R={R} runs, longest {longest}); kernel {ms:.4f} ms"
            f"{lib_txt}")
    return out


def pair_forward_held(torch, fs, args, what, fn=None) -> tuple:
    """``fn`` (``pair_forward``, or its tiled form ``pair_forward_tiled``)
    on ``args`` called twice, the two results bitwise equal, and held
    against its plain version run on a CPU copy of the rows it reads (the
    ids remapped to those rows): ``h`` bitwise, ``c_pos``, ``c_neg`` and
    ``d_center`` within rtol 1e-5 and atol 1e-6 x max, the loss within
    rel 1e-5. Returns (the first result, the largest abs difference, the
    loss's relative difference)."""
    fn = fn or fs.pair_forward
    syn0, syn1, centers, contexts, mask, negs, nmask, alpha = args
    fw = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    for field in fw._fields:
        expect(torch.equal(bits(torch, getattr(fw, field)),
                           bits(torch, getattr(again, field))),
               f"pair_forward {what}: two calls differ in {field}")
    u0 = torch.unique(centers.long())
    u1 = torch.unique(torch.cat([contexts, negs.reshape(-1)]).long())
    local = lambda uniq, ids: torch.searchsorted(uniq, ids.long()).to(torch.int32).cpu()  # noqa: E731
    ref = fs.pair_forward_reference(
        syn0[u0].cpu(), syn1[u1].cpu(), local(u0, centers), local(u1, contexts),
        mask.cpu(), local(u1, negs), nmask.cpu(), alpha.cpu())
    expect(torch.equal(fw.h.cpu(), ref.h), f"pair_forward {what}: h differs")
    e = 0.0
    for field in ("c_pos", "c_neg", "d_center"):
        g, w = getattr(fw, field).cpu(), getattr(ref, field)
        diff = (g - w).abs()
        tol = 1e-5 * w.abs() + 1e-6 * float(w.abs().max())
        expect(bool((diff <= tol).all()),
               f"pair_forward {what}: {field} off by {diff.max().item()} "
               "(rtol 1e-5, atol 1e-6 x max)")
        e = max(e, float(diff.max()))
    rel = abs(float(fw.loss_sum) - float(ref.loss_sum)) / max(
        abs(float(ref.loss_sum)), 1e-30)
    expect(rel <= 1e-5, f"pair_forward {what}: loss off by rel {rel}")
    return fw, e, rel


def pair_forward_parts(torch, np, fs, syn0, syn1, alpha, alias_table, flush,
                       gen, name) -> dict:
    """``pair_forward`` beyond phase 5's own case, each held as
    :func:`pair_forward_held` does and timed: (b) 4 x P pairs of fresh
    draws (time growing well under 4 times means occupancy and latency
    set it), (c) every id one row (every read after the first hits L2:
    the dependent trips without the DRAM traffic)."""
    from glint_word2vec_torch.corpus.batching import packed_pair_batch

    P = packed_pair_batch(B_TRAIN, W_TRAIN)
    big = step_inputs(torch, np, gen, 4 * P, alias_table)[0]
    one = tuple(torch.full_like(x, 12345) if x.dtype == torch.int32 else x
                for x in step_inputs(torch, np, gen, P, alias_table)[0])
    out = {}
    for key, (centers, contexts, mask, negs, nmask) in (("b", big), ("c", one)):
        args = (syn0, syn1, centers, contexts, mask, negs, nmask, alpha)
        _, e, rel = pair_forward_held(torch, fs, args, f"{name} ({key})")
        ms = median_ms(torch, lambda: fs.pair_forward(*args), flush)
        out[key] = dict(pairs=centers.numel(), ms=ms, max_abs_err=e)
        log(f"pair_forward {name} ({key}) P={centers.numel()}: within rtol "
            f"1e-5 (max |diff| {e:.3g}), h bitwise, loss rel {rel:.2g}, two "
            f"calls bitwise; kernel {ms:.4f} ms")
    return out


def pair_forward_waves(fs, P, n, syn0, syn1, tiled=False) -> str:
    """The launch's form, shape and waves (``fs.pair_forward_grid``)."""
    g = fs.pair_forward_grid(P, n, syn0, syn1, tiled)
    waves = g["blocks"] / (g["per_sm"] * g["sms"])
    return (f"{'tiled' if g['tiled'] else 'one-pass'} form, {g['blocks']} "
            f"blocks of {g['pairs_per_block']} pairs, {g['per_sm']} a SM, "
            f"{waves:.3f} waves")


def bits_equal(torch, a, b) -> bool:
    """Two ``PairForward`` results equal bit for bit."""
    return all(torch.equal(bits(torch, x), bits(torch, y)) for x, y in zip(a, b))


#: The (d, n) that do not fit the one-pass form's shared memory in fp32
#: (7 rows of 20,000 values; 27 rows of 2,200), each on a table of the
#: rows given (fp32 8.0 and 8.8 GB a table).
TILED_SHAPES = ((20_000, 5, 100_000), (2_200, 25, V_TRAIN))


def check_tiled_pair_forward(torch, np, fs, gen, flush) -> dict:
    """Phase 5, B4's tiled form: at each of TILED_SHAPES, fp32 and bf16,
    one step's P pairs (Zipf ids with 0 and V-1, 13 padded slots, table
    entries at about 1/sqrt(d) as training keeps them), ``pair_forward``
    (which takes the tiled form where the rows do not fit) and
    ``pair_forward_tiled`` each held against the plain version, two calls
    bitwise, the two bitwise equal, and timed beside the plain version
    and the bound (each distinct row read once, outputs written once);
    where the one-pass form fits (bf16 at d = 2,200) its time too."""
    from glint_word2vec_torch.corpus.batching import packed_pair_batch
    from glint_word2vec_torch.ops.sgns import negative_mask

    P = packed_pair_batch(B_TRAIN, W_TRAIN)
    alpha = torch.tensor(0.025, device=DEV)
    out = {}
    for d, n, v in TILED_SHAPES:
        ids = zipf_ids(torch, gen, (P, 2 + n), v)
        ids[0, 0], ids[1, 1], ids[2, 2], ids[3, 2] = v - 1, v - 1, v - 1, 0
        centers, contexts = ids[:, 0].contiguous(), ids[:, 1].contiguous()
        negs = ids[:, 2:].contiguous()
        mask = (torch.arange(P, device=DEV) < P - 13).to(torch.float32)
        centers, contexts = centers * mask.int(), contexts * mask.int()
        nmask = negative_mask(negs, contexts, mask)
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            s = 4 if dtype == torch.float32 else 2
            syn0, syn1 = ((d ** -0.5 * torch.randn((v, d), generator=gen, device=DEV))
                          .to(dtype) for _ in range(2))
            args = (syn0, syn1, centers, contexts, mask, negs, nmask, alpha)
            what = f"{name} d={d} n={n} V={v}"
            auto = fs.pair_forward_grid(P, n, syn0, syn1)
            fw, e1, rel1 = pair_forward_held(torch, fs, args, what)
            tw, e2, rel2 = pair_forward_held(
                torch, fs, args, f"{what} tiled", fs.pair_forward_tiled)
            expect(bits_equal(torch, fw, tw),
                   f"pair_forward {what}: the two forms differ")
            ms = median_ms(torch, lambda: fs.pair_forward_tiled(*args), flush)
            one_pass = None
            if not auto["tiled"]:
                one_pass = median_ms(torch, lambda: fs.pair_forward(*args), flush)
            plain = median_ms(torch, lambda: fs.pair_forward_reference(*args), flush)
            uniq0 = int(torch.unique(centers).numel())
            uniq1 = int(torch.unique(torch.cat([contexts, negs.reshape(-1)])).numel())
            bound, nbytes = pair_forward_bound(P, n, d, s, uniq0, uniq1)
            out[(d, n, name)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                     one_pass_ms=one_pass,
                                     max_abs_err=max(e1, e2))
            op_txt = (f", one-pass form {one_pass:.4f} ms" if one_pass is not None
                      else "")
            log(f"pair_forward {what} P={P}: the wrapper takes the "
                f"{'tiled' if auto['tiled'] else 'one-pass'} form; both forms "
                f"within rtol 1e-5 (max |diff| {max(e1, e2):.3g}), h bitwise, "
                f"loss rel {max(rel1, rel2):.2g}, two calls bitwise, the two "
                f"forms bitwise equal; tiled {ms:.4f} ms{op_txt}, plain "
                f"{plain:.4f} ms, bound {bound:.5f} ms ({nbytes} bytes, "
                f"{uniq0}+{uniq1} distinct rows); "
                f"{pair_forward_waves(fs, P, n, syn0, syn1, tiled=True)}")
            del syn0, syn1, args, fw, tw
            torch.cuda.empty_cache()
    return out


def rank1_hbm_parts(torch, fs, table, ids, coef, h, hidx, flush, name) -> dict:
    """``scatter_add_rank1_hbm`` beyond phase 5's own case, on ``table``
    (syn1), each case held bit for bit against the plain version, two
    calls equal, then timed (sort excluded): (a) the runs of 32 or more
    sent to distinct rows, (b) those runs alone, (e) the runs under 32
    alone."""
    n = ids.numel()
    _, inv, counts = torch.unique(ids, return_inverse=True, return_counts=True)
    long_slot = counts[inv] >= 32
    pads = (V_TRAIN // 2 + torch.arange(n, device=DEV)).to(torch.int32)
    cases = {
        "a": (torch.where(long_slot, pads, ids), coef, hidx),
        "b": tuple(x[long_slot].contiguous() for x in (ids, coef, hidx)),
        "e": tuple(x[~long_slot].contiguous() for x in (ids, coef, hidx)),
    }
    kernel = (fs.scatter_add_rank1_hbm, fs.scatter_add_rank1_hbm_reference)
    out = {}
    for key, (i, cf, hx) in cases.items():
        R = rank1_bitwise(torch, kernel, table, i, cf, h, hx,
                          f"scatter_add_rank1_hbm {name} ({key})")
        c = torch.unique(i, return_counts=True)[1]
        sid, order = fs.sorted_runs(i)
        ms = median_ms(torch, lambda: fs.scatter_add_rank1_hbm_sorted(
            table, sid, order, cf, h, hx), flush)
        out[key] = dict(n=i.numel(), runs=R, longest=int(c.max()),
                        long_runs=int((c >= 32).sum()), ms=ms)
        log(f"scatter_add_rank1_hbm {name} ({key}) N={i.numel()}: bitwise "
            f"equal, two calls equal (R={R} runs, longest {int(c.max())}, "
            f"{int((c >= 32).sum())} runs of 32+); kernel {ms:.4f} ms")
    return out


def check_training_kernels(torch, np, fs) -> dict:
    """Phase 5. Returns per-kernel results of the fp32 full-width case,
    with the worst error over every case."""
    gen = torch.Generator(device=DEV).manual_seed(20261017)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    (centers, contexts, mask, negs, nmask), (prob, alias) = step_inputs(torch, np, gen)
    check_draws(torch, prob, alias)
    P, n = negs.shape
    alpha = torch.tensor(0.025, device=DEV)
    rows = torch.arange(P, dtype=torch.int32, device=DEV)
    ids1 = torch.cat([contexts, negs.reshape(-1)])
    hidx = torch.cat([rows, rows.repeat_interleave(n)])
    out = {}
    err = {"pair_forward": 0.0, "scatter_add_rank1_hbm": 0.0, "scatter_add_rows_f32": 0.0}
    packed = packed_step_centers(torch, np)
    pool_in = shared_pool_inputs(torch, gen, V_TRAIN, S_POOL)
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        s = 4 if dtype == torch.float32 else 2
        syn0 = (0.3 * torch.randn((V_TRAIN, D), generator=gen, device=DEV)).to(dtype)
        syn1 = (0.3 * torch.randn((V_TRAIN, D), generator=gen, device=DEV)).to(dtype)
        args = (syn0, syn1, centers, contexts, mask, negs, nmask, alpha)

        # pair_forward against its plain version on the CPU, two calls
        # bitwise equal.
        fw, e, rel = pair_forward_held(torch, fs, args, name)
        err["pair_forward"] = max(err["pair_forward"], e)
        uniq0 = int(torch.unique(centers).numel())
        uniq1 = int(torch.unique(ids1).numel())
        bound, nbytes = pair_forward_bound(P, n, D, s, uniq0, uniq1)
        ms = median_ms(torch, lambda: fs.pair_forward(*args), flush)
        plain = median_ms(torch, lambda: fs.pair_forward_reference(*args), flush)
        # The wrapper's other launch: the fixed-order sum of P losses.
        losses = torch.rand(P, generator=gen, device=DEV)
        loss_sum = median_ms(torch, lambda: losses.sum(), flush)
        out[("pair_forward", name)] = dict(
            ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound, runs=None,
            loss_sum_ms=loss_sum)
        log(f"pair_forward {name} V={V_TRAIN} d={D} P={P} n={n}: within "
            f"rtol 1e-5 (max |diff| {e:.3g}), h bitwise, loss rel {rel:.2g}, "
            f"two calls bitwise; kernel {ms:.4f} ms (the loss sum alone "
            f"{loss_sum:.4f} ms), plain {plain:.4f} ms, bound {bound:.5f} ms "
            f"({nbytes} bytes, {uniq0}+{uniq1} distinct rows); "
            f"{pair_forward_waves(fs, P, n, syn0, syn1)}")
        out[("pair_forward", name)]["parts"] = pair_forward_parts(
            torch, np, fs, syn0, syn1, alpha, (prob, alias), flush, gen, name)
        # The tiled form at this shape: bitwise the one-pass form's.
        tw, _, _ = pair_forward_held(torch, fs, args, f"{name} tiled",
                                     fs.pair_forward_tiled)
        expect(bits_equal(torch, fw, tw), f"pair_forward {name}: the two forms differ")
        tiled = median_ms(torch, lambda: fs.pair_forward_tiled(*args), flush)
        out[("pair_forward", name)]["tiled_ms"] = tiled
        log(f"pair_forward {name}, tiled form at this shape: bitwise the "
            f"one-pass form's, {tiled:.4f} ms; "
            f"{pair_forward_waves(fs, P, n, syn0, syn1, tiled=True)}")

        # scatter_add_rank1_hbm: syn1 += coef * h[hidx], from the kernel's
        # own forward outputs, as the training step runs it.
        coefs = torch.cat([fw.c_pos, fw.c_neg.reshape(-1)])
        h = fw.h
        uniq = torch.unique(ids1.long())
        before = syn1[uniq].cpu()
        fs.scatter_add_rank1_hbm(syn1, ids1, coefs, h, hidx)
        torch.cuda.synchronize()
        R = touched_rows_check(
            torch, syn1, before, ids1,
            lambda t, local: fs.scatter_add_rank1_hbm_reference(
                t, local, coefs.cpu(), h.cpu(), hidx.cpu()),
            f"scatter_add_rank1_hbm {name}")
        sid, order = fs.sorted_runs(ids1)
        ms = median_ms(torch, lambda: fs.scatter_add_rank1_hbm_sorted(
            syn1, sid, order, coefs, h, hidx), flush)
        plain = median_ms(torch, lambda: fs.scatter_add_rank1_hbm_reference(
            syn1, ids1, coefs, h, hidx), flush)
        bound, nbytes = scatter_bound(P, ids1.numel(), R, D, s, 16, 2)
        counts = torch.unique(ids1, return_counts=True)[1]
        longest = int(counts.max())
        long_runs = int((counts >= 32).sum())
        long_updates = int(counts[counts >= 32].sum())
        out[("scatter_add_rank1_hbm", name)] = dict(
            ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound, runs=R,
            longest=longest, long_runs=long_runs, long_updates=long_updates)
        log(f"scatter_add_rank1_hbm {name} N={ids1.numel()}: bitwise equal "
            f"(R={R} runs, longest {longest}, {long_runs} runs of 32 or more "
            f"holding {long_updates} updates); kernel {ms:.4f} ms (sort "
            f"excluded), plain {plain:.4f} ms, bound {bound:.5f} ms "
            f"({nbytes} bytes)")
        out[("scatter_add_rank1_hbm", name)]["parts"] = rank1_hbm_parts(
            torch, fs, syn1, ids1, coefs, h, hidx, flush, name)

        # scatter_add_rows_f32: syn0 += d_center.
        upd = fw.d_center
        uniq = torch.unique(centers.long())
        before = syn0[uniq].cpu()
        fs.scatter_add_rows_f32(syn0, centers, upd)
        torch.cuda.synchronize()
        R = touched_rows_check(
            torch, syn0, before, centers,
            lambda t, local: fs.scatter_add_rows_f32_reference(t, local, upd.cpu()),
            f"scatter_add_rows_f32 {name}")
        sid, order = fs.sorted_runs(centers)
        ms = median_ms(torch, lambda: fs.scatter_add_rows_f32_sorted(
            syn0, sid, order, upd), flush)
        plain = median_ms(torch, lambda: fs.scatter_add_rows_f32_reference(
            syn0, centers, upd), flush)
        library = None
        if dtype == torch.float32:
            library = median_ms(
                torch, lambda: syn0.index_add_(0, centers.long(), upd), flush)
        bound, nbytes = scatter_bound(P, P, R, D, s, 8, 1)
        longest = int(torch.unique(centers, return_counts=True)[1].max())
        out[("scatter_add_rows_f32", name)] = dict(
            ms=ms, plain_ms=plain, library_ms=library, bound_ms=bound, runs=R)
        lib_txt = f", index_add_ {library:.4f} ms" if library is not None else ""
        log(f"scatter_add_rows_f32 {name} N={P}: bitwise equal (R={R} runs, "
            f"longest {longest}); kernel {ms:.4f} ms (sort excluded), plain "
            f"{plain:.4f} ms{lib_txt}, bound {bound:.5f} ms ({nbytes} bytes)")
        pool_c, pool_x, pool_m, pool = pool_in
        d_pool = fs.pair_forward_shared(
            syn0, syn1, pool_c, pool_x, pool_m, pool, alpha, N_NEG).d_pool
        out[("scatter_add_rows_f32", name)]["parts"] = scatter_f32_parts(
            torch, fs, syn0, centers, upd, (syn1, pool, d_pool), packed,
            flush, name)
        del syn0, syn1, args, fw, d_pool
        torch.cuda.empty_cache()

    # One fp32 scatter on a 10,000,000 x 300 table (12 GB): row offsets
    # past 2^31 elements, id V-1 included.
    table = torch.randn((V_BIG, D), generator=gen, device=DEV)
    ids = zipf_ids(torch, gen, (P,), V_BIG)
    ids[:2] = torch.tensor([V_BIG - 1, V_BIG - 1], dtype=torch.int32)
    upd = torch.randn((P, D), generator=gen, device=DEV)
    uniq = torch.unique(ids.long())
    before = table[uniq].cpu()
    fs.scatter_add_rows_f32(table, ids, upd)
    torch.cuda.synchronize()
    R = touched_rows_check(
        torch, table, before, ids,
        lambda t, local: fs.scatter_add_rows_f32_reference(t, local, upd.cpu()),
        "scatter_add_rows_f32 on the 10M-row table")
    log(f"scatter_add_rows_f32 f32 V={V_BIG} d={D} N={P}, id V-1: bitwise "
        f"equal (R={R} runs)")
    # pair_forward with that table, at the 0.3 scale of the 1M-row tables,
    # as syn0 and syn1, reading row V-1 as a center, a context and a
    # negative.
    table.mul_(0.3)
    c, x, m, ng, nm = step_inputs(torch, np, gen, P, (prob, alias))[0]
    c = zipf_ids(torch, gen, (P,), V_BIG)
    c[0] = V_BIG - 1
    x[1] = V_BIG - 1
    ng[2, 0] = V_BIG - 1
    _, e, _ = pair_forward_held(torch, fs, (table, table, c, x, m, ng, nm, alpha),
                                "f32 on the 10M-row table")
    err["pair_forward"] = max(err["pair_forward"], e)
    log(f"pair_forward f32 V={V_BIG} d={D} P={P}, row V-1 read: within rtol "
        f"1e-5 (max |diff| {e:.3g}), h bitwise, two calls bitwise")
    del table
    torch.cuda.empty_cache()
    tiled = check_tiled_pair_forward(torch, np, fs, gen, flush)
    err["pair_forward"] = max([err["pair_forward"]]
                              + [r["max_abs_err"] for r in tiled.values()])
    for (kernel, name), r in out.items():
        r["max_abs_err"] = err[kernel]
    out["tiled"] = tiled
    return out


# ----------------------------------------------------------------------
# Phase 6: train
# ----------------------------------------------------------------------


def synthetic_tokens(np, seed: int = 1):
    """The CORPUS_TOKENS word numbers of the seeded corpus: every word of
    ``w0 .. w{V-1}`` MIN_PER_WORD times, the rest drawn Zipf(1.0) over
    the same words, shuffled."""
    rng = np.random.default_rng(seed)
    base = np.repeat(np.arange(V_TRAIN), MIN_PER_WORD)
    u = rng.random(CORPUS_TOKENS - base.size)
    extra = np.minimum(np.floor(np.exp(u * math.log(V_TRAIN + 1))) - 1, V_TRAIN - 1)
    toks = np.concatenate([base, extra.astype(np.int64)])
    rng.shuffle(toks)
    return toks


def write_synthetic_corpus(np, path: str, seed: int = 1,
                           tokens: int | None = None) -> int:
    """:func:`synthetic_tokens` as words ``w<k>``, in sentences of
    SENTENCE_LEN words; with ``tokens``, only the corpus's first whole
    sentences up to that many tokens (what :func:`write_prefix` cuts from
    the whole file). Returns the token count."""
    toks = synthetic_tokens(np, seed)
    if tokens is not None:
        toks = toks[: tokens // SENTENCE_LEN * SENTENCE_LEN]
    words = np.array([f"w{i}" for i in range(V_TRAIN)])
    with open(path, "w") as f:
        for s in range(0, toks.size, 100_000):
            block = words[toks[s : s + 100_000]].reshape(-1, SENTENCE_LEN)
            f.write("\n".join(" ".join(line) for line in block) + "\n")
    return int(toks.size)


def write_prefix(path: str, out: str, tokens: int) -> int:
    """The first ``tokens`` tokens (whole sentences of SENTENCE_LEN) of the
    corpus at ``path``, written to ``out``. Returns the token count."""
    lines = tokens // SENTENCE_LEN
    with open(path) as src, open(out, "w") as dst:
        for _ in range(lines):
            dst.write(src.readline())
    return lines * SENTENCE_LEN


def make_tiny_corpus(np):
    """The country/capital corpus of ``tests/conftest.py:50-93`` (a copy:
    that module imports JAX)."""
    rng = np.random.default_rng(12345)
    pairs = [
        ("germany", "berlin"), ("france", "paris"), ("austria", "vienna"),
        ("spain", "madrid"), ("italy", "rome"), ("poland", "warsaw"),
    ]
    theme = {c: [f"{c}_t{j}" for j in range(4)] for c, _ in pairs}
    filler = [f"w{i}" for i in range(40)]
    sentences = []
    for _ in range(4000):
        country, capital = pairs[rng.integers(len(pairs))]
        th = list(rng.choice(theme[country], size=2))
        noise = list(rng.choice(filler, size=2))
        style = rng.integers(4)
        if style == 0:
            s = [capital, "is", "the", "capital", "of", country] + th
        elif style == 1:
            s = [th[0], country, "capital", "city", capital, th[1]] + noise
        elif style == 2:
            s = [country, "has", "capital", capital] + th + noise
        else:
            x = country if rng.random() < 0.5 else capital
            s = [x, "famous", "for"] + th + noise
        sentences.append(s)
    for _ in range(600):
        sentences.append(list(rng.choice(filler, size=8)))
    rng.shuffle(sentences)
    return [[str(w) for w in s] for s in sentences]


def tiny_w2v(Word2Vec, **kw):
    """The settings of tests/test_model_e2e.py, on the card."""
    return (Word2Vec(**kw).set_vector_size(48).set_window_size(5)
            .set_step_size(0.025).set_batch_size(256).set_num_negatives(5)
            .set_min_count(5).set_num_iterations(6).set_seed(1))


def profile_window(torch, run, steps: int, what: str) -> dict:
    """Steps/s of ``run(1)`` without the profiler after a warming
    ``run(0)``, then the card's busy share, device activities and device
    time a step, and the kernels with the most device time, in a
    ``torch.profiler`` window of ``run(2)``; each run takes ``steps``
    steps. Returns ``{"steps_per_s", "busy", "device_ms"}`` (None where
    the profiler saw no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(0)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    out = {"steps_per_s": steps / wall, "busy": None, "device_ms": None}
    log(f"{what} at full width, unprofiled: {steps} steps in {wall:.3f} s, "
        f"{steps / wall:.1f} steps/s")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        log(f"device busy share of the {what}: not measured (the profiler "
            "saw no device activity)")
        return out
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    out.update(busy=busy_us / (wall * 1e6), device_ms=busy_us / steps / 1e3)
    log(f"device busy share of the {what} (profiled, {steps} steps in "
        f"{wall:.3f} s): {out['busy']:.4f}; {len(spans) / steps:.1f} device "
        f"activities a step, {out['device_ms']:.4f} ms of device time a step")
    top = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)
    for a in top[:8]:
        log(f"  {a.self_device_time_total / 1e3:9.3f} ms  x{a.count:<6d} "
            f"{a.key[:90]}")
    return out


def profile_training(torch, engine, groups: int) -> dict:
    """:func:`profile_window` over ``groups`` packed groups (16 steps
    each) at full width. The corpus is still on the card after the fit;
    the windows train on."""
    from glint_word2vec_torch.corpus.batching import packed_pair_batch
    from glint_word2vec_torch.ops import random as rnd

    P = packed_pair_batch(B_TRAIN, W_TRAIN)
    key = rnd.seed_key(2)
    pos, step = [0], [0]

    def run(_):
        for _ in range(groups):
            out = engine.train_steps_corpus_packed(
                pos[0], P, W_TRAIN, B_TRAIN, key, 16, step0=step[0],
                step_size=0.025, total_words=CORPUS_TOKENS + 1,
            )
            pos[0], step[0] = int(out[2][-1]), step[0] + 16

    return profile_window(torch, run, groups * 16, "packed steps")


def check_compaction_memory(torch, model, n_words: int) -> None:
    """The peak device bytes a word of one subsample-and-compact pass
    over the trained model's 10M-token corpus, against the estimate that
    bounds the resident fit (``SUBSAMPLED_CORPUS_BYTES_PER_WORD``); then
    the peak of the next epoch's pass prefetched while that compacted
    view is active, against the estimate with the prefetched copy
    (``+ PREFETCHED_CORPUS_BYTES_PER_WORD``). The prefetch must enqueue
    its pass with no host-device synchronization (CUDA sync debug mode
    set to error around it), and its adoption must equal the pass run
    directly, bitwise."""
    from glint_word2vec_torch.models import word2vec as w2v

    engine = model.engine
    engine.set_keep_probs(model.vocab.device_keep_probabilities(1e-3))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n_kept = engine.compact_corpus(1)
    peak = torch.cuda.max_memory_allocated() - base
    per_word = w2v.CORPUS_BYTES_PER_WORD + peak / n_words
    log(f"subsample-and-compact of {n_words} words ({n_kept} kept): peak "
        f"{peak} bytes above the uploaded corpus, {per_word:.2f} bytes a "
        f"word with its id (estimate "
        f"{w2v.SUBSAMPLED_CORPUS_BYTES_PER_WORD})")
    expect(per_word <= w2v.SUBSAMPLED_CORPUS_BYTES_PER_WORD,
           f"compaction took {per_word:.2f} bytes a word, more than the "
           "fit's estimate")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        engine.prefetch_compact_corpus(2)
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    peak_pre = torch.cuda.max_memory_allocated() - base
    per_word_pre = w2v.CORPUS_BYTES_PER_WORD + peak_pre / n_words
    budget = (w2v.SUBSAMPLED_CORPUS_BYTES_PER_WORD
              + w2v.PREFETCHED_CORPUS_BYTES_PER_WORD)
    log(f"prefetched pass beside the active compacted view: enqueued in "
        f"{enqueue_s * 1e3:.2f} ms with no synchronization, peak {peak_pre} "
        f"bytes above the uploaded corpus, {per_word_pre:.2f} bytes a word "
        f"with its id (estimate {budget})")
    expect(per_word_pre <= budget,
           f"the prefetch took {per_word_pre:.2f} bytes a word, more than "
           "the fit's estimate")
    adopted = engine.compact_corpus(2)
    ids_p = engine._corpus_compacted[0].clone()
    expect(engine.compact_corpus(2) == adopted
           and torch.equal(engine._corpus_compacted[0], ids_p),
           "the adopted prefetch differs from the pass run directly")
    # What the budget admits at this width on this card, for a fit in a
    # fresh process: the free memory plus all this process holds.
    free = w2v._free_device_bytes(engine.device) + torch.cuda.memory_allocated()
    for ratio in (0.0, 1e-3):
        est = w2v.Word2Vec(model.params.replace(subsample_ratio=ratio))
        fixed = est._device_bytes_needed(V_TRAIN, 0, 0)
        per = (w2v.SUBSAMPLED_CORPUS_BYTES_PER_WORD if ratio
               else w2v.CORPUS_BYTES_PER_WORD)
        words = int((w2v.DEVICE_MEMORY_FRACTION * free - fixed) / per)
        log(f"device corpus budget at {V_TRAIN} x {D}, subsample_ratio "
            f"{ratio}: {free} bytes free, tables and step {fixed} bytes, "
            f"at most about {words} words")


def host_pass_numbers(np, path: str, counts) -> None:
    """``fit_file``'s ingestion of the corpus at ``path`` (phase 6's first
    PY_PASS_TOKENS tokens; ``scan_and_encode_file``) and the alias build
    over ``counts`` (its 1,000,000 words), each
    through the native pass and then through the Python pass, host clock;
    the two give the same vocabulary, ids, offsets and table."""
    from glint_word2vec_torch import native
    from glint_word2vec_torch.corpus.alias import build_unigram_alias
    from glint_word2vec_torch.corpus.vocab import scan_and_encode_file

    runs = {}
    for mode in ("native", "python"):
        calls = dict(native.calls)
        with python_host_pass() if mode == "python" else contextlib.nullcontext():
            t0 = time.perf_counter()
            vocab, ids, offsets = scan_and_encode_file(
                path, min_count=MIN_PER_WORD, max_sentence_length=1000)
            t1 = time.perf_counter()
            table = build_unigram_alias(counts)
            t2 = time.perf_counter()
        took = native_calls_since(calls)
        expect((took["corpus_scan"], took["alias_build"])
               == ((1, 1) if mode == "native" else (0, 0)),
               f"{mode} host pass: native calls {took}")
        runs[mode] = (vocab, ids, offsets, table, t1 - t0, t2 - t1)
    a, b = runs["native"], runs["python"]
    expect(a[0].words == b[0].words and np.array_equal(a[1], b[1])
           and np.array_equal(a[2], b[2]), "native and Python ingestion differ")
    expect(np.array_equal(a[3].prob.view(np.uint32), b[3].prob.view(np.uint32))
           and np.array_equal(a[3].alias, b[3].alias),
           "native and Python alias tables differ")
    log(f"host pass, {a[1].size} tokens, alias of {len(counts)} words: ingestion "
        f"(scan_and_encode_file) native {a[4]:.3f} s, Python {b[4]:.3f} s; "
        f"alias build native {a[5]:.4f} s, Python {b[5]:.3f} s; outputs equal")


def compat_fit(torch, np, fs, corpus, tmp: str) -> dict:
    """Phase 6 (e): the reference's PySpark surface
    (``ServerSideGlintWord2Vec``) fits the tiny corpus on the card at
    vectorSize 100 with a requested topology of 4 partitions x 2 parameter
    servers, which clamps to the one card with the JAX layer's warning;
    the fit runs B4, B6 and B7 and passes the gates of
    ``tests/test_compat.py`` and the vienna/berlin gates; a save loads
    back with the same answers. Returns the kernels' launches."""
    import warnings

    from glint_word2vec_torch import (
        ServerSideGlintWord2Vec,
        ServerSideGlintWord2VecModel,
    )

    counters = (fs.pair_forward, fs.scatter_add_rank1_hbm, fs.scatter_add_rows_f32)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m = ServerSideGlintWord2Vec(
            vectorSize=100, numPartitions=4, numParameterServers=2, seed=1,
            maxIter=6, stepSize=0.025, batchSize=256, windowSize=5,
            unigramTableSize=100_000,
        ).fit(corpus)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    clamp = [str(w.message) for w in caught if "clamped" in str(w.message)]
    expect(clamp == ["requested topology 4x2 (partitions x parameter servers) "
                     f"clamped to mesh 1x1 for {torch.cuda.device_count()} "
                     "device(s)"], f"compat clamp warnings: {clamp}")
    for name, k in launches.items():
        expect(k > 0, f"the compat fit never launched {name}: {launches}")
    by_word = m.findSynonyms("germany", 5)
    expect(len(by_word) == 5 and all(isinstance(w, str) for w, _ in by_word), by_word)
    vecs = m.getVectors()
    expect(len(vecs) > 50 and vecs[0][1].shape == (100,), len(vecs))
    expect(len(m.findSynonymsArray(np.asarray(vecs[0][1]), 3)) == 3, "findSynonymsArray")
    out = m.transform([["germany", "berlin"], ["nonexistent_word"]])
    expect(out.shape == (2, 100) and np.linalg.norm(out[0]) > 0
           and not out[1].any(), f"compat transform {out.shape}")
    syns = dict(m.findSynonyms("austria", 10))
    ana = m._model.analogy(positive=["vienna", "germany"], negative=["austria"],
                           num=10)
    expect(syns.get("vienna", 0.0) > 0.5, f"compat vienna gate failed: {syns}")
    expect("berlin" in [w for w, _ in ana], f"compat berlin gate failed: {ana}")
    path = os.path.join(tmp, "compat_model")
    m.save(path)
    loaded = ServerSideGlintWord2VecModel.load(path)
    expect([w for w, _ in loaded.findSynonyms("germany", 3)]
           == [w for w, _ in m.findSynonyms("germany", 3)], "compat reload")
    loaded.stop()
    m.stop(terminateOtherClients=True)
    log(f"(e) ServerSideGlintWord2Vec 4x2 fit on the card in {wall:.1f} s "
        f"(clamped: {clamp[0]!r}); austria -> vienna {syns['vienna']:.4f}; "
        f"launches {launches}; save and load equal")
    return launches


def train_end_to_end(torch, np, fs, rows_mod) -> dict:
    """Phase 6. Returns the training kernels' launch counts from (a) and
    the gather's from (d)."""
    from glint_word2vec_torch import Word2Vec

    tmp = tempfile.mkdtemp(prefix="glint_chip_train_")
    try:
        path = os.path.join(tmp, "corpus.txt")
        t0 = time.perf_counter()
        n_tok = write_synthetic_corpus(np, path)
        log(f"synthetic corpus: {n_tok} tokens, {V_TRAIN} words, written in "
            f"{time.perf_counter() - t0:.1f} s")

        # (a) The main path: every counter zeroed just before, read just
        # after.
        from glint_word2vec_torch import native

        counters = (fs.pair_forward, fs.scatter_add_rank1_hbm,
                    fs.scatter_add_rows_f32, rows_mod.gather_rows)
        for c in counters:
            c.launches = 0
        fs.pair_forward.tiled_launches = 0
        calls = dict(native.calls)
        t0 = time.perf_counter()
        model = Word2Vec(
            vector_size=D, window=W_TRAIN, batch_size=B_TRAIN,
            num_negatives=N_NEG, min_count=MIN_PER_WORD, num_iterations=1,
            step_size=0.025, seed=1,
        ).fit_file(path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters[:3]}
        took = native_calls_since(calls)
        expect(took["corpus_scan"] == 1 and took["alias_build"] >= 1,
               f"fit_file did not take the native host pass: {took}")
        expect(fs.pair_forward.tiled_launches == 0,
               "the 300-wide fit took pair_forward's tiled form")
        tm = model.training_metrics
        log(f"fit_file 1M x 300: {wall:.1f} s in all (vocabulary scan, "
            f"encode, upload, training); training {tm['wall_seconds']} s, "
            f"{tm['steps']} steps, {tm['words_per_sec']} words/s, final loss "
            f"{tm['final_loss']}, packed mask density "
            f"{tm['packed_mask_density']}; launches {launches}")
        expect(model.vocab.size == V_TRAIN, f"vocabulary {model.vocab.size}")
        expect(tm["words_done"] == n_tok, tm)
        expect(math.isfinite(tm["final_loss"]), tm)
        for name, k in launches.items():
            if k <= 0:
                raise AssertionError(f"the training path never launched {name}")
        # Groups of 16 steps, and the deferred schedule's one zero-pair
        # phantom group of the epoch.
        expect(launches["pair_forward"] == tm["steps"] + (-tm["steps"]) % 16 + 16,
               f"one pair_forward per step: {launches} for {tm['steps']} steps")
        for t in (model.engine.syn0, model.engine.syn1):
            expect(bool(torch.isfinite(t).all()), "non-finite table entries")
        profile_training(torch, model.engine, PROFILE_GROUPS)
        check_compaction_memory(torch, model, n_tok)
        prefix = os.path.join(tmp, "prefix.txt")
        write_prefix(path, prefix, PY_PASS_TOKENS)
        host_pass_numbers(np, prefix, model.vocab.counts)

        # (d) Queries on the trained model run the gather.
        rows_mod.gather_rows.launches = 0
        hits = model.find_synonyms("w0", 10)
        expect(len(hits) == 10 and all(math.isfinite(s) for _, s in hits), hits)
        gathers = rows_mod.gather_rows.launches
        expect(gathers > 0, "find_synonyms never launched gather_rows")
        log(f"find_synonyms('w0') on the trained model: {hits[:3]} ...; "
            f"gather_rows launched {gathers} time(s)")
        model.stop()
        del model
        torch.cuda.empty_cache()

        # (b) Quality gates on the card, fp32 and bf16 tables.
        corpus = make_tiny_corpus(np)
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            m = tiny_w2v(Word2Vec, dtype=dtype).fit(corpus)
            syns = m.find_synonyms("austria", 10)
            ana = m.analogy(positive=["vienna", "germany"], negative=["austria"],
                            num=10)
            log(f"tiny_corpus {dtype} fit on the card in "
                f"{time.perf_counter() - t0:.1f} s: austria -> {syns[:6]}; "
                f"vienna - austria + germany -> {ana[:3]}")
            expect("vienna" in dict(syns) and dict(syns)["vienna"] > 0.5,
                   f"{dtype} vienna gate failed: {syns}")
            expect("berlin" in [w for w, _ in ana],
                   f"{dtype} berlin gate failed: {ana}")
            m.stop()

        # (c) Resume on the card equals an uninterrupted run, bitwise.
        ck = os.path.join(tmp, "ck")
        tiny_w2v(Word2Vec, num_iterations=2).fit(
            corpus, checkpoint_dir=ck, stop_after_epochs=1).stop()
        resumed = tiny_w2v(Word2Vec, num_iterations=2).fit(corpus, checkpoint_dir=ck)
        full = tiny_w2v(Word2Vec, num_iterations=2).fit(corpus)
        for name in ("syn0", "syn1"):
            expect(torch.equal(getattr(resumed.engine, name), getattr(full.engine, name)),
                   f"resumed {name} differs from the uninterrupted run")
        log("resume on the card: 1 epoch + resume + 1 epoch == 2 epochs, bitwise")
        resumed.stop()
        full.stop()
        t_added = time.perf_counter()
        compat = compat_fit(torch, np, fs, corpus, tmp)
        log(f"phase 6 addition: (e) {time.perf_counter() - t_added:.1f} s")
        return {"launches": launches, "gathers": gathers, "compat": compat}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 7: the composed step's kernels against their plain versions,
# full fastText width
# ----------------------------------------------------------------------


def composed_step_ids(torch, np, gen, C: int):
    """One full-width fastText step's update ids on the card, as the
    composed step sends them: syn0 ids of B subword groups (word row,
    22 n-gram bucket rows, 9 padded slots at row 0 with zero updates, as
    a 7-letter word such as ``w123456`` has), the last 24 batch rows the
    epoch's padding (word 0's group, zero updates); syn1 ids of the
    contexts (Zipf, about 57 % of the slots padded to row 0 with zero
    coefficients) and of their negatives (alias draws over Zipf counts,
    zero coefficients under padded contexts); and the syn1 ids of the
    shared-pool composed step, the contexts then a pool of ``S_POOL``
    draws from the same table. Ids 0, V-1 and the last bucket row are
    among them."""
    from glint_word2vec_torch.corpus.alias import build_unigram_alias
    from glint_word2vec_torch.ops import random as rnd
    from glint_word2vec_torch.ops.sampling import (
        sample_negatives,
        sample_negatives_per_row,
    )

    B, S, n, V = B_TRAIN, FT_SUBWORDS, N_NEG, V_TRAIN
    words = zipf_ids(torch, gen, (B,), V)
    groups = torch.zeros((B, S), dtype=torch.int32, device=DEV)
    groups[:, 0] = words
    groups[:, 1:23] = V + torch.randint(
        0, FT_BUCKET, (B, 22), generator=gen, device=DEV, dtype=torch.int32)
    groups[0, 0], groups[1, 1] = V - 1, V + FT_BUCKET - 1
    cmask = (torch.arange(S, device=DEV) < 23).float().expand(B, S).clone()
    groups[-24:] = groups[0].clone()
    ctx = zipf_ids(torch, gen, (B, C), V)
    mask = (torch.rand((B, C), generator=gen, device=DEV) < 0.43).float()
    mask[-24:] = 0.0
    ctx = torch.where(mask > 0, ctx, 0)
    ctx[2, 0], mask[2, 0] = V - 1, 1.0
    counts = (1e9 / np.arange(1, V + 1)).astype(np.int64) + MIN_PER_WORD
    t = build_unigram_alias(counts)
    prob, alias = torch.from_numpy(t.prob).to(DEV), torch.from_numpy(t.alias).to(DEV)
    negs = sample_negatives_per_row(
        rnd.fold_in(rnd.seed_key(3), 9), prob, alias, torch.arange(B, device=DEV),
        (C, n),
    )
    pool = sample_negatives(rnd.fold_in(rnd.seed_key(3), 10), prob, alias, (S_POOL,))
    ids_shared = torch.cat([ctx.reshape(-1), pool])
    ids1 = torch.cat([ctx.reshape(-1), negs.reshape(-1)])
    coef = torch.randn(ids1.shape[0], generator=gen, device=DEV) * 0.02
    coef *= torch.cat([mask.reshape(-1), mask[..., None].expand(B, C, n).reshape(-1)])
    r = torch.arange(B, dtype=torch.int32, device=DEV)
    hidx = torch.cat([r.repeat_interleave(C), r.repeat_interleave(C * n)])
    return (groups.reshape(-1), cmask.reshape(-1), ids1, coef.contiguous(), hidx,
            ids_shared)


def scatter_rows_parts(torch, table, ids0, cmask, ids_c, upd, longest, flush,
                       rows_mod, fs, name) -> dict:
    """``scatter_add_rows`` beyond the composed step's own case, on
    ``table``, each case held bitwise against the plain version: the
    composed step's ids with ``upd`` (every update non-zero, of magnitudes
    1e-3, 1 and 100, so row 0's run of ``longest`` adds rounds at every add
    under bf16); then, timed, where the time goes: (a) the padded slots
    sent to distinct rows, so no run of thousands is left; (b) one run of
    ``longest`` such updates alone; (c) ``ids_c``, the shared-pool composed
    step's syn1 ids, whose many long runs all take long-run blocks."""
    n = ids0.numel()
    pads = (V_TRAIN // 2 + torch.arange(n, device=DEV)).to(torch.int32)
    ids_a = torch.where(cmask > 0, ids0, pads)
    ids_b = torch.zeros(longest, dtype=torch.int32, device=DEV)
    upd_b = upd[:longest].contiguous()
    upd_c = upd[:ids_c.numel()].contiguous()
    cases = (("non-zero long run", ids0, upd), ("(a)", ids_a, upd),
             ("(b)", ids_b, upd_b), ("(c)", ids_c, upd_c))
    for what, ids, u in cases:
        uniq = torch.unique(ids.long())
        before = table[uniq].cpu()
        rows_mod.scatter_add_rows(table, ids, u)
        torch.cuda.synchronize()
        R = touched_rows_check(
            torch, table, before, ids,
            lambda t, local: rows_mod.scatter_add_rows_reference(t, local, u.cpu()),
            f"scatter_add_rows {name} {what}")
        log(f"scatter_add_rows {name} {what} N={ids.numel()}: bitwise equal "
            f"(R={R} runs, longest "
            f"{int(torch.unique(ids, return_counts=True)[1].max())})")
    counts_c = torch.unique(ids_c, return_counts=True)[1]
    out = {"runs_a": int(torch.unique(ids_a).numel()),
           "longest_a": int(torch.unique(ids_a, return_counts=True)[1].max()),
           "n_c": ids_c.numel(), "runs_c": counts_c.numel(),
           "long_runs_c": int((counts_c >= 32).sum()),
           "long_updates_c": int(counts_c[counts_c >= 32].sum())}
    for key, ids, u in (("a_ms", ids_a, upd), ("b_ms", ids_b, upd_b),
                        ("c_ms", ids_c, upd_c)):
        sid, order = fs.sorted_runs(ids)
        out[key] = median_ms(torch, lambda: rows_mod.scatter_add_rows_sorted(
            table, sid, order, u), flush)
    return out


def bits(torch, t):
    """``t``'s bits as integers: equal bits, not equal values (-0.0 is not
    +0.0 here)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def rank1_bitwise(torch, kernel, table, ids, coef, h, hidx, what) -> int:
    """A rank-1 scatter, ``kernel`` = (wrapper, plain version), on
    ``table`` held against its plain version on a CPU copy of the touched
    rows, bit for bit (signed zeros too), and a second call from the same
    rows against the first. Returns R."""
    fn, reference = kernel
    uniq = torch.unique(ids.long())
    before = table[uniq].cpu()
    local = torch.searchsorted(uniq, ids.long()).to(torch.int32).cpu()
    want = reference(before.clone(), local, coef.cpu(), h.cpu(), hidx.cpu())
    fn(table, ids, coef, h, hidx)
    torch.cuda.synchronize()
    first = table[uniq].cpu()
    expect(torch.equal(bits(torch, first), bits(torch, want)),
           f"{what} differs from its plain version: max "
           f"|diff| {(first.float() - want.float()).abs().max().item()}")
    table[uniq] = before.to(DEV)
    fn(table, ids, coef, h, hidx)
    torch.cuda.synchronize()
    expect(torch.equal(bits(torch, table[uniq].cpu()), bits(torch, first)),
           f"{what}: two calls differ")
    return int(uniq.numel())


def b2_kernel(rows_mod) -> tuple:
    """``scatter_add_rank1`` and its plain version, for
    :func:`rank1_bitwise`."""
    return rows_mod.scatter_add_rank1, rows_mod.scatter_add_rank1_reference


def sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.strip().splitlines()[0])


def scatter_rank1_parts(torch, table, h, step, ctx, wide, longest, flush,
                        rows_mod, fs, name) -> dict:
    """``scatter_add_rank1`` beyond the composed step's own case ``step``
    (ids, coefficients, h rows; its first ``ctx`` slots the contexts), on
    ``table``: each case first held bitwise (and two calls equal) against
    the plain version, then timed (sort excluded): (a) the padded context
    slots (coefficient 0) sent to distinct rows, so no run of thousands is
    left; (b) one run of ``longest`` updates alone on row 0, coefficients
    of magnitudes 1e-3, 1 and 100 (every bf16 add rounds); (c) ``wide``,
    the C = 10 step's ids; (d) the step's runs of 32 or more but row 0's,
    alone; (e) its runs under 32 alone (every run of 32 or more sent to
    distinct rows); (f) its runs of 2 to 31 alone. Then signed zeros,
    bitwise (see ``signed_zero_case``). For an fp32 table also
    ``index_add_`` of the payload made beforehand (a yardstick: the kernel
    forms the payload itself)."""
    gen = torch.Generator(device=DEV).manual_seed(20261019)
    ids, coef, hidx = step
    n = ids.numel()
    pads = (V_TRAIN // 2 + torch.arange(n, device=DEV)).to(torch.int32)
    padded = (torch.arange(n, device=DEV) < ctx) & (coef == 0)
    ids_a = torch.where(padded, pads, ids)
    ids_b = torch.zeros(longest, dtype=torch.int32, device=DEV)
    scale = torch.tensor([1e-3, 1.0, 100.0], device=DEV)[torch.randint(
        0, 3, (longest,), generator=gen, device=DEV)]
    coef_b = torch.randn(longest, generator=gen, device=DEV) * scale
    hidx_b = torch.randint(0, B_TRAIN, (longest,), generator=gen, device=DEV,
                           dtype=torch.int32)
    _, inv, counts = torch.unique(ids, return_inverse=True, return_counts=True)
    run_len = counts[inv]  # each slot's run length
    long_slot = run_len >= 32
    mid = long_slot & (ids != 0)
    cases = {"a": (ids_a, coef, hidx), "b": (ids_b, coef_b, hidx_b), "c": wide,
             "d": tuple(x[mid].contiguous() for x in (ids, coef, hidx)),
             "e": (torch.where(long_slot, pads, ids), coef, hidx),
             "f": tuple(x[(run_len > 1) & ~long_slot].contiguous()
                        for x in (ids, coef, hidx))}
    out = {}
    for key, (i, cf, hx) in cases.items():
        R = rank1_bitwise(torch, b2_kernel(rows_mod), table, i, cf, h, hx,
                          f"scatter_add_rank1 {name} ({key})")
        counts = torch.unique(i, return_counts=True)[1]
        sid, order = fs.sorted_runs(i)
        out[key] = dict(n=i.numel(), runs=R, longest=int(counts.max()),
                        long_runs=int((counts >= 32).sum()),
                        ms=median_ms(torch, lambda: rows_mod.scatter_add_rank1_sorted(
                            table, sid, order, cf, h, hx), flush))
    signed_zero_case(torch, rows_mod, table, gen, name)
    if table.dtype == torch.float32:
        il = ids.long()
        payload = coef[:, None] * h[hidx.long()]
        out["index_add_payload_ms"] = median_ms(
            torch, lambda: table.index_add_(0, il, payload), flush)
    return out


def signed_zero_case(torch, rows_mod, table, gen, name) -> None:
    """Rows 0, 5 and 9 of ``table`` at -0.0 take a long run of 600 (every
    third coefficient 0, the others positive), a run of 7 and a run of 1
    (coefficients 0). Every update's product is -0.0 in columns 0 to 31;
    in columns 32 to 63 the zero coefficients' products are +0.0 and the
    others' -0.0; the rest of ``h`` is negative. So a kernel that skipped a
    zero-coefficient update would leave -0.0 where the plain version, which
    adds every update, gives +0.0: held bit for bit."""
    ids = torch.tensor([0] * 600 + [5] * 7 + [9], dtype=torch.int32, device=DEV)
    zero = torch.zeros(ids.numel(), dtype=torch.bool, device=DEV)
    zero[::3] = True
    zero[600:] = True
    coef = torch.where(zero, 0.0, torch.rand(ids.numel(), generator=gen,
                                             device=DEV) + 0.1)
    hz = -torch.rand((64, D), generator=gen, device=DEV) - 0.5
    hz[:, :32] = -0.0
    hz[0::2, 32:64] = 0.0  # even rows for the zero coefficients
    hz[1::2, 32:64] = -0.0
    pick = torch.randint(0, 32, (ids.numel(),), generator=gen, device=DEV,
                         dtype=torch.int32)
    hidx = torch.where(zero, 2 * pick, 2 * pick + 1).to(torch.int32)
    table[torch.tensor([0, 5, 9], device=DEV)] = -0.0
    rank1_bitwise(torch, b2_kernel(rows_mod), table, ids, coef, hz, hidx,
                  f"scatter_add_rank1 {name} signed zeros")
    got = table[torch.tensor([0, 5, 9], device=DEV)].float()
    expect(bool((torch.signbit(got[:, :32]).all()
                 & ~torch.signbit(got[:, 32:64]).any()).item()),
           f"scatter_add_rank1 {name} signed zeros: not -0.0 / +0.0 as made")
    log(f"scatter_add_rank1 {name} signed zeros: bitwise equal, -0.0 kept in "
        f"columns 0-31 and +0.0 from the zero coefficients in 32-63")


def check_composed_kernels(torch, np, rows_mod, fs) -> dict:
    """Phase 7. Returns per-kernel results of the fp32 full-width case,
    with the worst error over every case."""
    from glint_word2vec_torch.corpus.batching import context_width

    gen = torch.Generator(device=DEV).manual_seed(20261018)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    C = context_width(W_TRAIN)
    rows_v = V_TRAIN + FT_BUCKET
    mhz = sm_clock_mhz()
    out = {}
    # The main path's shapes (C = 7 context lanes at W = 5), then B2 at
    # C = 10 as well (N = 61,440).
    ids0, cmask, ids1, coef, hidx, ids_shared = composed_step_ids(torch, np, gen, C)
    _, _, ids1_w, coef_w, hidx_w, _ = composed_step_ids(torch, np, gen, 10)
    h = torch.randn((B_TRAIN, D), generator=gen, device=DEV)
    upd0 = torch.randn((ids0.shape[0], D), generator=gen, device=DEV) * 0.01
    upd0 *= cmask[:, None]
    scale = torch.tensor([1e-3, 1.0, 100.0], device=DEV)[torch.randint(
        0, 3, (ids0.shape[0], 1), generator=gen, device=DEV)]
    upd_mixed = torch.randn((ids0.shape[0], D), generator=gen, device=DEV) * scale
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        s = 4 if dtype == torch.float32 else 2
        table = (0.3 * torch.randn((rows_v, D), generator=gen, device=DEV)).to(dtype)

        # scatter_add_rank1: syn1 += (coef * h[hidx]) in the table's dtype;
        # each case bitwise, and two calls equal.
        for ids, cf, hx in ((ids1, coef, hidx), (ids1_w, coef_w, hidx_w)):
            R = rank1_bitwise(torch, b2_kernel(rows_mod), table, ids, cf, h, hx,
                              f"scatter_add_rank1 {name} N={ids.numel()}")
            longest = int(torch.unique(ids, return_counts=True)[1].max())
            log(f"scatter_add_rank1 {name} V={rows_v} d={D} N={ids.numel()}: "
                f"bitwise equal, two calls equal (R={R} runs, longest {longest})")
        R = int(torch.unique(ids1).numel())
        counts = torch.unique(ids1, return_counts=True)[1]
        longest = int(counts.max())
        sid, order = fs.sorted_runs(ids1)
        ms = median_ms(torch, lambda: rows_mod.scatter_add_rank1_sorted(
            table, sid, order, coef, h, hidx), flush)
        plain = median_ms(torch, lambda: rows_mod.scatter_add_rank1_reference(
            table, ids1, coef, h, hidx), flush)
        bound, nbytes = scatter_bound(B_TRAIN, ids1.numel(), R, D, s, 16, 2)
        parts = scatter_rank1_parts(
            torch, table, h, (ids1, coef, hidx), B_TRAIN * C,
            (ids1_w, coef_w, hidx_w), longest, flush, rows_mod, fs, name)
        out[("scatter_add_rank1", name)] = dict(
            ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound, runs=R,
            longest=longest, n=ids1.numel(), parts=parts)
        log(f"scatter_add_rank1 {name} N={ids1.numel()}: kernel {ms:.4f} ms "
            f"(sort excluded), plain {plain:.4f} ms, bound {bound:.5f} ms "
            f"({nbytes} bytes; R={R}, longest run {longest}, "
            f"{int((counts >= 32).sum())} runs of 32+ holding "
            f"{int(counts[counts >= 32].sum())} updates)")
        a, b, c = parts["a"], parts["b"], parts["c"]
        yard = parts.get("index_add_payload_ms")
        yard_txt = (f"; index_add_ of the payload made beforehand {yard:.4f} ms"
                    if yard is not None else "")
        log(f"scatter_add_rank1 {name} parts: (a) padded context slots to "
            f"distinct rows (R={a['runs']}, longest {a['longest']}, "
            f"{a['long_runs']} runs of 32+) {a['ms']:.4f} ms; (b) one run of "
            f"{longest} non-zero updates alone {b['ms']:.4f} ms; (c) C = 10 "
            f"N={c['n']} (R={c['runs']}, longest {c['longest']}, "
            f"{c['long_runs']} runs of 32+) {c['ms']:.4f} ms; (d) the runs of "
            f"32+ but row 0's alone (N={parts['d']['n']}, R={parts['d']['runs']}, "
            f"longest {parts['d']['longest']}) {parts['d']['ms']:.4f} ms; (e) "
            f"the runs under 32 alone (R={parts['e']['runs']}) "
            f"{parts['e']['ms']:.4f} ms; (f) the runs of 2 to 31 alone "
            f"(N={parts['f']['n']}, R={parts['f']['runs']}) "
            f"{parts['f']['ms']:.4f} ms{yard_txt}; chain "
            f"floor of the longest run {longest * 4 / (mhz * 1e3):.5f} ms "
            f"({longest} adds x 4 cycles, an fp32 add's latency, at {mhz:.0f} "
            f"MHz, nvidia-smi clocks.max.sm)")

        # scatter_add_rows: syn0 += upd, cast to the table's dtype.
        uniq = torch.unique(ids0.long())
        before = table[uniq].cpu()
        rows_mod.scatter_add_rows(table, ids0, upd0)
        torch.cuda.synchronize()
        R = touched_rows_check(
            torch, table, before, ids0,
            lambda t, local: rows_mod.scatter_add_rows_reference(
                t, local, upd0.cpu()),
            f"scatter_add_rows {name}")
        longest = int(torch.unique(ids0, return_counts=True)[1].max())
        sid, order = fs.sorted_runs(ids0)
        ms = median_ms(torch, lambda: rows_mod.scatter_add_rows_sorted(
            table, sid, order, upd0), flush)
        plain = median_ms(torch, lambda: rows_mod.scatter_add_rows_reference(
            table, ids0, upd0), flush)
        library = None
        if dtype == torch.float32:
            library = median_ms(
                torch, lambda: table.index_add_(0, ids0.long(), upd0), flush)
        bound, nbytes = scatter_bound(ids0.numel(), ids0.numel(), R, D, s, 8, 1)
        sort_ms = median_ms(torch, lambda: fs.sorted_runs(ids0), flush)
        parts = scatter_rows_parts(torch, table, ids0, cmask, ids_shared,
                                   upd_mixed, longest, flush, rows_mod, fs, name)
        out[("scatter_add_rows", name)] = dict(
            ms=ms, plain_ms=plain, library_ms=library, bound_ms=bound, runs=R,
            longest=longest, n=ids0.numel(), sort_ms=sort_ms, **parts)
        lib_txt = f", index_add_ {library:.4f} ms" if library is not None else ""
        log(f"scatter_add_rows {name} V={rows_v} d={D} N={ids0.numel()}: "
            f"bitwise equal (R={R} runs, longest {longest}); kernel "
            f"{ms:.4f} ms (sort excluded), plain {plain:.4f} ms{lib_txt}, "
            f"bound {bound:.5f} ms ({nbytes} bytes); sorted_runs "
            f"{sort_ms:.4f} ms")
        log(f"scatter_add_rows {name} parts: (a) padded slots to distinct "
            f"rows (R={parts['runs_a']}, longest {parts['longest_a']}) "
            f"{parts['a_ms']:.4f} ms; (b) one run of {longest} non-zero "
            f"updates alone {parts['b_ms']:.4f} ms; (c) shared-pool syn1 ids "
            f"N={parts['n_c']} (R={parts['runs_c']}, {parts['long_runs_c']} "
            f"runs of 32+ holding {parts['long_updates_c']} updates) "
            f"{parts['c_ms']:.4f} ms")
        del table
        torch.cuda.empty_cache()
    for r in out.values():
        r["max_abs_err"] = 0.0  # every case above is bitwise
    t_added = time.perf_counter()
    out["train_step_launches"] = check_train_step(torch, np, rows_mod, gen, C)
    log(f"phase 7 addition: (g) {time.perf_counter() - t_added:.1f} s")
    t_added = time.perf_counter()
    out["ops_sgns_launches"] = check_ops_sgns(torch, np, fs, gen, C)
    log(f"phase 7 addition: (h) {time.perf_counter() - t_added:.1f} s")
    return out


#: Tolerances of phase 7 (h): fp32 sums in another order (the composed
#: step's index_add_ on the card adds duplicates in any order).
SGNS_RTOL, SGNS_ATOL, SGNS_LOSS_RTOL = 2e-5, 1e-6, 1e-5


def check_ops_sgns(torch, np, fs, gen, C: int) -> dict:
    """Phase 7 (h): the step functions of ``ops/sgns.py``.
    ``train_step_pairs_fused`` on the card against ``train_step_pairs``
    on the same packed batch and draws, with B4, B6 and B7 each launched
    in it; ``train_step`` and ``sgns_loss`` on the card against their CPU
    runs. Returns the fused step's launches."""
    from glint_word2vec_torch.ops import sgns

    def close(a, b, what):
        err = float((a.float() - b.float()).abs().max())
        expect(torch.allclose(a, b, rtol=SGNS_RTOL, atol=SGNS_ATOL),
               f"{what}: max abs err {err}")
        return err

    def loss_close(a, b, what):
        a, b = float(a), float(b)
        expect(math.isfinite(a) and abs(a - b) <= SGNS_LOSS_RTOL * abs(b),
               f"{what}: loss {a} against {b}")

    (pc, px, pm, negs, _), _ = step_inputs(torch, np, gen)
    s0 = 0.3 * torch.randn((V_TRAIN, D), generator=gen, device=DEV)
    s1 = 0.3 * torch.randn((V_TRAIN, D), generator=gen, device=DEV)
    kernels = (fs.pair_forward, fs.scatter_add_rows_f32, fs.scatter_add_rank1_hbm)
    before = {k.__name__: k.launches for k in kernels}
    f0, f1, fl = sgns.train_step_pairs_fused(s0, s1, pc, px, pm, negs, 0.025)
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    c0, c1, cl = sgns.train_step_pairs(s0, s1, pc, px, pm, negs, 0.025)
    errs = [close(f0, c0, "train_step_pairs_fused syn0"),
            close(f1, c1, "train_step_pairs_fused syn1")]
    loss_close(fl, cl, "train_step_pairs_fused")
    for name, k in launched.items():
        expect(k > 0, f"train_step_pairs_fused never launched {name}: {launched}")
    del f0, f1, c0, c1
    log(f"(h) train_step_pairs_fused at {V_TRAIN} x {D}, P={pc.numel()}, "
        f"n={N_NEG}: loss {float(fl):.6f}, tables within rtol {SGNS_RTOL} / "
        f"atol {SGNS_ATOL} of train_step_pairs (max abs err {max(errs):.3g}); "
        f"launched {launched}")
    # The window step on a 100,000-row slice of the tables, so that the
    # CPU run stays short.
    V = 100_000
    w0, w1 = s0[:V].contiguous(), s1[:V].contiguous()
    del s0, s1
    centers = zipf_ids(torch, gen, (B_TRAIN,), V)
    ctx = zipf_ids(torch, gen, (B_TRAIN, C), V)
    mask = (torch.rand((B_TRAIN, C), generator=gen, device=DEV) < 0.7).float()
    ctx = torch.where(mask > 0, ctx, 0)
    wnegs = zipf_ids(torch, gen, (B_TRAIN, C, N_NEG), V)
    args = (centers, ctx, mask, wnegs)
    g0, g1, gl = sgns.train_step(w0, w1, *args, 0.025)
    gloss = sgns.sgns_loss(w0, w1, *args)
    cpu = [t.cpu() for t in (w0, w1) + args]
    h0, h1, hl = sgns.train_step(*cpu[:2], *cpu[2:], 0.025)
    hloss = sgns.sgns_loss(*cpu[:2], *cpu[2:])
    errs = [close(g0.cpu(), h0, "train_step syn0"),
            close(g1.cpu(), h1, "train_step syn1")]
    loss_close(gl, hl, "train_step")
    loss_close(gloss, hloss, "sgns_loss")
    log(f"(h) train_step and sgns_loss at {V} x {D}, B={B_TRAIN}, C={C}, "
        f"n={N_NEG}: losses {float(gl):.6f} and {float(gloss):.6f}, tables "
        f"within rtol {SGNS_RTOL} / atol {SGNS_ATOL} of the CPU run (max abs "
        f"err {max(errs):.3g})")
    del w0, w1, g0, g1
    torch.cuda.empty_cache()
    return launched


def check_train_step(torch, np, rows_mod, gen, C: int) -> dict:
    """Phase 7 (g): ``train_step`` and ``train_step_grouped`` (the JAX
    engine's one-batch forms) on copies of one 1,000,000 x 300 fp32 table
    pair are bitwise ``train_steps_grouped`` with K = 1 on the same batch
    and the same draws, and run B1, B2 and B3. Returns the one-batch
    calls' launches (the ``train_steps_grouped`` side is not counted)."""
    from glint_word2vec_torch.convert import engine_from_arrays

    counts = np.arange(V_TRAIN, 0, -1, dtype=np.int64)
    syn0 = 0.3 * torch.randn((V_TRAIN, D), generator=gen, device=DEV)
    syn1 = 0.3 * torch.randn((V_TRAIN, D), generator=gen, device=DEV)
    S = 4
    cg = zipf_ids(torch, gen, (B_TRAIN, S), V_TRAIN).to(torch.int32)
    gm = (torch.rand((B_TRAIN, S), generator=gen, device=DEV) < 0.7).float()
    gm[:, 0] = 1.0
    cg = torch.where(gm > 0, cg, 0)
    cx = zipf_ids(torch, gen, (B_TRAIN, C), V_TRAIN).to(torch.int32)
    mk = (torch.rand((B_TRAIN, C), generator=gen, device=DEV) < 0.6).float()
    cx = torch.where(mk > 0, cx, 0)
    counters = (rows_mod.gather_rows, rows_mod.scatter_add_rank1,
                rows_mod.scatter_add_rows)
    launched = {c.__name__: 0 for c in counters}
    for grouped in (False, True):
        one, many = (engine_from_arrays(syn0, syn1, counts, num_negatives=N_NEG,
                                        device=DEV) for _ in range(2))
        before = {c.__name__: c.launches for c in counters}
        if grouped:
            loss = one.train_step_grouped(cg, gm, cx, mk, 77, 0.025)
        else:
            loss = one.train_step(cg[:, 0], cx, mk, 77, 0.025)
            cg1, gm1 = cg[:, :1], torch.ones_like(gm[:, :1])
        torch.cuda.synchronize()
        for c in counters:
            launched[c.__name__] += c.launches - before[c.__name__]
        g, m = (cg, gm) if grouped else (cg1, gm1)
        ref = many.train_steps_grouped(g[None], m[None], cx[None], mk[None], 77,
                                       [0.025], 0)
        what = "train_step_grouped" if grouped else "train_step"
        expect(loss == float(ref[0]), f"{what} loss {loss} != {float(ref[0])}")
        for name in ("syn0", "syn1"):
            expect(torch.equal(bits(torch, getattr(one, name)),
                               bits(torch, getattr(many, name))),
                   f"{what} {name} differs from train_steps_grouped K=1")
        expect(math.isfinite(loss), f"{what} loss {loss}")
        log(f"(g) {what} at {V_TRAIN} x {D}, B={B_TRAIN}, C={C}"
            f"{f', S={S}' if grouped else ''}: loss {loss:.6f}, tables bitwise "
            f"train_steps_grouped with K = 1")
        one.destroy()
        many.destroy()
    del syn0, syn1
    torch.cuda.empty_cache()
    for name, k in launched.items():
        expect(k > 0, f"train_step never launched {name}: {launched}")
    log(f"(g) the one-batch steps launched {launched}")
    return launched


# ----------------------------------------------------------------------
# Phase 8: fastText and the host batcher, trained on the card
# ----------------------------------------------------------------------


def profile_composed(torch, np, model, path: str, groups: int) -> dict:
    """:func:`profile_window` over ``groups`` groups of 16 composed
    fastText steps at full width. The batches come from the host batcher
    over the corpus's first sentences, expanded to subword groups; the
    trained tables train on."""
    from glint_word2vec_torch.corpus.batching import (
        SkipGramBatcher,
        group_batches,
    )
    from glint_word2vec_torch.ops import random as rnd

    sents = []
    with open(path) as f:
        for _ in range((2 * groups + 1) * 16 * B_TRAIN // SENTENCE_LEN + 64):
            sents.append(model.vocab.encode(f.readline().split()))
    batcher = SkipGramBatcher(sents, model.vocab, B_TRAIN, W_TRAIN, seed=2)
    it = group_batches(batcher.epoch(0), 16)
    grps = [next(it) for _ in range(2 * groups + 1)]
    windows = [grps[:1], grps[1 : 1 + groups], grps[1 + groups :]]
    eng, key = model.engine, rnd.seed_key(2)
    step = [0]

    def run(i):
        for g in windows[i]:
            eng.train_steps_grouped(
                model._sub_ids[g.centers], model._sub_mask[g.centers],
                g.contexts, g.mask, key, [0.001] * 16, step[0])
            step[0] += 16

    return profile_window(torch, run, groups * 16, "composed fastText steps")


def tiny_fasttext(FastTextWord2Vec, **kw):
    """The settings of tests/test_fasttext.py:53-58, on the card."""
    return FastTextWord2Vec(
        vector_size=32, min_count=5, batch_size=256, num_iterations=4,
        step_size=0.025, seed=1, bucket=5000, min_n=3, max_n=5, **kw,
    )


def cosine(np, a, b) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def serve_fasttext(torch, np, rows_mod, model, tmp: str) -> None:
    """(d): the saved fastText model served by ``serve_model_dir``; an
    OOV ``/vector`` equals ``transform`` and ``/synonyms`` equals
    ``find_synonyms``, and the gather runs on that path."""
    from glint_word2vec_torch.serving import serve_model_dir

    model_dir = os.path.join(tmp, "ft_served")
    model.save(model_dir)
    want_vec = model.transform("austriaa")
    want_syn = model.find_synonyms("austria", 5)
    port_file = os.path.join(tmp, "ft_port.json")
    failure = []

    def run():
        try:
            serve_model_dir(model_dir, port=0, port_file=port_file, device=DEV)
        except BaseException as e:  # reported by the main thread
            failure.append(e)

    rows_mod.gather_rows.launches = 0
    th = threading.Thread(target=run, name="serve_fasttext", daemon=True)
    th.start()
    t0 = time.perf_counter()
    while not os.path.exists(port_file):
        if failure or not th.is_alive():
            raise RuntimeError(f"serve_model_dir failed: {failure}")
        if time.perf_counter() - t0 > 300:
            raise RuntimeError("fastText server not listening after 300 s")
        time.sleep(0.2)
    with open(port_file) as f:
        port = json.load(f)["port"]
    before = rows_mod.gather_rows.launches
    vec = np.asarray(post(port, "/vector", {"word": "austriaa"}), np.float32)
    grew = rows_mod.gather_rows.launches - before
    err = float(np.abs(vec - want_vec).max())
    expect(err <= 1e-6, f"served OOV /vector differs from transform by {err}")
    expect(grew > 0, "the served OOV /vector never launched gather_rows")
    hits = post(port, "/synonyms", {"word": "austria", "num": 5})
    expect([w for w, _ in hits] == [w for w, _ in want_syn]
           and all(abs(s - t) <= 1e-5 for (_, s), (_, t) in zip(hits, want_syn)),
           f"served /synonyms {hits} differ from find_synonyms {want_syn}")
    expect(post_status(port, "/vector", {"word": "q"}) == 404,
           "an OOV word with no n-gram did not answer 404")
    expect(post(port, "/shutdown", {}) == {"status": "shutting down"},
           "/shutdown was not acknowledged")
    th.join(timeout=120)
    if th.is_alive() or failure:
        raise RuntimeError(f"fastText server did not stop cleanly: {failure}")
    log(f"served fastText model: OOV /vector equals transform (max |diff| "
        f"{err:.3g}), gather_rows launched {grew} time(s) for it; /synonyms "
        f"equals find_synonyms: {hits[:3]} ...")


def fasttext_fit(FastTextWord2Vec, path: str):
    """Phase 8's fastText fit: ``fit_file`` at full width, one epoch."""
    return FastTextWord2Vec(
        vector_size=D, window=W_TRAIN, batch_size=B_TRAIN,
        num_negatives=N_NEG, min_count=MIN_PER_WORD, num_iterations=1,
        step_size=0.025, seed=1, bucket=FT_BUCKET, min_n=3, max_n=6,
        max_subwords=FT_SUBWORDS,
    ).fit_file(path)


def train_fasttext_end_to_end(torch, np, rows_mod) -> dict:
    """Phase 8. Returns the composed step's launch counts from (a)."""
    from glint_word2vec_torch import FastTextWord2Vec, Word2Vec
    from glint_word2vec_torch.models import load_model

    tmp = tempfile.mkdtemp(prefix="glint_chip_fasttext_")
    try:
        path = os.path.join(tmp, "corpus.txt")
        n_tok = write_synthetic_corpus(np, path)

        # (a) The main path: every counter zeroed just before, read just
        # after.
        from glint_word2vec_torch import native

        counters = (rows_mod.scatter_add_rows, rows_mod.scatter_add_rank1,
                    rows_mod.gather_rows)
        for c in counters:
            c.launches = 0
        calls = dict(native.calls)
        t0 = time.perf_counter()
        model = fasttext_fit(FastTextWord2Vec, path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        took = native_calls_since(calls)
        expect(took["corpus_scan"] == 1 and took["window_batch_epoch"] >= 1
               and took["alias_build"] >= 1,
               f"the fastText fit did not take the native host pass: {took}")
        tm = model.training_metrics
        log(f"fastText fit_file {V_TRAIN} words + {FT_BUCKET} buckets x {D}: "
            f"{wall:.1f} s in all (vocabulary scan, encode, subword table, "
            f"training); training {tm['wall_seconds']} s, {tm['steps']} steps, "
            f"{tm['words_per_sec']} words/s, host {tm['host_time']} s, step "
            f"{tm['step_time']} s, final loss {tm['final_loss']}; launches "
            f"{launches}")
        expect(tm["pipeline"] == "host", tm)
        expect(model.engine.num_rows == V_TRAIN + FT_BUCKET,
               f"table rows {model.engine.num_rows}")
        expect(tm["words_done"] == n_tok, tm)
        expect(math.isfinite(tm["final_loss"]), tm)
        groups = tm["steps"] + (-tm["steps"]) % 16
        for name in ("scatter_add_rows", "scatter_add_rank1", "gather_rows"):
            if launches[name] <= 0:
                raise AssertionError(f"the fastText fit never launched {name}")
        for name in ("scatter_add_rows", "scatter_add_rank1"):
            expect(launches[name] == groups,
                   f"one {name} per step: {launches} for {tm['steps']} steps")
        for t in (model.engine.syn0, model.engine.syn1):
            expect(bool(torch.isfinite(t).all()), "non-finite table entries")
        profile_composed(torch, np, model, path, PROFILE_GROUPS)
        model.stop()
        del model
        torch.cuda.empty_cache()
        # (a') A fit through the Python host pass (the numpy batcher on the
        # producer thread, the Python ingestion and alias loop), over the
        # corpus's first PY_PASS_TOKENS tokens.
        prefix = os.path.join(tmp, "prefix.txt")
        n_prefix = write_prefix(path, prefix, PY_PASS_TOKENS)
        with python_host_pass():
            calls = dict(native.calls)
            t0 = time.perf_counter()
            model = fasttext_fit(FastTextWord2Vec, prefix)
            torch.cuda.synchronize()
            wall_py = time.perf_counter() - t0
        expect(not any(native_calls_since(calls).values()),
               "the Python host pass called the native library")
        tp = model.training_metrics
        # min_count drops the prefix's rare words: every kept token trains.
        expect(tp["words_done"] == model.vocab.train_words_count
               and math.isfinite(tp["final_loss"]), tp)
        log(f"fastText fit_file through the Python host pass over a "
            f"{n_prefix}-token prefix ({model.vocab.size} words): {wall_py:.1f} "
            f"s in all, training {tp['wall_seconds']} s, {tp['words_per_sec']} "
            f"words/s, consumer stall (host) {tp['host_time']} s, step "
            f"{tp['step_time']} s")
        model.stop()
        del model
        torch.cuda.empty_cache()

        # (b) The fastText gates of tests/test_fasttext.py on the card.
        corpus = make_tiny_corpus(np)
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            m = tiny_fasttext(FastTextWord2Vec, dtype=dtype).fit(corpus)
            v, v_oov = m.transform("austria"), m.transform("austriaa")
            cos = cosine(np, v, v_oov)
            _, idx = m.engine.top_k_cosine(v, 20)
            syns = m.find_synonyms("austria", 5)
            expect(cos > 0.5, f"{dtype}: OOV cosine {cos}")
            expect(bool((idx < m.vocab.size).all()), "a bucket row surfaced")
            expect(len(syns) == 5 and "austria" not in dict(syns), syns)
            saved = os.path.join(tmp, f"ft_{dtype}")
            m.save(saved)
            loaded = load_model(saved, device=DEV)
            for w in ("austria", "austriaa"):
                a, b = loaded.transform(w), m.transform(w)
                expect(np.allclose(a, b, rtol=1e-5, atol=1e-6),
                       f"{dtype}: {w} changed across save/load_model")
            loaded.stop()
            log(f"tiny_corpus fastText {dtype} on the card in "
                f"{time.perf_counter() - t0:.1f} s: cos(austria, austriaa) "
                f"{cos:.4f}; austria -> {syns[:3]}; save/load_model kept the "
                "vectors")
            if dtype == "float32":
                serve_fasttext(torch, np, rows_mod, m, tmp)
            m.stop()

        # (c) Word2vec through the host batcher: GLINT_HOST_BATCHER=1
        # sends every corpus there.
        os.environ["GLINT_HOST_BATCHER"] = "1"
        try:
            for dtype in ("float32", "bfloat16"):
                m = tiny_w2v(Word2Vec, dtype=dtype).fit(corpus)
                expect(m.training_metrics["pipeline"] == "host", m.training_metrics)
                syns = m.find_synonyms("austria", 10)
                ana = m.analogy(positive=["vienna", "germany"],
                                negative=["austria"], num=10)
                log(f"tiny_corpus word2vec {dtype}, host batcher: austria -> "
                    f"{syns[:4]}; vienna - austria + germany -> {ana[:3]}")
                expect("vienna" in dict(syns) and dict(syns)["vienna"] > 0.5,
                       f"{dtype} host-route vienna gate failed: {syns}")
                expect("berlin" in [w for w, _ in ana],
                       f"{dtype} host-route berlin gate failed: {ana}")
                m.stop()
            ck = os.path.join(tmp, "ck_host")
            tiny_w2v(Word2Vec, num_iterations=2).fit(
                corpus, checkpoint_dir=ck, stop_after_epochs=1).stop()
            resumed = tiny_w2v(Word2Vec, num_iterations=2).fit(
                corpus, checkpoint_dir=ck)
            full = tiny_w2v(Word2Vec, num_iterations=2).fit(corpus)
            for name in ("syn0", "syn1"):
                expect(torch.equal(getattr(resumed.engine, name),
                                   getattr(full.engine, name)),
                       f"host route: resumed {name} differs")
            log("host-batcher resume on the card: 1 epoch + resume + 1 "
                "epoch == 2 epochs, bitwise")
            resumed.stop()
            full.stop()
        finally:
            del os.environ["GLINT_HOST_BATCHER"]
        return {"launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 9: the shared negative pool
# ----------------------------------------------------------------------


def shared_pool_inputs(torch, gen, v: int, S: int):
    """One full-width dense pair batch against a shared pool of S: Zipf
    centers and contexts (ids 0 and V-1 among them), 13 padded slots at
    the end, and a Zipf pool (frequent ids repeat) holding ids 0 and V-1,
    a repeat, and two pairs' contexts."""
    from glint_word2vec_torch.corpus.batching import packed_pair_batch

    P = packed_pair_batch(B_TRAIN, W_TRAIN)
    centers = zipf_ids(torch, gen, (P,), v)
    contexts = zipf_ids(torch, gen, (P,), v)
    centers[:3] = torch.tensor([v - 1, 0, v - 1], dtype=torch.int32)
    contexts[3] = v - 1
    mask = (torch.arange(P, device=DEV) < P - 13).to(torch.float32)
    centers = torch.where(mask > 0, centers, 0)
    contexts = torch.where(mask > 0, contexts, 0)
    pool = zipf_ids(torch, gen, (S,), v)
    for i, x in enumerate([contexts[5], v - 1, 0, pool[0], contexts[3]][:S]):
        pool[i] = x
    return centers, contexts, mask, pool


def pair_forward_shared_bound(P_live, S, d, s, uniq0, uniq1, P, passes):
    """Least time of pair_forward_shared on the card, ms, with the figures
    it comes from. The three pool products (2 * P * S * d flops each, over
    the live pairs) run as split-TF32 passes on the tensor cores: 3 each
    for fp32 tables, and 1 for the logits and 2 for each other product
    for bf16 tables, whose h and pool rows are exact TF32 (``passes`` in
    all). The dot and the c_pos term of d_center run outside them. Bytes:
    the distinct rows read once in storage dtype, the ids, mask and pool
    read, and the fp32 h, d_center and d_pool rows, c_pos and the loss
    written. Returns (tensor-core bound, FFMA bound: all flops over
    67 TFLOP/s, bytes, function flops)."""
    product = 2 * P_live * S * d
    small = 4 * P_live * d
    flops = 3 * product + small
    nbytes = (uniq0 + uniq1) * d * s + P * 12 + S * 4 + (2 * P + S) * d * 4 + P * 4 + 4
    mem = nbytes / HBM_BYTES_PER_S
    tensor = max(mem, passes * product / TF32_FLOPS + small / FP32_FLOPS)
    ffma = max(mem, flops / FP32_FLOPS)
    return tensor * 1e3, ffma * 1e3, nbytes, flops


#: B5's launches, by the name of their kernel function, in launch order,
#: with the pool products each runs (``grads_kernel`` runs d_center's and
#: d_pool's, split into chunks of K; ``finish_kernel`` sums the chunks).
#: ``d_center_kernel`` and ``d_pool_kernel`` are an older tree's, whose
#: launches this script times to compare.
B5_LAUNCHES = {"stage_kernel": 0, "pool_logits_kernel": 1, "grads_kernel": 2,
               "finish_kernel": 0, "d_center_kernel": 1, "d_pool_kernel": 1}


def b5_launch_times(torch, fn, calls: int = 10) -> dict:
    """Mean device time, ms, of each of B5's launches over ``calls`` calls
    of ``fn`` in one ``torch.profiler`` window (no L2 flush between)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(B5_LAUNCHES, 0.0)
    count = dict.fromkeys(B5_LAUNCHES, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for k in B5_LAUNCHES:
            if k in e.name:
                total[k] += e.time_range.end - e.time_range.start
                count[k] += 1
                break
    return {k: total[k] / count[k] / 1e3 if count[k] else None for k in B5_LAUNCHES}


def b5_f64_errors(torch, fs, args, outs) -> dict:
    """Norm-wise relative error ||x - x64|| / ||x64|| of ``d_center`` and
    ``d_pool`` in each of ``outs`` against the estimator computed in
    float64 on the card from the same tables and ids."""
    syn0, syn1, centers, contexts, mask, pool, alpha, n = args
    h = syn0[centers.long()].double()
    u = syn1[contexts.long()].double()
    up = syn1[pool.long()].double()
    a, m = alpha.double(), mask.double()
    keep = (pool[None, :] != contexts[:, None]).double()
    w = (m * fs._pool_weight(n, pool.shape[0]))[:, None] * keep
    c_pos = a * (1.0 - torch.sigmoid((h * u).sum(-1))) * m
    c_pool = -a * torch.sigmoid(h @ up.T) * w
    want = {"d_center": c_pos[:, None] * u + c_pool @ up, "d_pool": c_pool.T @ h}
    return {
        name: [float(torch.linalg.vector_norm(getattr(o, name).double() - x)
                     / torch.linalg.vector_norm(x)) for o in outs]
        for name, x in want.items()
    }


def b5_breakdown(torch, fs, args, P_live, S, flush) -> str:
    """Phase 9 (a) at S = 4,096: the device time, TFLOP/s and waves of
    each of B5's launches, and ``torch.matmul`` (fp32, TF32 off) on each
    of the three products at the same shapes, a yardstick the port never
    calls."""
    syn0, syn1, centers, contexts, mask, pool = args[:6]
    # An older tree run with this script to compare (one whose B5 has no
    # grid query, and separate d_center and d_pool launches) gets no waves.
    grid_of = getattr(fs, "pair_forward_shared_grid", None)
    grid = grid_of(centers.numel(), S, D, syn0.dtype) if grid_of else None
    waves = {k: grid[k][0] / (grid[k][1] * grid["sms"])
             for k in ("logits", "grads")} if grid else {}
    h = syn0[centers.long()].float()
    up = syn1[pool.long()].float()
    gen = torch.Generator(device=DEV).manual_seed(7)
    c_pool = 1e-4 * torch.randn((h.shape[0], S), generator=gen, device=DEV)
    launch = b5_launch_times(torch, lambda: fs.pair_forward_shared(*args))
    product = 2 * P_live * S * D
    mm = {
        "logits": median_ms(torch, lambda: h @ up.T, flush),
        "d_center": median_ms(torch, lambda: c_pool @ up, flush),
        "d_pool": median_ms(torch, lambda: c_pool.t() @ h, flush),
    }
    parts = []
    for k, v in launch.items():
        if v is None:
            continue
        n = B5_LAUNCHES[k]
        rate = f" ({n * product / (v * 1e-3) / 1e12:.2f} TFLOP/s)" if n else ""
        parts.append(f"{k} {v:.4f} ms{rate}")
    mms = ", ".join(f"{k} {v:.4f} ms ({product / (v * 1e-3) / 1e12:.2f} TFLOP/s)"
                    for k, v in mm.items())
    shape = ", ".join(f"{k} {grid[k][0]} blocks, {grid[k][1]} an SM on "
                      f"{grid['sms']} SMs: {waves[k]:.3f} waves"
                      for k in waves) or "waves not measured"
    return (f"launches (profiler, mean of 10 calls): {'; '.join(parts)}; "
            f"{shape}; torch.matmul fp32 yardsticks: {mms}")


def check_shared_kernel(torch, fs) -> dict:
    """Phase 9 (a). B5 against its plain version (which runs its three
    products through cuBLAS in fp32: no TF32) at full width, fp32 and
    bf16, S = 4,096, then S = 5 and 257, and an fp32 10,000,000 x 300
    table. At S = 4,096 on 1,000,000 rows also each launch's time and
    waves, the matmul yardsticks and the two bounds; there, in fp32 and
    bf16, two calls must be bitwise equal and the kernel's error against
    float64 at most 10 times the plain version's. Returns the fp32 and bf16 S = 4,096 results with
    the worst error over every case."""
    import glint_word2vec_torch.device  # noqa: F401  (TF32 off)

    expect(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    gen = torch.Generator(device=DEV).manual_seed(20261019)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    alpha = torch.tensor(0.025, device=DEV)
    out, worst = {}, 0.0
    cases = [(torch.float32, V_TRAIN, (S_POOL, 5, 257)),
             (torch.bfloat16, V_TRAIN, (S_POOL,)),
             (torch.float32, V_BIG, (S_POOL,))]
    for dtype, v, pools in cases:
        name = "f32" if dtype == torch.float32 else "bf16"
        s = 4 if dtype == torch.float32 else 2
        syn0 = (0.3 * torch.randn((v, D), generator=gen, device=DEV)).to(dtype)
        syn1 = (0.3 * torch.randn((v, D), generator=gen, device=DEV)).to(dtype)
        for S in pools:
            centers, contexts, mask, pool = shared_pool_inputs(torch, gen, v, S)
            args = (syn0, syn1, centers, contexts, mask, pool, alpha, N_NEG)
            fw = fs.pair_forward_shared(*args)
            torch.cuda.synchronize()
            ref = fs.pair_forward_shared_reference(*args)
            what = f"pair_forward_shared {name} V={v} S={S}"
            expect(torch.equal(fw.h, ref.h), f"{what}: h differs")
            e = 0.0
            for field, rtol in (("c_pos", 1e-5), ("d_center", 1e-4), ("d_pool", 1e-4)):
                g, w = getattr(fw, field), getattr(ref, field)
                diff = (g - w).abs()
                if field == "c_pos":
                    tol = rtol * w.abs() + 1e-6 * float(w.abs().max())
                else:
                    tol = rtol * w.abs() + 1e-6
                expect(bool((diff <= tol).all()),
                       f"{what}: {field} off by {diff.max().item()}")
                e = max(e, float(diff.max()))
            rel = abs(float(fw.loss_sum) - float(ref.loss_sum)) / abs(float(ref.loss_sum))
            expect(rel <= 1e-5, f"{what}: loss off by rel {rel}")
            worst = max(worst, e)
            P = centers.numel()
            P_live = int(mask.sum())
            uniq0 = int(torch.unique(centers).numel())
            uniq1 = int(torch.unique(torch.cat([contexts, pool])).numel())
            passes = 9 if dtype == torch.float32 else 5
            bound, ffma, nbytes, flops = pair_forward_shared_bound(
                P_live, S, D, s, uniq0, uniq1, P, passes)
            timed = ""
            if S == S_POOL and v == V_TRAIN:
                again = fs.pair_forward_shared(*args)
                for f in again._fields:
                    expect(torch.equal(getattr(again, f), getattr(fw, f)),
                           f"{what}: two calls differ in {f}")
                err = b5_f64_errors(torch, fs, args, (fw, ref))
                for f, (ek, ep) in err.items():
                    expect(ek <= 10 * ep, f"{what}: {f} error against "
                           f"float64 {ek:.3g}, over 10x the plain's {ep:.3g}")
                log(f"{what}: two calls bitwise equal; norm-wise error "
                    "against float64, kernel / plain: " + ", ".join(
                        f"{f} {ek:.3g} / {ep:.3g}" for f, (ek, ep) in err.items()))
                del again
                ms = median_ms(torch, lambda: fs.pair_forward_shared(*args), flush)
                plain = median_ms(
                    torch, lambda: fs.pair_forward_shared_reference(*args), flush)
                out[name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                 bound_ms=bound)
                timed = (f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                         f"{bound:.5f} ms ({passes} split-TF32 passes of "
                         f"{2 * P_live * S * D} flops at 495 TFLOP/s; {nbytes} "
                         f"bytes), FFMA bound {ffma:.5f} ms ({flops} flops at "
                         f"67 TFLOP/s), {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; "
                         + b5_breakdown(torch, fs, args, P_live, S, flush))
            log(f"{what} d={D} P={P} n={N_NEG}: h bitwise, c_pos within rtol "
                f"1e-5, d_center and d_pool within rtol 1e-4 atol 1e-6 (max "
                f"|diff| {e:.3g}), loss rel {rel:.2g}{timed}")
            del fw, ref
        del syn0, syn1
        torch.cuda.empty_cache()
    for r in out.values():
        r["max_abs_err"] = worst
    return out


def train_shared_end_to_end(torch, np, fs, rows_mod) -> dict:
    """Phase 9 (b) to (d). Returns B5's launch count from (b)."""
    from glint_word2vec_torch import FastTextWord2Vec, Word2Vec

    tmp = tempfile.mkdtemp(prefix="glint_chip_shared_")
    try:
        # The corpus's first SHARED_TOKENS tokens, every word kept.
        path = os.path.join(tmp, "shared.txt")
        n_tok = write_synthetic_corpus(np, path, tokens=SHARED_TOKENS)

        # (b) The main path: every counter zeroed just before, read just
        # after.
        counters = (fs.pair_forward_shared, fs.pair_forward,
                    fs.scatter_add_rank1_hbm, fs.scatter_add_rows_f32)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        model = Word2Vec(
            vector_size=D, window=W_TRAIN, batch_size=B_TRAIN,
            num_negatives=N_NEG, min_count=1, num_iterations=1,
            step_size=0.025, seed=1,
        ).set_shared_negatives(S_POOL).fit_file(path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        tm = model.training_metrics
        log(f"shared-pool fit_file on the corpus's first {n_tok} tokens, "
            f"{model.vocab.size} x {D}, S={S_POOL}: {wall:.1f} s in all; "
            f"training {tm['wall_seconds']} s, {tm['steps']} steps, "
            f"{tm['words_per_sec']} words/s, final loss {tm['final_loss']}; "
            f"launches {launches}")
        expect(tm["pipeline"] == "device_corpus", tm)
        expect(tm["words_done"] == n_tok, tm)
        expect(math.isfinite(tm["final_loss"]), tm)
        # Groups of 16 steps, and the epoch's phantom group.
        steps = tm["steps"] + (-tm["steps"]) % 16 + 16
        expect(launches["pair_forward_shared"] == steps,
               f"one pair_forward_shared per step: {launches} for {tm['steps']} steps")
        expect(launches["pair_forward"] == 0, f"pair_forward launched: {launches}")
        expect(launches["scatter_add_rank1_hbm"] == steps
               and launches["scatter_add_rows_f32"] == 2 * steps,
               f"scatters per step: {launches}")
        for t in (model.engine.syn0, model.engine.syn1):
            expect(bool(torch.isfinite(t).all()), "non-finite table entries")
        profile_training(torch, model.engine, PROFILE_GROUPS)
        model.stop()
        del model
        torch.cuda.empty_cache()

        # (c) The tiny_corpus gates of tests/test_shared_negatives.py with
        # a pool of 256: the resident route and the host batcher, fp32 and
        # bf16, then fastText.
        corpus = make_tiny_corpus(np)
        try:
            for route in ("device_corpus", "host"):
                if route == "host":
                    os.environ["GLINT_HOST_BATCHER"] = "1"
                for dtype in ("float32", "bfloat16"):
                    before = (rows_mod.gather_rows.launches,
                              rows_mod.scatter_add_rows.launches,
                              rows_mod.scatter_add_rank1.launches)
                    m = tiny_w2v(Word2Vec, dtype=dtype).set_shared_negatives(256).fit(corpus)
                    grew = [a - b for a, b in zip(
                        (rows_mod.gather_rows.launches,
                         rows_mod.scatter_add_rows.launches,
                         rows_mod.scatter_add_rank1.launches), before)]
                    tm = m.training_metrics
                    expect(tm["pipeline"] == route, tm)
                    hits = {c: [w for w, _ in m.find_synonyms(c, 10)]
                            for c in ("germany", "france")}
                    log(f"tiny_corpus shared pool {dtype}, {route}: germany -> "
                        f"{hits['germany'][:4]}; france -> {hits['france'][:4]}")
                    expect("berlin" in hits["germany"] and "paris" in hits["france"],
                           f"{dtype} {route} shared-pool gates failed: {hits}")
                    if route == "host":
                        # The composed shared step: the pool pulled by the
                        # gather, both tables landed by scatter_add_rows
                        # (twice a step, the groups' pad steps too).
                        expect(grew[0] > 0 and grew[1] >= 2 * tm["steps"],
                               f"host-route launches {grew}")
                        expect(grew[2] == 0, f"scatter_add_rank1 launched {grew}")
                    m.stop()
        finally:
            os.environ.pop("GLINT_HOST_BATCHER", None)
        m = tiny_fasttext(FastTextWord2Vec, shared_negatives=256).fit(corpus)
        v, v_oov = m.transform("austria"), m.transform("austriaa")
        cos = cosine(np, v, v_oov)
        _, idx = m.engine.top_k_cosine(v, 20)
        log(f"tiny_corpus fastText shared pool: cos(austria, austriaa) {cos:.4f}")
        expect(cos > 0.5, f"fastText shared pool: OOV cosine {cos}")
        expect(bool((idx < m.vocab.size).all()), "a bucket row surfaced")
        m.stop()

        # (d) Resume with the shared pool, bitwise.
        ck = os.path.join(tmp, "ck_shared")
        tiny_w2v(Word2Vec, num_iterations=2).set_shared_negatives(256).fit(
            corpus, checkpoint_dir=ck, stop_after_epochs=1).stop()
        resumed = tiny_w2v(Word2Vec, num_iterations=2).set_shared_negatives(
            256).fit(corpus, checkpoint_dir=ck)
        full = tiny_w2v(Word2Vec, num_iterations=2).set_shared_negatives(256).fit(corpus)
        for name in ("syn0", "syn1"):
            expect(torch.equal(getattr(resumed.engine, name), getattr(full.engine, name)),
                   f"shared pool: resumed {name} differs")
        log("shared-pool resume on the card: 1 epoch + resume + 1 epoch == 2 "
            "epochs, bitwise")
        resumed.stop()
        full.stop()
        return {"launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 10: grid packing on the device corpus, mid-epoch resume, wide rows
# ----------------------------------------------------------------------


def kernel_counters(fs, rows_mod) -> tuple:
    """Every kernel wrapper's launch counter."""
    return (rows_mod.gather_rows, rows_mod.scatter_add_rank1,
            rows_mod.scatter_add_rows, fs.pair_forward, fs.pair_forward_shared,
            fs.scatter_add_rank1_hbm, fs.scatter_add_rows_f32)


def zero_counters(fs, rows_mod) -> None:
    for c in kernel_counters(fs, rows_mod):
        c.launches = 0
    fs.pair_forward.tiled_launches = 0


def read_counters(fs, rows_mod) -> dict:
    out = {c.__name__: c.launches for c in kernel_counters(fs, rows_mod)}
    out["pair_forward (tiled form)"] = fs.pair_forward.tiled_launches
    return out


def expect_launched(launches: dict, names, what: str) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{what} never launched {name}: {launches}")


def profile_grid(torch, engine, groups: int) -> dict:
    """:func:`profile_window` over ``groups`` grid groups (16 steps each)
    on the device corpus at full width, from the corpus's start; the
    trained tables train on."""
    from glint_word2vec_torch.ops import random as rnd

    key = rnd.seed_key(2)
    step = [0]

    def run(_):
        for _ in range(groups):
            engine.train_steps_corpus(step[0] * B_TRAIN, B_TRAIN, W_TRAIN, key,
                                      [0.001] * 16, step[0])
            step[0] += 16

    return profile_window(torch, run, groups * 16, "grid steps")


def train_grid_and_resume(torch, np, fs, rows_mod) -> dict:
    """Phase 10. Returns the launch counts of (a) and (d)."""
    from glint_word2vec_torch import Word2Vec

    tmp = tempfile.mkdtemp(prefix="glint_chip_grid_")
    try:
        path = os.path.join(tmp, "corpus.txt")
        write_synthetic_corpus(np, path)
        full_width = dict(vector_size=D, window=W_TRAIN, batch_size=B_TRAIN,
                          num_negatives=N_NEG, min_count=MIN_PER_WORD,
                          num_iterations=1, step_size=0.025, seed=1)

        # (a) Grid batches on the device corpus, one epoch over the
        # corpus's first GRID_TOKENS tokens, every word kept (the table
        # keeps about its full width): B1, B2, B3 every step, the fused
        # pair step never.
        grid_path = os.path.join(tmp, "grid.txt")
        n_grid = write_prefix(path, grid_path, GRID_TOKENS)
        zero_counters(fs, rows_mod)
        t0 = time.perf_counter()
        model = Word2Vec(**dict(full_width, min_count=1),
                         batch_packing="grid").fit_file(grid_path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grid_launches = read_counters(fs, rows_mod)
        tm = model.training_metrics
        log(f"grid fit_file on the corpus's first {n_grid} tokens, "
            f"{model.vocab.size} x {D}, on the device corpus: {wall:.1f} s in "
            f"all; training {tm['wall_seconds']} s, {tm['steps']} steps, "
            f"{tm['words_per_sec']} words/s, final loss {tm['final_loss']}; "
            f"launches {grid_launches}")
        expect(tm["pipeline"] == "device_corpus" and tm["batch_packing"] == "grid", tm)
        expect(tm["words_done"] == n_grid and math.isfinite(tm["final_loss"]), tm)
        expect_launched(grid_launches, ("gather_rows", "scatter_add_rank1",
                                        "scatter_add_rows"), "the grid fit")
        steps = tm["steps"] + (-tm["steps"]) % 16
        expect(grid_launches["gather_rows"] == 3 * steps
               and grid_launches["scatter_add_rank1"] == steps
               and grid_launches["scatter_add_rows"] == steps
               and grid_launches["pair_forward"] == 0,
               f"grid launches a step: {grid_launches} for {tm['steps']} steps")
        for t in (model.engine.syn0, model.engine.syn1):
            expect(bool(torch.isfinite(t).all()), "non-finite table entries")
        window = profile_grid(torch, model.engine, PROFILE_GROUPS)
        model.stop()
        del model
        torch.cuda.empty_cache()

        # (b) The tiny_corpus gates under grid packing.
        corpus = make_tiny_corpus(np)
        m = tiny_w2v(Word2Vec, batch_packing="grid").fit(corpus)
        syns = m.find_synonyms("austria", 10)
        ana = m.analogy(positive=["vienna", "germany"], negative=["austria"], num=10)
        log(f"tiny_corpus grid fit on the card: austria -> {syns[:4]}; "
            f"vienna - austria + germany -> {ana[:3]}")
        expect(m.training_metrics["batch_packing"] == "grid", m.training_metrics)
        expect("vienna" in dict(syns) and dict(syns)["vienna"] > 0.5,
               f"grid vienna gate failed: {syns}")
        expect("berlin" in [w for w, _ in ana], f"grid berlin gate failed: {ana}")
        m.stop()

        # (c) The mid-epoch drill at full width over the corpus's first
        # DRILL_TOKENS tokens, every word kept: stop after 3 groups, resume
        # from the position, equal the uninterrupted epoch bitwise.
        drill_path = os.path.join(tmp, "drill.txt")
        write_prefix(path, drill_path, DRILL_TOKENS)
        drill_width = dict(full_width, min_count=1)
        ck = os.path.join(tmp, "ck")
        zero_counters(fs, rows_mod)
        os.environ["GLINT_PACKED_STOP_AFTER_GROUPS"] = "3"
        try:
            Word2Vec(**drill_width).fit_file(drill_path, checkpoint_dir=ck).stop()
        finally:
            os.environ.pop("GLINT_PACKED_STOP_AFTER_GROUPS", None)
        with open(os.path.join(ck, "train_state.json")) as f:
            state = json.load(f)
        expect(state["position"] > 0 and state["epochs_completed"] == 0, state)
        t0 = time.perf_counter()
        resumed = Word2Vec(**drill_width).fit_file(drill_path, checkpoint_dir=ck)
        resume_s = time.perf_counter() - t0
        drill_launches = read_counters(fs, rows_mod)
        expect_launched(drill_launches, ("pair_forward", "scatter_add_rank1_hbm",
                                         "scatter_add_rows_f32"), "the drill")
        full = Word2Vec(**drill_width).fit_file(drill_path)
        for name in ("syn0", "syn1"):
            expect(torch.equal(getattr(resumed.engine, name), getattr(full.engine, name)),
                   f"mid-epoch drill: resumed {name} differs from the uninterrupted run")
        log(f"mid-epoch drill at {resumed.vocab.size} x {D} over {DRILL_TOKENS} "
            f"tokens: stopped after 3 groups at "
            f"position {state['position']} (step {state['step']}, words_done "
            f"{state['words_done']}); the resumed run ({resume_s:.1f} s) equals "
            "the uninterrupted epoch bitwise")
        resumed.stop()
        full.stop()
        del resumed, full
        torch.cuda.empty_cache()

        # (d) Rows past the one-pass form's shared memory train: the tiled
        # form on every step, over the corpus's first WIDE_TOKENS tokens
        # (every word kept: a Zipf vocabulary, as a real corpus has).
        wide_path = os.path.join(tmp, "wide.txt")
        write_prefix(path, wide_path, WIDE_TOKENS)
        wide = {}
        for d, n in ((2_200, 25), (20_000, 5)):
            zero_counters(fs, rows_mod)
            m = Word2Vec(vector_size=d, num_negatives=n, window=W_TRAIN,
                         batch_size=B_TRAIN, min_count=1, num_iterations=1,
                         step_size=0.025, seed=1).fit_file(wide_path)
            launches = read_counters(fs, rows_mod)
            tm = m.training_metrics
            expect_launched(launches, ("pair_forward", "pair_forward (tiled form)",
                                       "scatter_add_rank1_hbm",
                                       "scatter_add_rows_f32"),
                            f"the d={d}, n={n} fit")
            expect(launches["pair_forward (tiled form)"] == launches["pair_forward"],
                   f"d={d}, n={n}: not every launch took the tiled form: {launches}")
            expect(math.isfinite(tm["final_loss"]), tm)
            for t in (m.engine.syn0, m.engine.syn1):
                expect(bool(torch.isfinite(t).all()), "non-finite table entries")
            log(f"Word2Vec(vector_size={d}, num_negatives={n}) fit_file over "
                f"{WIDE_TOKENS} tokens, {m.vocab.size} words: {tm['steps']} "
                f"steps, {tm['words_per_sec']} words/s, final loss "
                f"{tm['final_loss']}; launches {launches}")
            wide[(d, n)] = launches
            m.stop()
        return {"grid": grid_launches, "window": window, "wide": wide}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 11: the stall-free fit loop and its observability at full width
# ----------------------------------------------------------------------


class HeartbeatPoller:
    """Polls a fit's heartbeat (``/healthz`` and
    ``/metrics?format=prometheus``) every ``period`` seconds on a thread
    of its own, once the server has bound; keeps what it saw while the
    fit was running."""

    def __init__(self, obs, period: float = 0.5):
        self.obs, self.period = obs, period
        self.running = []  # (healthz dict, prometheus text) mid-fit
        # Failed polls followed by a good one; those after the last good
        # poll met the server shutting down with the fit.
        self.errors, self._pending = [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.period):
            port = self.obs.bound_port
            if port is None:
                continue
            try:
                health = get_json(port, "/healthz")
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics?format=prometheus",
                        timeout=10) as r:
                    text = r.read().decode()
            except (OSError, ValueError) as e:
                self._pending.append(repr(e))
                continue
            self.errors += self._pending
            self._pending = []
            if health.get("state") == "running" and len(self.running) < 50:
                self.running.append((health, text))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)


def span_seconds(log_path: str, name: str) -> list:
    """Durations in seconds of the spans ``name`` of a JSONL event log."""
    out = []
    with open(log_path) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("name") == name and ev.get("ph") == "X":
                out.append(ev["dur"] / 1e6)
    return out


def packed_groups(log_path: str) -> tuple:
    """(dispatched packed groups, groups read back with live steps, live
    steps) of a JSONL event log."""
    dispatched = live = steps = 0
    with open(log_path) as f:
        for line in f:
            ev = json.loads(line)
            args = ev.get("args", {})
            if ev.get("name") == "device_steps" and args.get("packed"):
                dispatched += 1
            elif ev.get("name") == "readback_harvest" and args.get("n"):
                live += 1
                steps += args["n"]
    return dispatched, live, steps


def obs_cost(log_path: str, status, train_s: float, tmp: str) -> None:
    """The host cost of the observability hooks in a fit: the events its
    log holds, times the cost of one span with a JSONL sink, one status
    update and one heartbeat render (snapshot plus Prometheus text,
    twice a second while polled), each timed here over many calls, on
    this machine's host."""
    from glint_word2vec_torch.obs import ObsConfig, ObsRun
    from glint_word2vec_torch.obs.prometheus import training_to_prometheus

    with open(log_path) as f:
        n_events = sum(1 for _ in f)
    run = ObsRun(ObsConfig(event_log=os.path.join(tmp, "cost.jsonl"),
                           status_file=os.path.join(tmp, "cost-status.json")))
    try:
        n = 20_000
        t0 = time.perf_counter()
        for i in range(n):
            with run.span("device_steps", step0=i, n=16, packed=True):
                pass
        span_s = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for i in range(n):
            run.update(step=i, words_done=i, alpha=0.01)
        update_s = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for _ in range(200):
            training_to_prometheus(status.snapshot())
        render_s = (time.perf_counter() - t0) / 200
    finally:
        run.close()
    total = n_events * span_s + n_events / 2 * update_s + 2 * train_s * render_s
    log(f"obs hooks on this host: {n_events} events in (a)'s log, "
        f"{span_s * 1e6:.2f} us a span with the JSONL sink, "
        f"{update_s * 1e6:.2f} us a status update, {render_s * 1e3:.3f} ms a "
        f"heartbeat render; about {total:.3f} s of (a)'s {train_s:.1f} s "
        f"training ({100 * total / train_s:.2f} %)")


def check_deferred_dispatch_syncs_nothing(torch, np, engine) -> None:
    """One packed group enqueued from a device-scalar start position with
    no readback, under CUDA sync debug mode "error": any host-device
    synchronization in the dispatch raises."""
    from glint_word2vec_torch.corpus.batching import packed_pair_batch
    from glint_word2vec_torch.ops import random as rnd

    P = packed_pair_batch(B_TRAIN, W_TRAIN)
    start = torch.zeros((), dtype=torch.int64, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        group = engine.train_steps_corpus_packed(
            start, P, W_TRAIN, B_TRAIN, rnd.seed_key(3), 16, step0=0,
            step_size=0.001, total_words=CORPUS_TOKENS + 1, readback=False)
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t0 = time.perf_counter()
    losses = engine.packed_readback(group)[0]
    wait_s = time.perf_counter() - t0
    expect(bool(np.isfinite(losses).all()), f"deferred group losses {losses}")
    log(f"one packed group of 16 steps enqueued with no synchronization in "
        f"{enqueue_s * 1e3:.1f} ms (host), read back {wait_s * 1e3:.1f} ms "
        "later")


def canary_abort_drill(torch, np, tmp: str) -> None:
    """The canary's abort path on the card: ``tiny_corpus`` with syn0 set
    to NaN before the first step, so the fused kernels' first losses are
    NaN; the fit must raise TrainingDiverged, leave ``ckpt-diverged`` and
    no ``train_state.json``, and publish ``diverged``."""
    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.obs import ObsConfig, TrainingDiverged

    class Poisoned(Word2Vec):
        def _make_engine(self, vocab, mesh=None):
            eng = super()._make_engine(vocab, mesh)
            eng.syn0.fill_(float("nan"))
            return eng

    ck = os.path.join(tmp, "ck-canary")
    status = os.path.join(tmp, "canary-status.json")
    obs = ObsConfig(status_file=status, status_interval=0.0, canary="abort",
                    canary_check_every=1)
    try:
        tiny_w2v(Poisoned, obs=obs, num_iterations=1).fit(
            make_tiny_corpus(np), checkpoint_dir=ck)
    except TrainingDiverged as e:
        reason = str(e)
    else:
        raise AssertionError("the poisoned fit did not trip the canary")
    with open(status) as f:
        state = json.load(f)["state"]
    expect("non-finite" in reason, reason)
    expect(os.path.exists(os.path.join(ck, "ckpt-diverged", "manifest.json")),
           "no ckpt-diverged snapshot")
    expect(not os.path.exists(os.path.join(ck, "train_state.json")),
           "the canary abort flipped train_state.json")
    expect(state == "diverged", f"status {state}")
    log(f"canary abort drill on the card: TrainingDiverged({reason!r}); "
        "ckpt-diverged written, train_state.json untouched, status diverged")


def a_status(model):
    """A TrainingStatus over a fitted model's metrics-free engine, for
    timing the heartbeat's render."""
    from glint_word2vec_torch.obs import StepTimeLedger, TrainingStatus

    return TrainingStatus(pipeline="device_corpus", engine=model.engine,
                          ledger=StepTimeLedger())


def train_stall_free(torch, np, fs, rows_mod) -> dict:
    """Phase 11. Returns the launch counts of (a)."""
    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.obs import ObsConfig
    from glint_word2vec_torch.obs.prometheus import lint_prometheus_text

    tmp = tempfile.mkdtemp(prefix="glint_chip_stall_")
    try:
        # The corpus's first STALL_TOKENS tokens, every word kept.
        path = os.path.join(tmp, "stall.txt")
        n_tok = write_synthetic_corpus(np, path, tokens=STALL_TOKENS)
        log(f"phase 11 scratch: {shutil.disk_usage(tmp).free / 2**30:.1f} GiB "
            "free on its disk")
        width = dict(vector_size=D, window=W_TRAIN, batch_size=B_TRAIN,
                     num_negatives=N_NEG, min_count=1,
                     num_iterations=2, step_size=0.025, seed=1,
                     subsample_ratio=1e-3)
        three = ("pair_forward", "scatter_add_rank1_hbm", "scatter_add_rows_f32")

        # (a) The defaults (deferred readbacks, async checkpoints,
        # compaction prefetch) with every observability hook on.
        files = {k: os.path.join(tmp, f"a-{k}") for k in
                 ("events.jsonl", "status.json", "STEPTIME.json")}
        obs = ObsConfig(event_log=files["events.jsonl"],
                        status_file=files["status.json"], status_port=0,
                        canary="warn", steptime_path=files["STEPTIME.json"])
        ck_a = os.path.join(tmp, "ck-a")
        zero_counters(fs, rows_mod)
        with HeartbeatPoller(obs) as poller:
            t0 = time.perf_counter()
            a = Word2Vec(**width, obs=obs).fit_file(path, checkpoint_dir=ck_a)
            torch.cuda.synchronize()
            wall_a = time.perf_counter() - t0
        launches_a = read_counters(fs, rows_mod)
        tm_a = a.training_metrics
        dispatched, live, steps = packed_groups(files["events.jsonl"])
        expect(tm_a["words_done"] == 2 * n_tok and math.isfinite(tm_a["final_loss"]),
               tm_a)
        expect(steps == tm_a["steps"] and dispatched == live + 2,
               f"(a) {dispatched} groups dispatched, {live} live, {steps} "
               f"steps, metrics {tm_a['steps']}: one phantom an epoch")
        for name in three:
            expect(launches_a[name] == 16 * dispatched,
                   f"(a) {name} launched {launches_a[name]} times for "
                   f"{dispatched} groups of 16 steps")
        expect(launches_a["pair_forward (tiled form)"] == 0, launches_a)
        expect(a.engine.checkpoint_stats()["forced_sync_saves"] == 0,
               a.engine.checkpoint_stats())
        expect(poller.running and not poller.errors,
               f"heartbeat polls mid-fit: {len(poller.running)}, errors "
               f"{poller.errors[:3]}")
        for health, text in poller.running:
            expect(health["status"] == "ok" and health["pipeline"] == "device_corpus",
                   health)
            lint_prometheus_text(text)
            expect("glint_training_device_stall_seconds" in text, text[:200])
        with open(files["status.json"]) as f:
            status = json.load(f)
        expect(status["state"] == "done" and status["pending_async_saves"] == 0,
               status)
        snap_a = span_seconds(files["events.jsonl"], "ckpt_snapshot")
        write_a = span_seconds(files["events.jsonl"], "ckpt_write")
        expect(len(snap_a) == 2 and len(write_a) == 2, (snap_a, write_a))
        mem = status.get("device_memory", {})
        log(f"(a) deferred readbacks, async checkpoints, compaction prefetch, "
            f"obs on, {a.vocab.size} x {D} over {n_tok} tokens: {wall_a:.1f} s "
            f"in all; {tm_a['steps']} steps, "
            f"{tm_a['words_per_sec']} words/s, device_stall_seconds "
            f"{tm_a['device_stall_seconds']}, ckpt_snapshot s {snap_a}, "
            f"ckpt_write s {write_a}, steptime {tm_a['steptime']}; "
            f"{dispatched} packed groups dispatched ({live} live), launches "
            f"{ {k: launches_a[k] for k in three} }; {len(poller.running)} "
            f"heartbeat polls mid-fit, last healthz {poller.running[-1][0]}; "
            f"device memory {mem}")

        obs_cost(files["events.jsonl"], a_status(a), tm_a["wall_seconds"], tmp)

        # (a)'s epoch-1 checkpoint (the state's "prev") in a directory of
        # its own, to resume from after (b).
        with open(os.path.join(ck_a, "train_state.json")) as f:
            state_a = json.load(f)
        prev = state_a["prev"]
        expect(prev["epochs_completed"] == 1 and prev["ckpt"] == "ckpt-1", state_a)
        ck_r = os.path.join(tmp, "ck-resume")
        os.makedirs(ck_r)
        os.rename(os.path.join(ck_a, "ckpt-1"), os.path.join(ck_r, "ckpt-1"))
        with open(os.path.join(ck_r, "train_state.json"), "w") as f:
            json.dump(prev, f)
        shutil.rmtree(ck_a)

        # (b) The synchronous schedule, blocking checkpoints, no prefetch;
        # of the observability hooks only the step-time ledger.
        sync_env = {"GLINT_SYNC_READBACK": "1", "GLINT_SYNC_CKPT": "1",
                    "GLINT_NO_COMPACT_PREFETCH": "1"}
        os.environ.update(sync_env)
        ck_b = os.path.join(tmp, "ck-b")
        zero_counters(fs, rows_mod)
        try:
            t0 = time.perf_counter()
            b = Word2Vec(**width, obs=ObsConfig(
                steptime_path=os.path.join(tmp, "b-STEPTIME.json"))).fit_file(
                    path, checkpoint_dir=ck_b)
            torch.cuda.synchronize()
            wall_b = time.perf_counter() - t0
        finally:
            for k in sync_env:
                os.environ.pop(k, None)
        launches_b = read_counters(fs, rows_mod)
        tm_b = b.training_metrics
        write_b = b.engine.checkpoint_stats()["checkpoint_write_seconds"]
        shutil.rmtree(ck_b)
        for name in three:
            expect(launches_b[name] == launches_a[name] - 2 * 16,
                   f"(b) {name} launched {launches_b[name]} times, (a) "
                   f"{launches_a[name]}: (a) has one phantom group an epoch")
        expect((tm_b["steps"], tm_b["words_done"], tm_b["packed_pairs"])
               == (tm_a["steps"], tm_a["words_done"], tm_a["packed_pairs"]),
               f"(a) {tm_a} (b) {tm_b}")
        for name in ("syn0", "syn1"):
            expect(torch.equal(getattr(a.engine, name), getattr(b.engine, name)),
                   f"(a) and (b) {name} differ")
        log(f"(b) synchronous readbacks, blocking checkpoints, no prefetch: "
            f"{wall_b:.1f} s in all; {tm_b['steps']} steps, "
            f"{tm_b['words_per_sec']} words/s, device_stall_seconds "
            f"{tm_b['device_stall_seconds']}, last checkpoint's write "
            f"(checkpoint_save) {write_b} s, steptime {tm_b['steptime']}; "
            f"launches { {k: launches_b[k] for k in three} }; tables equal "
            "(a)'s bitwise, and steps, words and pairs")
        b.stop()
        del b
        torch.cuda.empty_cache()

        # (c) Resume from (a)'s epoch-1 asynchronous checkpoint.
        zero_counters(fs, rows_mod)
        r = Word2Vec(**width).fit_file(path, checkpoint_dir=ck_r)
        expect_launched(read_counters(fs, rows_mod), three, "the resumed fit")
        for name in ("syn0", "syn1"):
            expect(torch.equal(getattr(a.engine, name), getattr(r.engine, name)),
                   f"resumed {name} differs from (a)")
        log(f"resume from (a)'s epoch-1 async checkpoint: epoch 2 "
            f"({r.training_metrics['steps']} steps) equals (a) bitwise")
        r.stop()
        check_deferred_dispatch_syncs_nothing(torch, np, a.engine)
        a.stop()
        del a, r
        torch.cuda.empty_cache()

        canary_abort_drill(torch, np, tmp)
        log(f"phase 11 on {nvidia_smi_line()}")
        return {"launches": launches_a}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 12: the ANN index and the bulk transform
# ----------------------------------------------------------------------

#: Phase 12's table: a mixture of ANN_CENTRES seeded Gaussian centres with
#: spread ANN_SPREAD, ``tests/test_ann.py``'s ``_structured_rows`` at full
#: width (random rows have no cluster structure for IVF to find).
ANN_CENTRES, ANN_SPREAD = 4096, 0.25
#: Rows of the prefix on which nprobe = C must give the exact path's ids.
ANN_PREFIX = 65_536
#: The serving recall gate (``ModelServer``'s default).
RECALL_GATE = 0.95
#: The bulk transform's input lines and its ``transform-file`` geometry.
TRANSFORM_LINES, TRANSFORM_ROWS, TRANSFORM_MAX_LEN, TRANSFORM_SHARD = (
    100_000, 1024, 256, 8192)
#: Words of the synonyms dump's vocabulary span.
DUMP_WORDS = 65_536


def model_over(torch, np, syn0):
    """A word2vec model on the card over the rows ``syn0`` (words ``w<i>``,
    syn1 zero)."""
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.utils.params import Word2VecParams

    n = syn0.shape[0]
    return model_from_arrays(
        [f"w{i}" for i in range(n)], syn0, torch.zeros_like(syn0),
        np.arange(n, 0, -1, dtype=np.int64),
        Word2VecParams(vector_size=D, min_count=1), device=DEV,
    )


def clustered_model(torch, np):
    """The 1,000,000 x 300 fp32 mixture-of-Gaussians model of phase 12."""
    gen = torch.Generator(device=DEV).manual_seed(12)
    centres = torch.randn((ANN_CENTRES, D), generator=gen, device=DEV)
    which = torch.randint(0, ANN_CENTRES, (V_SERVE,), generator=gen, device=DEV)
    syn0 = centres[which] + ANN_SPREAD * torch.randn(
        (V_SERVE, D), generator=gen, device=DEV)
    return model_over(torch, np, syn0)


def same_ids_up_to_ties(np, got, want, want_sims, tol: float = 1e-6) -> int:
    """Fail unless ``got`` equals ``want`` row by row, except where two
    neighbouring entries of ``want`` score within ``tol`` (a tie at fp32
    precision, which two summation orders may break either way) and
    ``got`` holds the other of the two. Returns the number of such
    swapped positions."""
    swaps = 0
    for q in range(want.shape[0]):
        for j in np.flatnonzero(got[q] != want[q]):
            s = want_sims[q]
            near = [i for i in (j - 1, j + 1) if 0 <= i < s.shape[0]
                    and abs(s[i] - s[j]) <= tol]
            expect(any(got[q, j] == want[q, i] for i in near),
                   f"query {q} position {j}: id {got[q, j]} against {want[q, j]}")
            swaps += 1
    return swaps


def check_ann_kernels(torch, np, rows_mod, eng, idx) -> dict:
    """B1 and B3 held bitwise against their plain versions at the shapes
    the index build gives them: the member blocks (one gather of all C x L
    slots, byte offsets past 2^31) against ``gather_rows_reference`` on
    the same ids, and two sweep blocks' sums on the ``(C, d + 1)`` fp32
    accumulator, payload ``[x·w, w]``, each against
    ``scatter_add_rows_reference`` on a CPU copy of the accumulator it
    started from. Returns the largest difference of each."""
    from glint_word2vec_torch.ops import ann

    C, L = idx.clusters, idx.slots
    want = rows_mod.gather_rows_reference(eng.syn0, idx.members.reshape(-1))
    got = idx.member_rows.reshape(C * L, D)
    b1_err = float((got.float() - want).abs().max())
    expect(torch.equal(got, want.to(got.dtype)),
           f"the member blocks differ from gather_rows_reference: {b1_err}")
    del want, got
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(rng.choice(V_SERVE, 2 * ann.ASSIGN_BLOCK, replace=False)
                           .astype(np.int32)).to(DEV)
    xn = ann.normalized_rows(eng.syn0, eng.norms(), ids)
    acc = torch.zeros((C, D + 1), dtype=torch.float32, device=DEV)
    b3_err = 0.0
    for s in range(0, xn.shape[0], ann.ASSIGN_BLOCK):
        x = xn[s : s + ann.ASSIGN_BLOCK]
        a = torch.argmax(x @ idx.centroids.T, dim=1).to(torch.int32)
        payload = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        before = acc.cpu()
        rows_mod.scatter_add_rows(acc, a, payload)
        want = rows_mod.scatter_add_rows_reference(before, a.cpu(), payload.cpu())
        b3_err = max(b3_err, float((acc.cpu() - want).abs().max()))
        expect(torch.equal(acc.cpu(), want),
               f"a sweep block's scatter_add_rows differs from its plain "
               f"version: {b3_err}")
    log(f"at the build's shapes, bitwise their plain versions: gather_rows of "
        f"the {C * L} member slots ({C * L * D * 4} bytes out); scatter_add_rows "
        f"of two {ann.ASSIGN_BLOCK}-row sweep blocks on the ({C}, {D + 1}) "
        f"accumulator ({int(torch.unique(a).numel())} clusters in the last)")
    return {"gather_rows": b1_err, "scatter_add_rows": b3_err}


def ann_index_and_search(torch, np, fs, rows_mod, model) -> dict:
    """Phase 12 (b) and (c): two builds of the index at the default
    geometry, recall, the exact check on a prefix, timings, and a refresh
    through ``write_rows``. Returns the launch counts and the recalls."""
    from glint_word2vec_torch.ops import ann
    from glint_word2vec_torch.utils import next_pow2

    eng = model.engine
    conf = eng.configure_ann()
    C = ann.auto_clusters(V_SERVE)
    expect((conf["clusters"], conf["slots"], conf["nprobe"], conf["iters"],
            conf["sample"]) == (C, ann.member_slots(V_SERVE, C), 8, 6, 65_536),
           conf)
    zero_counters(fs, rows_mod)
    idx = eng.ann_build()
    torch.cuda.synchronize()
    build = read_counters(fs, rows_mod)
    expect_launched(build, ("gather_rows", "scatter_add_rows"), "the index build")
    sample = max(ann.ASSIGN_BLOCK, next_pow2(min(conf["sample"], V_SERVE)))
    sweeps = conf["iters"] * (sample // ann.ASSIGN_BLOCK)
    expect(build["scatter_add_rows"] == sweeps,
           f"scatter_add_rows once a sweep block: {build}")
    block_bytes = idx.member_rows.numel() * idx.member_rows.element_size()
    parts = ", ".join(f"{k} {v:.3f}" for k, v in idx.build_parts.items())
    log(f"ANN build at {V_SERVE} x {D} ({conf['clusters']} clusters x "
        f"{conf['slots']} slots, {conf['iters']} sweeps of {conf['sample']} "
        f"sampled rows): build_seconds {idx.build_seconds:.3f} ({parts}); "
        f"spilled_rows {idx.spilled_rows}; member blocks {block_bytes} bytes; "
        f"launches gather_rows {build['gather_rows']}, scatter_add_rows "
        f"{build['scatter_add_rows']}")
    again = eng.ann_build()
    expect(torch.equal(idx.centroids, again.centroids)
           and np.array_equal(idx.members_np, again.members_np)
           and np.array_equal(idx.invn_np, again.invn_np)
           and torch.equal(idx.member_rows, again.member_rows),
           "two builds on the same table differ")
    log(f"a second build ({again.build_seconds:.3f} s) is bitwise the first: "
        "centroids, members, inverse norms and member blocks")
    del again
    path_err = check_ann_kernels(torch, np, rows_mod, eng, idx)
    eng.adopt_ann(idx)
    live = idx.members_np[idx.invn_np > 0]
    expect(live.size == V_SERVE and np.unique(live).size == V_SERVE,
           f"{live.size} member slots for {V_SERVE} rows")

    # (c) Recall@10 against exact, and the launches it makes.
    zero_counters(fs, rows_mod)
    recall = {}
    for p in (8, 32):
        for n in (64, 1024):
            t0 = time.perf_counter()
            recall[(p, n)] = eng.ann_recall_at_k(10, sample=n, nprobe=p)
            log(f"recall@10 at nprobe {p} on {n} sampled rows: "
                f"{recall[(p, n)]:.6f} ({time.perf_counter() - t0:.2f} s)")
    recall_launches = rows_mod.gather_rows.launches
    log(f"the four recall measurements launched gather_rows {recall_launches} "
        "times")
    expect(recall[(8, 64)] >= 0.9, f"recall@10 {recall[(8, 64)]} on a clustered table")

    # nprobe = C on a prefix is the exact masked top-k.
    pm = model_over(torch, np, eng.syn0[:ANN_PREFIX])
    pe = pm.engine
    pconf = pe.configure_ann()
    pe.adopt_ann(pe.ann_build())
    q = pe.pull(np.arange(0, ANN_PREFIX, ANN_PREFIX // 16, dtype=np.int32))
    q = q.cpu().numpy() + 0.01
    av, ai = pe.ann_top_k_batch(q, 10, nprobe=pconf["clusters"])
    ev, ei = pe.top_k_cosine_batch(q, 10)
    err = float(np.abs(av - ev).max())
    expect(err <= 1e-5, f"nprobe = C sims differ from exact by {err}")
    swaps = same_ids_up_to_ties(np, ai, ei, ev)
    log(f"nprobe = C ({pconf['clusters']} clusters x {pconf['slots']} slots) on "
        f"the {ANN_PREFIX}-row prefix: the ids of top_k_cosine_batch for 16 "
        f"queries ({swaps} tie swaps), sims within {err:.2e}")
    pm.stop()
    del pm, pe
    torch.cuda.empty_cache()

    # Device and host time of one search against the exact path.
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    C, L = idx.clusters, idx.slots
    for Q in (1, 8, 16):
        qv = eng.pull(np.arange(7, 7 + Q, dtype=np.int32)).cpu().numpy()
        qt = torch.from_numpy(qv / np.linalg.norm(qv, axis=1, keepdims=True)).to(DEV)
        pid = torch.topk(qt @ idx.centroids.T, conf["nprobe"], dim=1).indices.reshape(-1)
        ann_ms = median_ms(torch, lambda: ann.search(idx, qt, 16, conf["nprobe"],
                                                     V_SERVE), flush)
        gather_ms = median_ms(torch, lambda: idx.member_rows.reshape(C, L * D)
                              .index_select(0, pid), flush)
        exact_ms = median_ms(torch, lambda: eng._exact_topk(qt, 16), flush)
        host = {"ann": [], "exact": []}
        for _ in range(30):
            for name, fn in (("ann", eng.ann_top_k_batch),
                             ("exact", eng.top_k_cosine_batch)):
                t = time.perf_counter()
                fn(qv, 10)
                host[name].append((time.perf_counter() - t) * 1e3)
        tmp_bytes = Q * conf["nprobe"] * L * D * 4
        log(f"Q = {Q}, k = 10: device ANN search {ann_ms:.4f} ms (its block "
            f"gather alone {gather_ms:.4f} ms, {tmp_bytes} bytes), exact "
            f"{exact_ms:.4f} ms; host ann_top_k_batch {summary(host['ann'])}, "
            f"top_k_cosine_batch {summary(host['exact'])}")
    del flush

    # A refresh: rewriting rows re-buckets them (their own values, so the
    # table does not change).
    ids = np.arange(8, dtype=np.int32)
    vecs = eng.pull(ids).cpu().numpy()
    updated = idx.updated_rows
    zero_counters(fs, rows_mod)
    eng.write_rows(0, vecs)
    refresh_launches = rows_mod.gather_rows.launches
    expect(refresh_launches > 0, "the refresh never launched gather_rows")
    expect(idx.updated_rows == updated + 8 and idx.table_version == eng.table_version,
           "write_rows did not re-bucket its rows")
    _, top = eng.ann_top_k_batch(vecs, 1)
    expect(np.array_equal(top[:, 0], ids), f"rewritten rows not found: {top[:, 0]}")
    log(f"write_rows of 8 rows re-bucketed them: gather_rows launched "
        f"{refresh_launches} times; each is its own top-1 through the index")
    return {"build": build, "recall": recall, "recall_launches": recall_launches,
            "refresh_launches": refresh_launches, "path_err": path_err}


def serve_ann(torch, np, model, model_dir: str, recall_8_64: float) -> dict:
    """Phase 12 (d): the saved model served with ``ann=True``."""
    from glint_word2vec_torch.serving import serve_model_dir

    port_file = os.path.join(os.path.dirname(model_dir), "ann_port.json")
    failure = []

    def run():
        try:
            serve_model_dir(model_dir, port=0, port_file=port_file,
                            device=DEV, ann=True)
        except BaseException as e:  # reported by the main thread
            failure.append(e)

    t0 = time.perf_counter()
    th = threading.Thread(target=run, name="serve_ann", daemon=True)
    th.start()
    while not os.path.exists(port_file):
        if failure or not th.is_alive():
            raise RuntimeError(f"serve_model_dir failed: {failure}")
        if time.perf_counter() - t0 > 600:
            raise RuntimeError("server not listening after 600 s")
        time.sleep(0.2)
    with open(port_file) as f:
        port = json.load(f)["port"]
    health = get_json(port, "/healthz")
    gate_ok = recall_8_64 >= RECALL_GATE
    log(f"ANN server loaded, built, warmed and gated in "
        f"{time.perf_counter() - t0:.1f} s: ann_enabled {health['ann_enabled']}, "
        f"ann_recall_gate_ok {health['ann_recall_gate_ok']}, its recall@10 "
        f"{health['index']['recall_at10']} (phase 12 (c): {recall_8_64}), index "
        f"build {health['index']['build_seconds']} s")
    expect(health["ann_enabled"] is gate_ok and health["ann_recall_gate_ok"] is gate_ok,
           f"/healthz gate fields {health['ann_enabled']}, "
           f"{health['ann_recall_gate_ok']} against recall {recall_8_64}")
    swaps = 0
    for i in range(16):
        w = f"w{5000 + 37 * i}"
        got = post(port, "/synonyms", {"word": w, "num": 10, "exact": True})
        want = model.find_synonyms(w, 10)
        expect(len(got) == len(want) and np.allclose(
            [g[1] for g in got], [x[1] for x in want], atol=1e-5, rtol=0),
            f"exact=true for {w}: {got[:3]} against {want[:3]}")
        swaps += same_ids_up_to_ties(
            np, np.array([[g[0] for g in got]]), np.array([[x[0] for x in want]]),
            np.array([[x[1] for x in want]]))
    log(f"exact=true answers of 16 words equal find_synonyms ({swaps} tie swaps)")
    lat = {}
    for mode, exact in (("ann", False), ("exact", True)):
        xs = []
        for i in range(SEQ_REQUESTS):
            payload = {"word": f"w{(20_000 if exact else 10_000) + i}", "num": 10}
            if exact:
                payload["exact"] = True
            t = time.perf_counter()
            post(port, "/synonyms", payload)
            xs.append((time.perf_counter() - t) * 1e3)
        lat[(mode, 1)] = xs
        xs, wall = closed_loop_in_child(port, 16, 13, 40_000 if exact else 30_000,
                                        exact)
        lat[(mode, 16)] = xs
        log(f"/synonyms {mode}, 1 client: {summary(lat[(mode, 1)])}; 16 clients: "
            f"{summary(xs)}, {len(xs) / wall:.1f} requests/s")
    health = get_json(port, "/healthz")
    log(f"ANN server index block: {json.dumps(health['index'])}")
    expect(health["post_warmup_compiles"] == 0,
           f"{health['post_warmup_compiles']} query shapes after the warmup")
    expect(post(port, "/shutdown", {}) == {"status": "shutting down"},
           "/shutdown was not acknowledged")
    th.join(timeout=120)
    if th.is_alive() or failure:
        raise RuntimeError(f"ANN server did not stop cleanly: {failure}")
    return lat


def write_transform_input(np, path: str) -> list:
    """TRANSFORM_LINES seeded lines of 0 to 64 words drawn Zipf(1) from
    the vocabulary, about 2 % of them out-of-vocabulary tokens (lines of
    0 words are blank). Returns the tokenized lines."""
    rng = np.random.default_rng(13)
    lens = rng.integers(0, 65, TRANSFORM_LINES)
    u = rng.random(int(lens.sum()))
    ids = np.minimum(np.floor(np.exp(u * math.log(V_SERVE + 1))) - 1, V_SERVE - 1)
    toks = np.array([f"w{i}" for i in ids.astype(np.int64)], dtype=object)
    oov = np.flatnonzero(rng.random(toks.size) < 0.02)
    toks[oov] = [f"oov{i}" for i in oov]
    ends = np.cumsum(lens)
    sents = [list(toks[e - n : e]) for n, e in zip(lens, ends)]
    with open(path, "w") as f:
        f.write("\n".join(" ".join(s) for s in sents) + "\n")
    return sents


def run_cli(argv) -> dict:
    """``glint_word2vec_torch.cli.main(argv)`` with its standard output
    captured; the JSON of its last line."""
    import io

    from glint_word2vec_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    expect(rc == 0, f"cli {argv[0]} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def transform_and_dump(torch, np, fs, rows_mod, model, model_dir: str,
                       tmp: str) -> dict:
    """Phase 12 (e) and (f): ``transform-file`` with its resume drill and
    rank spans, then ``synonyms-dump`` exact and with ``--ann``."""
    from glint_word2vec_torch.batch.transform import (
        load_transform_output,
        synonyms_dump,
        transform_file,
    )
    from glint_word2vec_torch.parallel.distributed import shard_span
    from glint_word2vec_torch.utils import faults

    path = os.path.join(tmp, "sentences.txt")
    sents = write_transform_input(np, path)
    geometry = dict(rows=TRANSFORM_ROWS, max_len=TRANSFORM_MAX_LEN,
                    shard_size=TRANSFORM_SHARD)
    out = os.path.join(tmp, "vectors")
    zero_counters(fs, rows_mod)
    stats = run_cli(["transform-file", "--model", model_dir, "--input", path,
                     "--out", out, "--rows", str(TRANSFORM_ROWS),
                     "--max-len", str(TRANSFORM_MAX_LEN), "--shard-size",
                     str(TRANSFORM_SHARD), "--device", DEV])
    launches = rows_mod.gather_rows.launches
    expect(launches > 0, "transform-file never launched gather_rows")
    expect(stats["sentences_done"] == TRANSFORM_LINES
           and stats["post_warmup_compiles"] == 0, stats)
    log(f"transform-file of {TRANSFORM_LINES} lines ({sum(map(len, sents))} "
        f"tokens): {stats['sentences_per_sec']} sentences/s, wall "
        f"{stats['wall_seconds']} s, dispatch {stats['dispatch_seconds']} s, "
        f"producer wait {stats['producer_wait_seconds']} s, bucket fill "
        f"{stats['bucket_fill']}, {stats['batches']} batches, "
        f"{stats['shards_committed']} shards; gather_rows launched {launches} "
        f"times")
    # One batch's dispatch alone: its host time with no producer thread
    # beside it, and the device time of its gather and masked mean.
    from glint_word2vec_torch.corpus.batching import pack_query_block

    eng = model.engine
    idx_b, mask_b, _ = pack_query_block(
        [model.vocab.encode(x) for x in sents[:TRANSFORM_ROWS]], rows=TRANSFORM_ROWS)
    host = []
    for _ in range(20):
        t = time.perf_counter()
        model.transform_packed(idx_b, mask_b)
        host.append((time.perf_counter() - t) * 1e3)
    idx_t, m_t = torch.from_numpy(idx_b).to(DEV), torch.from_numpy(mask_b).to(DEV)
    flat = idx_t.reshape(-1)
    expect(bool(((flat >= 0) & (flat < eng.padded_vocab)).all()), "batch ids")
    got, want = eng._pull_rows(flat), eng.syn0.index_select(0, flat.long()).float()
    gather_err = float((got - want).abs().max())
    expect(torch.equal(got, want),
           f"the batch's _pull_rows differs from index_select: {gather_err}")
    del got, want

    def batch_device_work():
        rows = eng._pull_rows(idx_t.reshape(-1)).reshape(*idx_t.shape, D)
        (rows * m_t[..., None]).sum(dim=1) / m_t.sum(dim=1)[:, None].clamp(min=1.0)

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    dev_ms = median_ms(torch, batch_device_work, flush)
    del flush
    log(f"one {idx_b.shape} batch alone: transform_packed host {summary(host)}; "
        f"its gather (bitwise index_select) and masked mean on the device "
        f"{dev_ms:.4f} ms; in the "
        f"stream {1e3 * stats['dispatch_seconds'] / stats['batches']:.3f} ms of "
        "dispatch a batch")
    vecs = load_transform_output(out)
    expect(vecs.shape == (TRANSFORM_LINES, D) and np.isfinite(vecs).all(),
           f"transform output {vecs.shape}")
    ref = model.transform_sentences(sents[:4096])
    expect(np.array_equal(vecs[:4096], ref),
           "the first 4,096 rows differ from transform_sentences")
    faulted = os.path.join(tmp, "faulted")
    faults.arm("transform.shard_commit:exc@3")
    try:
        transform_file(model, path, faulted, **geometry)
        raise AssertionError("the armed fault did not fire")
    except faults.FaultInjected:
        pass
    finally:
        faults.disarm()
    resumed = transform_file(model, path, faulted, **geometry)
    expect(resumed["shards_skipped"] == 3, resumed)
    expect(np.array_equal(load_transform_output(faulted), vecs),
           "the resumed transform differs from the run without a fault")
    parts = []
    for rank in (0, 1):
        start, end = shard_span(TRANSFORM_LINES, rank, 2)
        rank_dir = os.path.join(tmp, f"rank-{rank}")
        transform_file(model, path, rank_dir, start=start, end=end, **geometry)
        parts.append(load_transform_output(rank_dir))
    expect(np.array_equal(np.concatenate(parts), vecs),
           "rank spans 0/1 of 2 do not concatenate to the whole run")
    log("transform: the first 4,096 rows bitwise transform_sentences; a fault "
        "at the third shard commit, then a resume (3 shards skipped), bitwise "
        "the run without it; ranks 0 and 1 of 2 concatenated, bitwise")

    # The dump of the first DUMP_WORDS words, exact and then through an
    # index built and adopted as ``synonyms-dump --ann`` builds it; every
    # query the index searches is counted, so an exact pass cannot pass
    # for an approximate one.
    from glint_word2vec_torch.ops import ann

    searched = [0]
    search = ann.search

    def counted_search(index, q, *a, **kw):
        searched[0] += q.shape[0]
        return search(index, q, *a, **kw)

    dumps, dump_stats, dump_searched = {}, {}, {}
    for mode in ("exact", "ann"):
        if mode == "ann":
            eng.configure_ann()
            eng.adopt_ann(eng.ann_build())
        jsonl = os.path.join(tmp, f"dump_{mode}.jsonl")
        searched[0] = 0
        ann.search = counted_search
        try:
            dump_stats[mode] = synonyms_dump(model, jsonl, num=10, end=DUMP_WORDS,
                                             approximate=mode == "ann")
        finally:
            ann.search = search
        dump_searched[mode] = searched[0]
        with open(jsonl) as f:
            dumps[mode] = [json.loads(line) for line in f]
        expect(len(dumps[mode]) == DUMP_WORDS, f"{mode} dump rows")
    expect(dump_searched["exact"] == 0 and dump_searched["ann"] >= DUMP_WORDS,
           f"queries searched through the index: {dump_searched}")
    agree = total = 0
    for e, a in zip(dumps["exact"], dumps["ann"]):
        want = {w for w, _ in e["synonyms"]}
        agree += len(want & {w for w, _ in a["synonyms"]})
        total += len(want)
    share = agree / max(1, total)
    log(f"synonyms-dump of {DUMP_WORDS} words, top-10: exact "
        f"{dump_stats['exact']['words_per_sec']} words/s "
        f"({dump_stats['exact']['seconds']} s), --ann "
        f"{dump_stats['ann']['words_per_sec']} words/s "
        f"({dump_stats['ann']['seconds']} s, {dump_searched['ann']} queries "
        f"searched through the index); the two agree on {share:.6f} of the "
        "neighbours")
    expect(share >= 0.9, f"the dumps agree on {share} of the neighbours")
    return {"launches": launches, "stats": stats, "dump": dump_stats,
            "agree": share, "transform_err": gather_err}


def ann_and_transform(torch, np, fs, rows_mod) -> dict:
    """Phase 12. Returns the launch counts of the index and transform paths."""
    tmp = tempfile.mkdtemp(prefix="glint_chip_ann_")
    try:
        t0 = time.perf_counter()
        model = clustered_model(torch, np)
        model_dir = os.path.join(tmp, "model")
        model.save(model_dir)
        log(f"clustered model ({ANN_CENTRES} centres, spread {ANN_SPREAD}) built "
            f"and saved in {time.perf_counter() - t0:.1f} s")
        index = ann_index_and_search(torch, np, fs, rows_mod, model)
        serve_ann(torch, np, model, model_dir, index["recall"][(8, 64)])
        model.engine.adopt_ann(None)
        torch.cuda.empty_cache()
        out = transform_and_dump(torch, np, fs, rows_mod, model, model_dir, tmp)
        model.stop()
        log(f"phase 12 on {nvidia_smi_line()}")
        return {**index, **out}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 13: streaming training and the serving hot swap
# ----------------------------------------------------------------------

#: Phase 13 (a)'s trainer: the corpus's first STREAM_TOKENS tokens (a
#: prefix, for the script's time limit), the tokens it bootstraps its
#: vocabulary from (seven tenths of them, so a generation that serves the
#: late word comes before the last), its spare rows and buffer (the JAX
#: defaults for the buffer), and its publish cadence (four generations);
#: the server's poll and clients.
STREAM_TOKENS = 5_000_000
STREAM_BOOTSTRAP = 3_500_000
STREAM_EXTRA_ROWS = 65_536
STREAM_BUFFER = 65_536
STREAM_PUBLISH_WORDS = 1_250_000
STREAM_POLL = 0.5
STREAM_CLIENTS = 4
#: Least promotions phase 13 (a) must make (tens of thousands of words of
#: the prefix are first seen past the bootstrap; the log prints how many).
STREAM_MIN_PROMOTED = 10_000
#: Seconds the stream may be held while the server catches up, and the
#: clients may wait for the final generation's swap.
STREAM_HOLD_LIMIT = 600.0


def stream_client_loop(port: int, words, late: str, stop, out_path: str) -> None:
    """The closed-loop ``/synonyms`` clients of phase 13 (a), run in a
    child process: STREAM_CLIENTS threads, each sending back to back,
    every eighth request for the late word and the rest for base words,
    each client its own slice of ``words`` in turn (cache misses, as a
    served query finds the table), until ``stop`` is set. Writes one
    ``[client, kind, status, sent, done]`` row a request (unix seconds;
    status -1 for a dropped connection) to ``out_path`` as JSON."""
    rows = [[] for _ in range(STREAM_CLIENTS)]
    per = len(words) // STREAM_CLIENTS

    def client(c):
        i = 0
        while not stop.is_set():
            late_q = i % 8 == 7
            word = late if late_q else words[c * per + i % per]
            t = time.time()
            try:
                status = post_status(port, "/synonyms", {"word": word, "num": 10})
            except (OSError, ValueError):
                status = -1
            rows[c].append([c, "late" if late_q else "base", status, t, time.time()])
            i += 1

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(STREAM_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    with open(out_path, "w") as f:
        json.dump([r for c in rows for r in c], f)


def stream_words(np) -> tuple:
    """Phase 13 (a)'s query words: the late word, absent from the corpus's
    first STREAM_BOOTSTRAP tokens (so outside the bootstrap vocabulary and
    promoted after gen-1), the one that first appears earliest after them,
    with its first position and the count of such words in the stream's
    prefix; and the base words, every word of the bootstrap among the
    400,000 most frequent."""
    toks = synthetic_tokens(np)
    # ids[i] is the word whose first position is first[i].
    ids, first = np.unique(toks, return_index=True)
    late = np.flatnonzero((first >= STREAM_BOOTSTRAP) & (first < STREAM_TOKENS))
    i = int(late[np.argmin(first[late])])
    base = ids[(ids < 400_000) & (first < STREAM_BOOTSTRAP)]
    return f"w{ids[i]}", int(first[i]), int(late.size), [f"w{k}" for k in base]


def percentile_line(ms) -> str:
    return summary(ms) if ms else "no requests"


class StreamCapture:
    """Phase 13 (b)'s capture of the stream's last round: when the source
    has ended, the next ``upload_corpus`` (the last round's) records its
    buffer, the engine's counts and a device copy of both tables, and the
    first packed group after it records its arguments."""

    def __init__(self, np, engine_cls):
        self.np, self.cls = np, engine_cls
        self.ended = threading.Event()
        self.upload = self.group = None
        self._orig = (engine_cls.upload_corpus, engine_cls.train_steps_corpus_packed)

    def install(self) -> None:
        cap, np = self, self.np
        upload, packed = self._orig

        def capturing_upload(eng, ids, offsets, n_valid=None):
            if cap.ended.is_set() and cap.upload is None:
                cap.upload = dict(
                    engine=eng, ids=np.array(ids), offsets=np.array(offsets),
                    n_valid=n_valid, counts=eng._counts.copy(),
                    syn0=eng.syn0.clone(), syn1=eng.syn1.clone())
            return upload(eng, ids, offsets, n_valid=n_valid)

        def capturing_group(eng, *args, **kw):
            if cap.upload is not None and cap.group is None:
                cap.group = (args, dict(kw))
            return packed(eng, *args, **kw)

        self.cls.upload_corpus = capturing_upload
        self.cls.train_steps_corpus_packed = capturing_group

    def remove(self) -> None:
        self.cls.upload_corpus, self.cls.train_steps_corpus_packed = self._orig


def serve_stream(torch, np, pub: str, ready, failure: list, box: dict,
                 counted: dict) -> None:
    """Phase 13 (a)'s server thread: boots from gen-000001 once it is
    committed, with the ANN index at its defaults, watches the publish
    directory, and serves until the main thread stops it."""
    from glint_word2vec_torch.models import load_model
    from glint_word2vec_torch.serving import ModelServer
    from glint_word2vec_torch.streaming.publish import read_latest

    try:
        t0 = time.perf_counter()
        while read_latest(pub) is None:
            if time.perf_counter() - t0 > STREAM_HOLD_LIMIT:
                raise RuntimeError("no generation published")
            time.sleep(0.05)
        t1 = time.perf_counter()
        gen1 = os.path.join(pub, "gen-000001")
        model = load_model(gen1, device=DEV)
        server = ModelServer(model, port=0, ann=True)
        counted["boot"] = dict(counted["now"])
        server.watch(pub, poll_seconds=STREAM_POLL, current="gen-000001")
        server.start_background()
        box.update(model=model, server=server,
                   boot_seconds=time.perf_counter() - t1)
    except BaseException as e:  # reported by the main thread
        failure.append(e)
    finally:
        ready.set()


def stream_and_swap(torch, np, fs, rows_mod, tmp: str) -> dict:
    """Phase 13 (a): the trainer thread and the hot-swapping server in
    one process. Returns what (b) replays and the launch counts."""
    from glint_word2vec_torch.corpus.vocab import iter_text_file
    from glint_word2vec_torch.models.word2vec import Word2Vec
    from glint_word2vec_torch.ops import ann as ann_mod
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine
    from glint_word2vec_torch.streaming.publish import read_latest

    path = os.path.join(tmp, "corpus.txt")
    n_tok = write_synthetic_corpus(np, path, tokens=STREAM_TOKENS)
    late, late_pos, n_late, base_words = stream_words(np)
    log(f"stream corpus: the corpus's first {n_tok} tokens; {n_late} words "
        f"first seen past the {STREAM_BOOTSTRAP}-token bootstrap; late word "
        f"{late} first at token {late_pos}")
    pub = os.path.join(tmp, "publish")

    # B1 and B3 launches of the index builds: the index module's own
    # references, counted on top of the wrappers' counters.
    counted = {"now": {"gather_rows": 0, "scatter_add_rows": 0}}

    def counting(name, fn):
        def wrapper(*a, **kw):
            counted["now"][name] += 1
            return fn(*a, **kw)
        return wrapper

    ann_orig = (ann_mod.gather_rows, ann_mod.scatter_add_rows)
    ann_mod.gather_rows = counting("gather_rows", ann_orig[0])
    ann_mod.scatter_add_rows = counting("scatter_add_rows", ann_orig[1])
    capture = StreamCapture(np, EmbeddingEngine)
    capture.install()
    ready, failure, box = threading.Event(), [], {}
    hold = {"seconds": 0.0}
    server_thread = threading.Thread(
        target=serve_stream, args=(torch, np, pub, ready, failure, box, counted),
        name="stream_server", daemon=True)

    def source():
        """The corpus, one sentence a line; every 256 sentences the stream
        is held while the server lags: until the server is up once gen-1
        is committed, and while it serves a generation more than one
        behind the newest (the trainer runs at most one generation
        ahead, so every generation is swapped in under load)."""
        for i, toks in enumerate(iter_text_file(path)):
            if i % 256 == 0:
                latest = read_latest(pub)
                t0 = time.perf_counter()
                while latest is not None:
                    if failure:
                        raise RuntimeError(f"server failed: {failure}")
                    srv = box.get("server")
                    if srv is not None:
                        served = int((srv.metrics.generation or "gen-0").split("-")[1])
                        if served >= int(latest["seq"]) - 1:
                            break
                    if time.perf_counter() - t0 > STREAM_HOLD_LIMIT:
                        raise RuntimeError("the server never caught up")
                    yield []
                    time.sleep(0.01)
                hold["seconds"] += time.perf_counter() - t0
            yield toks
        capture.ended.set()

    result = {}

    def train():
        try:
            w2v = Word2Vec(device=DEV, vector_size=D, window=W_TRAIN,
                           batch_size=B_TRAIN, num_negatives=N_NEG,
                           steps_per_call=16, min_count=1, seed=1)
            t0 = time.perf_counter()
            result["model"] = w2v.fit_stream(
                source(), publish_dir=pub, bootstrap_words=STREAM_BOOTSTRAP,
                extra_rows=STREAM_EXTRA_ROWS, buffer_words=STREAM_BUFFER,
                publish_words=STREAM_PUBLISH_WORDS, publish_seconds=1e9,
                publish_keep=2)
            result["seconds"] = time.perf_counter() - t0
        except BaseException as e:  # reported by the main thread
            result["error"] = e

    zero_counters(fs, rows_mod)
    # Daemon threads: a failed phase must not keep the process alive.
    trainer = threading.Thread(target=train, name="stream_trainer", daemon=True)
    t_start = time.perf_counter()
    server_thread.start()
    trainer.start()
    clients = None
    try:
        ready.wait()
        if failure:
            raise RuntimeError(f"stream server failed: {failure[0]!r}") from failure[0]
        server = box["server"]
        port = server.port
        ix = server.model.engine.ann_index.stats()
        log(f"server booted from gen-000001 (load, warmup, index build and gate) "
            f"in {box['boot_seconds']:.1f} s; index build {ix['build_seconds']} s, "
            f"{ix['spilled_rows']} rows spilled; recall@10 "
            f"{server.metrics.index_recall_at10}, ANN serving {server._ann_live}")
        ctx = multiprocessing.get_context("spawn")
        stop = ctx.Event()
        out_path = os.path.join(tmp, "clients.json")
        clients = ctx.Process(target=stream_client_loop,
                              args=(port, base_words, late, stop, out_path))
        clients.start()
        trainer.join()
        if "error" in result:
            raise RuntimeError(f"fit_stream failed: {result['error']!r}") from result["error"]
        final = read_latest(pub)["generation"]
        t0 = time.perf_counter()
        while server.metrics.generation != final:
            expect(time.perf_counter() - t0 < STREAM_HOLD_LIMIT,
                   f"the server never swapped to {final}")
            time.sleep(0.05)
        stop.set()
        clients.join(timeout=300)
        expect(clients.exitcode == 0, f"the client process exited {clients.exitcode}")
        with open(out_path) as f:
            reqs = json.load(f)
        health = server.health()
        launches = read_counters(fs, rows_mod)
    finally:
        if clients is not None and clients.is_alive():
            stop.set()
            clients.join(timeout=60)
            if clients.is_alive():
                clients.terminate()
                clients.join(timeout=30)
        capture.remove()
        ann_mod.gather_rows, ann_mod.scatter_add_rows = ann_orig
    wall = time.perf_counter() - t_start
    model = result["model"]
    tm = model.training_metrics
    pubr = tm["generations_published"]

    # -- the trainer ---------------------------------------------------
    fill_net = tm["fill_seconds"] - hold["seconds"]
    train_s = result["seconds"] - hold["seconds"]
    log(f"fit_stream: {tm['words_trained']} words in {tm['rounds']} rounds, "
        f"{result['seconds']:.1f} s ({hold['seconds']:.1f} s of it the stream "
        f"held for the server): {tm['words_trained'] / train_s:.1f} words/s "
        f"without the holds ({tm['words_per_sec']} with them); fill "
        f"{fill_net / tm['rounds']:.4f} s a round on the host (holds "
        f"excluded); device_stall_seconds {tm['device_stall_seconds']}; "
        f"{tm['steps']} steps, {tm['promoted_words']} promoted, vocabulary "
        f"{tm['vocab_size']}, {pubr} generations")
    for h in tm["publishes"]:
        log(f"  publish {h['generation']}: snapshot {h['snapshot_seconds']:.3f} s "
            f"(the trainer's stall), write {h['write_seconds']:.3f} s (writer thread)")
    eng = model.engine
    expect(tm["promoted_words"] >= STREAM_MIN_PROMOTED,
           f"only {tm['promoted_words']} words promoted")
    expect(eng.queryable_rows == model.vocab.size,
           f"queryable rows {eng.queryable_rows} != vocabulary {model.vocab.size}")
    expect(bool(torch.isfinite(eng.syn0).all()) and bool(torch.isfinite(eng.syn1).all()),
           "the stream's final tables hold non-finite values")
    expect(late in model.vocab.word_index
           and model.vocab.word_index[late] >= eng.vocab_size,
           f"the late word {late} was not promoted")

    # -- the swaps -----------------------------------------------------
    m = server.metrics
    swaps = list(server.swap_history)
    for s in swaps:
        ix = s["index"]
        log(f"  swap {s['generation']}: stage {s['stage_seconds']:.3f} s, index "
            f"build {s['index_seconds']:.3f} s ({ix['spilled_rows']} rows "
            f"spilled; {json.dumps(ix['build_parts'])}), gate "
            f"{s['gate_seconds']:.3f} s (recall@10 {s['recall_at10']}), lock wait "
            f"{s['lock_wait_seconds']:.4f} s, flip held {s['flip_seconds']:.4f} s")
    expect(m.table_swaps >= 3 and m.swap_failures == 0,
           f"{m.table_swaps} swaps, {m.swap_failures} failures")
    expect(health["post_warmup_compiles"] == 0,
           f"{health['post_warmup_compiles']} new query shapes after the warmup")

    # -- the clients ---------------------------------------------------
    bad = [r for r in reqs if r[2] == -1 or r[2] >= 500]
    expect(not bad, f"{len(bad)} dropped or 5xx responses, e.g. {bad[:3]}")
    base_ok = [r for r in reqs if r[1] == "base"]
    expect(all(r[2] == 200 for r in base_ok),
           f"base-word statuses {sorted({r[2] for r in base_ok})}")
    late_rows = [r for r in reqs if r[1] == "late"]
    for c in range(STREAM_CLIENTS):
        seq = [r[2] for r in sorted(late_rows, key=lambda r: r[3]) if r[0] == c]
        first_ok = seq.index(200) if 200 in seq else len(seq)
        expect(all(s == 404 for s in seq[:first_ok]) and all(s == 200 for s in seq[first_ok:]),
               f"client {c}: the late word's statuses go {seq[:8]}..., not 404 then 200")
    statuses = [r[2] for r in late_rows]
    expect(404 in statuses and 200 in statuses,
           f"the late word never answered both 404 and 200: {sorted(set(statuses))}")
    first_200 = min(r[4] for r in late_rows if r[2] == 200)
    expect(any(s["end_unix"] <= first_200 for s in swaps),
           "the late word answered 200 before any swap")
    lat_all = [(r[4] - r[3]) * 1e3 for r in reqs]
    lat_swap = [(r[4] - r[3]) * 1e3 for r in reqs
                if any(r[3] < s["end_unix"] and r[4] > s["start_unix"] for s in swaps)]
    span = max(r[4] for r in reqs) - min(r[3] for r in reqs)
    log(f"/synonyms under the stream, {STREAM_CLIENTS} clients, {len(reqs)} "
        f"requests in {span:.1f} s: {percentile_line(lat_all)}; inside the swap "
        f"windows: {percentile_line(lat_swap)}; late word {late}: "
        f"{statuses.count(404)} x 404 then {statuses.count(200)} x 200")
    swap_launches = {k: counted["now"][k] - counted["boot"][k] for k in counted["now"]}
    log(f"phase 13 (a) launches, all zeroed before the trainer started: "
        f"{json.dumps(launches)}; of which the swaps' index builds "
        f"(after the boot): {json.dumps(swap_launches)}; whole (a) {wall:.1f} s")
    expect_launched(launches, ("pair_forward", "scatter_add_rank1_hbm",
                               "scatter_add_rows_f32"), "phase 13 (a)'s trainer")
    expect(all(v > 0 for v in swap_launches.values()),
           f"the swaps launched no index-build kernel: {swap_launches}")
    server.stop()
    box["model"].stop()
    server_thread.join(timeout=60)
    return dict(model=model, capture=capture, launches=launches,
                swap_launches=swap_launches)


def hold_stream_group(torch, np, fs, stream: dict) -> dict:
    """Phase 13 (b): the captured first packed group of the stream's last
    round, run twice from the same tables: through the kernels on the
    card, and through their plain versions in a ``device="cpu"`` engine.
    Pair counts and consumed positions must be equal, and the tables
    within rtol 1e-4 and atol 1e-6 (``test_torch_train.py``'s tolerance).
    Inside the kernel run, the first step whose pairs touch a promoted
    row is held kernel by kernel: ``pair_forward`` through
    :func:`pair_forward_held`, ``scatter_add_rank1_hbm`` through
    :func:`rank1_bitwise`, ``scatter_add_rows_f32`` through
    :func:`touched_rows_check`."""
    from glint_word2vec_torch.parallel import engine as engine_mod
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine

    cap = stream["capture"]
    up, group = cap.upload, cap.group
    expect(up is not None and group is not None, "the last round was not captured")
    eng = up["engine"]
    n_valid = up["n_valid"]
    expect(n_valid < STREAM_BUFFER, f"the last round is full ({n_valid} words)")
    args, kw = group
    kw = dict(kw, readback=True)
    V = eng.vocab_size
    held = {}

    def checked(syn0, syn1, centers, contexts, pm, negs, nmask, alpha):
        promoted = bool(((centers >= V) | (contexts >= V)).any())
        if held or not promoted:
            return step(syn0, syn1, centers, contexts, pm, negs, nmask, alpha)
        P, n = negs.shape
        fw, e, rel = pair_forward_held(
            torch, fs, (syn0, syn1, centers, contexts, pm, negs, nmask, alpha),
            "on the stream's group")
        rows = torch.arange(P, dtype=torch.int32, device=centers.device)
        ids1 = torch.cat([contexts, negs.reshape(-1)])
        coefs = torch.cat([fw.c_pos, fw.c_neg.reshape(-1)])
        hidx = torch.cat([rows, rows.repeat_interleave(n)])
        r7 = rank1_bitwise(
            torch, (fs.scatter_add_rank1_hbm, fs.scatter_add_rank1_hbm_reference),
            syn1, ids1, coefs, fw.h, hidx, "scatter_add_rank1_hbm (stream group)")
        uniq = torch.unique(centers.long())
        before = syn0[uniq].cpu()
        fs.scatter_add_rows_f32(syn0, centers, fw.d_center)
        torch.cuda.synchronize()
        r6 = touched_rows_check(
            torch, syn0, before, centers,
            lambda t, local: fs.scatter_add_rows_f32_reference(t, local, fw.d_center.cpu()),
            "scatter_add_rows_f32 (stream group)")
        held.update(
            err=e, loss_rel=rel, runs7=r7, runs6=r6,
            promoted_centers=int((centers >= V).sum()),
            promoted_contexts=int((contexts >= V).sum()), pairs=int(pm.sum()))
        return fw.loss_sum

    step = engine_mod.fused_pair_step
    eng.syn0.copy_(up["syn0"])
    eng.syn1.copy_(up["syn1"])
    eng.set_noise_counts(up["counts"])
    eng.upload_corpus(up["ids"], up["offsets"], n_valid=n_valid)
    engine_mod.fused_pair_step = checked
    try:
        _, pairs_k, pos_k, _ = eng.train_steps_corpus_packed(*args, **kw)
    finally:
        engine_mod.fused_pair_step = step
    torch.cuda.synchronize()
    expect(held, "no step of the captured group touched a promoted row")
    log(f"stream group (b): the last round's first group, n_valid {n_valid} of "
        f"{STREAM_BUFFER}, start {args[0]}, {args[5]} steps; in its first step "
        f"touching promoted rows ({held['pairs']} pairs, {held['promoted_centers']} "
        f"promoted centers, {held['promoted_contexts']} promoted contexts): "
        f"pair_forward within rtol 1e-5 (max |diff| {held['err']:.3g}), h "
        f"bitwise, loss rel {held['loss_rel']:.2g}, two calls bitwise; "
        f"scatter_add_rank1_hbm bitwise (R={held['runs7']}), two calls equal; "
        f"scatter_add_rows_f32 bitwise (R={held['runs6']})")

    t0 = time.perf_counter()
    cpu = EmbeddingEngine(V, eng.dim, up["counts"], num_negatives=eng.num_negatives,
                          unigram_power=eng.unigram_power,
                          unigram_table_size=eng.unigram_table_size, seed=eng._seed,
                          extra_rows=eng.num_rows - V, device="cpu")
    cpu.set_tables(up["syn0"].cpu(), up["syn1"].cpu())
    cpu.set_noise_counts(up["counts"])
    cpu.upload_corpus(up["ids"], up["offsets"], n_valid=n_valid)
    _, pairs_p, pos_p, _ = cpu.train_steps_corpus_packed(*args, **kw)
    expect(np.array_equal(pairs_k, pairs_p) and np.array_equal(pos_k, pos_p),
           f"pair counts / positions differ from the CPU engine's: {pairs_k} "
           f"{pos_k} against {pairs_p} {pos_p}")
    err = 0.0
    for name in ("syn0", "syn1"):
        got, want = getattr(eng, name).cpu(), getattr(cpu, name)
        diff = (got - want).abs()
        ok = bool((diff <= 1e-4 * want.abs() + 1e-6).all())
        err = max(err, float(diff.max()))
        expect(ok, f"{name} after the group: off by {float(diff.max())} from the "
                   "plain versions' (rtol 1e-4, atol 1e-6)")
    log(f"stream group (b): pair counts {pairs_k.tolist()} and positions equal to "
        f"the device='cpu' engine's (its plain versions, "
        f"{time.perf_counter() - t0:.1f} s); tables within rtol 1e-4, atol 1e-6 "
        f"of it (max |diff| {err:.3g})")
    del cpu
    return dict(held, table_err=err)


def stream_kill_drill(torch, np, tmp: str) -> None:
    """Phase 13 (c): ``fit-stream`` on the card through the CLI on the
    shifted tiny corpus (``tests/test_streaming.py``'s stream), SIGKILLed
    between the second generation's rename and its pointer flip; a
    watcher must refuse the unreferenced generation, a second run numbers
    past it, and its stream passes the JAX streaming quality gate."""
    from glint_word2vec_torch.models import load_model
    from glint_word2vec_torch.serving import ModelServer
    from glint_word2vec_torch.streaming.publish import read_latest

    tiny = make_tiny_corpus(np)
    corpus = os.path.join(tmp, "tiny_stream.txt")
    with open(corpus, "w") as f:
        f.writelines(" ".join(s) + "\n" for s in tiny)
        for _ in range(3):
            f.writelines(" ".join(s + ["zagreb", "zagreb"]) + "\n" for s in tiny[:300])
    pub = os.path.join(tmp, "tiny_pub")
    argv = [sys.executable, "-m", "glint_word2vec_torch.cli", "fit-stream",
            "--corpus", corpus, "--publish-dir", pub, "--vector-size", "32",
            "--window", "3", "--step-size", "0.025", "--batch-size", "256",
            "--min-count", "5", "--seed", "1", "--steps-per-call", "4",
            "--bootstrap-words", "2000", "--buffer-words", "4096",
            "--extra-rows", "8", "--publish-words", "8000",
            "--publish-every", "1e9", "--device", DEV]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=600,
                       env=dict(env, GLINT_FAULTS="publish.pre_pointer:kill@2"))
    expect(r.returncode == -9, f"fit-stream under the kill fault exited "
                               f"{r.returncode}: {r.stderr[-2000:]}")
    expect(read_latest(pub)["generation"] == "gen-000001",
           f"LATEST moved past gen-000001: {read_latest(pub)}")
    gen2 = os.path.join(pub, "gen-000002")
    m2 = load_model(gen2, device=DEV)  # complete: verifies and loads
    m2.stop()
    model = load_model(os.path.join(pub, "gen-000001"), device=DEV)
    server = ModelServer(model, port=0, warmup=False)
    watcher = server.watch(pub, poll_seconds=3600, current="gen-000001")
    server.start_background()
    try:
        expect(watcher.poll_once() is None and server.metrics.table_swaps == 0,
               "a watcher loaded the unreferenced gen-000002")
    finally:
        server.stop()
        model.stop()
    out = os.path.join(tmp, "tiny_stream_model")
    r = subprocess.run(argv + ["--output", out], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    expect(r.returncode == 0, f"the second fit-stream exited {r.returncode}: "
                              f"{r.stderr[-2000:]}")
    tm = json.loads(r.stdout.strip().splitlines()[-1])
    seq = int(read_latest(pub)["seq"])
    route = "cuda" if DEV.startswith("cuda") else "plain"
    expect(tm["kernel_route"] == route and seq >= 3,
           f"second run: route {tm['kernel_route']}, LATEST seq {seq}")
    m = load_model(out, device=DEV)
    try:
        syns = dict(m.find_synonyms("austria", 10))
        expect("vienna" in syns, f"vienna not in austria's top 10: {list(syns)}")
        expect("zagreb" in m.vocab.word_index, "zagreb was not promoted")
    finally:
        m.stop()
    log(f"stream kill drill (c): killed at the second publish between rename "
        f"and pointer (LATEST on gen-000001, gen-000002 complete and not "
        f"loaded by a watcher); the second run published up to gen-{seq:06d}, "
        f"{tm['words_trained']} words, {tm['promoted_words']} promoted; vienna "
        f"in austria's top 10; {time.perf_counter() - t0:.1f} s")


def stream_and_hot_swap(torch, np, fs, rows_mod) -> dict:
    """Phase 13. Returns the launch counts and the held group's numbers."""
    tmp = tempfile.mkdtemp(prefix="glint_chip_stream_")
    try:
        stream = stream_and_swap(torch, np, fs, rows_mod, tmp)
        group = hold_stream_group(torch, np, fs, stream)
        stream["model"].stop()
        stream["capture"].upload = None
        torch.cuda.empty_cache()
        stream_kill_drill(torch, np, tmp)
        log(f"phase 13 on {nvidia_smi_line()}")
        return dict(launches=stream["launches"],
                    swap_launches=stream["swap_launches"], group=group)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 14: the replica-exchange gang
# ----------------------------------------------------------------------

#: Phase 14's corpus (phase 10 (a)'s prefix: 981,169 words kept at
#: min_count 1), its in-process replica groups, and the time limit of a
#: supervised CLI run. The supervised gang (b) trains two epochs of the
#: corpus's first GANG_FIT_TOKENS: at int8, a round every 4 groups, the
#: capacity grows to the whole table after the first round's spill, so
#: every round ships the whole table through gloo, and the gang's time
#: grows with the prefix (PERF.md §5 has the times of each prefix tried).
GANG_TOKENS = GRID_TOKENS
GANG_FIT_TOKENS = 1_250_000
GANG_GROUPS = 8
#: Groups over which the fp32 dense replica pair runs beside the sparse
#: pair (sparse == dense is checked after the last of them).
GANG_DENSE_GROUPS = 4
GANG_TIMEOUT = 600


def gib(n) -> str:
    """Bytes as GiB; "not measured" where the statistic is missing."""
    return "not measured" if n is None else f"{n / 2**30:.2f} GiB"


def _tree_rss_bytes(root: int) -> int:
    """Resident bytes of process ``root`` and all its descendants (the
    supervisor and its ranks), from ``/proc``."""
    kids, rss = {}, {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{name}/statm") as f:
                rss[int(name)] = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            continue
        kids.setdefault(ppid, []).append(int(name))
    total, todo = 0, [root]
    while todo:
        pid = todo.pop()
        total += rss.get(pid, 0)
        todo += kids.get(pid, [])
    return total


def _machine_used_bytes() -> int:
    """MemTotal less MemAvailable of ``/proc/meminfo``."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            info[k] = int(v.split()[0]) * 1024
    return info["MemTotal"] - info.get("MemAvailable", info.get("MemFree", 0))


class HostMemoryPeak:
    """Peak host memory over a ``with`` block, sampled every ``period``
    seconds on a thread of its own: this process with its descendants,
    and the machine's used memory."""

    def __init__(self, period: float = 0.25):
        self.period, self.tree, self.machine = period, 0, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self):
        self.tree = max(self.tree, _tree_rss_bytes(os.getpid()))
        self.machine = max(self.machine, _machine_used_bytes())

    def _run(self):
        while not self._stop.wait(self.period):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)
        self._sample()

    def line(self) -> str:
        return (f"peak host memory: this process and its children "
                f"{gib(self.tree)}, the machine's used {gib(self.machine)}")


def gang_kill_round(n_tok: int) -> int:
    """The exchange round at which phase 14 (b) kills rank 1: early in its
    second epoch, two rounds past the first epoch's rounds (a rank's shard
    in packed steps of about B_TRAIN centres, which overcounts them a
    little, 16 steps a group, a round every 4) and its flush."""
    rounds = -(-(-(-(-(-(n_tok // 2) // B_TRAIN)) // 16)) // 4)
    return rounds + 1 + 2


def _stage_line(stages: list) -> str:
    keys = ("diff", "encode", "copy_to_host", "apply")
    mean = {k: sum(s.get(k, 0.0) for s in stages) / max(len(stages), 1) for k in keys}
    return ", ".join(f"{k} {1e3 * v:.2f}" for k, v in mean.items()) + " ms"


def replica_rounds(torch, np, fs, rows_mod, path: str) -> dict:
    """Phase 14 (a): ``sync_group`` over two replica engines on the card,
    from identical tables, each training its round-robin shard of the
    prefix in packed groups of 16 steps under its rank-folded key.
    fp32 sparse every group, with a dense pair beside it over the first
    ``GANG_DENSE_GROUPS`` (equal tables then), bf16 and int8 sparse every 4
    groups; after every round the two replicas are bitwise equal. Rank 1's first step holds B4, B7 and B6
    as phase 5 does. One more round's payloads are applied by the card
    (B3) and by a ``device="cpu"`` engine (B3's plain version), fp32 and
    bf16 tables, bitwise; B3 at that shape is timed."""
    from glint_word2vec_torch.corpus.batching import packed_pair_batch
    from glint_word2vec_torch.corpus.vocab import scan_and_encode_file
    from glint_word2vec_torch.ops import random as rnd
    from glint_word2vec_torch.parallel import distributed as pdist
    from glint_word2vec_torch.parallel import engine as engine_mod
    from glint_word2vec_torch.parallel import exchange as pex
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine

    vocab, ids, offsets = scan_and_encode_file(path, min_count=1,
                                               max_sentence_length=1000)
    V, P = vocab.size, packed_pair_batch(B_TRAIN, W_TRAIN)
    shards = [pdist.shard_flat_for_process(ids, offsets, r, 2) for r in range(2)]
    base_key = rnd.seed_key(1)
    total = int(ids.size) + 1

    def replicas():
        engs = []
        for r in range(2):
            e = EmbeddingEngine(V, D, vocab.counts, num_negatives=N_NEG, seed=1,
                                device=DEV)
            e.upload_corpus(*shards[r])
            e.pos = 0
            engs.append(e)
        return engs

    def train(engs, g, hold_rank=None):
        for r, e in enumerate(engs):
            if r == hold_rank:
                engine_mod.fused_pair_step = checked
            try:
                _, _, pos_ends, _ = e.train_steps_corpus_packed(
                    e.pos, P, W_TRAIN, B_TRAIN, rnd.fold_in(base_key, r), 16,
                    step0=16 * g, step_size=0.025, total_words=total)
            finally:
                engine_mod.fused_pair_step = step
            e.pos = int(pos_ends[-1])

    step = engine_mod.fused_pair_step
    held = {}

    def checked(syn0, syn1, centers, contexts, pm, negs, nmask, alpha):
        if held:
            return step(syn0, syn1, centers, contexts, pm, negs, nmask, alpha)
        P_, n = negs.shape
        fw, e, rel = pair_forward_held(
            torch, fs, (syn0, syn1, centers, contexts, pm, negs, nmask, alpha),
            "on rank 1's first group")
        rows = torch.arange(P_, dtype=torch.int32, device=centers.device)
        r7 = rank1_bitwise(
            torch, (fs.scatter_add_rank1_hbm, fs.scatter_add_rank1_hbm_reference),
            syn1, torch.cat([contexts, negs.reshape(-1)]),
            torch.cat([fw.c_pos, fw.c_neg.reshape(-1)]), fw.h,
            torch.cat([rows, rows.repeat_interleave(n)]),
            "scatter_add_rank1_hbm (rank 1)")
        uniq = torch.unique(centers.long())
        before = syn0[uniq].cpu()
        fs.scatter_add_rows_f32(syn0, centers, fw.d_center)
        torch.cuda.synchronize()
        r6 = touched_rows_check(
            torch, syn0, before, centers,
            lambda t, local: fs.scatter_add_rows_f32_reference(t, local, fw.d_center.cpu()),
            "scatter_add_rows_f32 (rank 1)")
        held.update(err=e, loss_rel=rel, runs7=r7, runs6=r6, pairs=int(pm.sum()))
        return fw.loss_sum

    out = {}
    # fp32, every group: sparse and dense pairs trained alike over the
    # first GANG_DENSE_GROUPS groups, the sparse pair alone after them.
    t0 = time.perf_counter()
    sp, de = replicas(), replicas()
    xs = [pex.ReplicaExchanger(e, mode="sparse", pair_batch=P) for e in sp]
    xd = [pex.ReplicaExchanger(e, mode="dense", pair_batch=P) for e in de]
    stages, rounds, dense_bytes = [], [], 0
    for g in range(GANG_GROUPS):
        train(sp, g, hold_rank=1 if g == 0 else None)
        if de:
            train(de, g)
        rs = pex.sync_group(xs)
        stages.append(xs[0].round_stage_seconds())
        rounds.append(rs)
        pairs = [(sp, "sparse")]
        if de:
            pex.sync_group(xd)
            pairs.append((de, "dense"))
        for pair, what in pairs:
            expect(torch.equal(pair[0].syn0, pair[1].syn0)
                   and torch.equal(pair[0].syn1, pair[1].syn1),
                   f"fp32 {what} replicas differ after round {g}")
        if de and g + 1 == GANG_DENSE_GROUPS:
            expect(torch.equal(sp[0].syn0, de[0].syn0)
                   and torch.equal(sp[0].syn1, de[0].syn1),
                   f"fp32 sparse tables differ from dense after round {g}")
            dense_bytes = de[0].exchange_stats()["exchange_bytes_total"] // GANG_DENSE_GROUPS
            for e in de:
                e.destroy()
            de, xd = [], []
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    expect(held, "rank 1's first step was not held")
    log(f"replicas (a) rank 1's first step ({held['pairs']} pairs, its rank-folded "
        f"draws): pair_forward within rtol 1e-5 (max |diff| {held['err']:.3g}), h "
        f"bitwise, loss rel {held['loss_rel']:.2g}, two calls bitwise; "
        f"scatter_add_rank1_hbm bitwise (R={held['runs7']}); scatter_add_rows_f32 "
        f"bitwise (R={held['runs6']})")
    rows = [max(r["rows"]) for r in rounds]
    log(f"replicas (a) fp32, every=1, {V} x {D}: {GANG_GROUPS} rounds, replicas "
        f"bitwise equal after each, sparse == dense bitwise after the first "
        f"{GANG_DENSE_GROUPS}; touched rows a rank "
        f"(both tables) {min(rows)} to {max(rows)} against capacity "
        f"{rounds[-1]['capacity']} a table; bytes a rank a round sparse "
        f"{rounds[0]['bytes_per_rank']}, dense {dense_bytes}; "
        f"seconds a round (host) sparse {sum(r['seconds'] for r in rounds) / len(rounds):.3f}; "
        f"device stages of rank 0's sparse round: {_stage_line(stages)} "
        f"({time.perf_counter() - t0:.1f} s)")
    out["fp32"] = dict(rows=rows, stages=stages, bytes=rounds[0]["bytes_per_rank"])
    out["apply"] = apply_on_card_and_cpu(torch, np, sp, xs, train, vocab)
    for e in sp:
        e.destroy()
    del sp, xs
    torch.cuda.empty_cache()

    # bf16 and int8 wires, every 4 groups.
    for wire in ("bf16", "int8"):
        t0 = time.perf_counter()
        engs = replicas()
        xw = [pex.ReplicaExchanger(e, mode="sparse", pair_batch=P, wire=wire,
                                   every=4) for e in engs]
        stages, rounds = [], []
        for g in range(GANG_GROUPS):
            train(engs, g)
            if (g + 1) % 4 == 0:
                rounds.append(pex.sync_group(xw))
                stages.append(xw[0].round_stage_seconds())
                expect(torch.equal(engs[0].syn0, engs[1].syn0)
                       and torch.equal(engs[0].syn1, engs[1].syn1),
                       f"{wire} replicas differ after group {g}")
        st = engs[0].exchange_stats()
        # Four groups can touch more rows than the default capacity (sized
        # for one): such a round spills to the dense path, exact fp32.
        expect(st[f"exchange_bytes_wire_{wire}_total"]
               + st["exchange_bytes_wire_fp32_total"] == st["exchange_bytes_total"] > 0
               and st["exchange_dense_syncs_total"] == st["exchange_overflow_total"],
               f"{wire} bytes: {st}")
        log(f"replicas (a) {wire}, every=4: {len(rounds)} rounds "
            f"({[('dense spill' if r['dense'] else r['wire']) for r in rounds]}, capacity "
            f"after each {[r['capacity'] for r in rounds]}), replicas bitwise equal "
            f"after each; touched rows a rank {[max(r['rows']) for r in rounds]}; bytes "
            f"a rank a round {[r['bytes_per_rank'] for r in rounds]}; residual carry "
            f"{st['exchange_residual_abs']:.3g}; device stages of rank 0's rounds: "
            f"{_stage_line(stages)} ({time.perf_counter() - t0:.1f} s)")
        out[wire] = dict(rounds=rounds, stages=stages)
        for e in engs:
            e.destroy()
        del engs, xw
        torch.cuda.empty_cache()
    # The exchangers are gone; their pinned blocks stay cached by the host
    # allocator until released, and the gang's ranks need the memory.
    held_pinned = pex.pinned_stats().get("allocated_bytes.current")
    pex.release_host_cache()
    st = pex.pinned_stats()
    log(f"replicas (a) pinned host memory of this process: peak "
        f"{gib(st.get('allocated_bytes.peak'))}, {gib(held_pinned)} held after "
        f"the replicas, {gib(st.get('allocated_bytes.current'))} after the release")
    return out


def apply_on_card_and_cpu(torch, np, engs, xw, train, vocab) -> dict:
    """Phase 14 (a)'s last round: both fp32 replicas' payloads of one more
    group, applied to the base by the card (B3) and by a ``device="cpu"``
    engine (B3's plain version), on the fp32 base and on its bf16
    rounding: bitwise equal. Then B3 alone at the apply's shape: capacity
    rows, the padding a long zero run on row 0, an fp32 accumulator;
    bitwise against its plain version and timed beside ``index_add_``."""
    from glint_word2vec_torch.ops.rows import (
        scatter_add_rows,
        scatter_add_rows_reference,
    )
    from glint_word2vec_torch.parallel import exchange as pex
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine

    train(engs, GANG_GROUPS)
    got = [x.harvest() for x in xw]
    cap = xw[0].capacity
    stacked = [torch.stack([p[1][k] for p in got]) for k in range(6)]
    cpu = EmbeddingEngine(vocab.size, D, vocab.counts, num_negatives=N_NEG,
                          seed=1, device="cpu")
    wire = xw[0].wire
    fn_card = pex._build_apply_sparse_fn(engs[0], cap, 2, wire)
    fn_cpu = pex._build_apply_sparse_fn(cpu, cap, 2, wire)
    t_cpu = 0.0
    for dt in (torch.float32, torch.bfloat16):
        base = tuple(t.to(dt) for t in xw[0]._base)
        before = rows_launches = scatter_add_rows.launches
        card = fn_card(*base, *stacked)
        torch.cuda.synchronize()
        rows_launches = scatter_add_rows.launches - before
        t0 = time.perf_counter()
        plain = fn_cpu(*(t.cpu() for t in base), *stacked)
        t_cpu += time.perf_counter() - t0
        for a, b in zip(card, plain):
            expect(a.dtype == dt and torch.equal(bits(torch, a.cpu()), bits(torch, b)),
                   f"the card's apply differs from the CPU's ({dt})")
        expect(rows_launches == 4, f"B3 launches in one apply: {rows_launches}")
    n = [c for c, _ in got]
    log(f"replicas (a) one {wire} round applied by the card and by a device='cpu' "
        f"engine, fp32 and bf16 tables: bitwise equal (touched rows {n}, capacity "
        f"{cap}; 4 B3 launches an apply; CPU {t_cpu:.1f} s)")
    ids = stacked[0][0].to(DEV)
    dec = stacked[1][0].float()
    if wire == "int8":
        dec = dec * stacked[2][0][:, None]
    dec = dec.to(DEV)
    acc = xw[0]._base[0].float().clone()
    ref = acc.cpu()
    scatter_add_rows(acc, ids, dec)
    scatter_add_rows_reference(ref, ids.cpu(), dec.cpu())
    expect(torch.equal(bits(torch, acc.cpu()), bits(torch, ref)),
           "B3 at the apply's shape differs from its plain version")
    zero_run = int((ids == 0).sum())
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    from glint_word2vec_torch.ops.fused_sgns import sorted_runs
    from glint_word2vec_torch.ops.rows import scatter_add_rows_sorted

    sid, order = sorted_runs(ids)
    ms = median_ms(torch, lambda: scatter_add_rows_sorted(acc, sid, order, dec), flush)
    lib = median_ms(torch, lambda: acc.index_add_(0, ids.long(), dec), flush)
    d = dec.shape[1]
    uniq = int(torch.unique(ids).numel())
    bound = (2 * uniq * d * 4 + ids.numel() * (d * 4 + 8)) / HBM_BYTES_PER_S * 1e3
    log(f"B3 at the apply's shape: N={ids.numel()} ({zero_run} slots on row 0, a "
        f"zero run), fp32 accumulator {acc.shape[0]} x {d}: bitwise its plain "
        f"version; kernel {ms:.4f} ms, index_add_ {lib:.4f} ms, bound {bound:.4f} ms")
    del cpu
    return dict(ms=ms, library_ms=lib, bound_ms=bound, zero_run=zero_run, n=ids.numel())


def gang_cli(argv, timeout: float = GANG_TIMEOUT, **env_extra) -> None:
    """``python -m glint_word2vec_torch.cli`` in a child process (the
    supervisor, whose workers own the card), from this checkout, with
    ``env_extra`` added to its environment; fails the phase unless it
    exits 0."""
    env = dict(os.environ, **env_extra)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("GLINT_FAULTS", None)
    r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.cli", *argv],
                       env=env, cwd=here, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"cli {argv[:3]} exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")


def _mean_ms(xs) -> str:
    return f"{1e3 * sum(xs) / len(xs):.1f}" if xs else "none"


def anchor_trace(path: str):
    """The gang trace id on the clock anchor (first line) of an event log."""
    with open(path) as f:
        anchor = json.loads(f.readline())
    expect(anchor.get("name") == "clock_anchor", f"{path}: {anchor}")
    return anchor["args"].get("trace")


def gang_trace_and_scrape(sup: str) -> str:
    """Phase 19 (f), on phase 14 (b)'s gang: every rank's event log, of
    each generation (the killed one's in its postmortem bundles), opens
    with a clock anchor carrying its generation's ``GLINT_TRACE_ID``, one
    id a generation, a new one after the restart; and the gang scrape
    (``gang_to_prometheus`` of the ranks' final status files merged, as
    the supervisor's ``/metrics`` serves it) has
    ``glint_gang_checkpoint_shard_verify_seconds`` (the resumed ranks'
    verify) and the final id as its step-time exemplar. Returns that id."""
    from glint_word2vec_torch.obs.aggregate import merge_training_snapshots
    from glint_word2vec_torch.obs.prometheus import gang_to_prometheus

    final = {anchor_trace(os.path.join(sup, f"events-{r}.jsonl")) for r in (0, 1)}
    expect(len(final) == 1 and None not in final,
           f"19 (f) the ranks' anchors carry {final}")
    (trace_id,) = final
    killed = set()
    for r in (0, 1):
        bundle = os.path.join(sup, f"postmortem-0-{r}")
        with open(os.path.join(bundle, "meta.json")) as f:
            meta = json.load(f)
        expect(anchor_trace(os.path.join(bundle, "events.jsonl")) == meta["trace"],
               f"19 (f) rank {r}'s first generation: anchor against {meta}")
        killed.add(meta["trace"])
    expect(len(killed) == 1 and trace_id not in killed,
           f"19 (f) generation ids {killed} then {trace_id}")
    snaps = {}
    for r in (0, 1):
        with open(os.path.join(sup, f"status-{r}.json")) as f:
            snaps[r] = json.load(f)
    merged = merge_training_snapshots(snaps, num_workers=2)
    text = gang_to_prometheus(merged)
    verify = [ln for ln in text.splitlines()
              if ln.startswith("glint_gang_checkpoint_shard_verify_seconds ")]
    expect(len(verify) == 1 and float(verify[0].split()[1]) > 0,
           f"19 (f) gang scrape: {verify}")
    expect(merged["steptime_trace_id"] == trace_id
           and f'trace_id="{trace_id}"' in text,
           f"19 (f) step-time exemplar {merged['steptime_trace_id']}")
    log(f"19 (f) gang (b): both ranks' clock anchors carry the gang trace id "
        f"of their generation ({sorted(killed)[0]}, then {trace_id}); the gang "
        f"scrape has {verify[0]} and the id as its step-time exemplar")
    return trace_id


def supervised_gang(torch, np, path: str, n_tok: int, tmp: str) -> dict:
    """Phase 14 (b): ``cli supervise --workers 2 train --exchange sparse
    --exchange-wire int8 --exchange-every 4`` over the corpus at ``path``,
    two epochs, checkpointed, both ranks on the card, rank 1 killed early
    in its second epoch (:func:`gang_kill_round`), in its first
    generation: one restart from the last committed checkpoint, equal table hashes, a model that
    loads; the ranks' words/s, exchange seconds and bytes a round,
    capacity and stall; each rank's kernel launches (its metrics file)."""
    from glint_word2vec_torch.models import load_model

    d = os.path.join(tmp, "gang")
    report_path, model_dir = os.path.join(d, "report.json"), os.path.join(d, "model")
    os.makedirs(d)
    kill = gang_kill_round(n_tok)
    t0 = time.perf_counter()
    gang_cli(["supervise", "--workers", "2", "--report-out", report_path,
              "--backoff-base", "1", "--heartbeat-stale", "300",
              "--rank-env", f"1:GLINT_FAULTS=exchange.pre_send:kill@{kill}",
              "train", "--device", DEV, "--corpus", path, "--output", model_dir,
              "--checkpoint-dir", os.path.join(d, "ck"),
              "--metrics-out", os.path.join(d, "metrics.json"),
              "--exchange", "sparse", "--exchange-wire", "int8",
              "--exchange-every", "4", "--iterations", "2",
              "--vector-size", str(D), "--window", str(W_TRAIN),
              "--batch-size", str(B_TRAIN), "--negatives", str(N_NEG),
              "--min-count", "1", "--step-size", "0.025", "--seed", "1"])
    wall = time.perf_counter() - t0
    report = json.load(open(report_path))
    expect(report["completed"] and report["restarts"] == 1, f"report {report}")
    rec = report["restart_records"][0]
    expect("worker 1 killed by signal SIGKILL" in rec["reason"]
           and rec["resumed_from"] == "ckpt-1", f"restart {rec}")
    ranks = [json.load(open(os.path.join(d, f"metrics-rank{r}.json"))) for r in (0, 1)]
    expect(ranks[0]["tables_sha256"] == ranks[1]["tables_sha256"],
           "the ranks' final tables differ")
    launches = {}
    for m in ranks:
        for k, v in m["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
        expect_launched(m["kernel_launches"], (
            "pair_forward", "scatter_add_rank1_hbm", "scatter_add_rows_f32",
            "scatter_add_rows"), f"rank {m['rank']}")
    model = load_model(model_dir, device=DEV)
    for t in (model.engine.syn0, model.engine.syn1):
        expect(bool(torch.isfinite(t).all()), "non-finite gang tables")
    vsize = model.vocab.size
    model.stop()
    sup = os.path.join(d, "ck", "supervisor")
    trace_id = gang_trace_and_scrape(sup)
    syncs = [span_seconds(os.path.join(sup, f"events-{r}.jsonl"), "exchange_sync")
             for r in (0, 1)]
    ex = [m["exchange"] for m in ranks]
    wps = [m["words_per_sec"] for m in ranks]
    log(f"gang (b) {vsize} x {D}, 2 ranks on {torch.cuda.get_device_name(0)}, int8 "
        f"every=4, 2 epochs over {n_tok} tokens: {wall:.1f} s in all (supervisor); "
        f"rank 1 killed at round {kill}: restart {rec['reason']!r}, resumed from {rec['resumed_from']}, detect to "
        f"relaunch {rec['detect_to_relaunch_seconds']} s, to heartbeat "
        f"{rec['detect_to_heartbeat_seconds']} s; table hashes equal "
        f"({ranks[0]['tables_sha256'][:16]}); words/s rank 0 {wps[0]}, rank 1 "
        f"{wps[1]}, gang {wps[0] + wps[1]:.1f} (the resumed generation's fit)")
    for r in (0, 1):
        log(f"gang (b) rank {r}: {ex[r]['exchange_syncs_total']} rounds "
            f"({ex[r]['exchange_groups_total']} groups, "
            f"{ex[r]['exchange_flushes_total']} flushes, "
            f"{ex[r]['exchange_overflow_total']} spills), "
            f"{ex[r]['exchange_bytes_total'] // max(ex[r]['exchange_syncs_total'], 1)} "
            f"bytes a round, exchange_sync span mean {_mean_ms(syncs[r])} ms over "
            f"{len(syncs[r])} spans (both generations), capacity "
            f"{ex[r]['exchange_capacity']} (shrinks "
            f"{ex[r]['exchange_capacity_shrinks_total']}, grows "
            f"{ex[r]['exchange_capacity_grows_total']}), residual "
            f"{ex[r]['exchange_residual_abs']:.3g}, seconds by stage over the "
            f"resumed generation's rounds {ex[r].get('exchange_stage_seconds')}, "
            f"device_stall_seconds "
            f"{ranks[r]['device_stall_seconds']}, steptime {ranks[r].get('steptime')}; "
            f"launches {ranks[r]['kernel_launches']}")
        mem = ranks[r]["host_memory"]
        log(f"gang (b) rank {r} host memory (its resumed generation): peak RSS "
            f"{gib(mem['peak_rss_bytes'])}, pinned peak "
            f"{gib(mem.get('pinned_peak_bytes'))}, pinned at the end "
            f"{gib(mem.get('pinned_bytes'))}, kept by the exchange "
            f"{gib(mem['exchange_kept_bytes'])}")
    return dict(launches=launches, model_dir=model_dir, wps=wps, ex=ex,
                report=report, trace_id=trace_id)


def gang_quality(torch, np, tmp: str) -> None:
    """Phase 14 (c): a two-rank ``--exchange sparse`` gang on the
    ``tiny_corpus`` structure at the settings of
    ``tests/test_model_e2e.py``, held to the vienna and berlin gates."""
    from glint_word2vec_torch.models import load_model

    d = os.path.join(tmp, "tiny")
    os.makedirs(d)
    corpus = os.path.join(d, "c.txt")
    with open(corpus, "w") as f:
        f.write("".join(" ".join(s) + "\n" for s in make_tiny_corpus(np)))
    gang_cli(["supervise", "--workers", "2", "--report-out",
              os.path.join(d, "report.json"), "train", "--device", DEV,
              "--corpus", corpus,
              "--output", os.path.join(d, "m"), "--checkpoint-dir",
              os.path.join(d, "ck"), "--exchange", "sparse", "--iterations", "6",
              "--vector-size", "48", "--window", "5", "--step-size", "0.025",
              "--batch-size", "256", "--negatives", "5", "--min-count", "5",
              "--seed", "1"])
    m = load_model(os.path.join(d, "m"), device=DEV)
    syns = m.find_synonyms("austria", 10)
    res = [w for w, _ in m.analogy(positive=["vienna", "germany"],
                                   negative=["austria"], num=10)]
    log(f"gang (c) tiny_corpus, 2 ranks, sparse: austria -> "
        f"{[w for w, _ in syns][:4]}; vienna - austria + germany -> {res[:3]}")
    expect("vienna" in dict(syns) and dict(syns)["vienna"] > 0.5,
           f"gang vienna gate: {syns}")
    expect("berlin" in res, f"gang berlin gate: {res}")
    m.stop()


def gang_transform(torch, np, model_dir: str, tmp: str) -> None:
    """Phase 14 (d): ``transform-file --workers 2`` over phase 12's
    100,000 lines under the supervisor, against ``--workers 1``: the
    ranks' shards concatenated are bitwise the single run's."""
    from glint_word2vec_torch.batch.transform import load_transform_output

    inp = os.path.join(tmp, "lines.txt")
    write_transform_input(np, inp)
    base = ["transform-file", "--model", model_dir, "--input", inp,
            "--rows", str(TRANSFORM_ROWS), "--max-len", str(TRANSFORM_MAX_LEN),
            "--shard-size", str(TRANSFORM_SHARD), "--device", DEV]
    t0 = time.perf_counter()
    gang_cli(base + ["--out", os.path.join(tmp, "t2"), "--workers", "2"])
    t2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(base + ["--out", os.path.join(tmp, "t1")])
    t1 = time.perf_counter() - t0
    one = load_transform_output(os.path.join(tmp, "t1"))
    two = np.concatenate([load_transform_output(os.path.join(tmp, "t2", f"rank-{r:04d}"))
                          for r in (0, 1)])
    expect(one.shape[0] == TRANSFORM_LINES and np.array_equal(one, two),
           f"--workers 2 differs from --workers 1 ({one.shape}, {two.shape})")
    log(f"gang (d) transform-file of {TRANSFORM_LINES} lines: --workers 2 under the "
        f"supervisor ({t2:.1f} s with start-up) bitwise --workers 1 in this "
        f"process ({t1:.1f} s with the model's load)")


def exchange_gang(torch, np, fs, rows_mod) -> dict:
    """Phase 14."""
    tmp = tempfile.mkdtemp(prefix="glint_chip_gang_")
    try:
        prefix = os.path.join(tmp, "prefix.txt")
        write_synthetic_corpus(np, prefix, tokens=GANG_TOKENS)
        with HostMemoryPeak() as mem:
            replicas = replica_rounds(torch, np, fs, rows_mod, prefix)
        log(f"replicas (a) {mem.line()}")
        torch.cuda.empty_cache()
        short = os.path.join(tmp, "gang.txt")
        n_tok = write_synthetic_corpus(np, short, tokens=GANG_FIT_TOKENS)
        zero_counters(fs, rows_mod)
        with HostMemoryPeak() as mem:
            gang = supervised_gang(torch, np, short, n_tok, tmp)
        log(f"gang (b) {mem.line()}")
        with HostMemoryPeak() as mem:
            gang_quality(torch, np, tmp)
            gang_transform(torch, np, gang["model_dir"], tmp)
        log(f"gang (c), (d) {mem.line()}")
        log(f"phase 14 on {nvidia_smi_line()}")
        return {**gang, "replicas": replicas}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 15: the model catalog
# ----------------------------------------------------------------------

#: Phase 15's catalog: the planted model of seed 300 as the default and
#: those of seeds 301 and 302 beside it, under a budget of
#: CATALOG_BUDGET_MODELS models' resident bytes (two fit, three do not),
#: asked by CATALOG_CLIENTS clients CATALOG_REQUESTS cache misses each,
#: round robin over the three ids; then the default model's latency over
#: HOT_REQUESTS alone and while another model stages in.
CATALOG_SEEDS = (300, 301, 302)
CATALOG_IDS = ("default", "s301", "s302")
CATALOG_BUDGET_MODELS = 2.5
CATALOG_CLIENTS = 8
CATALOG_REQUESTS = 6
CATALOG_FIRST_WORD = 20_000
HOT_REQUESTS = 60
#: Words phase 16 asks model b (the seed-302 model) through the balancer.
FLEET_B_WORDS = ("w7", "w40", "w512")


def expected_top10(torch, rows_mod, syn0, words):
    """Each word's ten nearest words by cosine on ``syn0`` (itself
    excluded), computed with the plain gather and plain products on the
    card: ``(ids (Q, 10), sims (Q, 10))`` as host arrays."""
    ids = torch.tensor([int(w[1:]) for w in words], device=syn0.device)
    q = rows_mod.gather_rows_reference(syn0, ids)
    norms = torch.linalg.vector_norm(syn0, dim=1).clamp_min(1e-12)
    sims = (q @ syn0.T) / norms[None, :] / torch.linalg.vector_norm(
        q, dim=1, keepdim=True).clamp_min(1e-12)
    sims[torch.arange(len(words), device=syn0.device), ids] = -2.0
    top = torch.topk(sims, 10, dim=1)
    return top.indices.cpu().numpy(), top.values.cpu().numpy()


def check_top10(np, answers: dict, expected: dict, what: str) -> int:
    """Hold every ``(model id, word) -> [[word, score], ...]`` answer
    against the expected ids of that model (``same_ids_up_to_ties``).
    Returns the number of tie swaps."""
    swaps = 0
    for (mid, word), hits in answers.items():
        words, ids, sims = expected[mid]
        q = words.index(word)
        got = np.array([[int(w[1:]) for w, _ in hits]])
        expect(got.shape == (1, 10), f"{what}: {mid} {word} gave {hits}")
        swaps += same_ids_up_to_ties(np, got, ids[q:q + 1], sims[q:q + 1])
    return swaps


def catalog_words():
    """``{model id: [words]}`` the phase 15 drill sends (distinct across
    every request: each one a cache miss), and each request's
    ``(client, i) -> (model id, word)``."""
    plan = {}
    for c in range(CATALOG_CLIENTS):
        for i in range(CATALOG_REQUESTS):
            plan[(c, i)] = (CATALOG_IDS[(c + i) % len(CATALOG_IDS)],
                            f"w{CATALOG_FIRST_WORD + c * CATALOG_REQUESTS + i}")
    words = {mid: [w for m, w in plan.values() if m == mid] for mid in CATALOG_IDS}
    return words, plan


def timed_post(port: int, path: str, payload) -> tuple:
    """``(status, body or None, ms)`` of one POST on a new connection."""
    import http.client

    t = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, json.dumps(payload),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        status = r.status
    finally:
        conn.close()
    body = json.loads(data) if status == 200 else None
    return status, body, (time.perf_counter() - t) * 1e3


def catalog_drill(torch, np, fs, rows_mod, server, expected) -> dict:
    """Phase 15 (a) to (c) and (f): CATALOG_CLIENTS threads, each sending
    CATALOG_REQUESTS cache-miss ``/m/<id>/synonyms`` back to back, round
    robin over the ids, with the launch counters zeroed just before and
    every stage-in timed."""
    cat = server.catalog
    stage_log = []
    orig = cat._stage_in

    def timed_stage_in(entry):
        t0 = time.perf_counter()
        orig(entry)
        stage_log.append((entry.model_id, time.perf_counter() - t0,
                          sum(1 for e in cat.entries.values() if e.resident)))

    cat._stage_in = timed_stage_in
    words, plan = catalog_words()
    out, errors = {}, []
    before = {mid: dispatches(server._entry_snapshot(cat.get(mid)))
              for mid in CATALOG_IDS}
    snap0 = cat.snapshot()

    def client(c):
        for i in range(CATALOG_REQUESTS):
            mid, word = plan[(c, i)]
            try:
                status, body, ms = timed_post(server.port, f"/m/{mid}/synonyms",
                                              {"word": word, "num": 10})
            except OSError as e:
                errors.append(f"{mid} {word}: {e!r}")
                continue
            if status != 200:
                errors.append(f"{mid} {word}: {status}")
            else:
                out[(mid, word)] = body

    zero_counters(fs, rows_mod)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CATALOG_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        cat._stage_in = orig
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counted = read_counters(fs, rows_mod)
    launches = counted["gather_rows"]
    served = sum(dispatches(server._entry_snapshot(cat.get(mid))) - before[mid]
                 for mid in CATALOG_IDS)
    snap = cat.snapshot()
    n = CATALOG_CLIENTS * CATALOG_REQUESTS
    expect(not errors, f"15 (a) failed requests: {errors[:5]}")
    expect(len(out) == n, f"15 (a) {len(out)} answers of {n}")
    swaps = check_top10(np, out, expected, "15 (b)")
    delta = {k: snap[k] - snap0[k] for k in
             ("evictions_total", "stage_ins_total", "cold_hits_total")}
    expect(delta["evictions_total"] >= 2 and delta["stage_ins_total"] >= 2,
           f"15 (c) too little churn: {delta}")
    expect(delta["cold_hits_total"] >= delta["stage_ins_total"],
           f"15 (c) fewer cold hits than stage-ins: {delta}")
    expect(all(r <= 2 for _, _, r in stage_log),
           f"15 (c) more than two models resident after a stage-in: {stage_log}")
    expect(len(stage_log) == delta["stage_ins_total"], "15 (c) untimed stage-in")
    expect(launches == served and served > 0,
           f"15 (f) gather_rows launched {launches} times for {served} "
           "coalesced dispatches")
    log(f"15 (a)-(c): {n} requests from {CATALOG_CLIENTS} clients in "
        f"{wall:.2f} s, all 200, every top 10 its own model's "
        f"({swaps} tie swaps); churn {delta}; stage-ins "
        + ", ".join(f"{m} {s:.3f} s ({r} resident after)" for m, s, r in stage_log))
    log(f"15 (f) gather_rows launched {launches} times = {served} coalesced "
        "dispatches")
    return dict(launches=counted, peak=peak, stage_ins=stage_log, wall=wall)


def hot_latency(torch, server, first: int, stage_entry=None) -> list:
    """Request times of the default model over cache misses (words
    ``first``, ``first - 1``, ...): HOT_REQUESTS back to back, or with
    ``stage_entry`` as many as land while that model stages in (evicted
    first) on a thread of its own."""
    cat = server.catalog
    window = threading.Event()
    ms = []
    if stage_entry is None:
        for i in range(HOT_REQUESTS):
            status, _, t = timed_post(server.port, "/synonyms",
                                      {"word": f"w{first - i}", "num": 10})
            expect(status == 200, f"hot request {status}")
            ms.append(t)
        return ms
    expect(cat.evict(stage_entry) or not stage_entry.resident,
           "15: the staging model was not evictable")
    staged = []

    def stage():
        window.set()
        t = time.perf_counter()
        cat.ensure_resident(stage_entry)
        staged.append(time.perf_counter() - t)

    th = threading.Thread(target=stage)
    i = 0
    th.start()
    window.wait()
    while th.is_alive():
        status, _, t = timed_post(server.port, "/synonyms",
                                  {"word": f"w{first - i}", "num": 10})
        expect(status == 200, f"hot request {status} during a stage-in")
        ms.append(t)
        i += 1
    th.join()
    log(f"15: stage-in of {stage_entry.model_id} beside the hot model: "
        f"{staged[0]:.3f} s, {len(ms)} hot requests in it")
    return ms


def catalog_end_to_end(torch, np, fs, rows_mod) -> dict:
    """Phase 15. Returns the drill's counts and what phase 16 reuses: the
    temporary directory with the three saved models, the default model
    (seed 300) still on the card, and model b's expected answers."""
    from glint_word2vec_torch.obs.prometheus import lint_prometheus_text
    from glint_word2vec_torch.parallel.engine import query_program_builds
    from glint_word2vec_torch.serving import ModelServer

    gc_free(torch)
    tmp = tempfile.mkdtemp(prefix="glint_chip_catalog_")
    keep = {"tmp": tmp}
    server = None
    try:
        t0 = time.perf_counter()
        words, _ = catalog_words()
        dirs, expected, saves = {}, {}, []
        # The three saves run side by side, each on a thread of its own.
        with set_up_saves(), ThreadPoolExecutor(len(CATALOG_IDS)) as pool:
            for mid, seed in zip(CATALOG_IDS, CATALOG_SEEDS):
                model, _, _ = planted_model(torch, np, seed=seed)
                dirs[mid] = os.path.join(tmp, f"seed{seed}")
                ask = list(words[mid]) + (list(FLEET_B_WORDS) if seed == 302
                                          else [])
                expected[mid] = (ask, *expected_top10(torch, rows_mod,
                                                      model.engine.syn0, ask))
                saves.append((mid, model, pool.submit(model.save, dirs[mid])))
            for mid, model, done in saves:
                done.result()
                if mid == "default":
                    keep["model"] = model
                else:
                    model.stop()
        del saves, model
        gc_free(torch)
        log(f"15: three planted {V_SERVE} x {D} models built, saved "
            f"({sum(dir_bytes(d) for d in dirs.values()) / 2**30:.2f} GiB) and "
            f"their answers computed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        server = ModelServer(keep["model"], port=0, request_deadline=120.0)
        server.catalog.default.source_dir = dirs["default"]
        one = server.catalog.default.resident_bytes()
        budget = int(CATALOG_BUDGET_MODELS * one)
        server.catalog.budget_bytes = budget
        server.start_background()
        builds0 = query_program_builds()
        for mid in CATALOG_IDS[1:]:
            ta = time.perf_counter()
            entry = server.add_model(mid, model_dir=dirs[mid])
            log(f"15: added {mid} in {time.perf_counter() - ta:.2f} s (load, "
                f"warmup of {entry.model.engine.query_compiles} shapes, "
                f"{entry.model.engine.shared_program_hits} shared)")
            expect(entry.model.engine.query_compiles > 0
                   and entry.model.engine.shared_program_hits
                   == entry.model.engine.query_compiles,
                   f"15 (e) {mid}'s warmup was not all shared hits")
        expect(query_program_builds() == builds0,
               f"15 (e) query_program_builds moved {builds0} -> "
               f"{query_program_builds()} as same-shape models loaded")
        resident = [e.model_id for e in server.catalog.entries.values() if e.resident]
        log(f"15: server up in {time.perf_counter() - t0:.1f} s; one model "
            f"{one} bytes, budget {budget} bytes; resident {resident}; "
            f"query_program_builds {builds0} before and after")
        base = torch.cuda.memory_allocated()
        drill = catalog_drill(torch, np, fs, rows_mod, server, expected)
        expect(drill["peak"] < budget + 2**30,
               f"15 (d) max_memory_allocated {drill['peak']} past the budget "
               f"{budget} + 1 GiB")
        log(f"15 (d) max_memory_allocated in the drill {gib(drill['peak'])} "
            f"(budget {gib(budget)} + 1 GiB; {gib(base)} allocated before it)")
        cat = server.catalog
        victim = next(e for e in cat.entries.values()
                      if e.resident and e.evictable and not e.pins)
        torch.cuda.synchronize()
        rb, m0 = victim.resident_bytes(), torch.cuda.memory_allocated()
        expect(cat.evict(victim), "15 (d) eviction refused")
        torch.cuda.synchronize()
        freed = m0 - torch.cuda.memory_allocated()
        expect(abs(freed - rb) <= 0.01 * rb,
               f"15 (d) eviction of {victim.model_id} freed {freed} bytes, "
               f"its resident_bytes {rb}")
        log(f"15 (d) evicting {victim.model_id} lowered memory_allocated by "
            f"{freed} bytes against resident_bytes {rb} "
            f"({100 * (freed - rb) / rb:+.3f} %); memory_reserved "
            f"{gib(torch.cuda.memory_reserved())}")
        alone = hot_latency(torch, server, V_SERVE - 1)
        staging = []
        for k, e in enumerate([victim] + [x for x in cat.entries.values()
                                          if x.evictable and not x.pins
                                          and x is not victim]):
            staging += hot_latency(torch, server, V_SERVE // 2 - k * V_SERVE // 10,
                                   stage_entry=e)
        log(f"15: default model /synonyms alone: {summary(alone)}; while "
            f"another model stages in (side stream): {summary(staging)}")
        doc = get_json(server.port, "/models")
        log(f"15: /models {json.dumps(doc)}")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics?format=prometheus",
                timeout=60) as r:
            text = r.read().decode()
        lint_prometheus_text(text)
        fams = sorted({line.split()[2] for line in text.splitlines()
                       if line.startswith("# TYPE glint_model_")
                       or line.startswith("# TYPE glint_catalog_")})
        expect(any(f.startswith("glint_model_") for f in fams)
               and any(f.startswith("glint_catalog_") for f in fams),
               "15: no model or catalog families in the exposition")
        log(f"15: Prometheus exposition lint-clean, {len(fams)} model and "
            f"catalog families: {', '.join(fams)}")
        keep.update(dirs=dirs, expected=expected, launches=drill["launches"],
                    one=one)
        return keep
    except BaseException:
        cleanup_catalog(torch, keep)
        raise
    finally:
        if server is not None:
            server.stop()
            for e in list(server.catalog.entries.values()):
                if e is not server.catalog.default:
                    e.model.stop()


@contextlib.contextmanager
def set_up_saves():
    """The block's saves skip their fsyncs (``GLINT_CKPT_NO_FSYNC=1``, as
    the tests run): they write the phase's own input data, which it reads
    back from the page cache; what a save makes durable is not what
    phases 15 and 16 check."""
    prev = os.environ.get("GLINT_CKPT_NO_FSYNC")
    os.environ["GLINT_CKPT_NO_FSYNC"] = "1"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("GLINT_CKPT_NO_FSYNC", None)
        else:
            os.environ["GLINT_CKPT_NO_FSYNC"] = prev


def gc_free(torch) -> None:
    """Drop this process's unreferenced tensors and return the cached
    blocks, so a phase's device-memory figures start from what is live."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs_ in os.walk(path) for f in fs_)


def cleanup_catalog(torch, cat: dict) -> None:
    """Free phase 15's kept model and remove its temporary directory."""
    model = cat.pop("model", None)
    if model is not None:
        model.stop()
    shutil.rmtree(cat["tmp"], ignore_errors=True)
    gc_free(torch)


# ----------------------------------------------------------------------
# Phase 16: the self-healing fleet
# ----------------------------------------------------------------------

FLEET_REPLICAS = 2
FLEET_CLIENTS = 4
FLEET_MIRROR_SECONDS = 3
FLEET_POLL = 0.5
FLEET_TIMEOUT = 300.0


def link_tree(src: str, dst: str) -> None:
    """``dst`` as a tree of hard links to ``src``'s files (copies where the
    filesystem refuses links)."""
    for root, _, files in os.walk(src):
        out = os.path.join(dst, os.path.relpath(root, src))
        os.makedirs(out, exist_ok=True)
        for f in files:
            try:
                os.link(os.path.join(root, f), os.path.join(out, f))
            except OSError:
                shutil.copy2(os.path.join(root, f), os.path.join(out, f))


def publish_generation(pub: str, gen: str, src: str) -> None:
    """Commit the model directory ``src`` as ``gen`` in ``pub`` the way the
    publish protocol does: the directory renamed in whole, then
    ``LATEST.json`` replaced."""
    from glint_word2vec_torch.utils import atomic_write_json

    os.replace(src, os.path.join(pub, gen))
    atomic_write_json(os.path.join(pub, "LATEST.json"),
                      {"generation": gen, "seq": int(gen.split("-")[1]),
                       "published_unix": time.time()})


def stage_generations(torch, cat: dict, staged: dict, errors: list) -> None:
    """Phase 16's generations 2 and 3 built from the seed-300 model and
    saved next to the publish directory (``staged[gen]`` their
    directories, ``staged["seconds"]`` the time); a failure is appended to
    ``errors``."""
    from glint_word2vec_torch.convert import model_from_arrays

    try:
        t0 = time.perf_counter()
        base = cat["model"]
        shape = base.engine.syn0.shape
        with set_up_saves():
            for gen, seed, noisy in (("gen-000002", 303, True),
                                     ("gen-000003", 304, False)):
                g = torch.Generator(device="cuda").manual_seed(seed)
                syn0 = torch.randn(shape, generator=g, device="cuda")
                if noisy:
                    syn0 = base.engine.syn0 + 0.01 * syn0
                m = model_from_arrays(base.vocab.words, syn0, base.engine.syn1,
                                      base.vocab.counts, base.params,
                                      device="cuda")
                del syn0
                staged[gen] = os.path.join(cat["tmp"], f"staged-{gen}")
                m.save(staged[gen])
                m.stop()
        staged["seconds"] = time.perf_counter() - t0
    except BaseException as e:  # reported by the phase
        errors.append(repr(e))


def replica_pid(tag: str) -> int:
    """The pid of the replica process whose command line names the port
    file ``replica-<tag>.port`` (``tag`` is ``<slot>.<launch>``)."""
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if any(a.endswith(f"replica-{tag}.port".encode()) for a in argv):
            return int(pid)
    raise AssertionError(f"no replica process replica-{tag}")


class FleetClients:
    """Closed-loop cache-miss ``/synonyms`` clients through a balancer,
    each request on a new connection (``SO_REUSEPORT`` spreads
    connections, not requests) and for a word no earlier request asked
    (client ``c`` walks ``span`` words from ``first_word + c * span``),
    with ``headers(c)`` as client ``c``'s headers and ``pause`` seconds
    between its requests. Records ``(sent, done, status)`` of every
    request; a connection error is recorded as its exception's class
    name."""

    def __init__(self, port: int, clients: int = FLEET_CLIENTS,
                 first_word: int = V_SERVE // 10, span: int = V_SERVE // 5,
                 headers=None, pause: float = 0.0):
        self.port, self.rows = port, []
        self.first_word, self.span = first_word, span
        self.headers, self.pause = headers or (lambda c: None), pause
        self._stop = threading.Event()
        self._mu = threading.Lock()
        self._threads = [threading.Thread(target=self._run, args=(c,))
                         for c in range(clients)]

    def _run(self, c: int) -> None:
        i = 0
        while not self._stop.is_set():
            word = f"w{self.first_word + c * self.span + i % self.span}"
            t = time.time()
            status = fresh_post(self.port, "/synonyms", {"word": word, "num": 10},
                                self.headers(c))[0]
            with self._mu:
                self.rows.append((t, time.time(), status))
            i += 1
            if self.pause:
                self._stop.wait(self.pause)

    def __enter__(self):
        for th in self._threads:
            th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for th in self._threads:
            th.join(timeout=120)

    def window(self, t0: float, t1: float) -> list:
        with self._mu:
            return [r for r in self.rows if t0 <= r[0] <= t1]


def rotation_watch(port: int, stop, seen: list) -> None:
    """Sample the balancer's breakers every 0.1 s until ``stop``: the
    replicas in rotation (closed and not held), and each breaker state."""
    while not stop.is_set():
        try:
            doc = get_json(port, "/metrics")
            states = [(r["breaker"]["state"], r["breaker"]["held"])
                      for r in doc["replicas"]]
            seen.append((time.time(), sum(1 for s, h in states
                                          if s == "closed" and not h), states))
        except (OSError, ValueError):
            pass
        stop.wait(0.1)


def wait_until(pred, what: str, timeout: float = FLEET_TIMEOUT):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        got = pred()
        if got:
            return time.perf_counter() - t0
        time.sleep(0.1)
    raise AssertionError(f"16: timed out after {timeout:.0f} s waiting for {what}")


def fleet_replica_snaps(doc: dict) -> list:
    """Each replica's own ``/metrics`` snapshot from a balancer document,
    failing a replica that did not answer."""
    expect(all(r.get("up") for r in doc["replicas"]),
           f"16: a replica's /metrics did not answer: {doc['replicas']}")
    return [r["snapshot"] for r in doc["replicas"]]


def replica_gens(port: int) -> list:
    return [s["hot_swap"]["generation"]
            for s in fleet_replica_snaps(get_json(port, "/metrics"))]


def fleet_end_to_end(torch, np, rows_mod, cat: dict) -> dict:
    """Phase 16 on phase 15's saved models. Returns the replicas' launch
    counts since their warmups."""
    from glint_word2vec_torch.obs.prometheus import lint_prometheus_text

    tmp, dirs = cat["tmp"], cat["dirs"]
    pub = os.path.join(tmp, "pub")
    os.makedirs(pub)
    link_tree(dirs["default"], os.path.join(tmp, "staged-gen-000001"))
    publish_generation(pub, "gen-000001",
                       os.path.join(tmp, "staged-gen-000001"))
    port_file = os.path.join(tmp, "fleet.json")
    logs = os.path.join(tmp, "replica-logs")
    fleet_log = open(os.path.join(tmp, "fleet.log"), "wb")
    argv = [sys.executable, "-m", "glint_word2vec_torch.cli", "serve-fleet",
            "--replicas", str(FLEET_REPLICAS), "--device", "cuda",
            "--watch-checkpoint", pub, "--watch-poll", str(FLEET_POLL),
            "--add-model", f"b={dirs['s302']}",
            "--canary-mirror-seconds", str(FLEET_MIRROR_SECONDS),
            "--port", "0", "--port-file", port_file,
            "--replica-log-dir", logs]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("GLINT_FAULTS", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=fleet_log, stderr=subprocess.STDOUT,
                            cwd=here, env=env, start_new_session=True)
    stop_watch = threading.Event()
    seen = []
    # Generations 2 (generation 1 plus 1 % noise) and 3 (a fresh random
    # table) are written while the fleet boots, and published later by a
    # rename and a pointer flip.
    staged, prep_error = {}, []
    prep = threading.Thread(target=stage_generations,
                            args=(torch, cat, staged, prep_error))
    prep.start()
    try:
        wait_until(lambda: os.path.exists(port_file) or proc.poll() is not None,
                   "the fleet's port file")
        expect(proc.poll() is None, f"16: serve-fleet exited rc={proc.returncode}")
        port = json.load(open(port_file))["port"]
        boot = time.perf_counter() - t0
        doc = get_json(port, "/metrics")
        for r in doc["replicas"]:
            host, rport = r["url"][len("http://"):].split(":")
            h = get_json(int(rport), "/healthz")
            expect(h["device"] == torch.cuda.get_device_name(0),
                   f"16 (a) replica {r['url']} serves on {h['device']}")
            expect(set(h["models"]) == {"default", "b"},
                   f"16 (a) replica catalog {sorted(h['models'])}")
        b_answers = {("s302", w): post(port, "/m/b/synonyms",
                                       {"word": w, "num": 10})
                     for w in FLEET_B_WORDS}
        check_top10(np, b_answers, cat["expected"], "16 (a) /m/b/synonyms")
        log(f"16 (a): {FLEET_REPLICAS} replicas on the card, each with models "
            f"default and b, up in {boot:.1f} s (launch to the balancer's port "
            f"file); /m/b/synonyms through the balancer answers model b's "
            "own top 10")
        watcher = threading.Thread(target=rotation_watch,
                                   args=(port, stop_watch, seen))
        watcher.start()
        with FleetClients(port) as clients:
            time.sleep(1.0)
            # (b) replica 1 killed under traffic.
            t_kill = time.time()
            os.kill(replica_pid("1.0"), 9)

            def relaunched():
                d = get_json(port, "/metrics")
                st = d["supervisor"]["replica_states"][1]
                br = d["replicas"][1]["breaker"]
                return (st["restarts"] == 1 and st["state"] == "up"
                        and br["state"] == "closed" and br["opened_total"] >= 1
                        and br["closed_total"] >= 1)

            wait_until(relaunched, "replica 1 relaunched and readmitted")
            t_back = time.time()
            doc = get_json(port, "/metrics")
            rec = doc["supervisor"]["replica_states"][1]["restart_records"][-1]
            host, rport = doc["replicas"][1]["url"][len("http://"):].split(":")
            fgen = get_json(int(rport), "/healthz")["fleet_generation"]
            expect(fgen == "1.1", f"16 (b) relaunch under GLINT_FLEET_GEN {fgen}")
            kill_ms = [(d - s) * 1e3 for s, d, _ in clients.window(t_kill, t_back)]
            ejected = any(states[1][0] != "closed" for t, _, states in seen
                          if t >= t_kill)
            expect(ejected, "16 (b) the breaker never ejected replica 1")
            log(f"16 (b): replica 1 SIGKILLed; relaunched as {fgen} and "
                f"readmitted after {t_back - t_kill:.1f} s (detect to ready "
                f"{rec['detect_to_ready_seconds']} s, reason {rec['reason']!r}); "
                f"clients in the window: {percentile_line(kill_ms)}")
            # (c) generation 2: generation 1 plus 1 % noise.
            prep.join()
            expect(not prep_error, f"16: staging generations failed: {prep_error}")
            publish_generation(pub, "gen-000002", staged["gen-000002"])
            t2 = wait_until(lambda: (get_json(port, "/metrics").get("rollout")
                                     or {}).get("generation") == "gen-000002",
                            "generation 2 rolled out")
            ro = get_json(port, "/metrics")["rollout"]
            expect(replica_gens(port) == ["gen-000002"] * FLEET_REPLICAS,
                   f"16 (c) replicas on {replica_gens(port)}")
            expect(ro["canary"]["last_verdict"] == "pass",
                   f"16 (c) canary {ro['canary']}")
            agree2 = ro["canary"]["last_agreement"]
            log(f"16 (c): gen-000002 promoted {t2:.1f} s after its publish "
                f"(written during the boot in {staged['seconds']:.1f} s); canary "
                f"agreement {agree2} over {ro['canary']['last_scored']} "
                f"responses; steps {ro['step_seconds']}")
            # (d) generation 3: a fresh random table.
            publish_generation(pub, "gen-000003", staged["gen-000003"])
            t3 = wait_until(lambda: get_json(port, "/metrics")["rollout"]
                            ["held_back_generation"] == "gen-000003",
                            "generation 3 held back")
            ro = get_json(port, "/metrics")["rollout"]
            expect(replica_gens(port) == ["gen-000002"] * FLEET_REPLICAS,
                   f"16 (d) replicas on {replica_gens(port)}")
            agree3 = ro["canary"]["last_agreement"]
            log(f"16 (d): gen-000003 held back {t3:.1f} s after its publish; "
                f"canary agreement {agree3} (gate "
                f"{ro['canary']['agreement_gate']}); steps {ro['step_seconds']}")
            time.sleep(0.5)
        stop_watch.set()
        watcher.join(timeout=30)
        bad = [r for r in clients.rows if r[2] != 200]
        expect(not bad, f"16: {len(bad)} client requests failed, first "
               f"{bad[:5]} (a class name: a connection error)")
        low = min(n for _, n, _ in seen)
        expect(low >= 1, "16 (c) the balancer's rotation fell to 0 replicas")
        ms = [(d - s) * 1e3 for s, d, _ in clients.rows]
        log(f"16: {len(clients.rows)} client requests, all 200 "
            f"({summary(ms)}); replicas in rotation never below {low} "
            f"({len(seen)} samples)")
        # (e) the merged exposition and the replicas' launch counts.
        doc = get_json(port, "/metrics")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics?format=prometheus",
                timeout=60) as r:
            text = r.read().decode()
        lint_prometheus_text(text)
        snaps = fleet_replica_snaps(doc)
        launches = {}
        for i, s in enumerate(snaps):
            since = {k: s["kernel_launches"][k] - s["kernel_launches_warmup"][k]
                     for k in s["kernel_launches"]}
            served = sum(dispatches(m) for m in s["models"].values())
            expect(since["gather_rows"] > 0 and since["gather_rows"] == served,
                   f"16 (e) replica {i}: gather_rows {since['gather_rows']} "
                   f"since its warmup, {served} coalesced dispatches")
            for k, v in since.items():
                launches[k] = launches.get(k, 0) + v
        log(f"16 (e): merged /metrics lint-clean ({len(text.splitlines())} "
            f"lines); gather_rows since warmup per replica "
            + ", ".join(str(s["kernel_launches"]["gather_rows"]
                            - s["kernel_launches_warmup"]["gather_rows"])
                        for s in snaps)
            + f" = their coalesced dispatches; launches {launches}")
        expect(post_status(port, "/shutdown", {}) == 200, "16: shutdown refused")
        proc.wait(timeout=120)
        expect(proc.returncode == 0, f"16: serve-fleet exited {proc.returncode}")
        return dict(launches=launches, agreement=(agree2, agree3))
    except BaseException:
        fleet_log.flush()
        for path in [os.path.join(tmp, "fleet.log")] + sorted(
                os.path.join(logs, f) for f in (os.listdir(logs)
                                                if os.path.isdir(logs) else [])):
            with open(path, "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            log(f"16: tail of {os.path.basename(path)}:\n{tail}")
        raise
    finally:
        stop_watch.set()
        prep.join()
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, 9)
            except OSError:
                pass
            proc.wait(timeout=60)
        # The replicas run in sessions of their own: a kill of the
        # supervisor's group leaves them, so stop any left (their command
        # lines name this phase's directory).
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv_ = f.read()
            except OSError:
                continue
            if tmp.encode() in argv_ and b"--port-file" in argv_:
                try:
                    os.kill(int(pid), 9)
                except OSError:
                    pass
        fleet_log.close()


# ----------------------------------------------------------------------
# Phase 17: the demand-driven fleet
# ----------------------------------------------------------------------

DEMAND_INFLIGHT = 4
DEMAND_SURGE_CLIENTS = 32
#: Tenants the surge's clients take turns with (two clients a tenant).
DEMAND_SURGE_TENANTS = 16
DEMAND_TENANT_RATE, DEMAND_TENANT_BURST, DEMAND_BULK_INFLIGHT = 20, 10, 2
DEMAND_PROCS = 2
DEMAND_ROUTE_REQUESTS = 200
DEMAND_FLOOD, DEMAND_BULK, DEMAND_DEADLINE = 60, 8, 20
DEMAND_TIMEOUT = 120.0


def fresh_post(port: int, path: str, payload, headers=None) -> tuple:
    """``(status, Retry-After, body or None, ms)`` of one POST on a new
    connection; a connection error gives the error's class name as the
    status."""
    import http.client

    t = time.perf_counter()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", path, json.dumps(payload),
                         {"Content-Type": "application/json", **(headers or {})})
            r = conn.getresponse()
            status, retry, data = r.status, r.getheader("Retry-After"), r.read()
        finally:
            conn.close()
        try:
            body = json.loads(data)
        except ValueError:
            body = None
    except OSError as e:
        status, retry, body = type(e).__name__, None, None
    return status, retry, body, (time.perf_counter() - t) * 1e3


def fleet_processes(tag: str) -> dict:
    """pid -> command line of the processes whose command line names
    ``tag`` (phase 17's directory)."""
    out = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode(errors="replace").split("\0")
        except OSError:
            continue
        if any(tag in a for a in argv):
            out[int(pid)] = argv
    return out


def holds_device_files(pid: int) -> bool:
    """Whether the process has a ``/dev/nvidia*`` file open: a process
    that made a CUDA context has."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def maps_torch(pid: int) -> bool:
    """Whether the process has torch's library or ``libcuda``
    mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return any("libtorch" in ln or "libcuda" in ln for ln in f)
    except OSError:
        return False


def compute_app_pids() -> set:
    """The pids ``nvidia-smi`` lists as holding a context on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {int(x) for x in out.stdout.split() if x.strip().isdigit()}


def since_warmup(snap: dict) -> int:
    """``gather_rows`` launches a replica made since its warmup."""
    return (snap["kernel_launches"]["gather_rows"]
            - snap["kernel_launches_warmup"]["gather_rows"])


def replica_dispatches(snap: dict) -> int:
    return sum(dispatches(m) for m in snap["models"].values())


def released_together(port: int, n: int, headers, first_word: int) -> tuple:
    """``n`` requests released by one barrier, each on a new connection.
    Returns their ``fresh_post`` results and the seconds from the release
    to the last answer."""
    gate = threading.Barrier(n + 1)
    out = [None] * n

    def one(i):
        gate.wait()
        out[i] = fresh_post(port, "/synonyms",
                            {"word": f"w{first_word + i}", "num": 10}, headers)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    gate.wait()
    t = time.perf_counter()
    for th in threads:
        th.join(timeout=120)
    return out, time.perf_counter() - t


def prom_samples(text: str, family: str) -> dict:
    """Label set (the text between braces) -> value of a family's
    samples."""
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{") or line.startswith(family + " "):
            key, _, value = line.rpartition(" ")
            out[key[len(family):]] = float(value)
    return out


def demand_fleet_end_to_end(torch, np, cat: dict) -> dict:
    """Phase 17 on phase 15's seed-300 model. Returns the replicas'
    ``gather_rows`` launches since their warmups."""
    from glint_word2vec_torch.obs.prometheus import lint_prometheus_text

    tmp = tempfile.mkdtemp(prefix="demand_", dir=cat["tmp"])
    trace_dir = os.path.join(tmp, "trace")
    port_file = os.path.join(tmp, "fleet.json")
    logs = os.path.join(tmp, "replica-logs")
    fleet_log = open(os.path.join(tmp, "fleet.log"), "wb")
    argv = [sys.executable, "-m", "glint_word2vec_torch.cli", "serve-fleet",
            "--model", cat["dirs"]["default"], "--device", "cuda",
            "--replicas", "1", "--warm-spares", "1",
            "--balancer-procs", str(DEMAND_PROCS),
            "--max-inflight", str(DEMAND_INFLIGHT),
            "--qos-tenant-rate", str(DEMAND_TENANT_RATE),
            "--qos-tenant-burst", str(DEMAND_TENANT_BURST),
            "--qos-bulk-max-inflight", str(DEMAND_BULK_INFLIGHT),
            "--autoscale-interval", "0.25", "--autoscale-up-shed-rate", "1",
            "--autoscale-up-window", "0.5", "--autoscale-down-window", "4",
            "--autoscale-cooldown", "1", "--trace-dir", trace_dir,
            "--port", "0", "--port-file", port_file, "--replica-log-dir", logs]
    argv[argv.index("cuda")] = DEV
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    # The fleet's own temporary files (the shards' configurations) under
    # this phase's directory, so every process of the fleet names it.
    env["TMPDIR"] = tmp
    env.pop("GLINT_FAULTS", None)
    statuses = []  # every answer of the phase, to hold against 5xx
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=fleet_log, stderr=subprocess.STDOUT,
                            cwd=here, env=env, start_new_session=True)

    def doc():
        # A new connection each time: one the kernel queued on a shard
        # killed in (d) is reset, and asked again.
        for attempt in range(20):
            try:
                return get_json(port, "/metrics")
            except (ConnectionError, urllib.error.URLError):
                if attempt == 19:
                    raise
                time.sleep(0.1)

    def wait_for(pred, what, timeout=DEMAND_TIMEOUT):
        t = time.perf_counter()
        while time.perf_counter() - t < timeout:
            if pred():
                return time.perf_counter() - t
            expect(proc.poll() is None, f"17: serve-fleet exited "
                   f"rc={proc.returncode} waiting for {what}")
            time.sleep(0.05)
        raise AssertionError(f"17: timed out after {timeout:.0f} s waiting "
                             f"for {what}")

    try:
        wait_for(lambda: os.path.exists(port_file), "the fleet's port file",
                 timeout=300)
        port = json.load(open(port_file))["port"]
        boot = time.perf_counter() - t0
        # (a) Boot and routing.
        d = doc()
        expect(d["holds"] == {"held": {"1": ["autoscale"]}},
               f"17 (a) holds {d['holds']}")
        auto = d["autoscale"]
        expect((auto["live"], auto["spares"]) == (1, 1), f"17 (a) {auto}")
        expect([s.get("up") for s in d["balancer_shards"]] == [True] * DEMAND_PROCS,
               f"17 (a) shards {d['balancer_shards']}")
        procs = fleet_processes(tmp)
        shards = {p for p, a in procs.items() if "fleet-shard" in a}
        replicas = {p for p, a in procs.items() if "serve" in a}
        expect(len(shards) == DEMAND_PROCS - 1 and len(replicas) == 2,
               f"17 (a) processes {procs}")
        t = time.perf_counter()
        for i in range(DEMAND_ROUTE_REQUESTS):
            st = fresh_post(port, "/synonyms",
                            {"word": f"w{V_SERVE // 10 + i}", "num": 10},
                            {"X-Glint-Tenant": f"t{i % 8}"})
            statuses.append(st[0])
            expect(st[0] == 200, f"17 (a) request {i}: {st[:3]}")
        route_s = time.perf_counter() - t
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics?format=prometheus",
            timeout=60).read().decode()
        proxied = prom_samples(text, "glint_fleet_shard_proxied_total")
        expect(all(proxied.get(f'{{shard="{k}"}}', 0) > 0
                   for k in range(DEMAND_PROCS)),
               f"17 (a) proxied by shard {proxied}")
        on_card = compute_app_pids()
        with_files = {p for p in procs if holds_device_files(p)}
        expect(replicas <= with_files,
               f"17 (a) replica pids {replicas}, device files in {with_files}")
        expect(not (shards | {proc.pid}) & with_files,
               f"17 (a) a balancer process opened the card: {with_files}")
        with_torch = {p for p in shards | {proc.pid} if maps_torch(p)}
        expect(not with_torch, f"17 (a) torch loaded in {with_torch}")
        same_ns = bool(replicas & on_card)
        if same_ns:
            expect(not (shards | {proc.pid}) & on_card,
                   f"17 (a) nvidia-smi lists a balancer pid: {on_card}")
        log(f"17 (a): 1 live replica and 1 parked spare (held by autoscale), "
            f"{DEMAND_PROCS} balancer processes, up {boot:.1f} s after launch; "
            f"{DEMAND_ROUTE_REQUESTS} fresh-connection cache misses in "
            f"{route_s:.2f} s, all 200, proxied by shard {proxied}; "
            f"nvidia-smi compute pids {sorted(on_card)} "
            f"({'the same pid namespace' if same_ns else 'another pid namespace'}"
            f"), replicas {sorted(replicas)}, shard {sorted(shards)}, supervisor "
            f"{proc.pid}: only the replicas hold /dev/nvidia files, and the "
            f"shard and the supervisor have no torch or CUDA library mapped")
        # (b) Scale up under a surge, then down in the calm.
        spare0 = since_warmup(fleet_replica_snaps(doc())[1])
        t_surge = time.time()
        with FleetClients(port, DEMAND_SURGE_CLIENTS, V_SERVE // 5,
                          V_SERVE // 100,
                          lambda c: {"X-Glint-Tenant":
                                     f"t{c % DEMAND_SURGE_TENANTS}"}) as surge:
            up_s = wait_for(lambda: doc()["autoscale"]["scale_ups_total"] >= 1,
                            "the spare's readmission")
            wait_for(lambda: since_warmup(fleet_replica_snaps(doc())[1]) > spare0,
                     "the spare's first gather_rows")
            time.sleep(0.5)
        d = doc()
        rows = surge.rows
        statuses += [r[2] for r in rows]
        surge_codes = {c: sum(1 for r in rows if r[2] == c)
                       for c in sorted({r[2] for r in rows}, key=str)}
        expect(set(surge_codes) <= {200, 429}, f"17 (b) surge answers {surge_codes}")
        spare_served = since_warmup(fleet_replica_snaps(d)[1]) - spare0
        expect(spare_served > 0, "17 (b) the readmitted spare launched nothing")
        sheds = d["balancer"]
        ok_ms = [(r[1] - r[0]) * 1e3 for r in rows if r[2] == 200]
        log(f"17 (b): {DEMAND_SURGE_CLIENTS} closed-loop clients: the spare "
            f"readmitted {up_s:.2f} s after the surge began; "
            f"{len(rows)} requests in {time.time() - t_surge:.1f} s {surge_codes}, "
            f"admitted {summary(ok_ms)}; balancer sheds: exhausted "
            f"{sheds['exhausted_total']}, QoS {sheds.get('qos', {}).get('shed_total')}; "
            f"the spare's gather_rows since warmup {spare_served}; replica "
            f"admission sheds {[s['overload']['shed_admission_total'] for s in fleet_replica_snaps(d)]}")
        t_calm = time.time()
        with FleetClients(port, 1, V_SERVE * 6 // 10, V_SERVE // 100,
                          lambda c: {"X-Glint-Tenant": "t16"},
                          pause=0.25) as calm:
            down_s = wait_for(lambda: doc()["autoscale"]["scale_downs_total"] >= 1,
                              "the spare parked again")
            time.sleep(0.5)
            parked0 = since_warmup(fleet_replica_snaps(doc())[1])
            time.sleep(1.0)
            d = doc()
            parked1 = since_warmup(fleet_replica_snaps(d)[1])
        statuses += [r[2] for r in calm.rows]
        expect(d["holds"] == {"held": {"1": ["autoscale"]}},
               f"17 (b) holds after the calm {d['holds']}")
        expect(parked1 == parked0, f"17 (b) the parked spare launched "
               f"{parked1 - parked0} gather_rows")
        auto = d["autoscale"]
        expect((auto["scale_ups_total"], auto["scale_downs_total"]) == (1, 1),
               f"17 (b) autoscale {auto}")
        log(f"17 (b): the spare parked {down_s:.2f} s after the calm began "
            f"(down window 4 s); its gather_rows {parked0} and {parked1} since "
            f"warmup across 1.0 s parked; transitions {auto['transitions']}; "
            f"{len(calm.rows)} calm requests {sorted(set(r[2] for r in calm.rows), key=str)}")
        # (c) QoS: a tenant's flood, the bulk class, infeasible deadlines.
        out, el = released_together(port, DEMAND_FLOOD,
                                    {"X-Glint-Tenant": "flood"},
                                    V_SERVE * 7 // 10)
        statuses += [o[0] for o in out]
        admitted = sum(1 for o in out if o[0] == 200)
        quota = [o for o in out if o[0] == 429 and o[2]
                 and o[2].get("error") == "tenant quota exceeded"]
        bound = DEMAND_PROCS * (DEMAND_TENANT_BURST + DEMAND_TENANT_RATE * el)
        expect(quota, "17 (c) no tenant_quota shed in the flood")
        expect(admitted <= bound, f"17 (c) {admitted} admitted > {bound:.1f}")
        bulk_sheds, rounds = [], 0
        while not bulk_sheds and rounds < 5:
            rounds += 1
            out_b, _ = released_together(
                port, DEMAND_BULK, {"X-Glint-Priority": "bulk",
                                    "X-Glint-Tenant": "bulk"},
                V_SERVE * 7 // 10 + 100 * rounds)
            statuses += [o[0] for o in out_b]
            bulk_sheds = [o for o in out_b if o[0] == 429 and o[2]
                          and o[2].get("error") == "bulk class at capacity"]
        expect(bulk_sheds, f"17 (c) no bulk_inflight shed in {rounds} rounds")
        before = [replica_dispatches(s) for s in fleet_replica_snaps(doc())]
        dl = [fresh_post(port, "/synonyms",
                         {"word": f"w{V_SERVE * 3 // 4 + i}", "num": 10},
                         {"X-Glint-Deadline-Ms": "1"})
              for i in range(DEMAND_DEADLINE)]
        statuses += [o[0] for o in dl]
        d = doc()
        after = [replica_dispatches(s) for s in fleet_replica_snaps(d)]
        expect(all(o[0] == 429 and o[2]["error"] == "deadline infeasible"
                   and o[1] for o in dl), f"17 (c) deadline answers {dl[:3]}")
        expect(after == before, f"17 (c) dispatches moved {before} -> {after}")
        for o in out + [x for x in out_b] + dl:
            if o[0] == 429:
                expect(o[1], f"17 (c) a 429 without Retry-After: {o}")
        qos = d["balancer"]["qos"]
        dl_ms = sorted(o[3] for o in dl)
        log(f"17 (c): a flood of {DEMAND_FLOOD} from one tenant: {admitted} "
            f"admitted in {el:.2f} s (bound {bound:.1f}), {len(quota)} "
            f"tenant_quota sheds; {DEMAND_BULK} bulk requests together: "
            f"{len(bulk_sheds)} bulk_inflight sheds (round {rounds}); "
            f"{DEMAND_DEADLINE} with X-Glint-Deadline-Ms 1 shed, p50 "
            f"{dl_ms[len(dl_ms) // 2]:.3f} ms, replica dispatches unmoved "
            f"{after}; QoS {qos}")
        # (d) A shard process killed and relaunched.
        (pid1,) = [p for p, a in fleet_processes(tmp).items()
                   if "fleet-shard" in a and any("shard-1." in x for x in a)]
        with FleetClients(port, 4, V_SERVE * 8 // 10, V_SERVE // 100,
                          lambda c: {"X-Glint-Tenant": f"t{c}"}) as kw:
            time.sleep(0.5)
            t_kill = time.time()
            os.kill(pid1, 9)
            relaunch_s = wait_for(
                lambda: len(doc()["data_plane"].get("shard_relaunches", [])) >= 1
                and doc()["balancer_shards"][1].get("up"), "shard 1's relaunch")
            t_back = time.time()
            time.sleep(0.5)
        statuses += [r[2] for r in kw.rows]
        # The kill window: requests in flight at the kill or sent before the
        # relaunch.
        window = [r for r in kw.rows if r[0] <= t_back and r[1] >= t_kill]
        errors = [r for r in window if not isinstance(r[2], int)]
        for i in range(100):
            st = fresh_post(port, "/synonyms",
                            {"word": f"w{V_SERVE * 9 // 10 + i}", "num": 10},
                            {"X-Glint-Tenant": f"t{i % 8}"})
            statuses.append(st[0])
        for i in range(8):  # unknown words: 404, kept in every hop's trace
            st = fresh_post(port, "/synonyms", {"word": f"zz{i}", "num": 10},
                            {"X-Glint-Tenant": f"t{i}"})
            statuses.append(st[0])
        d = doc()
        rec = d["data_plane"]["shard_relaunches"][0]
        new1 = [p for p, a in fleet_processes(tmp).items()
                if "fleet-shard" in a]
        expect(new1 and pid1 not in new1, f"17 (d) shard processes {new1}")
        expect(d["balancer_shards"][1]["stats"]["proxied_total"] > 0,
               f"17 (d) the relaunched shard proxied nothing: "
               f"{d['balancer_shards'][1]}")
        log(f"17 (d): shard 1 (pid {pid1}) SIGKILLed; relaunched as pid "
            f"{new1[0]} {t_back - t_kill:.2f} s later (detect to ready "
            f"{rec['detect_to_ready_seconds']} s, {rec['reason']}); "
            f"{len(window)} requests in the kill window, {len(errors)} "
            f"connection errors {[r[2] for r in errors][:5]}; fresh connections "
            f"proxied by the new shard {d['balancer_shards'][1]['stats']['proxied_total']}")
        # (e) The merged exposition and each replica's launches.
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics?format=prometheus",
            timeout=60).read().decode()
        lint_prometheus_text(text)
        for fam in ("glint_fleet_shard_", "glint_fleet_qos_",
                    "glint_fleet_autoscale_"):
            expect(fam in text, f"17 (e) no {fam}* family")
        launches = {}
        for i, snap in enumerate(fleet_replica_snaps(d)):
            since, served = since_warmup(snap), replica_dispatches(snap)
            expect(since > 0 and since == served,
                   f"17 (e) replica {i}: gather_rows {since} since its warmup, "
                   f"{served} coalesced dispatches")
            for k in snap["kernel_launches"]:
                launches[k] = launches.get(k, 0) + (
                    snap["kernel_launches"][k] - snap["kernel_launches_warmup"][k])
        log(f"17 (e): merged /metrics lint-clean ({len(text.splitlines())} "
            f"lines) with the shard, QoS and autoscale families; gather_rows "
            f"since warmup per replica "
            + ", ".join(str(since_warmup(s)) for s in fleet_replica_snaps(d))
            + f" = their coalesced dispatches; launches {launches}")
        # (f) Teardown, then the traces the processes flushed at exit.
        expect(post_status(port, "/shutdown", {}) == 200, "17: shutdown refused")
        proc.wait(timeout=120)
        expect(proc.returncode == 0, f"17: serve-fleet exited {proc.returncode}")
        t = time.perf_counter()
        while fleet_processes(tmp) and time.perf_counter() - t < 60:
            time.sleep(0.1)
        expect(not fleet_processes(tmp),
               f"17 (f) processes left: {fleet_processes(tmp)}")
        http5 = [c for c in statuses if isinstance(c, int) and c >= 500]
        expect(not http5, f"17: {len(http5)} answers 5xx: {http5[:10]}")
        lost = [c for c in statuses if not isinstance(c, int)]
        expect(len(lost) == len(errors),
               f"17: connection errors outside the kill window: {lost[:10]}")
        merged = os.path.join(tmp, "merged.json")
        r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.cli",
                            "trace-merge", trace_dir, "--out", merged],
                           cwd=here, env=env, capture_output=True, text=True,
                           timeout=300)
        expect(r.returncode == 0, f"17 (e) trace-merge rc {r.returncode}: "
               f"{r.stderr[-2000:]}")
        mdoc = json.load(open(merged))
        lanes = {e["args"]["name"] for e in mdoc["traceEvents"]
                 if e.get("name") == "process_name"}
        want = {"balancer"} | {f"balancer-shard-{k}" for k in range(1, DEMAND_PROCS)} \
            | {"replica-0", "replica-1"}
        expect(want <= lanes, f"17 (e) trace lanes {sorted(lanes)}")
        pid_lane = {e["pid"]: e["args"]["name"] for e in mdoc["traceEvents"]
                    if e.get("name") == "process_name"}
        by_trace = {}
        for e in mdoc["traceEvents"]:
            tid = (e.get("args") or {}).get("trace")
            if tid and e.get("pid") in pid_lane:
                by_trace.setdefault(tid, set()).add(pid_lane[e["pid"]])
        across = [t for t, ls in by_trace.items()
                  if any(x.startswith("balancer") for x in ls)
                  and any(x.startswith("replica") for x in ls)]
        expect(across, "17 (e) no trace stitched across a balancer and a replica")
        log(f"17 (f): POST /shutdown; serve-fleet exited 0 and no shard or "
            f"replica process is left; trace-merge: lanes {sorted(lanes)}, "
            f"{mdoc['otherData']['trace_ids']} trace ids, "
            f"{mdoc['otherData']['stitched_traces']} stitched ({len(across)} "
            f"across a balancer and a replica lane); answers of the phase "
            f"{ {c: statuses.count(c) for c in sorted(set(statuses), key=str)} }")
        return dict(launches=launches)
    except BaseException:
        fleet_log.flush()
        for path in [os.path.join(tmp, "fleet.log")] + sorted(
                os.path.join(logs, f) for f in (os.listdir(logs)
                                                if os.path.isdir(logs) else [])):
            with open(path, "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            log(f"17: tail of {os.path.basename(path)}:\n{tail}")
        raise
    finally:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, 9)
            except OSError:
                pass
            proc.wait(timeout=60)
        # Replicas and shards run in sessions of their own: stop any left.
        for pid in fleet_processes(tmp):
            try:
                os.kill(pid, 9)
            except OSError:
                pass
        fleet_log.close()


#: Phase 18: tokens of (b)'s dims fit and of (c)'s gang (prefixes of
#: phase 6's corpus), and (a)'s grid batches and corpus slice.
MESH_FIT_TOKENS = 1_000_000
MESH_GANG_TOKENS = 100_000
MESH_STEPS, MESH_CORPUS_TOKENS = 2, 200_000
#: The CPU tests' tolerance of a mesh against the 1 x 1 engine.
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6


def close_err(torch, got, want, what: str, rtol=MESH_RTOL, atol=MESH_ATOL) -> float:
    """Max abs error of ``got`` against ``want``; fails unless every value
    is within ``atol + rtol * |want|``."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    err = float(diff.max()) if diff.numel() else 0.0
    expect(ok, f"{what}: max abs error {err:.3g} past rtol {rtol} atol {atol}")
    return err


def mesh_kernels_at_shard_shapes(torch, np, fs, rows_mod, gen) -> float:
    """Each kernel of the mesh paths held against its plain version on the
    card at a shard's shape: B1, B2 and B3 on a (1, 2) rows shard
    (500,000 x 300) and on ``dims`` column slices 150, 38 and 2 wide (300
    over 2, 304 over 8, 12 over 8), contiguous; B4, B5, B6 and B7 at a
    (2, 1) data rank's ``P / 2`` pairs. Gathers and scatters bitwise; B4
    and B5 within phase 5's and 9's tolerances. Returns the largest error."""
    worst = 0.0
    for rows, width in ((V_TRAIN // 2, D), (V_TRAIN, D // 2), (100_000, 38),
                        (100_000, 2)):
        table = torch.rand((rows, width), generator=gen, device=DEV) - 0.5
        ids = zipf_ids(torch, gen, (20_000,), rows)
        expect(torch.equal(rows_mod.gather_rows(table, ids),
                           rows_mod.gather_rows_reference(table, ids)),
               f"B1 at a {rows} x {width} shard")
        upd = torch.rand((ids.shape[0], width), generator=gen, device=DEV) - 0.5
        h = torch.rand((1024, width), generator=gen, device=DEV) - 0.5
        coef = torch.rand(ids.shape, generator=gen, device=DEV) - 0.5
        hidx = torch.randint(0, 1024, ids.shape, generator=gen, device=DEV,
                             dtype=torch.int32)
        uniq = torch.unique(ids.long())
        for name, kernel, args, plain in (
            ("B3", rows_mod.scatter_add_rows, (upd,),
             lambda t, local: rows_mod.scatter_add_rows_reference(
                 t, local, upd.cpu())),
            ("B2", rows_mod.scatter_add_rank1, (coef, h, hidx),
             lambda t, local: rows_mod.scatter_add_rank1_reference(
                 t, local, coef.cpu(), h.cpu(), hidx.cpu())),
        ):
            before = table[uniq].cpu()
            kernel(table, ids, *args)
            touched_rows_check(torch, table, before, ids, plain,
                               f"{name} at a {rows} x {width} shard")
        del table
    syn0 = (torch.rand((V_TRAIN, D), generator=gen, device=DEV) - 0.5) * 0.3
    syn1 = (torch.rand((V_TRAIN, D), generator=gen, device=DEV) - 0.5) * 0.3
    from glint_word2vec_torch.corpus.batching import packed_pair_batch

    Pl = packed_pair_batch(B_TRAIN, W_TRAIN, 2) // 2
    c = zipf_ids(torch, gen, (Pl,), V_TRAIN)
    x = zipf_ids(torch, gen, (Pl,), V_TRAIN)
    m = (torch.rand((Pl,), generator=gen, device=DEV) < 0.9).float()
    negs = zipf_ids(torch, gen, (Pl, N_NEG), V_TRAIN)
    nm = (negs != x[:, None]).float() * m[:, None]
    alpha = torch.full((), 0.025, device=DEV)
    fw = fs.pair_forward(syn0, syn1, c, x, m, negs, nm, alpha)
    ref = fs.pair_forward_reference(syn0, syn1, c, x, m, negs, nm, alpha)
    for f in ("c_pos", "c_neg", "h", "d_center"):
        worst = max(worst, close_err(torch, getattr(fw, f), getattr(ref, f),
                                     f"B4 {f} at P/2 = {Pl}", 1e-5, 1e-6))
    pool = zipf_ids(torch, gen, (S_POOL,), V_TRAIN)
    fw = fs.pair_forward_shared(syn0, syn1, c, x, m, pool, alpha, N_NEG)
    ref = fs.pair_forward_shared_reference(syn0, syn1, c, x, m, pool, alpha, N_NEG)
    for f in ("c_pos", "d_center", "d_pool"):
        w = getattr(ref, f)
        worst = max(worst, close_err(torch, getattr(fw, f), w,
                                     f"B5 {f} at P/2 = {Pl}", 1e-4,
                                     1e-6 * float(w.abs().max())))
    h = ref.h.contiguous()
    coef = torch.rand((Pl,), generator=gen, device=DEV) - 0.5
    rows = torch.arange(Pl, dtype=torch.int32, device=DEV)
    for name, kernel, ids, args in (
        ("B7", fs.scatter_add_rank1_hbm, x, (coef, h, rows)),
        ("B6", fs.scatter_add_rows_f32, c, (ref.d_center.contiguous(),)),
    ):
        plain = (fs.scatter_add_rank1_hbm_reference if name == "B7"
                 else fs.scatter_add_rows_f32_reference)
        before = syn1[torch.unique(ids.long())].cpu()
        kernel(syn1, ids, *args)
        touched_rows_check(
            torch, syn1, before, ids,
            lambda t, local: plain(t, local, *(a.cpu() for a in args)),
            f"{name} at P/2 = {Pl}")
    return worst


#: The kernel wrappers the mesh paths call, by the module whose global
#: name the call goes through: the engine's row kernels, and the fused
#: kernels that ``_mesh_pair_step`` reaches as ``fs.<name>``.
MESH_KERNEL_SITES = (
    ("glint_word2vec_torch.parallel.engine",
     ("gather_rows", "scatter_add_rank1", "scatter_add_rows")),
    ("glint_word2vec_torch.ops.fused_sgns",
     ("pair_forward", "pair_forward_shared", "scatter_add_rank1_hbm",
      "scatter_add_rows_f32")),
)


@contextlib.contextmanager
def shimmed_kernels(shim_for):
    """While the block runs, every wrapper of :data:`MESH_KERNEL_SITES` is
    replaced by ``shim_for(name, wrapper)``. A wrapper that counts through
    its own global name (the fused ones) counts on its shim meanwhile: each
    shim gets ``launches`` and ``tiled_launches`` of 0, and after the block
    those counts are folded back into the wrapper's, so the wrappers and
    their counts are whole again."""
    import importlib

    patched = []
    try:
        for module, names in MESH_KERNEL_SITES:
            mod = importlib.import_module(module)
            for name in names:
                orig = getattr(mod, name)
                shim = shim_for(name, orig)
                shim.launches = shim.tiled_launches = 0
                setattr(mod, name, shim)
                patched.append((mod, name, orig, shim))
        yield
    finally:
        for mod, name, orig, shim in patched:
            setattr(mod, name, orig)
            orig.launches += shim.launches
            if hasattr(orig, "tiled_launches"):
                orig.tiled_launches += shim.tiled_launches


@contextlib.contextmanager
def launches_by_table():
    """Each kernel's launches by the table tensor it ran on, while the
    block runs: every wrapper of :data:`MESH_KERNEL_SITES` is shimmed
    (:func:`shimmed_kernels`) to read the wrapper's launch count around
    each call and credit the difference to the call's first argument (the
    table, or a model shard of it) by its storage address. Yields
    ``{kernel: {address: launches}}``."""
    tally = {}

    def shim_for(name, orig):
        def shim(table, *args, **kw):
            before = orig.launches + shim.launches
            try:
                return orig(table, *args, **kw)
            finally:
                n = orig.launches + shim.launches - before
                if n:
                    by = tally.setdefault(name, {})
                    by[table.data_ptr()] = by.get(table.data_ptr(), 0) + n

        return shim

    with shimmed_kernels(shim_for):
        yield tally


def shard_launches(tally: dict, eng, names, launches: dict, what: str) -> dict:
    """``{kernel: [launches on model shard 0, 1, ...]}`` from a
    :func:`launches_by_table` tally, the shards being ``eng``'s (syn0's
    and syn1's shard ``m`` both count for ``m``). Fails unless every
    launch the counters saw is on a shard of ``eng`` and every shard
    launched each kernel of ``names``."""
    shard_of = {t.data_ptr(): m for i in (0, 1)
                for m, t in enumerate(eng.shard_tables(i))}
    per = {}
    for name, by in tally.items():
        row = [0] * eng.num_model
        for ptr, n in by.items():
            expect(ptr in shard_of, f"{what}: {name} launched on a tensor that "
                   f"is no shard of the engine's tables ({by})")
            row[shard_of[ptr]] += n
        expect(sum(row) == launches[name],
               f"{what}: {name} launched {launches[name]} times, {sum(row)} "
               "on the shards")
        per[name] = row
    for name in names:
        expect(name in per and all(n > 0 for n in per[name]),
               f"{what}: a shard never launched {name}: {per}")
    return per


def mesh_engines(torch, np, fs, rows_mod) -> dict:
    """Phase 18 (a): one group of steps on each mesh, every shard on the
    card, from the tables of a 1 x 1 engine and the same draws, held
    against the 1 x 1 engine's steps within the CPU tests' tolerance:
    (1, 2) ``rows`` and (2, 2) ``dims`` grid steps (B1, B2, B3, shard by
    shard), and (2, 1) ``rows`` packed steps (the fused B4, B7, B6, then B5
    with a pool of S_POOL). Each mesh's launches, and each kernel's
    launches on each model shard (:func:`launches_by_table`): every shard
    must have launched every kernel of its path."""
    from glint_word2vec_torch.corpus.batching import context_width, packed_pair_batch
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine, TrainingDraws
    from glint_word2vec_torch.parallel.mesh import make_mesh

    gen = torch.Generator(device=DEV).manual_seed(18)
    counts = np.maximum(1, (1e7 / np.arange(1, V_TRAIN + 1))).astype(np.int64)
    s0 = (torch.rand((V_TRAIN, D), generator=gen, device=DEV) - 0.5) / D
    s1 = (torch.rand((V_TRAIN, D), generator=gen, device=DEV) - 0.5) / D

    def engine(mesh=None, layout="rows", S=0):
        e = EmbeddingEngine(V_TRAIN, D, counts, num_negatives=N_NEG, seed=18,
                            shared_negatives=S, layout=layout,
                            device=None if mesh else DEV,
                            mesh=make_mesh(*mesh, devices=[DEV] * (mesh[0] * mesh[1]))
                            if mesh else None)
        e.set_tables(s0, s1)
        return e

    out, errs = {"launches": {}, "by_shard": {}}, []
    C = context_width(W_TRAIN)
    K, B = MESH_STEPS, B_TRAIN
    centers = zipf_ids(torch, gen, (K, B), V_TRAIN)
    contexts = zipf_ids(torch, gen, (K, B, C), V_TRAIN)
    mask = (torch.rand((K, B, C), generator=gen, device=DEV) < 0.8).float()
    alphas = np.array([0.025, 0.024], np.float32)
    ref = engine()
    draws = TrainingDraws(7, *ref.noise_tables(), W_TRAIN, B, N_NEG)
    negs = torch.stack([draws.window_negatives(i, B, C) for i in range(K)])
    want_l = ref.train_steps(centers, contexts, mask, 7, alphas, 0, negs=negs)
    want = (ref.syn0, ref.syn1)
    for shape, layout in (((1, 2), "rows"), ((2, 2), "dims")):
        e = engine(shape, layout)
        torch.cuda.synchronize()
        zero_counters(fs, rows_mod)
        with launches_by_table() as tally:
            got_l = e.train_steps(centers, contexts, mask, 7, alphas, 0, negs=negs)
            torch.cuda.synchronize()
        launches = read_counters(fs, rows_mod)
        names = ("gather_rows", "scatter_add_rank1", "scatter_add_rows")
        expect_launched(launches, names, f"mesh {shape} {layout}")
        per = shard_launches(tally, e, names, launches, f"mesh {shape} {layout}")
        errs.append(close_err(torch, got_l, want_l, f"{shape} {layout} losses"))
        for i, name in enumerate(("syn0", "syn1")):
            errs.append(close_err(torch, e.logical_table(i)[:V_TRAIN, :D],
                                  want[i], f"{shape} {layout} {name}"))
        key = f"{shape} {layout}"
        out["launches"][key], out["by_shard"][key] = launches, per
        log(f"mesh (a) {shape} {layout}, {K} grid steps of {B} x {C} at "
            f"{V_TRAIN} x {D} fp32 on {e.num_model} shard(s) of "
            f"{e.rows_per_shard} x {e.cols_per_shard}: held against 1 x 1 "
            f"(max abs err {max(errs[-3:]):.3g}); launches by shard {per}")
        del e
    ids = zipf_ids(torch, gen, (MESH_CORPUS_TOKENS,), V_TRAIN).cpu().numpy()
    offsets = np.arange(0, MESH_CORPUS_TOKENS + 1, SENTENCE_LEN, dtype=np.int64)
    P = packed_pair_batch(B_TRAIN, W_TRAIN, 2)
    for S in (0, S_POOL):
        r1 = engine(S=S)
        r1.upload_corpus(ids, offsets)
        w = r1.train_steps_corpus_packed(0, P, W_TRAIN, B, 9, 4, step_size=0.025,
                                         total_words=10 ** 7)
        e = engine((2, 1), S=S)
        e.upload_corpus(ids, offsets)
        torch.cuda.synchronize()
        zero_counters(fs, rows_mod)
        with launches_by_table() as tally:
            g = e.train_steps_corpus_packed(0, P, W_TRAIN, B, 9, 4,
                                            step_size=0.025, total_words=10 ** 7)
            torch.cuda.synchronize()
        launches = read_counters(fs, rows_mod)
        names = (("pair_forward_shared",) if S else ("pair_forward",)) + (
            "scatter_add_rank1_hbm", "scatter_add_rows_f32")
        expect_launched(launches, names, f"mesh (2, 1) S={S}")
        per = shard_launches(tally, e, names, launches, f"mesh (2, 1) S={S}")
        expect(all(np.array_equal(a, b) for a, b in zip(g[1:3], w[1:3])),
               "packed (2, 1): pairs or positions differ from 1 x 1")
        errs.append(close_err(torch, torch.from_numpy(g[0]),
                              torch.from_numpy(w[0]), f"(2, 1) S={S} losses"))
        for name, gt, wt in zip(("syn0", "syn1"), (e.syn0, e.syn1),
                                (r1.syn0, r1.syn1)):
            errs.append(close_err(torch, gt, wt, f"(2, 1) S={S} {name}"))
        key = f"(2, 1) rows S={S}"
        out["launches"][key], out["by_shard"][key] = launches, per
        log(f"mesh (a) (2, 1) rows packed, 4 steps of P = {P} ({P // 2} a data "
            f"rank), S = {S}: held against 1 x 1 (max abs err "
            f"{max(errs[-3:]):.3g}); launches on its one model shard {per}")
        del e, r1
    out["kernels_err"] = mesh_kernels_at_shard_shapes(torch, np, fs, rows_mod, gen)
    out["max_abs_err"] = max(errs)
    log(f"mesh (a) kernels at the shards' shapes against their plain versions: "
        f"B1, B2, B3 bitwise at {V_TRAIN // 2} x {D} and widths {D // 2}, 38, 2; B6, B7 "
        f"bitwise and B4, B5 within tolerance at P/2 (max abs err "
        f"{out['kernels_err']:.3g})")
    return out


def mesh_fit(torch, np, fs, rows_mod, tmp: str) -> dict:
    """Phase 18 (b): ``Word2Vec(num_partitions=2, num_shards=2,
    layout="dims").fit_file`` on a MESH_FIT_TOKENS prefix, its ``sharded``
    save (column blocks), reloaded onto 1 x 1 and onto (1, 2) ``rows``
    with equal tables, and synonym queries through the mesh that agree
    with the 1 x 1 load's."""
    from glint_word2vec_torch.models.word2vec import Word2Vec, Word2VecModel
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine
    from glint_word2vec_torch.parallel.mesh import make_mesh

    path = os.path.join(tmp, "mesh.txt")
    n_tok = write_synthetic_corpus(np, path, tokens=MESH_FIT_TOKENS)
    torch.cuda.synchronize()
    zero_counters(fs, rows_mod)
    t0 = time.perf_counter()
    with launches_by_table() as tally:
        m = Word2Vec(device=DEV, vector_size=D, window=W_TRAIN,
                     batch_size=B_TRAIN, num_negatives=N_NEG, min_count=1,
                     num_iterations=1, seed=1, num_partitions=2, num_shards=2,
                     layout="dims").fit_file(path)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(fs, rows_mod)
    names = ("gather_rows", "scatter_add_rank1", "scatter_add_rows")
    expect_launched(launches, names, "the (2, 2) dims fit")
    eng = m.engine
    per = shard_launches(tally, eng, names, launches, "the (2, 2) dims fit")
    expect(eng.mesh.shape == {"data": 2, "model": 2} and eng.layout == "dims",
           f"fit mesh {eng.mesh.shape} {eng.layout}")
    V = m.vocab.size
    model_dir = os.path.join(tmp, "mesh_model")
    m.save(model_dir)
    blocks = sorted(f for f in os.listdir(os.path.join(model_dir, "matrix"))
                    if f.endswith(".npy") and f != "counts.npy")
    expect(blocks == [f"{t}.c{c:012d}.npy" for t in ("syn0", "syn1")
                      for c in (0, D // 2)], f"sharded save blocks {blocks}")
    want0, want1 = (eng.logical_table(i)[:V, :D] for i in (0, 1))
    one = EmbeddingEngine.load(os.path.join(model_dir, "matrix"), device=DEV,
                               layout="rows")
    rows12 = EmbeddingEngine.load(os.path.join(model_dir, "matrix"),
                                  mesh=make_mesh(1, 2, devices=[DEV] * 2),
                                  layout="rows")
    for e, what in ((one, "1 x 1"), (rows12, "(1, 2) rows")):
        expect(torch.equal(e.logical_table(0)[:V], want0)
               and torch.equal(e.logical_table(1)[:V], want1),
               f"the {what} load's tables differ from the fit's")
    expect(not one._meshed, "the 1 x 1 load runs the mesh code")
    loaded = Word2VecModel.load(model_dir, device=DEV)
    expect((loaded.engine.num_data, loaded.engine.num_model) == (1, 1),
           "one card did not load onto 1 x 1")
    single = Word2VecModel(m.vocab, one, m.params)
    words = [f"w{i}" for i in range(0, 2000, 50)]
    agree, err = 0, 0.0
    for w in words:
        a, b = m.find_synonyms(w, 10), single.find_synonyms(w, 10)
        agree += [x for x, _ in a] == [x for x, _ in b]
        err = max(err, max(abs(x - y) for (_, x), (_, y) in zip(a, b)))
    expect(agree >= len(words) - 1 and err <= 1e-5,
           f"mesh synonyms agree with 1 x 1 on {agree}/{len(words)} words "
           f"(max sim diff {err:.3g})")
    q = eng.pull(np.arange(64, dtype=np.int32)).cpu().numpy()
    a = eng.top_k_cosine_batch(q, 10)
    b = rows12.top_k_cosine_batch(q, 10)
    c = one.top_k_cosine_batch(q, 10)
    same = sum(np.array_equal(x, y) for x, y in zip(a[1], c[1]))
    same_rows = sum(np.array_equal(x, y) for x, y in zip(b[1], c[1]))
    expect(same >= 63 and same_rows >= 63,
           f"batched top-k: (2, 2) dims {same}/64, (1, 2) rows {same_rows}/64 "
           "rows equal to 1 x 1")
    wps = m.training_metrics["words_per_sec"]
    log(f"mesh (b) (2, 2) dims fit_file, {V} x {D} fp32, {n_tok} tokens, all "
        f"four shards on {torch.cuda.get_device_name(0)}, beside (c)'s gang: "
        f"{wall:.1f} s, {wps} words/s (a correctness figure, not a speed-up); "
        f"loss {m.training_metrics['final_loss']:.4f}; launches {launches}, "
        f"by model shard {per}; save "
        f"{blocks}; reloaded onto 1 x 1 and (1, 2) rows bitwise; synonyms of "
        f"{len(words)} words agree on {agree} (max sim diff {err:.3g}); "
        f"batched top-k rows equal: dims {same}/64, rows {same_rows}/64")
    for x in (m, loaded):
        x.stop()
    one.destroy()
    rows12.destroy()
    return {"launches": launches, "by_shard": per, "wps": wps}


def mesh_gang_start(np, tmp: str) -> dict:
    """Phase 18 (c), started: ``cli supervise --workers 2 train --exchange
    none --num-partitions 2 --num-shards 2`` on a MESH_GANG_TOKENS prefix,
    in a session of its own (its output in a log file): one mesh across
    two processes on the card (each rank a data row and both model
    shards, the data axis through gloo), two checkpointed epochs, rank 1
    killed early in the second. :func:`mesh_gang_finish` waits for it."""
    d = os.path.join(tmp, "mesh_gang")
    os.makedirs(d)
    path = os.path.join(d, "c.txt")
    n_tok = write_synthetic_corpus(np, path, tokens=MESH_GANG_TOKENS)
    sents = n_tok // SENTENCE_LEN
    steps = -(-(sents // 2) * SENTENCE_LEN // (B_TRAIN // 2))
    kill = -(-steps // 16) + 2
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")  # two ranks share the cores
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("GLINT_FAULTS", None)
    argv = ["supervise", "--workers", "2", "--report-out",
            os.path.join(d, "report.json"), "--backoff-base", "1",
            "--heartbeat-stale", "300",
            "--rank-env", f"1:GLINT_FAULTS=worker.step:kill@{kill}",
            "train", "--device", DEV, "--corpus", path, "--output",
            os.path.join(d, "model"), "--checkpoint-dir", os.path.join(d, "ck"),
            "--metrics-out", os.path.join(d, "metrics.json"),
            "--exchange", "none", "--num-partitions", "2", "--num-shards", "2",
            "--iterations", "2", "--vector-size", str(D),
            "--window", str(W_TRAIN), "--batch-size", str(B_TRAIN),
            "--negatives", str(N_NEG), "--min-count", "1", "--seed", "1"]
    out = open(os.path.join(d, "supervise.log"), "wb")
    proc = subprocess.Popen([sys.executable, "-m", "glint_word2vec_torch.cli",
                             *argv], env=env, cwd=here, stdout=out,
                            stderr=subprocess.STDOUT, start_new_session=True)
    return dict(dir=d, proc=proc, out=out, n_tok=n_tok, kill=kill,
                t0=time.perf_counter())


def mesh_gang_stop(gang: dict) -> None:
    """Ends (c)'s supervisor if it still runs, and any rank it left (the
    ranks run in sessions of their own; their command lines name the
    gang's directory)."""
    proc = gang["proc"]
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, 9)
        except OSError:
            pass
        proc.wait(timeout=60)
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read()
        except OSError:
            continue
        if gang["dir"].encode() in argv:
            try:
                os.kill(int(pid), 9)
            except OSError:
                pass
    gang["out"].close()


def mesh_gang_finish(torch, gang: dict) -> dict:
    """Phase 18 (c), ended: the supervisor exits 0 within GANG_TIMEOUT of
    its start, after one restart resumed from ``ckpt-1``; the ranks' tables
    are equal, each rank launched each kernel of the grid path (its
    metrics file), and the model loads with finite tables."""
    from glint_word2vec_torch.models import load_model

    d, proc = gang["dir"], gang["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, GANG_TIMEOUT - (time.perf_counter()
                                                        - gang["t0"])))
    except subprocess.TimeoutExpired:
        rc = None
    wall = time.perf_counter() - gang["t0"]
    if rc != 0:
        gang["out"].flush()
        with open(os.path.join(d, "supervise.log"), "rb") as f:
            tail = f.read()[-3000:].decode(errors="replace")
        raise AssertionError(f"mesh gang supervisor exited {rc} after "
                             f"{wall:.1f} s:\n{tail}")
    report = json.load(open(os.path.join(d, "report.json")))
    expect(report["completed"] and report["restarts"] == 1, f"report {report}")
    rec = report["restart_records"][0]
    expect(rec["resumed_from"] == "ckpt-1", f"restart {rec}")
    ranks = [json.load(open(os.path.join(d, f"metrics-rank{r}.json"))) for r in (0, 1)]
    expect(ranks[0]["tables_sha256"] == ranks[1]["tables_sha256"],
           "the mesh gang's ranks end with different tables")
    launches = {}
    for r, m in enumerate(ranks):
        for k, v in m["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
        expect_launched(m["kernel_launches"], (
            "gather_rows", "scatter_add_rank1", "scatter_add_rows"),
            f"mesh gang rank {r}")
    model = load_model(os.path.join(d, "model"), device=DEV)
    for t in (model.engine.syn0, model.engine.syn1):
        expect(bool(torch.isfinite(t).all()), "non-finite mesh gang tables")
    vsize = model.vocab.size
    model.stop()
    by_rank = [{k: v for k, v in m["kernel_launches"].items() if v} for m in ranks]
    log(f"mesh (c) gang of 2 processes, mesh (2, 2) rows ({vsize} x {D}), 2 "
        f"epochs over {gang['n_tok']} tokens, both on "
        f"{torch.cuda.get_device_name(0)}, beside (a) and (b): {wall:.1f} s "
        f"(supervisor); rank 1 killed at group {gang['kill']}: "
        f"{rec['reason']!r}, resumed from {rec['resumed_from']}; tables equal "
        f"({ranks[0]['tables_sha256'][:16]}); words/s rank 0 "
        f"{ranks[0]['words_per_sec']}, rank 1 {ranks[1]['words_per_sec']}; "
        f"launches by rank {by_rank}")
    return {"launches": launches}


def mesh_on_one_card(torch, np, fs, rows_mod) -> dict:
    """Phase 18: the SPMD mesh on one card, every shard on it. (c)'s gang
    runs in processes of its own while this one runs (a) and (b): its
    start-ups are mostly host time, and its ranks count their own
    launches."""
    tmp = tempfile.mkdtemp(prefix="glint_mesh_")
    gang = None
    try:
        gang = mesh_gang_start(np, tmp)
        out = {"engines": mesh_engines(torch, np, fs, rows_mod)}
        gc_free(torch)
        out["fit"] = mesh_fit(torch, np, fs, rows_mod, tmp)
        gc_free(torch)
        out["gang"] = mesh_gang_finish(torch, gang)
        return out
    finally:
        if gang is not None:
            mesh_gang_stop(gang)
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 19: the route knobs, the load and verify keywords, the legacy
# resume and the server's keywords at full width
# ----------------------------------------------------------------------

#: Phase 19's corpus: the first STALL_TOKENS tokens (phases 11 and 14 (b)'s
#: prefix, 569,250 x 300), at ``configs[1]``'s width.
KNOB_TOKENS = STALL_TOKENS
#: Packed groups of phase 19 (c), each of steps_per_call = 16 steps.
KNOB_GROUPS = 2


@contextlib.contextmanager
def hold_first_calls(torch, fs, rows_mod, what: str):
    """Within the block, the first call of each kernel wrapper of
    :data:`MESH_KERNEL_SITES` is held against its plain version on that
    call's own inputs, at the shapes the main path gives it: ``gather_rows``
    bitwise; ``pair_forward`` within rtol 1e-5 and atol 1e-6 x max and
    ``pair_forward_shared`` within rtol 1e-4 and atol 1e-6 x max (phases 5
    and 9), both against their plain versions on the card; each scatter
    bitwise against its plain version on a CPU copy of the rows it touches
    (:func:`touched_rows_check`). The held call is the path's own call,
    once, and the plain versions launch nothing, so the block's launches
    are the path's; read the counters after the block
    (:func:`shimmed_kernels`). Yields ``{kernel: max abs error}`` of the
    calls held."""
    held = {}
    fields = {"pair_forward": ("c_pos", "c_neg", "h", "d_center"),
              "pair_forward_shared": ("c_pos", "h", "d_center", "d_pool")}
    rtol = {"pair_forward": 1e-5, "pair_forward_shared": 1e-4}
    plain_scatter = {
        "scatter_add_rank1": rows_mod.scatter_add_rank1_reference,
        "scatter_add_rows": rows_mod.scatter_add_rows_reference,
        "scatter_add_rank1_hbm": fs.scatter_add_rank1_hbm_reference,
        "scatter_add_rows_f32": fs.scatter_add_rows_f32_reference,
    }

    def hold(name, orig, args):
        if name == "gather_rows":
            out = orig(*args)
            expect(torch.equal(out, rows_mod.gather_rows_reference(*args)),
                   f"gather_rows {what} differs from its plain version")
            held[name] = 0.0
            return out
        if name in fields:
            out = orig(*args)
            plain = getattr(fs, f"{name}_reference")(*args)
            err = 0.0
            for f in fields[name]:
                want = getattr(plain, f)
                err = max(err, close_err(
                    torch, getattr(out, f), want, f"{name} {f} {what}",
                    rtol[name], 1e-6 * float(want.abs().max())))
            held[name] = err
            return out
        table, ids, *rest = args
        before = table[torch.unique(ids.long())].cpu()
        out = orig(*args)
        torch.cuda.synchronize()
        touched_rows_check(
            torch, table, before, ids,
            lambda t, local: plain_scatter[name](t, local,
                                                 *(a.cpu() for a in rest)),
            f"{name} {what}")
        held[name] = 0.0
        return out

    def shim_for(name, orig):
        def shim(*args, **kw):
            if name in held or kw:
                return orig(*args, **kw)
            return hold(name, orig, args)

        return shim

    with shimmed_kernels(shim_for):
        yield held


def words_per_sec_line(tm: dict) -> str:
    return (f"{tm['words_per_sec']} words/s ({tm['steps']} steps; "
            f"{nvidia_smi_line()})")


def knob_routes(torch, np, fs, rows_mod, path: str, n_tok: int, tmp: str) -> dict:
    """Phase 19 (a): the prefix fitted under ``GLINT_HOST_BATCHER=1`` (the
    host batcher and the composed step: B1, B2, B3) with a checkpoint, the
    tiny corpus under ``GLINT_DEVICE_CORPUS_MAX_BYTES=1`` (the host), and
    the prefix with neither knob (the resident packed path: B4, B6, B7);
    every kernel each fit launches held once against its plain version."""
    from glint_word2vec_torch import Word2Vec

    width = dict(vector_size=D, window=W_TRAIN, batch_size=B_TRAIN,
                 num_negatives=N_NEG, min_count=1, num_iterations=1,
                 step_size=0.025, seed=1, subsample_ratio=1e-3)
    out = {"held": {}}
    ck = os.path.join(tmp, "ck-host")
    os.environ["GLINT_HOST_BATCHER"] = "1"
    try:
        zero_counters(fs, rows_mod)
        with hold_first_calls(torch, fs, rows_mod, "on the host route") as held:
            host = Word2Vec(**width).fit_file(path, checkpoint_dir=ck)
            torch.cuda.synchronize()
        launches = read_counters(fs, rows_mod)
    finally:
        del os.environ["GLINT_HOST_BATCHER"]
    tm = host.training_metrics
    expect(tm["pipeline"] == "host" and tm["words_done"] == n_tok
           and math.isfinite(tm["final_loss"]), tm)
    expect_launched(launches, ("gather_rows", "scatter_add_rank1",
                               "scatter_add_rows"), "19 (a) host route")
    expect(set(held) == {"gather_rows", "scatter_add_rank1", "scatter_add_rows"},
           f"19 (a) host route held {sorted(held)}")
    out["held"].update(held)
    out["host"] = {"launches": launches, "wps": tm["words_per_sec"]}
    log(f"19 (a) GLINT_HOST_BATCHER=1: {host.vocab.size} x {D}, {n_tok} tokens, "
        f"pipeline {tm['pipeline']}, {words_per_sec_line(tm)}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; first calls held: "
        f"gather_rows, scatter_add_rank1, scatter_add_rows bitwise")

    os.environ["GLINT_DEVICE_CORPUS_MAX_BYTES"] = "1"
    try:
        tiny = tiny_w2v(Word2Vec).set_num_iterations(1).fit(make_tiny_corpus(np))
    finally:
        del os.environ["GLINT_DEVICE_CORPUS_MAX_BYTES"]
    expect(tiny.training_metrics["pipeline"] == "host", tiny.training_metrics)
    tiny.stop()
    log("19 (a) GLINT_DEVICE_CORPUS_MAX_BYTES=1: the tiny corpus took the host "
        "batcher")

    zero_counters(fs, rows_mod)
    with hold_first_calls(torch, fs, rows_mod, "on the resident route") as held:
        res = Word2Vec(**width).fit_file(path)
        torch.cuda.synchronize()
    launches = read_counters(fs, rows_mod)
    tm = res.training_metrics
    expect(tm["pipeline"] == "device_corpus" and tm["words_done"] == n_tok
           and math.isfinite(tm["final_loss"]), tm)
    three = ("pair_forward", "scatter_add_rank1_hbm", "scatter_add_rows_f32")
    expect_launched(launches, three, "19 (a) resident route")
    expect(set(three) <= set(held), f"19 (a) resident route held {sorted(held)}")
    out["held"].update({k: max(v, out["held"].get(k, 0.0)) for k, v in held.items()})
    out["resident"] = {"launches": launches, "wps": tm["words_per_sec"]}
    log(f"19 (a) no knob: pipeline {tm['pipeline']}, "
        f"{words_per_sec_line(tm)}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; first calls held: "
        f"pair_forward (max |diff| {held['pair_forward']:.3g}), "
        f"scatter_add_rank1_hbm and scatter_add_rows_f32 bitwise")
    res.stop()
    del res
    gc_free(torch)
    return dict(out, model=host, ck=ck)


def verify_loads(torch, np, model, ck: str, tmp: str) -> dict:
    """Phase 19 (b): three loads of the host route's checkpoint into its
    model's engine, each timed (host clock, synchronized): with the deep
    check, under ``GLINT_CKPT_NO_VERIFY=1`` (sizes only) and with
    ``verify=False``; then a copy with one byte flipped in a table file
    (only the deep check refuses it) and the same copy truncated (every
    check refuses it; ``verify=False`` checks nothing)."""
    from glint_word2vec_torch.utils import integrity

    rec, snap = integrity.resolve_train_state(ck)
    expect(snap is not None and rec["epochs_completed"] == 1, rec)
    eng = model.engine
    want = [eng.syn0.clone(), eng.syn1.clone()]
    secs = {}
    for mode in ("deep", "size only", "none"):
        if mode == "size only":
            os.environ["GLINT_CKPT_NO_VERIFY"] = "1"
        eng._ckpt_shard_verify_s = None
        try:
            t0 = time.perf_counter()
            eng.load_tables(snap, verify=mode != "none")
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t0
        finally:
            os.environ.pop("GLINT_CKPT_NO_VERIFY", None)
        verify_s = eng.checkpoint_stats()["checkpoint_shard_verify_seconds"]
        expect((verify_s is None) == (mode == "none"),
               f"{mode}: checkpoint_shard_verify_seconds {verify_s}")
        secs[f"{mode} verify"] = verify_s
        expect(torch.equal(eng.syn0, want[0]) and torch.equal(eng.syn1, want[1]),
               f"19 (b) load ({mode}) changed the tables")
    log(f"19 (b) loads of the {eng.vocab_size} x {eng.dim} checkpoint "
        f"({dir_bytes(snap) / 2**30:.2f} GiB, warm page cache): deep "
        f"{secs['deep']:.3f} s (verify {secs['deep verify']} s), size only "
        f"{secs['size only']:.3f} s (verify {secs['size only verify']} s), none "
        f"{secs['none']:.3f} s; {nvidia_smi_line()}")

    bad = os.path.join(tmp, "damaged")
    shutil.copytree(snap, bad)
    with open(os.path.join(bad, "engine.json")) as f:
        meta = json.load(f)
    table = os.path.join(bad, meta["shards"]["syn0"][0]["file"]
                         if meta.get("format") == "sharded" else "syn0.npy")
    size = os.path.getsize(table)

    def refused(**kw) -> bool:
        try:
            integrity.verify_snapshot_dir(bad, **kw)
        except integrity.CheckpointCorruptError:
            return True
        return False

    def refused_under_no_verify() -> bool:
        os.environ["GLINT_CKPT_NO_VERIFY"] = "1"
        try:
            return refused()
        finally:
            del os.environ["GLINT_CKPT_NO_VERIFY"]

    with open(table, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    flipped = (refused(), refused(deep=False), refused_under_no_verify())
    expect(flipped == (True, False, False), f"flipped byte: {flipped}")
    eng.load_tables(bad, verify=False)
    expect(not torch.equal(eng.syn0, want[0]), "the flipped byte did not load")
    with open(table, "r+b") as f:
        f.truncate(size - 4096)
    truncated = (refused(), refused(deep=False), refused_under_no_verify())
    expect(truncated == (True, True, True), f"truncated: {truncated}")
    eng.load_tables(snap, verify=False)
    shutil.rmtree(bad)
    log("19 (b) a byte flipped in syn0: refused by the deep check, passed by "
        "the size check and GLINT_CKPT_NO_VERIFY=1, loaded by verify=False; "
        "the file truncated: refused by all three checks")
    return dict(secs=secs, snap=snap)


def engine_overrides(torch, np, fs, rows_mod, path: str, snap: str) -> dict:
    """Phase 19 (c): ``EmbeddingEngine.load(snap, "cuda",
    shared_negatives=S_POOL)`` over the prefix's corpus, KNOB_GROUPS packed
    groups (B5, B6, B7, held once each), then the same groups from the same
    tables with ``span=`` the default span: bitwise the same tables, losses
    and positions."""
    from glint_word2vec_torch.corpus.batching import context_width, packed_pair_batch
    from glint_word2vec_torch.corpus.vocab import scan_and_encode_file
    from glint_word2vec_torch.ops.device_batching import packed_span
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine

    _, ids, offsets = scan_and_encode_file(path, min_count=1)
    eng = EmbeddingEngine.load(snap, DEV, shared_negatives=S_POOL)
    expect(eng.shared_negatives == S_POOL, "the override was not taken")
    eng.upload_corpus(ids, offsets)
    P = packed_pair_batch(B_TRAIN, W_TRAIN)

    def groups(span=None):
        pos, outs = 0, []
        for g in range(KNOB_GROUPS):
            out = eng.train_steps_corpus_packed(
                pos, P, W_TRAIN, B_TRAIN, 7, 16, 16 * g, 16 * g,
                total_words=int(ids.size) + 1, span=span)
            outs.append(out)
            pos = int(out[2][-1])
        torch.cuda.synchronize()
        return outs, eng.syn0.clone(), eng.syn1.clone()

    zero_counters(fs, rows_mod)
    with hold_first_calls(torch, fs, rows_mod, "on the shared-pool engine") as held:
        first, s0, s1 = groups()
    launches = read_counters(fs, rows_mod)
    expect_launched(launches, ("pair_forward_shared", "scatter_add_rank1_hbm",
                               "scatter_add_rows_f32"), "19 (c)")
    expect(launches["pair_forward"] == 0, launches)
    expect({"pair_forward_shared", "scatter_add_rank1_hbm",
            "scatter_add_rows_f32"} <= set(held), f"19 (c) held {sorted(held)}")
    span = packed_span(P, context_width(W_TRAIN))
    eng.load_tables(snap, verify=False)
    again, t0, t1 = groups(span=span)
    same = (torch.equal(s0, t0) and torch.equal(s1, t1)
            and all(np.array_equal(a, b) for x, y in zip(first, again)
                    for a, b in zip(x, y)))
    expect(same, f"19 (c) span={span} differs from the default span")
    log(f"19 (c) EmbeddingEngine.load(..., shared_negatives={S_POOL}): "
        f"{KNOB_GROUPS} groups of 16 steps, P={P}, launches "
        f"{ {k: v for k, v in launches.items() if v} }; first calls held: "
        f"pair_forward_shared (max |diff| {held['pair_forward_shared']:.3g}), "
        f"the scatters bitwise; span={span} bitwise the default span")
    eng.release_tables()
    del eng, s0, s1, t0, t1
    gc_free(torch)
    return {"launches": launches, "held": held}


def legacy_resume(torch, np, fs, rows_mod, tmp: str) -> dict:
    """Phase 19 (d): one epoch of the tiny corpus on the resident route
    with a checkpoint, its tables rewritten as the legacy layout
    (``ckpt/syn0.npy``, ``ckpt/syn1.npy``, a ``train_state.json`` with no
    ``"ckpt"``); the second epoch resumed from each layout, bitwise
    equal."""
    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine
    from glint_word2vec_torch.utils import atomic_write_json, atomic_write_npy, integrity

    corpus = make_tiny_corpus(np)
    modern, legacy = os.path.join(tmp, "ck-modern"), os.path.join(tmp, "ck-legacy")
    tiny_w2v(Word2Vec).set_num_iterations(2).fit(
        corpus, checkpoint_dir=modern, stop_after_epochs=1).stop()
    rec, snap = integrity.resolve_train_state(modern)
    one = EmbeddingEngine.load(snap, DEV)
    os.makedirs(os.path.join(legacy, "ckpt"))
    for name in ("syn0", "syn1"):
        atomic_write_npy(os.path.join(legacy, "ckpt", f"{name}.npy"),
                         getattr(one, name).float().cpu().numpy())
    atomic_write_json(os.path.join(legacy, "train_state.json"),
                      {k: v for k, v in rec.items() if k != "ckpt"})
    one.release_tables()
    expect(integrity.resolve_train_state(legacy)[1] is None, "not a legacy record")
    zero_counters(fs, rows_mod)
    a = tiny_w2v(Word2Vec).set_num_iterations(2).fit(corpus, checkpoint_dir=modern)
    b = tiny_w2v(Word2Vec).set_num_iterations(2).fit(corpus, checkpoint_dir=legacy)
    launches = read_counters(fs, rows_mod)
    expect_launched(launches, ("pair_forward", "scatter_add_rank1_hbm",
                               "scatter_add_rows_f32"), "19 (d)")
    expect(b.training_metrics["pipeline"] == "device_corpus", b.training_metrics)
    expect(torch.equal(a.engine.syn0, b.engine.syn0)
           and torch.equal(a.engine.syn1, b.engine.syn1),
           "19 (d) the legacy resume differs from the modern resume")
    log(f"19 (d) tiny corpus, epoch 2 resumed from ckpt/syn0.npy and "
        f"ckpt/syn1.npy bitwise the resume from {rec['ckpt']}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    a.stop()
    b.stop()
    return {"launches": launches}


def server_keywords(torch, np, fs, rows_mod, model, tmp: str) -> dict:
    """Phase 19 (e): ``ModelServer(model, warm_ks=(16, 32, 64))`` answers a
    ``/synonyms`` of ``num=50`` with no shape past its warmup and launches
    B1 for it; ``serve_model_dir(..., ann=True, ann_nprobe=8)`` starts
    through the named keywords and builds the index (its recall gate
    decides whether the index or the exact path answers)."""
    from glint_word2vec_torch.serving import ModelServer, serve_model_dir

    server = ModelServer(model, port=0, max_batch=8, warm_ks=(16, 32, 64))
    server.start_background()
    try:
        zero_counters(fs, rows_mod)
        hits = post(server.port, "/synonyms", {"word": "w3", "num": 50})
        launches = read_counters(fs, rows_mod)
        health = get_json(server.port, "/healthz")
    finally:
        server.stop()
    expect(len(hits) == 50, f"19 (e) {len(hits)} synonyms")
    expect(health["post_warmup_compiles"] == 0, health)
    expect_launched(launches, ("gather_rows",), "19 (e) /synonyms")
    mdir, port_file = os.path.join(tmp, "model"), os.path.join(tmp, "port.json")
    model.save(mdir)
    box = {}

    def serve():
        try:
            serve_model_dir(mdir, port=0, port_file=port_file, device=DEV,
                            max_batch=8, ann=True, ann_nprobe=8)
        except BaseException as e:  # reported by the phase below
            box["error"] = e

    t = threading.Thread(target=serve, name="serve_model_dir", daemon=True)
    t.start()
    deadline = time.monotonic() + 300
    while not os.path.exists(port_file):
        expect(t.is_alive() and time.monotonic() < deadline,
               f"19 (e) serve_model_dir did not start: {box.get('error')!r}")
        time.sleep(0.1)
    with open(port_file) as f:
        port = json.load(f)["port"]
    try:
        index = get_json(port, "/healthz")["index"]
        ann = post(port, "/synonyms", {"word": "w3", "num": 10})
    finally:
        post(port, "/shutdown", {})
        t.join(timeout=120)
    expect(not t.is_alive() and "error" not in box, f"19 (e) {box}")
    expect(index["enabled"] and index["nprobe"] == 8, index)
    expect(len(ann) == 10, ann)
    log(f"19 (e) ModelServer(warm_ks=(16, 32, 64)): /synonyms num=50 with no new "
        f"shape, gather_rows launched {launches['gather_rows']} times; "
        f"serve_model_dir(ann=True, ann_nprobe=8): index of {index['clusters']} "
        f"clusters, nprobe {index['nprobe']}, recall@10 {index['recall_at10']}")
    return {"launches": launches}


def route_knobs_and_surface(torch, np, fs, rows_mod) -> dict:
    """Phase 19: (a) to (e) at ``configs[1]``'s width on the corpus's first
    KNOB_TOKENS tokens; (f) is phase 14 (b)'s."""
    tmp = tempfile.mkdtemp(prefix="glint_chip_knobs_")
    model = None
    try:
        path = os.path.join(tmp, "prefix.txt")
        n_tok = write_synthetic_corpus(np, path, tokens=KNOB_TOKENS)
        out = knob_routes(torch, np, fs, rows_mod, path, n_tok, tmp)
        model = out.pop("model")
        out["verify"] = verify_loads(torch, np, model, out["ck"], tmp)
        out["overrides"] = engine_overrides(torch, np, fs, rows_mod, path,
                                            out["verify"]["snap"])
        out["legacy"] = legacy_resume(torch, np, fs, rows_mod, tmp)
        out["serving"] = server_keywords(torch, np, fs, rows_mod, model, tmp)
        launches = {}
        for part in (out["host"], out["resident"], out["overrides"],
                     out["legacy"], out["serving"]):
            for k, v in part["launches"].items():
                launches[k] = launches.get(k, 0) + v
        out["launches"] = launches
        out["held"].update({k: max(v, out["held"].get(k, 0.0))
                            for k, v in out["overrides"]["held"].items()})
        expect_launched(launches, [c.__name__ for c in kernel_counters(fs, rows_mod)],
                        "phase 19")
        expect(set(out["held"]) == {c.__name__ for c in kernel_counters(fs, rows_mod)},
               f"phase 19 held {sorted(out['held'])}")
        return out
    finally:
        if model is not None:
            model.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        gc_free(torch)


def ptxas_report(text: str) -> list:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name
    (demangled where ``c++filt`` is found), registers and spills."""
    demangle = shutil.which("c++filt")
    out, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            if demangle:
                fn = subprocess.run([demangle, fn], capture_output=True,
                                    text=True, timeout=60).stdout.strip() or fn
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{fn}: {regs}; {spill}")
            fn = None
    return out


def parse_args(argv) -> tuple:
    """``(only, lane_out)``: the phases ``--only`` names (3 to 19; 16 and
    17 bring 15, whose models they serve), or None to run them all; and
    the file a lane-B child writes its results to, or None."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--only", metavar="N[,N...]",
        help="run phases 1, 2 and these (3 to 19; 16 and 17 run 15 first) "
             "only, one after another, "
             "print their lines, "
             f"and exit {PARTIAL_EXIT} without the kernels or result line")
    # The child of a whole run: phases 1, 2 and LANE_B, results to FILE.
    ap.add_argument("--lane-out", metavar="FILE", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.only is None:
        return None, args.lane_out
    phases = {int(p) for p in args.only.split(",") if p.strip()}
    if not phases or not phases <= set(range(3, 20)):
        ap.error(f"--only takes phases 3 to 19, got {args.only!r}")
    if phases & {16, 17}:
        phases.add(15)
    return phases, args.lane_out


def plain_data(x):
    """``x`` with what pickles across processes: dicts, lists, tuples,
    strings and numbers (numpy's as Python's); anything else as None."""
    if isinstance(x, dict):
        return {k: plain_data(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain_data(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if hasattr(x, "item") and getattr(x, "ndim", None) == 0:
        return x.item()
    return None


def exit_on_sigterm() -> None:
    """SIGTERM raises SystemExit, so every ``finally`` (servers, fleets,
    gangs, the lane) runs before the process ends."""
    def handler(signum, frame):
        raise SystemExit(128 + signum)
    signal.signal(signal.SIGTERM, handler)


def watch_parent(parent: int) -> None:
    """A lane-B child ends itself (SIGTERM) if the process that started it
    is gone."""
    def loop():
        while os.getppid() == parent:
            time.sleep(1.0)
        os.kill(os.getpid(), signal.SIGTERM)
    threading.Thread(target=loop, name="lane_watch", daemon=True).start()


def start_lane() -> dict:
    """Starts lane B: this script with ``--lane-out``, in a session of its
    own, its output in a log file."""
    tmp = tempfile.mkdtemp(prefix="glint_chip_lane_")
    here = os.path.dirname(os.path.abspath(__file__))
    log_path = os.path.join(tmp, "lane.log")
    out = open(log_path, "wb")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--lane-out",
         os.path.join(tmp, "lane.pkl")],
        cwd=here, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    return dict(tmp=tmp, proc=proc, out=out, log=log_path, shown=False,
                t0=time.perf_counter())


def show_lane(lane: dict) -> None:
    """Prints lane B's lines (once)."""
    if lane["shown"]:
        return
    lane["shown"] = True
    lane["out"].close()
    log(f"lane B (phases {', '.join(map(str, LANE_B))} in a process of its "
        f"own beside lane A), its lines:")
    with open(lane["log"], errors="replace") as f:
        for line in f:
            print(line, end="", flush=True)


def finish_lane(lane: dict, deadline: float) -> dict:
    """Waits for lane B until ``deadline`` (perf_counter), prints its
    lines, and returns its phases' results; fails if it failed or did not
    end in time."""
    proc = lane["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        raise AssertionError(
            f"lane B still running {time.perf_counter() - lane['t0']:.1f} s "
            "after it started") from None
    show_lane(lane)
    expect(rc == 0, f"lane B exited {rc}")
    with open(os.path.join(lane["tmp"], "lane.pkl"), "rb") as f:
        results = pickle.load(f)
    log(f"lane B: {time.perf_counter() - lane['t0']:.1f} s, its waits "
        "included")
    return results


def stop_lane(lane: dict) -> None:
    """Ends lane B if it still runs (SIGTERM, so its phases stop what they
    started; then SIGKILL to its group), prints its lines if nothing has,
    and removes its files."""
    proc = lane["proc"]
    try:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        show_lane(lane)
    finally:
        shutil.rmtree(lane["tmp"], ignore_errors=True)


def main() -> int:
    t_start = time.perf_counter()
    only, lane_out = parse_args(sys.argv[1:])
    exit_on_sigterm()
    if lane_out is not None:
        watch_parent(os.getppid())
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    import numpy as np

    from glint_word2vec_torch.corpus.batching import packed_pair_batch
    from glint_word2vec_torch.kernels import build
    from glint_word2vec_torch.ops import fused_sgns as fs
    from glint_word2vec_torch.ops import rows as rows_mod

    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"nvidia-smi: {smi}")

    log(f"phase 1: {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    secs = build.build()
    log(f"built {build.sources()} with nvcc in {secs:.1f} s")
    for name, text in sorted(build.build_logs.items()):
        for line in ptxas_report(text):
            log(f"  {name}: {line}")
    log(f"phase 2: {time.perf_counter() - t0:.1f} s")

    phases = {
        3: lambda: check_gather(torch, rows_mod),
        4: lambda: serve_end_to_end(torch, np, rows_mod),
        5: lambda: check_training_kernels(torch, np, fs),
        6: lambda: train_end_to_end(torch, np, fs, rows_mod),
        7: lambda: check_composed_kernels(torch, np, rows_mod, fs),
        8: lambda: train_fasttext_end_to_end(torch, np, rows_mod),
        9: lambda: check_shared_kernel(torch, fs),
        10: lambda: train_grid_and_resume(torch, np, fs, rows_mod),
        11: lambda: train_stall_free(torch, np, fs, rows_mod),
        12: lambda: ann_and_transform(torch, np, fs, rows_mod),
        13: lambda: stream_and_hot_swap(torch, np, fs, rows_mod),
        14: lambda: exchange_gang(torch, np, fs, rows_mod),
        15: lambda: catalog_end_to_end(torch, np, fs, rows_mod),
        16: lambda: fleet_end_to_end(torch, np, rows_mod, catalog),
        17: lambda: demand_fleet_end_to_end(torch, np, catalog),
        18: lambda: mesh_on_one_card(torch, np, fs, rows_mod),
        19: lambda: route_knobs_and_surface(torch, np, fs, rows_mod),
        # Phase 9 (b) on: the shared-pool fit, its gates and resume.
        "9 (b)": lambda: train_shared_end_to_end(torch, np, fs, rows_mod),
    }
    catalog = {}

    switch = sys.getswitchinterval()

    def run(p):
        t0 = time.perf_counter()
        out = phases[p]()
        if p == 15:
            catalog.update(out)
        # A server tightens the process-wide switch interval while it
        # serves; a phase must not leave it tightened for the next.
        expect(sys.getswitchinterval() == switch,
               f"phase {p} left the switch interval at "
               f"{sys.getswitchinterval()} (was {switch})")
        log(f"phase {p}: {time.perf_counter() - t0:.1f} s")
        return out

    def serving_phases(ps) -> dict:
        """Runs ``ps`` in order; phase 15's catalog is cleaned up after
        16 and 17 have served it."""
        try:
            return {p: run(p) for p in ps}
        finally:
            if catalog:
                cleanup_catalog(torch, catalog)

    if only is not None:
        serving_phases([q for p in sorted(only)
                        for q in ((p, "9 (b)") if p == 9 else (p,))])
        log(f"partial run: phases 1, 2 and {sorted(only)} passed in "
            f"{time.perf_counter() - t_start:.1f} s; no kernels line and no "
            f"result line (exit {PARTIAL_EXIT})")
        return PARTIAL_EXIT

    if lane_out is not None:
        out = serving_phases(LANE_B)
        out[15] = {"launches": out[15]["launches"]}
        with open(lane_out, "wb") as f:
            pickle.dump(plain_data(out), f)
        return 0

    gathered, served, timed, composed, shared_timed = (
        run(p) for p in SERIAL_PHASES)
    lane = start_lane()
    try:
        shared = run("9 (b)")
        trained, ft, grid, stall, annt, mesh, knobs = (run(p) for p in LANE_A)
        log(f"lane A: {time.perf_counter() - lane['t0']:.1f} s")
        b = finish_lane(lane, t_start + LANE_DEADLINE)
        streamed, gang, cat, fleet, demand = (b[p] for p in LANE_B)
    finally:
        stop_lane(lane)

    main_case = gathered[("f32", V_SERVE, 10_000)]
    kernels = [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "glint_word2vec_torch/csrc/gather_rows.cu",
        "replaces": "glint_word2vec_tpu/ops/pallas_rows.py:75",
        "launches": served["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in gathered.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
        "checked": True,
        "shape": f"fp32 table {V_SERVE}x{D}, N=10000",
        "launches_training_queries": trained["gathers"],
        "launches_grid_fit": grid["grid"]["gather_rows"],
        "waves": main_case["waves"],
        "bf16_ms": gathered[("bf16", V_SERVE, 10_000)]["ms"],
        "bf16_index_select_ms": gathered[("bf16", V_SERVE, 10_000)]["library_ms"],
        "clean_flush_ms": main_case["clean_ms"],
        "clean_flush_index_select_ms": main_case["clean_library_ms"],
        "n1_ms": gathered[("f32", V_SERVE, 1)]["ms"],
        "n64_ms": gathered[("f32", V_SERVE, 64)]["ms"],
        "launches_ann_build": annt["build"]["gather_rows"],
        "launches_ann_recall": annt["recall_launches"],
        "launches_ann_refresh": annt["refresh_launches"],
        "launches_transform": annt["launches"],
        "ann_build_max_abs_err": annt["path_err"]["gather_rows"],
        "transform_max_abs_err": annt["transform_err"],
        "launches_stream_and_swaps": streamed["launches"]["gather_rows"],
        "launches_swap_index_builds": streamed["swap_launches"]["gather_rows"],
        "launches_overload_drills": served["drill"]["launches"],
        "launches_train_step": composed["train_step_launches"]["gather_rows"],
    }]
    train_shape = (f"fp32 tables {V_TRAIN}x{D}, P={packed_pair_batch(B_TRAIN, W_TRAIN)}, "
                   f"n={N_NEG}")
    for name, source, line in (
        ("pair_forward", "pair_forward.cu", 201),
        ("scatter_add_rank1_hbm", "scatter_runs.cu", 676),
        ("scatter_add_rows_f32", "scatter_runs.cu", 601),
    ):
        r = timed[(name, "f32")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"glint_word2vec_torch/csrc/{source}",
            "replaces": f"glint_word2vec_tpu/ops/pallas_sgns.py:{line}",
            "launches": trained["launches"][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes",
            "library_ms": r["library_ms"],
            "checked": True,
            "shape": train_shape,
            "runs": r["runs"],
            "bf16_ms": timed[(name, "bf16")]["ms"],
            "bf16_bound_ms": timed[(name, "bf16")]["bound_ms"],
            "launches_stall_free_fit": stall["launches"][name],
            "launches_stream_fit": streamed["launches"][name],
            "launches_gang": gang["launches"][name],
            "launches_compat_fit": trained["compat"][name],
        })
    b4, b7 = kernels[-3], kernels[-2]
    b4["stream_group_max_abs_err"] = streamed["group"]["err"]
    b4["tiled_launches"] = {f"d={d} n={n}": w["pair_forward (tiled form)"]
                            for (d, n), w in grid["wide"].items()}
    for (d, n, dt), r in timed["tiled"].items():
        b4.update({f"tiled_{d}x{n}_{dt}_{k}": r[k]
                   for k in ("ms", "plain_ms", "bound_ms", "one_pass_ms")
                   if r[k] is not None})
    for dt in ("f32", "bf16"):
        parts = timed[("pair_forward", dt)]["parts"]
        b4.update({f"{dt}_pairs_x4_ms": parts["b"]["ms"],
                   f"{dt}_one_row_ms": parts["c"]["ms"],
                   f"{dt}_tiled_form_ms": timed[("pair_forward", dt)]["tiled_ms"],
                   f"{dt}_loss_sum_ms": timed[("pair_forward", dt)]["loss_sum_ms"]})
        r7 = timed[("scatter_add_rank1_hbm", dt)]
        b7.update({f"{dt}_longest_run": r7["longest"],
                   f"{dt}_long_runs": r7["long_runs"]})
        b7.update({f"{dt}_{k}_ms": p["ms"] for k, p in r7["parts"].items()})
        parts = timed[("scatter_add_rows_f32", dt)]["parts"]
        kernels[-1].update({f"{dt}_{k}_ms": p["ms"] for k, p in parts.items()})
        kernels[-1].update({f"{dt}_{k}_index_add_ms": p["library_ms"]
                            for k, p in parts.items() if p["library_ms"] is not None})
    for name, line in (("scatter_add_rank1", 218), ("scatter_add_rows", 276)):
        r = composed[(name, "f32")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "glint_word2vec_torch/csrc/scatter_runs.cu",
            "replaces": f"glint_word2vec_tpu/ops/pallas_rows.py:{line}",
            "launches": ft["launches"][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes",
            "library_ms": r["library_ms"],
            "checked": True,
            "shape": (f"fp32 table {V_TRAIN + FT_BUCKET}x{D}, N={r['n']}"),
            "runs": r["runs"],
            "longest_run": r["longest"],
            "launches_grid_fit": grid["grid"][name],
            "launches_ann_build": annt["build"][name],
            "ann_build_max_abs_err": annt["path_err"].get(name),
            "launches_stream_and_swaps": streamed["launches"][name],
            "bf16_ms": composed[(name, "bf16")]["ms"],
            "bf16_bound_ms": composed[(name, "bf16")]["bound_ms"],
            "launches_train_step": composed["train_step_launches"][name],
        })
    b2, b2_bf16 = (composed[("scatter_add_rank1", dt)]["parts"] for dt in ("f32", "bf16"))
    kernels[-1]["launches_swap_index_builds"] = streamed["swap_launches"]["scatter_add_rows"]
    applied = gang["replicas"]["apply"]
    kernels[-1].update(
        launches_gang=gang["launches"]["scatter_add_rows"],
        exchange_apply_ms=applied["ms"], exchange_apply_bound_ms=applied["bound_ms"],
        exchange_apply_index_add_ms=applied["library_ms"],
        exchange_apply_n=applied["n"], exchange_apply_zero_run=applied["zero_run"])
    kernels[-2].update(
        no_long_run_ms=b2["a"]["ms"], long_run_alone_ms=b2["b"]["ms"],
        wide_ms=b2["c"]["ms"], index_add_payload_ms=b2["index_add_payload_ms"],
        bf16_no_long_run_ms=b2_bf16["a"]["ms"],
        bf16_long_run_alone_ms=b2_bf16["b"]["ms"], bf16_wide_ms=b2_bf16["c"]["ms"])
    b3, b3_bf16 = composed[("scatter_add_rows", "f32")], composed[("scatter_add_rows", "bf16")]
    kernels[-1].update(
        sort_ms=b3["sort_ms"],
        no_long_run_ms=b3["a_ms"], long_run_alone_ms=b3["b_ms"],
        shared_syn1_ms=b3["c_ms"],
        bf16_no_long_run_ms=b3_bf16["a_ms"], bf16_long_run_alone_ms=b3_bf16["b_ms"],
        bf16_shared_syn1_ms=b3_bf16["c_ms"])
    r = shared_timed["f32"]
    kernels.append({
        "name": "pair_forward_shared",
        "route": "cuda",
        "source": "glint_word2vec_torch/csrc/pair_forward_shared.cu",
        "replaces": "glint_word2vec_tpu/ops/pallas_sgns.py:423",
        "launches": shared["launches"]["pair_forward_shared"],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": "operations",
        "library_ms": r["library_ms"],
        "checked": True,
        "shape": f"{train_shape}, S={S_POOL}",
        "bf16_ms": shared_timed["bf16"]["ms"],
        "bf16_bound_ms": shared_timed["bf16"]["bound_ms"],
    })
    # Phases 15 to 17 serve only: each kernel's launches in the catalog
    # drill and in the fleets' replicas since their warmups.
    for k in kernels:
        k["launches_catalog"] = cat["launches"][k["name"]]
        k["launches_fleet"] = fleet["launches"].get(k["name"], 0)
        k["launches_demand"] = demand["launches"].get(k["name"], 0)
    expect(kernels[0]["launches_catalog"] > 0 and kernels[0]["launches_fleet"] > 0
           and kernels[0]["launches_demand"] > 0,
           "gather_rows not launched in phase 15, 16 or 17")
    # Phase 18: each kernel's launches on the meshes of (a), in the fit of
    # (b) and in the gang of (c).
    for k in kernels:
        k["launches_mesh_engines"] = {
            shape: n[k["name"]] for shape, n in mesh["engines"]["launches"].items()}
        k["launches_mesh_by_shard"] = {
            shape: per[k["name"]]
            for shape, per in mesh["engines"]["by_shard"].items()
            if k["name"] in per}
        k["launches_mesh_fit"] = mesh["fit"]["launches"][k["name"]]
        k["launches_mesh_fit_by_shard"] = mesh["fit"]["by_shard"].get(k["name"])
        k["launches_mesh_gang"] = mesh["gang"]["launches"].get(k["name"], 0)
        k["mesh_max_abs_err"] = max(mesh["engines"]["max_abs_err"],
                                    mesh["engines"]["kernels_err"])
        # Phase 19: its launches over (a) to (e), and the error of its
        # first call held against the plain version.
        k["launches_phase19"] = knobs["launches"][k["name"]]
        k["phase19_max_abs_err"] = knobs["held"][k["name"]]
    log(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
