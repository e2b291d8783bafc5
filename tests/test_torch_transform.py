"""The port's bulk transform (glint_word2vec_torch/batch/transform.py, the
CLI's ``transform-file`` and ``synonyms-dump``) against the JAX package's
(glint_word2vec_tpu/batch/transform.py), on models of both packages holding
the same random tables: V = 300 words, D = 16.

Tolerances: the transform's vectors within rtol 1e-6 / atol 1e-7 of the
JAX package's (sentence means of fp32 rows, summed in another order), and
bitwise equal to the port's own ``transform_sentences`` and across its own
runs (resume, corrupt shard, rank spans); the dump's words equal wherever
neighbouring scores differ by more than 1e-5 and its sims within 1e-5."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.batch import transform as jtr
from glint_word2vec_tpu.corpus.batching import pack_query_block as j_pack
from glint_word2vec_tpu.corpus.vocab import Vocabulary as JaxVocab
from glint_word2vec_tpu.models.word2vec import Word2VecModel as JaxModel
from glint_word2vec_tpu.obs.heartbeat import TrainingStatus as JaxStatus
from glint_word2vec_tpu.parallel.distributed import shard_span as j_span
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh
from glint_word2vec_tpu.utils.params import Word2VecParams as JaxParams

from glint_word2vec_torch import cli
from glint_word2vec_torch.batch.transform import (
    ShardWriter,
    count_lines,
    iter_sentence_lines,
    load_transform_output,
    synonyms_dump,
    transform_file,
)
from glint_word2vec_torch.convert import ann_index_from_arrays, model_from_arrays
from glint_word2vec_torch.corpus.batching import pack_query_block
from glint_word2vec_torch.corpus.subword import build_subword_table
from glint_word2vec_torch.corpus.vocab import Vocabulary
from glint_word2vec_torch.models.fasttext import FastTextModel, FastTextParams
from glint_word2vec_torch.obs import NULL_RUN, ObsConfig, start_run
from glint_word2vec_torch.obs.heartbeat import TrainingStatus
from glint_word2vec_torch.obs.prometheus import training_to_prometheus
from glint_word2vec_torch.parallel.distributed import shard_span
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.utils import faults
from glint_word2vec_torch.utils.integrity import (
    CheckpointCorruptError,
    build_shard_manifest,
    verify_shard,
    write_shard_manifest,
)
from glint_word2vec_torch.utils.params import Word2VecParams

V, D = 300, 16
WORDS = [f"w{i}" for i in range(V)]
COUNTS = np.arange(V, 0, -1, dtype=np.int64) + 4
KW = dict(rows=8, max_len=16, shard_size=16)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(5)
    # Clustered rows, so the ANN index has structure to find.
    centers = rng.standard_normal((12, D)).astype(np.float32)
    syn0 = (centers[rng.integers(0, 12, V)]
            + 0.3 * rng.standard_normal((V, D)).astype(np.float32))
    syn1 = rng.standard_normal((V, D)).astype(np.float32)
    return syn0, syn1


@pytest.fixture(scope="module")
def models(tables):
    syn0, syn1 = tables
    jeng = JaxEngine(make_mesh(1, 1), V, D, COUNTS, seed=1)
    jeng.set_tables(syn0, syn1)
    jm = JaxModel(JaxVocab.from_sorted(WORDS, COUNTS), jeng,
                  JaxParams(vector_size=D, min_count=1))
    pm = model_from_arrays(WORDS, syn0, syn1, COUNTS,
                           Word2VecParams(vector_size=D, min_count=1),
                           device="cpu")
    yield jm, pm
    jm.stop()
    pm.stop()


@pytest.fixture(scope="module")
def transform_input(tmp_path_factory):
    """90 lines: sentences of up to 15 words (under max_len 16, which
    would truncate), blank lines and all-OOV lines, each of which must give
    one row."""
    rng = np.random.default_rng(6)
    lines = []
    for i in range(90):
        if i % 17 == 0:
            lines.append("")
        elif i % 13 == 0:
            lines.append("zzzunknown qqqmissing")
        else:
            n = int(rng.integers(1, 16))
            toks = [WORDS[int(j)] for j in rng.integers(0, V, n)]
            if i % 5 == 0:
                toks.insert(1, "oov_token")
            lines.append(" ".join(toks))
    path = tmp_path_factory.mktemp("transform") / "input.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path), [line.split() for line in lines]


# ----------------------------------------------------------------------
# Host building blocks
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["rows8", "default_rows", "all_empty",
                                  "one_long"])
def test_pack_query_block_equals_jax(case):
    enc = {
        "rows8": [np.array([3, 1, 4], np.int32), np.array([], np.int32),
                  np.array([1, 5], np.int32)],
        "default_rows": [np.array([1], np.int32)] * 3,
        "all_empty": [np.array([], np.int32)] * 3,
        "one_long": [np.arange(17, dtype=np.int32)],
    }[case]
    rows = 8 if case == "rows8" else None
    got, want = pack_query_block(enc, rows=rows), j_pack(enc, rows=rows)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_pack_query_block_overflow_raises_in_both():
    enc = [np.array([1], np.int32)] * 5
    for fn in (pack_query_block, j_pack):
        with pytest.raises(ValueError):
            fn(enc, rows=4)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
def test_shard_span_equals_jax(world):
    for total in (0, 1, 7, 8, 9, 100, 100_003):
        spans = [shard_span(total, r, world) for r in range(world)]
        assert spans == [j_span(total, r, world) for r in range(world)]
        assert spans[0][0] == 0 and spans[-1][1] == total
    for bad in ((10, world, world), (10, 0, 0), (-1, 0, world)):
        with pytest.raises(ValueError):
            shard_span(*bad)


def test_count_lines_and_line_iterator_equal_jax(tmp_path):
    for name, text in (("a.txt", "a b\n\nc\n"), ("b.txt", "a\nb"), ("c.txt", "")):
        p = str(tmp_path / name)
        with open(p, "w") as f:
            f.write(text)
        assert count_lines(p) == jtr.count_lines(p)
        for span in ((0, None), (1, 2), (2, None)):
            assert list(iter_sentence_lines(p, start=span[0], end=span[1])) \
                == list(jtr.iter_sentence_lines(p, start=span[0], end=span[1]))
    assert list(iter_sentence_lines(str(tmp_path / "a.txt"))) == [
        ["a", "b"], [], ["c"]]


def test_verify_shard_deep_and_shallow(tmp_path):
    d = str(tmp_path)
    np.save(os.path.join(d, "s.npy"), np.arange(6, dtype=np.float32))
    write_shard_manifest(d, "s.npy", build_shard_manifest(d, "s.npy"))
    verify_shard(d, "s.npy")
    raw = bytearray(open(os.path.join(d, "s.npy"), "rb").read())
    raw[-1] ^= 0xFF
    open(os.path.join(d, "s.npy"), "wb").write(raw)
    verify_shard(d, "s.npy", deep=False)  # same size: the shallow check passes
    with pytest.raises(CheckpointCorruptError, match="sha256"):
        verify_shard(d, "s.npy")
    with pytest.raises(CheckpointCorruptError, match="missing"):
        verify_shard(d, "t.npy", deep=False)


def test_fault_spec_grammar():
    specs = faults.parse_spec("transform.shard_commit:exc@3; "
                              "transform.producer:delay=0.01")
    assert specs["transform.shard_commit"].at == 3
    assert specs["transform.producer"].arg == 0.01
    for bad in ("nope:exc", "transform.producer:boom", "transform.producer",
                "transform.producer:exc@0"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
    assert not faults.armed()


# ----------------------------------------------------------------------
# The pipeline
# ----------------------------------------------------------------------


def test_transform_file_matches_jax_and_transform_sentences(
    models, transform_input, tmp_path
):
    jm, pm = models
    path, sents = transform_input
    stats = transform_file(pm, path, str(tmp_path / "p"), **KW)
    jstats = jtr.transform_file(jm, path, str(tmp_path / "j"), **KW)
    got = load_transform_output(str(tmp_path / "p"))
    np.testing.assert_allclose(got, load_transform_output(str(tmp_path / "j")),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got, pm.transform_sentences(sents))
    assert set(stats) == set(jstats)
    assert stats["sentences"] == stats["sentences_done"] == len(sents)
    assert stats["shards_committed"] == -(-len(sents) // 16)
    assert stats["post_warmup_compiles"] == 0
    assert 0.0 < stats["bucket_fill"] <= 1.0
    prog = json.loads((tmp_path / "p" / "progress.json").read_text())
    assert prog["complete"] and prog["sentences_done"] == len(sents)
    assert (got[[0, 13, 17]] == 0).all()  # blank and all-OOV lines


def test_transform_file_resume_after_fault_is_bitwise(
    models, transform_input, tmp_path
):
    _, pm = models
    path, _ = transform_input
    ref = str(tmp_path / "ref")
    transform_file(pm, path, ref, **KW)
    out = str(tmp_path / "out")
    faults.arm("transform.shard_commit:exc@2")
    try:
        with pytest.raises(faults.FaultInjected):
            transform_file(pm, path, out, **KW)
    finally:
        faults.disarm()
    assert os.path.exists(os.path.join(out, "shard-000001.npy"))
    stats = transform_file(pm, path, out, **KW)
    assert stats["shards_skipped"] >= 2 and stats["resumed_sentences"] >= 32
    np.testing.assert_array_equal(load_transform_output(out),
                                  load_transform_output(ref))


def test_transform_file_corrupt_shard_recomputed(
    models, transform_input, tmp_path
):
    _, pm = models
    path, _ = transform_input
    out = str(tmp_path / "out")
    transform_file(pm, path, out, **KW)
    ref = load_transform_output(out)
    victim = os.path.join(out, "shard-000001.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(raw)
    stats = transform_file(pm, path, out, **KW)
    assert stats["shards_skipped"] == 1
    np.testing.assert_array_equal(load_transform_output(out), ref)


def test_transform_file_geometry_mismatch_refuses(
    models, transform_input, tmp_path
):
    _, pm = models
    path, _ = transform_input
    out = str(tmp_path / "out")
    transform_file(pm, path, out, **KW)
    with pytest.raises(CheckpointCorruptError):
        transform_file(pm, path, out, rows=16, max_len=16, shard_size=16)


def test_transform_file_rank_spans_concat_bitwise(
    models, transform_input, tmp_path
):
    _, pm = models
    path, sents = transform_input
    whole = str(tmp_path / "whole")
    transform_file(pm, path, whole, **KW)
    parts = []
    for rank in range(3):
        start, end = shard_span(len(sents), rank, 3)
        out = str(tmp_path / f"rank-{rank}")
        transform_file(pm, path, out, start=start, end=end, **KW)
        parts.append(load_transform_output(out))
    np.testing.assert_array_equal(np.concatenate(parts),
                                  load_transform_output(whole))


def test_shard_writer_commit_fires_fault_point(tmp_path):
    w = ShardWriter(str(tmp_path / "w"), shard_size=4, dim=3,
                    meta={"version": 1})
    faults.arm("transform.shard_commit:exc@1")
    try:
        with pytest.raises(faults.FaultInjected):
            w.append(np.ones((4, 3), np.float32))
    finally:
        faults.disarm()
    assert os.path.exists(str(tmp_path / "w" / "shard-000000.npy"))


def test_transform_packed_and_bulk_warmup(models):
    jm, pm = models
    sents = [[WORDS[i] for i in range(j, j + 5)] for j in range(10)]
    enc = [pm.vocab.encode(s) for s in sents]
    idx, mask, n = pack_query_block(enc, rows=16)
    packed = pm.transform_packed(idx, mask)[:n]
    np.testing.assert_array_equal(packed, pm.transform_sentences(sents))
    np.testing.assert_allclose(packed, jm.transform_packed(idx, mask)[:n],
                               rtol=1e-6, atol=1e-7)
    eng = EmbeddingEngine(V, D, COUNTS, device="cpu")
    from glint_word2vec_torch.models.word2vec import Word2VecModel

    fresh = Word2VecModel(pm.vocab, eng, pm.params)
    assert fresh.bulk_warmup(8, 16) == 5  # lengths 1, 2, 4, 8, 16
    assert fresh.bulk_warmup(8, 16) == 0
    eng.destroy()


@pytest.fixture(scope="module")
def ft_model(tables):
    syn0, _ = tables
    params = FastTextParams(vector_size=D, min_count=1, bucket=400,
                            min_n=3, max_n=5, max_subwords=16)
    words = ["austria", "vienna", "germany", "berlin", "capital"] + WORDS[5:]
    vocab = Vocabulary.from_sorted(words, COUNTS)
    rng = np.random.default_rng(8)
    full = np.concatenate([syn0, rng.standard_normal((400, D)).astype(np.float32)])
    eng = EmbeddingEngine(V, D, COUNTS, extra_rows=400, device="cpu")
    eng.set_tables(full, np.zeros_like(full))
    sub_ids, sub_mask = build_subword_table(words, V, 400, 3, 5, 16)
    m = FastTextModel(vocab, eng, params, sub_ids, sub_mask)
    yield m
    m.stop()


def test_fasttext_bulk_transform_oov_heavy(ft_model, tmp_path):
    rng = np.random.default_rng(9)
    lines = []
    for i in range(40):
        toks = [ft_model.vocab.words[int(j)] for j in rng.integers(0, V, 6)]
        toks += [f"oov{i}x", "austriaa", "zz"]
        lines.append(" ".join(toks) if i % 7 else "")
    path = str(tmp_path / "ft.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    stats = transform_file(ft_model, path, str(tmp_path / "out"), **KW)
    got = load_transform_output(str(tmp_path / "out"))
    np.testing.assert_array_equal(
        got, ft_model.transform_sentences([s.split() for s in lines]))
    assert stats["post_warmup_compiles"] == 0 and stats["warmup_compiles"] <= 1


# ----------------------------------------------------------------------
# synonyms_dump
# ----------------------------------------------------------------------


def _assert_rows_close(want, got):
    """Lists of [word, sim]: sims within 1e-5, words equal where the
    neighbouring scores differ by more than that."""
    assert len(got) == len(want)
    ws = [s for _, s in want]
    np.testing.assert_allclose([s for _, s in got], ws, atol=1e-5, rtol=0)
    for j, ((w, _), (g, _)) in enumerate(zip(want, got)):
        gaps = [ws[j - 1] - ws[j] if j else np.inf,
                ws[j] - ws[j + 1] if j + 1 < len(ws) else np.inf]
        if min(gaps) > 1e-5:
            assert g == w, (j, want, got)


def _dump_both(jm, pm, tmp_path, tag, **kw):
    paths = {}
    for name, m, fn in (("j", jm, jtr.synonyms_dump),
                        ("p", pm, synonyms_dump)):
        out = str(tmp_path / f"{tag}_{name}.jsonl")
        prefix = str(tmp_path / f"{tag}_{name}_knn")
        stats = fn(m, out, num=5, block=32, graph_prefix=prefix, **kw)
        paths[name] = (out, prefix, stats)
    want = [json.loads(x) for x in open(paths["j"][0])]
    got = [json.loads(x) for x in open(paths["p"][0])]
    assert [d["word"] for d in got] == [d["word"] for d in want]
    for a, b in zip(want, got):
        _assert_rows_close(a["synonyms"], b["synonyms"])
        assert b["word"] not in [w for w, _ in b["synonyms"]]
    jp, pp = paths["j"][1], paths["p"][1]
    np.testing.assert_allclose(np.load(pp + ".sims.npy"),
                               np.load(jp + ".sims.npy"), atol=1e-5, rtol=0)
    assert np.load(pp + ".ids.npy").dtype == np.int32
    meta = json.loads(open(pp + ".json").read())
    assert meta["pad_id"] == -1 and meta["words"] == V
    assert set(paths["p"][2]) == set(paths["j"][2])
    return got


def test_synonyms_dump_exact_matches_jax(models, tmp_path):
    jm, pm = models
    got = _dump_both(jm, pm, tmp_path, "exact")
    want = pm.find_synonyms(WORDS[0], 5)
    assert [w for w, _ in got[0]["synonyms"]] == [w for w, _ in want]


def test_synonyms_dump_ann_on_a_carried_index_matches_jax(tables, tmp_path):
    syn0, syn1 = tables
    jeng = JaxEngine(make_mesh(1, 1), V, D, COUNTS, seed=1)
    jeng.set_tables(syn0, syn1)
    jm = JaxModel(JaxVocab.from_sorted(WORDS, COUNTS), jeng,
                  JaxParams(vector_size=D, min_count=1))
    pm = model_from_arrays(WORDS, syn0, syn1, COUNTS,
                           Word2VecParams(vector_size=D, min_count=1),
                           device="cpu")
    jeng.configure_ann(nprobe=2)
    pm.engine.configure_ann(nprobe=2)
    jeng.adopt_ann(jeng.ann_build())
    pm.engine.adopt_ann(ann_index_from_arrays(jeng.ann_index, device="cpu"))
    got = _dump_both(jm, pm, tmp_path, "ann", approximate=True)
    exact = pm.find_synonyms_batch(pm.transform_words(WORDS), 6)
    differ = sum(
        [w for w, _ in g["synonyms"]] != [w for w, _ in e if w != g["word"]][:5]
        for g, e in zip(got, exact))
    assert differ < V // 2  # a probe of 2 of the clusters misses some
    jm.stop()
    pm.stop()


def test_synonyms_dump_vocab_span(models, tmp_path):
    _, pm = models
    out = str(tmp_path / "span.jsonl")
    stats = synonyms_dump(pm, out, num=3, block=8, start=2, end=6)
    assert stats["words"] == 4
    assert [json.loads(x)["word"] for x in open(out)] == WORDS[2:6]


# ----------------------------------------------------------------------
# Observability
# ----------------------------------------------------------------------


def _transform_kwargs():
    return dict(sentences_done=64, input_sentences=128,
                sentences_per_sec=100.0, shards_committed=4, shards_skipped=1,
                bucket_fill=0.75, producer_wait_seconds=0.5,
                dispatch_seconds=2.0, post_warmup_compiles=0)


def test_status_transform_block_equals_jax_and_renders():
    from glint_word2vec_torch.obs.prometheus import lint_prometheus_text

    st, jst = TrainingStatus(pipeline="transform"), JaxStatus(pipeline="transform")
    assert "transform" not in st.snapshot(include_devices=False)
    st.set_transform(**_transform_kwargs())
    jst.set_transform(**_transform_kwargs())
    got = st.snapshot(include_devices=False)["transform"]
    assert got == jst.snapshot(include_devices=False)["transform"]
    text = training_to_prometheus(st.snapshot(include_devices=False))
    lint_prometheus_text(text)
    assert "glint_transform_sentences_done_total 64" in text
    assert "glint_transform_" not in training_to_prometheus(
        TrainingStatus(pipeline="fit").snapshot(include_devices=False))


def test_obs_run_update_transform_writes_status(tmp_path):
    NULL_RUN.update_transform(**_transform_kwargs())
    status = str(tmp_path / "status.json")
    run = start_run(ObsConfig(status_file=status), pipeline="transform")
    try:
        run.update_transform(**_transform_kwargs())
    finally:
        run.close()
    snap = json.loads(open(status).read())
    assert snap["transform"]["sentences_done_total"] == 64
    assert snap["pipeline"] == "transform"


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def saved_model_dir(models, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("saved") / "model")
    models[1].save(path)
    return path


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_transform_file_and_resume(saved_model_dir, transform_input,
                                       tmp_path, capsys):
    path, sents = transform_input
    out = str(tmp_path / "out")
    status = str(tmp_path / "status.json")
    argv = ["transform-file", "--model", saved_model_dir, "--input", path,
            "--out", out, "--rows", "8", "--max-len", "16",
            "--shard-size", "16", "--device", "cpu", "--status-file", status]
    assert cli.main(argv) == 0
    stats = _last_json(capsys)
    assert stats["sentences_done"] == len(sents)
    assert stats["post_warmup_compiles"] == 0
    assert json.loads(open(status).read())["transform"][
        "sentences_done_total"] == len(sents)
    assert cli.main(argv) == 0  # a second run resumes past every shard
    stats2 = _last_json(capsys)
    assert stats2["shards_committed"] == 0
    assert stats2["shards_skipped"] == stats["shards_committed"]
    vecs = load_transform_output(out)
    assert vecs.shape == (len(sents), D)
    # Two ranks of the same input concatenate to the whole run.
    for rank in (0, 1):
        assert cli.main(argv[:-2] + ["--out", str(tmp_path / "ranks"),
                                     "--rank", str(rank), "--world", "2"]) == 0
        assert _last_json(capsys)["world"] == 2
    np.testing.assert_array_equal(np.concatenate([
        load_transform_output(str(tmp_path / "ranks" / f"rank-{r:04d}"))
        for r in (0, 1)]), vecs)
    assert cli.main(argv + ["--workers", "2"]) == 2
    assert "Queue A item 8" in capsys.readouterr().err


def test_cli_synonyms_dump_ann(saved_model_dir, tmp_path, capsys):
    out = str(tmp_path / "syn.jsonl")
    rc = cli.main(["synonyms-dump", "--model", saved_model_dir, "--out", out,
                   "--graph-out", str(tmp_path / "g"), "-n", "3",
                   "--block", "32", "--ann", "--ann-nprobe", "4",
                   "--device", "cpu"])
    assert rc == 0
    stats = _last_json(capsys)
    assert stats["approximate"] is True
    assert stats["words"] == V == sum(1 for _ in open(out))
    assert np.load(str(tmp_path / "g.ids.npy")).shape == (V, 3)
    assert cli.main(["synonyms-dump", "--model", saved_model_dir,
                     "--device", "cpu"]) == 1
