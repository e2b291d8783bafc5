"""The keywords the port took over from the JAX package's surface, each
against the JAX package on the same inputs.

* ``SkipGramBatcher(..., shuffle=True)`` and ``from_flat(...,
  shuffle=True)``: each epoch visits the sentences in the order drawn
  from ``default_rng((seed, epoch))``, and the batches equal the JAX
  package's bitwise (the numpy pass, also where the native library is
  built).
* ``ModelServer(warm_ks=, warm_sentence_lens=, warm_sentence_rows=)``:
  the warmup runs the shapes asked for, as many as the JAX server's, and
  a ``/synonyms`` of ``num=50`` after warming k = 64 dispatches no new
  shape.
* ``serve_model_dir`` names the seven ``ann*`` keywords with the JAX
  defaults: a misspelt one fails at the call, and ``ann=True,
  ann_nprobe=8`` serves through the index.

Tolerances: batches, counts and names compare exactly.
"""

import inspect
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.corpus import batching as jb
from glint_word2vec_tpu.corpus import vocab as jv

from glint_word2vec_torch.corpus import batching as pb
from glint_word2vec_torch.corpus import vocab as pv


def _encoded(corpus, vocab_mod, batching_mod):
    voc = vocab_mod.build_vocab(corpus, min_count=5)
    return voc, batching_mod.chunk_sentences(
        batching_mod.encode_sentences(corpus, voc), 7)


def _batches(it):
    return [(b.centers.copy(), b.contexts.copy(), b.mask.copy(), b.words_done)
            for b in it]


@pytest.mark.parametrize("block_rows", [1 << 16, 37])
@pytest.mark.parametrize("subsample_ratio", [0.0, 0.05])
def test_shuffled_batches_equal_jax(tiny_corpus, monkeypatch,
                                    subsample_ratio, block_rows):
    monkeypatch.setattr(pb, "_BLOCK_ROWS", block_rows)
    corpus = tiny_corpus[:900]
    jvoc, jenc = _encoded(corpus, jv, jb)
    pvoc, penc = _encoded(corpus, pv, pb)
    kw = dict(batch_size=64, window=4, subsample_ratio=subsample_ratio,
              seed=3, shuffle=True)
    jbat = jb.SkipGramBatcher(jenc, jvoc, **kw)
    ids = np.concatenate(penc)
    offsets = np.zeros(len(penc) + 1, np.int64)
    np.cumsum([s.size for s in penc], out=offsets[1:])
    flat = pb.SkipGramBatcher.from_flat(ids, offsets, pvoc, **kw)
    listed = pb.SkipGramBatcher(penc, pvoc, **kw)
    plain = pb.SkipGramBatcher(penc, pvoc, **dict(kw, shuffle=False))
    for epoch in (0, 1):
        want = _batches(jbat._epoch_python(epoch))
        for bat in (flat, listed):
            got = _batches(bat.epoch(epoch))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
            assert bat.words_done == jbat.words_done
        order = _batches(plain._epoch_python(epoch))
        assert any(not np.array_equal(a[0], b[0])
                   for a, b in zip(order, want))


V, D = 200, 16


def _models():
    from glint_word2vec_tpu.corpus.vocab import Vocabulary as JaxVocab
    from glint_word2vec_tpu.models.word2vec import Word2VecModel as JaxModel
    from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
    from glint_word2vec_tpu.parallel.mesh import make_mesh
    from glint_word2vec_tpu.utils.params import Word2VecParams as JaxParams

    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.utils.params import Word2VecParams

    rng = np.random.default_rng(0)
    s0 = rng.normal(size=(V, D)).astype(np.float32)
    counts = np.arange(V, 0, -1).astype(np.int64)
    words = [f"w{i}" for i in range(V)]
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts)
    jeng.set_tables(s0, s0)
    jmodel = JaxModel(JaxVocab.from_sorted(words, counts), jeng,
                      JaxParams(vector_size=D))
    pmodel = model_from_arrays(words, s0, s0, counts,
                               Word2VecParams(vector_size=D), device="cpu")
    return jmodel, pmodel


def _post(host, port, path, payload):
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(host, port, path):
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def test_server_warms_the_shapes_asked_for():
    from glint_word2vec_tpu.serving import ModelServer as JaxServer

    from glint_word2vec_torch.serving import ModelServer

    jmodel, pmodel = _models()
    warm = dict(warm_ks=(16, 32, 64), warm_sentence_lens=(1, 4),
                warm_sentence_rows=(1, 2))
    counts = {}
    for side, cls, model in (("jax", JaxServer, jmodel),
                             ("torch", ModelServer, pmodel)):
        for name, kw in (("asked", warm), ("default", {})):
            before = model.engine.query_compiles
            server = cls(model, port=0, max_batch=4, **kw)
            counts[side, name] = model.engine.query_compiles - before
            server._httpd.server_close()
    assert counts["torch", "asked"] == counts["jax", "asked"]
    assert counts["torch", "default"] == counts["jax", "default"]
    jmodel.stop()
    # k = 64 warmed: a /synonyms of 50 (fetching 51) dispatches no new
    # shape.
    server = ModelServer(pmodel, port=0, max_batch=4, warm_ks=(16, 32, 64))
    server.start_background()
    try:
        hits = _post(server.host, server.port, "/synonyms",
                     {"word": "w3", "num": 50})
        assert len(hits) == 50
        assert _get(server.host, server.port,
                    "/healthz")["post_warmup_compiles"] == 0
    finally:
        server.stop()
        pmodel.stop()


def test_serve_model_dir_names_the_ann_keywords(tmp_path):
    from glint_word2vec_tpu.serving import serve_model_dir as jax_serve

    from glint_word2vec_torch.serving import serve_model_dir

    names = [f"ann{s}" for s in ("", "_clusters", "_nprobe", "_iters",
                                 "_sample", "_recall_gate", "_recall_sample")]
    mine = inspect.signature(serve_model_dir).parameters
    theirs = inspect.signature(jax_serve).parameters
    assert not any(p.kind is p.VAR_KEYWORD for p in mine.values())
    for n in names:
        assert mine[n].default == theirs[n].default, n
    with pytest.raises(TypeError, match="ann_probe"):
        serve_model_dir(str(tmp_path / "absent"), ann_probe=8)

    _, model = _models()
    model.save(str(tmp_path / "m"))
    model.stop()
    port_file = str(tmp_path / "port.json")
    t = threading.Thread(target=serve_model_dir, args=(str(tmp_path / "m"),),
                         kwargs=dict(port=0, port_file=port_file,
                                     device="cpu", max_batch=4, ann=True,
                                     ann_nprobe=8, ann_recall_sample=16),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 120
    while not os.path.exists(port_file):
        assert t.is_alive() and time.monotonic() < deadline
        time.sleep(0.05)
    with open(port_file) as f:
        addr = json.load(f)
    host, port = addr["host"], addr["port"]
    try:
        h = _get(host, port, "/healthz")
        assert h["index"]["enabled"] and h["index"]["nprobe"] == 8
    finally:
        _post(host, port, "/shutdown", {})
        t.join(timeout=60)
    assert not t.is_alive()
