"""The port's native host pass (glint_word2vec_torch/native) against the
JAX package's (glint_word2vec_tpu/native), and its place in the port.

* ``alias_build``, ``window_batch_epoch`` (1 and 2 threads) and the corpus
  scan are bitwise equal to the JAX package's native functions: on Zipf
  weights, and on a text file with CRLF and CR line ends, Unicode
  whitespace and, in a second file, invalid UTF-8 (where both decline and
  the Python passes run).
* ``build_alias`` and ``scan_and_encode_file`` take the native pass when
  it is built and equal the Python passes where those are exact;
  ``GLINT_W2V_NO_NATIVE=1`` gives the Python passes.
* Without a compiler the Python pass runs, logged once at WARNING; the
  library's file name changes with the host CPU.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu import native as jnative
from glint_word2vec_tpu.corpus import vocab as jv

from glint_word2vec_torch import native as pnative
from glint_word2vec_torch.corpus import alias as palias
from glint_word2vec_torch.corpus import vocab as pv
from glint_word2vec_torch.kernels import build

from torch_jax_native import jax_native_library


@pytest.fixture(scope="module", autouse=True)
def _both_built(tmp_path_factory):
    assert pnative.get_lib() is not None, "the port's native pass"
    with jax_native_library(str(tmp_path_factory.mktemp("jax_native"))):
        yield


@pytest.mark.parametrize("n,a", [(1, 1.5), (1000, 1.1), (50_000, 1.3)])
def test_alias_build_equals_jax_native(n, a):
    rng = np.random.default_rng(n)
    w = rng.zipf(a, n).astype(np.float64) ** 0.75
    w[::7] = 0.0 if n > 1 else w[::7]
    calls = pnative.calls["alias_build"]
    prob, alias = pnative.alias_build_native(w)
    jprob, jalias = jnative.alias_build_native(w)
    assert prob.view(np.uint32).tolist() == jprob.view(np.uint32).tolist()
    np.testing.assert_array_equal(alias, jalias)
    table = palias.build_alias(w)  # the port's builder takes the native pass
    np.testing.assert_array_equal(table.prob.view(np.uint32), prob.view(np.uint32))
    np.testing.assert_array_equal(table.alias, alias)
    assert pnative.calls["alias_build"] == calls + 2


@pytest.mark.parametrize("bad", [np.zeros(0), np.array([1.0, -1.0]),
                                 np.array([np.nan]), np.zeros(3)])
def test_alias_build_rejects_what_the_jax_builder_rejects(bad):
    with pytest.raises(ValueError) as pe:
        pnative.alias_build_native(bad)
    with pytest.raises(ValueError) as je:
        jnative.alias_build_native(bad)
    assert str(pe.value) == str(je.value)


def _flat_corpus(seed, V=300, n_sent=400):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 40, n_sent)
    ids = (rng.zipf(1.2, int(lens.sum())) % V).astype(np.int32)
    offsets = np.zeros(n_sent + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    kp = np.linspace(0.05, 1.0, V).astype(np.float32)
    return ids, offsets, kp


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("window,subsample", [(5, True), (2, False), (1, False)])
def test_window_batch_epoch_equals_jax_native(threads, window, subsample):
    ids, offsets, kp = _flat_corpus(window)
    if not subsample:
        kp = np.ones_like(kp)
    got = pnative.window_batch_epoch_native(ids, offsets, kp, window, 1234567,
                                            threads=threads)
    want = jnative.window_batch_epoch_native(ids, offsets, kp, window, 1234567,
                                             threads=1)
    assert got[3] == want[3] == ids.size
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
    assert got[0].shape[0] > 0


def test_window_batch_epoch_threads_from_the_environment(monkeypatch):
    ids, offsets, kp = _flat_corpus(3)
    one = pnative.window_batch_epoch_native(ids, offsets, kp, 4, 9, threads=1)
    for value in ("2", "", "many"):
        monkeypatch.setenv("GLINT_NATIVE_THREADS", value)
        got = pnative.window_batch_epoch_native(ids, offsets, kp, 4, 9)
        for g, w in zip(got, one):
            np.testing.assert_array_equal(g, w)


#: Lines with CRLF and a lone CR, Unicode whitespace (NBSP, em space,
#: ideographic space, NEL, the information separators) inside lines, a
#: blank line, and words past min_count.
TEXT = (
    "der hund läuft über die straße\r\n"
    "die katze\u00a0schläft\u3000im haus\u2003\r\n"
    "\r\n"
    "der hund und die katze\x1cspielen\x85im garten\r"
    "über die straße läuft der hund\n"
    "im haus schläft die katze im garten spielen der hund\n"
) * 9


def _write(tmp_path, name, data: bytes):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("min_count,max_len", [(1, 1000), (5, 3), (40, 1000)])
def test_corpus_scan_equals_jax_native(tmp_path, min_count, max_len):
    path = _write(tmp_path, "c.txt", TEXT.encode("utf-8"))
    calls = pnative.calls["corpus_scan"]
    got = pnative.corpus_scan_native(path, min_count, max_len, threads=2)
    want = jnative.corpus_scan_native(path, min_count, max_len, threads=1)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert pnative.calls["corpus_scan"] == calls + 1
    # The scan's output is the Python passes' output.
    vocab, ids, offsets = pv.scan_and_encode_file(
        path, min_count=min_count, max_sentence_length=max_len)
    jvocab = jv.build_vocab(jv.iter_text_file(path), min_count=min_count)
    jids, joffsets = jv.encode_file(path, jvocab, max_sentence_length=max_len)
    assert vocab.words == jvocab.words == got[0]
    np.testing.assert_array_equal(vocab.counts, jvocab.counts)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(offsets, joffsets)


def test_corpus_scan_declines_invalid_utf8_and_lowercase(tmp_path):
    data = TEXT.encode("utf-8") + b"der hund \xff\xfe l\xe4uft\n" * 6
    path = _write(tmp_path, "bad.txt", data)
    assert pnative.corpus_scan_native(path, 1, 1000) is None
    assert jnative.corpus_scan_native(path, 1, 1000) is None
    good = _write(tmp_path, "good.txt", TEXT.encode("utf-8"))
    assert pnative.corpus_scan_native(good, 1, 1000, lowercase=True) is None
    # scan_and_encode_file then runs the Python passes, as the JAX
    # package's does.
    for p, kw in ((path, {}), (good, {"lowercase": True})):
        a = pv.scan_and_encode_file(p, min_count=1, **kw)
        b = jv.scan_and_encode_file(p, min_count=1, **kw)
        assert a[0].words == b[0].words
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


def test_no_native_gives_the_python_passes(tmp_path, monkeypatch):
    path = _write(tmp_path, "c.txt", TEXT.encode("utf-8"))
    native = pv.scan_and_encode_file(path, min_count=2)
    w = np.random.default_rng(0).zipf(1.2, 3000).astype(np.float64)
    table = palias.build_alias(w)
    monkeypatch.setenv("GLINT_W2V_NO_NATIVE", "1")
    assert pnative.get_lib() is None
    calls = dict(pnative.calls)
    python = pv.scan_and_encode_file(path, min_count=2)
    assert python[0].words == native[0].words
    for a, b in zip(python[1:], native[1:]):
        np.testing.assert_array_equal(a, b)
    # The Python alias loop builds the native table, bit for bit.
    loop = palias.build_alias(w)
    np.testing.assert_array_equal(loop.prob.view(np.uint32), table.prob.view(np.uint32))
    np.testing.assert_array_equal(loop.alias, table.alias)
    assert pnative.calls == calls


def test_without_a_compiler_the_python_pass_runs_and_warns_once(
        monkeypatch, caplog):
    def no_compiler(name):
        raise RuntimeError("g++ not found: the native host pass cannot be built")

    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_build_failed", False)
    monkeypatch.setattr(build, "native_library", no_compiler)
    with caplog.at_level(logging.WARNING, logger=pnative.__name__):
        assert pnative.get_lib() is None
        assert pnative.get_lib() is None
        table = palias.build_alias(np.array([1.0, 2.0, 3.0, 0.5]))
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "g++ not found" in warnings[0].getMessage()
    assert table.size == 4


def test_library_name_follows_source_flags_and_cpu(monkeypatch):
    a = build.native_library_path("host_ops")
    assert a.parent == build.BUILD_DIR and a.name.startswith("host_ops-")
    assert build.native_library_path("host_ops") == a
    monkeypatch.setattr(build, "host_cpu_model", lambda: "another cpu")
    assert build.native_library_path("host_ops") != a
    monkeypatch.undo()
    monkeypatch.setattr(build, "GXX_FLAGS", build.GXX_FLAGS + ("-g",))
    assert build.native_library_path("host_ops") != a
