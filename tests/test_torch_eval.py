"""The port's analogy evaluation against the JAX package's
(``glint_word2vec_tpu/eval/analogy.py``).

One model trained by the port on ``tiny_corpus``, saved, loaded by the
JAX package (``Word2VecModel.load``), and its tables handed to the
port's ``convert.model_from_arrays``: both packages then hold the same
tables. ``parse_analogy_file``, ``evaluate_analogies`` (per section,
with OOV questions skipped, top-k 1 and 5, batches that pad) and
``evaluate_synonym_gate`` give the JAX package's results: counts and
verdicts exactly, similarities within rtol 1e-5 (fp32 products summed
in another order). ``cli eval`` prints the same result.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.eval import analogy as jeval
from glint_word2vec_tpu.models.word2vec import Word2VecModel as JaxModel
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch.convert import model_from_arrays
from glint_word2vec_torch.eval import analogy as peval

COUNTRIES = [("germany", "berlin"), ("france", "paris"), ("austria", "vienna"),
             ("spain", "madrid"), ("italy", "rome"), ("poland", "warsaw")]

QUESTIONS = (
    ": capital-common\n"
    + "".join(f"{a} {b} {c} {d}\n" for a, b in COUNTRIES for c, d in COUNTRIES
              if a != c)
    + ": Mixed-Case and OOV\n"
    "Germany Berlin France Paris\n"
    "germany berlin atlantis poseidonia\n"
    "not four tokens\n"
    "\n"
    ": filler\n"
    + "".join(f"w{i} w{i + 1} w{i + 2} w{i + 3}\n" for i in range(0, 30, 3))
)


@pytest.fixture(scope="module")
def models(tiny_corpus, tmp_path_factory):
    """The same tables in a JAX model and a port model."""
    d = str(tmp_path_factory.mktemp("eval") / "m")
    trained = (Word2Vec(device="cpu").set_vector_size(32).set_window_size(5)
               .set_step_size(0.025).set_batch_size(256).set_num_negatives(5)
               .set_min_count(5).set_num_iterations(3).set_seed(1)
               .fit(tiny_corpus))
    trained.save(d)
    jm = JaxModel.load(d, mesh=make_mesh(1, 1))
    n = jm.vocab.size
    pm = model_from_arrays(
        list(jm.vocab.words), np.asarray(jm.engine.syn0, np.float32)[:n],
        np.asarray(jm.engine.syn1, np.float32)[:n], jm.vocab.counts,
        trained.params, device="cpu")
    return d, jm, pm


@pytest.mark.parametrize("lowercase", [True, False])
def test_parse_analogy_file_equals_jax(tmp_path, lowercase):
    q = tmp_path / "q.txt"
    q.write_text(QUESTIONS)
    got = peval.parse_analogy_file(str(q), lowercase=lowercase)
    assert got == jeval.parse_analogy_file(str(q), lowercase=lowercase)
    assert [name for name, _ in got] == ["capital-common", "Mixed-Case and OOV",
                                         "filler"]


@pytest.mark.parametrize("top_k,batch_size", [(1, 1024), (5, 7)])
def test_evaluate_analogies_equals_jax(models, tmp_path, top_k, batch_size):
    _, jm, pm = models
    q = tmp_path / "q.txt"
    q.write_text(QUESTIONS)
    questions = jeval.parse_analogy_file(str(q))
    got = peval.evaluate_analogies(pm, questions, top_k=top_k,
                                   batch_size=batch_size).to_dict()
    want = jeval.evaluate_analogies(jm, questions, top_k=top_k,
                                    batch_size=batch_size).to_dict()
    assert got == want
    assert got["skipped_oov"] == 1 and got["total"] == 30 + 1 + 10
    assert got["sections"]["capital-common"]["correct"] > 0
    # A flat list of 4-tuples is one "default" section.
    flat = questions[0][1][:6]
    assert (peval.evaluate_analogies(pm, flat, top_k=top_k).to_dict()
            == jeval.evaluate_analogies(jm, flat, top_k=top_k).to_dict())


@pytest.mark.parametrize("word,expected,top,min_sim", [
    ("austria", "vienna", 10, None),
    ("austria", "vienna", 10, 0.99),
    ("germany", "berlin", 3, 0.1),
    ("germany", "w7", 5, None),
])
def test_evaluate_synonym_gate_equals_jax(models, word, expected, top, min_sim):
    _, jm, pm = models
    got = peval.evaluate_synonym_gate(pm, word, expected, top, min_sim)
    want = jeval.evaluate_synonym_gate(jm, word, expected, top, min_sim)
    assert got[0] == want[0]
    if want[1] is None:
        assert got[1] is None
    else:
        assert got[1] == pytest.approx(want[1], rel=1e-5)


def test_cli_eval_prints_the_jax_result(models, tmp_path, capsys):
    from glint_word2vec_torch import cli

    d, jm, _ = models
    q = tmp_path / "q.txt"
    q.write_text(QUESTIONS)
    assert cli.main(["eval", "--model", d, "--questions", str(q),
                     "--device", "cpu", "--top-k", "3"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jeval.evaluate_analogies(
        jm, jeval.parse_analogy_file(str(q)), top_k=3).to_dict()
    assert got == want
