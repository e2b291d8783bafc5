"""The port stands alone: it imports neither JAX nor the JAX package, and
it runs on the CPU only when asked to."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import glint_word2vec_torch
from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch.models import load_model
from glint_word2vec_torch.ops.rows import gather_rows
from glint_word2vec_torch.parallel.engine import EmbeddingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "glint_word2vec_torch")
FORBIDDEN = ("jax", "jaxlib", "glint_word2vec_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__")):
                names = [str(node.args[0].value)]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert len(_sources()) > 10
    assert not bad, bad


def test_every_module_imports_with_jax_poisoned():
    modules = ["glint_word2vec_torch"] + [
        m.name for m in pkgutil.walk_packages(
            glint_word2vec_torch.__path__, "glint_word2vec_torch."
        )
    ]
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'glint_word2vec_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib', 'glint_word2vec_tpu')\n"
        "               and v is not None for k, v in sys.modules.items())\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(modules) >= 14
    # The observability, checkpoint-writer, evaluation and streaming
    # modules too.
    assert {
        "glint_word2vec_torch.obs", "glint_word2vec_torch.obs.events",
        "glint_word2vec_torch.obs.canary", "glint_word2vec_torch.obs.heartbeat",
        "glint_word2vec_torch.obs.prometheus",
        "glint_word2vec_torch.utils.async_ckpt",
        "glint_word2vec_torch.eval", "glint_word2vec_torch.eval.analogy",
        "glint_word2vec_torch.corpus.stream_vocab",
        "glint_word2vec_torch.streaming", "glint_word2vec_torch.streaming.publish",
        "glint_word2vec_torch.streaming.trainer",
    } <= set(modules)


def test_no_cuda_raises_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    counts = np.ones(4, np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingEngine(4, 3, counts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbeddingEngine(4, 3, counts, device="cuda")
    eng = EmbeddingEngine(4, 3, counts, device="cpu")
    assert eng.syn0.device.type == "cpu"
    assert eng.pull(np.array([1, 2], np.int32)).shape == (2, 3)
    eng.save(str(tmp_path / "m" / "matrix"))
    (tmp_path / "m" / "words.txt").write_text("a\nb\nc\nd\n")
    (tmp_path / "m" / "params.json").write_text('{"vector_size": 3}')
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(str(tmp_path / "m"))
    assert load_model(str(tmp_path / "m"), device="cpu").vocab.size == 4
    sents = [["a", "b", "c", "d"]] * 8
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Word2Vec(min_count=1, vector_size=3).fit(sents)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Word2Vec(min_count=1, vector_size=3).fit_stream(iter(sents))
    assert Word2Vec(device="cpu", min_count=1, vector_size=3).fit(sents).vocab.size == 4


def test_gather_refuses_other_devices():
    # Only a CPU tensor takes the plain version; anything else launches
    # the kernel (CUDA) or raises.
    table = torch.zeros((5, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_rows(table, torch.zeros(2, dtype=torch.int32, device="meta"))


def test_fasttext_model_dir_is_refused(tmp_path):
    # load_model reads a fastText directory (its params carry "bucket") as
    # a FastTextModel, whose params refuse a geometry fastText cannot have.
    (tmp_path / "params.json").write_text(json.dumps({"bucket": 0}))
    with pytest.raises(ValueError, match="bucket must be > 0"):
        load_model(str(tmp_path), device="cpu")


def test_cli_info_and_synonyms_on_cpu(tmp_path, capsys):
    from glint_word2vec_torch import cli
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.utils.params import Word2VecParams

    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(20)]
    tables = rng.normal(size=(2, 20, 4)).astype(np.float32)
    model_from_arrays(words, tables[0], tables[1], np.arange(20, 0, -1),
                      Word2VecParams(vector_size=4, min_count=1),
                      device="cpu").save(str(tmp_path / "m"))
    assert cli.main(["info", "--model", str(tmp_path / "m"), "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert (info["vocab_size"], info["vector_size"]) == (20, 4)
    assert cli.main(["synonyms", "--model", str(tmp_path / "m"), "--word", "w1",
                     "-n", "3", "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 3
    # train, in a child process with JAX poisoned, at a tiny size.
    corpus = tmp_path / "c.txt"
    corpus.write_text("".join(
        " ".join(f"w{(7 * i + j) % 12}" for j in range(9)) + "\n" for i in range(40)
    ))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'glint_word2vec_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from glint_word2vec_torch import cli\n"
        "sys.exit(cli.main(sys.argv[1:]))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code, "train", "--corpus", str(corpus),
         "--output", str(tmp_path / "t"), "--device", "cpu", "--vector-size", "4",
         "--batch-size", "16", "--min-count", "1", "--window", "2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["pipeline"] == "device_corpus"
    assert load_model(str(tmp_path / "t"), device="cpu").vocab.size == 12
