"""The port's fault points against the JAX package's.

* The port's ``POINTS`` registry names the JAX package's points.
* ``ckpt.pre_rename`` and ``ckpt.post_rename`` sit around the snapshot
  directory's commit rename: ``ckpt.pre_rename:kill@2`` in a child lets
  ``ckpt-1`` commit and load and leaves no ``ckpt-2``, only its temp
  directory with the manifest in it (the JAX drill of
  ``tests/test_ckpt_integrity.py``); ``ckpt.post_rename:exc`` raises once
  the directory is committed.
* ``producer.batch`` fires on the producer thread of ``group_batches``: an
  injected exception reaches the consumer of ``prefetch`` and the caller
  of a host-route fit (``tests/test_faults.py`` for the JAX package).
* A host-route fit with observability on records one ``batch_prefetch``
  span a group, on the producer thread's tid.

Tolerances: names, counts and tables compare exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.utils import faults as jfaults

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch import obs as pobs
from glint_word2vec_torch.corpus.batching import Batch, group_batches
from glint_word2vec_torch.models import word2vec as w2v_mod
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.utils import faults
from glint_word2vec_torch.utils.integrity import verify_snapshot_dir
from glint_word2vec_torch.utils.prefetch import prefetch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = [
    "the quick brown fox jumps over the lazy dog".split(),
    "the dog sleeps all day long in the sun".split(),
    "a quick fox and a lazy dog meet in the field".split(),
    "the sun rises over the field every day".split(),
] * 30

_ENGINE = "EmbeddingEngine(48, 16, np.arange(48, 0, -1), seed=3, device='cpu')"


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    yield
    faults.disarm()


def _host_fit(monkeypatch, **kw):
    """A word2vec fit on the host batcher route (the device budget set to
    nothing), which runs ``group_batches`` under ``prefetch``."""
    monkeypatch.setattr(w2v_mod, "_free_device_bytes", lambda device: 0)
    return Word2Vec(device="cpu", vector_size=8, batch_size=32, min_count=1,
                    num_iterations=1, seed=7, steps_per_call=2, window=3,
                    **kw).fit(SMALL)


def test_points_are_the_jax_packages():
    assert set(faults.POINTS) == set(jfaults.POINTS)
    for name in ("ckpt.pre_rename", "ckpt.post_rename", "producer.batch"):
        assert faults.POINTS[name] == jfaults.POINTS[name]
    assert set(faults.parse_spec("ckpt.pre_rename:kill@2")) == {"ckpt.pre_rename"}


def test_pre_rename_kill_leaves_the_committed_checkpoint_alone(tmp_path):
    script = (
        "import sys\n"
        "import numpy as np\n"
        "from glint_word2vec_torch.parallel.engine import EmbeddingEngine\n"
        f"eng = {_ENGINE}\n"
        "eng.save(sys.argv[1] + '/ckpt-1')\n"
        "eng.write_rows(1, np.ones((1, 16), np.float32))\n"
        "eng.save(sys.argv[1] + '/ckpt-2')  # killed at pre_rename\n"
        "raise SystemExit('unreachable: the injected SIGKILL did not fire')\n"
    )
    env = dict(os.environ, GLINT_FAULTS="ckpt.pre_rename:kill@2",
               GLINT_CKPT_NO_FSYNC="1", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-2000:])
    assert verify_snapshot_dir(str(tmp_path / "ckpt-1")) is True
    assert not os.path.exists(tmp_path / "ckpt-2")
    tmp_dirs = [e for e in os.listdir(tmp_path) if ".tmp-" in e]
    assert len(tmp_dirs) == 1, os.listdir(tmp_path)
    # The manifest was written before the kill: the point sits between
    # the manifest and the rename.
    assert os.path.exists(tmp_path / tmp_dirs[0] / "manifest.json")
    loaded = EmbeddingEngine.load(str(tmp_path / "ckpt-1"), device="cpu")
    fresh = eval(_ENGINE)
    assert torch.equal(loaded.syn0, fresh.syn0)
    assert torch.equal(loaded.syn1, fresh.syn1)


def test_post_rename_fires_after_the_commit(tmp_path):
    eng = eval(_ENGINE)
    faults.arm("ckpt.post_rename:exc")
    with pytest.raises(faults.FaultInjected):
        eng.save(str(tmp_path / "ckpt-1"))
    assert verify_snapshot_dir(str(tmp_path / "ckpt-1")) is True
    assert not [e for e in os.listdir(tmp_path) if ".tmp-" in e]


def test_producer_batch_exc_propagates_through_prefetch():
    def batches():
        B, C = 4, 2
        while True:
            yield Batch(centers=np.zeros(B, np.int32),
                        contexts=np.zeros((B, C), np.int32),
                        mask=np.ones((B, C), np.float32), words_done=B)

    faults.arm("producer.batch:exc@2")
    it = prefetch(group_batches(batches(), 2), depth=2)
    next(it)  # group 1 was produced before the armed hit
    with pytest.raises(faults.FaultInjected):
        for _ in range(4):
            next(it)


def test_producer_batch_exc_reaches_the_fit_caller(monkeypatch):
    faults.arm("producer.batch:exc@3")
    with pytest.raises(faults.FaultInjected):
        _host_fit(monkeypatch)


def test_host_fit_records_batch_prefetch_on_the_producer_thread(
        tmp_path, monkeypatch):
    log = str(tmp_path / "events.jsonl")
    m = _host_fit(monkeypatch, obs=pobs.ObsConfig(event_log=log))
    assert m.training_metrics["pipeline"] == "host"
    events = [json.loads(line) for line in open(log) if line.strip()]
    prefetched = [e for e in events if e["name"] == "batch_prefetch"]
    steps = [e for e in events if e["name"] == "device_steps"]
    assert steps and len(prefetched) > len(steps)  # and the epoch's empty end
    assert [e["args"]["group"] for e in prefetched] == list(range(len(prefetched)))
    producer = {e["tid"] for e in prefetched}
    assert len(producer) == 1
    assert producer.isdisjoint({e["tid"] for e in steps})
    m.stop()
