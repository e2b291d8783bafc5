"""The port's mesh across processes (glint_word2vec_torch/parallel/
distributed.py: ``make_global_mesh``, ``process_batch_slice``,
``make_global_batch``) against the JAX package's, the five cases of
tests/test_distributed.py in one process, and a gang of two processes on
gloo (tests/torch_mesh_gang_worker.py): each holds one data rank and both
model shards of a (2, 2) mesh, trains its half of the global batches, and
must end with the tables the JAX engine's (2, 2) mesh computes from the
whole batches; its ``exchange="none"`` fit ends with the two ranks' tables
bitwise equal, and a fit stopped after one epoch and resumed ends bitwise
at the uninterrupted one.

Tolerances: shapes, fractions, sentences and digests compare exactly;
tables within rtol 1e-5 and atol 1e-6 of the JAX engine's, losses within
rel 1e-5.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row
from glint_word2vec_tpu.parallel import distributed as jdist
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh as jax_mesh

from glint_word2vec_torch.parallel import distributed as pdist
from glint_word2vec_torch.parallel import mesh as pmesh
from glint_word2vec_torch.parallel.engine import EmbeddingEngine

HERE = os.path.dirname(os.path.abspath(__file__))
CPU8 = ["cpu"] * 8


def test_make_global_mesh_uses_all_devices():
    mesh = pdist.make_global_mesh(2, 4, devices=CPU8)
    assert mesh.shape == jdist.make_global_mesh(2, 4).shape
    assert mesh.shape == {"data": 2, "model": 4}
    assert (mesh.process_index, mesh.process_count) == (0, 1)


def test_process_batch_slice_fractions():
    mesh = pmesh.make_mesh(2, 4, devices=CPU8)
    jm = jax_mesh(2, 4)
    for args in [(0, 4), (3, 4), ()]:
        assert pdist.process_batch_slice(mesh, *args) \
            == jdist.process_batch_slice(jm, *args)
    assert pdist.process_batch_slice(mesh) == (0.0, 1.0)


def test_shard_sentences_round_robin_equal_slices():
    sents = [[f"w{i}"] for i in range(10)]
    for pi in range(3):
        assert pdist.shard_sentences_for_process(sents, pi, 3) \
            == jdist.shard_sentences_for_process(sents, pi, 3)
    assert [s[0] for s in pdist.shard_sentences_for_process(sents, 1, 3)] \
        == ["w1", "w4", "w7"]
    assert pdist.shard_sentences_for_process(sents, 0, 1) == sents


def test_make_global_batch_shards_on_data_axis():
    mesh = pmesh.make_mesh(4, 2, devices=CPU8)
    B, C = 16, 5
    centers = np.arange(B, dtype=np.int32)
    contexts = np.zeros((B, C), np.int32)
    gc, gx = pdist.make_global_batch(mesh, centers, contexts)
    jc, _ = jdist.make_global_batch(jax_mesh(4, 2), centers, contexts)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(jc))
    assert gx.shape == (B, C)
    with pytest.raises(ValueError, match="data ranks"):
        pdist.make_global_batch(mesh, np.zeros(6, np.int32))


def test_global_batch_feeds_train_steps():
    mesh = pmesh.make_mesh(4, 2, devices=CPU8)
    V, D = 40, 8
    counts = np.arange(V, 0, -1).astype(np.int64)
    eng = EmbeddingEngine(V, D, counts, num_negatives=2, seed=0, mesh=mesh)
    K, B, C = 2, 8, 3
    rng = np.random.default_rng(0)
    ck = rng.integers(0, V, (K, B)).astype(np.int32)
    xk = rng.integers(0, V, (K, B, C)).astype(np.int32)
    mk = (rng.random((K, B, C)) < 0.8).astype(np.float32)
    gck, gxk, gmk = pdist.make_global_batch(mesh, ck, xk, mk, data_axis=1)
    losses = eng.train_steps(gck, gxk, gmk, 0, np.full(K, 0.05, np.float32))
    assert np.all(np.isfinite(losses.numpy()))


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def test_two_process_gang_matches_the_jax_mesh(tmp_path):
    V, D, N, K, B, C = 40, 12, 3, 3, 16, 4
    counts = np.arange(V, 0, -1).astype(np.int64) * 5
    jeng = JaxEngine(jax_mesh(2, 2), V, D, counts, num_negatives=N, seed=1)
    rng = np.random.default_rng(2)
    s0 = np.asarray(jeng.syn0, np.float32)[:V, :D]
    s1 = rng.normal(0, 0.2, (V, D)).astype(np.float32)
    jeng.set_tables(s0, s1)
    centers = rng.integers(0, V, (K, B)).astype(np.int32)
    contexts = rng.integers(0, V, (K, B, C)).astype(np.int32)
    mask = (rng.random((K, B, C)) < 0.8).astype(np.float32)
    alphas = np.array([0.05, 0.04, 0.03], np.float32)
    key = jax.random.PRNGKey(4)
    jl = np.asarray(jeng.train_steps(centers, contexts, mask, key, alphas))
    negs = np.stack([np.asarray(sample_negatives_per_row(
        jax.random.fold_in(key, jnp.uint32(i)), jeng._prob, jeng._alias,
        jnp.arange(B, dtype=jnp.int32), (C, N))) for i in range(K)])
    np.savez(tmp_path / "batch.npz", V=V, D=D, N=N, counts=counts, syn0=s0,
             syn1=s1, centers=centers, contexts=contexts, mask=mask,
             negs=negs, alphas=alphas)
    words = [f"w{i}" for i in range(30)]
    lines = [" ".join(words[j] for j in rng.integers(0, 30, L))
             for L in rng.integers(3, 12, 41)]
    (tmp_path / "corpus.txt").write_text("\n".join(lines) + "\n")
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_gang_worker.py"),
         str(r), port, str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    want = (np.asarray(jeng.syn0, np.float32)[:V, :D],
            np.asarray(jeng.syn1, np.float32)[:V, :D])
    for r in range(2):
        got = np.load(tmp_path / f"engine-{r}.npz")
        np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(got["syn0"][:V, :D], want[0],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["syn1"][:V, :D], want[1],
                                   rtol=1e-5, atol=1e-6)
    fits = [json.load(open(tmp_path / f"fit-{r}.json")) for r in range(2)]
    assert fits[0]["mesh"] == {"data": 2, "model": 2}
    assert fits[0]["full"] == fits[1]["full"] == fits[0]["resumed"] \
        == fits[1]["resumed"]
    assert fits[0]["steps"] == fits[1]["steps"] > 0
    assert np.isfinite(fits[0]["loss"])
    state = json.load(open(tmp_path / "ck" / "train_state.json"))
    assert state["epochs_completed"] == 2
