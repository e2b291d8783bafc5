"""One rank of the two-process mesh gang of tests/test_torch_mesh_gang.py:
``python torch_mesh_gang_worker.py <rank> <port> <workdir>``.

The rank joins a gloo group of two and takes the ("data", "model") =
(2, 2) mesh of ``distributed.make_global_mesh``: one data rank and both
model shards of its own, the data axis across the two processes. It then

* trains its half of ``workdir/batch.npz``'s global batches through
  ``train_steps`` from the tables there, with the negatives there, and
  writes its tables and losses to ``engine-<rank>.npz``;
* fits ``workdir/corpus.txt`` with ``exchange="none"`` for two epochs in
  one call, and for one epoch then a resume from the checkpoint, and
  writes both models' table digests, the step counts and the last loss to
  ``fit-<rank>.json``.

The parent compares the ranks with each other and with the JAX engine.
"""

import json
import os
import sys


def main() -> int:
    rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from glint_word2vec_torch.models.word2vec import Word2Vec
    from glint_word2vec_torch.parallel import distributed as dist
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine

    dist.initialize(f"127.0.0.1:{port}", 2, rank)
    mesh = dist.make_global_mesh(2, 2, devices=["cpu"] * 2)
    assert mesh.shape == {"data": 2, "model": 2}
    b = np.load(os.path.join(workdir, "batch.npz"))
    eng = EmbeddingEngine(int(b["V"]), int(b["D"]), b["counts"], mesh=mesh,
                          num_negatives=int(b["N"]))
    eng.set_tables(b["syn0"], b["syn1"])
    lo, hi = dist.process_batch_slice(mesh)
    B = b["centers"].shape[1]
    rows = slice(int(lo * B), int(hi * B))
    c, x, m, n = dist.make_global_batch(
        mesh, b["centers"][:, rows], b["contexts"][:, rows],
        b["mask"][:, rows], b["negs"][:, rows], data_axis=1)
    losses = eng.train_steps(c, x, m, 0, b["alphas"], 0, negs=n)
    np.savez(os.path.join(workdir, f"engine-{rank}.npz"),
             syn0=eng.logical_table(0).numpy(),
             syn1=eng.logical_table(1).numpy(),
             losses=losses.numpy())

    sents = [line.split() for line in open(os.path.join(workdir, "corpus.txt"))]
    kw = dict(device="cpu", vector_size=8, min_count=1, window=3,
              batch_size=16, num_iterations=2, seed=3, steps_per_call=2,
              num_partitions=2, num_shards=2, layout="dims", exchange="none")
    full = Word2Vec(**kw).fit(sents)
    ck = os.path.join(workdir, "ck")
    Word2Vec(**kw).fit(sents, checkpoint_dir=ck, stop_after_epochs=1)
    resumed = Word2Vec(**kw).fit(sents, checkpoint_dir=ck)
    out = {"full": full.engine.tables_digest(),
           "resumed": resumed.engine.tables_digest(),
           "steps": full.training_metrics["steps"],
           "loss": full.training_metrics["final_loss"],
           "mesh": full.engine.mesh.shape}
    with open(os.path.join(workdir, f"fit-{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
