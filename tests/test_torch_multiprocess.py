"""A real two-process gloo gang of the port on the CPU, through
``python -m glint_word2vec_torch.cli supervise --workers 2 train --exchange
sparse --device cpu`` on ``tiny_corpus``, two epochs, checkpointed:

* both ranks end with bitwise equal tables (each rank's metrics file
  carries its tables' sha256), and each rank wrote only its own row block
  of every checkpoint (its event log names the blocks it wrote);
* a ``kill@`` at ``exchange.pre_send`` in rank 1's first generation is
  detected, the gang relaunches once from the last committed checkpoint
  and ends bitwise equal to the uninterrupted run;
* the gang's model passes the vienna and berlin gates;
* ``transform-file --workers 2`` under the supervisor equals ``--workers
  1`` bitwise.

Each worker runs one intra-op thread (``OMP_NUM_THREADS=1``).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from glint_word2vec_torch import cli
from glint_word2vec_torch.batch.transform import load_transform_output
from glint_word2vec_torch.models import load_model

_TRAIN = ["--device", "cpu", "--exchange", "sparse", "--iterations", "2",
          "--vector-size", "48", "--window", "5", "--step-size", "0.025",
          "--batch-size", "256", "--min-count", "5"]


@pytest.fixture(scope="module")
def gang_runs(tmp_path_factory, tiny_corpus):
    """The uninterrupted gang and the gang killed at its 6th exchange
    round (rank 1, first generation only), as supervisor reports."""
    root = tmp_path_factory.mktemp("gang")
    corpus = root / "c.txt"
    corpus.write_text("".join(" ".join(s) + "\n" for s in tiny_corpus))
    env0 = dict(os.environ)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ.pop("GLINT_FAULTS", None)
    runs = {}
    try:
        for name, extra in (("full", []), ("killed", [
                "--rank-env", "1:GLINT_FAULTS=exchange.pre_send:kill@6"])):
            d = root / name
            report = str(d / "report.json")
            rc = cli.main(["supervise", "--workers", "2", "--report-out", report,
                           "--backoff-base", "0.1", *extra,
                           "train", "--corpus", str(corpus),
                           "--output", str(d / "model"),
                           "--checkpoint-dir", str(d / "ck"),
                           "--metrics-out", str(d / "metrics.json"), *_TRAIN])
            runs[name] = (rc, json.load(open(report)), d)
    finally:
        os.environ.clear()
        os.environ.update(env0)
    return runs


def test_gang_ranks_end_bitwise_equal_and_write_their_blocks(gang_runs):
    rc, report, d = gang_runs["full"]
    assert rc == 0 and report["completed"] and report["restarts"] == 0
    ranks = [json.load(open(d / f"metrics-rank{r}.json")) for r in (0, 1)]
    assert ranks[0]["tables_sha256"] == ranks[1]["tables_sha256"]
    for r, m in enumerate(ranks):
        assert m["rank"] == r and m["world"] == 2
        ex = m["exchange"]
        assert ex["exchange_syncs_total"] > 0 and ex["exchange_bytes_total"] > 0
        assert ex["exchange_world1_skips_total"] == 0
    model = load_model(str(d / "model"), device="cpu")
    per = -(-model.engine.num_rows // 2)
    for r in (0, 1):
        lines = [json.loads(x) for x in open(d / "ck" / "supervisor"
                                             / f"events-{r}.jsonl")]
        files = {e["args"]["file"] for e in lines
                 if e.get("name") == "ckpt_shard_write"}
        assert files == {f"{t}.r{r * per:012d}.npy" for t in ("syn0", "syn1")}
    ck = json.load(open(d / "ck" / "train_state.json"))
    assert ck["epochs_completed"] == 2 and ck["ckpt"] == "ckpt-2"
    assert sorted(f for f in os.listdir(d / "ck" / "ckpt-2")
                  if f.endswith(".npy") and f.startswith("syn")) == sorted(
        f"{t}.r{s:012d}.npy" for t in ("syn0", "syn1") for s in (0, per))


def test_killed_gang_resumes_to_the_uninterrupted_tables(gang_runs):
    rc, report, d = gang_runs["killed"]
    assert rc == 0 and report["completed"] and report["restarts"] == 1
    rec = report["restart_records"][0]
    assert "worker 1 killed by signal SIGKILL" in rec["reason"]
    assert rec["resumed_from"] == "ckpt-1"
    full = load_model(str(gang_runs["full"][2] / "model"), device="cpu")
    back = load_model(str(d / "model"), device="cpu")
    assert torch.equal(full.engine.syn0, back.engine.syn0)
    assert torch.equal(full.engine.syn1, back.engine.syn1)


def test_gang_model_passes_quality_gates(gang_runs):
    m = load_model(str(gang_runs["full"][2] / "model"), device="cpu")
    syns = m.find_synonyms("austria", 10)
    assert "vienna" in dict(syns) and dict(syns)["vienna"] > 0.5, syns
    res = m.analogy(positive=["vienna", "germany"], negative=["austria"], num=10)
    assert "berlin" in [w for w, _ in res], res


def test_transform_workers_two_equals_one(gang_runs, tmp_path, tiny_corpus):
    model = str(gang_runs["full"][2] / "model")
    inp = tmp_path / "s.txt"
    inp.write_text("".join(" ".join(s) + "\n" for s in tiny_corpus[:700]))
    base = ["transform-file", "--model", model, "--input", str(inp),
            "--rows", "64", "--max-len", "16", "--shard-size", "128",
            "--device", "cpu"]
    env0 = dict(os.environ)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        assert cli.main(base + ["--out", str(tmp_path / "one")]) == 0
        assert cli.main(base + ["--out", str(tmp_path / "two"),
                                "--workers", "2"]) == 0
    finally:
        os.environ.clear()
        os.environ.update(env0)
    one = load_transform_output(str(tmp_path / "one"))
    two = np.concatenate([load_transform_output(
        str(tmp_path / "two" / f"rank-{r:04d}")) for r in (0, 1)])
    assert one.shape == (700, 48)
    np.testing.assert_array_equal(one, two)


_GATHER = r"""
import sys
import numpy as np
import torch
from glint_word2vec_torch.parallel import distributed as dist

rank, port = int(sys.argv[1]), sys.argv[2]
dist.initialize(f"127.0.0.1:{port}", 2, rank)
assert (dist.process_index(), dist.process_count()) == (rank, 2)
dist._CHUNK_BYTES = 40  # several chunks in flight, a short last one
g = torch.Generator().manual_seed(rank)
vals = {
    "bf16": torch.randn(33, 7, generator=g).to(torch.bfloat16),
    "f32": torch.randn(5, 3, generator=g),
    "i8": torch.randint(-127, 127, (9,), generator=g, dtype=torch.int8),
}
for name, t in vals.items():
    out = dist.allgather_host(t)
    assert out.dtype == t.dtype and out.shape == (2,) + tuple(t.shape), name
    assert torch.equal(out[rank].view(-1).view(torch.uint8),
                       t.reshape(-1).view(torch.uint8)), name
    torch.save(out, sys.argv[3] + f".{rank}.{name}.pt")
h = dist.allgather_host(np.arange(6, dtype=np.int64) + 10 * rank)
assert isinstance(h, np.ndarray) and h.tolist() == [list(range(6)),
                                                    list(range(10, 16))]
dist.barrier("end")
dist.shutdown()
"""


def test_allgather_host_between_two_processes(tmp_path):
    """``allgather_host`` over a real gloo pair: rank order kept, every
    wire dtype bit for bit (bf16 as its byte view), in chunks, numpy in,
    numpy out."""
    import subprocess
    import sys

    from glint_word2vec_torch.parallel.supervisor import free_port

    script = tmp_path / "gather.py"
    script.write_text(_GATHER)
    port, base = str(free_port()), str(tmp_path / "out")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, base],
                              env=env) for r in (0, 1)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    for name in ("bf16", "f32", "i8"):
        a, b = (torch.load(f"{base}.{r}.{name}.pt") for r in (0, 1))
        assert torch.equal(a.view(torch.uint8) if a.dtype != torch.bfloat16
                           else a.view(torch.int16), b.view(torch.uint8)
                           if b.dtype != torch.bfloat16 else b.view(torch.int16))


_PROTOCOL = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from glint_word2vec_torch.ops import random as rnd
from glint_word2vec_torch.parallel import distributed as dist
from glint_word2vec_torch.parallel import exchange as pex
sys.path.insert(0, sys.argv[4])
import test_torch_multiprocess as t

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.initialize(f"127.0.0.1:{port}", 2, rank)
for name, kw in t.PROTOCOL_CASES:
    eng = t.protocol_engine(rank)
    ex = pex.ReplicaExchanger(eng, transport=pex.ProcessTransport(), **kw)
    for g in range(t.PROTOCOL_GROUPS):
        t.protocol_group(eng, rank, g)
        ex.group_end(live=True, done=g == t.PROTOCOL_GROUPS - 1)
    ex.flush()
    np.save(f"{out}.{name}.{rank}.syn0.npy", eng.syn0.float().numpy())
    np.save(f"{out}.{name}.{rank}.syn1.npy", eng.syn1.float().numpy())
    json.dump(eng.exchange_stats(), open(f"{out}.{name}.{rank}.json", "w"))
dist.barrier("end")
dist.shutdown()
"""

PROTOCOL_GROUPS = 4
PROTOCOL_CASES = [
    ("fp32", dict(mode="sparse", capacity=256)),
    ("bf16_every2", dict(mode="sparse", capacity=256, wire="bf16", every=2)),
    ("int8_every2", dict(mode="sparse", capacity=256, wire="int8", every=2)),
    ("spill", dict(mode="sparse", capacity=8, wire="int8")),
    ("dense", dict(mode="dense")),
    ("twolevel", dict(mode="sparse", capacity=256, wire="int8",
                      topology="twolevel", node_size=1)),
]


def protocol_engine(rank):
    """Rank ``rank``'s replica of the protocol drill: the seed's tables,
    its round-robin shard of a seeded corpus uploaded."""
    from glint_word2vec_torch.parallel import distributed as pdist
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine

    rng = np.random.default_rng(9)
    ids = rng.integers(0, 157, 3000).astype(np.int32)
    offsets = np.arange(0, 3001, 8, dtype=np.int64)
    offsets[-1] = 3000
    eng = EmbeddingEngine(157, 16, rng.integers(1, 100, 157), seed=3,
                          device="cpu")
    eng.upload_corpus(*pdist.shard_flat_for_process(ids, offsets, rank, 2))
    return eng


def protocol_group(eng, rank, g):
    from glint_word2vec_torch.ops import random as rnd

    eng.train_steps_corpus(g * 2 * 64, 64, 3, rnd.fold_in(rnd.seed_key(5), rank),
                           np.full(2, 0.02, np.float32), g * 2)


def test_transported_protocol_equals_in_process_rounds(tmp_path):
    """Two gloo processes running ``ReplicaExchanger.group_end`` over
    ``ProcessTransport`` end bitwise where ``sync_group`` and
    ``flush_group`` leave two in-process replicas on the same training,
    for each wire, coalescing, a capacity that spills, the dense mode and
    the two-level topology; and their byte counters agree."""
    import subprocess
    import sys

    from glint_word2vec_torch.parallel import exchange as pex
    from glint_word2vec_torch.parallel.supervisor import free_port

    here = os.path.dirname(os.path.abspath(__file__))
    script = tmp_path / "protocol.py"
    script.write_text(_PROTOCOL)
    port, out = str(free_port()), str(tmp_path / "r")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(here))
    env.pop("GLINT_EXCHANGE_FORCE_WIRE", None)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, out,
                               here], env=env) for r in (0, 1)]
    assert [p.wait(timeout=240) for p in procs] == [0, 0]
    for name, kw in PROTOCOL_CASES:
        engs = [protocol_engine(r) for r in (0, 1)]
        exs = [pex.ReplicaExchanger(e, **kw) for e in engs]
        every = kw.get("every", 1)
        for g in range(PROTOCOL_GROUPS):
            for r, e in enumerate(engs):
                protocol_group(e, r, g)
            if (g + 1) % every == 0:
                pex.sync_group(exs)
        pex.flush_group(exs)
        for r in (0, 1):
            for tname in ("syn0", "syn1"):
                got = np.load(f"{out}.{name}.{r}.{tname}.npy")
                want = getattr(engs[0], tname).float().numpy()
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {r} {tname}")
            st = json.load(open(f"{out}.{name}.{r}.json"))
            mine = engs[r].exchange_stats()
            if kw.get("topology") == "twolevel":
                # The transported round also counts its level-2 header, as
                # the JAX module's does; the in-process count leaves it out.
                mine["exchange_bytes_total"] += 48 * (
                    mine["exchange_syncs_total"] - mine["exchange_flushes_total"])
            for k in ("exchange_syncs_total", "exchange_bytes_total",
                      "exchange_overflow_total", "exchange_dense_syncs_total",
                      "exchange_intra_bytes_total", "exchange_flushes_total"):
                assert st[k] == mine[k], (name, r, k, st[k], mine[k])
