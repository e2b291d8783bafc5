"""The port's public API surface against the JAX package's.

For each ported class pair the public names (those not starting with
``_``) of the JAX class, and of one small instance where one is cheap to
build, must all exist on the port's side, or stand in :data:`WAITING`
with the item of the port's queue that brings them (ROADMAP.md, Queue A)
or the reason they have no counterpart. The word2vec estimator's fluent
setters build the JAX package's ``Word2VecParams`` field by field and
refuse what JAX refuses.

Tolerances: names and parameter values compare exactly.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

#: (module under both packages, class name).
PAIRS = [
    ("models.word2vec", "Word2Vec"),
    ("models.word2vec", "Word2VecModel"),
    ("models.fasttext", "FastTextWord2Vec"),
    ("parallel.engine", "EmbeddingEngine"),
    ("utils.metrics", "TrainingMetrics"),
    ("utils.metrics", "ServingMetrics"),
    ("obs.heartbeat", "TrainingStatus"),
    ("obs.events", "EventRecorder"),
    ("serving", "ModelServer"),
    ("serving", "SnapshotWatcher"),
    ("streaming.trainer", "StreamTrainer"),
    ("parallel.exchange", "ReplicaExchanger"),
    ("parallel.supervisor", "Supervisor"),
    ("compat", "ServerSideGlintWord2Vec"),
    ("compat", "ServerSideGlintWord2VecModel"),
    ("serving", "ModelCatalog"),
    ("serving", "ServedModel"),
    ("fleet", "LoadBalancer"),
    ("fleet", "ReplicaBreaker"),
    ("fleet", "RolloutCoordinator"),
    ("fleet", "ReplicaHoldLedger"),
    ("fleet", "FleetSupervisor"),
    ("fleet", "QosGate"),
    ("fleet", "Autoscaler"),
    ("fleet", "BalancerShardManager"),
    ("obs.aggregate", "GangStatusServer"),
]

ITEM3 = "Queue A item 3: the SPMD mesh (one program across several cards)"
TPU_ONLY = "TPU-only: the row width padded to a multiple of 128 lanes"

#: Public JAX names the port does not have, with what they wait for.
WAITING = {
    "EmbeddingEngine": {
        "mesh": ITEM3,
        "num_data": ITEM3,
        "num_model": ITEM3,
        "rows_per_shard": ITEM3,
        "cols_per_shard": ITEM3,
        "layout": ITEM3,
        "padded_dim": TPU_ONLY,
    },
    "Word2Vec": {"mesh": ITEM3},
    "FastTextWord2Vec": {"mesh": ITEM3},
}


def _classes(module, name):
    j = getattr(importlib.import_module(f"glint_word2vec_tpu.{module}"), name)
    p = getattr(importlib.import_module(f"glint_word2vec_torch.{module}"), name)
    return j, p


def _public(obj) -> set:
    names = {n for n in dir(obj) if not n.startswith("_")}
    if not isinstance(obj, type):
        names |= {n for n in vars(obj) if not n.startswith("_")}
    return names


def _missing(jax_obj, port_obj, cls_name) -> list:
    allowed = WAITING.get(cls_name, {})
    return sorted(_public(jax_obj) - _public(port_obj) - set(allowed))


@pytest.mark.parametrize("module,name", PAIRS, ids=[n for _, n in PAIRS])
def test_class_names_exist_in_the_port(module, name):
    j, p = _classes(module, name)
    assert _missing(j, p, name) == []


def test_waiting_names_are_still_missing():
    # An allowlisted name the port has gained must leave the list.
    for module, name in PAIRS:
        j, p = _classes(module, name)
        for attr in WAITING.get(name, {}):
            assert not hasattr(p, attr), (name, attr)


V, D = 40, 8


@pytest.fixture(scope="module")
def instances():
    """One small instance a side of the classes that are cheap to build."""
    from glint_word2vec_tpu.corpus.vocab import Vocabulary as JaxVocab
    from glint_word2vec_tpu.models.word2vec import Word2VecModel as JaxModel
    from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
    from glint_word2vec_tpu.parallel.mesh import make_mesh
    from glint_word2vec_tpu.serving import ModelServer as JaxServer
    from glint_word2vec_tpu.serving import SnapshotWatcher as JaxWatcher
    from glint_word2vec_tpu.utils.params import Word2VecParams as JaxParams

    from glint_word2vec_torch.convert import engine_from_arrays, model_from_arrays
    from glint_word2vec_torch.serving import ModelServer, SnapshotWatcher
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
    jserver = JaxServer(jmodel, port=0, warmup=False)
    pserver = ModelServer(pmodel, port=0, warmup=False)
    out = {"EmbeddingEngine": (jeng, engine_from_arrays(s0, s0, counts,
                                                        device="cpu")),
           "Word2VecModel": (jmodel, pmodel),
           "ModelServer": (jserver, pserver),
           "SnapshotWatcher": (JaxWatcher(jserver, "."),
                               SnapshotWatcher(pserver, ".")),
           "ModelCatalog": (jserver.catalog, pserver.catalog),
           "ServedModel": (jserver.catalog.default, pserver.catalog.default)}
    jfleet, pfleet = (importlib.import_module(f"{pkg}.fleet") for pkg in
                      ("glint_word2vec_tpu", "glint_word2vec_torch"))
    lbs = tuple(f.LoadBalancer(["http://127.0.0.1:9"], port=0)
                for f in (jfleet, pfleet))
    out["LoadBalancer"] = lbs
    out["RolloutCoordinator"] = tuple(
        f.RolloutCoordinator(lb, ".") for f, lb in zip((jfleet, pfleet), lbs))
    out["ReplicaHoldLedger"] = tuple(
        f.ReplicaHoldLedger(print, print) for f in (jfleet, pfleet))
    out["FleetSupervisor"] = tuple(
        f.FleetSupervisor("m") for f in (jfleet, pfleet))
    for module, name in (("utils.metrics", "TrainingMetrics"),
                         ("utils.metrics", "ServingMetrics"),
                         ("obs.heartbeat", "TrainingStatus"),
                         ("obs.events", "EventRecorder"),
                         ("models.word2vec", "Word2Vec"),
                         ("models.fasttext", "FastTextWord2Vec"),
                         ("compat", "ServerSideGlintWord2Vec"),
                         ("fleet", "ReplicaBreaker")):
        j, p = _classes(module, name)
        out[name] = (j(), p())
    yield out
    # Never started: close the sockets without a serve loop to stop.
    jserver._httpd.server_close()
    pserver._httpd.server_close()
    for lb in lbs:
        lb.stop()
    jmodel.stop()
    pmodel.stop()


INSTANCE_NAMES = ["EmbeddingEngine", "Word2VecModel", "ModelServer",
                  "SnapshotWatcher", "TrainingMetrics", "ServingMetrics",
                  "TrainingStatus", "EventRecorder", "Word2Vec",
                  "FastTextWord2Vec", "ServerSideGlintWord2Vec",
                  "ModelCatalog", "ServedModel", "LoadBalancer",
                  "ReplicaBreaker", "RolloutCoordinator", "ReplicaHoldLedger",
                  "FleetSupervisor"]


@pytest.mark.parametrize("name", INSTANCE_NAMES)
def test_instance_names_exist_in_the_port(instances, name):
    j, p = instances[name]
    assert _missing(j, p, name) == []


SETTER_VALUES = {
    "set_exchange": ["sparse", "dense", "none"],
    "set_exchange_capacity": [0, 4096],
    "set_exchange_wire": ["fp32", "bf16", "int8"],
    "set_exchange_every": [1, 4],
    "set_exchange_topology": ["flat", "twolevel"],
    "set_exchange_shard": ["roundrobin", "locality"],
}

SETTER_BAD = {
    "set_exchange": "ring",
    "set_exchange_capacity": -1,
    "set_exchange_wire": "fp16",
    "set_exchange_every": 0,
    "set_exchange_topology": "tree",
    "set_exchange_shard": "random",
}


@pytest.mark.parametrize("setter", sorted(SETTER_VALUES))
def test_exchange_setters_build_the_jax_params(setter):
    import dataclasses

    from glint_word2vec_tpu import Word2Vec as JaxWord2Vec

    from glint_word2vec_torch import Word2Vec

    for value in SETTER_VALUES[setter]:
        est = Word2Vec()
        assert getattr(est, setter)(value) is est
        jest = getattr(JaxWord2Vec(), setter)(value)
        assert dataclasses.asdict(est.params) == dataclasses.asdict(jest.params)
    with pytest.raises(ValueError):
        getattr(JaxWord2Vec(), setter)(SETTER_BAD[setter])
    with pytest.raises(ValueError):
        getattr(Word2Vec(), setter)(SETTER_BAD[setter])


def test_set_exchange_sparse_returns_the_estimator():
    from glint_word2vec_torch import FastTextWord2Vec, Word2Vec

    est = Word2Vec()
    assert est.set_exchange("sparse") is est
    assert est.params.exchange == "sparse"
    ft = FastTextWord2Vec()
    assert ft.set_exchange("dense").set_exchange_wire("int8") is ft
    assert (ft.params.exchange, ft.params.exchange_wire) == ("dense", "int8")
