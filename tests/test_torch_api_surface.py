"""The port's public API surface against the JAX package's.

For each ported class pair the public names (those not starting with
``_``, and the dunder methods such as ``__getitem__``) of the JAX class,
and of one small instance where one is cheap to build, must all exist on
the port's side. For every module of the JAX package, each public
function and class it defines must exist in the port's module of the
same name (:data:`MODULE_RENAMES` and :data:`NAME_RENAMES` map the names
that differ). A name the port lacks stands in :data:`WAITING` with the
reason it has no counterpart. Every parameter name of each such JAX
function, class and public method must be a parameter name of its port
counterpart (``inspect.signature``), but those :data:`KEYWORDS_WAITING`
lists with a reason; an allowlisted name the port gains must leave the
list. The root's ``__all__`` (``__version__`` included) is the JAX
root's or more, and importing the root imports no torch. The word2vec
estimator's fluent setters build the JAX package's ``Word2VecParams``
field by field and refuse what JAX refuses.

Tolerances: names and parameter values compare exactly.
"""

import ast
import importlib
import os

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
    ("corpus.vocab", "Vocabulary"),
    ("corpus.alias", "AliasTable"),
    ("corpus.stream_vocab", "SpaceSavingSketch"),
]

#: Public JAX names the port does not have, by class or module, each
#: with the reason it has no counterpart.
WAITING: dict = {
    "ops.pallas_sgns": {
        "shared_pool_vmem_ok": "a TPU VMEM budget: the CUDA kernel of the "
                               "shared pool stages by shared memory and "
                               "takes every shape",
    },
    "utils.platform": {
        "force_platform": "forces JAX's platform; the port's device.py "
                          "resolves the torch device of every entry point",
    },
}

#: JAX module -> the port's module of the same job.
MODULE_RENAMES = {"ops.pallas_rows": "ops.rows",
                  "ops.pallas_sgns": "ops.fused_sgns"}

#: JAX name -> the port's name of the same function.
NAME_RENAMES = {"train_step_pairs_pallas": "train_step_pairs_fused"}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _classes(module, name):
    j = getattr(importlib.import_module(f"glint_word2vec_tpu.{module}"), name)
    p = getattr(importlib.import_module(f"glint_word2vec_torch.{module}"), name)
    return j, p


def _public(obj) -> set:
    names = {n for n in dir(obj) if not n.startswith("_")}
    if not isinstance(obj, type):
        names |= {n for n in vars(obj) if not n.startswith("_")}
    else:
        names |= {n for k in obj.__mro__[:-1] for n, v in vars(k).items()
                  if n.startswith("__") and n.endswith("__") and callable(v)
                  and n != "__init__"}
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
    for module, names in WAITING.items():
        if module not in JAX_MODULES:
            continue
        port = _port_module(module)
        for attr, reason in names.items():
            assert reason.strip(), (module, attr)
            assert attr in _module_names(module), (module, attr)
            assert port is None or not hasattr(port, NAME_RENAMES.get(attr, attr))


def _jax_modules() -> list:
    out = []
    base = os.path.join(REPO, "glint_word2vec_tpu")
    for root, dirs, files in os.walk(base):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), base)[:-3]
                parts = rel.split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                if parts:
                    out.append(".".join(parts))
    return out


JAX_MODULES = _jax_modules()


def _module_names(module) -> set:
    """Public functions and classes a JAX module defines (by its source,
    so that names it imports from elsewhere are not counted twice)."""
    path = os.path.join(REPO, "glint_word2vec_tpu", *module.split("."))
    path = path + ".py" if os.path.isfile(path + ".py") else os.path.join(
        path, "__init__.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _port_module(module):
    name = MODULE_RENAMES.get(module, module)
    rel = os.path.join(REPO, "glint_word2vec_torch", *name.split("."))
    if not (os.path.isfile(rel + ".py")
            or os.path.isfile(os.path.join(rel, "__init__.py"))):
        return None
    return importlib.import_module(f"glint_word2vec_torch.{name}")


#: Keyword names of a JAX callable that its port counterpart does not
#: take, by ``module:qualified name``, each with the reason.
_TPU_KNOBS = "a Pallas/TPU setting: the CUDA kernel takes every shape and block"
_THREEFRY = ("a threefry key or table of the JAX draws: the port's draws are "
             "its counter hash (ops/random.py), and tests inject draws")
KEYWORDS_WAITING: dict = {
    **{f"ops.pallas_rows:{f}": {"interpret": _TPU_KNOBS,
                                "block_rows": _TPU_KNOBS}
       for f in ("gather_rows", "scatter_add_rank1", "scatter_add_rows")},
    **{f"ops.pallas_sgns:{f}": {"interpret": _TPU_KNOBS,
                                "block_rows": _TPU_KNOBS}
       for f in ("pair_forward", "pair_forward_shared",
                 "scatter_add_rows_f32", "scatter_add_rank1_hbm",
                 "fused_pair_step", "fused_pair_step_shared")},
    "parallel.engine:EmbeddingEngine": {
        "use_pallas": "the TPU's opt-in to the Pallas kernels: on the card "
                      "the hand kernels are the only path"},
    "parallel.engine:EmbeddingEngine.__init__": {
        "use_pallas": "the TPU's opt-in to the Pallas kernels: on the card "
                      "the hand kernels are the only path"},
    "ops.ann:AnnIndex": {"_sharding": "a JAX sharding of the index's "
                                      "arrays: the port keeps them on one "
                                      "torch device"},
    "ops.ann:AnnIndex.__init__": {"_sharding": "a JAX sharding of the "
                                               "index's arrays: the port "
                                               "keeps them on one torch "
                                               "device"},
    "ops.ann:build": {
        "sharding": "a JAX sharding of the index's arrays: the port keeps "
                    "them on one torch device",
        "nprobe_hint": "the JAX body never reads it"},
    "parallel.distributed:initialize": {
        "local_device_ids": "selects a process's TPU chips; a torch process "
                            "names its card by device"},
    "ops.device_batching:device_window_batch": {"rows": _THREEFRY,
                                                "key": _THREEFRY},
    "ops.device_batching:subsample_compact": {"keep_prob": _THREEFRY,
                                              "epoch_key": _THREEFRY},
    "ops.device_batching:pack_window_pairs": {
        "base_key": _THREEFRY, "grid_step0": _THREEFRY,
        "grid_batch": _THREEFRY,
        "span": "the candidate positions, which the injected shrink draws "
                "imply: len(shrink)"},
    "ops.sgns:init_tables": {"key": _THREEFRY},
    **{f"ops.sgns:{f}": {
        "prob": _THREEFRY, "alias": _THREEFRY, "key": _THREEFRY,
        "num_negatives": "the negatives per row, which the injected draws "
                         "imply: negs.shape[-1]"}
       for f in ("train_step", "train_step_pairs", "sgns_loss")},
    "ops.sgns:train_step_pairs_pallas": {
        "prob": _THREEFRY, "alias": _THREEFRY, "key": _THREEFRY,
        "num_negatives": "the negatives per row, which the injected draws "
                         "imply: negs.shape[-1]",
        "interpret": _TPU_KNOBS, "block_rows": _TPU_KNOBS},
    "utils.metrics:TrainingMetrics": {
        "_last_loss_lazy": "a private field of the JAX dataclass (a device "
                           "value read late); the port reads its loss back "
                           "in the fit loop"},
    "utils.metrics:TrainingMetrics.__init__": {
        "_last_loss_lazy": "a private field of the JAX dataclass (a device "
                           "value read late); the port reads its loss back "
                           "in the fit loop"},
    "models.fasttext:FastTextWord2Vec": {
        "kw": "the parameter overrides, which the port names **overrides "
              "as both packages' Word2Vec does"},
    "models.fasttext:FastTextWord2Vec.__init__": {
        "kw": "the parameter overrides, which the port names **overrides "
              "as both packages' Word2Vec does"},
}


def _param_names(obj):
    """Parameter names of a callable (``*args`` aside), or None where
    ``inspect`` cannot read a signature."""
    import inspect

    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [n for n, p in sig.parameters.items()
            if p.kind is not p.VAR_POSITIONAL]


def _callables(module):
    """(qualified name, JAX object, port object) of each public function
    and class a JAX module defines, and of each public method (and
    ``__init__``) those classes define, with its port counterpart."""
    port = _port_module(module)
    jmod = importlib.import_module(f"glint_word2vec_tpu.{module}")
    out = []
    for name in sorted(_module_names(module)):
        pname = NAME_RENAMES.get(name, name)
        if port is None or not hasattr(port, pname):
            continue  # test_module_names_exist_in_the_port reports it
        j, p = getattr(jmod, name), getattr(port, pname)
        out.append((name, j, p))
        if isinstance(j, type):
            for attr, v in vars(j).items():
                if attr.startswith("_") and attr != "__init__":
                    continue
                if isinstance(v, property) or not (
                        callable(v) or isinstance(v, (staticmethod,
                                                      classmethod))):
                    continue
                if hasattr(p, attr):
                    out.append((f"{name}.{attr}", getattr(j, attr),
                                getattr(p, attr)))
    return out


@pytest.mark.parametrize("module", JAX_MODULES)
def test_keyword_names_exist_in_the_port(module):
    missing = []
    for qual, j, p in _callables(module):
        jn, pn = _param_names(j), _param_names(p)
        if jn is None or pn is None:
            continue
        allowed = KEYWORDS_WAITING.get(f"{module}:{qual}", {})
        missing += [f"{qual}({n})" for n in jn
                    if n not in pn and n not in allowed]
    assert missing == []


def test_waiting_keywords_are_still_missing():
    # An allowlisted keyword the port has gained must leave the list.
    by_key = {f"{m}:{q}": (j, p) for m in
              sorted({k.split(":")[0] for k in KEYWORDS_WAITING})
              for q, j, p in _callables(m)}
    for key, names in KEYWORDS_WAITING.items():
        assert key in by_key, key
        j, p = by_key[key]
        for name, reason in names.items():
            assert reason.strip(), (key, name)
            assert name in _param_names(j), (key, name)
            assert name not in _param_names(p), (key, name)


def test_root_exports_every_jax_name():
    import subprocess
    import sys

    import glint_word2vec_tpu

    import glint_word2vec_torch

    assert set(glint_word2vec_tpu.__all__) <= set(glint_word2vec_torch.__all__)
    assert glint_word2vec_torch.__version__ == glint_word2vec_tpu.__version__
    for name in glint_word2vec_torch.__all__:
        assert getattr(glint_word2vec_torch, name) is not None, name
    # The root stays torch-free: the supervisor and the balancer shards
    # import it and must never make a CUDA context.
    code = ("import sys, glint_word2vec_torch as g; g.__version__; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "False", out.stderr


def test_every_jax_module_is_covered():
    assert len(JAX_MODULES) >= 60
    assert {"ops.sgns", "corpus.vocab", "analysis.core",
            "analysis.checkers.sync_point"} <= set(JAX_MODULES)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_names_exist_in_the_port(module):
    port = _port_module(module)
    allowed = set(WAITING.get(module, {}))
    names = _module_names(module) - allowed
    if port is None:
        assert names == set(), f"no port module for {module}"
        return
    missing = sorted(n for n in names
                     if not hasattr(port, NAME_RENAMES.get(n, n)))
    assert missing == []


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
