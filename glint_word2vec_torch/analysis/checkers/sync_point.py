"""sync-point: host<->device synchronization only in blessed seams
(counterpart of ``glint_word2vec_tpu/analysis/checkers/sync_point.py``,
retargeted to torch).

The port's fit loops keep the card fed by confining every device->host
readback to explicit seams: the one-group-deferred harvest, the
checkpoint snapshot, the query surfaces that return host values, the
exchange round. PyTorch syncs implicitly wherever a host value is asked
of a CUDA tensor, so a stray ``loss.item()`` re-serializes the loop: the
device waits on the host again, and every path on the card is host-bound
already. This rule flags, in every torch-importing module of the port,
outside the ``SYNC_SEAMS`` allowlist below:

- ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()``;
- ``.to("cpu")``, ``.to(device="cpu")`` and ``.to(torch.device("cpu"))``;
- ``float()``, ``int()`` and ``bool()`` of a value that is not obviously
  on the host, and ``np.asarray()`` / ``np.array()`` of one;
- ``torch.cuda.synchronize()`` and ``.synchronize()`` on an event or a
  stream;
- the calls that sync to learn their output's size: ``torch.nonzero``,
  ``torch.unique`` (and ``unique_consecutive``), ``masked_select``, the
  one-argument ``torch.where``, and ``repeat_interleave`` whose repeats
  are not a host int and that is given no ``output_size``.

Scope: ``chip_smoke.py`` is exempt by design, as the JAX rule exempts
``bench.py``: a script that measures syncs by design. Its persistence sites stay
covered by atomic-persist.

The heuristic is about *candidate* sites. A value is taken to be on the
host when its expression is a literal, a string, a comparison, rooted in
a ``HOST_ROOTS`` name (``len``, ``os``, ``np``: numpy cannot hold a CUDA
tensor's values), read through a host attribute (``.shape``,
``.numel()``, ``.dtype`` ...), or a local name every binding of which is
such a value, or a parameter annotated as a Python scalar. Anything left
that is host-only gets an inline ``# graftlint: ignore[sync-point]
<why>`` or a baseline note: the audit trail is the feature.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from glint_word2vec_torch.analysis.core import Finding, ModuleCache, checker
from glint_word2vec_torch.analysis.checkers.common import (
    call_name,
    const_str,
    enclosing_map,
    root_name,
)

RULE = "sync-point"

_M = "glint_word2vec_torch/models/word2vec.py::"
_E = "glint_word2vec_torch/parallel/engine.py::"
_X = "glint_word2vec_torch/parallel/exchange.py::"
_A = "glint_word2vec_torch/ops/ann.py::"

#: Blessed harvest/readback seams: "<repo-relative path>::<qualname>"
#: -> why syncing is legal there. A seam blesses everything lexically
#: inside the named function (including nested helpers).
SYNC_SEAMS: Dict[str, str] = {
    # The deferred-readback harvests: group g's scalars are read while
    # group g+1 runs, the one legal fit-loop sync.
    _M + "Word2Vec._fit_corpus_resident.harvest_packed":
        "the one-group-deferred scalar harvest of the packed loop: reads "
        "group g's losses, pair counts and end position while group g+1 "
        "runs (the fused kernels' only host-visible outputs)",
    _M + "Word2Vec._harvest":
        "the host batcher's twin of the deferred harvest: one-group-"
        "lagged loss and word records",
    "glint_word2vec_torch/streaming/trainer.py::StreamTrainer._harvest":
        "the streaming mini-epoch harvest: one dispatched group's result "
        "scalars; the next buffer is uploaded already",
    _E + "DeferredReadback.wait":
        "the deferred readback itself: waits on the group's copy event "
        "and hands over its pinned host buffer, one group after dispatch",
    # Corpus staging and compaction.
    _E + "EmbeddingEngine.upload_corpus":
        "host->device corpus staging; np.asarray here normalizes host "
        "input",
    _E + "EmbeddingEngine.compact_corpus":
        "subsample-compaction readback seam: the n_kept sync is "
        "stall-accounted and prefetch-overlapped",
    _E + "EmbeddingEngine.compacted_offsets":
        "compaction offsets readback: host accounting needs the "
        "compacted offsets once per epoch",
    # Checkpoint and stage-in seams.
    _E + "EmbeddingEngine._snapshot_host":
        "checkpoint harvest seam: device->host copy of tables and counts "
        "before the writer takes them",
    _E + "EmbeddingEngine._upload_rows":
        "stage-in seam, off the request path: each host slice buffer is "
        "reused only after its copy's event, and the last copies are "
        "waited for before the staged table is handed over",
    _E + "EmbeddingEngine._side_stream":
        "stage-in seam: the side stream is drained before its staged "
        "tables are handed over",
    _E + "EmbeddingEngine.tables_digest":
        "digest of the live tables for equality checks (gang ranks, "
        "tests): a whole readback by contract, never on a fit's step",
    # Serving query ops return host values by contract; the dispatch is
    # the sync, coalesced and warmed upstream.
    _E + "EmbeddingEngine.multiply":
        "serving query op: stages the host query vector and returns "
        "host scores by contract",
    _E + "EmbeddingEngine.top_k_cosine":
        "serving query op: returns host (vals, ids) by contract",
    _E + "EmbeddingEngine.top_k_cosine_batch":
        "serving query op: returns host (vals, ids) by contract",
    _E + "EmbeddingEngine.ann_top_k_batch":
        "serving query op: returns host (vals, ids) by contract, the "
        "approximate twin of top_k_cosine_batch",
    _E + "EmbeddingEngine.ann_recall_at_k":
        "recall-gate seam: compares exact and approximate host id sets "
        "at build or refresh time, off the request path",
    _E + "EmbeddingEngine.warmup":
        "warmup seam: one sync after every query shape is built, before "
        "the first request (boot, hot swap)",
    _E + "EmbeddingEngine.warmup_ann":
        "warmup seam of the ANN shapes, as warmup",
    _E + "EmbeddingEngine.train_step_grouped":
        "the one-batch API returns the host loss by contract, as the JAX "
        "engine's train_step_grouped does",
    # The mesh: the gang's data axis and the rows layout's ownership.
    _E + "EmbeddingEngine._gang_exchange":
        "the mesh gang's data-axis wire: gloo carries host tensors, so "
        "the gathered and summed values go to host by design",
    _E + "EmbeddingEngine._owned":
        "a rows-layout model shard compacts the updates it owns: one "
        "host sync a shard and table a step, which the 1 x 1 mesh never "
        "pays (the JAX engine masks them instead, and pays a run per "
        "shard as long as the batch's disowned updates)",
    # The model query and export surface: host numpy out by contract.
    _M + "Word2VecModel._decode_hits":
        "serving surface: decodes device top-k hits into host "
        "(word, score) pairs",
    _M + "Word2VecModel.find_synonyms_vector":
        "model query surface: stages the host query vector, returns "
        "host (word, score) pairs",
    _M + "Word2VecModel.find_synonyms_batch":
        "model query surface: stages host query vectors, returns host "
        "(word, score) pairs",
    _M + "Word2VecModel.transform":
        "model query surface: returns a host vector by contract",
    _M + "Word2VecModel.transform_sentences":
        "model query surface: returns host vectors by contract",
    _M + "Word2VecModel.transform_words":
        "model query surface: returns host vectors by contract",
    _M + "Word2VecModel.transform_packed":
        "bulk-transform hot path: harvests one packed pull_average block "
        "to host vectors by contract, the batch pipeline's only sync",
    _M + "Word2VecModel.get_vectors":
        "model export surface: pulls the table to host by contract",
    _M + "Word2VecModel.to_local":
        "model export surface: materializes a host-numpy local model",
    _M + "LocalWord2VecModel.find_synonyms_vector":
        "local numpy model: every value is already host",
    # ANN index lifecycle seams: builds and incremental re-bucketing run
    # off the request path (boot, the hot-swap staging, promotions).
    _A + "build":
        "index build seam: k-means assignment readbacks and host member "
        "packing, off the request path (boot, hot-swap staging)",
    _A + "assign_rows":
        "the build's k-means assignment readback, called only from the "
        "build and re-bucketing seams",
    _A + "centroid_scores":
        "incremental re-bucket scores of the touched rows, called only "
        "from add_rows",
    _A + "_place_spills":
        "the build's spill placement: host preference lists for the "
        "native placement pass, off the request path",
    _A + "_sync":
        "the build's stage clock: syncs so that each stage's seconds "
        "are the device's, off the request path",
    _A + "add_rows":
        "incremental re-bucket seam: score readback for only the touched "
        "rows (streaming promotions), off the request path",
    _A + "_pack_members":
        "host member packing invoked only from the build seam",
    _A + "_drop_row":
        "host member-layout bookkeeping: slot ids are host numpy ints",
    _A + "remove_rows":
        "host member-layout bookkeeping: freed row ids arrive as host "
        "ints from the engine",
    # Replica-exchange seams: a reconciliation round is a sync point by
    # design; the harvest brings the payload buffers to host for the
    # cross-rank transport, and the round's code moves host values.
    _X + "ReplicaExchanger.harvest":
        "exchange harvest seam: the padded (ids, deltas) buffers and "
        "their counts must reach host for the cross-rank transport",
    _X + "ReplicaExchanger._to_host":
        "the harvest's copy to pinned host memory, waited for before "
        "the transport reads it",
    _X + "ReplicaExchanger._dense_delta":
        "dense/spill harvest seam: the whole per-rank delta is a host "
        "wire payload by definition",
    _X + "ReplicaExchanger.sync":
        "the exchange round itself: a deliberate reconciliation barrier "
        "between dispatch groups (headers and payloads are host)",
    _X + "ReplicaExchanger._twolevel_round":
        "level-1/level-2 legs of the sync seam: node fold and leader "
        "payloads are host wire traffic of the same barrier",
    _X + "_StageClock.seconds":
        "the exchange round's stage clock, read after the round's "
        "barrier",
    _X + "_touched_ids":
        "the round's touched-row ids for the checkpoint's skip-clean "
        "bookkeeping, read at the barrier",
    _X + "decide_dense":
        "reads the round's gathered headers, host after the allgather",
    _X + "sync_group":
        "in-process N-replica exchange loop: the same reconciliation "
        "barrier as ReplicaExchanger.sync",
    _X + "NullTransport.allgather":
        "1-replica transport: wraps an already-host payload",
    _X + "ProcessTransport.allgather":
        "cross-process transport: host arrays by contract",
    # The plain versions of the scatter kernels run only on CPU tensors
    # (their kernels take the CUDA ones): no device to wait on.
    "glint_word2vec_torch/ops/rows.py::_run_sum_table_reference":
        "plain version of the table-dtype scatters: CPU tensors only",
    "glint_word2vec_torch/ops/fused_sgns.py::_run_sum_reference":
        "plain version of the fp32 scatters: CPU tensors only",
    "glint_word2vec_torch/parallel/distributed.py::allgather_host":
        "host-level collective wire of the replica exchange: input and "
        "output are host by contract",
}

#: Expression roots that are host values by construction: calling
#: float()/int() on them synchronizes nothing. ``np``/``numpy`` are here
#: because numpy cannot hold a CUDA tensor (it raises instead of
#: syncing).
HOST_ROOTS = frozenset({
    "os", "time", "len", "sys", "math", "random", "args", "json", "re",
    "str", "repr", "round", "min", "max", "sum", "abs", "sorted", "ord",
    "int", "float", "bool", "env", "environ", "np", "numpy", "range",
    "divmod", "isinstance", "hash", "id",
})

#: Tensor attributes and methods whose value is host metadata.
HOST_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "size", "numel", "dim",
    "nbytes", "itemsize", "element_size", "data_ptr", "is_contiguous",
    "stride", "requires_grad", "layout",
})

#: The readbacks a host value is taken out of a tensor with: their
#: result is on the host (the call itself is flagged).
_READBACKS = ("item", "tolist", "cpu", "numpy")

_SCALAR_ANNOTATIONS = frozenset({"int", "float", "bool", "str"})

_CAST_CALLS = ("float", "int", "bool", "np.asarray", "numpy.asarray",
               "np.array", "numpy.array")

_SIZE_SYNCS = frozenset({
    "torch.nonzero", "torch.unique", "torch.unique_consecutive",
    "torch.masked_select", "torch.argwhere",
})

_SIZE_SYNC_METHODS = frozenset({
    "nonzero", "unique", "unique_consecutive", "masked_select", "argwhere",
})


def _is_host(node: ast.AST, host: Set[str]) -> bool:
    """Is ``node`` obviously a host value (given the host local names)?"""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.JoinedStr, ast.Compare, ast.BoolOp)):
        return True  # strings and Python bools are host values
    if isinstance(node, ast.UnaryOp):
        return _is_host(node.operand, host)
    if isinstance(node, ast.BinOp):
        return _is_host(node.left, host) and _is_host(node.right, host)
    if isinstance(node, ast.IfExp):
        return _is_host(node.body, host) and _is_host(node.orelse, host)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return all(_is_host(e, host) for e in node.elts)
    # Walk the chain: a host attribute or a readback anywhere on it makes
    # the rest host metadata.
    cur = node
    while True:
        if isinstance(cur, ast.Call):
            f = cur.func
            if isinstance(f, ast.Attribute) and f.attr in _READBACKS:
                return True
            cur = f
        elif isinstance(cur, ast.Attribute):
            if cur.attr in HOST_ATTRS:
                return True
            cur = cur.value
        elif isinstance(cur, ast.Subscript):
            cur = cur.value
        else:
            break
    root = root_name(node)
    return root is not None and (root in HOST_ROOTS or root in host)


def _annotated_scalar(ann) -> bool:
    if ann is None:
        return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    names |= {n.value for n in ast.walk(ann)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    return bool(names) and names <= (_SCALAR_ANNOTATIONS | {"Optional", "None"})


def _host_names(fn: ast.AST) -> Set[str]:
    """Local names of ``fn`` (not of its nested functions) whose every
    binding is a host value, and its parameters annotated as Python
    scalars: the greatest fixpoint."""
    bindings: Dict[str, list] = {}

    def bind(target, value):
        if isinstance(target, ast.Name):
            bindings.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if (isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts)):
                for t, v in zip(target.elts, value.elts):
                    bind(t, v)
            else:
                for t in target.elts:
                    bind(t, value)
        elif isinstance(target, ast.Starred):
            bind(target.value, value)

    def rec(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(child, ast.Assign):
                for t in child.targets:
                    bind(t, child.value)
            elif isinstance(child, ast.AnnAssign) and child.value is not None:
                bind(child.target, child.value)
            elif isinstance(child, ast.AugAssign):
                bind(child.target, ast.BinOp(child.target, child.op,
                                             child.value))
            elif isinstance(child, (ast.For, ast.comprehension)):
                it = child.iter
                is_range = (isinstance(it, ast.Call)
                            and call_name(it) in ("range", "enumerate"))
                if is_range and call_name(it) == "range":
                    bind(child.target, ast.Constant(0))
                else:
                    bind(child.target, it)
            elif isinstance(child, ast.withitem) and child.optional_vars:
                bind(child.optional_vars, child.context_expr)
            rec(child)

    rec(fn)
    host = set(bindings)
    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if _annotated_scalar(a.annotation):
                host.add(a.arg)
                bindings.pop(a.arg, None)
    changed = True
    while changed:
        changed = False
        for name, values in bindings.items():
            if name in host and not all(_is_host(v, host) for v in values):
                host.discard(name)
                changed = True
    return host


def _function_scopes(tree: ast.AST) -> Dict[int, ast.AST]:
    """id(node) -> the innermost enclosing function node (or the
    module) of every node."""
    out: Dict[int, ast.AST] = {}

    def rec(node, scope):
        out[id(node)] = scope
        for child in ast.iter_child_nodes(node):
            rec(child, child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope)

    rec(tree, tree)
    return out


def _to_cpu(node: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(device="cpu")``, ``.to(torch.device("cpu"))``."""
    vals = list(node.args[:1]) + [k.value for k in node.keywords
                                  if k.arg == "device"]
    for v in vals:
        if const_str(v) == "cpu":
            return True
        if (isinstance(v, ast.Call) and call_name(v) in ("torch.device",)
                and v.args and const_str(v.args[0]) == "cpu"):
            return True
    return False


def _sync_form(node: ast.Call, host: Set[str]):
    """The message for a sync-inducing call, or None."""
    name = call_name(node) or ""
    f = node.func
    attr = f.attr if isinstance(f, ast.Attribute) else None
    recv = f.value if isinstance(f, ast.Attribute) else None
    if name == "torch.cuda.synchronize" or attr == "synchronize":
        return f"{name or '.synchronize'}() blocks the host until the device drains"
    if attr in _READBACKS and not node.args and not _is_host(recv, host):
        return f".{attr}() reads a possibly-device value back to the host"
    if attr == "to" and _to_cpu(node) and not _is_host(recv, host):
        return ".to('cpu') copies a possibly-device value to the host"
    if name in _CAST_CALLS and node.args:
        if name in ("float", "int", "bool") and (
                len(node.args) != 1 or node.keywords):
            return None  # int(s, 16)-style parses are never syncs
        if _is_host(node.args[0], host):
            return None
        return (f"{name}() on a possibly-device value is an implicit "
                f"sync")
    if name in _SIZE_SYNCS or (name == "torch.where" and len(node.args) == 1):
        return f"{name}() syncs to learn its output's size"
    if (attr in _SIZE_SYNC_METHODS and not name.startswith(("torch.", "np.",
                                                           "numpy."))
            and not _is_host(recv, host)):
        return f".{attr}() syncs to learn its output's size"
    if attr == "repeat_interleave" and not any(
            k.arg == "output_size" for k in node.keywords):
        args = list(node.args)
        if name == "torch.repeat_interleave":
            args = args[1:]
        repeats = args[0] if args else next(
            (k.value for k in node.keywords if k.arg == "repeats"), None)
        if repeats is None or not _is_host(repeats, host):
            return ("repeat_interleave() of device repeats without "
                    "output_size syncs to learn its output's size")
    return None


@checker(RULE,
         "host<->device syncs (.item()/.tolist()/.cpu()/.numpy(), "
         ".to('cpu'), float()/int()/bool() of device values, "
         "synchronize(), size-learning calls) only in the blessed "
         "harvest/readback seams")
def check_sync_point(cache: ModuleCache) -> List[Finding]:
    findings: List[Finding] = []
    for mod in cache.modules():
        if mod.tree is None:
            continue
        if not mod.rel.startswith("glint_word2vec_torch/"):
            continue  # chip_smoke.py measures by syncing: see docstring
        if "torch" not in mod.imports():
            continue
        enclosing = enclosing_map(mod.tree)
        scopes = _function_scopes(mod.tree)
        host_cache: Dict[int, Set[str]] = {}

        def in_seam(node: ast.AST) -> bool:
            qn = enclosing.get(id(node), "")
            while qn:
                if SYNC_SEAMS.get(f"{mod.rel}::{qn}") is not None:
                    return True
                qn = qn.rsplit(".", 1)[0] if "." in qn else ""
            return False

        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            scope = scopes.get(id(node), mod.tree)
            host = host_cache.get(id(scope))
            if host is None:
                host = host_cache[id(scope)] = _host_names(scope)
            msg = _sync_form(node, host)
            if msg is None or in_seam(node):
                continue
            findings.append(mod.finding(
                RULE, node, msg + " outside a blessed seam",
                hint="if the value is host-only, add `# graftlint: "
                     "ignore[sync-point] <why>`; if it is a device value, "
                     "harvest it in a seam (SYNC_SEAMS, with its reason)",
            ))
    return findings
