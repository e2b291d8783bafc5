"""The port's ANN index (glint_word2vec_torch/ops/ann.py and the engine's
ANN hooks) against the JAX package's (glint_word2vec_tpu/ops/ann.py), on
the structured table of tests/test_ann.py: V = 1,024 rows of a
32-centre Gaussian mixture, D = 16, 8 extra rows.

Tolerances: the k-means sweep's centroids within atol 1e-5 (sums of up to
1,024 fp32 terms in another order, then a normalization); the assignment,
the packing and the host masters exactly (the assignment test first
asserts that no row's two best centroids score within 1e-4, so a
mismatch is a fault, not a tie); search ids equal and sims within rtol
1e-5 (d-term fp32 dot products in another order); member blocks after
incremental edits within 1e-6 (copies of table rows). The port's own
builds are bitwise equal to each other."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.ops import ann as jann
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch.convert import ann_index_from_arrays, engine_from_arrays
from glint_word2vec_torch.corpus.vocab import Vocabulary
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.ops import ann as pann
from glint_word2vec_torch.serving import ModelServer
from glint_word2vec_torch.utils.params import Word2VecParams

V, D, EXTRA, TRUE_CLUSTERS = 1024, 16, 8, 32
COUNTS = np.arange(V, 0, -1, dtype=np.int64) + 4


def _structured_rows(num_rows, seed=0, spread=0.25, clusters=TRUE_CLUSTERS):
    """The mixture-of-Gaussians table of tests/test_ann.py."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, D)).astype(np.float32)
    return (
        centers[rng.integers(0, clusters, num_rows)]
        + spread * rng.standard_normal((num_rows, D)).astype(np.float32)
    )


def _full(pts):
    return np.concatenate([pts, np.zeros((EXTRA, D), np.float32)])


def _port_engine(pts, seed=1):
    full = _full(pts)
    return engine_from_arrays(full, np.zeros_like(full), COUNTS, device="cpu",
                              seed=seed)


def _jax_engine(pts, seed=1):
    eng = JaxEngine(make_mesh(1, 1), V, D, COUNTS, seed=seed, extra_rows=EXTRA)
    full = _full(pts)
    eng.set_tables(full, np.zeros_like(full))
    return eng


@pytest.fixture(scope="module")
def pair():
    """A JAX engine with its built index and a port engine holding the same
    tables and, carried across, the same index."""
    pts = _structured_rows(V)
    je, pe = _jax_engine(pts), _port_engine(pts)
    je.configure_ann(nprobe=8)
    pe.configure_ann(nprobe=8)
    je.adopt_ann(je.ann_build())
    pe.adopt_ann(ann_index_from_arrays(je.ann_index, device="cpu"))
    yield je, pe, pts
    je.destroy()
    pe.destroy()


@pytest.fixture(scope="module")
def own():
    """A port engine with the index the port builds itself."""
    pts = _structured_rows(V)
    pe = _port_engine(pts)
    pe.configure_ann(nprobe=8)
    pe.adopt_ann(pe.ann_build())
    pe.warmup_ann()
    yield pe, pts
    pe.destroy()


def _model(eng):
    vocab = Vocabulary.from_sorted([f"w{i}" for i in range(V)], COUNTS)
    return Word2VecModel(vocab, eng, Word2VecParams(vector_size=D))


def _unit(x):
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x * np.where(n > 0, 1.0 / np.where(n > 0, n, 1.0), 0.0)


def _min_top2_margin(x, cent):
    s = np.sort(_unit(x.astype(np.float64)) @ cent.astype(np.float64).T, axis=1)
    return float((s[:, -1] - s[:, -2]).min())


# ----------------------------------------------------------------------
# Geometry, sweep, assignment, packing
# ----------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 2, 3, 15, 16, 17, 100, 1032, 65_536,
                                  1_000_000, 1_000_001, 3_000_000])
def test_auto_clusters_and_member_slots_equal_jax(rows):
    C = pann.auto_clusters(rows)
    assert C == jann.auto_clusters(rows)
    for c in (C, 4, 64, 1024):
        assert pann.member_slots(rows, c) == jann.member_slots(rows, c)
    assert (pann.ASSIGN_BLOCK, pann.INCREMENTAL_BLOCK, pann.SLOT_FACTOR) == (
        jann.ASSIGN_BLOCK, jann.INCREMENTAL_BLOCK, jann.SLOT_FACTOR)


def test_kmeans_sweep_matches_jax_and_empty_clusters_keep_theirs():
    pts = _structured_rows(V)
    S, C = pann.ASSIGN_BLOCK, 64
    xn = np.zeros((S, D), np.float32)
    xn[:V] = _unit(pts)
    w = np.zeros(S, np.float32)
    w[:V] = 1.0
    # The true centres (the first draw of _structured_rows' generator),
    # perturbed, and 32 centroids no sample row prefers.
    centers = np.random.default_rng(0).standard_normal(
        (TRUE_CLUSTERS, D)).astype(np.float32)
    init = np.zeros((C, D), np.float32)
    init[:32] = _unit(centers + 0.3)
    init[32:] = -_unit(np.abs(np.random.default_rng(3).standard_normal(
        (32, D))).astype(np.float32) + 4.0)
    assert _min_top2_margin(pts, init) > 1e-4
    got = pann.kmeans_sweep(torch.from_numpy(xn), torch.from_numpy(w),
                            torch.from_numpy(init)).numpy()
    want = np.asarray(jann._kmeans_sweep_fn(S, C, D)(xn, w, init))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    scores = _unit(pts) @ init.T
    empty = np.setdiff1d(np.arange(C), np.argmax(scores, axis=1))
    assert empty.size > 0
    np.testing.assert_array_equal(got[empty], init[empty])


def test_assignment_matches_jax_given_its_centroids():
    # 64 true centres for the 64 clusters: no row sits near a boundary
    # between two centroids of one split centre.
    pts = _structured_rows(V, clusters=64)
    je, pe = _jax_engine(pts), _port_engine(pts)
    je.configure_ann(nprobe=8)
    cent = np.array(je.ann_build().centroids)
    assert _min_top2_margin(pts, cent) > 1e-4
    ids = np.arange(V, dtype=np.int32)
    want = np.asarray(jann._assign_fn(pann.ASSIGN_BLOCK, cent.shape[0], D)(
        je.syn0, je.norms(),
        np.concatenate([ids, np.zeros(pann.ASSIGN_BLOCK - V, np.int32)]), cent,
    ))[:V]
    got = pann.assign_rows(pe.syn0, pe.norms(), ids, torch.from_numpy(cent))
    np.testing.assert_array_equal(got, want)
    je.destroy()
    pe.destroy()


def _pack_both(assign, inv, live_ids, C, L, pref):
    a = jann._pack_members(assign, inv, live_ids, C, L, lambda ids: pref[ids])
    b = pann._pack_members(assign, inv, live_ids, C, L, lambda ids: pref[ids])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    return b


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("case", ["census", "spill", "heavy", "heavy-deep"])
def test_pack_members_bitwise(case, route, monkeypatch):
    from glint_word2vec_torch import native

    if route == "python":
        monkeypatch.setenv("GLINT_W2V_NO_NATIVE", "1")
    elif native.get_lib() is None:
        pytest.skip("the native host pass does not build here")
    calls = native.calls["ann_place_spills"]
    rng = np.random.default_rng(7)
    if case == "census":
        n, C, L = 1000, 64, 32
        assign = rng.integers(0, C, n).astype(np.int32)
    elif case == "spill":
        # Every row claims cluster 0: everything past its slots spills.
        n, C, L = 64, 8, 16
        assign = np.zeros(n, np.int32)
    else:
        # A skewed census (a poorly clustered table): most clusters
        # overflow, the spill rounds fill them one after another, and
        # late rows find their first candidates full. "heavy-deep" keeps
        # 2 candidates a row in rounds of 64, so rows take their whole
        # preference order.
        n, C, L = 7800, 64, 128
        assign = np.minimum(rng.zipf(1.3, n) - 1, C - 1).astype(np.int32)
        if case == "heavy-deep":
            monkeypatch.setattr(pann, "SPILL_CANDIDATES", 2)
            monkeypatch.setattr(pann, "SPILL_ROUND", 64)
    live_ids = np.sort(rng.choice(2 * n, n, replace=False)).astype(np.int32)
    inv = rng.random(n).astype(np.float32) + 0.5
    pref = rng.standard_normal((2 * n, C)).astype(np.float32)
    members, invn, fill, cluster_of, slot_of, n_spill = _pack_both(
        assign, inv, live_ids, C, L, pref)
    assert fill.sum() == n
    if case == "spill":
        assert n_spill == n - L
    if case.startswith("heavy"):
        assert n_spill > n // 2 and (fill == L).sum() > C // 2
    placed_natively = native.calls["ann_place_spills"] > calls
    assert placed_natively == (route == "native" and n_spill > 0)
    live = members[invn > 0]
    assert len(set(live.tolist())) == n == live.size


# ----------------------------------------------------------------------
# Search on the carried-across index
# ----------------------------------------------------------------------


@pytest.mark.parametrize("nprobe", [1, 8, "C"])
@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("Q", [1, 5, 16, 20])
def test_search_matches_jax(pair, Q, k, nprobe):
    je, pe, pts = pair
    p = je.ann_index.clusters if nprobe == "C" else nprobe
    q = pts[100 : 100 + Q] + 0.01
    jv, ji = je.ann_top_k_batch(q, k, p)
    pv, pi = pe.ann_top_k_batch(q, k, p)
    assert pv.shape == jv.shape == (Q, k)
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(pv), finite)
    np.testing.assert_array_equal(pi[finite], np.asarray(ji)[finite])
    np.testing.assert_allclose(pv[finite], jv[finite], rtol=1e-5, atol=0)


@pytest.mark.parametrize("nprobe", [8, "C"])
def test_search_matches_jax_below_a_queryable_bound(pair, nprobe):
    je, pe, pts = pair
    p = je.ann_index.clusters if nprobe == "C" else nprobe
    bound = V - 300
    q = pts[V - 320 : V - 300]
    jv, ji = je.ann_top_k_batch(q, 10, p, queryable=bound)
    pv, pi = pe.ann_top_k_batch(q, 10, p, queryable=bound)
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(pv), finite)
    np.testing.assert_array_equal(pi[finite], np.asarray(ji)[finite])
    np.testing.assert_allclose(pv[finite], jv[finite], rtol=1e-5, atol=0)
    assert (pi[finite] < bound).all()


def _masters(idx):
    return (idx.members_np, idx.invn_np, idx.fill, idx.cluster_of,
            idx.slot_of, idx.updated_rows)


def test_incremental_edits_match_jax():
    """add_rows, remove_rows and update_rows with the same edits and the
    same norms give identical host masters and member blocks."""
    pts = _structured_rows(V)
    je, pe = _jax_engine(pts), _port_engine(pts)
    je.configure_ann(nprobe=8)
    ji = je.ann_build()
    pi = ann_index_from_arrays(ji, device="cpu")
    # New values for some rows (moved to another true cluster), rows freed,
    # then extra rows written and added.
    rng = np.random.default_rng(11)
    edited = pts.copy()
    moved = np.array([3, 70, 71, 500, 1023])
    edited[moved] = edited[rng.permutation(V)[: moved.size]] + 0.01
    full = _full(edited)
    full[V : V + 3] = edited[[9, 99, 999]] * 1.5
    je.set_tables(full, np.zeros_like(full))
    pe.set_tables(full, np.zeros_like(full))
    norms_j = je.norms()
    norms_p = torch.from_numpy(np.asarray(norms_j)[: V + EXTRA].copy())
    steps = [
        ("update_rows", moved), ("remove_rows", np.array([5, 6, 70, 1000])),
        ("add_rows", np.arange(V, V + 3)), ("update_rows", np.array([6, 7])),
    ]
    for name, ids in steps:
        if name == "remove_rows":
            nj = jann.remove_rows(ji, je.syn0, ids)
            np_ = pann.remove_rows(pi, pe.syn0, ids)
        else:
            nj = getattr(jann, name)(ji, je.syn0, norms_j, ids)
            np_ = getattr(pann, name)(pi, pe.syn0, norms_p, ids)
        assert nj == np_, name
        for a, b in zip(_masters(ji), _masters(pi)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        np.testing.assert_allclose(pi.member_rows.numpy(),
                                   np.asarray(ji.member_rows)[..., :D],
                                   atol=1e-6, rtol=0)
    assert pi.cluster_of[70] == pi.cluster_of[5] == -1
    assert (pi.cluster_of[V : V + 3] >= 0).all() and pi.cluster_of[6] >= 0
    je.destroy()
    pe.destroy()


# ----------------------------------------------------------------------
# The port's own build
# ----------------------------------------------------------------------


def test_own_build_every_live_row_once(own):
    pe, _ = own
    idx = pe.ann_index
    live = idx.members_np[idx.invn_np > 0]
    assert live.size == V and len(set(live.tolist())) == V
    assert (idx.cluster_of[:V] >= 0).all()
    for rid in (0, 17, V - 1):
        assert idx.members_np[idx.cluster_of[rid], idx.slot_of[rid]] == rid


def test_own_build_all_clusters_equals_exact(own):
    pe, pts = own
    q = pts[:8]
    sims_a, ids_a = pe.ann_top_k_batch(q, 10, nprobe=pe.ann_index.clusters)
    sims_e, ids_e = pe.top_k_cosine_batch(q, 10)
    np.testing.assert_array_equal(ids_a, ids_e)
    np.testing.assert_allclose(sims_a, sims_e, rtol=1e-5, atol=1e-6)


def test_own_build_recall_passes_gate_and_tracks_jax(own):
    pe, pts = own
    je = _jax_engine(pts)
    je.configure_ann(nprobe=8)
    je.adopt_ann(je.ann_build())
    recall = pe.ann_recall_at_k(10, sample=64)
    assert recall >= 0.95, recall
    assert abs(recall - je.ann_recall_at_k(10, sample=64)) <= 0.02
    je.destroy()


def test_own_builds_bitwise_equal(own):
    pe, _ = own
    a, b = pe.ann_build(), pe.ann_build()
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.member_rows, b.member_rows)
    for x, y in zip(_masters(a), _masters(b)):
        np.testing.assert_array_equal(x, y)
    assert set(a.build_parts) == {"sample_seconds", "sweep_seconds",
                                  "assign_seconds", "pack_seconds",
                                  "blocks_seconds"}


def test_warmed_family_adds_no_shape(own):
    pe, pts = own
    before = pe.query_compiles
    for Q in (1, 2, 5, 8, 16, 23, 40):
        pe.ann_top_k_batch(pts[:Q], 10)
    assert pe.query_compiles == before
    keep = pe.ann_index
    pe.adopt_ann(pe.ann_build())
    pe.ann_top_k_batch(pts[:7], 12)
    assert pe.query_compiles == before
    pe.adopt_ann(keep)


def test_build_from_staged_arrays_leaves_live_state_untouched():
    pts = _structured_rows(V)
    pe = _port_engine(pts)
    pe.configure_ann(nprobe=8)
    live_idx = pe.ann_build()
    pe.adopt_ann(live_idx)
    syn0_before = pe.syn0.clone()
    masters_before = [np.copy(x) for x in _masters(live_idx)[:5]]
    version = pe.table_version
    staged = torch.from_numpy(_full(_structured_rows(V, seed=9)))
    idx = pe.ann_build(syn0=staged)
    assert torch.equal(pe.syn0, syn0_before) and pe.table_version == version
    assert pe.ann_index is live_idx
    for a, b in zip(masters_before, _masters(live_idx)[:5]):
        np.testing.assert_array_equal(a, b)
    # The staged index holds the staged rows.
    c, s = idx.cluster_of[5], idx.slot_of[5]
    assert torch.equal(idx.member_rows[c, s], staged[5])
    recall = pe.ann_recall_at_k(10, sample=32, index=idx, syn0=staged)
    assert recall >= 0.9, recall
    pe.destroy()


def test_write_rows_rebuckets_only_touched_rows():
    pts = _structured_rows(V)
    pe = _port_engine(pts)
    pe.configure_ann(nprobe=8)
    pe.adopt_ann(pe.ann_build())
    idx = pe.ann_index
    before = idx.cluster_of.copy()
    updated = idx.updated_rows
    # Rows 10..12 take the values of rows in other true clusters.
    src = [400, 401, 402]
    pe.write_rows(10, pts[src] * 1.01)
    changed = set(np.flatnonzero(idx.cluster_of != before).tolist())
    assert changed <= {10, 11, 12}
    assert idx.updated_rows == updated + 3
    assert idx.table_version == pe.table_version
    _, ids = pe.ann_top_k_batch(pts[src[:1]] * 1.01, 3)
    assert ids[0, 0] == 10
    pe.destroy()


def test_oversized_k_takes_the_exact_route(own):
    pe, pts = own
    cap = pe._ann_conf["nprobe"] * pe.ann_index.slots
    with pytest.raises(ValueError, match="probe capacity"):
        pe.ann_top_k_batch(pts[:2], cap + 1)
    model = _model(pe)
    big = min(cap + 10, V)
    approx = model.find_synonyms_batch(pts[:1], big, approximate=True)
    exact = model.find_synonyms_batch(pts[:1], big)
    assert [w for w, _ in approx[0]] == [w for w, _ in exact[0]]


def test_sparse_probe_returns_no_filler(own):
    pe, pts = own
    model = _model(pe)
    k = pe.ann_index.slots - 2
    vals, ids = pe.ann_top_k_batch(pts[:2], k, nprobe=1)
    assert (~np.isfinite(vals)).any(), "expected filler in the raw output"
    rows = [model._decode_hits(v, i) for v, i in zip(vals, ids)]
    for row in rows:
        assert all(np.isfinite(s) for _, s in row), row
        json.dumps(row)
    assert any(len(row) < k for row in rows)


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------


def _post(server, path, payload):
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(server, path):
    with urllib.request.urlopen(
        f"http://{server.host}:{server.port}{path}", timeout=30
    ) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def ann_server():
    model = _model(_port_engine(_structured_rows(V), seed=4))
    server = ModelServer(model, port=0, max_batch=16, cache_size=1024,
                         ann=True, ann_nprobe=8, ann_recall_sample=48)
    server.start_background()
    yield server, model
    server.stop()
    model.stop()


def test_serving_ann_gate_and_healthz(ann_server):
    server, model = ann_server
    h = _get(server, "/healthz")
    assert h["ann_enabled"] is True and h["ann_recall_gate_ok"] is True
    assert h["post_warmup_compiles"] == 0
    assert h["index"]["enabled"] and h["index"]["nprobe"] == 8
    assert h["index"]["recall_at10"] >= 0.95
    assert h["index"]["clusters"] == model.engine.ann_index.clusters


def test_serving_exact_escape_hatch(ann_server):
    server, model = ann_server
    code, approx = _post(server, "/synonyms", {"word": "w7", "num": 5})
    code2, exact = _post(server, "/synonyms",
                         {"word": "w7", "num": 5, "exact": True})
    assert code == code2 == 200
    assert [w for w, _ in approx] == [w for w, _ in exact]
    assert exact == [[w, s] for w, s in model.find_synonyms("w7", 5)]
    code, vexact = _post(server, "/synonyms_vector", {
        "vector": model.transform("w7").tolist(), "num": 4, "exact": True})
    assert code == 200 and vexact[0][0] == "w7"
    idx = _get(server, "/healthz")["index"]
    assert idx["exact_fallbacks"]["requested"] >= 2
    assert idx["ann_queries_total"] >= 1
    assert _get(server, "/healthz")["post_warmup_compiles"] == 0


def test_serving_cache_keys_are_mode_scoped(ann_server):
    server, _ = ann_server
    _post(server, "/synonyms", {"word": "w9", "num": 4})
    hits0 = _get(server, "/healthz")["coalescer"]["cache_hits"]
    _post(server, "/synonyms", {"word": "w9", "num": 4, "exact": True})
    assert _get(server, "/healthz")["coalescer"]["cache_hits"] == hits0
    _post(server, "/synonyms", {"word": "w9", "num": 4})
    assert _get(server, "/healthz")["coalescer"]["cache_hits"] == hits0 + 1


def test_failing_recall_gate_holds_the_exact_path():
    model = _model(_port_engine(_structured_rows(V), seed=5))
    server = ModelServer(model, port=0, max_batch=8, ann=True,
                         ann_recall_gate=1.01, ann_recall_sample=16)
    server.start_background()
    try:
        h = _get(server, "/healthz")
        assert h["ann_enabled"] is False and h["ann_recall_gate_ok"] is False
        code, hits = _post(server, "/synonyms", {"word": "w1", "num": 3})
        assert code == 200
        assert hits == [[w, s] for w, s in model.find_synonyms("w1", 3)]
        fb = _get(server, "/healthz")["index"]["exact_fallbacks"]
        assert fb["gate"] >= 1 and fb["requested"] == 0
        assert _get(server, "/healthz")["index"]["ann_queries_total"] == 0
        code, _ = _post(server, "/synonyms",
                        {"word": "w2", "num": 3, "exact": True})
        assert code == 200
        fb2 = _get(server, "/healthz")["index"]["exact_fallbacks"]
        assert fb2["requested"] == 1 and fb2["gate"] == fb["gate"]
    finally:
        server.stop()
        model.stop()
