"""graftlint for the port (glint_word2vec_torch/analysis) against the JAX
package's graftlint (glint_word2vec_tpu/analysis).

* The framework-neutral rules (``fault-point``, ``span-registry``,
  ``atomic-persist``, ``lock-discipline``, ``prom-consistency``) and the
  suppression and baseline mechanics: each fixture of
  ``tests/test_analysis.py`` (and a span-registry fixture) is written
  under the JAX package's paths for its linter and under the port's paths
  for the port's, and both must report the same ``(rule, line)`` set.
* ``sync-point`` and ``table-tick`` are retargeted to torch: fixtures in
  torch idiom state their expected findings, one case for each flagged
  form and for each blessed form.
* The gate: ``--check-baseline`` exits 0 on the repo with ``jax``,
  ``torch`` and ``numpy`` not importable, in under 30 s; every baseline
  note is non-empty; ``--list-rules`` prints seven rules; an unknown rule
  is a usage error.

Tolerance: findings compare exactly. The analysis package imports only
the standard library, so this file imports neither torch nor numpy.
"""

import ast
import os
import subprocess
import sys
import textwrap
import time

import pytest

import glint_word2vec_tpu.analysis.checkers  # noqa: F401  (registers the rules)
from glint_word2vec_tpu.analysis import baseline as jbl
from glint_word2vec_tpu.analysis import core as jcore

import glint_word2vec_torch.analysis.checkers  # noqa: F401
from glint_word2vec_torch.analysis import baseline as pbl
from glint_word2vec_torch.analysis import core as pcore
from glint_word2vec_torch.analysis.checkers.common import walk_functions
from glint_word2vec_torch.analysis.checkers.sync_point import SYNC_SEAMS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(root, files):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))


def _port_rel(rel):
    for a, b in (("glint_word2vec_tpu/", "glint_word2vec_torch/"),
                 ("scripts/", "glint_word2vec_torch/scripts_/")):
        if rel.startswith(a):
            return b + rel[len(a):]
    return rel


def run_both(tmp_path, files, rules):
    """Run the JAX linter on ``files`` and the port's on the same sources
    under the port's paths; return, for each, its ``(rule, line, file
    name)`` set and its count of suppressed findings."""
    out = []
    for core, name, mapper in ((jcore, "jax", lambda r: r),
                               (pcore, "port", _port_rel)):
        root = tmp_path / name
        mapped = {mapper(rel): src for rel, src in files.items()}
        _write(root, mapped)
        findings, suppressed = core.run_analysis(
            str(root), targets=sorted(mapped), rules=rules)
        out.append(({(f.rule, f.line, os.path.basename(f.path))
                     for f in findings}, len(suppressed)))
    return out


def run_port(tmp_path, files, rules):
    _write(tmp_path, files)
    findings, suppressed = pcore.run_analysis(
        str(tmp_path), targets=sorted(files), rules=rules)
    return findings, suppressed


# ----------------------------------------------------------------------
# The framework-neutral rules: the port's linter agrees with the JAX one
# ----------------------------------------------------------------------

_FAULTS_REL = "glint_word2vec_tpu/utils/faults.py"
_EVENTS_REL = "glint_word2vec_tpu/obs/events.py"
_RENDERER_REL = "glint_word2vec_tpu/obs/prometheus.py"
_HEARTBEAT_REL = "glint_word2vec_tpu/obs/heartbeat.py"

_FAULTS_FIXTURE = """
    POINTS = {
        "a.used": "fires in mod",
        "a.unused": "never fired",
    }
"""

_SPANS_FIXTURE = """
    REQUEST_SPANS = {
        "req.parse": "parsing",
        "req.unused": "never recorded",
    }

    def phase_span(name):
        pass
"""

_LOCKED_BAD = """
    import threading

    class Box:
        def __init__(self):
            self._mu = threading.Lock()
            self.count = 0

        def bump(self):
            with self._mu:
                self.count += 1

        def peek(self):
            return self.count
"""

NEUTRAL = {
    "atomic_bare_dump": ({"scripts/bad_persist.py": """
        import json

        def save(path, doc):
            with open(path, "w") as f:
                json.dump(doc, f)
    """}, ["atomic-persist"]),
    "atomic_commit_and_append": ({"scripts/good_persist.py": """
        import json
        import os

        def save(path, doc):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)

        def log(path, line):
            with open(path, "a") as f:
                f.write(line)
    """}, ["atomic-persist"]),
    "atomic_np_save": ({"scripts/badnp.py": """
        import numpy as np

        def save(path, arr):
            np.save(path, arr)
    """}, ["atomic-persist"]),
    "atomic_path_write": ({"glint_word2vec_tpu/pw.py": """
        import pathlib

        def save(path, text):
            pathlib.Path(path).write_text(text)

        def nested(path, text):
            import os

            def inner():
                with open(path + ".t", "w") as f:
                    f.write(text)
            inner()
            os.replace(path + ".t", path)
    """}, ["atomic-persist"]),
    "fault_point_both_directions": ({
        _FAULTS_REL: _FAULTS_FIXTURE,
        "glint_word2vec_tpu/mod.py": """
            from glint_word2vec_tpu.utils import faults

            def f():
                faults.fire("a.used")
                faults.fire("a.typo")
        """}, ["fault-point"]),
    "fault_point_clean_and_nonliteral": ({
        _FAULTS_REL: _FAULTS_FIXTURE,
        "glint_word2vec_tpu/mod.py": """
            from glint_word2vec_tpu.utils import faults

            def f(name):
                faults.fire("a.used")
                faults.fire("a.unused")
                faults.fire(name)
        """}, ["fault-point"]),
    "fault_point_registry_missing": ({
        _FAULTS_REL: "POINTS = make_points()\n",
        "glint_word2vec_tpu/mod.py": "faults.fire('x')\n"}, ["fault-point"]),
    "span_registry_both_directions": ({
        _EVENTS_REL: _SPANS_FIXTURE,
        "glint_word2vec_tpu/srv.py": """
            from glint_word2vec_tpu.obs import events as obs_events

            def handle(tr, name):
                with tr.phase("req.parse"):
                    pass
                tr.add_phase("req.typo", 0.0, 1.0)
                with obs_events.phase_span(name):
                    pass
        """}, ["span-registry"]),
    "prom_renderer_only_key_and_bad_names": ({
        _RENDERER_REL: """
            def training_to_prometheus(snap):
                p = _Prom()
                p.head("glint_training_x_total", "gauge", "bad suffix")
                p.sample("glint_training_x_total", None, snap.get("x"))
                p.sample("glint_training_orphan", None, snap.get("missing"))
                return p.text()
        """,
        _HEARTBEAT_REL: """
            def snapshot():
                return {"x": 1}
        """}, ["prom-consistency"]),
    "prom_cross_renderer_type_conflict": ({_RENDERER_REL: """
        def training_to_prometheus(snap):
            p = _Prom()
            p.head("glint_shared", "gauge", "one type")
            p.sample("glint_shared", None, 1)
            return p.text()

        def serving_to_prometheus(snap):
            p = _Prom()
            p.head("glint_shared", "summary", "another type")
            p.sample("glint_shared", None, 1)
            return p.text()
    """}, ["prom-consistency"]),
    "prom_cross_renderer_help_drift": ({_RENDERER_REL: """
        def training_to_prometheus(snap):
            p = _Prom()
            p.head("glint_shared", "gauge", "one help")
            p.sample("glint_shared", None, 1)
            return p.text()

        def serving_to_prometheus(snap):
            p = _Prom()
            p.head("glint_shared", "gauge", "another help")
            p.sample("glint_shared", None, 1)
            return p.text()
    """}, ["prom-consistency"]),
    "prom_clean_loop_idiom": ({
        _RENDERER_REL: """
            def training_to_prometheus(snap):
                p = _Prom()
                gauges = [
                    ("glint_training_epoch", "epoch", "Epoch."),
                    ("glint_training_alpha", "alpha", "LR."),
                ]
                for name, key, help_ in gauges:
                    p.head(name, "gauge", help_)
                    p.sample(name, None, snap.get(key))
                p.head("glint_training_steps_total", "counter", "Steps.")
                p.sample("glint_training_steps_total", None,
                         snap.get("step", 0))
                return p.text()
        """,
        _HEARTBEAT_REL: """
            def snapshot():
                return {"epoch": 0, "alpha": 0.01, "step": 3}
        """}, ["prom-consistency"]),
    "lock_unguarded_read": ({"glint_word2vec_tpu/box.py": _LOCKED_BAD},
                            ["lock-discipline"]),
    "lock_atomic_attrs_and_locked_suffix": ({"glint_word2vec_tpu/box2.py": """
        import threading

        class Box:
            _ATOMIC_ATTRS = frozenset({"count"})

            def __init__(self):
                self._mu = threading.Lock()
                self.count = 0
                self.state = "idle"

            def bump(self):
                with self._mu:
                    self.count += 1
                    self._advance_locked()

            def _advance_locked(self):
                self.state = "running"

            def peek(self):
                return self.count
    """}, ["lock-discipline"]),
    "lock_nested_def_does_not_inherit": ({"glint_word2vec_tpu/box3.py": """
        import threading

        class Box:
            def __init__(self):
                self._mu = threading.Lock()
                self.value = 0

            def start(self):
                with self._mu:
                    self.value = 1

                    def worker():
                        self.value = 2
                    return worker
    """}, ["lock-discipline"]),
    "suppression_reason_and_known_rule": ({"scripts/sup.py": """
        import json

        def a(path, doc):
            # graftlint: ignore[atomic-persist]
            with open(path, "w") as f:
                json.dump(doc, f)

        def b(path, doc):
            # graftlint: ignore[no-such-rule] because reasons
            with open(path, "w") as f:
                json.dump(doc, f)

        def c(path, doc):
            with open(path, "w") as f:  # graftlint: ignore[atomic-persist] test seam
                json.dump(doc, f)

        def d(path, doc):
            # graftlint: ignore[] a reason but no rule
            with open(path, "w") as f:
                json.dump(doc, f)
    """}, ["atomic-persist"]),
    "parse_error": ({"scripts/broken.py": "def f(:\n"}, []),
}


@pytest.mark.parametrize("case", sorted(NEUTRAL))
def test_neutral_rules_match_the_jax_linter(tmp_path, case):
    files, rules = NEUTRAL[case]
    (jax_found, jax_sup), (port_found, port_sup) = run_both(tmp_path, files,
                                                            rules)
    assert port_found == jax_found
    assert port_sup == jax_sup


BASELINE_CASES = {
    "line_drift": ("r", {"line": 99, "context": "x = 1", "note": "fine"}),
    "noteless": ("r", {"line": 10, "context": "x = 1", "note": " "}),
    "moved": ("r", {"line": 10, "context": "x = 2", "note": "fine"}),
    "meta_rule": (None, {"line": 3, "context": "x = 1", "note": "laundered"}),
}


@pytest.mark.parametrize("case", sorted(BASELINE_CASES))
def test_baseline_mechanics_match_the_jax_linter(tmp_path, case):
    rule, entry = BASELINE_CASES[case]
    out = []
    for core, bl in ((jcore, jbl), (pcore, pbl)):
        r = rule or core.SUPPRESSION_RULE
        f = core.Finding(rule=r, path="p.py", line=10, message="m",
                         context="x = 1")
        e = dict(entry, rule=r, path="p.py")
        new, stale, noteless = bl.compare_to_baseline([f], [e])
        written = bl.write_baseline(str(tmp_path / f"{core.__name__}.json"),
                                    [f], [e])
        out.append(([x.line for x in new], [x["line"] for x in stale],
                    [x["line"] for x in noteless],
                    [(x["line"], x["note"]) for x in written]))
    assert out[0] == out[1]


# ----------------------------------------------------------------------
# sync-point, retargeted to torch
# ----------------------------------------------------------------------

_SYNC_HEAD = "import numpy as np\nimport torch\n\n\ndef f(x, m, r, ev, n: int, ids):\n"

SYNC_FLAGGED = {
    "item": "    return x.item()\n",
    "tolist": "    return x.tolist()\n",
    "cpu": "    return x.cpu()\n",
    "numpy": "    return x.numpy()\n",
    "to_cpu": "    return x.to('cpu')\n",
    "to_device_cpu": "    return x.to(device='cpu')\n",
    "to_torch_device_cpu": "    return x.to(torch.device('cpu'))\n",
    "float": "    return float(x)\n",
    "int": "    return int(x)\n",
    "bool": "    return bool(x)\n",
    "np_asarray": "    return np.asarray(x)\n",
    "np_array_dtype": "    return np.array(x, np.float32)\n",
    "cuda_synchronize": "    torch.cuda.synchronize()\n",
    "event_synchronize": "    ev.synchronize()\n",
    "stream_synchronize": "    torch.cuda.current_stream().synchronize()\n",
    "nonzero": "    return torch.nonzero(m)\n",
    "nonzero_method": "    return m.nonzero()\n",
    "unique": "    return torch.unique(x)\n",
    "masked_select": "    return torch.masked_select(x, m)\n",
    "masked_select_method": "    return x.masked_select(m)\n",
    "where_one_arg": "    return torch.where(m)\n",
    "repeat_interleave_tensor": "    return x.repeat_interleave(r)\n",
    "repeat_interleave_fn": "    return torch.repeat_interleave(x, r)\n",
}

SYNC_BLESSED = {
    "host_shape": "    return int(x.shape[0]) + float(x.numel())\n",
    "host_len_env": ("    import os\n"
                     "    return float(len(ids)), int(os.environ.get('N', '1'))\n"),
    "annotated_param": "    return int(n)\n",
    "host_local": "    k = 3\n    w = k * 2\n    return int(w)\n",
    "host_unpack": "    P, d = x.shape\n    return int(P * d)\n",
    "np_rooted": "    return float(np.mean(ids)), int(np.prod([2, 3]))\n",
    "string_parse": "    return int('ff', 16)\n",
    "repeat_host": "    return x.repeat_interleave(3), x.repeat_interleave(n)\n",
    "repeat_output_size": "    return x.repeat_interleave(r, output_size=n)\n",
    "to_cuda": "    return x.to('cuda'), x.to(torch.float32)\n",
    "where_three_args": "    return torch.where(m, x, 0)\n",
    "readback_result": "    return float(x.item())  # graftlint: ignore[sync-point] test seam\n",
    "suppressed": "    return x.item()  # graftlint: ignore[sync-point] test seam\n",
}


@pytest.mark.parametrize("form", sorted(SYNC_FLAGGED))
def test_sync_point_flags_each_torch_form(tmp_path, form):
    findings, _ = run_port(tmp_path, {
        "glint_word2vec_torch/mod.py": _SYNC_HEAD + SYNC_FLAGGED[form],
    }, ["sync-point"])
    assert [(f.rule, f.line) for f in findings] == [("sync-point", 6)]


@pytest.mark.parametrize("form", sorted(SYNC_BLESSED))
def test_sync_point_passes_each_host_form(tmp_path, form):
    findings, _ = run_port(tmp_path, {
        "glint_word2vec_torch/mod.py": _SYNC_HEAD + SYNC_BLESSED[form],
    }, ["sync-point"])
    assert findings == []


@pytest.mark.parametrize("where", ["seam", "nested_in_seam", "no_torch",
                                   "chip_smoke"])
def test_sync_point_scope(tmp_path, where):
    src = "import torch\n\n\ndef f(x):\n    return x.item()\n"
    files = {
        "seam": {"glint_word2vec_torch/parallel/engine.py":
                 "import torch\n\n\nclass EmbeddingEngine:\n"
                 "    def top_k_cosine(self, x):\n        return x.cpu()\n"},
        "nested_in_seam": {"glint_word2vec_torch/parallel/engine.py":
                           "import torch\n\n\nclass EmbeddingEngine:\n"
                           "    def warmup(self, x):\n"
                           "        def inner():\n"
                           "            torch.cuda.synchronize()\n"
                           "        inner()\n"},
        "no_torch": {"glint_word2vec_torch/mod.py":
                     "def f(x):\n    return float(x)\n"},
        "chip_smoke": {"chip_smoke.py": src},
    }[where]
    findings, _ = run_port(tmp_path, files, ["sync-point"])
    assert findings == []
    # The same call outside a seam, in a torch module of the package, is
    # flagged.
    findings, _ = run_port(tmp_path, {"glint_word2vec_torch/other.py": src},
                           ["sync-point"])
    assert [f.line for f in findings] == [5]


def test_every_sync_seam_names_a_function():
    for key, reason in SYNC_SEAMS.items():
        path, qualname = key.split("::")
        with open(os.path.join(REPO, path), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        assert qualname in {q for q, _ in walk_functions(tree)}, key
        assert reason.strip(), key


# ----------------------------------------------------------------------
# table-tick, retargeted to in-place mutation and model shards
# ----------------------------------------------------------------------

_ENGINE_HEAD = """\
from glint_word2vec_torch.ops import fused_sgns as fs
from glint_word2vec_torch.ops.fused_sgns import scatter_add_rows_f32


class Engine:
    def __init__(self, t):
        self.syn0 = t
        self._shards = [[t], [t]]

    def _tick_tables(self, reason):
        self.table_version = 1

    def _fill(self, table, v):
        table.fill_(v)

    def m(self, t, ids, upd):
"""

TICK_FLAGGED = {
    "assign_syn0": "        self.syn0 = t\n",
    "assign_shard": "        self._shards[0] = [t]\n",
    "subscript_assign": "        self.syn0[ids] = upd\n",
    "shard_augassign": "        self._shards[0][0][:, :4] += upd\n",
    "inplace_method": "        self.syn1.index_add_(0, ids, upd)\n",
    "alias_inplace": "        s = self._shards[1][0]\n        s.copy_(t)\n",
    "loop_alias": ("        for k, s in enumerate(self._shards[0]):\n"
                   "            s.zero_()\n"),
    "getter_inplace": "        self.shard_tables(0)[0].mul_(2)\n",
    "scatter_wrapper": "        scatter_add_rows_f32(self.syn0, ids, upd)\n",
    "fused_step": "        fs.fused_pair_step(self.syn0, self.syn1, ids, ids, upd, ids, upd, t)\n",
    "setattr": "        setattr(self, 'syn1', t)\n",
    "setattr_loop": ("        for name in ('syn0', 'syn1'):\n"
                     "            setattr(self, name, t)\n"),
    "writing_helper": "        self._fill(self.syn1, 0.0)\n",
}

TICK_BLESSED = {
    "ticking_method": ("        self.syn0 = t\n        self.syn0.index_add_(0, ids, upd)\n"
                       "        self._tick_tables('m')\n"),
    "reads_only": ("        x = self.syn0[ids].float()\n        y = self.syn0.float()\n"
                   "        y.add_(1)\n        return x\n"),
    "other_tensor": "        upd.add_(1)\n        scatter_add_rows_f32(t, ids, upd)\n",
}


def _tick_line(body):
    """The line of the mutation in a TICK_FLAGGED body (its last line)."""
    return _ENGINE_HEAD.count("\n") + body.count("\n")


@pytest.mark.parametrize("form", sorted(TICK_FLAGGED))
def test_table_tick_flags_each_mutation_form(tmp_path, form):
    body = TICK_FLAGGED[form]
    findings, _ = run_port(tmp_path, {
        "glint_word2vec_torch/eng.py": _ENGINE_HEAD + body,
    }, ["table-tick"])
    assert [(f.rule, f.line) for f in findings] == [("table-tick",
                                                     _tick_line(body))]
    assert "Engine.m " in findings[0].message


@pytest.mark.parametrize("form", sorted(TICK_BLESSED))
def test_table_tick_passes_each_blessed_form(tmp_path, form):
    findings, _ = run_port(tmp_path, {
        "glint_word2vec_torch/eng.py": _ENGINE_HEAD + TICK_BLESSED[form],
    }, ["table-tick"])
    assert findings == []


def test_table_tick_ignores_classes_without_a_tick(tmp_path):
    findings, _ = run_port(tmp_path, {
        "glint_word2vec_torch/noteng.py": """
            class NotAnEngine:
                def set(self, t):
                    self.syn0 = t
                    self.syn0.add_(1)
        """,
    }, ["table-tick"])
    assert findings == []


# ----------------------------------------------------------------------
# The gate on the repo
# ----------------------------------------------------------------------


def test_default_targets_are_the_port_and_chip_smoke():
    targets = pcore.default_targets(REPO)
    assert "chip_smoke.py" in targets
    assert all(t == "chip_smoke.py" or t.startswith("glint_word2vec_torch/")
               for t in targets)
    assert "glint_word2vec_torch/parallel/engine.py" in targets


def test_repo_reproduces_the_committed_baseline():
    findings, _ = pcore.run_analysis(REPO)
    entries = pbl.load_baseline(os.path.join(REPO, pbl.BASELINE_REL))
    new, stale, noteless = pbl.compare_to_baseline(findings, entries)
    assert new == [], [f.format() for f in new[:5]]
    assert stale == [], stale[:5]
    assert noteless == [], noteless[:5]


def test_baseline_notes_all_nonempty():
    entries = pbl.load_baseline(os.path.join(REPO, pbl.BASELINE_REL))
    assert entries
    assert pbl.BASELINE_REL != jbl.BASELINE_REL
    assert all(e.get("note", "").strip() for e in entries)
    assert {e["rule"] for e in entries} <= set(pcore.CHECKERS)


def _cli(*args, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.analysis", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_check_baseline_passes_without_jax_torch_or_numpy(tmp_path):
    poison = tmp_path / "poison"
    poison.mkdir()
    for name in ("jax", "torch", "numpy"):
        (poison / f"{name}.py").write_text(
            f"raise ImportError('graftlint must not import {name}')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(poison) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    out = _cli("--check-baseline", env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "0 new, 0 stale, 0 noteless" in out.stdout
    assert time.monotonic() - t0 < 30


def test_list_rules_prints_seven_rules():
    out = _cli("--list-rules")
    assert out.returncode == 0
    rules = [line.split()[0] for line in out.stdout.splitlines() if line.strip()]
    assert sorted(rules) == sorted(jcore.CHECKERS) == sorted(pcore.CHECKERS)
    assert len(rules) == 7


def test_unknown_rule_is_a_usage_error():
    out = _cli("--rules", "no-such-rule")
    assert out.returncode == 2
    assert "unknown rule" in out.stderr
