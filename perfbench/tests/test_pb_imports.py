"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either; a run loads none of
them. Names compare by their whole top-level part: the port's name begins
with the JAX package's."""

import ast
import subprocess
import sys

import pytest

import pb_tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "glint_word2vec_tpu"}
PROGRAM = "glint_word2vec_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files():
    return sorted(pb_tiny.PB.rglob("*.py"))


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(pb_tiny.PB)))
def test_no_forbidden_import(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(pb_tiny.PB).parts:
        assert PROGRAM not in names


def test_a_run_loads_none_of_them(tmp_path):
    root = pb_tiny.tiny_root(tmp_path)
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(pb_tiny.ROOT)!r})\n"
        f"sys.path.insert(0, {str(pb_tiny.PB / 'tests')!r})\n"
        "import pb_tiny\n"
        "from pathlib import Path\n"
        f"root = Path({str(root)!r})\n"
        "for cell in pb_tiny.cells():\n"
        "    assert pb_tiny.run(root, cell, seconds=0.2)['correct']\n"
        "from perfbench import harness\n"
        "print(harness.forbidden_modules())\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
