"""Nothing the harness runs imports JAX, Flax or the JAX package (each
compared as a whole top-level name), and the plain reference imports
nothing of the program."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness


def _sources(sub=""):
    base = os.path.join(harness.HERE, sub)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            yield "__import__"


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_in_the_harness(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), (path, tops)
    assert "__import__" not in tops


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert "gnnflow_tpu_torch" not in tops and "portbench" not in tops


def test_whole_names_are_compared(monkeypatch):
    """``gnnflow_tpu_torch`` starts with ``gnnflow_tpu`` but is not it;
    a submodule of a forbidden package is found by its top-level name."""
    for name in harness.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "gnnflow_tpu_torch.x", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_a_run_loads_no_jax():
    """A tiny run in a fresh process leaves no forbidden module behind."""
    code = ("from portbench.tests import tiny\n"
            "from portbench.run import Ctx, execute\n"
            "from portbench import harness\n"
            "res = execute(Ctx(tiny.cell('tgn-serve'), 3, 1.0, 0, 'cpu'))\n"
            "assert res['correct'], res['checks']\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
