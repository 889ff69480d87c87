"""No module under benchmark/ imports JAX, the JAX package or the JAX-era
bench.py, and the plain references import nothing of the program: each
import's top-level name (the part before the first dot) compared whole."""

import ast
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "alfi_tpu", "bench"}
#: what a plain reference may import
REFERENCE_ALLOWED = {"__future__", "itertools", "math", "numpy", "torch"}


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    assert "alfi_torch" not in FORBIDDEN
    assert top_level_imports(os.path.join(BENCH, "harness", "system.py")) \
        >= {"alfi_torch", "importlib"}


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_imports(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= REFERENCE_ALLOWED


def test_run_refuses_a_loaded_jax_module(monkeypatch):
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    # a process that loaded JAX before this test (a test run that also
    # runs the JAX package's tests) has it out of sys.modules while it runs
    for name in [m for m in sys.modules
                 if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "alfi_torch_extra", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
