"""The port stands alone: no module of ``alfi_torch`` and none of its
card scripts (``chip_*.py``: ``chip_smoke.py`` and the on-card
comparisons beside it) imports jax or the JAX package, or reads a file
of the JAX package.

The scan reads each file's syntax tree.  It rejects

* an ``import`` of ``jax`` or ``alfi_tpu`` (or of a submodule), and
* a string, outside docstrings, that names ``jax`` as a module or
  ``alfi_tpu`` other than in a ``file.py:line`` reference (the label of
  the kernel a port replaces): a path built into the JAX package, such as
  ``os.path.join(..., "alfi_tpu", ...)``, or a name handed to
  ``importlib``.

Comments and docstrings may name the reference.
"""

import ast
import glob
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "alfi_tpu")
#: "alfi_tpu/<path>.<ext>:<line>": a reference, not a path that is opened
_LABEL = re.compile(r"alfi_tpu/[\w/.-]+\.\w+:\d+")


def _sources():
    out = glob.glob(os.path.join(REPO, "chip_*.py"))
    for root, _, files in os.walk(os.path.join(REPO, "alfi_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _docstrings(tree):
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                ids.add(id(body[0].value))
    return ids


def _is_forbidden_module(name):
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def offences(source):
    """What in ``source`` (Python text) reaches jax or the JAX package."""
    tree = ast.parse(source)
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += ["import " + a.name for a in node.names
                      if _is_forbidden_module(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.module and _is_forbidden_module(node.module):
                found.append("from %s import" % node.module)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs):
            s = node.value
            if _is_forbidden_module(s.strip()):
                found.append("module name %r" % s)
            elif "alfi_tpu" in _LABEL.sub("", s):
                found.append("string %r" % s)
    return found


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_reaches_no_jax(path):
    with open(path) as f:
        assert offences(f.read()) == []


@pytest.mark.parametrize("bad", [
    "import jax\n",
    "import jax.numpy as jnp\n",
    "from alfi_tpu.mesh import core\n",
    "import alfi_tpu\n",
    "import os\np = os.path.join('..', 'alfi_tpu', 'native', 'x.cpp')\n",
    "open('alfi_tpu/native/topology.cpp')\n",
    "import importlib\nimportlib.import_module('jax')\n",
])
def test_scan_catches(bad):
    assert offences(bad)


def test_scan_allows_references():
    ok = ('"""Mirrors alfi_tpu/mg/velocity.py and jax.numpy."""\n'
          '# see alfi_tpu/solvers\n'
          'REPLACES = "alfi_tpu/mg/velocity.py:437 (level_apply)"\n')
    assert offences(ok) == []
