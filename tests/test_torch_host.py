"""The port's host layer is a numpy copy of the JAX package's: its tables
must equal alfi_tpu's EXACTLY (ldc2d baseN=4 nref=1, uniform hierarchy),
and importing the port must never load jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from alfi_torch import ConstantPressureSolver as TorchSolver
from alfi_torch.problems import TwoDimLidDrivenCavityProblem as TorchLDC
from alfi_tpu import ConstantPressureSolver as JaxSolver
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem as JaxLDC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(nref=1, k=2, solver_type="almg", hierarchy="uniform", gamma=1e4,
          verbose=False)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solvers():
    torch.set_num_threads(1)
    return (TorchSolver(TorchLDC(4), device="cpu", **KW),
            JaxSolver(JaxLDC(4), **KW))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _equal(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("level", [0, 1])
def test_meshes_equal(solvers, level):
    t, j = solvers
    mt, mj = t.mh[level], j.mh[level]
    for attr in ("vertices", "cells", "facet_vertices", "cell_facets",
                 "facet_birth_level"):
        _equal(getattr(mt, attr), getattr(mj, attr))


@pytest.mark.parametrize("level", [0, 1])
def test_dof_numbering_equal(solvers, level):
    t, j = solvers
    Vt, Vj = t.vmg.levels[level].V, j.vmg.levels[level].V
    _equal(Vt.cell_dofs, Vj.cell_dofs)
    _equal(Vt.dof_coords, Vj.dof_coords)
    _equal(t.vmg.levels[level].rows, j.vmg.levels[level].rows)


@pytest.mark.parametrize("part", [0, 1])
def test_bc_masks_equal(solvers, part):
    t, j = solvers
    _equal(t.bcset.mask[part], j.bcset.mask[part])
    _equal(t.bcset.values[part], j.bcset.values[part])


@pytest.mark.parametrize("kind", ["smoother", "schoeberl"])
def test_patchsets_equal(solvers, kind):
    t, j = solvers
    if kind == "smoother":
        pt, pj = t.vmg.patchsets[0], j.vmg.patchsets[0]
    else:
        pt, pj = t.vmg.schoeberl[0].patchset, j.vmg.schoeberl[0].patchset
        _equal(t.vmg.schoeberl[0].zmask, j.vmg.schoeberl[0].zmask)
    assert (pt.m, pt.nflat, pt.npatches) == (pj.m, pj.nflat, pj.npatches)
    for attr in ("dofs", "cells", "l2p", "active", "sizes"):
        _equal(getattr(pt, attr), getattr(pj, attr))


@pytest.mark.parametrize("kind", ["prolongs", "injects"])
def test_transfer_tables_equal(solvers, kind):
    t, j = solvers
    tt, tj = getattr(t.vmg, kind)[0], getattr(j.vmg, kind)[0]
    np.testing.assert_array_equal(_np(tt.idx), _np(tj.idx).astype(np.int64))
    _equal(tt.w, tj.w)


def test_import_loads_no_jax():
    code = ("import sys\n"
            "import alfi_torch, alfi_torch.solver, alfi_torch.interop\n"
            "import alfi_torch.kernels, alfi_torch.problems\n"
            "assert 'jax' not in sys.modules, 'alfi_torch imported jax'\n"
            "assert 'alfi_tpu' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_topology_source_is_a_copy():
    """The port compiles its own copy of the native topology helper; it
    must stay byte-for-byte the JAX package's."""
    with open(os.path.join(REPO, "alfi_torch", "native", "topology.cpp"),
              "rb") as f:
        port = f.read()
    with open(os.path.join(REPO, "alfi_tpu", "native", "topology.cpp"),
              "rb") as f:
        ref = f.read()
    assert port == ref
