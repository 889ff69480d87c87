"""The outer Krylov's Jacobian action of almg from the multigrid set-up's
assembled finest level operator (``solvers/linear.py``:
``make_assembled_jacobian_matvec``), against ``torch.func.jvp`` of the
residual (``make_jacobian_matvec``), on the CPU through the plain kernels.

At a seeded state z and frozen wind z_last the two agree to 1e-12 in both
blocks, with the BC rows as identity, in every mode where the set-up's
operator is the Newton Jacobian's velocity block: no stabilisation, SUPG on
a P0 pressure (Shakib, Turek; 3D [P1+FB]^3-P0 with the face bubbles), and
Burman's facet term on Scott-Vogelius.  GLS, and a level operator stored in
f32, keep the jvp.  ``COUNTERS`` tells which path each action took.
"""

import numpy as np
import pytest
import torch

import alfi_torch.solver as solver_mod
from alfi_torch import ConstantPressureSolver, ScottVogeliusSolver
from alfi_torch import config
from alfi_torch.problems import (
    ThreeDimLidDrivenCavityProblem,
    TwoDimLidDrivenCavityProblem,
)
from alfi_torch.solvers.linear import (
    make_assembled_jacobian_matvec,
    make_jacobian_matvec,
)
from alfi_torch.utils import events

RE = 100.0

#: name -> (solver class, problem, keywords)
CASES = {
    "ldc2d_p2p0": (ConstantPressureSolver,
                   lambda: TwoDimLidDrivenCavityProblem(4),
                   dict(k=2, hierarchy="uniform")),
    "ldc3d_p1fb_supg": (ConstantPressureSolver,
                        lambda: ThreeDimLidDrivenCavityProblem(1),
                        dict(k=1, hierarchy="uniform",
                             stabilisation_type="supg",
                             stabilisation_weight=0.05)),
    "ldc2d_sv_burman": (ScottVogeliusSolver,
                        lambda: TwoDimLidDrivenCavityProblem(4),
                        dict(k=2, hierarchy="bary", patch="macro",
                             stabilisation_type="burman",
                             stabilisation_weight=5e-3)),
    "ldc2d_p2p0_supg_turek": (ConstantPressureSolver,
                              lambda: TwoDimLidDrivenCavityProblem(4),
                              dict(k=2, hierarchy="uniform",
                                   stabilisation_type="supg",
                                   supg_method="turek")),
}

#: name -> (solver class, problem, keywords, the store dtype)
FALLBACKS = {
    "gls": (ConstantPressureSolver, lambda: TwoDimLidDrivenCavityProblem(4),
            dict(k=2, hierarchy="uniform", stabilisation_type="gls"),
            torch.float64),
    "store32": (ConstantPressureSolver,
                lambda: TwoDimLidDrivenCavityProblem(4),
                dict(k=2, hierarchy="uniform"), torch.float32),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _solver(cls, problem, kw, store=torch.float64):
    config.set_mg_store(store)
    try:
        return cls(problem(), nref=1, solver_type="almg", gamma=1e4,
                   verbose=False, device="cpu", **kw)
    finally:
        config.set_mg_store(None)


def _seeded(s, seed, scale):
    """A feasible state: seeded values on the free dofs, the BC values on
    the others."""
    rng = np.random.default_rng(seed)
    out = []
    for x, m, g in zip(s.z, s.bcset.mask, s.bcset.values):
        r = torch.as_tensor(scale * rng.standard_normal(tuple(x.shape)))
        out.append(m * r + g)
    return tuple(out)


def _at(s, seeded):
    """Re 100 at a seeded state and frozen wind, or at rest (the first
    Newton step of a sweep); (z, params, the Schur PC of that Newton step,
    the transfer state)."""
    s.advect_val = 1.0
    s.nu_val = s.char_L * s.char_U / RE
    if seeded:
        s.z_last, s.z = _seeded(s, 1, 0.3), _seeded(s, 2, 0.5)
    else:
        s.z = s.z_last = s.bcset.apply(s.Z.zero(s.device))
    params = s.params()
    tstate = s._transfer_setup(params)
    return s.z, params, s._make_schur_pc(s.z, params, tstate), tstate


def _linear_step_counts(s, monkeypatch):
    """One Newton step's linear solve from rest: (the outer FGMRES's
    operator calls, the counters' increments)."""
    z, params, _, tstate = _at(s, seeded=False)
    calls = []
    real_fgmres = solver_mod.fgmres

    def counted_fgmres(A, *args, **kwargs):
        def counted(v):
            calls.append(1)
            return A(v)

        return real_fgmres(counted, *args, **kwargs)

    monkeypatch.setattr(solver_mod, "fgmres", counted_fgmres)
    events.reset()
    _, its = s._linear_step(z, s.residual_masked(z, params), params, tstate)
    assert 0 < its < 500
    return len(calls), dict(events.COUNTERS)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    torch.set_num_threads(1)
    cls, problem, kw = CASES[request.param]
    s = _solver(cls, problem, kw)
    return (request.param, s) + _at(s, seeded=True)


def test_assembled_action_is_the_jvp(case):
    name, s, z, params, schur, _ = case
    assert schur.jacobian_A is not None, name
    J_asm = make_assembled_jacobian_matvec(s.form, s.bcset, schur.jacobian_A)
    J_jvp = make_jacobian_matvec(s.form.residual, s.bcset, z, params)
    v = _seeded(s, 3, 1.0)
    # the BC entries of v too, which the identity rows return
    v = tuple(x + torch.as_tensor(np.random.default_rng(4).standard_normal(
        tuple(x.shape))) * (1.0 - m) for x, m in zip(v, s.bcset.mask))
    a, b = J_asm(v), J_jvp(v)
    for block, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype == torch.float64
        assert _rel(x, y) < 1e-12, (name, block, _rel(x, y))
    for x, m, w in zip(a, s.bcset.mask, v):
        assert torch.equal(x[m == 0], w[m == 0])
    # the action runs where its operator is set: KM on the finest level
    assert a[0].shape == z[0].shape and a[1].shape == z[1].shape


def test_linear_step_takes_the_assembled_action(case, monkeypatch):
    name, s = case[:2]
    calls, counts = _linear_step_counts(s, monkeypatch)
    assert counts["jacobian_assembled"] == calls, name
    assert counts["jacobian_jvp"] == 0, name


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_fallbacks_keep_the_jvp(name, monkeypatch):
    cls, problem, kw, store = FALLBACKS[name]
    s = _solver(cls, problem, kw, store)
    assert _at(s, seeded=True)[2].jacobian_A is None
    calls, counts = _linear_step_counts(s, monkeypatch)
    assert counts["jacobian_jvp"] == calls
    assert counts["jacobian_assembled"] == 0
