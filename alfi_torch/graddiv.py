"""Grad-div velocity-block study harness (the reference's
examples/graddiv/graddiv.py), ported from the JAX package's
``graddiv.py``: the velocity-block multigrid alone on

    F(u) = 2 nu (sym grad u, grad v) + gamma (div u, div v) - (f, v),
    u = 0 on the whole boundary,  f = (1, ..., 1),

swept over gamma in {0, 1, 10, ..., 1e8} for each smoother (patch or
Jacobi) and transfer (Schoeberl on or off), or the smoothed-aggregation
AMG baseline.  Expected (the papers' table): patch + transfer stays flat
in gamma; everything else blows up.

Solved with CG (rtol 1e-8, at most 200 iterations, unpreconditioned
norm) under a W-cycle with Chebyshev-driven smoothers, which keep the
preconditioner linear, as CG needs (the reference's options,
graddiv.py:88-147).  The W-cycle's level operators run KM (assembled by
KA), the patch smoother and the Schoeberl patch solves K1; the AMG
baseline's fine operator KM and its Galerkin product KA
(``alfi_torch/kernels.py``).
"""

from __future__ import annotations

import torch

from .config import real_dtype
from .fem import (
    FunctionSpace,
    MixedFunctionSpace,
    NSForm,
    VectorFunctionSpace,
    dg_lagrange,
    lagrange,
    pk_facet_bubble,
)
from .fem.bcs import BCSet, DirichletBC
from .mesh import rectangle_mesh, unit_cube_mesh
from .mg.amg import VelocityAMG
from .mg.velocity import VelocityMG
from .problem import NavierStokesProblem
from .solvers.krylov import cg


class _ZeroBCProblem(NavierStokesProblem):
    def __init__(self, base):
        self._base = base

    def mesh(self):
        return self._base

    def bcs(self, Z):
        d = Z.mesh.dim
        return [DirichletBC(Z.V, (0.0,) * d, None)]

    def has_nullspace(self):
        return False


class GradDivSolver:
    """One grad-div configuration: mesh, element, smoother, transfer.

    ``smoother``: 'patch' or 'jacobi' (the geometric W-cycle) or 'amg'
    (smoothed aggregation, rebuilt per gamma in :meth:`solve`, since its
    prolongators smooth on K + gamma G).  ``smoothing``: Chebyshev steps
    per level (the reference's chebyshev max_it 2)."""

    #: what VelocityMG reads of a solver besides the spaces: additive
    #: patches, no stabilisation
    patch_composition = "additive"
    stabilisation = None

    def __init__(self, dim=2, baseN=8, nref=1, k=2, discretisation="pkp0",
                 hierarchy="uniform", patch="star", smoother="patch",
                 transfer=True, smoothing=2, diagonal="left", mesh=None, *,
                 device="cuda"):
        self.device = torch.device(device)
        if mesh is None:
            if dim == 2:
                mesh = rectangle_mesh(baseN, baseN, 1, 1, diagonal=diagonal)
            else:
                mesh = unit_cube_mesh(baseN)
        self.problem = _ZeroBCProblem(mesh)
        self.mh = self.problem.mesh_hierarchy(hierarchy, nref)
        self.patch = patch
        self.smoothing = smoothing
        # the Schoeberl ADJOINT restriction keeps the cycle symmetric, as
        # the CG outer needs (the reference's graddiv.py:158 wires
        # vtransfer.restrict)
        self.restriction = True
        fine = self.mh[-1]
        d = fine.dim
        self.d = d
        if discretisation == "pkp0" and k < d:
            eu = pk_facet_bubble(d, k)
        else:
            eu = lagrange(d, k)
        V = VectorFunctionSpace(fine, eu)
        Q = FunctionSpace(fine, dg_lagrange(d, 0))
        self.Z = MixedFunctionSpace(V, Q)
        gd_mode = "cell_avg" if discretisation == "pkp0" else "exact"
        self.form = NSForm(V, Q, graddiv_mode=gd_mode, device=self.device)
        self.bcset = BCSet(self.Z, self.problem.bcs(self.Z),
                           device=self.device)
        self.smoother = smoother
        self.vmg = None
        if smoother != "amg":
            self.vmg = VelocityMG(
                self, transfer_mode="schoeberl" if transfer else "standard",
                smoother=smoother, smoother_driver="chebyshev", cycle="w")
        self._load = self._assemble_load()

    def _assemble_load(self):
        """(f, v) with f = (1, ..., 1), BC rows zeroed; summed on the host
        CPU (index_add_ there is sequential), once per solver."""
        form = self.form
        tv = form.tab_v
        wdet = tv.w[None, :] * form.geom.detj[:, None]
        # integral of each test function per cell, all components equal
        loads = torch.einsum("cq,ql->cl", wdet, tv.phi).cpu()
        cd = torch.as_tensor(form.V.cell_dofs, dtype=torch.int64)
        F = torch.zeros((form.V.ndof,), dtype=real_dtype).index_add_(
            0, cd.reshape(-1), loads.reshape(-1)).to(self.device)
        b = F[:, None].expand(form.V.ndof, self.d)
        return self.bcset.mask[0] * b

    def solve(self, gamma, rtol=1e-8, maxit=200):
        """Returns (u, iteration count, converged)."""
        # the reference's viscosity coefficient 1 in front of 2 sym grad
        params = {"nu": 1.0, "gamma": float(gamma), "advect": 0.0}
        zero_wind = torch.zeros((self.form.V.ndof, self.d), dtype=real_dtype,
                                device=self.device)
        if self.smoother == "amg":
            self.gamma = float(gamma)  # SA smooths on K + gamma G
            vmg = VelocityAMG(self, smoothing=self.smoothing)
            state = vmg.setup(zero_wind, params)

            def A(v):
                return vmg.level_apply(state["vals"], v)
        else:
            vmg = self.vmg
            state = vmg.setup(zero_wind, params, vmg.transfer_setup(params),
                              None)
            vals = state["level_ops"][-1]

            def A(v):
                return vmg.level_apply(vmg.nlevels - 1, vals, v)

        u, info = cg(A, self._load, pc=vmg.make_solve_A(state), rtol=rtol,
                     maxit=maxit)
        return u, int(info["iters"]), bool(info["converged"])


def gamma_sweep(gammas=(0.0, 1.0, 1e1, 1e2, 1e3, 1e4, 1e6, 1e8), **kw):
    """The reference's experiment loop (graddiv.py:160-180): returns
    {gamma: iterations} with 201 marking divergence (">200")."""
    s = GradDivSolver(**kw)
    out = {}
    for g in gammas:
        _, its, conv = s.solve(g)
        out[g] = its if conv else 201
    return out
