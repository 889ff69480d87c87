"""Reynolds-robust Navier-Stokes solvers (the reference's alfi/solver.py),
ported from the JAX package's ``solver.py`` to eager PyTorch.

This slice ports the flagship mode:

* ``almg`` — Newton-FGMRES with the block-Schur PC; velocity block by one
  full-multigrid cycle with patch smoothers and Schoeberl transfers
  (alfi/solver.py:353-379),

on ``ConstantPressureSolver`` ([Pk]^d - P0), a uniform hierarchy, star
patches and no stabilisation.  Every tensor lives on the ``device`` the
caller passes; nothing falls back to another device.
"""

from __future__ import annotations

import time as _time

import torch

from .fem import (
    BCSet,
    FunctionSpace,
    MixedFunctionSpace,
    NSForm,
    VectorFunctionSpace,
    dg_lagrange,
    lagrange,
    pk_facet_bubble,
)
from .solvers.fieldsplit import SchurPC, pressure_nullspace_projector
from .solvers.krylov import fgmres
from .solvers.linear import make_jacobian_matvec
from .solvers.newton import newton
from .utils.tree import tnorm, tscale

GREEN = "\033[1;37;32m%s\033[0m"
BLUE = "\033[1;37;34m%s\033[0m"


class NavierStokesSolver:
    """Base solver; subclasses fix the discretisation
    (alfi/solver.py:557-662)."""

    def __init__(self, problem, nref=1, solver_type="almg", gamma=10000,
                 k=5, hierarchy="bary", restriction=False, smoothing=None,
                 high_accuracy=False, verbose=True, *, device):
        if solver_type != "almg":
            raise NotImplementedError(
                "solver_type %r is not ported yet (only almg)" % solver_type)
        if hierarchy != "uniform":
            raise NotImplementedError(
                "hierarchy %r is not ported yet (only uniform)" % hierarchy)
        self.problem = problem
        self.nref = nref
        self.solver_type = solver_type
        self.restriction = restriction
        self.hierarchy = hierarchy
        self.high_accuracy = high_accuracy
        self.verbose = verbose
        self.device = torch.device(device)

        mh = problem.mesh_hierarchy(hierarchy, nref)
        self.mh = mh
        mesh = mh[-1]
        self.mesh = mesh
        self.tdim = mesh.dim
        if smoothing is None:
            smoothing = 10 if self.tdim > 2 else 6
        self.smoothing = smoothing

        self.char_L = problem.char_length()
        self.char_U = problem.char_velocity()
        self.gamma = float(gamma)
        self.nu_val = 1.0
        self.advect_val = 0.0

        Z = self.function_space(mesh, k)
        self.Z = Z
        self.k = k
        if self.verbose:
            print("Number of degrees of freedom: %s" % Z.dim)
            print("Number of velocity degrees of freedom: %s"
                  % (Z.V.ndof * Z.V.value_size))

        self.bcset = BCSet(Z, problem.bcs(Z), device=self.device)
        self.nsp = problem.has_nullspace()

        self.form = self.make_form()
        self.area = float(self.form.area())
        self.z = self.bcset.apply(Z.zero(self.device))
        self.z_last = self.z

        self._tolerances()
        self._linear_step = self._build_almg_step(
            pressure_nullspace_projector(Z) if self.nsp else None)

    # ------------------------------------------------------------------
    # subclass hooks
    # ------------------------------------------------------------------
    def function_space(self, mesh, k):
        raise NotImplementedError

    def make_form(self):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _tolerances(self):
        if self.high_accuracy:
            tol = dict(ksp_rtol=1e-12, ksp_atol=1e-12, snes_rtol=1e-10,
                       snes_atol=1e-10, snes_stol=1e-10)
        elif self.tdim == 2:
            tol = dict(ksp_rtol=1e-9, ksp_atol=1e-10, snes_rtol=1e-9,
                       snes_atol=1e-8, snes_stol=1e-6)
        else:
            tol = dict(ksp_rtol=1e-8, ksp_atol=1e-8, snes_rtol=1e-8,
                       snes_atol=1e-8, snes_stol=1e-6)
        self.tolerances = tol

    def params(self):
        return {"nu": self.nu_val, "gamma": self.gamma,
                "advect": self.advect_val}

    def residual_masked(self, z, params):
        return self.bcset.zero_rows(self.form.residual(z, params))

    def _build_almg_step(self, project):
        from .mg.velocity import VelocityMG

        self.vmg = VelocityMG(self)
        form, bcset = self.form, self.bcset
        tol = self.tolerances
        mask_u = bcset.mask[0]
        vmg = self.vmg

        # one-time static patch operators (smoother levels + transfers)
        self._almg_static = vmg.static_state()
        static = self._almg_static
        self._transfer_setup = (
            lambda params: vmg.transfer_setup(params, static["schoeberl"]))

        def lin(z, F, params, tstate):
            state = vmg.setup(z[0], params, schoeberl_state=tstate,
                              static=static)
            pc = SchurPC(form, mask_u, vmg.make_solve_A(state)).make_apply(
                params)
            J = make_jacobian_matvec(form.residual, bcset, z, params)
            dz, info = fgmres(
                J, tscale(-1.0, F), pc=pc, rtol=tol["ksp_rtol"],
                atol=tol["ksp_atol"], maxit=500, restart=30,
                project=project)
            return bcset.zero(dz), info["iters"]

        return lin

    # ------------------------------------------------------------------
    def message(self, msg):
        if self.verbose:
            print(msg)

    def solve(self, re):
        """Solve at Reynolds number ``re`` (continuation from the current
        state), mirroring alfi/solver.py:257-303."""
        self.z_last = self.z
        self.message(GREEN % ("Solving for Re = %s" % re))
        if re == 0:
            self.message(GREEN % "Solving Stokes")
            self.advect_val = 0.0
            self.nu_val = self.char_L * self.char_U
        else:
            self.advect_val = 1.0
            self.nu_val = self.char_L * self.char_U / re
        params = self.params()

        start = _time.perf_counter()

        def monitor(it, fnorm):
            self.message("  %3d SNES Function norm %14.12e" % (it, fnorm))

        tol = self.tolerances
        # transfer operators depend only on (nu, gamma): build once per Re
        tstate = self._transfer_setup(params)
        z, ninfo = newton(
            lambda zz: self.residual_masked(zz, params),
            lambda zz, FF: self._linear_step(zz, FF, params, tstate),
            self.z, maxit=20, rtol=tol["snes_rtol"],
            atol=tol["snes_atol"], stol=tol["snes_stol"],
            monitor=monitor if self.verbose else None)
        elapsed = _time.perf_counter() - start
        self.message(GREEN % (
            "Nonlinear solve %s in %d iterations (%s)" % (
                "converged" if ninfo.converged else "DIVERGED",
                ninfo.nonlinear_iter, ninfo.reason)))

        if self.nsp:
            u, p = z
            pint = float(self.form.pressure_integral(p))
            z = (u, p - pint / self.area)
        if ninfo.converged:
            self.z = z
        else:
            # keep the last CONVERGED state as the continuation iterate:
            # carrying a diverged (possibly NaN) z forward poisons every
            # later Re step
            z = self.z = self.z_last

        # gamma-free residual sanity check (alfi/solver.py:282-291)
        F_ngd = self.residual_masked(z, dict(params, gamma=0.0))
        F = self.residual_masked(z, params)
        self.residual_no_graddiv = float(tnorm(F_ngd))
        self.message(BLUE % ("Residual without grad-div term: %.14e"
                             % self.residual_no_graddiv))
        self.message(BLUE % ("Residual with grad-div term:    %.14e"
                             % float(tnorm(F))))

        linear_its = ninfo.linear_iter
        nonlinear_its = max(1, ninfo.nonlinear_iter)
        re_time = elapsed / 60.0
        self.message(GREEN % (
            "Time taken: %.2f min in %d iterations "
            "(%.2f Krylov iters per Newton step)"
            % (re_time, linear_its, linear_its / float(nonlinear_its))))
        info_dict = {
            "Re": re,
            "nu": self.nu_val,
            "linear_iter": linear_its,
            "nonlinear_iter": ninfo.nonlinear_iter,
            "time": re_time,
            "converged": ninfo.converged,
        }
        return (self.z, info_dict)


class ConstantPressureSolver(NavierStokesSolver):
    """[Pk]^d - P0, FacetBubble-enriched when k < dim; cell-averaged
    grad-div (alfi/solver.py:557-605)."""

    def function_space(self, mesh, k):
        d = mesh.dim
        if k < d:
            eu = pk_facet_bubble(d, k)
        else:
            eu = lagrange(d, k)
        V = VectorFunctionSpace(mesh, eu)
        Q = FunctionSpace(mesh, dg_lagrange(d, 0))
        return MixedFunctionSpace(V, Q)

    def make_form(self):
        return NSForm(self.Z.V, self.Z.Q, graddiv_mode="cell_avg",
                      rhs=self.problem.rhs(), device=self.device)
