"""Reynolds-robust Navier-Stokes solvers (the reference's alfi/solver.py),
ported from the JAX package's ``solver.py`` to eager PyTorch.

The port has the modes

* ``lu``    — full-system dense LU per Newton step (MUMPS analogue,
              alfi/solver.py:396-403), with the pressure pinned when the
              problem has a null space (:182-189);
* ``allu``  — Newton-FGMRES with the block-Schur PC; velocity block by
              dense LU (:346-352);
* ``almg``  — the same, velocity block by one full-multigrid cycle with
              patch smoothers (additive, or multiplicative colour sweeps)
              and Schoeberl transfers (:353-379),

on ``ConstantPressureSolver`` ([Pk]^d - P0) and ``ScottVogeliusSolver``
([Pk]^d - DG(k-1), exact grad-div), the uniform, bary and uniformbary
hierarchies, star and macrostar patches, and optional SUPG/GLS or
Burman stabilisation carried through the Newton Jacobian and the
multigrid level and patch operators.  Every tensor lives on ``device``:
the card (``"cuda"``) unless the caller asks for another; nothing falls
back to another device.
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
from .solvers.linear import (
    assemble_dense_mixed,
    assemble_dense_velocity,
    flatten_mixed,
    lu_solve_closure,
    make_jacobian_matvec,
    unflatten_mixed,
)
from .solvers.newton import newton
from .stabilisation import make_stabilisation
from .utils.events import timed_function, timed_region
from .utils.tree import tnorm, tscale

GREEN = "\033[1;37;32m%s\033[0m"
BLUE = "\033[1;37;34m%s\033[0m"


class NavierStokesSolver:
    """Base solver; subclasses fix the discretisation
    (alfi/solver.py:557-662)."""

    def __init__(self, problem, nref=1, solver_type="almg",
                 stabilisation_type=None, supg_method="shakib",
                 supg_magic=9.0, gamma=10000, nref_vis=0, k=5,
                 patch="star", hierarchy="bary", use_mkl=False,
                 stabilisation_weight=None, patch_composition="additive",
                 restriction=False, smoothing=None,
                 rebalance_vertices=False, hierarchy_callback=None,
                 high_accuracy=False, verbose=True, *, device="cuda"):
        if solver_type in ("alamg", "simple", "lsc"):
            raise NotImplementedError(
                "solver_type %r is not ported yet: ROADMAP.md Queue 1 "
                "item 10f" % solver_type)
        if solver_type not in ("lu", "allu", "almg"):
            raise ValueError("solver_type %r" % solver_type)
        if patch_composition not in ("additive", "multiplicative"):
            raise ValueError("patch_composition %r" % patch_composition)
        # each kwarg of the reference the port has not ported yet takes
        # only the reference's default; use_mkl is accepted and unused,
        # as in the reference
        for bad, what, item in [
                (nref_vis != 0, "nref_vis %r (visprolong)" % nref_vis,
                 "10h"),
                (rebalance_vertices, "rebalance_vertices", "12")]:
            if bad:
                raise NotImplementedError(
                    "%s is not ported yet: ROADMAP.md Queue 1 item %s"
                    % (what, item))
        if stabilisation_type == "none":
            stabilisation_type = None
        if stabilisation_type not in (None, "supg", "gls", "burman"):
            raise ValueError("stabilisation_type %r" % stabilisation_type)
        if hierarchy not in ("uniform", "bary", "uniformbary"):
            raise ValueError("hierarchy %r" % hierarchy)
        if patch not in ("star", "macro"):
            raise ValueError("patch %r" % patch)
        if hierarchy != "bary" and patch == "macro":
            raise ValueError(
                "macro patch only makes sense with a bary hierarchy")
        self.problem = problem
        self.nref = nref
        self.solver_type = solver_type
        self.stabilisation_type = stabilisation_type
        self.supg_method = supg_method
        self.supg_magic = supg_magic
        self.stabilisation_weight = stabilisation_weight
        self.patch = patch
        self.patch_composition = patch_composition
        self.restriction = restriction
        self.hierarchy = hierarchy
        self.high_accuracy = high_accuracy
        self.verbose = verbose
        self.device = torch.device(device)

        mh = problem.mesh_hierarchy(hierarchy, nref)
        if hierarchy_callback is not None:
            mh = hierarchy_callback(mh)
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

        has_nsp = problem.has_nullspace()
        pin = has_nsp and solver_type == "lu"
        self.bcset = BCSet(Z, problem.bcs(Z), pin_pressure=pin,
                           device=self.device)
        self.nsp = has_nsp and not pin

        self.form = self.make_form()
        self.area = float(self.form.area())
        self.z = self.bcset.apply(Z.zero(self.device))
        self.z_last = self.z

        self.stabilisation = None
        self._setup_stabilisation()
        self._tolerances()
        self._build_step_functions()

    # ------------------------------------------------------------------
    # subclass hooks
    # ------------------------------------------------------------------
    def function_space(self, mesh, k):
        raise NotImplementedError

    def make_form(self):
        raise NotImplementedError

    def _setup_stabilisation(self):
        if self.stabilisation_type is None:
            return
        self.stabilisation = make_stabilisation(
            self.form, self.stabilisation_type, self.supg_method,
            self.supg_magic, self.stabilisation_weight,
            char_LU=self.char_L * self.char_U)
        self.form.stabilisation = self.stabilisation.residual_hook

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
        p = {"nu": self.nu_val, "gamma": self.gamma,
             "advect": self.advect_val}
        if self.stabilisation is not None:
            # frozen test-function wind = previous-Re velocity (the
            # reference's z_last, alfi/solver.py:203,258)
            p["wind"] = self.z_last[0]
        return p

    def residual_masked(self, z, params):
        return self.bcset.zero_rows(self.form.residual(z, params))

    def _build_step_functions(self):
        form, bcset, Z = self.form, self.bcset, self.Z
        project = pressure_nullspace_projector(Z) if self.nsp else None
        # the transfer operators of almg depend on (nu, gamma) only and
        # are built once per Re; the direct modes have none
        self._transfer_setup = lambda params: None

        if self.solver_type == "lu":
            def lin(z, F, params, tstate):
                A = assemble_dense_mixed(form, z, params, bcset)
                x = lu_solve_closure(A)(-flatten_mixed(F))
                return bcset.zero(unflatten_mixed(x, Z)), 1
        elif self.solver_type == "allu":
            mask_u = bcset.mask[0]
            d = self.tdim

            def make_solve_A(z, params, tstate):
                flat_solve = lu_solve_closure(
                    assemble_dense_velocity(form, z[0], params, mask_u))
                return lambda rv: flat_solve(rv.reshape(-1)).reshape(-1, d)

            lin = self._schur_fgmres_step(make_solve_A, project)
        else:
            lin = self._build_almg_step(project)
        self._linear_step = lin

    def _schur_fgmres_step(self, make_solve_A, project):
        """The outer Krylov step of allu and almg: FGMRES (maxit 500,
        restart 30) on the matrix-free Jacobian under the Schur-complement
        preconditioner, whose velocity solve ``make_solve_A(z, params,
        tstate)`` builds at each Newton step."""
        form, bcset = self.form, self.bcset
        tol = self.tolerances
        mask_u = bcset.mask[0]

        def lin(z, F, params, tstate):
            pc = SchurPC(form, mask_u, make_solve_A(z, params, tstate)
                         ).make_apply(params)
            J = make_jacobian_matvec(form.residual, bcset, z, params)
            dz, info = fgmres(
                J, tscale(-1.0, F), pc=pc, rtol=tol["ksp_rtol"],
                atol=tol["ksp_atol"], maxit=500, restart=30,
                project=project)
            return bcset.zero(dz), info["iters"]

        return lin

    def _build_almg_step(self, project):
        from .mg.velocity import VelocityMG

        self.vmg = VelocityMG(self)
        vmg = self.vmg

        # one-time static patch operators (smoother levels + transfers)
        self._almg_static = vmg.static_state()
        static = self._almg_static
        self._transfer_setup = (
            lambda params: vmg.transfer_setup(params, static["schoeberl"]))

        def make_solve_A(z, params, tstate):
            return vmg.make_solve_A(vmg.setup(
                z[0], params, schoeberl_state=tstate, static=static,
                p_fine=z[1]))

        return self._schur_fgmres_step(make_solve_A, project)

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

        if self.stabilisation is not None:
            self.stabilisation.update(self.z[0])

        start = _time.perf_counter()

        def monitor(it, fnorm):
            self.message("  %3d SNES Function norm %14.12e" % (it, fnorm))

        tol = self.tolerances
        # transfer operators depend only on (nu, gamma): build once per Re
        tstate = self._transfer_setup(params)
        # the first linear step builds the kernel and initialises cuBLAS
        # and cuSOLVER: attribute it to a warm-up event so that KSPSolve
        # stays a per-iteration quantity
        residual_t = timed_function("SNESFunctionEval")(
            lambda zz: self.residual_masked(zz, params))
        linear_t = timed_function("KSPSolve", first_to="Warmup")(
            lambda zz, FF: self._linear_step(zz, FF, params, tstate))
        with timed_region("SNESSolve"):
            z, ninfo = newton(
                residual_t, linear_t,
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


class ScottVogeliusSolver(NavierStokesSolver):
    """[Pk]^d - DG(k-1) on barycentric meshes; exact grad-div
    (alfi/solver.py:608-662)."""

    def function_space(self, mesh, k):
        d = mesh.dim
        V = VectorFunctionSpace(mesh, lagrange(d, k))
        Q = FunctionSpace(mesh, dg_lagrange(d, k - 1))
        return MixedFunctionSpace(V, Q)

    def make_form(self):
        return NSForm(self.Z.V, self.Z.Q, graddiv_mode="exact",
                      rhs=self.problem.rhs(), device=self.device)
