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
              and Schoeberl transfers (:353-379);
* ``alamg`` — the same, velocity block by one smoothed-aggregation AMG
              V-cycle (:380-384), the algebraic baseline;
* ``simple``, ``lsc`` — gamma set to 0, velocity block by the AMG
              V-cycle, Schur complement by the pressure mass or the
              Least-Squares Commutator (:423-460),

on ``ConstantPressureSolver`` ([Pk]^d - P0) and ``ScottVogeliusSolver``
([Pk]^d - DG(k-1), exact grad-div), the uniform, bary and uniformbary
hierarchies, star and macrostar patches, and optional SUPG/GLS or
Burman stabilisation carried through the Newton Jacobian and the
multigrid level and patch operators; with the adjoint solve of a scalar
functional (:meth:`NavierStokesSolver.setup_adjoint`) and the velocity
prolonged to ``nref_vis`` extra refinements for output
(``visprolong``).  Every tensor lives on ``device``:
the card (``"cuda"``) unless the caller asks for another; nothing falls
back to another device.
"""

from __future__ import annotations

import time as _time

import torch

from .config import real_dtype
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
from .solvers.batched_lu import coarse_factor, coarse_solve
from .solvers.fieldsplit import (
    LSCSchurPC,
    SchurPC,
    pressure_laplacian,
    pressure_nullspace_projector,
)
from .solvers.krylov import fgmres
from .solvers.linear import (
    assemble_dense_mixed,
    assemble_dense_velocity,
    flatten_mixed,
    lu_solve_closure,
    make_assembled_jacobian_matvec,
    make_jacobian_matvec,
    make_jacobian_rmatvec,
    unflatten_mixed,
)
from .solvers.newton import newton
from .stabilisation import make_stabilisation
from .utils.events import host_read, spanned, timed_function, timed_region
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
        if solver_type not in ("lu", "allu", "almg", "alamg", "simple",
                               "lsc"):
            raise ValueError("solver_type %r" % solver_type)
        if patch_composition not in ("additive", "multiplicative"):
            raise ValueError("patch_composition %r" % patch_composition)
        # rebalance_vertices (the distributed partitioner's) takes only the
        # reference's default; use_mkl is accepted and unused, as in the
        # reference
        if rebalance_vertices:
            raise NotImplementedError(
                "rebalance_vertices is not ported yet: ROADMAP.md Queue 1 "
                "item 12b")
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
        if solver_type in ("simple", "lsc"):
            # the non-AL baselines run without grad-div augmentation
            # (alfi/solver.py:127-128)
            if self.verbose:
                print("Setting gamma to 0")
            self.gamma = 0.0
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
        self._setup_visprolong(nref_vis)

    def _setup_visprolong(self, nref_vis):
        """Visualisation refinement (the reference's visprolong,
        alfi/solver.py:135-162): ``visprolong(u)`` prolongs the velocity
        to ``nref_vis`` extra uniform refinements of the fine mesh and
        returns (u, mesh, space) there."""
        self.nref_vis = nref_vis
        if not nref_vis:
            self.visprolong = lambda u: (u, self.mesh, self.Z.V)
            return
        from .mesh.hierarchy import MeshHierarchy
        from .mesh.refine import refine_uniform
        from .mg.transfer import prolongation

        meshes = [self.mesh]
        for _ in range(nref_vis):
            meshes.append(refine_uniform(meshes[-1]))
        vh = MeshHierarchy(meshes, "uniform")
        elem = self.Z.V.element
        spaces = [self.Z.V] + [VectorFunctionSpace(m, elem)
                               for m in meshes[1:]]
        transfers = [prolongation(vh, l, spaces[l], spaces[l + 1],
                                  device=self.device)
                     for l in range(nref_vis)]

        def visprolong(u):
            for t in transfers:
                u = t.apply(u)
            return (u, meshes[-1], spaces[-1])

        self.visprolong = visprolong

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

            def make_pc(z, params, tstate):
                flat_solve = lu_solve_closure(
                    assemble_dense_velocity(form, z[0], params, mask_u))
                return SchurPC(form, mask_u, lambda rv: flat_solve(
                    rv.reshape(-1)).reshape(-1, d))

            lin = self._schur_fgmres_step(make_pc, project)
        elif self.solver_type == "almg":
            lin = self._build_almg_step(project)
        else:
            # alamg and simple: the mass-matrix Schur PC; lsc: the Least-
            # Squares Commutator
            lin = self._build_alamg_step(
                project, lsc=self.solver_type == "lsc")
        self._linear_step = lin

    def _schur_fgmres_step(self, make_pc, project):
        """The outer Krylov step of allu, almg and the AMG modes: FGMRES
        (maxit 500, restart 30) on the Jacobian under the Schur-complement
        preconditioner that ``make_pc(z, params, tstate)`` builds at each
        Newton step (kept as ``self._make_schur_pc`` for the adjoint).

        The Jacobian action: where the preconditioner holds the exact
        velocity block (``SchurPC.jacobian_A``: almg's finest level
        operator, assembled at the same state in f64), that block plus B^T
        and B (:func:`make_assembled_jacobian_matvec`: KM, and KB on a
        gamma-split state); else ``torch.func.jvp`` of the residual
        (:func:`make_jacobian_matvec`): allu, alamg, simple and lsc, whose
        set-up holds no such operator (a dense factor, an AMG hierarchy),
        and almg where the level operators are stored narrower than f64
        or the residual has pressure terms they lack (GLS, SUPG on a
        pressure of degree 1 or more)."""
        form, bcset = self.form, self.bcset
        tol = self.tolerances
        self._make_schur_pc = make_pc

        def lin(z, F, params, tstate):
            schur = make_pc(z, params, tstate)
            pc = schur.make_apply(params)
            if schur.jacobian_A is not None:
                J = make_assembled_jacobian_matvec(form, bcset,
                                                   schur.jacobian_A)
            else:
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

        form, mask_u = self.form, self.bcset.mask[0]
        # the finest level operator (nu K + advect (N + the stabilisation's
        # velocity terms) + gamma G at z) is the Newton Jacobian's velocity
        # block; the Jacobian is that block plus B^T and B where the
        # residual has no other pressure term: no stabilisation, Burman's
        # (its facet Jacobians merged in), or SUPG on a P0 pressure (the
        # strong residual's grad p vanishes); not GLS (pressure rows
        # (Lu, grad q)), nor SUPG on a pressure of degree 1 or more
        st, L = self.stabilisation, vmg.nlevels - 1
        exact = L > 0 and (
            st is None or st.has_facet_tensors
            or (st.impl.mode == "supg" and self.Z.Q.element.degree == 0))

        def make_pc(z, params, tstate):
            state = vmg.setup(z[0], params, schoeberl_state=tstate,
                              static=static, p_fine=z[1])
            vals = state["level_ops"][L]
            jacobian_A = None
            if exact and (vals["M"] if isinstance(vals, dict)
                          else vals).dtype == real_dtype:
                # an f32-stored or f32-cycle state keeps the jvp: its
                # rounded operator would change the outer result
                def jacobian_A(u):
                    return vmg.level_apply(L, vals, u)
            return SchurPC(form, mask_u, vmg.make_solve_A(state),
                           jacobian_A=jacobian_A)

        return self._schur_fgmres_step(make_pc, project)

    def _build_alamg_step(self, project, lsc=False):
        """The AMG modes' step: the velocity solve is one AMG V-cycle at
        each Newton step; with ``lsc`` the Schur PC is LSCSchurPC, whose
        B A B^T applies the AMG fine operator of the same set-up."""
        from .mg.amg import VelocityAMG

        self.vamg = VelocityAMG(self)
        vamg = self.vamg
        form, mask_u = self.form, self.bcset.mask[0]
        # B M B^T depends on the mesh and the BCs only
        L = pressure_laplacian(form, mask_u) if lsc else None

        def make_pc(z, params, tstate):
            state = vamg.setup(z[0], params, p_fine=z[1])
            solve_A = vamg.make_solve_A(state)
            if L is None:
                return SchurPC(form, mask_u, solve_A)
            return LSCSchurPC(form, mask_u, solve_A,
                              lambda v: vamg.level_apply(state["vals"], v),
                              self.nsp, L=L)

        return self._schur_fgmres_step(make_pc, project)

    # ------------------------------------------------------------------
    def setup_adjoint(self, functional):
        """Adjoint solve of a scalar functional J(z) (alfi/solver.py:
        520-535: the reference forms L = F.z_adj + J and solves
        derivative(L, z) = 0, the linear system F_z(z)^T z_adj = -dJ/dz
        with homogenised BCs, reusing the solver's parameters).
        ``functional``: (u, p) -> 0-d tensor, differentiable by
        torch.func.  Call :meth:`solve_adjoint` after a forward solve."""
        self._adjoint_functional = functional

    def solve_adjoint(self):
        """Solve the adjoint system at the current state; returns (z_adj,
        info_dict).  The operator is the transposed masked Jacobian, M
        J^T M v + (I - M) v, with J^T from one torch.func.vjp of the
        residual at z.  ``lu`` solves with the transpose of the dense
        mixed matrix (the other branch of the same in-place factors),
        refined once against that operator; the Krylov modes run FGMRES on
        it under the forward mode's Schur PC at the current state (a legal
        FGMRES preconditioner for J^T; PETSc assembles the exact
        transpose)."""
        functional = getattr(self, "_adjoint_functional", None)
        if functional is None:
            raise RuntimeError("call setup_adjoint(functional) first")
        params = self.params()
        z = self.z
        bcset, form, Z = self.bcset, self.form, self.Z
        tol = self.tolerances
        project = pressure_nullspace_projector(Z) if self.nsp else None

        # homogenised adjoint rhs: -dJ/dz, zero at BC dofs
        rhs = bcset.zero(torch.func.grad(functional)(z))
        if project is not None:
            rhs = project(rhs)

        JT = make_jacobian_rmatvec(form.residual, bcset, z, params)
        start = _time.perf_counter()
        if self.solver_type == "lu":
            # the transpose solve, then one step of f64 iterative
            # refinement against the matrix-free J^T: at the bench config
            # (kappa ~ 1e10) the solve alone leaves a residual of 2e-6
            # relative to dJ/dz
            fac = coarse_factor(assemble_dense_mixed(form, z, params, bcset))
            b = -flatten_mixed(rhs)
            x = coarse_solve(fac, b, transpose=True)
            r = b - flatten_mixed(JT(unflatten_mixed(x, Z)))
            x = x + coarse_solve(fac, r, transpose=True)
            del fac
            z_adj = bcset.zero(unflatten_mixed(x, Z))
            iters = 1
        else:
            pc = self._make_adjoint_pc(z, params,
                                       self._transfer_setup(params))
            z_adj, info = fgmres(
                JT, tscale(-1.0, rhs), pc=pc, rtol=tol["ksp_rtol"],
                atol=tol["ksp_atol"], maxit=500, restart=30,
                project=project)
            z_adj = bcset.zero(z_adj)
            iters = int(info["iters"])
        elapsed = _time.perf_counter() - start
        if self.nsp:
            u, p = z_adj
            z_adj = (u, p - torch.mean(p))
        self.z_adj = z_adj
        self.message(GREEN % (
            "Adjoint solve in %d Krylov iterations (%.2f s)"
            % (iters, elapsed)))
        return z_adj, {"linear_iter": iters, "time": elapsed / 60.0}

    def _make_adjoint_pc(self, z, params, tstate):
        """The forward mode's Schur PC at the current state (for the AMG
        modes too, which the JAX package's adjoint does not build); for
        allu the dense velocity block's factors solved by their
        transpose."""
        if self.solver_type != "allu":
            return self._make_schur_pc(z, params, tstate).make_apply(params)
        mask_u = self.bcset.mask[0]
        fac = coarse_factor(assemble_dense_velocity(self.form, z[0], params,
                                                    mask_u))
        d = self.tdim

        def solve_A(rv):
            return coarse_solve(fac, rv.reshape(-1),
                                transpose=True).reshape(-1, d)

        return SchurPC(self.form, mask_u, solve_A).make_apply(params)

    # ------------------------------------------------------------------
    def message(self, msg):
        if self.verbose:
            print(msg)

    @spanned("alfi.re_step")
    def solve(self, re, hooks=None):
        """Solve at Reynolds number ``re`` (continuation from the current
        state), mirroring alfi/solver.py:257-303.

        ``hooks``: what the Newton loop runs on, by the methods
        ``_newton_pieces``, ``_solve_norm``, ``_shift_pressure``,
        ``_to_local`` and ``_to_global`` (a DistributedSolver: its rank's
        arrays and reductions); none: this solver's own.  The solver's
        state stays the global one."""
        h = self if hooks is None else hooks
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
        residual, linear, residual_ngd = h._newton_pieces(params)
        # the first linear step builds the kernel and initialises cuBLAS
        # and cuSOLVER: attribute it to a warm-up event so that KSPSolve
        # stays a per-iteration quantity
        residual_t = spanned("alfi.residual")(
            timed_function("SNESFunctionEval")(residual))
        linear_t = spanned("alfi.linear_step")(
            timed_function("KSPSolve", first_to="Warmup")(linear))
        with timed_region("SNESSolve"):
            z, ninfo = newton(
                residual_t, linear_t,
                h._to_local(self.z), maxit=20, rtol=tol["snes_rtol"],
                atol=tol["snes_atol"], stol=tol["snes_stol"],
                monitor=monitor if self.verbose else None,
                norm=h._solve_norm)
        elapsed = _time.perf_counter() - start
        self.message(GREEN % (
            "Nonlinear solve %s in %d iterations (%s)" % (
                "converged" if ninfo.converged else "DIVERGED",
                ninfo.nonlinear_iter, ninfo.reason)))

        if self.nsp:
            z = h._shift_pressure(z)
        if ninfo.converged:
            self.z = h._to_global(z)
        else:
            # keep the last CONVERGED state as the continuation iterate:
            # carrying a diverged (possibly NaN) z forward poisons every
            # later Re step
            self.z = self.z_last
            z = h._to_local(self.z)

        # gamma-free residual sanity check (alfi/solver.py:282-291); the
        # residual with the grad-div term only feeds the message (a
        # distributed solve's norm is a collective: every rank takes it)
        self.residual_no_graddiv = host_read(h._solve_norm(residual_ngd(z)))
        self.message(BLUE % ("Residual without grad-div term: %.14e"
                             % self.residual_no_graddiv))
        if self.verbose or hooks is not None:
            self.message(BLUE % ("Residual with grad-div term:    %.14e"
                                 % host_read(h._solve_norm(residual(z)))))

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

    # the Newton loop's pieces on this solver's own arrays (solve's hooks)
    def _newton_pieces(self, params):
        """(residual(z), linear(z, F), gamma-free residual(z)) at
        ``params``; the transfer operators depend only on (nu, gamma):
        built once per Re."""
        tstate = self._transfer_setup(params)
        params_ngd = dict(params, gamma=0.0)
        return (lambda zz: self.residual_masked(zz, params),
                lambda zz, FF: self._linear_step(zz, FF, params, tstate),
                lambda zz: self.residual_masked(zz, params_ngd))

    def _solve_norm(self, v):
        return tnorm(v)

    def _shift_pressure(self, z):
        """The state with its pressure's mean removed."""
        u, p = z
        pint = host_read(self.form.pressure_integral(p))
        return (u, p - pint / self.area)

    def _to_local(self, z):
        return z

    def _to_global(self, z):
        return z


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
