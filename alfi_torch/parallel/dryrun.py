"""Spawned rank groups, and the multi-rank dryrun.

:func:`spawn_ranks` runs a function on each rank of an n-rank group, one
spawned process per rank (a clean interpreter: nothing of the parent's
state), the ranks joined by a file store in a fresh temporary directory,
so that groups never clash over a port.  It returns every rank's result,
and raises when a rank fails or the group has not finished within its
time limit; either way it stops every process it started.  The function
must be importable by the children (a module-level function of a module,
or of the script that was run).

:func:`dryrun_multichip` is the twin of the JAX package's
``__graft_entry__.py:dryrun_multichip``: one SUPG-stabilised Re=1000
Newton step of the flagship almg solve (ldc2d ``[P2]^2-P0``, baseN=4,
nref=1), distributed over ``n`` ranks.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback


def _rank_main(fn, rank, n, args, device, store, threads, out):
    import torch
    import torch.distributed as dist

    from .sharding import make_rank_group

    # a spawned rank yields the host's cores to whatever else runs there
    # (the caller's own work, other test workers); alone it runs as fast
    os.nice(10)
    if threads:
        torch.set_num_threads(threads)
    try:
        group = make_rank_group(n, device=device,
                                init_method="file://" + store, rank=rank)
        result = fn(group, *args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, n, args=(), *, device="cuda", timeout=600.0,
                threads=1):
    """[fn(group, *args) of rank 0, ..., of rank n-1], each on its own
    spawned process, ``group`` its :class:`RankGroup` on ``device`` (see
    ``parallel/sharding.py:make_rank_group``).  ``threads``: torch threads
    per rank (0: torch's default).  Raises RuntimeError naming the failed
    rank and its traceback, or TimeoutError after ``timeout`` seconds;
    every process is stopped before it returns or raises."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="alfi_torch_ranks_")
    store = os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, tuple(args), device, store, threads,
                               out), daemon=True)
             for r in range(n)]
    results = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < n:
            try:
                rank, ok, value = out.get(timeout=0.5)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "spawn_ranks: %d of %d ranks unfinished after %.0f s"
                        % (n - len(results), n, timeout))
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if dead:
                    raise RuntimeError(
                        "spawn_ranks: rank %d exited with code %s and no "
                        "result" % (dead[0], procs[dead[0]].exitcode))
                continue
            if not ok:
                raise RuntimeError("spawn_ranks: rank %d failed:\n%s"
                                   % (rank, value))
            results[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n)]


def _dryrun_rank(group):
    import numpy as np
    import torch

    from .distributed import DistributedSolver

    solver = ldc_solver(group.device, re=1000.0, stabilisation_type="supg")
    dist = DistributedSolver(solver, group)
    z, params = dist.shard_state(solver.z, solver.params())
    z2, its = dist.newton_step(z, params)
    state = dist.gather_state(z2)
    du = float(torch.max(torch.abs(state[0])))
    if not np.isfinite(du):
        raise AssertionError("the distributed Newton step produced a "
                             "non-finite state")
    return {"du": du, "its": its, "state": _np(state),
            "device": str(group.device), "backend": group.backend}


#: how close (relative norms of u, p) the dryrun's gathered state must be
#: to :func:`dryrun_reference`'s.  From rest at Re=1000 the step is poorly
#: determined: the single device's own steps at ksp_rtol 1e-9 and 1e-13
#: differ by 3e-4 (u) and 6e-4 (p).  A distributed step follows the single
#: device's Krylov path, so it comes much closer: on the CPU at 1, 2 and 8
#: ranks within 6e-9 (u) and 8e-7 (p), the p gap the same at ksp_rtol
#: 1e-13 (rounding the ill-conditioned pressure block amplifies)
DRYRUN_TOL = (1e-7, 1e-5)


def dryrun_reference(device):
    """The dryrun's Newton step on one device (no group): the state after
    it (numpy (u, p)) and its FGMRES count, which every rank's must
    match."""
    solver = ldc_solver(device, re=1000.0, stabilisation_type="supg")
    params = solver.params()
    z = solver.z
    F = solver.residual_masked(z, params)
    dz, its = solver._linear_step(z, F, params,
                                  solver._transfer_setup(params))
    return _np((z[0] + dz[0], z[1] + dz[1])), int(its)


def dryrun_multichip(n, device="cuda", timeout=900.0):
    """One distributed SUPG-stabilised Re=1000 Newton step on an n-rank
    group; prints its ok line and returns the ranks' results (each with
    the gathered state, numpy); raises if a rank fails, if the ranks
    disagree (the states bit for bit), or after ``timeout`` seconds.

    ``device``: "cuda" (a card per rank under NCCL when the host has n
    cards, else every rank on ``cuda:0`` under gloo, as the ok line says);
    an explicit ``cuda:K`` (every rank on it); or "cpu" (gloo)."""
    import torch

    if device == "cuda" and torch.cuda.device_count() < n:
        device = "cuda:0"
    res = spawn_ranks(_dryrun_rank, n, device=device, timeout=timeout)
    if any((r["du"], r["its"]) != (res[0]["du"], res[0]["its"])
           or any((a != b).any() for a, b in zip(r["state"],
                                                  res[0]["state"]))
           for r in res):
        raise AssertionError("dryrun_multichip(%d): the ranks disagree: %s"
                             % (n, res))
    print("dryrun_multichip(%d): one SUPG-stabilised Re=1000 Newton step "
          "(block-decomposed almg: interface sums, owner-weighted dots, "
          "replicated coarse solve; %s, ranks on %s) on a %d-rank group ok, "
          "|u| max %.3e, fgmres iters %d"
          % (n, res[0]["backend"], ", ".join(sorted(
              {r["device"] for r in res})), n, res[0]["du"], res[0]["its"]),
          flush=True)
    return res


# ----------------------------------------------------------------------
# rank functions of the distributed checks (the CPU tests and the card's
# smoke run spawn them; results are numpy, gathered to every rank)
# ----------------------------------------------------------------------
def ldc_solver(device, baseN=4, nref=1, re=None, **kw):
    """The ldc2d ``[P2]^2-P0`` almg solver (uniform hierarchy, star
    patches, gamma 1e4) of the distributed checks; with ``re``, its
    parameters set to that Reynolds number."""
    from ..problems import TwoDimLidDrivenCavityProblem
    from ..solver import ConstantPressureSolver

    solver = ConstantPressureSolver(
        TwoDimLidDrivenCavityProblem(baseN), nref=nref, k=2,
        solver_type="almg", hierarchy="uniform", gamma=1e4, verbose=False,
        device=device, **kw)
    if re is not None:
        solver.advect_val = 1.0
        solver.nu_val = solver.char_L * solver.char_U / re
    return solver


def _np(z):
    return tuple(x.detach().cpu().numpy() for x in z)


def step_rank(group, kw, re, state=None):
    """One distributed residual and linear step of ``ldc_solver(**kw)`` at
    Re ``re``, at ``state`` (numpy (u, p), also the frozen wind) or, with
    None, after one single-device Newton step from rest.  Returns the
    gathered residual ``F`` and step ``dz`` (numpy), the Krylov count
    ``its``, the ``state``; rank 0 also the single-device ``F_ref``,
    ``dz_ref``, ``its_ref``."""
    import torch

    from .distributed import DistributedSolver

    solver = ldc_solver(group.device, re=re, **kw)
    if state is None:
        p0 = solver.params()
        F0 = solver.residual_masked(solver.z, p0)
        dz0, _ = solver._linear_step(solver.z, F0, p0,
                                     solver._transfer_setup(p0))
        solver.z = (solver.z[0] + dz0[0], solver.z[1] + dz0[1])
    else:
        solver.z = tuple(torch.as_tensor(x, device=group.device)
                         for x in state)
    solver.z_last = solver.z
    params = solver.params()
    dist = DistributedSolver(solver, group)
    z, pr = dist.shard_state(solver.z, params)
    F, _ = dist.residual(z, pr)
    dz, its = dist.linear_step(z, F, pr, dist.transfer_setup(pr))
    out = {"F": _np(dist.gather_state(F)), "dz": _np(dist.gather_state(dz)),
           "its": its, "state": _np(solver.z)}
    if group.rank == 0:
        Fg = solver.residual_masked(solver.z, params)
        dzg, itg = solver._linear_step(solver.z, Fg, params,
                                       solver._transfer_setup(params))
        out.update(F_ref=_np(Fg), dz_ref=_np(dzg), its_ref=int(itg))
    return out


def solve_rank(group, kw, res):
    """The distributed continuation of ``ldc_solver(**kw)`` over ``res``:
    per Re its record and seconds, the gathered final state (numpy), the
    collectives run, and on a card the rank's peak device memory."""
    import time as _t

    import torch

    from .distributed import DistributedSolver

    solver = ldc_solver(group.device, **kw)
    dist = DistributedSolver(solver, group)
    if group.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(group.device)
    infos, seconds = [], []
    for re in res:
        t0 = _t.perf_counter()
        _, info = dist.solve(re)
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        seconds.append(_t.perf_counter() - t0)
        infos.append(info)
    out = {"infos": infos, "seconds": seconds, "state": _np(solver.z),
           "calls": group.calls}
    if group.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(group.device)
    return out


def bits_rank(group, kw, seed=0):
    """What every rank must hold bit for bit: an owner-weighted dot of two
    random vectors (each rank its own draws), the fine level's interface
    values after one exchange (by global flat dof), and the global coarse
    right-hand side of a random level-0 vector."""
    import numpy as np
    import torch

    from .distributed import DistributedSolver

    solver = ldc_solver(group.device, **kw)
    dist = DistributedSolver(solver, group)
    rng = np.random.default_rng(seed + group.rank)
    lvf, lv0 = dist.lv[-1], dist.lv[0]

    def draw(lv):
        v = torch.as_tensor(rng.standard_normal((lv.L + 1, dist.d)),
                            device=group.device)
        v[-1] = 0.0
        return v

    a, b = draw(lvf), draw(lvf)
    dot = float(dist._ctx().dot((a, dist.qweight), (b, dist.qweight)))
    x = dist._exchange(lvf, draw(lvf))
    levf = dist.levs[-1]
    li = lvf.lidx.cpu().numpy()
    gd = levf.gdofs[group.rank][li]
    flat = (gd[:, None] * dist.d + np.arange(dist.d)).reshape(-1)
    return {"dot": dot, "interface_dofs": flat,
            "interface": x[lvf.lidx].cpu().numpy().reshape(-1),
            "coarse_rhs": dist._coarse_rhs(draw(lv0)).cpu().numpy()}


def driver_rank(group, argv):
    """``alfi_torch.examples.iters.main(argv)`` on this rank (the group
    already made: ``get_solver`` joins it); returns what the rank
    printed."""
    import contextlib
    import io

    from ..examples import iters

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        iters.main(list(argv))
    return buf.getvalue()


def batch_rank(group, calls):
    """Several of this module's rank functions on one group, in order:
    ``calls`` = [(name, args)]; returns their results (one spawn for a
    file's checks)."""
    return [globals()[name](group, *args) for name, args in calls]
