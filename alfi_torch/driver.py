"""Shared CLI and Reynolds-continuation experiment loop.

Mirrors the JAX package's ``driver.py`` (and through it the reference's
alfi/driver.py): the same flags, solver dispatch, and the
try-load-checkpoint-else-solve continuation loop with per-Re npz
checkpoints keyed ``checkpoint/<ndofs>/nssolution-Re-<re>.npz``, in the
layout both packages read and write (alfi_torch/interop.py).

A choice the port does not have yet raises ``NotImplementedError``
naming its ROADMAP.md item; nothing falls back to another mode.
"""

from __future__ import annotations

import argparse
import os
import shutil
import zipfile

import numpy as np

from .interop import (
    INFO_KEYS,
    numbering_tag,
    save_checkpoint,
    state_from_numpy,
)
from .solver import BLUE, GREEN, ConstantPressureSolver, ScottVogeliusSolver
from .utils.events import EVENTS


def get_default_parser():
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--nref", type=int, default=1)
    parser.add_argument("--nref-vis", type=int, default=0)
    parser.add_argument("--baseN", type=int, default=16)
    parser.add_argument("--k", type=int, default=2)
    parser.add_argument("--stabilisation-weight", type=float, default=None)
    parser.add_argument("--solver-type", type=str, default="almg",
                        choices=["lu", "allu", "almg", "alamg",
                                 "simple", "lsc"])
    parser.add_argument("--patch", type=str, default="star",
                        choices=["star", "macro"])
    parser.add_argument("--patch-composition", type=str, default="additive",
                        choices=["additive", "multiplicative"])
    parser.add_argument("--mh", type=str, default="uniform",
                        choices=["uniform", "bary", "uniformbary"])
    parser.add_argument("--stabilisation-type", type=str, default=None,
                        choices=["none", "burman", "gls", "supg"])
    parser.add_argument("--discretisation", type=str, required=True,
                        choices=["pkp0", "sv"])
    parser.add_argument("--gamma", type=float, default=1e4)
    parser.add_argument("--clear", dest="clear", default=False,
                        action="store_true")
    parser.add_argument("--time", dest="time", default=False,
                        action="store_true")
    parser.add_argument("--mkl", dest="mkl", default=False,
                        action="store_true")
    parser.add_argument("--checkpoint", dest="checkpoint", default=False,
                        action="store_true")
    parser.add_argument("--paraview", dest="paraview", default=False,
                        action="store_true")
    parser.add_argument("--restriction", dest="restriction", default=False,
                        action="store_true")
    parser.add_argument("--rebalance", dest="rebalance", default=False,
                        action="store_true")
    parser.add_argument("--high-accuracy", dest="high_accuracy",
                        default=False, action="store_true")
    parser.add_argument("--smoothing", type=int, default=None)
    parser.add_argument("--ndevices", type=int, default=1)
    return parser


def get_solver(args, problem, hierarchy_callback=None, *, device="cuda"):
    """The solver of ``args`` (the solver itself rejects what the port
    has not ported yet, naming its ROADMAP.md item); --mkl is accepted
    and unused, as in the JAX package.

    ``--ndevices N`` > 1: this process's rank of an N-rank group
    (``torchrun --nproc-per-node N``; raises outside one, naming it) runs
    the DistributedSolver over the solver, on ``device`` as
    ``parallel/sharding.py:make_rank_group`` reads it (``cuda``: a card
    per rank under NCCL; ``cuda:0``: every rank on one card under gloo;
    ``cpu``: gloo).  Only rank 0 prints."""
    verbose = True
    group = None
    if args.ndevices > 1:
        from .parallel.sharding import make_rank_group

        group = make_rank_group(args.ndevices, device=device)
        device, verbose = group.device, group.rank == 0
    solver_t = {"pkp0": ConstantPressureSolver,
                "sv": ScottVogeliusSolver}[args.discretisation]
    solver = solver_t(
        problem,
        solver_type=args.solver_type,
        stabilisation_type=args.stabilisation_type,
        nref=args.nref,
        k=args.k,
        gamma=args.gamma,
        nref_vis=args.nref_vis,
        patch=args.patch,
        use_mkl=args.mkl,
        supg_method="shakib",
        stabilisation_weight=args.stabilisation_weight,
        hierarchy=args.mh,
        patch_composition=args.patch_composition,
        restriction=args.restriction,
        smoothing=args.smoothing,
        rebalance_vertices=args.rebalance,
        high_accuracy=args.high_accuracy,
        hierarchy_callback=hierarchy_callback,
        verbose=verbose,
        device=device,
    )
    if group is None:
        return solver
    from .parallel.distributed import DistributedSolver

    return DistributedSolver(solver, group)


def performance_info(solver):
    """Per-event timing report, mirroring alfi/driver.py:77-92 with the
    same metric (time and time-per-1k-dofs, sorted by cost), over the
    host-timed events of the solve loop (SNESSolve, KSPSolve,
    SNESFunctionEval and the warm-up)."""
    print(BLUE % "Some performance info:")
    ndofs = solver.Z.dim
    rows = sorted(EVENTS.items(), key=lambda kv: -kv[1]["time"])
    for name, v in rows:
        print(GREEN % (("%s:" % name).ljust(30)
                       + "Time = % 6.2fs, Time/1kdofs = %.2fs, Count = %d"
                       % (v["time"], 1000 * v["time"] / ndofs, v["count"])))
    if rows:
        t = rows[0][1]["time"]
        print(BLUE % ("% 5.1fs \t % 4.2fs \t %i" % (t, 1000 * t / ndofs,
                                                    ndofs)))


def _nearest_full_checkpoint(chkptdir, re_lo, re_hi):
    """Largest-Re full (u/p, converged, numbering-matching) checkpoint
    with re_lo < Re < re_hi, or None: the warm start of a cache-miss
    re-solve below the continuation frontier, when the rows before it
    were table-only checkpoints that left solver.z cold."""
    best = None
    try:
        names = os.listdir(chkptdir)
    except OSError:
        return None
    for f in names:
        if not (f.startswith("nssolution-Re-") and f.endswith(".npz")
                and ".tmp" not in f):
            continue
        try:
            f_re = float(f[len("nssolution-Re-"):-len(".npz")])
        except ValueError:
            continue
        if not (re_lo < f_re < re_hi):
            continue
        if best is not None and f_re <= best[0]:
            continue
        try:
            with np.load(os.path.join(chkptdir, f)) as chk:
                if ("u" in chk.files
                        and (bool(chk["converged"])
                             if "converged" in chk.files else True)
                        and (str(chk["numbering"])
                             if "numbering" in chk.files else "legacy0")
                        == numbering_tag()):
                    best = (f_re, chk["u"], chk["p"])
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            continue  # truncated or corrupt npz: not a warm-start source
    return best


def run_solver(solver, res, args):
    """The continuation over ``res`` with checkpoints.  A distributed
    solver's ranks all solve; rank 0 alone prints the records and writes
    the checkpoints (the gathered global state, as a single-device run's)
    and the VTU files, and the ranks wait for each write."""
    rank = getattr(solver, "rank", 0)
    sync = getattr(solver, "barrier", lambda: None)
    problemsize = solver.Z.dim
    outdir = "output/%i/" % problemsize
    chkptdir = "checkpoint/%i/" % problemsize
    if args.clear:
        if rank == 0:
            shutil.rmtree(chkptdir, ignore_errors=True)
            shutil.rmtree(outdir, ignore_errors=True)
        sync()
    if args.checkpoint:
        os.makedirs(chkptdir, exist_ok=True)
    results = {}
    warm_re = float("-inf")  # Re whose state solver.z currently holds
    for re in res:
        path = chkptdir + "nssolution-Re-%s.npz" % re
        try:
            with np.load(path) as chk:
                if ("converged" in chk.files
                        and not bool(chk["converged"])):
                    # a checkpoint of a diverged solve: retry it
                    raise KeyError("diverged checkpoint")
                if "u" in chk.files:
                    stored_numbering = (str(chk["numbering"])
                                        if "numbering" in chk.files
                                        else "legacy0")
                    if stored_numbering != numbering_tag():
                        # dof vectors laid out under another entity
                        # numbering would load scrambled
                        raise KeyError("numbering mismatch: %s != %s"
                                       % (stored_numbering, numbering_tag()))
                    solver.z = state_from_numpy(chk["u"], chk["p"],
                                                solver.device)
                    warm_re = re
                elif "linear_iter" not in chk.files:
                    raise KeyError("empty checkpoint")
                # else: a table-only checkpoint (the solve record without
                # the state); the state for later steps comes from the
                # full checkpoint at the continuation frontier
                if "linear_iter" in chk.files:
                    info = {k: chk[k].item() for k in INFO_KEYS
                            if k in chk.files}
                else:
                    info = {"nu": None, "linear_iter": 0,
                            "nonlinear_iter": 0, "time": 0.0,
                            "converged": True}
            results[re] = dict(info, Re=re, checkpointed=True)
        except (FileNotFoundError, OSError, KeyError, ValueError,
                zipfile.BadZipFile):
            # BadZipFile/ValueError: a truncated npz must trigger a
            # re-solve, not crash the sweep
            if args.checkpoint and warm_re < re:
                # cache miss below the frontier: solver.z may still be
                # cold (all earlier rows were table-only); warm-start
                # from the nearest lower full checkpoint if one exists
                found = _nearest_full_checkpoint(chkptdir, warm_re, re)
                if found is not None:
                    print("Warm-starting Re = %s from checkpoint "
                          "Re = %g" % (re, found[0]))
                    solver.z = state_from_numpy(found[1], found[2],
                                                solver.device)
                    warm_re = found[0]
            z, info_dict = solver.solve(re)
            if info_dict.get("converged", True):
                warm_re = re
            results[re] = info_dict
            # never checkpoint a diverged solve: a resumed sweep would
            # skip the failed Re with a poisoned state
            if (args.checkpoint and info_dict.get("converged", True)
                    and rank == 0):
                save_checkpoint(path, z, info_dict)
            sync()
        if args.paraview and rank == 0:
            os.makedirs(outdir, exist_ok=True)
            from .utils.vtk import write_velocity_vtu, write_vtu

            write_vtu(outdir + "velocity-Re-%s.vtu" % re, solver.mesh,
                      solver.Z, [x.cpu().numpy() for x in solver.z])
            if solver.nref_vis:
                uvis, vmesh, _ = solver.visprolong(solver.z[0])
                write_velocity_vtu(
                    outdir + "velocity-refined-Re-%s.vtu" % re, vmesh,
                    uvis.cpu().numpy())
    if rank == 0:
        for re in results:
            print(results[re])
        if args.time:
            performance_info(solver)
    return results
