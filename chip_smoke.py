#!/usr/bin/env python3
"""Smoke test of the alfi_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``alfi_torch/csrc`` (one nvcc per source,
   started together) and print the seconds; then build the solvers whose
   tables phases 3 to 3b read (the seconds include the merged level
   operators' host patterns);
3. hold the fused gather-GEMV-scatter kernel against its plain PyTorch
   version on the card at every 2D main-path shape (the bench config's K1
   smoother and K1 Schoeberl tables of levels 2 and 1, and the nref=3
   fine level's K1 table), each bare and masked (the main path's
   masks; the Schoeberl tables, which the main path calls bare, with
   their coarse-skeleton mask in and out), on random f64 inputs from
   ``numpy.random.default_rng(0)``:
   max relative error <= 1e-13 and two launches bitwise equal; print the
   eager and device times of kernel, plain version and one cuSPARSE CSR
   SpMV of the same operator (``library``), the kernel's device time with
   L2 cold, its bound, the bytes of A the kernel loads beside the bytes
   the bound counts and the rate on the bytes loaded, and the device time
   of the source's other kernel (pair or strided) where the table allows
   both;
3a. the same at the 3D shapes: the K1 smoother (m = 189) and K1
   Schoeberl (m = 27) tables of ldc3d [P2+FB]^3 baseN=4 nref=2, levels 2
   and 1 (level 1's tables are the fine tables of nref=1), and the
   [P1+FB]^3 fine tables of the 3D step on its gmsh mesh (m = 201, 24);
3b. the same at the Scott-Vogelius tables: the K1 macrostar smoother
   tables of the fine levels of phases 11 (2D, m = 62, the pair kernel)
   and 12 (3D, m = 1590, the strided kernel); then, for every level table
   the main paths apply (the 2D headline's levels 2 and 1, nref=3's fine
   level, the 3D scale row's levels 2 and 1, the step's level 1, the SV
   fine levels of phases 11 and 12), the merged level operator: KA, the
   assembly of the cell (and Burman facet) tensors into merged values,
   and KM, its apply, each against its plain version (max relative error
   <= 1e-13, two launches bitwise equal), with device times warm and
   cold, the bound, the plain version, the library call on the same data
   (``index_add_`` on KA's map; cuSPARSE on the merged operator), KM at
   half and twice its lanes, and the blocked route beside it (the fused
   kernel over the cell blocks, plus the facet blocks with Burman); then
   ``torch.linalg.inv`` (the patch factorisation, a library call) at the
   3D batches (4913, 189, 189) and (729, 189, 189) and both macrostar
   batches, beside its bound, with the bytes of the 3D SV inverse table
   and the peak device memory of that call;
3c. the same at the per-colour K1 tables of the multiplicative sweep
   (phase 16's solvers: the bench config's levels 2 and 1 and the 3D
   cavity baseN=2 nref=1's level 1), each as its sweep calls it (bare),
   with the number of colours and the launches per symmetrised sweep;
3d. KA over the AMG Galerkin map of the bench config (phase 18's alamg
   solver: 1,020,100 dense entries of the level-1 matrix from about 118 M
   per-cell contributions, those of zero weight left out) against its
   plain version (<= 1e-13 relative, two launches bitwise equal), with
   device times warm and cold, the byte bound (sources, map, output) and
   ``index_put_(accumulate=True)`` of the same contributions as the
   library call; KM on the AMG fine operator is 3b's "level L2" table
   (the same pattern, checked), not timed again;
3e. the precision modes' kernels against their plain versions at every
   table phases 17 and 20 drive them at: K1 in f32 at the bench config's
   and the 3D scale row's smoother tables (out-masked), levels 2 and 1
   (4,913 x 189 at 3D L2), 1e-5 (f32 sums); KL, the f32 LU solve, at the
   bench config's Schoeberl tables (2,048 and 512 x 6; the f32 LU factors
   of the transfer matrices at Re 100's viscosity), 1e-4, and on f64
   vectors at phase 17's f32-stored smoother tables (overlapping, two
   launches), 1e-5; KM in its three mixed modes (f64 values on f32
   vectors, f32 values on f64 vectors, f32 on f32) at levels 2 and 1 of
   the bench config and the 3D scale row, 1e-6, 1e-13 and 1e-5, and KM
   with KB's dof stage as its epilogue in the split level apply's modes
   (store32 and the f32 cycle at the bench config, store32 in 3D); KB's
   cell stage at the bench config's masked levels 2 and 1 on f64 and f32
   vectors and at the 3D scale row's on f64 vectors, 1e-13 (both of KB's
   stages timed beside it, the launches the two-stage design made), and
   both
   stages raw (the Schoeberl transfers') on f32 vectors, 1e-6; besides,
   K1 f32 at the SV 3D L1 table (125 x 1,590) and KB at SV 2D L2, shapes
   phase 20 does not run; two launches bitwise equal; device times,
   bounds, plain versions and cuSPARSE in the same (KM: the promoted)
   dtype (for KB on gamma G as CSR, for KM+KB on the split operator as
   one CSR matrix), ``torch.linalg.lu_solve`` on the gathered batch for
   KL;
4. the port's reference parity: the small config (ldc2d baseN=4 nref=1)
   must take the JAX package's Krylov/Newton counts 8/2, 7/2, 15/3 over
   Re 1/10/100, and with SUPG (shakib) and --restriction 7/2, 7/2, 16/3;
5. the bench config (ldc2d [P2]^2-P0 almg, baseN=16, nref=2, 41,474
   dofs, the configuration of ``bench.py``): warm up with Re=1, reset the
   state, time Re 1 -> 10 -> 100; every Re must converge, with 22 Krylov
   iterations and 7 Newton steps in all, and the main path must have
   launched the fused kernel for K1 and KM and KA at every level it
   applies (and the blocked level matvec never); then one Newton linear
   step is
   traced with torch.profiler (kernel count, device busy share, kernel
   time by name);
6. the same problem at nref=3 (164,866 dofs) for Re 1 -> 10 must
   converge;
7. the papers' headline protocol through the port's own driver
   (get_default_parser / get_solver / run_solver, as examples/iters.py
   runs it): the bench config with SUPG (shakib), --restriction and
   --checkpoint in a temporary directory, over Re 1, 10, 100, 200, ...,
   1000.  Every Re must converge to a finite state; Re 1, 10, 100 must
   take the JAX package's counts exactly, and Re 200-1000 its Newton
   count and at most its Krylov count plus one per Newton step; the
   launches as in phase 5.  One Newton
   linear step of the Re=1000 solve is traced as in phase 5.  A second
   run of the same solver over the same ladder must load all 12
   checkpoints, solve nothing and reproduce every count;
8. 3D parity: ldc3d baseN=2 nref=1 over Re 1/10/100 must take the JAX
   package's counts, 6/2, 5/2, 6/3 with [P2+FB]^3 (k=2) and 9/2, 6/2,
   9/3 with [P1+FB]^3 (k=1, through BubbleTransfer);
9. the 3D scale row at full width, through the driver as phase 7: ldc3d
   [P2+FB]^3-P0, baseN=4, nref=2 (284,451 dofs), SUPG, --restriction,
   smoothing 10, --checkpoint, Re 1, 10, 100, 200, ..., 500, held to the
   JAX package's committed counts
   (results/logs/ldc3d_p2fb_nref2_re500_cpu.log) by phase 7's rule; peak
   device memory printed, one Newton linear step at Re=500 traced;
10. [P1+FB]^3 on a real mesh: the 3D backwards-facing step on
   tests/fixtures/bfs3d_coarse55.msh (76,132 dofs; an outflow, so no
   pressure null space), k=1, nref=1, SUPG weight 0.05, --restriction,
   Re 1, 10, 50, 100, held to results/logs/bfs3d_p1fb_coarse55_re500.log
   by the same rule;
11. the second paper's headline protocol (the reference's iters2dsv),
   through the driver as phase 7: ldc2d Scott-Vogelius k=2 ([P2]^2-DG1,
   exact grad-div), baseN=10, nref=2 (67,522 dofs), bary hierarchy,
   macrostar patches, Burman 5e-3, --restriction, --checkpoint, Re 1, 10,
   100, 200, ..., 1000, held to
   results/logs/sv_ldc2d_k2_nref2_re10000_cpu.log by phase 7's rule; the
   velocity of every Re must be pointwise divergence-free,
   ``divergence_norm`` < 1e-8; the launches as in phase 5 (KM applies
   the cell and facet terms merged); one Newton linear step at Re=1000
   traced;
12. Scott-Vogelius in 3D: ldc3d SV k=3, baseN=2, nref=1 (39,231 dofs),
   bary, macrostar (m = 1590), Burman 5e-3, smoothing 10, --restriction,
   Re 1, 10, 100, held to results/logs/sv_ldc3d_k3_nref1_re500.log
   (5/2, 5/2, 8/3) by the same rule; peak device memory printed;
13. the direct modes at the bench config, Re 1 -> 10 -> 100: ``lu``
   (the dense mixed Jacobian, 13.8 GB in f64, factored in place by
   cuSOLVER's LU, pressure pinned) must take the Newton counts 2, 2, 3 of
   results/logs/lu_anchor.log; ``allu`` (the dense velocity block, 8.9
   GB, under the Schur PC and FGMRES) must converge at each Re; its
   velocity within 1e-6 (max abs) of lu's and of phase 5's almg at every
   Re; the seconds of one assembly, factorisation and solve, and each
   mode's peak device memory printed;
14. the MMS convergence study through ``alfi_torch.examples.mms`` at the
   widths of its committed JAX logs: [P2]^2-P0 almg, baseN=8, nref 1 -> 3
   (2,690 / 10,498 / 41,474 dofs), the harness's 10 Re, with the
   convergence orders of results/logs/mms2d_pkp0_nref3.log within 1e-3
   and at every (nref, Re) the Krylov/Newton counts of the current JAX
   package (its CPU log under results/torch_h100/; the committed log's
   counts are an older JAX package's) by phase 7's rule, exact to Re 100;
   then Scott-Vogelius (bary, macrostar; 10,882 / 43,266 / 172,546 dofs)
   the same way against results/logs/mms2d_sv_nref3.log, with |div u_h| <
   1e-8 at every solve; K1, KM and KA must have launched;
15. the DFG cylinder (the configuration of
   results/logs/dfg_pkp0_nref1_re500.log: k=2, almg, [P2]^2-P0, uniform,
   SUPG, star, --restriction, nref=1, n=40, 56,736 dofs) through the
   driver as phase 7, Re 1, 10, 20, 50, 100, 200, with that log's counts
   at every Re;
16. multiplicative patch sweeps (one K1 table per colour, a KM residual
   update between colours): the bench config, Re 1 -> 10 -> 100, and the
   3D cavity baseN=2 nref=1, with the counts of the JAX package's CPU
   logs (results/torch_h100/iters_ldc2d_nref2_re100_multiplicative_jax_cpu.log
   and iters_ldc3d_p2fb_nref1_re100_multiplicative_jax_cpu.log); K1 and KM
   launches per Krylov iteration printed;
17. the grad-div study (``alfi_torch.examples.graddiv``, smoothing 3) at
   the Makefile's 2D comparisons, pkp0 baseN=8 nref=2 k=2 and SV (bary,
   macrostar) baseN=6 nref=2 k=2: patch and Jacobi, each with and without
   the Schoeberl transfer, and AMG, at the eight gamma of the harness,
   held to the JAX package's CPU logs
   (results/torch_h100/graddiv2d_{pkp0,sv}_jax_cpu.log): patch + transfer
   equal at every gamma, the other rows ">200" where the log says so and
   elsewhere within 10 % or 2 iterations; K1, KM, KA and KG launched;
   then pkp0's patch + transfer row with the smoother's patch factors
   stored in f32 (mg_smooth_dtype f32 under the Chebyshev driver: f32 LU
   factors through KL on f64 vectors), equal to the JAX package's CPU log
   of the same row (results/torch_h100/graddiv2d_pkp0_smooth32_jax_cpu.log)
   at every gamma, KL launched at every smoothed level;
18. the algebraic baselines: alamg (gamma 1e4), simple and lsc (gamma
   0) at the small config over Re 1, 10, 100 with the JAX package's
   Newton counts and Krylov within one per Newton step (alamg: 2 %), and at
   the bench config (simple Re 1 -> 10 -> 100; alamg and lsc, whose every
   linear solve there runs to maxit 500, Re 1 alone), each Re converged or
   not as the JAX package's CPU logs
   (results/torch_h100/iters_ldc2d_nref2_re100_*_jax_cpu.log) say, with
   their counts by the same rule, or, where every linear solve of the log
   stops at maxit (alamg 2,000/4 and lsc 1,500/3), exactly; the papers'
   contrast: alamg's Re 1 at
   least 3x phase 5's Krylov count, simple's Krylov per Newton at Re 100
   and lsc's at Re 1 above almg's at every Re; n1, kmax, the map's size
   and each mode's peak device memory;
19. the adjoint at the bench config: Re 1 -> 10 by lu, allu and almg,
   then ``solve_adjoint`` of the kinetic energy: |J^T lambda + dJ/dz|
   (BC rows out, mean-projected) < 1e-6 relative, allu's and almg's lambda
   within 1e-5 of lu's (pressure mean removed), almg in fewer than 100
   Krylov iterations; then one ``--nref-vis 1 --paraview`` solve through
   the driver, whose refined VTU file holds the refined mesh's vertices
   and finite values;

20. the precision modes (``alfi_torch/config.py``): (b) the bench config
   in f64 and in each mode (dc32, the defect-correction f32 smoother;
   store32, f32 storage; cycle32, the f32 cycle), warm, Re 1 -> 10 ->
   100, each held to its JAX CPU log
   (results/torch_h100/iters_ldc2d_nref2_re100_<mode>_jax_cpu.log) by
   phase 7's rule and to the JAX package's gates against the f64 control
   (dc32 and store32 c64 + 1, the f32 cycle 1.10 c64 + 1, per Re; only
   at the f32 cycle's Re 100, where the JAX package's own logs, f64 in
   iters_ldc2d_nref2_re100_jax_cpu.log, miss the gate, its mode's count
   is the bound, and a miss anywhere else fails), with seconds per Re and
   peak device memory beside f64; the f32 cycle with its Schoeberl state
   in f32 (LU factors through KL, the JAX package's default); (c) the 3D
   scale row in f64, dc32 and store32, Re 1 -> 10 -> 100, the f64 counts
   in each, with seconds, peak memory and the memory each built solver
   holds; K1 in f32, KL, KM in each mixed mode and with KB's dof stage as
   its epilogue, and KB must have launched; each of phase 3e's rows takes
   its table's launches here (phase 17's for the smoother's KL rows);

then print the kernel table as one JSON line (every K1 table of phases
3 to 3c in the variant its main path calls, and KM and KA of every level
table, with the launches of the phase that drives it: 7 for the 2D
tables, 6 for nref=3, 9 and 10 for the 3D ones, 11 and 12 for the
Scott-Vogelius ones, 16 for the colour tables, 18 for the Galerkin map)
and, last, the
result line ``{"ok": true, "device":
{...}}``.  Exits non-zero without a result when CUDA is unavailable or
the ``alfi_torch`` package is not beside this file.

``python3 chip_smoke.py --kernels-only`` stops after phase 3e (the kernel
rows and the K3 times) and prints no result line: for measurements of the
kernels alone.
"""

import json
import os
import subprocess
import sys
import time
import warnings

BENCH_RES = [1, 10, 100]
SMALL_COUNTS = [(8, 2), (7, 2), (15, 3)]  # JAX package, CPU f64
SMALL_SUPG_COUNTS = [(7, 2), (7, 2), (16, 3)]  # the same, SUPG, restriction
BENCH_COUNTS = (22, 7)  # JAX package's record at the bench config
#: the headline protocol at the bench config: Re -> (Krylov, Newton) of
#: the JAX package (CPU f64; the first 10 Re agree with
#: results/iters_ldc2d_nref2_re10000.log)
HEADLINE_ARGV = ["--discretisation", "pkp0", "--mh", "uniform", "--baseN",
                 "16", "--nref", "2", "--k", "2", "--gamma", "1e4",
                 "--stabilisation-type", "supg", "--restriction",
                 "--checkpoint"]
HEADLINE_JAX = {1: (6, 2), 10: (5, 2), 100: (10, 3), 200: (13, 3),
                300: (15, 3), 400: (14, 3), 500: (14, 3), 600: (15, 3),
                700: (15, 3), 800: (16, 3), 900: (15, 3), 1000: (15, 3)}
#: Re at which the counts must equal the JAX package's exactly
HEADLINE_EXACT = (1, 10, 100)
#: 3D parity at ldc3d baseN=2 nref=1 (JAX package, CPU f64), by k
CAVITY3D_COUNTS = {2: [(6, 2), (5, 2), (6, 3)], 1: [(9, 2), (6, 2), (9, 3)]}
#: the 3D scale row (scripts/queue.py stage f3) and the JAX package's
#: committed counts (results/logs/ldc3d_p2fb_nref2_re500_cpu.log)
SCALE_ARGV = ["--discretisation", "pkp0", "--mh", "uniform", "--k", "2",
              "--baseN", "4", "--nref", "2", "--stabilisation-type", "supg",
              "--restriction", "--smoothing", "10", "--checkpoint"]
SCALE_JAX = {1: (6, 2), 10: (3, 2), 100: (6, 3), 200: (7, 3), 300: (6, 3),
             400: (6, 3), 500: (6, 3)}
SCALE_EXACT = (1, 10, 100)
SCALE_DOFS = 284451
#: [P1+FB]^3 on the 3D step's gmsh mesh (scripts/queue.py stage f2) and
#: the counts of results/logs/bfs3d_p1fb_coarse55_re500.log
STEP_MESH = os.path.join("tests", "fixtures", "bfs3d_coarse55.msh")
STEP_ARGV = ["--discretisation", "pkp0", "--mh", "uniform", "--k", "1",
             "--baseN", "0", "--nref", "1", "--stabilisation-type", "supg",
             "--stabilisation-weight", "0.05", "--restriction",
             "--smoothing", "10", "--checkpoint"]
STEP_JAX = {1: (12, 2), 10: (10, 2), 50: (16, 3), 100: (18, 3)}
STEP_DOFS = 76132
#: the second paper's headline protocol (iters2dsv) at nref=2 and the
#: counts of results/logs/sv_ldc2d_k2_nref2_re10000_cpu.log; that log's
#: 67,522 dofs (and its nref=1 twin's 16,962) are baseN=10, not the
#: Makefile's 12 (97,154 dofs at nref=2)
SV2D_ARGV = ["--discretisation", "sv", "--mh", "bary", "--patch", "macro",
             "--baseN", "10", "--nref", "2", "--k", "2", "--gamma", "1e4",
             "--stabilisation-type", "burman", "--stabilisation-weight",
             "5e-3", "--restriction", "--checkpoint"]
SV2D_JAX = {1: (8, 2), 10: (8, 2), 100: (13, 3), 200: (14, 3), 300: (14, 3),
            400: (14, 3), 500: (14, 3), 600: (15, 3), 700: (15, 3),
            800: (15, 3), 900: (15, 3), 1000: (17, 3)}
SV2D_DOFS = 67522
#: SV k=3 in 3D and the counts of results/logs/sv_ldc3d_k3_nref1_re500.log
SV3D_ARGV = ["--discretisation", "sv", "--mh", "bary", "--patch", "macro",
             "--baseN", "2", "--nref", "1", "--k", "3", "--gamma", "1e4",
             "--stabilisation-type", "burman", "--stabilisation-weight",
             "5e-3", "--smoothing", "10", "--restriction", "--checkpoint"]
SV3D_JAX = {1: (5, 2), 10: (5, 2), 100: (8, 3)}
SV3D_DOFS = 39231
#: the pointwise divergence the SV velocity must stay under
SV_DIV_TOL = 1e-8
#: the direct solve's Newton counts at the bench config, Re 1, 10, 100
#: (results/logs/lu_anchor.log, a host direct solve)
LU_NEWTON = [2, 2, 3]
#: allu's velocity against lu's and almg's, max abs (the rule of
#: tests/test_almg.py::test_almg_matches_lu)
DIRECT_TOL = 1e-6
#: the MMS study (examples/Makefile mms2dpkp0, mms2dsv) at the width of
#: the committed logs results/logs/mms2d_{pkp0,sv}_nref3.log, whose first
#: level has 2,690 and 10,882 dofs: baseN=8, nref 1 -> 3.  The counts of
#: those logs are an older JAX package's; the current one takes other
#: counts on the same solves (its CPU logs under results/torch_h100/),
#: and the port is held to those, the orders to the committed logs'.
MMS_RUNS = [
    ("MMS [P2]^2-P0", ["--dim", "2", "--discretisation", "pkp0", "--mh",
                       "uniform", "--k", "2", "--baseN", "8", "--nref", "3",
                       "--solver-type", "almg"],
     os.path.join("results", "torch_h100", "mms2d_pkp0_nref3_jax_cpu.log"),
     os.path.join("results", "logs", "mms2d_pkp0_nref3.log"), None),
    ("MMS SV", ["--dim", "2", "--discretisation", "sv", "--mh", "bary",
                "--patch", "macro", "--k", "2", "--baseN", "8", "--nref",
                "3", "--solver-type", "almg"],
     os.path.join("results", "torch_h100", "mms2d_sv_nref3_jax_cpu.log"),
     os.path.join("results", "logs", "mms2d_sv_nref3.log"), SV_DIV_TOL)]
#: the Re at which the MMS counts must equal the JAX package's exactly;
#: elsewhere phase 7's rule
MMS_EXACT = (1, 9, 10, 50, 90, 100)
#: the convergence orders must match the logs' to this
MMS_ORDER_TOL = 1e-3
#: the DFG cylinder (scripts/queue.py:131-135) and the counts of
#: results/logs/dfg_pkp0_nref1_re500.log to Re 200
DFG_ARGV = ["--discretisation", "pkp0", "--mh", "uniform", "--k", "2",
            "--nref", "1", "--stabilisation-type", "supg", "--patch",
            "star", "--restriction", "--checkpoint"]
DFG_JAX = {1: (6, 2), 10: (14, 3), 20: (15, 3), 50: (19, 4), 100: (24, 4),
           200: (51, 6)}
DFG_N = 40
DFG_DOFS = 56736
#: multiplicative sweeps: the JAX package's CPU counts at the bench
#: config and at the 3D cavity baseN=2 nref=1 (results/torch_h100/)
MULT_JAX = [(6, 2), (5, 2), (8, 3)]
MULT3D_JAX = [(3, 2), (3, 2), (4, 3)]
#: the grad-div study (examples/Makefile pkp02dcomparison, sv2dcomparison)
#: at the reference's 2D widths, smoothing 3 (the harness's default), and
#: the JAX package's CPU logs of both targets (results/torch_h100/)
GRADDIV_RUNS = [
    ("pkp0", ["--dim", "2", "--discretisation", "pkp0", "--baseN", "8",
              "--nref", "2", "--k", "2"],
     os.path.join("results", "torch_h100", "graddiv2d_pkp0_jax_cpu.log")),
    ("sv", ["--dim", "2", "--discretisation", "sv", "--mh", "bary",
            "--patch", "macro", "--baseN", "6", "--nref", "2", "--k", "2"],
     os.path.join("results", "torch_h100", "graddiv2d_sv_jax_cpu.log"))]
#: smoother x transfer rows of each target, and the AMG row
GRADDIV_ROWS = [["--smoother", "patch", "--transfer"],
                ["--smoother", "patch"],
                ["--smoother", "jacobi", "--transfer"],
                ["--smoother", "jacobi"],
                ["--smoother", "amg"]]
#: the algebraic baselines at the small config (ldc2d baseN=4 nref=1),
#: Re 1, 10, 100: the JAX package's counts on the CPU
BASELINE_SMALL = {"alamg": [(330, 2), (358, 2), (781, 3)],
                  "simple": [(54, 3), (43, 2), (126, 3)],
                  "lsc": [(72, 3), (52, 2), (94, 3)]}
#: and at the bench config: the Re of each mode (simple the whole ladder;
#: alamg and lsc, whose every linear solve there runs to FGMRES's maxit
#: 500, Re 1, the rest of their ladders through the harness, logs under
#: results/torch_h100/) and the JAX package's CPU logs
BASELINE_BENCH_RES = {"alamg": [1], "simple": [1, 10, 100], "lsc": [1]}
#: FGMRES's maxit in every mode.  The JAX logs of alamg and lsc at the
#: bench config stop every linear solve there (2,000/4 and 1,500/3 at Re
#: 1); the card's deterministic scatter-adds (fem/scatter.py:ScatterAdd)
#: repeat those counts run after run, so they are held exactly, as every
#: other count is
BASELINE_MAXIT = 500
#: phase 20: the precision modes' gates against the port's f64 control,
#: Krylov <= scale * c64 + plus per Re (tests/test_mixed_cycle.py)
PRECISION_GATES = {"dc32": (1.0, 1), "store32": (1.0, 1),
                   "cycle32": (1.10, 1)}
#: the (mode, Re) where the JAX package's own CPU logs of the bench config
#: miss their gate, and only there is the port held to the JAX mode's
#: count instead: its f32 cycle at Re 100 (12 Krylov against its f64 run's
#: 9 > 1.10 * 9 + 1).  The gates come from the SUPG ladder at ldc2d
#: baseN=8 nref=1 (tests/test_mixed_cycle.py), where both packages meet them
PRECISION_JAX_MISSES = {("cycle32", 100)}
#: and the JAX package's CPU logs of the bench config in each mode and in
#: f64
PRECISION_LOGS = {
    mode: os.path.join("results", "torch_h100",
                       "iters_ldc2d_nref2_re100_%s_jax_cpu.log" % mode)
    for mode in PRECISION_GATES}
PRECISION_LOGS["f64"] = os.path.join("results", "torch_h100",
                                     "iters_ldc2d_nref2_re100_jax_cpu.log")
#: phase 17's grad-div row with the smoother's patch factors stored in f32
#: (mg_smooth_dtype f32 under the Chebyshev driver): pkp0 patch + transfer
#: at the Makefile's widths, and the JAX package's CPU log of it
GRADDIV_F32_KW = dict(dim=2, discretisation="pkp0", baseN=8, nref=2, k=2,
                      smoother="patch", transfer=True, smoothing=3)
GRADDIV_F32_LOG = os.path.join("results", "torch_h100",
                               "graddiv2d_pkp0_smooth32_jax_cpu.log")
BASELINE_BENCH_LOGS = {
    mode: os.path.join("results", "torch_h100",
                       "iters_ldc2d_nref2_re100_%s_jax_cpu.log" % mode)
    for mode in ("alamg", "simple", "lsc")}
#: the adjoint (tests/test_adjoint.py's rules): J^T lambda + dJ/dz
#: relative to dJ/dz, and the modes' lambda against lu's
ADJOINT_RESID_TOL, ADJOINT_TOL = 1e-6, 1e-5
#: almg's adjoint Krylov count of the JAX package on the CPU at ldc2d
#: baseN=4 nref=1 (tests/test_torch_adjoint.py holds the port to it there)
ADJOINT_ALMG_JAX_SMALL = 10
REL_TOL = 1e-13
#: published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
#: f64 FLOP/s outside the tensor cores, which the kernel uses
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12
#: f32 FLOP/s outside the tensor cores (the f32 kernels)
F32_FLOP_PER_S = 67e12
#: and in them (the same data sheet), for the K3 library call's bound
F64_TENSOR_FLOP_PER_S = 67e12
#: bytes written between launches to evict the 50 MB L2
FLUSH_BYTES = 128 << 20
#: both kernels of the source (pair and strided) carry this in their name
KERNEL_NAME = "gather_gemv_scatter"
KERNEL_OF_PATH = {1: "pair", 2: "strided"}
#: the merged level operator's apply (KM) and assembly (KA) kernels
KM_NAME, KA_NAME = "level_apply_kernel", "level_assemble_kernel"
PALLAS_GEMV = ("alfi_tpu/solvers/patch_pallas.py:46 _gemv_kernel "
               "(pallas_call at :81; deleted in aaee1ce)")
XLA_LEVEL_APPLY = ("alfi_tpu/mg/velocity.py:437 and :449 (plain-XLA "
                   "level_apply, cell and facet branches; no Pallas kernel)")
REPLACES = {"K1": PALLAS_GEMV, "KM": XLA_LEVEL_APPLY, "KA": XLA_LEVEL_APPLY,
            "KB": "alfi_tpu/mg/velocity.py:417-431 (gamma-split dict branch "
                  "of level_apply) and alfi_tpu/mg/schoeberl.py:128-140 "
                  "(_apply_gd), plain XLA; no Pallas kernel",
            "KG": "alfi_tpu/mg/amg.py:239-255 (VelocityAMG._galerkin1, a "
                  "plain-XLA scatter into the dense level-1 matrix; no "
                  "Pallas kernel)",
            "KL": "alfi_tpu/mg/schoeberl.py:144-146 (_patch_solve) and "
                  "alfi_tpu/mg/patches.py:728-730 (build_patch_solver's "
                  "apply): jax.scipy.linalg.lu_solve on f32 LU factors "
                  "(alfi_tpu/solvers/batched_lu.py:128-134), plain XLA; no "
                  "Pallas kernel"}


def _median_ms(fn, reps=15, inner=20):
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call (ms): what a call costs in the eager loop, host
    enqueue included."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def _device_kernels(prof):
    """(name, device us) of every kernel a torch.profiler run saw."""
    import torch

    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_ms(fn, reps=20, only=None, before=None):
    """Device time per call (ms) from a torch.profiler trace: summed over
    every kernel ``fn`` runs, or over the kernels whose name holds
    ``only``; ``before()`` runs ahead of each call (untimed when ``only``
    leaves it out).  With ``only`` (one such kernel per call) it is
    the median of the launches the trace kept: one launch in twenty that
    is held up now and then must not move the number.  None when the
    trace shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # a trace now and then comes back without its device events: trace
    # again, at most three times
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        times = [us for name, us in _device_kernels(prof)
                 if only is None or only in name]
        if times:
            break
    if not times:
        return None
    # one named kernel per call: the median launch of those the trace
    # kept (it may drop some); else everything per call
    if only:
        return sorted(times)[len(times) // 2] / 1e3
    return sum(times) / reps / 1e3


def _fmt(ms):
    return "not measured" if ms is None else "%.4f" % ms


def _library_operator(op, A):
    """The operator sum_b S_b^T A_b S_b of ``op``'s table as one CSR
    matrix (pads dropped, no masks), assembled once for cuSPARSE."""
    import torch

    nb, m, _ = op.ashape
    rows = op.pidx[:, :, None].expand(nb, m, m).reshape(-1)
    cols = op.pidx[:, None, :].expand(nb, m, m).reshape(-1)
    keep = (rows < op.n) & (cols < op.n)
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]), A.reshape(-1)[keep],
        (op.n, op.n)).coalesce()
    crow = torch._convert_indices_from_coo_to_csr(coo.indices()[0], op.n)
    return torch.sparse_csr_tensor(crow, coo.indices()[1], coo.values(),
                                   (op.n, op.n))


def _bound_bytes(op, itemsize=8):
    """What one call on this table's data must move, each byte once, by
    part: the A entries whose row feeds a live output dof and whose
    column gathers a live dof (one multiply-add each), the index table, x
    at the dofs gathered, out, the in-mask only where it zeroes a
    gathered entry, the out-mask, and the passthrough where the out-mask
    is 0; ``itemsize`` bytes a value (8: f64, 4: f32)."""
    import torch

    nb, m, _ = op.ashape
    live = op.gidx >= 0  # gathered entries: not a pad, in-mask 1
    parts = {"A": op.a_bytes(itemsize=itemsize)[1], "index": 4 * nb * m,
             "out": itemsize * op.n,
             "x": itemsize * int(torch.unique(op.gidx[live]).numel())}
    if op.in_keep is not None and bool(((op.pidx < op.n) & ~live).any()):
        parts["in_mask"] = op.n
    if op.out_keep is not None:
        parts["out_mask"] = op.n
        parts["passthrough"] = itemsize * int((~op.out_keep).sum())
    return parts


def _bound_of(parts, ops, flops=F64_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes ``parts``
    over the memory rate and ``ops`` operations over the rate ``flops``
    (the f64 rate unless given)."""
    t_bytes = sum(parts.values()) / HBM_BYTES_PER_S
    t_ops = ops / flops
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _bound(op):
    """The least time of one call: ``_bound_bytes`` against one f64
    multiply-add per needed A entry."""
    parts = _bound_bytes(op)
    return _bound_of(parts, 2.0 * (parts["A"] // 8))


def _merged_bound_bytes(op, vbytes=8, xbytes=8):
    """What one KM call on a merged level operator must move, each byte
    once: the merged values (``vbytes`` each) and their block columns,
    the row pointers, x at the dofs gathered or passed through, the mask,
    out (``xbytes`` a vector value)."""
    import numpy as np

    p, d = op.pattern, op.d
    cols = np.unique(p.bcol).astype(np.int64)
    xdofs = np.union1d((cols[:, None] * d + np.arange(d)).reshape(-1),
                       np.flatnonzero(~p.keep))
    return {"values": vbytes * d * d * p.nnzb, "index": 4 * p.nnzb,
            "rowptr": 4 * (p.nodes + 1), "x": xbytes * len(xdofs),
            "mask": p.n, "out": xbytes * p.n}


def _merged_bound(op):
    """KM's least time: ``_merged_bound_bytes`` against one f64
    multiply-add per merged value."""
    return _bound_of(_merged_bound_bytes(op),
                     2.0 * op.d * op.d * op.pattern.nnzb)


def _assembly_bound_bytes(op):
    """What one KA call must move, each byte once: every live block entry
    (the sources), its map entry and the map's pointers, and the merged
    values written."""
    p = op.pattern
    nvals = p.nnzb * op.d * op.d
    return {"sources": 8 * p.nlive, "map": 4 * p.nlive + 4 * (nvals + 1),
            "values": 8 * nvals}


def _assembly_bound(op):
    """KA's least time: ``_assembly_bound_bytes`` against one f64 add per
    live source."""
    return _bound_of(_assembly_bound_bytes(op), float(op.pattern.nlive))


def _check_kernel(name, op, rng, flush, mask=None, bare_only=False):
    """The fused kernel against its plain version on ``op``'s table, bare
    and masked (with ``op``'s masks, or ``mask`` in and out where the main
    path calls ``op`` bare; only bare with ``bare_only``); returns one
    result dict per variant."""
    import torch

    from alfi_torch.kernels import PAIR_MAX_M, GatherGemvScatter

    dev = op.device
    main_op = op
    nb, m, _ = op.ashape
    A = torch.as_tensor(rng.standard_normal((nb, m, m)), device=dev)
    x = torch.as_tensor(rng.standard_normal(op.n), device=dev)
    p = torch.as_tensor(rng.standard_normal(op.n), device=dev)
    idx = op.pidx.cpu().numpy()
    bare = GatherGemvScatter(idx, op.n, op.use, device=dev)
    main_masked = op.out_keep is not None
    if op.in_keep is None and op.out_keep is None:
        op = GatherGemvScatter(idx, op.n, op.use, in_mask=mask,
                               out_mask=mask, device=dev)
    lib = _library_operator(bare, A)
    print("%-22s library CSR: %d nonzeros for %d block entries"
          % (name, lib.values().numel(), nb * m * m), flush=True)

    def library():
        return lib @ x

    y_lib = library()
    y_bare = bare(A, x)
    torch.cuda.synchronize()
    lib_err = float((y_lib - y_bare).abs().max() / y_bare.abs().max())
    if not lib_err <= 1e-12:
        raise AssertionError("%s: library operator disagrees (%.3e)"
                             % (name, lib_err))
    lib_ms = _median_ms(library)
    lib_dev = _device_ms(library)
    out = []
    variants = ((False, bare),) if bare_only else ((False, bare), (True, op))
    for masked, o in variants:
        args = (p,) if o.out_keep is not None else ()

        def kernel():
            return o(A, x, *args)

        def plain():
            return o.plain(A, x, *args)

        yk, yk2, yp = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(yk, yk2):
            raise AssertionError("%s: two launches differ" % name)
        abs_err = float((yk - yp).abs().max())
        rel_err = abs_err / max(float(yp.abs().max()), 1e-300)
        if not rel_err <= REL_TOL:
            raise AssertionError("%s: kernel vs plain max rel err %.3e > "
                                 "%.0e" % (name, rel_err, REL_TOL))
        ms_p1, ms_k1 = _median_ms(plain), _median_ms(kernel)
        ms_k2, ms_p2 = _median_ms(kernel), _median_ms(plain)
        bound_ms, bound_by = _bound(o)
        dev_ms = _device_ms(kernel, only=KERNEL_NAME)
        cold_ms = _device_ms(kernel, only=KERNEL_NAME, before=flush)
        # the source's other kernel, where the table allows both (the
        # pair kernel takes an even m up to PAIR_MAX_M, the strided kernel
        # every m)
        other_ms = None
        chosen = o.kernel_path()
        if m % 2 == 0 and m <= PAIR_MAX_M:
            o.path = 3 - chosen
            y_other, y_other2 = kernel(), kernel()
            torch.cuda.synchronize()
            other_err = float((y_other - yp).abs().max()) / max(
                float(yp.abs().max()), 1e-300)
            if not (other_err <= REL_TOL and torch.equal(y_other, y_other2)):
                raise AssertionError("%s: %s kernel vs plain max rel err "
                                     "%.3e" % (name, KERNEL_OF_PATH[o.path],
                                               other_err))
            other_ms = _device_ms(kernel, only=KERNEL_NAME)
            o.path = 0
        loaded, live = o.a_bytes()
        r = {"name": name, "shape": (nb, m), "masked": masked,
             "op": main_op if masked == main_masked else None,
             "kernel": KERNEL_OF_PATH[chosen],
             "abs_err": abs_err, "rel_err": rel_err,
             "ms": min(ms_k1, ms_k2), "dev_ms": dev_ms, "cold_ms": cold_ms,
             "other_dev_ms": other_ms,
             "plain_ms": min(ms_p1, ms_p2), "plain_dev_ms": _device_ms(plain),
             "library_ms": lib_ms, "library_dev_ms": lib_dev,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "share": (bound_ms / dev_ms) if dev_ms else None}
        print("%-22s %6d x %-3d %-6s %8.2e  %s %s (%s, cold %s, other %s) | "
              "%7.2f us %-5s %5s | A %.4f GB loaded, %.4f in the bound, "
              "%s TB/s | %s (%s) | %s (%s)" % (
                  name, nb, m, "masked" if masked else "bare", rel_err,
                  r["kernel"] + ("" if chosen == 1 else "/%d lanes"
                                 % (1 << o.lanes_log2)),
                  _fmt(r["ms"]), _fmt(dev_ms), _fmt(cold_ms),
                  "-" if other_ms is None else _fmt(other_ms),
                  1e3 * bound_ms, bound_by,
                  "-" if r["share"] is None else "%.0f%%" % (100 * r["share"]),
                  loaded / 1e9, live / 1e9,
                  "-" if not dev_ms else "%.2f" % (loaded / dev_ms / 1e9),
                  _fmt(r["plain_ms"]), _fmt(r["plain_dev_ms"]),
                  _fmt(lib_ms), _fmt(lib_dev)), flush=True)
        out.append(r)
    return out


def _merged_library_operator(op, vals):
    """The merged operator with its passthrough, keep * A + diag(1 -
    keep), as one CSR matrix for cuSPARSE."""
    import torch

    d = op.d
    e = torch.arange(vals.numel(), device=op.device)
    blk = e // (d * d)
    rows = op.brow[blk] * d + (e // d) % d
    cols = op.bcol.long()[blk] * d + e % d
    pas = torch.nonzero(~op.keep).reshape(-1)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat([rows, pas]), torch.cat([cols, pas])]),
        torch.cat([vals.reshape(-1), torch.ones(pas.numel(),
                                               dtype=vals.dtype,
                                               device=op.device)]),
        (op.n, op.n)).coalesce()
    crow = torch._convert_indices_from_coo_to_csr(coo.indices()[0], op.n)
    return torch.sparse_csr_tensor(crow, coo.indices()[1], coo.values(),
                                   (op.n, op.n))


def _check_merged(name, vmg, l, rng, flush):
    """KA and KM of level l's merged operator against their plain
    versions on random cell (and facet) tensors and a random x: max
    relative error <= REL_TOL, two launches bitwise equal; device times
    (warm and with L2 cold), the bounds, the plain versions' and the
    library calls' times (index_add_ on the same map; cuSPARSE on the same
    merged operator), KM at half and twice its lanes, and the blocked
    route beside it: the fused kernel over the cell blocks (K2) plus, with
    facets, over the facet blocks.  Returns the (KM, KA) result dicts."""
    import torch

    from alfi_torch.kernels import GatherGemvScatter

    op = vmg.level_ops[l]
    dev = op.device
    T = torch.as_tensor(rng.standard_normal(op.cell_shape), device=dev)
    F = (None if op.facet_shape is None else
         torch.as_tensor(rng.standard_normal(op.facet_shape), device=dev))
    x = torch.as_tensor(rng.standard_normal(op.n), device=dev)

    def ka():
        return op.assemble(T, F)

    def ka_plain():
        return op.plain_assemble(T, F)

    # the library call: one index_add_ of every block entry into its merged
    # entry (a masked one into a dump slot), the sources concatenated ahead
    src = T.reshape(-1) if F is None else torch.cat([T.reshape(-1),
                                                     F.reshape(-1)])
    p = op.pattern
    nvals = p.nnzb * op.d * op.d
    dest = torch.full((p.nsource,), nvals, dtype=torch.int64, device=dev)
    amap = op.assembly
    dest[amap.amap_src.long()] = torch.repeat_interleave(
        torch.arange(nvals, device=dev), torch.diff(amap.amap_ptr.long()))

    def ka_library():
        return src.new_zeros(nvals + 1).index_add_(0, dest, src)

    va, va2, vp = ka(), ka(), ka_plain()
    torch.cuda.synchronize()
    if not torch.equal(va, va2):
        raise AssertionError("%s: two KA launches differ" % name)
    ka_abs = float((va - vp).abs().max())
    ka_rel = ka_abs / max(float(vp.abs().max()), 1e-300)
    lib_err = float((ka_library()[:nvals] - vp.reshape(-1)).abs().max())
    if not (ka_rel <= REL_TOL and lib_err <= 1e-12 * float(vp.abs().max())):
        raise AssertionError("%s: KA vs plain max rel err %.3e (library "
                             "%.3e)" % (name, ka_rel, lib_err))
    ka_r = {"name": name + " KA", "kernel": "KA", "op": op,
            "abs_err": ka_abs, "rel_err": ka_rel,
            "dev_ms": _device_ms(ka, only=KA_NAME),
            "cold_ms": _device_ms(ka, only=KA_NAME, before=flush),
            "plain_dev_ms": _device_ms(ka_plain),
            "library_dev_ms": _device_ms(ka_library)}
    ka_r["bound_ms"], ka_r["bound_by"] = _assembly_bound(op)
    print("%-24s KA %d sources -> %d merged entries (%.2f per entry; %d "
          "block entries) %8.2e | %s (cold %s) ms | bound %.2f us %s, %s | "
          "plain %s | index_add_ %s" % (
              name, p.nlive, nvals, p.nlive / max(nvals, 1), p.nsource,
              ka_rel, _fmt(ka_r["dev_ms"]), _fmt(ka_r["cold_ms"]),
              1e3 * ka_r["bound_ms"], ka_r["bound_by"],
              _share(ka_r["bound_ms"], ka_r["dev_ms"]),
              _fmt(ka_r["plain_dev_ms"]), _fmt(ka_r["library_dev_ms"])),
          flush=True)

    vals = va
    lib = _merged_library_operator(op, vals)

    def km():
        return op(vals, x)

    def km_plain():
        return op.plain(vals, x)

    def library():
        return lib @ x

    yk, yk2, yp = km(), km(), km_plain()
    torch.cuda.synchronize()
    if not torch.equal(yk, yk2):
        raise AssertionError("%s: two KM launches differ" % name)
    km_abs = float((yk - yp).abs().max())
    km_rel = km_abs / max(float(yp.abs().max()), 1e-300)
    lib_err = float((library() - yp).abs().max() / yp.abs().max())
    if not (km_rel <= REL_TOL and lib_err <= 1e-12):
        raise AssertionError("%s: KM vs plain max rel err %.3e (library "
                             "%.3e)" % (name, km_rel, lib_err))
    # KM at half and twice its lanes, held to the plain version too
    own = op.lanes_log2
    other = {}
    for lanes in (own - 1, own + 1):
        if 0 <= lanes <= 5:
            op.lanes_log2 = lanes
            y = km()
            torch.cuda.synchronize()
            if not float((y - yp).abs().max()) <= REL_TOL * float(
                    yp.abs().max()):
                raise AssertionError("%s: KM at %d lanes disagrees"
                                     % (name, 1 << lanes))
            other[1 << lanes] = _device_ms(km, only=KM_NAME)
    op.lanes_log2 = own
    # the blocked route on the same blocks: K2 over the cells, then the
    # facet blocks through the same kernel (as a second masked launch)
    keep = op.keep
    blocked = [(GatherGemvScatter(vmg.levels[l].rows.cpu().numpy(), op.n,
                                  "K2", in_mask=keep, out_mask=keep,
                                  device=dev), T)]
    if F is not None:
        blocked.append((GatherGemvScatter(vmg.facet_rows[l], op.n, "K2",
                                          in_mask=keep, out_mask=keep,
                                          device=dev), F))
    blocked_ms = []
    for table, A in blocked:
        blocked_ms.append(_device_ms(lambda: table(A, x, x),
                                     only=KERNEL_NAME))
    del blocked
    loaded = op.value_bytes()
    km_r = {"name": name + " KM", "kernel": "KM", "op": op,
            "abs_err": km_abs, "rel_err": km_rel,
            "ms": min(_median_ms(km), _median_ms(km)),
            "dev_ms": _device_ms(km, only=KM_NAME),
            "cold_ms": _device_ms(km, only=KM_NAME, before=flush),
            "plain_dev_ms": _device_ms(km_plain),
            "library_ms": _median_ms(library),
            "library_dev_ms": _device_ms(library),
            "blocked_dev_ms": (None if None in blocked_ms
                               else sum(blocked_ms))}
    km_r["bound_ms"], km_r["bound_by"] = _merged_bound(op)
    print("%-24s KM %d nodes, %d blocks of %dx%d (merge %.2fx), %d lanes "
          "%8.2e | %s ms eager, device %s (cold %s; lanes %s) | bound %.2f "
          "us %s, %s | values+index %.4f GB, %s TB/s | plain %s | cuSPARSE "
          "%s (%s) | blocked route %s (%s)" % (
              name, p.nodes, p.nnzb, op.d, op.d, p.merge_factor,
              1 << own, km_rel, _fmt(km_r["ms"]), _fmt(km_r["dev_ms"]),
              _fmt(km_r["cold_ms"]),
              ", ".join("%d: %s" % (g, _fmt(t)) for g, t in other.items()),
              1e3 * km_r["bound_ms"], km_r["bound_by"],
              _share(km_r["bound_ms"], km_r["dev_ms"]), loaded / 1e9,
              "-" if not km_r["dev_ms"] else "%.2f" % (
                  loaded / km_r["dev_ms"] / 1e9),
              _fmt(km_r["plain_dev_ms"]), _fmt(km_r["library_ms"]),
              _fmt(km_r["library_dev_ms"]), _fmt(km_r["blocked_dev_ms"]),
              " + ".join(_fmt(t) for t in blocked_ms)), flush=True)
    return km_r, ka_r


def _share(bound_ms, ms):
    return "-" if not ms else "%.0f%%" % (100.0 * bound_ms / ms)


def _time_patch_inverses(dev, batches):
    """torch.linalg.inv (the patch factorisation; a library call, as in
    the JAX package) at the (blocks, m) of ``batches``, f64: median of 3
    CUDA-event times after one warm-up, the inverse's residual, the bytes
    of the inverse table and the call's peak device memory."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    for nb, m in batches:
        A = torch.randn((nb, m, m), dtype=torch.float64, device=dev,
                        generator=gen)
        A += float(m) * torch.eye(m, dtype=torch.float64, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        inv = torch.linalg.inv(A)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        resid = float((torch.bmm(A[:8], inv[:8])
                       - torch.eye(m, dtype=torch.float64,
                                   device=dev)).abs().max())
        if not resid <= 1e-10:
            raise AssertionError("patch inverses: residual %.3e" % resid)
        ms = _median_ms(lambda: torch.linalg.inv(A), reps=3, inner=1)
        # its bound: A read and the inverse written once, against about
        # 2 m^3 operations per block (LU, then the inverse from it) at
        # the f64 tensor-core rate, which the call's GEMMs use
        t_bytes = 2.0 * nb * m * m * 8 / HBM_BYTES_PER_S
        ops = 2.0 * m ** 3 * nb
        print("K3 torch.linalg.inv (%d, %d, %d) f64: %.3f ms (library "
              "call; residual %.2e); bound %.3f ms by operations at %.0f "
              "TFLOP/s (%.3f ms outside the tensor cores; bytes %.3f ms); "
              "inverse table %.4f GB, peak device memory of the call "
              "%.3f GB"
              % (nb, m, m, ms, resid, 1e3 * ops / F64_TENSOR_FLOP_PER_S,
                 F64_TENSOR_FLOP_PER_S / 1e12, 1e3 * ops / F64_FLOP_PER_S,
                 1e3 * t_bytes, 8.0 * nb * m * m / 1e9, peak / 1e9),
              flush=True)
        del A, inv


def _profile_linear_step(solver):
    """Trace the first Newton linear step of the solver's last solve
    (from the state before it) under torch.profiler; print its kernel
    count, device busy share and kernel time by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alfi_torch import kernels

    params = solver.params()
    z = solver.z_last
    F = solver.residual_masked(z, params)
    tstate = solver._transfer_setup(params)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, its = solver._linear_step(z, F, params, tstate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = _device_kernels(prof)
    busy = sum(us for _, us in kern) / 1e6
    print("profiled linear step: %d Krylov its, %.3f s wall (profiler on), "
          "%d kernels (%.0f per Krylov it), device busy %.3f s = %.1f%% of "
          "wall; kernel launches %s"
          % (its, wall, len(kern), len(kern) / max(its, 1), busy,
             100.0 * busy / wall, _launches()), flush=True)
    by_name = {}
    for kname, us in kern:
        n_us = by_name.setdefault(kname[:70], [0, 0.0])
        n_us[0] += 1
        n_us[1] += us
    for kname, (cnt, us) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:10]:
        print("  %8.2f ms %6d x  %s" % (us / 1e3, cnt, kname))
    for label, key in (("the fused kernel (K1)", KERNEL_NAME),
                       ("KM", KM_NAME), ("KA", KA_NAME)):
        t = sum(us for kname, us in kern if key in kname) / 1e6
        print("  %s: %.4f s = %.1f%% of device busy time"
              % (label, t, 100.0 * t / max(busy, 1e-300)), flush=True)


def _launches():
    """Kernel launches per use (K1, K2) and kernel (KM, KA; KG, KA over
    the AMG Galerkin maps) since the last reset_launch_counts()."""
    from alfi_torch import kernels

    return {**kernels.GatherGemvScatter.launches,
            **kernels.MergedLevelOperator.launches,
            **kernels.MapAssembly.launches}


def _table_launches():
    """(id of a table, use or kernel) -> its launches since the last
    reset_launch_counts()."""
    from alfi_torch import kernels

    out = {(id(t), t.use): t.launched
           for t in kernels.GatherGemvScatter._tables_alive}
    for op in kernels.MergedLevelOperator._tables_alive:
        out.update(((id(op), k), v) for k, v in op.launched.items())
    for op in kernels.MapAssembly._tables_alive:
        if op.key == "KG":
            out[(id(op), "KG")] = op.launched
    return out


def _check_levels(label, solver, launches):
    """Every applied level (1 and up) of the solver must have launched
    KM and KA, and the blocked level matvec (K2) never."""
    if launches["K2"]:
        raise AssertionError("%s: the blocked level matvec ran" % label)
    for l, op in enumerate(solver.vmg.level_ops[1:], 1):
        if not (op.launched["KM"] > 0 and op.launched["KA"] > 0):
            raise AssertionError("%s: level %d launched KM %d, KA %d times"
                                 % (label, l, op.launched["KM"],
                                    op.launched["KA"]))


def _driver_sweep(label, solver, args, expected, exact, ndofs,
                  state_check=None):
    """One continuation through the port's driver (run_solver with
    --checkpoint) in a temporary working directory, as phases 7, 9 and 10
    run it.  ``expected``: Re -> the JAX package's (Krylov, Newton); every
    Re must converge to a finite state, take those counts exactly at the
    Re in ``exact`` and elsewhere the same Newton count and at most one
    more Krylov iteration per Newton step.  The launch counts are zeroed
    just before the sweep and read just after (returned per table, by
    ``id`` and use); K1 must have launched, and KM and KA at every
    applied level (``_check_levels``).
    ``state_check(re, u)``, when given, runs on each Re's checkpointed
    velocity (a numpy array) and raises if it fails.  Then one Newton
    linear step of the last Re is traced, and a second run over the
    checkpoints must load them all, solve nothing and reproduce the
    counts."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from alfi_torch import kernels, run_solver

    res = list(expected)
    if solver.Z.dim != ndofs:
        raise AssertionError("%s: %d dofs, expected %d"
                             % (label, solver.Z.dim, ndofs))
    solver.verbose = False
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # a solver deleted by an earlier phase sits in reference
            # cycles (its multigrid and transfers point at each other)
            # until the cyclic collector runs: collect it, so that the peak
            # is this sweep's and not the collector's timing
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results = run_solver(solver, res, args)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            launches = _launches()
            per_table = _table_launches()
            peak = torch.cuda.max_memory_allocated()
            chkdir = os.path.join("checkpoint", str(solver.Z.dim))
            for re in res:
                with np.load(os.path.join(
                        chkdir, "nssolution-Re-%s.npz" % re)) as chk:
                    finite = bool(np.isfinite(chk["u"]).all()
                                  and np.isfinite(chk["p"]).all())
                    if state_check is not None:
                        state_check(re, chk["u"])
                if not (results[re]["converged"] and finite):
                    raise AssertionError("%s Re=%s did not converge "
                                         "(finite=%s)" % (label, re, finite))
            counts = {re: (results[re]["linear_iter"],
                           results[re]["nonlinear_iter"]) for re in res}
            print("%s: %d dofs, Re %s -> %s (%d steps) in %.3f s; peak "
                  "device memory %.3f GB (%d bytes; %.3f GB allocated at "
                  "its start)"
                  % (label, solver.Z.dim, res[0], res[-1], len(res), total,
                     peak / 1e9, peak, resident / 1e9), flush=True)
            print("%s seconds per Re: %s" % (label, ", ".join(
                "%s: %.3f" % (re, 60.0 * results[re]["time"]) for re in res)))
            print("%s Krylov/Newton per Re (JAX package): %s"
                  % (label, ", ".join("%s: %d/%d (%d/%d)"
                                      % ((re,) + counts[re] + expected[re])
                                      for re in res)))
            print("%s kpn per Re: %s" % (label, ", ".join(
                "%s: %.2f" % (re, counts[re][0] / counts[re][1])
                for re in res)))
            print("%s kernel launches: %s (K1 %.1f and KM %.1f per Krylov "
                  "iteration)"
                  % (label, launches,
                     launches["K1"] / sum(k for k, _ in counts.values()),
                     launches["KM"] / sum(k for k, _ in counts.values())),
                  flush=True)
            for re in res:
                (k, n), (kj, nj) = counts[re], expected[re]
                ok = ((k, n) == (kj, nj) if re in exact
                      else n == nj and k <= kj + nj)
                if not ok:
                    raise AssertionError(
                        "%s Re=%s: Krylov/Newton %d/%d against the "
                        "JAX package's %d/%d" % (label, re, k, n, kj, nj))
            if launches["K1"] <= 0:
                raise AssertionError("the fused kernel was not launched "
                                     "for K1 on the %s path" % label)
            _check_levels(label, solver, launches)
            _profile_linear_step(solver)

            # resume: the checkpoints are loaded, nothing is solved
            solve = solver.solve

            def no_solve(re):
                raise AssertionError("resumed sweep solved Re=%s" % re)

            solver.solve = no_solve
            resumed = run_solver(solver, res, args)
            solver.solve = solve
            if not all(resumed[re].get("checkpointed") for re in res):
                raise AssertionError("resumed sweep did not load every "
                                     "checkpoint")
            rcounts = {re: (resumed[re]["linear_iter"],
                            resumed[re]["nonlinear_iter"]) for re in res}
            if rcounts != counts:
                raise AssertionError("resumed counts %s != %s"
                                     % (rcounts, counts))
            print("%s resume: %d checkpoints loaded, nothing solved, "
                  "counts reproduced" % (label, len(res)), flush=True)
        finally:
            os.chdir(cwd)
    return per_table


def _solve_sweep(solver, res, keep=None):
    """Solve each Re of ``res`` in turn; every Re must converge to a
    finite state.  Returns (rows, seconds); the velocity of each Re is
    appended to ``keep`` (on the host) when given."""
    import torch

    rows, t_all = [], 0.0
    for re in res:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, info = solver.solve(re)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t_all += dt
        if keep is not None:
            keep.append(z[0].cpu())
        finite = all(bool(torch.isfinite(x).all()) for x in z)
        rows.append((re, info["linear_iter"], info["nonlinear_iter"], dt,
                     solver.residual_no_graddiv))
        print("  Re=%-4s krylov=%-3d newton=%d  %.3f s  gamma-free "
              "residual %.3e" % rows[-1], flush=True)
        if not (info["converged"] and finite):
            raise AssertionError("Re=%s did not converge (finite=%s)"
                                 % (re, finite))
    return rows, t_all


def _log_solves(path, converged=False):
    """(Krylov, Newton) of every solve a solver log records, in order;
    with ``converged``, (Krylov, Newton, converged)."""
    import re as _re

    out, newton, conv = [], None, None
    with open(path) as f:
        for line in f:
            m = _re.search(r"Nonlinear solve (\S+) in (\d+) iterations", line)
            if m:
                conv, newton = m.group(1) == "converged", int(m.group(2))
            m = _re.search(r"Time taken: .* in (\d+) iterations", line)
            if m:
                out.append((int(m.group(1)), newton) + ((conv,) if converged
                                                       else ()))
    return out


def _log_orders(path):
    """The convergence orders an MMS log prints, in order (per Re: the
    velocity's, then the pressure's)."""
    import numpy as np

    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("convergence orders:"):
                out.append(np.array(line.split("[", 1)[1].split("]")[0]
                                    .split(), dtype=float))
    return out


def _mms_phase(label, argv, counts_log, orders_log, div_tol):
    """Phase 14: one MMS study through alfi_torch.examples.mms, its
    solver output kept off the console.  The counts of every (nref, Re)
    are held to ``counts_log`` (exact at MMS_EXACT, else phase 7's rule),
    the convergence orders to ``orders_log``'s within MMS_ORDER_TOL, and
    with ``div_tol`` every |div u_h| stays under it.  K1, KM and KA must
    have launched."""
    import contextlib
    import io

    import numpy as np

    from alfi_torch import kernels
    from alfi_torch.examples import mms

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mms.main(argv)
    total = time.perf_counter() - t0
    launches = _launches()
    dofs = [int(line.split(":")[1]) for line in buf.getvalue().splitlines()
            if line.startswith("Number of degrees of freedom")]
    # the solves in the logs' order: per nref, the Re in mms.RES order
    nrefs = sorted({nref for nref, _ in out["counts"]})
    keys = [(nref, re) for nref in nrefs for re in mms.RES]
    mine = [out["counts"][k] for k in keys]
    want = _log_solves(counts_log)
    print("%s: %s dofs, %d solves in %.3f s; Krylov per solve %s (JAX %s); "
          "kernel launches %s" % (label, dofs, len(mine), total,
                                  [k for k, _ in mine], [k for k, _ in want],
                                  launches), flush=True)
    if len(want) != len(mine):
        raise AssertionError("%s: %d solves, the log %d"
                             % (label, len(mine), len(want)))
    for (nref, re), (k, n), (kj, nj) in zip(keys, mine, want):
        ok = ((k, n) == (kj, nj) if re in MMS_EXACT
              else n == nj and k <= kj + nj)
        if not ok:
            raise AssertionError("%s nref=%d Re=%s: Krylov/Newton %d/%d "
                                 "against the JAX package's %d/%d"
                                 % (label, nref, re, k, n, kj, nj))
    orders = []
    for re in mms.RES:
        r = out["results"][re]
        orders += [mms.convergence_orders(r["velocity"]),
                   mms.convergence_orders(r["pressure"])]
    logged = _log_orders(orders_log)
    worst = max(float(np.abs(a - b).max()) for a, b in zip(orders, logged))
    print("%s convergence orders (u, p) per Re: %s; max difference from the "
          "log's %.2e" % (label, "; ".join(
              "%s: %s, %s" % (re, np.round(orders[2 * i], 4),
                              np.round(orders[2 * i + 1], 4))
              for i, re in enumerate(mms.RES)), worst), flush=True)
    if not (len(orders) == len(logged) and worst <= MMS_ORDER_TOL):
        raise AssertionError("%s: convergence orders differ from the log's "
                             "by %.3e" % (label, worst))
    if div_tol is not None:
        divs = [d for re in mms.RES for d in out["results"][re]["divergence"]]
        print("%s max |div u_h| %.3e" % (label, max(divs)), flush=True)
        if not max(divs) < div_tol:
            raise AssertionError("%s: |div u_h| %.3e >= %.0e"
                                 % (label, max(divs), div_tol))
    if min(launches["K1"], launches["KM"], launches["KA"]) <= 0:
        raise AssertionError("%s: a kernel of the path was not launched: %s"
                             % (label, launches))


def _direct_phase(make, almg_u):
    """Phase 13: lu and allu at the bench config over BENCH_RES; lu takes
    LU_NEWTON, allu converges, allu's velocity is within DIRECT_TOL of
    lu's and of almg's (``almg_u``, phase 5's per Re); one assembly,
    factorisation and solve of each timed apart; peak memory per mode."""
    import gc

    import torch

    from alfi_torch.solvers import linear
    from alfi_torch.solvers.batched_lu import coarse_factor, coarse_solve

    states = {}
    for mode in ("lu", "allu"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        solver = make(16, 2, solver_type=mode)
        keep = []
        rows, total = _solve_sweep(solver, BENCH_RES, keep=keep)
        peak = torch.cuda.max_memory_allocated()
        states[mode] = keep
        print("%s at the bench config: %d dofs, Re 1->10->100 in %.3f s, "
              "Krylov/Newton %s; peak device memory %.3f GB (%.3f GB "
              "allocated at its start)"
              % (mode, solver.Z.dim, total, [(r[1], r[2]) for r in rows],
                 peak / 1e9, resident / 1e9), flush=True)
        if mode == "lu" and [r[2] for r in rows] != LU_NEWTON:
            raise AssertionError("lu Newton counts %s != %s"
                                 % ([r[2] for r in rows], LU_NEWTON))
        # one assembly, factorisation and solve at the last state, apart
        z, params = solver.z, solver.params()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "lu":
            A = linear.assemble_dense_mixed(solver.form, z, params,
                                            solver.bcset)
        else:
            A = linear.assemble_dense_velocity(solver.form, z[0], params,
                                               solver.bcset.mask[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fac = coarse_factor(A)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        x = coarse_solve(fac, torch.ones(A.shape[0], dtype=A.dtype,
                                         device=A.device))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print("%s: N = %d (%.2f GB in f64): assembly %.3f s, factorisation "
              "%.3f s, one solve %.4f s (finite: %s)"
              % (mode, A.shape[0], A.numel() * 8 / 1e9, t1 - t0, t2 - t1,
                 t3 - t2, bool(torch.isfinite(x).all())), flush=True)
        del solver, A, fac, x
    for i, re in enumerate(BENCH_RES):
        d_lu = float((states["allu"][i] - states["lu"][i]).abs().max())
        d_mg = float((states["allu"][i] - almg_u[i]).abs().max())
        print("Re=%s: allu velocity against lu's %.3e, against almg's %.3e"
              % (re, d_lu, d_mg), flush=True)
        if not (d_lu < DIRECT_TOL and d_mg < DIRECT_TOL):
            raise AssertionError("Re=%s: allu's velocity differs from lu's "
                                 "by %.3e, from almg's by %.3e"
                                 % (re, d_lu, d_mg))


def _check_galerkin(name, vamg, rng, flush):
    """Phase 3d: KA over the AMG Galerkin map (``vamg.galerkin``, one chunk
    at the bench config) against
    its plain version on random contributions: max relative error <=
    REL_TOL, two launches bitwise equal; device times warm and cold, the
    byte bound (sources, map, output), the plain version's time and the
    library call's, ``index_put_(accumulate=True)`` of every contribution
    into its dense entry (the JAX package's scatter; its atomics make the
    sums unrepeatable).  Returns the result dict."""
    import torch

    (_, _, g), = vamg.galerkin
    dev = g.device
    src = torch.as_tensor(rng.standard_normal(g.ncell), device=dev)
    dest = torch.full((g.ncell,), g.nvals, dtype=torch.int64, device=dev)
    dest[g.amap_src.long()] = torch.repeat_interleave(
        torch.arange(g.nvals, device=dev), torch.diff(g.amap_ptr.long()))

    def ka():
        return g(src)

    def ka_plain():
        return g.plain(src)

    def library():
        return src.new_zeros(g.nvals + 1).index_put_((dest,), src,
                                                     accumulate=True)

    va, va2, vp = ka(), ka(), ka_plain()
    torch.cuda.synchronize()
    if not torch.equal(va, va2):
        raise AssertionError("%s: two KA launches differ" % name)
    abs_err = float((va - vp).abs().max())
    rel_err = abs_err / max(float(vp.abs().max()), 1e-300)
    lib_err = float((library()[:g.nvals] - vp).abs().max())
    if not (rel_err <= REL_TOL and lib_err <= 1e-12 * float(vp.abs().max())):
        raise AssertionError("%s: KA vs plain max rel err %.3e (library "
                             "%.3e)" % (name, rel_err, lib_err))
    parts = {"sources": 8 * g.nsrc, "map": 4 * g.nsrc + 4 * (g.nvals + 1),
             "values": 8 * g.nvals}
    r = {"name": name, "kernel": "KG", "op": g, "abs_err": abs_err,
         "rel_err": rel_err, "dev_ms": _device_ms(ka, only=KA_NAME),
         "cold_ms": _device_ms(ka, only=KA_NAME, before=flush),
         "plain_dev_ms": _device_ms(ka_plain),
         # one launch of the library call takes seconds: time one
        "library_dev_ms": _device_ms(library, reps=1)}
    r["bound_ms"], r["bound_by"] = _bound_of(parts, float(g.nsrc))
    print("%s: n1 %d, kmax %d, %d contributions (%.3f GB) -> %d map sources "
          "(%.3f GB of int32) -> %d dense entries %8.2e | %s (cold %s) ms | "
          "bound %.2f us %s, %s | plain %s | index_put_(accumulate=True) %s"
          % (name, vamg.n1, vamg.kmax, g.ncell, 8e-9 * g.ncell, g.nsrc,
             4e-9 * g.nsrc, g.nvals, rel_err, _fmt(r["dev_ms"]),
             _fmt(r["cold_ms"]), 1e3 * r["bound_ms"], r["bound_by"],
             _share(r["bound_ms"], r["dev_ms"]), _fmt(r["plain_dev_ms"]),
             _fmt(r["library_dev_ms"])), flush=True)
    return r


def _graddiv_log_rows(path):
    """The iteration cells of every run of a grad-div log, by its
    arguments (an environment setting before the command is not part of
    the key)."""
    import re

    rows, key = {}, None
    head = re.compile(
        r"=== (?:\S+=\S+ )*python examples/graddiv\.py (.*) ===$")
    with open(path) as f:
        for line in f:
            found = head.match(line.rstrip("\n"))
            if found:
                key = found.group(1)
            elif line.startswith("iters:") and key is not None:
                rows[key] = [c.strip() for c in line.split(None, 1)[1]
                             .strip().rstrip("\\").split("\t&")]
    return rows


def _graddiv_phase(label, base_argv, log_path):
    """Phase 17: one 2D grad-div comparison through
    ``alfi_torch.examples.graddiv`` (its output kept off the console),
    every row held to the JAX package's CPU log: patch + transfer equal at
    every gamma; the other rows ">200" where the log says so, elsewhere
    within 10 % or 2 iterations, whichever is larger.  K1, KM, KA and KG
    must have launched."""
    import contextlib
    import io

    from alfi_torch import kernels
    from alfi_torch.examples import graddiv

    want = _graddiv_log_rows(log_path)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for row in GRADDIV_ROWS:
        argv = base_argv + row
        exact = row == ["--smoother", "patch", "--transfer"]
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            got = graddiv.main(argv)
        jax_row = want[" ".join(argv)]
        print("grad-div %s %s: %s (JAX CPU %s) in %.3f s"
              % (label, " ".join(row[1:]), " ".join(got), " ".join(jax_row),
                 time.perf_counter() - t1), flush=True)
        for g, j, c in zip(got, jax_row, graddiv.GAMMAS):
            if exact or j == ">200":
                ok = g == j
            else:
                ok = g != ">200" and abs(int(g) - int(j)) <= max(
                    2, 0.1 * int(j))
            if not ok:
                raise AssertionError("grad-div %s %s gamma=%g: %s iterations "
                                     "against the JAX package's %s"
                                     % (label, " ".join(row), c, g, j))
    launches = _launches()
    print("grad-div %s: %d rows in %.3f s; kernel launches %s"
          % (label, len(GRADDIV_ROWS), time.perf_counter() - t0, launches),
          flush=True)
    if min(launches[k] for k in ("K1", "KM", "KA", "KG")) <= 0:
        raise AssertionError("grad-div %s: a kernel of the path was not "
                             "launched: %s" % (label, launches))


def _baseline_phase(make, alamg_bench, almg_rows):
    """Phase 18: the algebraic baselines.  (a) alamg, simple and lsc at the
    small config over Re 1, 10, 100: Newton counts equal to
    BASELINE_SMALL's, Krylov within one per Newton step (alamg: within 2 %
    too).  (b) At the bench config, the Re of BASELINE_BENCH_RES, every Re
    converges or not as in the JAX package's CPU logs, to a finite state,
    with their counts by (a)'s rule, or, where every linear solve of the
    log stops at maxit, exactly (BASELINE_MAXIT); alamg (gamma = 1e4) takes at
    least 3x
    phase 5's Krylov count (``almg_rows``) at Re 1 alone, simple's Krylov
    per Newton at Re 100 and lsc's at Re 1 exceed almg's at every Re of
    phase 5; KM and KG launch.
    ``alamg_bench``: the bench alamg solver, whose Galerkin map phase 3d
    checked.  Returns that solver's launches per table."""
    import gc

    import torch

    from alfi_torch import kernels

    def held(mode, counts, want):
        for re, (k, n), (kj, nj) in zip(BENCH_RES, counts, want):
            if kj == BASELINE_MAXIT * nj:
                # every linear solve of the log stops at maxit: the same
                # Newton trajectory, exactly (BASELINE_MAXIT)
                ok = (k, n) == (kj, nj)
            else:
                tol = max(nj, 0.02 * kj) if mode == "alamg" else nj
                ok = n == nj and abs(k - kj) <= tol
            if not ok:
                raise AssertionError(
                    "%s Re=%s: Krylov/Newton %d/%d against the JAX "
                    "package's %d/%d" % (mode, re, k, n, kj, nj))

    for mode, want in BASELINE_SMALL.items():
        rows, total = _solve_sweep(make(4, 1, solver_type=mode), BENCH_RES)
        counts = [(r[1], r[2]) for r in rows]
        print("%s at the small config: Krylov/Newton %s (JAX CPU %s), %.3f s"
              % (mode, counts, want, total), flush=True)
        held(mode, counts, want)
    here = os.path.dirname(os.path.abspath(__file__))
    kpn_last, krylov, launched = {}, {}, {}
    for mode in ("alamg", "simple", "lsc"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        solver = (alamg_bench if mode == "alamg"
                  else make(16, 2, solver_type=mode))
        res = BASELINE_BENCH_RES[mode]
        want = _log_solves(os.path.join(here, BASELINE_BENCH_LOGS[mode]),
                           converged=True)[:len(res)]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        counts = []
        for re, (_, _, conv) in zip(res, want):
            z, info = solver.solve(re)
            finite = all(bool(torch.isfinite(x).all()) for x in z)
            counts.append((info["linear_iter"], info["nonlinear_iter"]))
            print("  Re=%-4s krylov=%-4d newton=%-2d %s" % (
                re, counts[-1][0], counts[-1][1], "converged"
                if info["converged"] else "DIVERGED"), flush=True)
            if not (info["converged"] == conv and finite):
                raise AssertionError(
                    "%s Re=%s: converged %s (finite %s), the JAX package's "
                    "%s" % (mode, re, info["converged"], finite, conv))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = _launches()
        if mode == "alamg":
            launched = _table_launches()
        peak = torch.cuda.max_memory_allocated()
        want = [w[:2] for w in want]
        v = solver.vamg
        nsrc = sum(g.nsrc for _, _, g in v.galerkin)
        print("%s at the bench config (gamma %g): %d dofs, n1 %d, kmax %d, "
              "Galerkin map %d sources (%.3f GB); Re %s in %.3f s, "
              "Krylov/Newton %s (JAX CPU %s); peak device memory %.3f GB "
              "(%.3f GB allocated at its start); kernel launches %s"
              % (mode, solver.gamma, solver.Z.dim, v.n1, v.kmax,
                 nsrc, 4e-9 * nsrc, res, total, counts,
                 want, peak / 1e9, resident / 1e9, launches), flush=True)
        held(mode, counts, want)
        if min(launches["KM"], launches["KG"]) <= 0:
            raise AssertionError("%s: KM or KG was not launched: %s"
                                 % (mode, launches))
        krylov[mode] = sum(k for k, _ in counts)
        # the last Re run: 100 for simple, 1 for alamg and lsc
        kpn_last[mode] = counts[-1][0] / counts[-1][1]
        del solver, v
    almg_krylov = sum(r[1] for r in almg_rows)
    almg_kpn = max(r[1] / r[2] for r in almg_rows)
    print("the papers' contrast at the bench config: alamg %d Krylov at Re 1 "
          "against almg's %d over Re 1, 10, 100 (%.1fx); Krylov per Newton: "
          "simple %.2f (Re 100), lsc %.2f (Re 1), almg at most %.2f"
          % (krylov["alamg"], almg_krylov, krylov["alamg"] / almg_krylov,
             kpn_last["simple"], kpn_last["lsc"], almg_kpn), flush=True)
    if not (krylov["alamg"] >= 3 * almg_krylov
            and min(kpn_last["simple"], kpn_last["lsc"]) > almg_kpn):
        raise AssertionError("the baselines do not lose to almg at the "
                             "bench config")
    return launched


def _kinetic_energy(z):
    import torch

    return 0.5 * torch.sum(z[0] * z[0])


def _adjoint_phase(make, parser):
    """Phase 19: at the bench config, Re 1 -> 10 by lu, allu and almg, then
    the adjoint of the kinetic energy: J^T lambda + dJ/dz (BC rows out,
    mean-projected) under ADJOINT_RESID_TOL relative, allu's and almg's
    lambda within ADJOINT_TOL of lu's (pressure mean removed), almg in
    fewer than 100 Krylov iterations; then one ``--nref-vis 1
    --paraview`` solve through the driver, whose refined file must hold
    the refined mesh's vertices and finite values."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from alfi_torch import get_solver, run_solver
    from alfi_torch.problems import TwoDimLidDrivenCavityProblem
    from alfi_torch.solvers.linear import make_jacobian_rmatvec
    from alfi_torch.utils.tree import tnorm

    lam = {}
    for mode in ("lu", "allu", "almg"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        s = make(16, 2, solver_type=mode)
        _solve_sweep(s, [1, 10])
        s.setup_adjoint(_kinetic_energy)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z_adj, info = s.solve_adjoint()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        JTlam = make_jacobian_rmatvec(s.form.residual, s.bcset, s.z,
                                      s.params())(z_adj)
        rhs = s.bcset.zero(torch.func.grad(_kinetic_energy)(s.z))
        r = tuple(a + b for a, b in zip(s.bcset.zero(JTlam), rhs))
        if s.nsp:
            r = (r[0], r[1] - torch.mean(r[1]))
        resid = float(tnorm(r)) / max(1.0, float(tnorm(rhs)))
        peak = torch.cuda.max_memory_allocated()
        print("adjoint %s at the bench config: %d Krylov iterations in %.3f "
              "s; |J^T lambda + dJ/dz| / max(1, |dJ/dz|) = %.3e; peak device "
              "memory %.3f GB (%.3f GB allocated at its start)"
              % (mode, info["linear_iter"], dt, resid, peak / 1e9,
                 resident / 1e9), flush=True)
        if not resid < ADJOINT_RESID_TOL:
            raise AssertionError("adjoint %s: residual %.3e" % (mode, resid))
        if mode == "almg":
            print("almg adjoint: %d Krylov iterations at the bench config; "
                  "the JAX package's CPU count at ldc2d baseN=4 nref=1: %d"
                  % (info["linear_iter"], ADJOINT_ALMG_JAX_SMALL))
            if not info["linear_iter"] < 100:
                raise AssertionError("almg adjoint took %d Krylov iterations"
                                     % info["linear_iter"])
        lam[mode] = tuple(x.clone() for x in z_adj)
        del s, z_adj, JTlam, r
    u1, p1 = lam["lu"]
    p1 = p1 - torch.mean(p1)
    for mode in ("allu", "almg"):
        u2, p2 = lam[mode]
        p2 = p2 - torch.mean(p2)
        du = float((u1 - u2).abs().max())
        dp = float((p1 - p2).abs().max())
        print("adjoint %s against lu: velocity %.3e, pressure (mean removed) "
              "%.3e" % (mode, du, dp), flush=True)
        if not (du < ADJOINT_TOL * (1.0 + float(u1.abs().max()))
                and dp < ADJOINT_TOL * (1.0 + float(p1.abs().max()))):
            raise AssertionError("adjoint %s differs from lu's" % mode)
    del lam
    # visprolong through the driver
    args = parser.parse_args(["--discretisation", "pkp0", "--mh", "uniform",
                              "--baseN", "16", "--nref", "2", "--k", "2",
                              "--nref-vis", "1", "--paraview"])
    solver = get_solver(args, TwoDimLidDrivenCavityProblem(args.baseN),
                        device=torch.device("cuda"))
    solver.verbose = False
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            run_solver(solver, [1], args)
            path = os.path.join("output", str(solver.Z.dim),
                                "velocity-refined-Re-1.vtu")
            with open(path) as f:
                text = f.read()
            size = os.path.getsize(path)
        finally:
            os.chdir(cwd)
    _, vmesh, vspace = solver.visprolong(solver.z[0])
    block = text.split('Name="Velocity" NumberOfComponents="3" '
                       'format="ascii">')[1].split("</DataArray>")[0]
    vel = np.array(block.split(), dtype=float)
    ok = (('NumberOfPoints="%d"' % vmesh.num_vertices) in text
          and vel.size == 3 * vmesh.num_vertices
          and bool(np.isfinite(vel).all()))
    print("--nref-vis 1 --paraview at the bench config: %d vertices, %d "
          "cells, %d velocity dofs on the refined mesh; %d bytes, finite: "
          "%s" % (vmesh.num_vertices, vmesh.num_cells, vspace.ndof, size,
                  ok), flush=True)
    if not ok:
        raise AssertionError("the refined VTU file is wrong")


# ----------------------------------------------------------------------
# phase 3e and 20: the precision modes
# ----------------------------------------------------------------------
def _set_precision(mode):
    """The port's three precision switches (``alfi_torch/config.py``) to
    ``mode``: "f64", "dc32" (the defect-correction f32 smoother),
    "store32" (f32 storage, f64 arithmetic) or "cycle32" (the f32
    cycle)."""
    import torch

    from alfi_torch import config

    f32, f64 = torch.float32, torch.float64
    config.set_mg_dtype(f32 if mode == "cycle32" else f64)
    config.set_mg_store(f32 if mode in ("store32", "cycle32") else f64)
    config.set_mg_smooth_dtype(f32 if mode in ("dc32", "cycle32") else f64)


def _rel_err(y, yp):
    import torch

    y, yp = y.to(torch.float64), yp.to(torch.float64)
    a = float((y - yp).abs().max())
    return a, a / max(float(yp.abs().max()), 1e-300)


def _precision_row(name, kernel, fn, plain, library, tol, bound, flush,
                   only):
    """Check ``fn`` (one wrapper call) against ``plain`` (max relative
    error <= ``tol``, two launches bitwise equal), time it warm and cold,
    the plain version and the library call; ``bound`` = (ms, by)."""
    import torch

    y1, y2, yp = fn(), fn(), plain()
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        raise AssertionError("%s: two launches differ" % name)
    abs_err, rel_err = _rel_err(y1, yp)
    if not rel_err <= tol:
        raise AssertionError("%s: kernel vs plain max rel err %.3e > %.0e"
                             % (name, rel_err, tol))
    # a call of two kernels (KB) is timed as their sum, warm only
    r = {"name": name, "kernel": kernel, "abs_err": abs_err,
         "rel_err": rel_err, "dev_ms": _device_ms(fn, only=only),
         "cold_ms": (None if only is None
                     else _device_ms(fn, only=only, before=flush)),
         "plain_dev_ms": _device_ms(plain),
         "library_dev_ms": (None if library is None
                            else _device_ms(library))}
    r["bound_ms"], r["bound_by"] = bound
    print("%-34s %8.2e (tol %.0e) | device %s ms (cold %s) | bound %.2f us "
          "%s, %s | plain %s | library %s"
          % (name, rel_err, tol, _fmt(r["dev_ms"]), _fmt(r["cold_ms"]),
             1e3 * r["bound_ms"], r["bound_by"],
             _share(r["bound_ms"], r["dev_ms"]), _fmt(r["plain_dev_ms"]),
             _fmt(r["library_dev_ms"])), flush=True)
    return r


def _graddiv_coo(term, B, gamma):
    """(rows, cols, values) of gamma * sum_c R_c^T B_c B_c^T R_c with the
    term's mask in and out."""
    import torch

    nc, nld, _ = B.shape
    G = gamma * torch.einsum("cip,cjp->cij", B, B)
    live = term.gidx >= 0
    rows = term.gidx.long()[:, :, None].expand(nc, nld, nld)
    cols = term.gidx.long()[:, None, :].expand(nc, nld, nld)
    keep = live[:, :, None] & live[:, None, :]
    return rows[keep], cols[keep], G[keep]


def _csr(rows, cols, vals, shape):
    """One CSR matrix for cuSPARSE from COO entries (duplicates summed)."""
    import torch

    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                  shape).coalesce()
    crow = torch._convert_indices_from_coo_to_csr(coo.indices()[0],
                                                  shape[0])
    return torch.sparse_csr_tensor(crow, coo.indices()[1], coo.values(),
                                   shape)


def _graddiv_library(term, B, gamma):
    """gamma * sum_c R_c^T B_c B_c^T R_c with the term's mask in and out,
    as one CSR matrix for cuSPARSE."""
    return _csr(*_graddiv_coo(term, B, gamma), (term.n, term.n))


def _split_library(op, vals, term, B, gamma):
    """The split level operator, keep * (M + gamma G) + diag(1 - keep), as
    one CSR matrix for cuSPARSE (the merged values ``vals`` in their
    dtype, the grad-div part cast to it)."""
    import torch

    m = _merged_library_operator(op, vals).to_sparse_coo().coalesce()
    r, c, g = _graddiv_coo(term, B, gamma)
    return _csr(torch.cat([m.indices()[0], r]),
                torch.cat([m.indices()[1], c]),
                torch.cat([m.values(), g.to(vals.dtype)]), (op.n, op.n))


def _kl_row(name, table, A, x, args, tol, flush):
    """KL on ``table`` with the f32 factors of the f64 matrices ``A``
    against its plain version, with its bound (the live f32 factor
    entries, the tables, x and out; two flops a factor entry) and
    ``torch.linalg.lu_solve`` on the same gathered f32 batch as the
    library call."""
    import torch

    fac = table.factor(A)
    lut, piv = fac["lut"], fac["piv"]
    b = table.gathered(x).to(lut.dtype)[..., None]
    parts = table.bound_bytes(itemsize=x.element_size())
    r = _precision_row(
        name, "KL", lambda: table(fac, x, *args),
        lambda: table.plain(fac, x, *args),
        lambda: torch.linalg.lu_solve(lut.mT, piv, b), tol,
        _bound_of(parts, 2.0 * parts["factors"] / 4, F32_FLOP_PER_S), flush,
        None if not table.disjoint else "patch_lu_solve")
    return r


def _precision_kernels(bench, scale, sv2d, sv3d, gd32, rng, flush):
    """Phase 3e: the precision modes' kernels at every table phases 17
    and 20 drive them at, each against its plain version on the card,
    with device times, bounds and library calls (cuSPARSE in the same or
    the promoted dtype; ``torch.linalg.lu_solve`` for KL): K1 in f32 at
    the bench config's and the 3D scale row's smoother tables (levels 2
    and 1); KL, the f32 LU solve, at the bench config's Schoeberl tables
    (levels 2 and 1, the f32 cycle's) and, on f64 vectors, at the f32
    Chebyshev smoother's tables of the grad-div study (``gd32``, levels 2
    and 1); KM in its three mixed modes at both applied levels of the
    bench config and the 3D scale row, and KM with KB's dof stage as its
    epilogue in the modes the split level apply runs (store32 f32/f64,
    the f32 cycle's f32/f32); KB's cell stage on f64 and f32 vectors at
    the bench config's masked levels 2 and 1, on f64 vectors at the 3D
    scale row's, and both of KB's stages on f32 vectors at its raw
    Schoeberl operators (the f32 cycle's).  Besides, as the
    Scott-Vogelius shapes, which phase 20 does not run: K1 f32 at SV 3D
    L1, KB's cell stage at SV 2D L2.  Each row's ``key`` (configuration,
    kernel and mode, level) names its table's launches in phase 17 or 20.
    Returns the result rows."""
    import torch

    from alfi_torch.kernels import (
        GatherGemvScatter,
        GradDivTerm,
        PatchLUSolve,
    )
    from alfi_torch.mg.patches import static_patch_sum

    f32, f64 = torch.float32, torch.float64
    rows = []
    # K1 f32: the smoothers' tables (out-masked)
    k1 = [("bench", "smoother", l, bench.vmg.patch_solvers[l - 1][1], "2D")
          for l in (2, 1)]
    k1 += [("scale", "smoother", l, scale.vmg.patch_solvers[l - 1][1], "3D")
           for l in (2, 1)]
    k1 += [("sv3d", "smoother", 1, sv3d.vmg.patch_solvers[-1][1], "SV 3D")]
    for config, table, l, op, tag in k1:
        nb, m, _ = op.ashape
        dev = op.device
        A = torch.as_tensor(rng.standard_normal((nb, m, m)), device=dev,
                            dtype=f32)
        x = torch.as_tensor(rng.standard_normal(op.n), device=dev, dtype=f32)
        p = torch.as_tensor(rng.standard_normal(op.n), device=dev, dtype=f32)
        args = (p,) if op.out_keep is not None else ()
        bare = GatherGemvScatter(op.pidx.cpu().numpy(), op.n, "K1",
                                 device=dev)
        lib = _library_operator(bare, A)
        del bare
        parts = _bound_bytes(op, itemsize=4)
        r = _precision_row(
            "K1 f32 %s %s L%d (%d x %d, %s)" % (
                table, tag, l, nb, m, KERNEL_OF_PATH[op.kernel_path()]),
            "K1 f32", lambda: op(A, x, *args),
            lambda: op.plain(A, x, *args), lambda: lib @ x, 1e-5,
            _bound_of(parts, 2.0 * parts["A"] / 4, F32_FLOP_PER_S), flush,
            KERNEL_NAME)
        r["kernel_path"] = KERNEL_OF_PATH[op.kernel_path()]
        r["key"] = (config, "K1 f32 " + table, l)
        rows.append(r)
        del A, lib
        torch.cuda.empty_cache()
    # KL: the f32 cycle's Schoeberl solves, on the transfer matrices at Re
    # 100's viscosity (f32 factors of condition up to gamma / nu: 1e-4),
    # and the f32 Chebyshev smoother's, on f64 vectors (random diagonally
    # dominant patch matrices)
    for t in reversed(bench.vmg.schoeberl):
        ps = t.patchset
        table = PatchLUSolve(ps.dofs, ps.nflat, device=bench.vmg.device)
        A = static_patch_sum(bench._almg_static["schoeberl"][t.l],
                             {"nu": 0.02, "gamma": 1e4})
        x = torch.as_tensor(rng.standard_normal(table.n), device=table.device,
                            dtype=f32)
        r = _kl_row("KL f32 schoeberl 2D L%d (%d x %d)" % (
            t.l + 1, table.npatches, table.m), table, A, x, (), 1e-4, flush)
        r["key"] = ("bench", "KL schoeberl", t.l + 1)
        rows.append(r)
    for l in (2, 1):
        table = gd32.vmg.patch_lu[l - 1]
        nb, m, _ = table.ashape
        A = (torch.as_tensor(rng.standard_normal((nb, m, m)),
                             device=table.device)
             + m * torch.eye(m, dtype=f64, device=table.device))
        x = torch.as_tensor(rng.standard_normal(table.n), device=table.device)
        r = _kl_row("KL f32 on f64 smoother grad-div L%d (%d x %d)" % (
            l, nb, m), table, A, x, (x,), 1e-5, flush)
        r["key"] = ("graddiv", "KL smoother", l)
        rows.append(r)
    torch.cuda.empty_cache()
    # KM in its three mixed modes, and with the grad-div epilogue in the
    # split level apply's modes
    for config, vmg, tag, epi in (("bench", bench.vmg, "2D",
                                   ((f32, f64), (f32, f32))),
                                  ("scale", scale.vmg, "3D", ((f32, f64),))):
        for l in (2, 1):
            op = vmg.level_ops[l]
            dev = op.device
            lev = vmg.levels[l]
            term = GradDivTerm(lev.rows.cpu().numpy(), op.n,
                               keep=lev.mask_flat, device=dev)
            B = vmg.gd_factors(l)
            vals = torch.as_tensor(rng.standard_normal(op.vshape),
                                   device=dev)
            x = torch.as_tensor(rng.standard_normal(op.n), device=dev)
            for vt, xt, tol in ((f64, f32, 1e-6), (f32, f64, 1e-13),
                                (f32, f32, 1e-5)):
                v, xx = vals.to(vt), x.to(xt)
                ct = torch.promote_types(vt, xt)
                lib = _merged_library_operator(op, v.to(ct))
                xc = xx.to(ct)
                parts = _merged_bound_bytes(op, vbytes=v.element_size(),
                                            xbytes=xx.element_size())
                mode = "%s/%s" % tuple("f32" if t == f32 else "f64"
                                       for t in (vt, xt))
                r = _precision_row(
                    "KM %s %s L%d (%d blocks of %dx%d)" % (
                        mode, tag, l, op.pattern.nnzb, op.d, op.d),
                    "KM " + mode, lambda: op(v, xx), lambda: op.plain(v, xx),
                    lambda: lib @ xc, tol,
                    _bound_of(parts, 2.0 * op.d * op.d * op.pattern.nnzb,
                              F32_FLOP_PER_S if ct == f32
                              else F64_FLOP_PER_S),
                    flush, KM_NAME)
                r["key"] = (config, "KM " + mode, l)
                rows.append(r)
                if (vt, xt) in epi:
                    # the dof stage reads the cell stage's contributions
                    # (f64, in list order) and the lists' offsets; the
                    # library call sums gamma G into the same CSR matrix
                    w = term.cell_stage(B, 1e4, xx)
                    arg = (term, w)
                    nc, nld, q = B.shape
                    parts.update(w=8 * w.numel(), offsets=4 * (term.n + 1))
                    del lib
                    lib = _split_library(op, v.to(ct), term, B, 1e4)
                    r = _precision_row(
                        "KM+KB %s %s L%d (%d blocks, %d cells x %d)" % (
                            mode, tag, l, op.pattern.nnzb, nc, nld),
                        "KM+KB " + mode, lambda: op(v, xx, graddiv=arg),
                        lambda: op.plain(v, xx, graddiv=arg),
                        lambda: lib @ xc, tol,
                        _bound_of(parts,
                                  2.0 * (op.d * op.d * op.pattern.nnzb
                                         + nc * nld * q),
                                  F64_FLOP_PER_S), flush, KM_NAME)
                    r["key"] = (config, "KM+KB " + mode, l)
                    rows.append(r)
                del lib
            del vals, term
            torch.cuda.empty_cache()
    # KB, the gamma-split grad-div term, f64 arithmetic: on the masked
    # tables (the level operators') the cell stage alone where the level
    # takes the dof stage as KM's epilogue (above), else both stages, each
    # with the other's time printed beside it; both stages on the raw
    # tables (the Schoeberl transfers')
    kb = [("bench", "2D", l, True, (f64, f32)) for l in (2, 1)]
    kb += [("bench", "2D", l, False, (f32,)) for l in (2, 1)]
    kb += [("scale", "3D", l, True, (f64,)) for l in (2, 1)]
    kb += [("sv2d", "SV 2D", 2, True, (f64, f32))]
    solvers = {"bench": bench, "scale": scale, "sv2d": sv2d}
    for config, tag, l, masked, dtypes in kb:
        vmg = solvers[config].vmg
        lev = vmg.levels[l]
        dev = vmg.device
        term = GradDivTerm(lev.rows.cpu().numpy(), lev.V.ndof * vmg.d,
                           keep=lev.mask_flat if masked else None,
                           device=dev)
        B = vmg.gd_factors(l)
        nc, nld, q = B.shape
        lib = _graddiv_library(term, B, 1e4)
        cells = masked and vmg.level_ops[l].takes_epilogue
        if cells:
            # the cell stage alone, w = B_c,i . gamma B_c^T x_c for every
            # cell entry: one CSR matrix of gamma G_c's rows
            G = 1e4 * torch.einsum("cip,cjp->cij", B, B)
            ri = torch.arange(nc * nld, device=dev).reshape(
                nc, nld)[:, :, None].expand(nc, nld, nld)
            ci = term.gidx.long()[:, None, :].expand(nc, nld, nld)
            keep = ci >= 0
            cell_lib = _csr(ri[keep], ci[keep], G[keep],
                            (nc * nld, term.n))
            del G, ri, ci, keep
        for xt in dtypes:
            tol = 1e-13 if xt == f64 else 1e-6
            x = torch.as_tensor(rng.standard_normal(term.n), device=dev,
                                dtype=xt)
            y = torch.as_tensor(rng.standard_normal(term.n), device=dev,
                                dtype=xt)
            xl, yl = x.to(f64), y.to(f64)
            itemsize = x.element_size()
            live = term.gidx >= 0
            xbytes = itemsize * int(torch.unique(term.gidx[live]).numel())
            dt = "f32" if xt == f32 else "f64"
            kind = ("masked" if masked else "raw (Schoeberl)")
            if cells:
                parts = {"B": 8 * B.numel(), "gidx": 4 * nc * nld,
                         "x": xbytes, "w": 8 * nc * nld}
                r = _precision_row(
                    "KB cell stage %s %s %s L%d (%d cells x %d x q=%d)"
                    % (dt, kind, tag, l, nc, nld, q), "KB",
                    lambda: term.cell_stage(B, 1e4, x),
                    lambda: term.contributions(
                        B, term._plain_cells(B, 1e4, x)),
                    lambda: cell_lib @ xl, 1e-13,
                    _bound_of(parts, 4.0 * nc * nld * q, F64_FLOP_PER_S),
                    flush, "graddiv_cell_kernel")
                other = _device_ms(lambda: term(B, 1e4, x, y))
                print("  both stages (cell + dof kernel, two launches) %s ms"
                      % _fmt(other), flush=True)
            else:
                parts = {"B": 8 * B.numel(), "gidx": 4 * nc * nld,
                         "lists": 4 * (term.n + 1) + 4 * term.slots.numel(),
                         "x": xbytes, "y": itemsize * term.n,
                         "out": itemsize * term.n}
                r = _precision_row(
                    "KB %s %s %s L%d (%d cells x %d x q=%d)" % (
                        dt, kind, tag, l, nc, nld, q), "KB",
                    lambda: term(B, 1e4, x, y),
                    lambda: term.plain(B, 1e4, x, y),
                    lambda: yl + lib @ xl, tol,
                    _bound_of(parts, 4.0 * nc * nld * q, F64_FLOP_PER_S),
                    flush, None)
                if masked:
                    other = _device_ms(lambda: term.cell_stage(B, 1e4, x),
                                       only="graddiv_cell_kernel")
                    print("  the cell stage alone %s ms" % _fmt(other),
                          flush=True)
            r["key"] = (config, "KB %s%s" % ("" if masked else "schoeberl ",
                                             dt), l)
            rows.append(r)
        del lib, term
        if cells:
            del cell_lib
        torch.cuda.empty_cache()
    return rows


def _precision_table_launches(vmg):
    """{(kernel and mode, level): launches} of a hierarchy's precision
    tables since the last reset: K1 in f32 on its smoother tables, KL on
    the Schoeberl ones, KM per mixed mode and with the grad-div epilogue,
    KB's cell stage (masked) on f64 and f32 vectors and both its stages on
    the raw Schoeberl operators (the same keys as phase 3e's rows)."""
    out = {}
    for l in range(1, vmg.nlevels):
        out["K1 f32 smoother", l] = vmg.patch_solvers[l - 1][1].f32_launched
        op = vmg.level_ops[l]
        for mode, n in op.mode_launched.items():
            out["KM " + mode, l] = n
        for mode, n in op.gd_launched.items():
            out["KM+KB " + mode, l] = n
        term = vmg.graddiv_terms[l]
        out["KB f32", l] = 0 if term is None else term.f32_launched
        out["KB f64", l] = 0 if term is None else (term.launched
                                                   - term.f32_launched)
    for t in vmg.schoeberl or ():
        out["KL schoeberl", t.l + 1] = (0 if t.lusolve is None
                                        else t.lusolve.launched)
        out["KB schoeberl f32", t.l + 1] = (0 if t._gd_term is None
                                            else t._gd_term.f32_launched)
    return out


def _precision_sweep(label, build, res, warm):
    """Build a solver (the precision switches already set), optionally
    warm it with one Re-1 solve from zero, then solve ``res`` from zero;
    returns (counts, seconds per Re, peak device memory above what was
    allocated before the build, bytes the built solver holds, the
    precision tables' launches as _precision_table_launches gives them)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = build()
    solver.verbose = False
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - before
    if warm:
        solver.solve(1)
        solver.z = solver.bcset.apply(solver.Z.zero(torch.device("cuda")))
        solver.z_last = solver.z
    rows, total = _solve_sweep(solver, res)
    peak = torch.cuda.max_memory_allocated() - before
    vmg = solver.vmg
    print("%s: %d dofs (cdt %s, sdt %s, mdt %s), built in %.2f s holding "
          "%.3f GB; Re %s in %.3f s; peak device memory %.3f GB above what "
          "was allocated before the build"
          % (label, solver.Z.dim, vmg.cdt, vmg.sdt, vmg.mdt, built,
             held / 1e9, "->".join(str(r) for r in res), total, peak / 1e9),
          flush=True)
    counts = [(r[1], r[2]) for r in rows]
    secs = [r[3] for r in rows]
    tables = _precision_table_launches(vmg)
    del solver, vmg
    gc.collect()
    torch.cuda.empty_cache()
    return counts, secs, peak, held, tables


def _precision_phase(make, scale_build, here):
    """Phase 20: (b) the bench config in f64 and in each mode, warm, Re 1
    -> 10 -> 100: each mode's counts against its JAX CPU log (the same
    Newton counts, Krylov within one per Newton step) and against the f64
    control by the JAX package's gates (dc32 and store32 c64 + 1, the f32
    cycle 1.10 c64 + 1, per Re; PRECISION_JAX_MISSES); the f32 cycle runs
    with the Schoeberl state in f32 (its LU factors, kernel KL), as the
    JAX package's does; (c) the 3D scale row in f64, dc32 and store32, Re
    1 -> 10 -> 100, cold, every Re converged.  The launch counts are
    zeroed before (b) and read after (c); K1 in f32, KL, KM in each mixed
    mode, KM with the grad-div epilogue and KB must have launched.
    Returns {(configuration, kernel and mode, level): launches} of phase
    3e's rows' tables."""
    from alfi_torch import kernels

    def hold(mode, res, counts, c64, want, j64):
        for re, (k, n), (kj, nj), (k64, _), (kj64, _) in zip(
                res, counts, want, c64, j64):
            if not (n == nj and k <= kj + nj):
                raise AssertionError(
                    "precision %s Re=%s: %d/%d against the JAX CPU log's "
                    "%d/%d" % (mode, re, k, n, kj, nj))
            scale_k, plus = PRECISION_GATES[mode]
            bound = scale_k * k64 + plus
            missed = kj > scale_k * kj64 + plus
            if missed != ((mode, re) in PRECISION_JAX_MISSES):
                raise AssertionError(
                    "precision %s Re=%s: the JAX CPU logs %s the gate (%d "
                    "Krylov against their f64 %d), PRECISION_JAX_MISSES "
                    "says otherwise" % (mode, re, "miss" if missed
                                        else "meet", kj, kj64))
            if missed:
                print("precision %s Re=%s: the JAX package misses the gate "
                      "itself (%d Krylov against its f64 %d): held to its "
                      "%d" % (mode, re, kj, kj64, kj), flush=True)
                bound = kj
            if not k <= bound:
                raise AssertionError(
                    "precision %s Re=%s: %d Krylov against the f64 "
                    "control's %d (gate %.2f c64 + %d)"
                    % (mode, re, k, k64, scale_k, plus))

    launched = {}

    def count(config, tables):
        for (kind, l), n in tables.items():
            key = (config, kind, l)
            launched[key] = launched.get(key, 0) + n

    kernels.reset_launch_counts()
    try:
        bench = {}
        for mode in ("f64",) + tuple(PRECISION_GATES):
            _set_precision(mode)
            bench[mode] = _precision_sweep(
                "precision bench %s" % mode, lambda: make(16, 2), BENCH_RES,
                warm=True)
            count("bench", bench[mode][4])
        c64 = bench["f64"][0]
        j64 = _log_solves(os.path.join(here, PRECISION_LOGS["f64"]))
        for mode in PRECISION_GATES:
            counts, secs, peak = bench[mode][:3]
            want = _log_solves(os.path.join(here, PRECISION_LOGS[mode]))
            print("precision bench %s: Krylov/Newton %s (JAX CPU log %s, "
                  "f64 control %s); s per Re %s (f64 %s); peak %.3f GB (f64 "
                  "%.3f)" % (mode, counts, want, c64,
                             ", ".join("%.3f" % t for t in secs),
                             ", ".join("%.3f" % t for t in bench["f64"][1]),
                             peak / 1e9, bench["f64"][2] / 1e9), flush=True)
            hold(mode, BENCH_RES, counts, c64, want, j64)
        scale = {}
        for mode in ("f64", "dc32", "store32"):
            _set_precision(mode)
            scale[mode] = _precision_sweep("precision 3D scale row %s" % mode,
                                           scale_build, BENCH_RES,
                                           warm=False)
            count("scale", scale[mode][4])
        for mode in ("dc32", "store32"):
            counts, secs, peak, held, _ = scale[mode]
            print("precision 3D scale row %s: Krylov/Newton %s (f64 %s); s "
                  "per Re %s (f64 %s); peak %.3f GB (f64 %.3f); solver holds "
                  "%.3f GB (f64 %.3f)"
                  % (mode, counts, scale["f64"][0],
                     ", ".join("%.3f" % t for t in secs),
                     ", ".join("%.3f" % t for t in scale["f64"][1]),
                     peak / 1e9, scale["f64"][2] / 1e9, held / 1e9,
                     scale["f64"][3] / 1e9), flush=True)
            if counts != scale["f64"][0]:
                raise AssertionError("precision 3D scale row %s: %s against "
                                     "the f64 counts %s"
                                     % (mode, counts, scale["f64"][0]))
    finally:
        _set_precision("f64")
    out = {"K1 f32": kernels.GatherGemvScatter.f32_launches["K1"],
           "KL": kernels.PatchLUSolve.launches["KL"]}
    out.update(("KM " + k, v)
               for k, v in kernels.MergedLevelOperator.mode_launches.items())
    out.update(kernels.MergedLevelOperator.epilogue_launches)
    out["KB"] = kernels.GradDivTerm.launches["KB"]
    print("precision phase kernel launches: %s" % out, flush=True)
    for key, n in out.items():
        if n <= 0:
            raise AssertionError("precision phase: %s never launched" % key)
    print("precision phase launches per table: %s" % ", ".join(
        "%s %s L%d %d" % (k + (n,)) for k, n in sorted(launched.items())),
        flush=True)
    return launched


def _graddiv_f32_row(gd32, log_path):
    """Phase 17's row with the smoother's patch factors stored in f32
    (``gd32``: the grad-div solver built with mg_smooth_dtype f32, its
    tables phase 3e checked): CG counts at the eight gamma of the harness
    equal to the JAX package's CPU log of the same row; KL must have
    launched on f64 vectors at every smoothed level.  Returns
    {("graddiv", "KL smoother", level): launches}."""
    from alfi_torch import kernels
    from alfi_torch.examples import graddiv

    want = _graddiv_log_rows(log_path)
    (jax_row,) = want.values()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = []
    for g in graddiv.GAMMAS:
        _, its, conv = gd32.solve(g)
        got.append(str(its) if conv else ">200")
    tables = {("graddiv", "KL smoother", l + 1): t.mixed_launched
              for l, t in enumerate(gd32.vmg.patch_lu)}
    print("grad-div pkp0 patch + transfer, smoother stored in f32 (mdt %s): "
          "%s (JAX CPU %s) in %.3f s; KL launches per level %s"
          % (gd32.vmg.mdt, " ".join(got), " ".join(jax_row),
             time.perf_counter() - t0, tables), flush=True)
    if got != jax_row:
        raise AssertionError("grad-div with the smoother stored in f32: %s "
                             "against the JAX package's %s" % (got, jax_row))
    if min(tables.values()) <= 0:
        raise AssertionError("grad-div f32 smoother: KL not launched at "
                             "every level: %s" % tables)
    return tables


def main(kernels_only=False):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from alfi_torch import (
        ConstantPressureSolver,
        get_default_parser,
        get_solver,
        kernels,
    )
    from alfi_torch.problems import (
        ThreeDimBackwardsFacingStepProblem,
        ThreeDimLidDrivenCavityProblem,
        TwoDimLidDrivenCavityProblem,
    )

    warnings.filterwarnings("ignore", message="Sparse")
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    # 2. build (the three sources, one nvcc each, started together)
    t0 = time.perf_counter()
    kernels.load_library()
    print("kernel build: %.2f s (%s)"
          % (time.perf_counter() - t0, ", ".join(
              os.path.basename(src) for src in kernels.SOURCES)), flush=True)
    for line in kernels.build_log.splitlines():
        if "ptxas info" in line:
            print("  " + line.strip())

    # the solvers whose tables phases 3 and 3a read; they run on the card
    # by default.  The headline, scale and step solvers come from the
    # driver's get_solver, as phases 7, 9 and 10 run them.
    def make(baseN, nref, **kw):
        return ConstantPressureSolver(
            TwoDimLidDrivenCavityProblem(baseN), nref=nref, k=2,
            **dict(dict(solver_type="almg", hierarchy="uniform", gamma=1e4,
                        verbose=False), **kw))

    def timed(label, build):
        t0 = time.perf_counter()
        solver = build()
        torch.cuda.synchronize()
        print("%s solver built: %d dofs, %.2f s; merged level operators "
              "(blocks, merge factor, host seconds): %s"
              % (label, solver.Z.dim, time.perf_counter() - t0, ", ".join(
                  "L%d %d, %.2fx, %.2f s" % (l, op.pattern.nnzb,
                                             op.pattern.merge_factor,
                                             op.pattern.seconds)
                  for l, op in enumerate(solver.vmg.level_ops))),
              flush=True)
        return solver

    here = os.path.dirname(os.path.abspath(__file__))
    parser = get_default_parser()
    head_args = parser.parse_args(HEADLINE_ARGV)
    scale_args = parser.parse_args(SCALE_ARGV)
    step_args = parser.parse_args(STEP_ARGV)
    sv2d_args = parser.parse_args(SV2D_ARGV)
    sv3d_args = parser.parse_args(SV3D_ARGV)
    bench = timed("bench", lambda: make(16, 2))
    head = timed("headline", lambda: get_solver(
        head_args, TwoDimLidDrivenCavityProblem(head_args.baseN),
        device=dev))
    big = timed("nref=3", lambda: make(16, 3))
    scale = timed("3D scale row", lambda: get_solver(
        scale_args, ThreeDimLidDrivenCavityProblem(scale_args.baseN),
        device=dev))
    step = timed("3D step", lambda: get_solver(
        step_args, ThreeDimBackwardsFacingStepProblem(
            os.path.join(here, STEP_MESH)), device=dev))
    sv2d = timed("SV 2D", lambda: get_solver(
        sv2d_args, TwoDimLidDrivenCavityProblem(sv2d_args.baseN),
        device=dev))
    sv3d = timed("SV 3D", lambda: get_solver(
        sv3d_args, ThreeDimLidDrivenCavityProblem(sv3d_args.baseN),
        device=dev))
    # phase 17's grad-div row with the smoother stored in f32, whose KL
    # tables phase 3e reads (mdt is fixed when the hierarchy is built)
    t0 = time.perf_counter()
    from alfi_torch import config
    from alfi_torch.graddiv import GradDivSolver

    config.set_mg_smooth_dtype(torch.float32)
    try:
        gd32 = GradDivSolver(device=dev, **GRADDIV_F32_KW)
    finally:
        config.set_mg_smooth_dtype(torch.float64)
    print("grad-div solver with the smoother stored in f32 built: %.2f s"
          % (time.perf_counter() - t0), flush=True)
    # phase 16's multiplicative sweeps, whose colour tables phase 3c reads
    mult = timed("multiplicative", lambda: make(
        16, 2, patch_composition="multiplicative"))
    mult3d = timed("multiplicative 3D", lambda: ConstantPressureSolver(
        ThreeDimLidDrivenCavityProblem(2), nref=1, k=2, solver_type="almg",
        hierarchy="uniform", gamma=1e4, verbose=False,
        patch_composition="multiplicative"))
    # phase 18's alamg at the bench config, whose Galerkin map phase 3d reads
    t0 = time.perf_counter()
    alamg_bench = make(16, 2, solver_type="alamg")
    print("alamg bench solver built: %.2f s (aggregation, P, the fine "
          "pattern and the Galerkin map on the host)"
          % (time.perf_counter() - t0), flush=True)

    def tables(vmg, levels, tag=""):
        """(name, table, mask for the masked variant) of a hierarchy's K1
        smoother and K1 Schoeberl tables at ``levels``."""
        out = [("K1 smoother %sL%d" % (tag, l), vmg.patch_solvers[l - 1][1],
                None) for l in levels]
        out += [("K1 schoeberl %sL%d" % (tag, t.l + 1), t.papply, t.zmask)
                for t in reversed(vmg.schoeberl) if t.l + 1 in levels]
        return out

    # 3. the fused kernel vs its plain version on the 2D main-path tables
    ops2d = tables(head.vmg, (2, 1))
    ops2d += [("K1 smoother nref3", big.vmg.patch_solvers[-1][1], None)]
    # 3a. and on the 3D ones
    ops3d = tables(scale.vmg, (2, 1), "3D ") + tables(step.vmg, (1,),
                                                      "step ")
    # 3b. and on the Scott-Vogelius ones
    ops_sv = [("K1 macrostar SV L2", sv2d.vmg.patch_solvers[-1][1], None),
              ("K1 macrostar SV 3D L1", sv3d.vmg.patch_solvers[-1][1],
               None)]
    # the merged level operators (KA, KM) of the levels the main paths
    # apply: the 2D headline's levels 2 and 1 and nref=3's fine level, the
    # 3D scale row's levels 2 and 1, the step's, and both SV fine levels
    levels = [("level L2", head.vmg, 2), ("level L1", head.vmg, 1),
              ("level nref3", big.vmg, 3), ("level 3D L2", scale.vmg, 2),
              ("level 3D L1", scale.vmg, 1), ("level step L1", step.vmg, 1),
              ("level SV L2", sv2d.vmg, 2), ("level SV 3D L1", sv3d.vmg, 1)]
    flush_buf = torch.empty(FLUSH_BYTES // 8, dtype=torch.float64,
                            device=dev)
    rng = np.random.default_rng(0)
    print("%-22s %12s %-6s %8s  %s" % (
        "operator", "blocks x m", "masks", "rel err",
        "kernel, ms eager (device, cold, the other kernel) | bound, share | "
        "bytes of A | plain ms eager (device) | library ms eager (device)"))
    table = []
    for name, op, mask in ops2d + ops3d + ops_sv:
        table += _check_kernel(name, op, rng, flush_buf.zero_, mask)
        torch.cuda.empty_cache()
    for name, vmg, l in levels:
        table += _check_merged(name, vmg, l, rng, flush_buf.zero_)
        torch.cuda.empty_cache()
    # 3c. the per-colour K1 tables of the multiplicative sweeps, bare as
    # the sweep calls them
    for tag, vmg in (("", mult.vmg), ("3D ", mult3d.vmg)):
        for l, (_, sweep) in enumerate(vmg.patch_solvers, 1):
            print("multiplicative %sL%d: %d patches in %d colours (%s), %d "
                  "K1 launches per symmetrised sweep"
                  % (tag, l, sweep.patchset.npatches, sweep.ncolors,
                     ", ".join(str(sweep.bounds[c + 1] - sweep.bounds[c])
                               for c in range(sweep.ncolors)),
                     len(sweep.seq)), flush=True)
            for c, op in enumerate(sweep.tables):
                table += _check_kernel("K1 colour %sL%d c%d" % (tag, l, c),
                                       op, rng, flush_buf.zero_,
                                       bare_only=True)
    # 3d. KA over the AMG Galerkin map of the bench config; KM on the AMG
    # fine operator is phase 3b's "level L2" table (the same pattern)
    same = (alamg_bench.vamg.level_op.pattern.nnzb
            == head.vmg.level_ops[2].pattern.nnzb and np.array_equal(
                alamg_bench.vamg.level_op.pattern.bcol,
                head.vmg.level_ops[2].pattern.bcol))
    print("KM on the AMG fine operator: the pattern of phase 3b's level L2 "
          "(identical: %s), not timed again" % same, flush=True)
    if not same:
        raise AssertionError("the AMG fine pattern is not level L2's")
    table.append(_check_galerkin("KA Galerkin bench", alamg_bench.vamg, rng,
                                 flush_buf.zero_))
    torch.cuda.empty_cache()
    # 3e. the precision modes' kernels (phases 17 and 20 drive them): K1 in
    # f32, KL, KM in its mixed modes and with KB's dof stage, KB
    precision_rows = _precision_kernels(bench, scale, sv2d, sv3d, gd32, rng,
                                        flush_buf.zero_)
    torch.cuda.empty_cache()
    # the list holds every hierarchy: drop it, so that the solver a later
    # phase deletes is freed and each sweep's peak is its own
    del flush_buf, levels, vmg
    sv_batches = [(ps.npatches, ps.m) for ps in (sv2d.vmg.patchsets[-1],
                                                 sv3d.vmg.patchsets[-1])]
    _time_patch_inverses(dev, [(4913, 189), (729, 189)] + sv_batches)
    torch.cuda.empty_cache()
    print("device memory allocated after the kernel rows: %.3f GB"
          % (torch.cuda.memory_allocated() / 1e9), flush=True)
    if kernels_only:
        return

    # 4. reference parity at the small config
    small = make(4, 1)
    rows, _ = _solve_sweep(small, BENCH_RES)
    counts = [(r[1], r[2]) for r in rows]
    if counts != SMALL_COUNTS:
        raise AssertionError("small config counts %s != JAX package %s"
                             % (counts, SMALL_COUNTS))
    print("small config (%d dofs) counts equal the JAX package's: %s"
          % (small.Z.dim, counts), flush=True)
    small = make(4, 1, stabilisation_type="supg", restriction=True)
    rows, _ = _solve_sweep(small, BENCH_RES)
    counts = [(r[1], r[2]) for r in rows]
    if counts != SMALL_SUPG_COUNTS:
        raise AssertionError("small SUPG counts %s != JAX package %s"
                             % (counts, SMALL_SUPG_COUNTS))
    print("small config with SUPG and restriction: counts equal the JAX "
          "package's: %s" % counts, flush=True)

    # 5. the bench config
    t0 = time.perf_counter()
    bench.solve(1)
    torch.cuda.synchronize()
    print("warm-up Re=1: %.3f s" % (time.perf_counter() - t0), flush=True)
    bench.z = bench.bcset.apply(bench.Z.zero(dev))
    bench.z_last = bench.z
    kernels.reset_launch_counts()
    bench_u = []
    rows, t_bench = _solve_sweep(bench, BENCH_RES, keep=bench_u)
    bench_rows = rows
    launches = _launches()
    krylov = sum(r[1] for r in rows)
    newton = sum(r[2] for r in rows)
    print("bench config: %d dofs, Re 1->10->100 in %.3f s, Krylov %d, "
          "Newton %d, kernel launches %s"
          % (bench.Z.dim, t_bench, krylov, newton, launches), flush=True)
    if (krylov, newton) != BENCH_COUNTS:
        raise AssertionError("bench counts %d/%d, expected %d/%d"
                             % ((krylov, newton) + BENCH_COUNTS))
    if launches["K1"] <= 0:
        raise AssertionError("the fused kernel was not launched for K1 on "
                             "the main path")
    _check_levels("bench config", bench, launches)

    # where the time goes: one Newton linear step of the Re=100 solve
    # (from the Re=10 state) under torch.profiler
    params = bench.params()
    z = bench.z_last
    F = bench.residual_masked(z, params)
    _profile_linear_step(bench)
    # the Jacobian action is torch.func.jvp of the residual, which
    # evaluates the residual again on every call
    from alfi_torch.solvers.linear import make_jacobian_matvec

    J = make_jacobian_matvec(bench.form.residual, bench.bcset, z, params)
    ms_res = _median_ms(lambda: bench.residual_masked(z, params), reps=5,
                        inner=10)
    ms_jvp = _median_ms(lambda: J(F), reps=5, inner=10)
    print("Jacobian action (jvp): %.3f ms per call; masked residual: "
          "%.3f ms per call" % (ms_jvp, ms_res), flush=True)

    # 6. nref=3
    kernels.reset_launch_counts()
    _, t_big = _solve_sweep(big, [1, 10])
    print("nref=3: Re 1->10 in %.3f s" % t_big, flush=True)
    _check_levels("nref=3", big, _launches())
    launched = _table_launches()
    del big
    torch.cuda.empty_cache()

    # 7. the headline protocol through the driver
    per_table = _driver_sweep("headline protocol", head, head_args,
                              HEADLINE_JAX, HEADLINE_EXACT, 41474)
    launched.update((k, v) for k, v in per_table.items() if v)
    del head, bench
    torch.cuda.empty_cache()

    # 8. 3D parity at the small cavity, [P2+FB]^3 and [P1+FB]^3
    for k, expected in sorted(CAVITY3D_COUNTS.items(), reverse=True):
        small = ConstantPressureSolver(
            ThreeDimLidDrivenCavityProblem(2), nref=1, k=k,
            solver_type="almg", hierarchy="uniform", gamma=1e4,
            verbose=False)
        rows, _ = _solve_sweep(small, BENCH_RES)
        counts = [(r[1], r[2]) for r in rows]
        if counts != expected:
            raise AssertionError("ldc3d k=%d counts %s != JAX package %s"
                                 % (k, counts, expected))
        print("ldc3d baseN=2 nref=1 k=%d (%d dofs, %s, prolongation %s): "
              "counts equal the JAX package's: %s"
              % (k, small.Z.dim, small.Z.V.element.name,
                 type(small.vmg.prolongs[0]).__name__, counts), flush=True)
    del small

    # 9. the 3D scale row at full width (this slice's main path)
    per_table = _driver_sweep("3D scale row", scale, scale_args,
                              SCALE_JAX, SCALE_EXACT, SCALE_DOFS)
    launched.update((k, v) for k, v in per_table.items() if v)
    del scale
    torch.cuda.empty_cache()

    # 10. [P1+FB]^3 on the 3D step's gmsh mesh
    per_table = _driver_sweep("3D step", step, step_args, STEP_JAX,
                              (1, 10), STEP_DOFS)
    launched.update((k, v) for k, v in per_table.items() if v)
    del step
    torch.cuda.empty_cache()

    # 11. the second paper's headline protocol, Scott-Vogelius with
    # Burman, through the driver; the velocity of every Re divergence-free
    from alfi_torch.fem.errors import ErrorComputer

    def divergence_free(solver, gate):
        errors = ErrorComputer(solver.form)
        norms = {}

        def check(re, u):
            norms[re] = float(errors.divergence_norm(
                torch.as_tensor(u, device=dev)))
            print("  Re=%s divergence_norm %.3e" % (re, norms[re]),
                  flush=True)
            if gate and not norms[re] < SV_DIV_TOL:
                raise AssertionError("SV Re=%s: divergence_norm %.3e >= "
                                     "%.0e" % (re, norms[re], SV_DIV_TOL))

        return check

    per_table = _driver_sweep(
        "SV headline protocol", sv2d, sv2d_args, SV2D_JAX, HEADLINE_EXACT,
        SV2D_DOFS, state_check=divergence_free(sv2d, True))
    launched.update((k, v) for k, v in per_table.items() if v)
    del sv2d
    torch.cuda.empty_cache()

    # 12. Scott-Vogelius in 3D (macrostar patches of m = 1590)
    per_table = _driver_sweep(
        "SV 3D", sv3d, sv3d_args, SV3D_JAX, tuple(SV3D_JAX), SV3D_DOFS,
        state_check=divergence_free(sv3d, False))
    launched.update((k, v) for k, v in per_table.items() if v)
    del sv3d
    torch.cuda.empty_cache()

    # 13. the direct modes at the bench config, against lu and phase 5
    _direct_phase(make, bench_u)
    torch.cuda.empty_cache()

    # 14. the MMS convergence studies through the port's harness
    for label, argv, counts_log, orders_log, div_tol in MMS_RUNS:
        _mms_phase(label, argv, os.path.join(here, counts_log),
                   os.path.join(here, orders_log), div_tol)
        torch.cuda.empty_cache()

    # 15. the DFG cylinder through the driver
    from alfi_torch.problems import DfgBenchmarkProblem

    dfg_args = parser.parse_args(DFG_ARGV)
    dfg = timed("DFG", lambda: get_solver(
        dfg_args, DfgBenchmarkProblem(n=DFG_N), device=dev))
    per_table = _driver_sweep("DFG", dfg, dfg_args, DFG_JAX, tuple(DFG_JAX),
                              DFG_DOFS)
    launched.update((k, v) for k, v in per_table.items() if v)
    del dfg
    torch.cuda.empty_cache()

    # 16. the multiplicative sweeps: the colour tables on the main path
    for label, solver, expected in (("multiplicative", mult, MULT_JAX),
                                    ("multiplicative 3D", mult3d,
                                     MULT3D_JAX)):
        kernels.reset_launch_counts()
        rows, total = _solve_sweep(solver, BENCH_RES)
        launches = _launches()
        counts = [(r[1], r[2]) for r in rows]
        krylov = sum(k for k, _ in counts)
        print("%s: %d dofs, Re 1->10->100 in %.3f s, counts %s (JAX CPU "
              "%s); kernel launches %s: K1 %.1f and KM %.1f per Krylov "
              "iteration" % (label, solver.Z.dim, total, counts, expected,
                             launches, launches["K1"] / krylov,
                             launches["KM"] / krylov), flush=True)
        if counts != expected:
            raise AssertionError("%s counts %s != the JAX package's %s"
                                 % (label, counts, expected))
        if launches["K1"] <= 0:
            raise AssertionError("%s: no colour table launched" % label)
        _check_levels(label, solver, launches)
        launched.update((k, v) for k, v in _table_launches().items() if v)
    _profile_linear_step(mult)
    del mult, mult3d, solver
    torch.cuda.empty_cache()

    # 17. the grad-div study at the reference's 2D widths, and its patch +
    # transfer row with the smoother stored in f32
    for label, argv, log in GRADDIV_RUNS:
        _graddiv_phase(label, argv, os.path.join(here, log))
        torch.cuda.empty_cache()
    graddiv_launches = _graddiv_f32_row(gd32,
                                        os.path.join(here, GRADDIV_F32_LOG))
    del gd32
    torch.cuda.empty_cache()

    # 18. the algebraic baselines, small and at the bench config
    launched.update((k, v) for k, v in _baseline_phase(
        make, alamg_bench, bench_rows).items() if v)
    del alamg_bench
    torch.cuda.empty_cache()

    # 19. the adjoint and visprolong at the bench config
    _adjoint_phase(make, parser)
    torch.cuda.empty_cache()

    # 20. the precision modes at the bench config and the 3D scale row
    precision_launches = _precision_phase(
        make, lambda: get_solver(scale_args, ThreeDimLidDrivenCavityProblem(
            scale_args.baseN), device=dev), here)
    precision_launches.update(graddiv_launches)
    torch.cuda.empty_cache()

    sources = {"K1": os.path.relpath(kernels.SOURCE, here),
               "KM": os.path.relpath(kernels.LEVEL_SOURCE, here),
               "KL": os.path.relpath(kernels.LU_SOURCE, here)}
    sources["KA"] = sources["KG"] = sources["KM"]
    entries = []
    for r in table:
        if r["op"] is None:
            continue  # not the variant the main path calls
        use = (r["kernel"] if r["kernel"] in ("KM", "KA", "KG")
               else r["op"].use)
        n_launch = launched.get((id(r["op"]), use), 0)
        if n_launch <= 0:
            raise AssertionError("%s: the main path never launched this "
                                 "table's kernel" % r["name"])
        if use == "K1":
            name = "gather_gemv_scatter %s kernel (%s, %d x %d, %s)" % (
                r["kernel"], r["name"], r["shape"][0], r["shape"][1],
                "masked" if r["masked"] else "bare")
        elif use == "KG":
            g = r["op"]
            name = ("level_operator assembly over the AMG Galerkin map (%s, "
                    "%d sources -> %d dense entries)" % (r["name"], g.nsrc,
                                                          g.nvals))
        else:
            p = r["op"].pattern
            name = "level_operator %s (%s, %d blocks of %dx%d)" % (
                {"KM": "apply", "KA": "assembly"}[use], r["name"], p.nnzb,
                p.d, p.d)
        entries.append({
            "name": name, "route": "cuda", "source": sources[use],
            "replaces": REPLACES[use],
            "launches": n_launch,
            "max_abs_err": max(t["abs_err"] for t in table
                               if t["name"] == r["name"]),
            "ms": r["dev_ms"], "plain_ms": r["plain_dev_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_dev_ms"]})
    # the precision kernels' rows, each with phase 20's launches of its
    # table in its mode (0 for the Scott-Vogelius shapes, which phase 20
    # does not run)
    for r in precision_rows:
        use = r["kernel"].split()[0]  # K1, KL, KM, KM+KB or KB
        if use == "K1":
            name = "gather_gemv_scatter f32 %s kernel (%s)" % (
                r["kernel_path"], r["name"])
        elif use == "KL":
            name = "patch_lu_solve, the f32 LU solve (%s)" % r["name"]
        elif use == "KB":
            name = "level_operator gamma-split grad-div term (%s)" % r["name"]
        elif use == "KM+KB":
            name = ("level_operator apply with the grad-div term as its "
                    "epilogue (%s)" % r["name"])
        else:
            name = "level_operator apply, mixed precision (%s)" % r["name"]
        entries.append({
            "name": name, "route": "cuda",
            "source": sources["K1" if use == "K1"
                              else "KL" if use == "KL" else "KM"],
            "replaces": REPLACES["KB" if use == "KM+KB" else use],
            "launches": precision_launches.get(r["key"], 0),
            "max_abs_err": r["abs_err"], "ms": r["dev_ms"],
            "plain_ms": r["plain_dev_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_dev_ms"]})
    for kernel in KERNEL_OF_PATH.values():
        if not any(" %s kernel " % kernel in e["name"] for e in entries):
            raise AssertionError("the main path launched no table through "
                                 "the %s kernel" % kernel)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--kernels-only"]):
        raise SystemExit(__doc__)
    main(kernels_only=bool(sys.argv[1:]))
