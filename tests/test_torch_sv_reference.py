"""The Scott-Vogelius cell's plain reference (``benchmark/reference/ns_sv.py``)
against the port on the CPU, through the harness's state reader
(``benchmark/harness/answers.py``): alfi's iters2dsv row ([P2]^2-P1disc on
barycentric meshes, macrostar patches, Burman's stabilisation at the
default weight) cut to ldc2d baseN 2 and 4, nref 1.

On seeded random states the reference's residual is the port's row for
row, Burman's facet term included and compared on its own; the state
rounded to float32 is not; a converged small solve is judged correct;
the mesh check refuses a mesh that is not the barycentric cavity mesh."""

import copy

import numpy as np
import pytest
import torch

from benchmark.harness import check, registry
from benchmark.harness.system import System

#: the two assemble the same exact integrals (every cell term is a
#: polynomial the rules integrate exactly; beta_F by one 3-point rule on
#: both sides) in different orders, so they agree to rounding, ~1e-15 of
#: the largest row; Burman's term is ~1e-5 of that row, so this holds it
#: to ~1e-7 of its own size, and it is compared on its own as well
RTOL = 1e-12


def small_sv_config(base, nref=1):
    """The configuration ``sv2d_k2`` cut to ldc2d baseN ``base``."""
    cfg = copy.deepcopy(registry.config("sv2d_k2"))
    flags = cfg["flags"]
    flags[flags.index("--baseN") + 1] = str(base)
    flags[flags.index("--nref") + 1] = str(nref)
    cfg["problem"]["args"]["baseN"] = base
    cfg["reference"]["cells_per_side"] = base * 2 ** nref
    return cfg


@pytest.fixture(scope="module", params=[2, 4], ids=["base2", "base4"])
def sv(request):
    torch.set_num_threads(1)
    cfg = small_sv_config(request.param)
    system = System(cfg, "cpu")
    mesh = system.mesh()
    nodes = system.node_coords() + (system.pressure_cell_dofs(),)
    judge = check.Judge(cfg, mesh, nodes, "cpu")
    assert judge.error is None
    s = system.solver
    g = torch.Generator().manual_seed(request.param)
    z = s.bcset.apply((
        torch.randn(s.Z.V.ndof, 2, generator=g, dtype=torch.float64),
        torch.randn(s.Z.Q.ndof, generator=g, dtype=torch.float64)))
    return {"cfg": cfg, "system": system, "mesh": mesh, "nodes": nodes,
            "judge": judge, "z": z}


def _residuals(sv, re, z_ref):
    """The port's residual of the random state and the reference's of
    ``z_ref``, both in the reference's numbering, and its free rows."""
    s, judge = sv["system"].solver, sv["judge"]
    s.nu_val, s.advect_val = 2.0 / re, 1.0
    z = sv["z"]
    Rv, Rq = judge.read(*(x.numpy() for x in s.residual_masked(
        z, s.params())))
    Fv, Fq = judge.ref.residual(*judge.read(*(x.numpy() for x in z_ref)),
                                re)
    free = np.ones(judge.ref.nnodes, bool)
    free[judge.ref.bc_nodes] = False
    return (Rv, Rq), (Fv.numpy(), Fq.numpy()), free


@pytest.mark.parametrize("re", [1.0, 321.5])
def test_reference_residual_is_the_ports(sv, re):
    (Rv, Rq), (Fv, Fq), free = _residuals(sv, re, sv["z"])
    assert np.abs(Fv[free] - Rv[free]).max() < RTOL * np.abs(Rv).max()
    assert np.abs(Fq - Rq).max() < RTOL * np.abs(Rq).max()
    # the Dirichlet rows read u - g: the state holds the data
    assert np.abs(Fv[~free]).max() < 1e-14


def test_burman_term_is_the_ports(sv):
    """Burman's facet term alone: the port's stabilisation residual
    against the reference's facet sum, to rounding of its own size."""
    s, judge = sv["system"].solver, sv["judge"]
    ref, z = judge.ref, sv["z"]
    Sv, _ = s.stabilisation.impl.residual(z, s.params())
    u, _ = judge.read(z[0].numpy(), z[1].numpy())
    u = torch.as_tensor(u)
    Bv = torch.zeros_like(u)
    for nodes, r in zip(ref.f_nodes, ref._burman(u)):
        Bv.index_add_(0, nodes.reshape(-1), r.reshape(-1, 2))
    Sv, _ = judge.read(Sv.numpy(), z[1].numpy())
    assert np.abs(Sv).max() > 0
    assert np.abs(Bv.numpy() - Sv).max() < RTOL * np.abs(Sv).max()


def test_float32_state_fails_the_comparison(sv):
    """The control: the state rounded to float32 is not the program's
    state, and the comparison sees it."""
    z32 = tuple(x.float().double() for x in sv["z"])
    (Rv, Rq), (Fv, Fq), free = _residuals(sv, 321.5, z32)
    err = max(np.abs(Fv[free] - Rv[free]).max() / np.abs(Rv).max(),
              np.abs(Fq - Rq).max() / np.abs(Rq).max())
    assert err > 1e3 * RTOL


def test_converged_small_solve_is_correct():
    torch.set_num_threads(1)
    cfg = small_sv_config(4)
    system = System(cfg, "cpu")
    steps = []
    for re in (1.0, 10.0, 100.0):
        u, p, info = system.solve(re)
        assert info["converged"]
        steps.append((re, u, p))
    nodes = system.node_coords() + (system.pressure_cell_dofs(),)
    correct, numbers, residuals = check.judge(cfg, system.mesh(), nodes,
                                              steps)
    assert correct and numbers["steps_unjudged"]["value"] == 0
    assert max(residuals) < 1e-6


def test_mesh_check_refuses_other_meshes(sv):
    ref = registry.reference("ns_sv")
    vertices, cells = sv["mesh"]
    n = sv["cfg"]["reference"]["cells_per_side"]
    ref.check_mesh(vertices, cells, 2.0, n)
    with pytest.raises(ValueError):
        ref.check_mesh(vertices, cells, 2.0, 2 * n)  # not the lattice
    with pytest.raises(ValueError):
        ref.check_mesh(vertices, cells[1:], 2.0, n)  # a hole
    # the other diagonal: the same vertices, other cells
    flipped = vertices.copy()
    flipped[:, 0] = 2.0 - flipped[:, 0]
    with pytest.raises(ValueError):
        ref.check_mesh(flipped, cells, 2.0, n)
