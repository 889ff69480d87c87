"""The plain reference against the program on the CPU: at a random state
the reference's residual is the program's, row for row, on both cells'
discretisations ([P2]^2-P0, and [P1+FB]^3-P0 with SUPG) and on [P2]^2-P0
with SUPG; the mesh check refuses a mesh that is not the box's; the state
reader matches nodes by coordinates."""

import numpy as np
import pytest
import torch

from benchmark.harness import answers, check, registry
from benchmark.harness.system import System
from conftest import small_3d_config, small_config


def _small_2d_supg():
    """The 2D cell's discretisation with SUPG (weight 1), which checks the
    reference's SUPG term on P2's second derivatives."""
    cfg = small_config()
    cfg["flags"] += ["--stabilisation-type", "supg",
                     "--stabilisation-weight", "1.0"]
    cfg["reference"]["supg_weight"] = 1.0
    return cfg


@pytest.mark.parametrize("make",
                         [small_config, small_3d_config, _small_2d_supg],
                         ids=["2d_p2", "3d_p1fb_supg", "2d_p2_supg"])
def test_reference_residual_is_the_programs(make):
    torch.set_num_threads(1)
    cfg = make()
    system = System(cfg, "cpu")
    s = system.solver
    vertices, cells = system.mesh()
    nodes = system.node_coords() + (system.pressure_cell_dofs(),)
    judge = check.Judge(cfg, (vertices, cells), nodes, "cpu")
    assert judge.error is None
    ref, read = judge.ref, judge.read
    g = torch.Generator().manual_seed(7)
    d = vertices.shape[1]
    z = s.bcset.apply((
        torch.randn(s.Z.V.ndof, d, generator=g, dtype=torch.float64),
        torch.randn(s.Z.Q.ndof, generator=g, dtype=torch.float64)))
    free = np.ones(ref.nnodes, bool)
    free[ref.bc_nodes] = False
    for re in (1.0, 321.5):
        s.nu_val, s.advect_val = 2.0 / re, 1.0
        Rv, Rq = (x.numpy() for x in s.residual_masked(z, s.params()))
        Fv, Fq = ref.residual(*read(z[0].numpy(), z[1].numpy()), re)
        Rv, Rq = read(Rv, Rq)
        scale = np.abs(Rv).max()
        assert np.abs(Fv.numpy()[free] - Rv[free]).max() < 1e-13 * scale
        assert np.abs(Fq.numpy() - Rq).max() < 1e-13 * np.abs(Rq).max()
        # the Dirichlet rows read u - g: the state holds the data
        assert np.abs(Fv.numpy()[~free]).max() < 1e-14


def test_mesh_check_refuses_other_meshes():
    ref = registry.reference("ns_pkp0")
    system = System(small_config(), "cpu")
    vertices, cells = system.mesh()
    ref.check_mesh(vertices, cells, 2.0, 8)
    with pytest.raises(ValueError):
        ref.check_mesh(vertices, cells, 2.0, 16)  # not the lattice
    with pytest.raises(ValueError):
        ref.check_mesh(vertices, cells[1:], 2.0, 8)  # a hole
    moved = vertices.copy()
    moved[np.argmax((vertices == 1.0).all(1))] += 0.01
    with pytest.raises(ValueError):
        ref.check_mesh(moved, cells, 2.0, 8)


def test_state_reader_matches_by_coordinates():
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 50, size=(40, 3)) * 0.25
    pts = np.unique(pts, axis=0)
    perm = rng.permutation(len(pts))
    p = answers.match(pts[perm], pts, 0.25)
    assert np.array_equal(pts[perm][p], pts)
    with pytest.raises(ValueError):
        answers.match(pts[perm] + 0.1, pts, 0.25)
    with pytest.raises(ValueError):
        answers.match(pts[1:], pts[:-1], 0.25)
