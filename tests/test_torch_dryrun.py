"""The twin of tests/test_parallel.py::test_dryrun_multichip_8: the port's
``alfi_torch.parallel.dryrun.dryrun_multichip(8)`` runs one distributed
SUPG-stabilised Re=1000 Newton step (ldc2d [P2]^2-P0, baseN=4, nref=1) on
eight spawned gloo ranks on the CPU, within its own time limit, and
prints its ok line; the ranks agree bit for bit, and the step takes the
single-device step's FGMRES count and state (u, p within
``dryrun.DRYRUN_TOL``)."""

import numpy as np
import torch

from alfi_torch.parallel.dryrun import (
    DRYRUN_TOL,
    dryrun_multichip,
    dryrun_reference,
)


def test_dryrun_multichip_8(capsys):
    torch.set_num_threads(1)
    res = dryrun_multichip(8, device="cpu", timeout=420)
    out = capsys.readouterr().out
    assert "on a 8-rank group ok" in out
    assert len(res) == 8
    state, its = dryrun_reference("cpu")
    assert res[0]["its"] == its
    for a, b, tol in zip(res[0]["state"], state, DRYRUN_TOL):
        assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b)
