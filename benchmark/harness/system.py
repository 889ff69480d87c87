"""The system under test: an alfi_torch solver built by the program's own
``get_solver`` from a configuration's flags, and the one call the window drives,
``NavierStokesSolver.solve(re)`` from the state the sweep left.

Nothing here computes; it builds, resets and calls the program, and copies
each returned state to the host for the check after the window."""

from __future__ import annotations

import importlib


def _problem(config):
    """The configuration's problem object, by ``problem.class`` (a class of
    ``alfi_torch.problems``) and ``problem.args``."""
    spec = config["problem"]
    problems = importlib.import_module("alfi_torch.problems")
    return getattr(problems, spec["class"])(**spec.get("args", {}))


class System:
    """One solver of ``config`` on ``device`` (a torch device name)."""

    def __init__(self, config, device):
        from alfi_torch.driver import get_default_parser, get_solver

        args = get_default_parser().parse_args(config["flags"])
        self.solver = get_solver(args, _problem(config), device=device)
        # the per-iteration prints of the Newton loop go nowhere: the
        # result line is the last line of standard output
        self.solver.verbose = False
        s = self.solver
        #: the state every sweep starts from: the Dirichlet data, zero
        #: elsewhere (the solver's own initial state)
        self._rest = tuple(x.clone() for x in s.bcset.apply(
            s.Z.zero(s.device)))

    def mesh(self):
        """(vertices (nv, d), cells (nc, d + 1)) of the finest mesh, the
        one the state lives on."""
        m = self.solver.mesh
        return m.vertices.copy(), m.cells.copy()

    def node_coords(self):
        """(velocity dof coordinates, pressure dof coordinates) in the
        program's numbering: how its states are read."""
        Z = self.solver.Z
        return Z.V.dof_coords.copy(), Z.Q.dof_coords.copy()

    def pressure_cell_dofs(self):
        """The pressure's cell-to-dof map (nc, dofs per cell), rows in the
        cells' order of :meth:`mesh`: which cell owns each pressure dof."""
        return self.solver.Z.Q.cell_dofs.copy()

    def rest(self):
        s = self.solver
        s.z = tuple(x.clone() for x in self._rest)
        s.z_last = s.z

    def solve(self, re):
        """Solve at ``re`` from the current state: (u, p) on the host and
        the program's info_dict."""
        z, info = self.solver.solve(re)
        return z[0].detach().cpu(), z[1].detach().cpu(), info

    def events(self):
        """The program's event registry (host-timed, synchronising)."""
        from alfi_torch.utils.events import EVENTS

        return EVENTS

    def close(self):
        """Drop the solver and everything it holds on the device."""
        self.solver = None
        self._rest = None
