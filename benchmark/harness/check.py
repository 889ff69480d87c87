"""What decides ``correct``: every state that a timed Reynolds step
returned is judged by the configuration's plain reference, once the
window has closed and the program's state is freed.

The reference assembles the discrete Navier-Stokes residual of the state
at its Reynolds number from the mesh alone (``reference/<module>.py``),
with the Dirichlet rows read as u - g.  The numbers compared, each with
its limit from the configuration's ``check`` entry:

* ``residual_max``: the largest residual norm over the judged states;
* ``steps_unjudged``: timed steps whose state could not be judged (limit
  0): a mesh that fails the reference's check of the box, or nodes that do
  not match the reference's (``answers.StateReader``: velocity dofs by
  point, pressure dofs by their owning cell and point, so that a
  discontinuous pressure is read as well as a cellwise constant one).
"""

from __future__ import annotations

import sys

from . import answers, registry


class Judge:
    """The configuration's reference on the program's mesh, after its check
    of the mesh against the configuration's box and lattice, with the
    reader of the program's states; ``error`` says why there is none.
    ``nodes``: the program's velocity and pressure dof coordinates and its
    pressure cell-to-dof map, as ``cell.build`` returns them."""

    def __init__(self, config, mesh, nodes, device):
        spec = config["reference"]
        self.error = None
        try:
            mod = registry.reference(spec["module"])
            extent, n = float(spec["extent"]), int(spec["cells_per_side"])
            mod.check_mesh(mesh[0], mesh[1], extent, n)
            self.ref = mod.Reference(mesh[0], mesh[1], spec, device=device)
            self.read = answers.StateReader(self.ref, mesh, nodes,
                                            extent / n)
        except ValueError as exc:
            self.error = str(exc)

    def residuals(self, steps):
        """The residual norm of each step (re, u, p)."""
        return [self.ref.residual_norm(*self.read(u.numpy(), p.numpy()), re)
                for re, u, p in steps]


def judge(config, mesh, nodes, steps, device="cpu"):
    """``steps``: [(re, u, p)] as the program returned them.  Returns
    (correct, numbers, per-step residuals)."""
    j = Judge(config, mesh, nodes, device)
    if j.error is not None:
        print("check: the states cannot be read: %s" % j.error,
              file=sys.stderr)
        residuals, unjudged = [], len(steps)
    else:
        residuals, unjudged = j.residuals(steps), 0
    worst = max(residuals) if residuals else None
    numbers = {
        "residual_max": {"value": worst,
                         "limit": float(config["check"]["residual_max"])},
        "steps_unjudged": {"value": unjudged, "limit": 0},
    }
    correct = (worst is not None
               and worst <= numbers["residual_max"]["limit"]
               and unjudged == 0)
    return correct, numbers, residuals


def print_numbers(numbers):
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for name, v in numbers.items():
        print("check %s %r limit %r" % (name, v["value"], v["limit"]),
              file=sys.stderr, flush=True)
