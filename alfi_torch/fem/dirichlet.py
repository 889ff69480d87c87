"""Dirichlet boundary conditions, resolved on the host (numpy only).

Split out of ``fem/bcs.py`` so that problem definitions can build their
BCs without any tensor code; :class:`alfi_torch.fem.bcs.BCSet` compiles
them into device masks.
"""

from __future__ import annotations

import numpy as np


class DirichletBC:
    """value on the closure of tagged boundary facets of one (sub)space.

    Parameters
    ----------
    space : FunctionSpace | VectorFunctionSpace
    value : constant scalar / length-d sequence, or callable
        ``value(x)`` mapping dof coordinates ``(n, d)`` to nodal values
        (``(n,)`` scalar space, ``(n, d)`` vector space).  Nodal
        interpolation matches Firedrake's DirichletBC on nodal elements.
    tags : int | sequence[int] | None
        boundary markers; None = the whole exterior boundary.
    nodes : optional explicit dof indices (overrides tags) — the analogue
        of the pressure-pinning trick in alfi/solver.py:184-189.
    """

    def __init__(self, space, value, tags=None, nodes=None):
        self.space = space
        self.value = value
        self.tags = tags
        if nodes is not None:
            self.dofs = np.asarray(nodes, dtype=np.int64)
        else:
            self.dofs = np.asarray(space.boundary_dofs(tags), dtype=np.int64)

    def nodal_values(self):
        x = self.space.dof_coords[self.dofs]
        vec = getattr(self.space, "value_size", None)
        if callable(self.value):
            vals = np.asarray(self.value(x), dtype=np.float64)
        else:
            vals = np.broadcast_to(
                np.asarray(self.value, dtype=np.float64),
                (len(self.dofs), vec) if vec else (len(self.dofs),),
            )
        return vals
