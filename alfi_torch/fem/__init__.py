from .element import (
    dg_lagrange,
    facet_bubble,
    lagrange,
    pk_facet_bubble,
)
from .bcs import BCSet
from .dirichlet import DirichletBC
from .geometry import CellGeometry
from .nsforms import NSForm, Tabulation
from .quadrature import facet_quadrature, simplex_quadrature
from .spaces import FunctionSpace, MixedFunctionSpace, VectorFunctionSpace
