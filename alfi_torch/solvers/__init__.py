from .fieldsplit import SchurPC, pressure_nullspace_projector
from .krylov import fgmres
from .newton import newton
