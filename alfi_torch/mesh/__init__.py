from .core import Mesh
from .domains import bfs2d_mesh, bfs3d_mesh, dfg2d_mesh
from .generators import (
    box_mesh,
    gmsh_read,
    rectangle_mesh,
    unit_cube_mesh,
    unit_square_mesh,
)
from .hierarchy import MeshHierarchy, mesh_hierarchy
from .refine import alfeld, refine_uniform
