"""alfi_torch — the PyTorch/CUDA port of alfi_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``alfi_tpu``: the host-side
topology layer (meshes, dof numbering, patches, transfer tables) is a
numpy copy of the reference's, the device code is eager PyTorch, and the
hot applies of the multigrid cycle run hand-written CUDA kernels
(``alfi_torch/kernels.py``, ``alfi_torch/csrc/``).  It never imports
jax.  Every solver takes an explicit ``device``.
"""

from . import config  # noqa: F401

__version__ = "0.1.0"

from .fem.bcs import BCSet, DirichletBC  # noqa: E402
from .mesh.hierarchy import MeshHierarchy, mesh_hierarchy  # noqa: E402
from .mg.patches import star_patches  # noqa: E402
from .mg.schoeberl import SchoeberlTransfer  # noqa: E402
from .problem import NavierStokesProblem  # noqa: E402
from .solver import ConstantPressureSolver, NavierStokesSolver  # noqa: E402
