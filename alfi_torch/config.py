"""Global configuration for alfi_torch.

The port computes in float64 throughout, like the JAX package's CPU
path: the outer Krylov/Newton tolerances (ksp_rtol=1e-9,
snes_atol=1e-8) and the gamma-conditioned patch and coarse
factorisations (kappa ~ gamma/nu * h^-2) need it, and Hopper runs f64
natively.  Every tensor is created with an explicit dtype and device;
importing this module changes no global torch state.
"""

import numpy as np
import torch

#: dtype of every floating-point tensor the port creates.
real_dtype = torch.float64

#: host-side index dtype of the topology tables (numpy).
index_dtype = np.int32
