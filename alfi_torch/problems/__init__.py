from .ldc import TwoDimLidDrivenCavityProblem
