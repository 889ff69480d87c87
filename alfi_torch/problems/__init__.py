from .bfs import (
    ThreeDimBackwardsFacingStepProblem,
    TwoDimBackwardsFacingStepProblem,
)
from .ldc import (
    ThreeDimLidDrivenCavityProblem,
    TwoDimLidDrivenCavityProblem,
)
