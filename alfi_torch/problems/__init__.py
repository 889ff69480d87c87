from .bfs import (
    ThreeDimBackwardsFacingStepProblem,
    TwoDimBackwardsFacingStepProblem,
)
from .dfg import DfgBenchmarkProblem
from .ldc import (
    ThreeDimLidDrivenCavityProblem,
    TwoDimLidDrivenCavityProblem,
)
from .mms import (
    ThreeDimLidDrivenCavityMMSProblem,
    TwoDimLidDrivenCavityMMSProblem,
)
