"""aosx_torch: the PyTorch/CUDA port of the aosx orchard exploration engine.

The perceive -> GVD -> plan -> control loop of ``aosx`` on tensors with an
explicit device, with the same module layout, function names and padded
shapes. Imports torch and numpy, never jax. On a CUDA device the jump-flood
passes and the Zhang-Suen thinning run through hand-written CUDA kernels
(``csrc/``), built with nvcc at first use.
"""

from .config import AosParams, Statics, TEST_STATICS, BENCH_STATICS
from .types import (
    ControlState,
    GridWorld,
    GvdGraph,
    MissionState,
    Path,
    PointCloud,
    Polygon,
    SeedSet,
    TreeRows,
    Waypoints,
)

__version__ = "0.1.0"
