# The plain version reads the encoding of repro_torch.pathfinding, whose
# evaluator calls this package: importing that package first lets either
# one be imported first.
import repro_torch.pathfinding  # noqa: F401
from repro_torch.kernels.topology.ops import (
    build,
    launch_count,
    reset_launch_count,
    topology,
)
from repro_torch.kernels.topology.ref import bonding, topology_plain

__all__ = ["bonding", "build", "launch_count", "reset_launch_count",
           "topology", "topology_plain"]
