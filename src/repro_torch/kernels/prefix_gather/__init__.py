from repro_torch.kernels.prefix_gather.ops import (
    build,
    launch_count,
    prefix_select,
    reset_launch_count,
)
from repro_torch.kernels.prefix_gather.ref import prefix_select_plain

__all__ = ["build", "launch_count", "prefix_select", "prefix_select_plain",
           "reset_launch_count"]
