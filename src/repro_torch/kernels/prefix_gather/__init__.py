from repro_torch.kernels.prefix_gather.ops import (
    build,
    build_segment,
    launch_count,
    prefix_segment_gather,
    prefix_select,
    reset_launch_count,
    segment_geometry,
    segment_launch_count,
)
from repro_torch.kernels.prefix_gather.ref import (
    prefix_segment_plain,
    prefix_select_plain,
)

__all__ = ["build", "build_segment", "launch_count", "prefix_segment_gather",
           "prefix_segment_plain", "prefix_select", "prefix_select_plain",
           "reset_launch_count", "segment_geometry",
           "segment_launch_count"]
