from repro_torch.kernels.wkv6.ops import (
    build,
    launch_count,
    reset_launch_count,
    wkv6,
)
from repro_torch.kernels.wkv6.ref import wkv6_plain

__all__ = ["build", "launch_count", "reset_launch_count", "wkv6",
           "wkv6_plain"]
