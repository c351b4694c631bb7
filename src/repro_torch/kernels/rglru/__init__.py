from repro_torch.kernels.rglru.ops import (
    build,
    launch_count,
    reset_launch_count,
    rglru,
)
from repro_torch.kernels.rglru.ref import rglru_assoc_plain, rglru_plain

__all__ = ["build", "launch_count", "reset_launch_count", "rglru",
           "rglru_plain", "rglru_assoc_plain"]
