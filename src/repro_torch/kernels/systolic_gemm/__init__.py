from repro_torch.kernels.systolic_gemm.ops import (
    build,
    is_gemm_partials,
    launch_count,
    os_gemm,
    os_gemm_splitk,
    reset_launch_count,
    systolic_gemm,
    ws_gemm_partials,
)
from repro_torch.kernels.systolic_gemm.ref import (
    gemm_plain,
    is_gemm_partials_plain,
    os_gemm_plain,
    os_gemm_splitk_plain,
    ws_gemm_partials_plain,
)

__all__ = ["build", "gemm_plain", "is_gemm_partials",
           "is_gemm_partials_plain", "launch_count",
           "os_gemm", "os_gemm_plain", "os_gemm_splitk",
           "os_gemm_splitk_plain", "reset_launch_count", "systolic_gemm",
           "ws_gemm_partials", "ws_gemm_partials_plain"]
