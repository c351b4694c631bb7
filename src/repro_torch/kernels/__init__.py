"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
torch version. A wrapper launches its kernel for CUDA tensors and uses
the plain version only for tensors that lie on the CPU.

  systolic_gemm  — tiled GEMM with the paper's mapping knobs (dataflow
                   OS/WS/IS, split-K, tile shape).
  wkv6           — RWKV-6 data-dependent-decay recurrence.
  rglru          — RecurrentGemma gated linear recurrence.
  prefix_gather  — prefix-table gathers with per-slot segment reduction:
                   ``prefix_select`` (the search's fused stage) and
                   ``prefix_segment_gather`` (one table).
"""
from repro_torch.kernels.prefix_gather import (
    prefix_segment_gather,
    prefix_segment_plain,
    prefix_select,
    prefix_select_plain,
)
from repro_torch.kernels.rglru import rglru, rglru_assoc_plain, rglru_plain
from repro_torch.kernels.systolic_gemm import gemm_plain, systolic_gemm
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain

__all__ = [
    "systolic_gemm", "gemm_plain",
    "wkv6", "wkv6_plain",
    "rglru", "rglru_plain", "rglru_assoc_plain",
    "prefix_segment_gather", "prefix_segment_plain",
    "prefix_select", "prefix_select_plain",
]
