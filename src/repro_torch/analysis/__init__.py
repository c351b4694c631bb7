"""Launch analysis on the card: counted work (``counting``), the
three-term roofline on the H100's constants (``roofline``), depth
extrapolation (``depth``) and the GPU carbon pathfinder
(``gpu_pathfinder``); the JAX package's ``repro.analysis`` names."""
from repro_torch.analysis.counting import COLLECTIVE_KINDS, collective_bytes

__all__ = ["collective_bytes", "COLLECTIVE_KINDS"]
