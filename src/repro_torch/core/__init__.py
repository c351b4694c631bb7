"""CarbonPATH core models, copied from the reference package.

The modules here are the framework-free paper models (technology
database, chiplets, workloads, Algorithm 1, the floorplan/D2D/cost/carbon
models, the scalar evaluator, the ChipletGym baseline and the
simulated-annealing moves with its ``anneal`` shim) that the torch search
engine needs. They are kept as copies so that the port imports nothing
of the JAX package.
"""
from repro_torch.core.chiplet import (
    Chiplet,
    different_chiplet_system,
    identical_chiplet_system,
    library,
)
from repro_torch.core.chipletgym import evaluate_chipletgym
from repro_torch.core.evaluate import Metrics, evaluate
from repro_torch.core.sa import (
    SAConfig,
    SAResult,
    anneal,
    fit_normalizer,
    random_system,
)
from repro_torch.core.scalesim import SimCache
from repro_torch.core.system import HISystem, InvalidSystem, is_valid, validate
from repro_torch.core.techdb import DEFAULT_DB, TechDB, all_pkg_protocol_pairs
from repro_torch.core.templates import TEMPLATES, Normalizer, Template, sa_cost
from repro_torch.core.workload import (
    ALL_MAPPINGS,
    GEMMWorkload,
    Mapping,
    WORKLOADS,
    tile_and_assign,
    workload,
)

__all__ = [
    "Chiplet", "library", "identical_chiplet_system", "different_chiplet_system",
    "evaluate_chipletgym", "Metrics", "evaluate", "SAConfig", "SAResult",
    "anneal", "fit_normalizer",
    "random_system", "SimCache", "HISystem", "InvalidSystem", "is_valid",
    "validate", "DEFAULT_DB", "TechDB", "all_pkg_protocol_pairs", "TEMPLATES",
    "Normalizer", "Template", "sa_cost", "ALL_MAPPINGS", "GEMMWorkload",
    "Mapping", "WORKLOADS", "tile_and_assign", "workload",
]
