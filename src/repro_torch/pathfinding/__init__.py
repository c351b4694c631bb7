"""Design-space pathfinding on torch: the encoded space, the batched and
fused evaluators, the tempering engine, the search strategies, the
Pareto archive and scalarization sweep, and the :class:`Pathfinder`
facade (counterparts of :mod:`repro.pathfinding`)."""
from repro_torch.pathfinding.batch import (
    BatchEvaluator,
    MetricsBatch,
    evaluate_batch,
    fit_normalizer_batched,
    get_evaluator,
)
from repro_torch.pathfinding.device import (
    DeviceEvaluator,
    DevicePTResult,
    get_device_evaluator,
    propose_batch,
)
from repro_torch.pathfinding.pareto import (
    FrontierFeed,
    ParetoArchive,
    ScalarizationSweep,
    crowding_distance,
    directions_to_weights,
    hypervolume,
    non_dominated_mask,
    non_dominated_mask_torch,
    simplex_directions,
)
from repro_torch.pathfinding.pathfinder import OBJECTIVES, Pathfinder
from repro_torch.pathfinding.space import DesignSpace
from repro_torch.pathfinding.strategies import (
    DEFAULT_SEARCH_KEY,
    GridSweep,
    Objective,
    ParallelTempering,
    RandomSearch,
    SearchResult,
    SearchStrategy,
    SimulatedAnnealing,
)

__all__ = [
    "BatchEvaluator", "MetricsBatch", "evaluate_batch",
    "fit_normalizer_batched", "get_evaluator", "DeviceEvaluator",
    "DevicePTResult", "get_device_evaluator",
    "propose_batch", "FrontierFeed", "ParetoArchive", "ScalarizationSweep",
    "crowding_distance", "directions_to_weights", "hypervolume",
    "non_dominated_mask", "non_dominated_mask_torch", "simplex_directions",
    "OBJECTIVES", "Pathfinder", "DesignSpace", "DEFAULT_SEARCH_KEY",
    "GridSweep", "Objective", "ParallelTempering", "RandomSearch",
    "SearchResult", "SearchStrategy", "SimulatedAnnealing",
]
