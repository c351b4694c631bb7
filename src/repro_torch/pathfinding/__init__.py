"""Design-space pathfinding on torch: the encoded space, the batched and
fused evaluators, the tempering engine, the stacked scenario engine, the
search strategies, the Pareto archive, the scalarization and scenario
sweeps, checkpoint/resume of the device searches, and the
:class:`Pathfinder` facade (counterparts of :mod:`repro.pathfinding`)."""
from repro_torch.pathfinding.batch import (
    BatchEvaluator,
    MetricsBatch,
    evaluate_batch,
    fit_normalizer_batched,
    fit_region_normalizers,
    get_evaluator,
)
from repro_torch.pathfinding.device import (
    DeviceEvaluator,
    DevicePTResult,
    ScenarioEngine,
    ScenarioPTResult,
    evaluate_batch_device,
    get_device_evaluator,
    get_scenario_engine,
    propose_batch,
)
from repro_torch.pathfinding.pareto import (
    FrontierFeed,
    REGION_INTENSITIES,
    ParetoArchive,
    ScalarizationSweep,
    Scenario,
    ScenarioFrontier,
    ScenarioSweep,
    crowding_distance,
    directions_to_weights,
    fold_cell_key,
    fold_job_key,
    hypervolume,
    non_dominated_mask,
    non_dominated_mask_torch,
    simplex_directions,
    workloads_from_configs,
)
from repro_torch.pathfinding.pathfinder import OBJECTIVES, Pathfinder
from repro_torch.pathfinding.resume import (
    SearchCheckpointer,
    run_segmented,
    search_fingerprint,
    segment_fingerprint,
)
from repro_torch.pathfinding.scenario import ScenarioSpec
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
    "fit_normalizer_batched", "fit_region_normalizers", "get_evaluator",
    "DeviceEvaluator", "DevicePTResult", "ScenarioEngine",
    "ScenarioPTResult", "evaluate_batch_device", "get_device_evaluator",
    "get_scenario_engine",
    "propose_batch", "FrontierFeed", "ParetoArchive", "ScalarizationSweep",
    "REGION_INTENSITIES", "Scenario", "ScenarioFrontier", "ScenarioSpec",
    "ScenarioSweep", "fold_cell_key", "fold_job_key",
    "workloads_from_configs", "SearchCheckpointer", "run_segmented",
    "search_fingerprint", "segment_fingerprint",
    "crowding_distance", "directions_to_weights", "hypervolume",
    "non_dominated_mask", "non_dominated_mask_torch", "simplex_directions",
    "OBJECTIVES", "Pathfinder", "DesignSpace", "DEFAULT_SEARCH_KEY",
    "GridSweep", "Objective", "ParallelTempering", "RandomSearch",
    "SearchResult", "SearchStrategy", "SimulatedAnnealing",
]
