from repro_torch.runtime.failures import (
    FailureInjector,
    RestartStats,
    RestartSupervisor,
    SimulatedFailure,
    StragglerMonitor,
)

__all__ = [
    "FailureInjector", "RestartStats", "RestartSupervisor",
    "SimulatedFailure", "StragglerMonitor",
]
