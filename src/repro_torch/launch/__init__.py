"""Entry points of the port's language-model path: serving, training,
the step builders and the one-card dry-run. Importing this package
touches no device and parses no arguments (``dryrun`` runs only as the
program's entry point)."""
from repro_torch.launch.mesh import (
    axis_size,
    data_axes,
    make_host_mesh,
    make_production_mesh,
)

__all__ = ["axis_size", "data_axes", "make_host_mesh", "make_production_mesh"]
