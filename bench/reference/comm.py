"""Pluggable communication models: legacy pairwise links vs mesh-NoC + NoI.

The package-level communication model used to live in three bit-pinned
copies (scalar ``core/d2d.py``, host-batched ``pathfinding/batch.py``,
fused-device ``pathfinding/device.py``). This module is the single seam
all three share:

* ``legacy`` — the original pairwise-link model: traffic crosses the
  package interconnect only; on-chiplet distribution is free. The
  bit-pinned default; every golden was recorded under it.
* ``mesh_noc`` — each chiplet carries an on-die mesh NoC (dims a new
  design axis) whose traffic funnels through one interposer-NoI entry
  router (placement a new design axis). Per-bit NoC hop counts are
  **closed-form Manhattan index arithmetic** — no graph library, no BFS —
  so the model vectorizes into the fused jit program as pure elementwise
  math over the ``[P, C]`` slot layout.

Mesh hop model. A chiplet's PEs are tiles of an ``mx x my`` mesh; the
NoI entry router sits at integer coordinates ``(ex, ey)``. Traffic is
uniformly sourced across tiles, and XY routing makes the expected hop
count to the entry separable per axis:

    D(m, e) = (sum_{x<=e} (e-x) + sum_{x>e} (x-e)) / m
            = (e(e+1)/2 + (m-1-e)(m-e)/2) / m

    noc_hops(mx, my, ex, ey) = D(mx, ex) + D(my, ey)

Every bit leaving (entering) a chiplet pays its source's (destination's)
mean NoC hop count in router latency (``TechDB.noc_hop_latency_s``) and
router energy (``TechDB.noc_energy_pj_bit``), on top of the unchanged
package-level link model. Embodied router carbon scales with the
physical router count ``mx * my`` per chiplet (ECO-CHIP's ``router_c``
generalized from a flat area fraction), and operational router carbon
rides the traffic-proportional NoC energy term.

Neutrality. ``MESH_DIMS[0] == (1, 1)`` is the exact neutral element:
one tile, zero hops, one router. Every mesh-model term then reduces to
``x + 0.0`` / ``x * 1.0`` — bit-identical to legacy — which is what lets
the forced-on CI lane (``REPRO_COMM_MODEL=mesh_noc``) replay all legacy
goldens through the mesh program.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

COMM_MODELS: Tuple[str, ...] = ("legacy", "mesh_noc")
DEFAULT_COMM = "legacy"
# Forces default-constructed DesignSpaces onto the mesh_noc encoding with
# the NoC axes *frozen at neutral* — the CI lane proving the mesh program
# is bit-invisible. Explicit ``DesignSpace(comm="mesh_noc")`` makes the
# axes live instead.
COMM_ENV_VAR = "REPRO_COMM_MODEL"

# Searchable mesh dimensions per chiplet. Index 0 is the neutral element
# (single tile: zero hops, one router) — the bit-exact legacy limit.
MESH_DIMS: Tuple[Tuple[int, int], ...] = (
    (1, 1), (2, 2), (4, 2), (4, 4), (8, 4), (8, 8))
# NoI entry-router placements within the mesh.
ENTRY_PLACEMENTS: Tuple[str, ...] = ("corner", "edge", "center")
NOC_NEUTRAL: Tuple[int, int] = (0, 0)


def resolve_comm(comm: Optional[str] = None) -> str:
    """Resolve a comm-model name; ``None`` consults ``REPRO_COMM_MODEL``."""
    if comm is None:
        comm = DEFAULT_COMM
    if comm not in COMM_MODELS:
        raise ValueError(
            f"unknown comm model {comm!r}; expected one of {COMM_MODELS}")
    return comm


def entry_coords(mx: int, my: int, placement: int) -> Tuple[int, int]:
    """Integer mesh coordinates of the NoI entry router."""
    if placement == 0:                       # corner
        return 0, 0
    if placement == 1:                       # middle of the bottom edge
        return (mx - 1) // 2, 0
    if placement == 2:                       # mesh center
        return (mx - 1) // 2, (my - 1) // 2
    raise ValueError(f"entry placement {placement} outside "
                     f"[0, {len(ENTRY_PLACEMENTS)})")


def axis_mean_hops(m: int, e: int) -> float:
    """Closed-form mean ``|x - e|`` over ``x in [0, m)`` (one mesh axis)."""
    return (e * (e + 1) // 2 + (m - 1 - e) * (m - e) // 2) / m


def mesh_mean_hops(mx: int, my: int, ex: int, ey: int) -> float:
    """Mean XY-routed hop count from a uniform tile to the entry router."""
    return axis_mean_hops(mx, ex) + axis_mean_hops(my, ey)


def noc_hop_count(mesh_idx: int, entry_idx: int) -> float:
    """Mean NoC hops for one chiplet's ``(mesh dims, entry placement)``."""
    mx, my = MESH_DIMS[mesh_idx]
    ex, ey = entry_coords(mx, my, entry_idx)
    return mesh_mean_hops(mx, my, ex, ey)


def n_routers(mesh_idx: int) -> int:
    """Physical router count of the mesh — the embodied-carbon multiplier."""
    mx, my = MESH_DIMS[mesh_idx]
    return mx * my


_TABLES: Optional[Tuple[np.ndarray, np.ndarray]] = None


def noc_tables() -> Tuple[np.ndarray, np.ndarray]:
    """``(hops[Mi, Ei] float64, routers[Mi] float64)`` lookup tables.

    The vectorized engines gather these by the encoded per-slot
    ``(mesh_idx, entry_idx)`` columns — the axes stay runtime data, the
    tables are trace-time constants shared by every mesh program.
    """
    global _TABLES
    if _TABLES is None:
        hops = np.array(
            [[noc_hop_count(mi, ei) for ei in range(len(ENTRY_PLACEMENTS))]
             for mi in range(len(MESH_DIMS))], dtype=np.float64)
        routers = np.array([float(n_routers(mi))
                            for mi in range(len(MESH_DIMS))],
                           dtype=np.float64)
        _TABLES = (hops, routers)
    return _TABLES


# ---------------------------------------------------------------------------
# The scalar CommModel seam (core/evaluate consumes it through d2d/carbon)
# ---------------------------------------------------------------------------


def system_noc_hops(sys) -> Tuple[float, ...]:
    """Per-chiplet mean NoC hop counts; all-zero for legacy systems."""
    if not getattr(sys, "noc", ()):
        return (0.0,) * sys.n_chiplets
    return tuple(noc_hop_count(mi, ei) for mi, ei in sys.noc)


def system_n_routers(sys) -> Tuple[int, ...]:
    """Per-chiplet physical router counts; all-one for legacy systems."""
    if not getattr(sys, "noc", ()):
        return (1,) * sys.n_chiplets
    return tuple(n_routers(mi) for mi, ei in sys.noc)


def validate_noc(noc: Sequence[Tuple[int, int]], n_chiplets: int) -> None:
    """Raise ``ValueError`` unless ``noc`` is a well-formed per-chiplet
    ``(mesh_idx, entry_idx)`` assignment."""
    if len(noc) != n_chiplets:
        raise ValueError(
            f"noc carries {len(noc)} entries for {n_chiplets} chiplets")
    for mi, ei in noc:
        if not 0 <= mi < len(MESH_DIMS):
            raise ValueError(f"mesh index {mi} outside "
                             f"[0, {len(MESH_DIMS)})")
        if not 0 <= ei < len(ENTRY_PLACEMENTS):
            raise ValueError(f"entry placement {ei} outside "
                             f"[0, {len(ENTRY_PLACEMENTS)})")
