"""Bipartitioning slicing floorplanner for 2.5D / 2.5D+3D packages.

Recursively splits the chiplet set into two area-balanced halves with
alternating vertical/horizontal cuts (Sec IV-C, after [3], [43]); the
recursion bottoms out at single chiplets, which are shaped as squares.
Outputs placed rectangles, the package bounding box (with white space),
and the adjacency graph used by the D2D topology model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Set, Tuple


@dataclasses.dataclass
class Rect:
    """A slot of the slicing tree. The slot tiles the package exactly (so
    slot adjacency == interconnect adjacency); ``die_area`` is the true
    silicon area inside the slot, the difference is white space."""

    x: float
    y: float
    w: float
    h: float
    idx: int = -1       # chiplet index; -1 for internal nodes
    die_area: float = 0.0

    @property
    def area(self) -> float:
        return self.w * self.h

    def edge_shared(self, other: "Rect", tol: float = 1e-9) -> float:
        """Length of shared boundary between two rects (0 if not adjacent)."""
        # vertical adjacency (share an x-edge)
        if abs(self.x + self.w - other.x) < tol or abs(other.x + other.w - self.x) < tol:
            lo = max(self.y, other.y)
            hi = min(self.y + self.h, other.y + other.h)
            return max(0.0, hi - lo)
        # horizontal adjacency (share a y-edge)
        if abs(self.y + self.h - other.y) < tol or abs(other.y + other.h - self.y) < tol:
            lo = max(self.x, other.x)
            hi = min(self.x + self.w, other.x + other.w)
            return max(0.0, hi - lo)
        return 0.0


@dataclasses.dataclass
class Floorplan:
    rects: List[Rect]              # one per chiplet, in input order
    width: float
    height: float

    @property
    def bbox_area(self) -> float:
        return self.width * self.height

    @property
    def die_area(self) -> float:
        return sum(r.die_area for r in self.rects)

    @property
    def white_space(self) -> float:
        return self.bbox_area - self.die_area

    def adjacency(self) -> Dict[int, Set[int]]:
        adj: Dict[int, Set[int]] = {r.idx: set() for r in self.rects}
        for i, a in enumerate(self.rects):
            for b in self.rects[i + 1:]:
                if a.edge_shared(b) > 1e-9:
                    adj[a.idx].add(b.idx)
                    adj[b.idx].add(a.idx)
        return adj


def _balanced_bipartition(areas: Sequence[Tuple[int, float]]):
    """Greedy balanced split of (index, area) items into two halves."""
    ordered = sorted(areas, key=lambda t: t[1], reverse=True)
    left: List[Tuple[int, float]] = []
    right: List[Tuple[int, float]] = []
    al = ar = 0.0
    for item in ordered:
        if al <= ar:
            left.append(item)
            al += item[1]
        else:
            right.append(item)
            ar += item[1]
    return left, right, al, ar


def _place(items, x, y, w, h, vertical, out):
    """Recursively place ``items`` (list of (idx, area)) inside the box."""
    if len(items) == 1:
        idx, area = items[0]
        # the chiplet owns the whole slot; slots tile the package exactly,
        # so slot adjacency below is the link topology. Slot area >= die
        # area; the surplus is white space.
        out[idx] = Rect(x, y, w, h, idx, die_area=area)
        return
    left, right, al, ar = _balanced_bipartition(items)
    frac = al / (al + ar)
    if vertical:   # vertical cut -> split width
        wl = w * frac
        _place(left, x, y, wl, h, not vertical, out)
        _place(right, x + wl, y, w - wl, h, not vertical, out)
    else:          # horizontal cut -> split height
        hl = h * frac
        _place(left, x, y, w, hl, not vertical, out)
        _place(right, x, y + hl, w, h - hl, not vertical, out)


def floorplan(areas: Sequence[float], whitespace_frac: float = 0.10) -> Floorplan:
    """Slicing floorplan of chiplets with the given areas (mm^2).

    The bounding box is sized to total area * (1 + whitespace_frac) with a
    square aspect ratio; recursive bipartition assigns each chiplet a slot.
    """
    if not areas:
        raise ValueError("empty chiplet set")
    total = sum(areas) * (1.0 + whitespace_frac)
    side = math.sqrt(total)
    out: Dict[int, Rect] = {}
    _place(list(enumerate(areas)), 0.0, 0.0, side, side, True, out)
    rects = [out[i] for i in range(len(areas))]
    # bbox from actual placements (slots may underfill)
    width = max(r.x + r.w for r in rects)
    height = max(r.y + r.h for r in rects)
    return Floorplan(rects, width, height)


def chain_adjacency(n: int) -> Dict[int, Set[int]]:
    """Adjacency of a vertical 3D stack: tier i touches i-1 and i+1."""
    adj: Dict[int, Set[int]] = {i: set() for i in range(n)}
    for i in range(n - 1):
        adj[i].add(i + 1)
        adj[i + 1].add(i)
    return adj
