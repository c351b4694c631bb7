"""Depth variants for cost extrapolation.

The counterpart of the JAX package's ``analysis/depth.py``. There, XLA
costs a scanned layer stack's body once, so the dry-run compiles two
reduced depths and extrapolates. Here every layer runs as a Python loop
and the counter (:mod:`repro_torch.analysis.counting`) sees every op,
so a full-depth count is exact; but counting on ``meta`` costs host
time in proportion to the depth, so the dry-run counts each cell at two
depths (in the arch's natural repeat unit) and extrapolates linearly to
the full depth. FLOPs, bytes, collective bytes and output bytes are
sums over units, each unit the same computation, so any two depths
extrapolate them exactly. The peak of live bytes is not a sum but the
largest of several terms, each linear in depth (a layer's transient, the
activations kept for the backward, the gradients, the new optimizer
state); at one unit some of those terms have no layer yet (one that
follows another), and the largest may change between one unit and two.
So :func:`count_depths` counts units 2 and 3, past that change: the
dry-run tests hold all four extrapolations to the full-depth count for
every family. The configs have no ``unroll_layers`` (the JAX package's
cost-probe switch), so none is set.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig


def depth_variants(cfg: ModelConfig) -> Tuple[ModelConfig, int,
                                              ModelConfig, int, int]:
    """Returns (cfg_d1, d1, cfg_d2, d2, full_units).

    Units are repeat units: layers for uniform stacks, (dense, moe)
    groups for llama4, (rglru, rglru, local) groups for recurrentgemma,
    moe layers for deepseek (its single leading dense layer is held
    constant)."""
    if cfg.family == "moe" and cfg.moe_every > 1:           # llama4 groups
        unit = cfg.moe_every
        full = cfg.n_layers // unit
        c1 = dataclasses.replace(cfg, n_layers=1 * unit)
        c2 = dataclasses.replace(cfg, n_layers=2 * unit)
        return c1, 1, c2, 2, full
    if cfg.family == "moe" and cfg.first_dense:             # deepseek
        fd = cfg.first_dense
        full = cfg.n_layers - fd
        c1 = dataclasses.replace(cfg, n_layers=fd + 1)
        c2 = dataclasses.replace(cfg, n_layers=fd + 2)
        return c1, 1, c2, 2, full
    if cfg.family == "hybrid":                              # rg groups+tail
        pat = len(cfg.block_pattern)
        tail = cfg.n_layers - (cfg.n_layers // pat) * pat
        full = cfg.n_layers // pat
        c1 = dataclasses.replace(cfg, n_layers=1 * pat + tail)
        c2 = dataclasses.replace(cfg, n_layers=2 * pat + tail)
        return c1, 1, c2, 2, full
    full = cfg.n_layers
    c1 = dataclasses.replace(cfg, n_layers=1)
    c2 = dataclasses.replace(cfg, n_layers=2)
    return c1, 1, c2, 2, full


def extrapolate(v1: float, v2: float, d1: int, d2: int, full: int) -> float:
    """Linear in depth: f(d) = a + b*d, clamped non-negative (a noisy
    negative slope on a tiny term must not extrapolate below zero)."""
    b = (v2 - v1) / (d2 - d1)
    return max(0.0, v2 + b * (full - d2))


def count_depths(cfg: ModelConfig) -> Tuple[ModelConfig, int,
                                            ModelConfig, int, int]:
    """The two depths the dry-run counts, as (cfg_lo, lo, cfg_hi, hi,
    full_units): units 2 and 3 of :func:`depth_variants`'s repeat unit,
    or its own 1 and 2 for a model of at most 2 units (then the count at
    2 is exact or extrapolates back to 1)."""
    c1, d1, c2, d2, full = depth_variants(cfg)
    if full <= d2:
        return c1, d1, c2, d2, full
    c3 = dataclasses.replace(
        cfg, n_layers=2 * c2.n_layers - c1.n_layers)
    return c2, d2, c3, d2 + 1, full
