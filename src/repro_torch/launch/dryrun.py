"""One-card dry-run: count every (arch x shape) cell's work on ``meta``.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles every cell on 256- or 512-device production meshes and
reads XLA's cost and memory analyses. Here each applicable cell of
``ARCH_NAMES x SHAPES`` is built by ``launch.steps.build_cell`` on the
``meta`` device (shapes, no data, nothing drawn or launched) under the
JAX package's bf16 policy and run once under
:class:`~repro_torch.analysis.counting.OpCounter`, which counts its
FLOPs, bytes, collectives and peak live bytes op by op. Counting costs
host time in proportion to depth, so each cell is counted at the two
depths of ``analysis.depth.count_depths`` (repeat units 2 and 3) and
extrapolated to its full depth (exact for the counts, which sum over
units, and for the peak of live bytes from unit 2 on; the dry-run tests
hold both to a full-depth count).

Each record keeps the JAX package's field names and adds ``chips`` (1)
and ``fits_one_card``:

- ``flops``, ``bytes_accessed``, ``collectives``: extrapolated to full
  depth; ``*_raw``: the count at the deeper of the two depths;
  ``depth_extrapolation``: [lower depth, deeper depth, full depth], in
  repeat units;
- ``argument_size_in_bytes``: parameters, optimizer state, batch and
  cache at full depth, exact from their shapes;
- ``output_size_in_bytes``: the step's returned tensors (a train step
  updates the parameters in place and returns the optimizer state);
- ``temp_size_in_bytes``: the peak of the bytes the step allocates
  while they live, extrapolated in depth;
- ``fits_one_card``: arguments plus that peak within the H100's 80 GB.
  A cell that does not fit is ``ok`` all the same: most production
  cells do not fit one card.
- ``lower_s`` is 0 and ``compile_s`` the seconds the counting took
  (nothing compiles); ``alias_size_in_bytes`` and
  ``generated_code_size_in_bytes`` have no counterpart and are None.

``--mesh one`` (the default) counts one card. ``--mesh single`` (16 x
16, axes data and model), ``multi`` (2 x 16 x 16, pod, data and model)
and ``both`` count one rank of the JAX package's production meshes:
this process starts a fake process group of 256 (512) ranks, of which
it is rank 0 (no device, no data moved), each cell's step places its
parameters, optimizer state, batch and caches as DTensors on ``meta``
by the JAX package's rules (``distributed/sharding.py``), and the
counter sees this rank's local ops and the ``_c10d_functional``
collectives DTensor runs. Its records are per device:
``argument_size_in_bytes`` and ``param_size_in_bytes`` from the local
shard shapes, ``chips`` the mesh's size; ``fits_one_card`` asks whether
one rank's share fits. The collectives are DTensor's and are recorded,
not held against XLA's, which chooses others. The multi-pod cells are
counted on the mesh's (pod x data, model) = 32 x 16 view, which splits
every dimension the (pod, data) pair splits the same way: DTensor's
sharding propagation on the 3-d mesh takes minutes an op here. XLA's
probe mode and ``scan_layers`` have no twin: the port's layers are a
Python loop and the counter sees every op.

Usage (no device needed; importing this module changes nothing in the
environment)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --arch smollm-135m --shape train_4k
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Dict

import torch
from torch import nn
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.counting import OpCounter
from repro_torch.analysis.depth import count_depths, extrapolate
from repro_torch.analysis.roofline import H100, HEADER, format_row, \
    from_record
from repro_torch.configs import ARCH_NAMES, SHAPES, applicable, get_config, \
    get_shape
from repro_torch.launch.mesh import (
    is_device_mesh,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.launch.steps import BF16, build_cell

MESHES = ("one", "single", "multi", "both")


def tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a model's parameters, an
    optimizer state, nested dicts, lists and tuples), each storage once."""
    leaves = []
    for x in tree_flatten(tree)[0]:
        leaves.extend(x.parameters() if isinstance(x, nn.Module) else [x])
    seen: Dict[int, int] = {}
    for t in leaves:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _local_bytes(arg, pl, mesh) -> int:
    """Bytes of this rank's shards of ``arg`` (a tensor, a model, an
    AdamW state, dicts, lists and tuples of them) placed by ``pl`` (the
    same structure of placements, or None for a replicated tensor)."""
    if isinstance(arg, torch.Tensor):
        n = arg.numel() * arg.element_size()
        for i, p in enumerate(pl or ()):
            if p.is_shard():
                n //= mesh.mesh.shape[i]
        return n
    if isinstance(arg, nn.Module):
        return sum(_local_bytes(t, pl[k], mesh)
                   for k, t in arg.named_parameters())
    if hasattr(arg, "_fields"):                 # AdamWState
        return (_local_bytes(arg.step, None, mesh)
                + _local_bytes(arg.mu, pl.mu, mesh)
                + _local_bytes(arg.nu, pl.nu, mesh))
    if isinstance(arg, dict):
        return sum(_local_bytes(v, pl[k], mesh) for k, v in arg.items())
    return sum(_local_bytes(a, p, mesh) for a, p in zip(arg, pl))


def production_mesh(name: str):
    """The mesh a ``--mesh`` name counts on: the production mesh of a
    fake process group, the multi-pod one as its (pod x data, model)
    view."""
    mesh = make_production_mesh(multi_pod=name == "multi")
    if "pod" not in mesh.mesh_dim_names:
        return mesh
    from torch.distributed.device_mesh import init_device_mesh

    pod, data, model = mesh.mesh.shape
    return init_device_mesh("cpu", (pod * data, model),
                            mesh_dim_names=("data", "model"))


def count_step(fn, args, static, device) -> Dict[str, object]:
    """One call of ``fn(*args, **static)`` counted on ``device``: flops,
    bytes, collectives, the peak of live allocated bytes and the bytes
    of what it returns."""
    with OpCounter(device) as c:
        out = fn(*args, **static)
    return dict(flops=c.flops, bytes=c.bytes, collectives=c.collectives,
                temp=c.peak_bytes, output=tree_bytes(out),
                kernels=c.summary()["kernels"])


def _count_cell(cfg, shape, mesh, policy):
    fn, args, _, _, static = build_cell(cfg, shape, mesh, policy)
    return count_step(fn, args, static, "meta")


def count_extrapolated(cfg, shape, mesh=None, policy=BF16):
    """The cell counted on meta at the two depths of ``count_depths``:
    (counts at full depth, the deeper depth's counts, [lo, hi, full]).
    ``flops``, ``bytes``, ``output`` and ``temp`` are extrapolated, and
    ``collectives`` kind by kind."""
    c1, d1, c2, d2, full = count_depths(cfg)
    k1 = _count_cell(c1, shape, mesh, policy)
    k2 = _count_cell(c2, shape, mesh, policy)
    out = {key: extrapolate(k1[key], k2[key], d1, d2, full)
           for key in ("flops", "bytes", "output", "temp")}
    coll1, coll2 = k1["collectives"], k2["collectives"]
    out["collectives"] = {
        k: extrapolate(coll1.get(k, 0.0), coll2.get(k, 0.0), d1, d2, full)
        for k in set(coll1) | set(coll2)}
    return out, k2, [d1, d2, full]


def run_cell(arch: str, shape_name: str, mesh_name: str = "one",
             policy=BF16, verbose: bool = True, mesh=None) -> dict:
    """One cell's record; ``mesh`` is the mesh a ``single`` or ``multi``
    cell counts on (without one, :func:`run_mesh_cell` builds it)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    if mesh is None and mesh_name != "one":
        return run_mesh_cell(arch, shape_name, mesh_name, policy, verbose)
    t0 = time.time()
    try:
        if mesh is None:
            mesh = make_host_mesh(torch_device="meta")
        ext, k2, depths = count_extrapolated(cfg, shape, mesh, policy)
        _, args, in_sh, _, _ = build_cell(cfg, shape, mesh, policy)
        if is_device_mesh(mesh):
            chips = mesh.size()
            arg_bytes = _local_bytes(args, in_sh, mesh)
            param_bytes = _local_bytes(args[0], in_sh[0], mesh)
        else:
            chips = 1
            arg_bytes = tree_bytes(args)
            param_bytes = tree_bytes(args[0])
        temp = ext["temp"]
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "chips": chips, "status": "ok",
            "flops": ext["flops"],
            "bytes_accessed": ext["bytes"],
            "collectives": ext["collectives"],
            "flops_raw": k2["flops"],
            "bytes_raw": k2["bytes"],
            "collectives_raw": k2["collectives"],
            "depth_extrapolation": depths,
            "lower_s": 0.0,
            "compile_s": round(time.time() - t0, 1),
            "temp_size_in_bytes": temp,
            "argument_size_in_bytes": arg_bytes,
            "param_size_in_bytes": param_bytes,
            "output_size_in_bytes": ext["output"],
            "alias_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
            "fits_one_card": arg_bytes + temp <= H100.hbm_bytes,
        }
        if verbose:
            print(f"  memory: args={arg_bytes / 2**30:.2f}GiB "
                  f"temp={temp / 2**30:.2f}GiB "
                  f"out={rec['output_size_in_bytes'] / 2**30:.2f}GiB "
                  f"fits_one_card={rec['fits_one_card']}")
            print(f"  counted: flops={rec['flops']:.3e} "
                  f"bytes={rec['bytes_accessed']:.3e}")
            r = from_record(rec, cfg, shape, H100,
                            H100.peak_flops(policy.compute_dtype))
            print(f"  roofline ({HEADER}): {format_row(r)} "
                  f"step_time_lb={r.step_time_lb:.3e}")
        return rec
    except Exception as e:  # noqa: BLE001 — report and continue
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def run_mesh_cell(arch: str, shape_name: str, mesh_name: str,
                  policy=BF16, verbose: bool = False) -> dict:
    """:func:`run_cell` on a production mesh in a process with no live
    process group: the fake group starts for the cell and stops after
    it, so the process can count one-card cells again."""
    import torch.distributed as dist

    mesh = production_mesh(mesh_name)
    try:
        return run_cell(arch, shape_name, mesh_name, policy, verbose,
                        mesh=mesh)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, help="one shape (default all)")
    ap.add_argument("--mesh", default="one", choices=MESHES)
    ap.add_argument("--out", default="dryrun_report.json")
    ap.add_argument("--append", action="store_true",
                    help="merge into an existing report")
    args = ap.parse_args(argv)

    arches = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    records = []
    if args.append and args.out:
        try:
            with open(args.out) as f:
                records = json.load(f)
        except FileNotFoundError:
            pass
    done = {(r["arch"], r["shape"], r["mesh"]) for r in records
            if r.get("status") == "ok"}

    failures = 0
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    for mesh_name in meshes:
        for arch in arches:
            for shape in shapes:
                key = (arch, shape, mesh_name)
                if key in done:
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name}")
                rec = run_cell(arch, shape, mesh_name)
                records = [r for r in records
                           if (r["arch"], r["shape"], r["mesh"]) != key]
                records.append(rec)
                if rec["status"] == "error":
                    failures += 1
                    print(f"  ERROR: {rec['error']}")
                elif rec["status"] == "skipped":
                    print(f"  skipped: {rec['reason']}")
                else:
                    print(f"  ok in {rec['compile_s']}s")
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)
    print(f"[dryrun] wrote {args.out}: "
          f"{sum(r['status'] == 'ok' for r in records)} ok, "
          f"{sum(r['status'] == 'skipped' for r in records)} skipped, "
          f"{failures} errors")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
