"""One rank of the multi-rank CPU runs of ``tests/test_torch_distributed.py``
(holds no tests itself).

    python tests/test_torch_distributed_worker.py CASE RANK WORLD STORE OUT

joins a gloo process group of WORLD ranks through the ``FileStore`` at
STORE, runs CASE and, on rank 0, writes its results to the ``.npz`` at
OUT. Each rank runs on one thread, so eight ranks fit a test worker.
The cases:

- ``dense``: smollm-135m reduced, fp32, on a 2 x 4 (data, model) mesh:
  the first step's loss and gradients (gathered whole), then 12 sharded
  train steps' losses, then one sharded decode step's logits from the
  initial weights;
- ``moe``: deepseek-v2-236b reduced on 2 x 4: a MoE layer's
  expert-parallel output (exact and with the capacity drops) on a fixed
  input, the first step's loss and gradients with a capacity that drops
  no pair (:func:`no_drop`), then 12 sharded train steps' losses;
- ``scenario`` and ``scenario_resume``: the scenario grid of
  ``tests/test_torch_distributed.py`` split over the ranks (see there).
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)

SEQ, BATCH, STEPS = 64, 4, 12
DECODE = dict(batch=4, cache=32, length=8)


def opt_cfg():
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=30)


def moe_input(cfg) -> np.ndarray:
    return np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)


def no_drop(cfg):
    """``cfg`` with a capacity factor of E: the capacity of T tokens is
    ``T * k + 1``, so neither one process nor a rank drops a pair and
    the two compute the same function."""
    return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))


def _model_and_data(cfg, mesh):
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import place_model
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model

    model = init_model(cfg, DTypePolicy(), seed=0, torch_device="cpu",
                       trainable=True)
    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab, SEQ, BATCH, seed=0),
                                  torch_device="cpu")
    return place_model(model, mesh), pipe


def _first_step(cfg, mesh, out):
    """The first step's loss and gradients, gathered whole."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import loss_fn

    model, pipe = _model_and_data(cfg, mesh)
    params = dict(model.named_parameters())
    batch = pipe.batch(0)
    batch = shd.distribute(batch, shd.batch_specs(batch, mesh), mesh)
    with shd.activation_policy(mesh):
        loss = loss_fn(model, batch, remat=True)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    out["loss0"] = shd.full(loss).detach().numpy()
    for (name, p), g in zip(params.items(), grads):
        g = torch.zeros_like(p) if g is None else \
            g.redistribute(p.device_mesh, p.placements)
        out["grad/" + name] = shd.full(g).detach().numpy()


def _train(cfg, mesh, out):
    """STEPS sharded train steps' losses."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.common import DTypePolicy
    from repro_torch.optim import adamw

    model, pipe = _model_and_data(cfg, mesh)
    step, _ = build_train_step(cfg, mesh, opt_cfg(), DTypePolicy(),
                               remat=True)
    state = adamw.init(dict(model.named_parameters()), opt_cfg())
    losses = []
    for i in range(STEPS):
        state, m = step(model, state, pipe.batch(i))
        losses.append(float(m["loss"]))
    out["losses"] = np.array(losses)


def case_dense(mesh, out):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_cache, init_model

    cfg = get_config("smollm-135m").reduced()
    _first_step(cfg, mesh, out)
    _train(cfg, mesh, out)
    model = init_model(cfg, DTypePolicy(), seed=0, torch_device="cpu")
    serve, _ = build_serve_step(cfg, mesh, DTypePolicy())
    b = DECODE["batch"]
    cache = init_cache(cfg, b, DECODE["cache"], DTypePolicy(),
                       torch_device="cpu")
    token = torch.zeros((b,), dtype=torch.int32)
    length = torch.full((b,), DECODE["length"], dtype=torch.int32)
    nxt, logits, cache, length = serve(model, cache, token, length)
    out["logits"] = logits.numpy()
    out["next"] = nxt.numpy()


def case_moe(mesh, out):
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import place_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model

    cfg = get_config("deepseek-v2-236b").reduced()
    model = init_model(cfg, DTypePolicy(), seed=0, torch_device="cpu")
    place_model(model, mesh)
    layer = model.moe_layers[0].moe
    x = shd.place(torch.from_numpy(moe_input(cfg)),
                  (shd.DATA, None, None), mesh)
    with shd.activation_policy(mesh):
        for tag, exact in (("exact", True), ("capped", False)):
            y = moe_mod.moe_forward(layer, x, cfg, exact=exact)
            out["y_" + tag] = shd.full(y).numpy()
    _first_step(no_drop(cfg), mesh, out)
    _train(cfg, mesh, out)


def _cells(res, out, pre):
    for i, s in enumerate(res.scenarios):
        r = res.results[s.key]
        out[f"{pre}enc/{i}"] = r.frontier.encoded
        out[f"{pre}vec/{i}"] = r.frontier.vectors
        out[f"{pre}best/{i}"] = np.array(r.best_cost)
        out[f"{pre}hist/{i}"] = np.asarray(r.history)
        out[f"{pre}key/{i}"] = np.array("|".join(s.key))


def case_scenario(out):
    from test_torch_distributed import scenario_run

    _cells(scenario_run(True), out, "")


def case_scenario_resume(out, directory):
    """The uninterrupted split run, then the same run interrupted at its
    first checkpoint and resumed from it."""
    from test_torch_distributed import scenario_run

    _cells(scenario_run(True, "resume"), out, "ref/")
    interrupted = 0
    try:
        scenario_run(True, "resume", resume_dir=directory, interrupt=True)
    except (KeyboardInterrupt, RuntimeError):
        interrupted = 1
    _cells(scenario_run(True, "resume", resume_dir=directory), out, "res/")
    out["interrupted"] = np.array(interrupted)


def main(argv) -> int:
    import torch.distributed as dist

    case, rank, world, store, path = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        out = {}
        if case in ("dense", "moe"):
            mesh = make_host_mesh(model=4, torch_device="cpu")
            (case_dense if case == "dense" else case_moe)(mesh, out)
        elif case == "scenario":
            case_scenario(out)
        elif case == "scenario_resume":
            case_scenario_resume(out, argv[5])
        else:
            raise SystemExit(f"unknown case {case}")
        if rank == 0:
            np.savez(path, **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
