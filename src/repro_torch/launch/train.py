"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --steps 20                            # smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --steps 20 --fail-rate 0.1            # with restarts
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch rwkv6-3b --reduced --steps 20            # moe, ssm, hybrid
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --pathfind --steps 2                  # print an H100 plan
    PYTHONPATH=src python -m repro_torch.launch.train --steps 30 \
        --batch 8 --seq 256 --ckpt-every 10             # on cuda, full width

The JAX package's ``launch/train.py`` on one device: a model drawn from a
seed with grads on, the remat'd ``train_step``, the deterministic
synthetic pipeline, AdamW (warmup 10 steps, cosine over ``--steps``),
checkpoints every ``--ckpt-every`` steps through the port's
``CheckpointManager`` under the JAX package's tree keys (``params``,
``opt_mu``, ``opt_nu``, ``opt_step``, the parameters stacked per layer as
there, so either package restores the other's), failure injection
(``--fail-rate``, fault seed 11 as there) with restart supervision, and
straggler monitoring. It exits 0 only if the last loss is below the
first.

The config is reduced with ``--reduced`` or on the CPU, as there.
``--dtype`` picks ``DTypePolicy()`` (float32, the JAX CLI's policy) or
``DTypePolicy.bf16()``. Without a GPU it raises unless ``--device cpu``
is given. ``--pathfind`` first anneals a plan for a cluster of H100s
(``analysis/gpu_pathfinder.py``: devices, TP width, microbatch, remat,
int8 gradients, with their carbon) and prints it, as the JAX CLI does.

``--model-par N`` trains on a (data, model) mesh of the ranks that
``python -m torch.distributed.run --nproc-per-node R`` starts (gloo on
the CPU, nccl on cuda, a card per rank), N ranks per model group:
``launch/steps.py``'s ``build_train_step`` on it (parameters, moments
and batch placed by the JAX package's rules, gradients redistributed to
the parameters' placements before AdamW). A checkpoint gathers the
whole tensors and rank 0 writes it; a restore places them again. Rank
0 prints. Without that environment the CLI trains on one device::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --reduced --steps 20 \
        --model-par 2
Every token-LM family trains: dense, moe (with
the experts' capacity drops and the load-balancing loss), ssm (RWKV-6,
gradients through the ``wkv6`` kernel's autograd node) and hybrid
(RecurrentGemma, through ``rglru``'s); audio and vlm are refused with
the JAX CLI's message. Without ``--ckpt-dir`` the checkpoints go to a
fresh temporary directory, removed at the end.

On the CPU a run with injected failures ends with the parameters of the
fault-free run bit for bit: a restart restores the last checkpoint and
replays the same batches. On cuda that holds under
``torch.use_deterministic_algorithms(True)``.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.analysis.gpu_pathfinder import pathfind
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (
    adamw_state_from_reference,
    lm_params_from_reference,
    lm_params_to_reference,
    lm_reference_shapes,
)
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import init_from_env, make_host_mesh
from repro_torch.launch.steps import build_train_step, train_step
from repro_torch.models.common import DTypePolicy
from repro_torch.models.transformer import LM, init_model
from repro_torch.optim import adamw
from repro_torch.runtime import (
    FailureInjector,
    RestartSupervisor,
    StragglerMonitor,
)

FAULT_SEED = 11        # the JAX CLI's FailureInjector seed


def require_trainable(cfg: ModelConfig) -> None:
    """Refuse the families ``train`` does not train, audio and vlm, as
    the JAX CLI does."""
    if cfg.family in ("audio", "vlm"):
        raise SystemExit("train driver supports token-LM archs; "
                         "audio/vlm run via the dry-run cells")


def _whole(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: shd.full(v) for k, v in tensors.items()}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def save_state(mgr: CheckpointManager, step: int, model: LM,
               opt_state: adamw.AdamWState) -> Optional[str]:
    """Checkpoint the model and optimizer under the JAX package's keys,
    the parameters and both moments stacked per layer as there. Sharded
    tensors are gathered whole on every rank and rank 0 writes."""
    tree = {
        "params": _whole(dict(model.named_parameters())),
        "opt_mu": _whole(opt_state.mu), "opt_nu": _whole(opt_state.nu)}
    path = None
    if _rank() == 0:
        path = mgr.save(step, {
            **{k: lm_params_to_reference(v) for k, v in tree.items()},
            "opt_step": opt_state.step.cpu().numpy()})
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
    return path


def _shared_temp_dir() -> str:
    """A fresh temporary directory, rank 0's on every rank of a live
    group (the ranks share one host)."""
    import torch.distributed as dist

    path = [tempfile.mkdtemp(prefix="repro_torch_ckpt_")
            if _rank() == 0 else None]
    if dist.is_initialized():
        dist.broadcast_object_list(path, src=0)
    return path[0]


def load_params(model: LM, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` (whole tensors named as ``model``'s parameters)
    into the model in place, each into its parameter's placement."""
    params = dict(model.named_parameters())
    if not any(shd.is_dtensor(p) for p in params.values()):
        model.load_state_dict(state)
        return
    if set(state) != set(params):
        raise KeyError(f"parameters differ: {set(state) ^ set(params)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(shd.place(state[name].to(p.device), None, None, like=p))


def restore_state(mgr: CheckpointManager, model: LM):
    """Load the newest valid checkpoint (the port's or the JAX
    package's) into ``model`` in place. Returns (step, the restored
    optimizer state on the model's device)."""
    shapes = lm_reference_shapes(dict(model.named_parameters()))
    step, tree = mgr.restore({"params": shapes, "opt_mu": shapes,
                              "opt_nu": shapes,
                              "opt_step": np.zeros((), np.int32)})
    load_params(model, lm_params_from_reference(tree["params"], model.cfg,
                                                copy=False))
    return step, adamw_state_from_reference(
        tree["opt_step"], tree["opt_mu"], tree["opt_nu"], model.cfg,
        model.embed.device)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-3, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, fail_rate: float = 0.0,
          log_every: int = 10, policy: DTypePolicy = DTypePolicy(),
          seed: int = 0, remat: bool = True,
          torch_device: DeviceLike = None,
          log: Callable[[str], None] = print, mesh=None) -> Dict:
    """Train ``cfg`` for ``steps`` steps under restart supervision.
    Returns the model, the loss and wall time of every executed step
    (replays included, in order), the steps each loss belongs to, and
    the supervisor's stats. On a ``DeviceMesh`` ``mesh`` the step is
    ``build_train_step``'s on it."""
    require_trainable(cfg)
    dev = resolve_device(torch_device)
    opt_cfg = adamw.AdamWConfig(lr_peak=lr, warmup_steps=10,
                                total_steps=steps)
    model = init_model(cfg, policy, seed=seed, torch_device=dev,
                       trainable=True)
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch), torch_device=dev)
    own_dir = ckpt_dir is None
    if own_dir:
        ckpt_dir = _shared_temp_dir()
    mgr = CheckpointManager(ckpt_dir, keep=3)
    losses, step_ids, times = [], [], []
    if mesh is None:
        def step_fn(model, opt_state, batch):
            return train_step(model, opt_state, batch, opt_cfg, remat=remat)
    else:
        step_fn = build_train_step(cfg, mesh, opt_cfg, policy, remat)[0]

    def one_step(step, opt_state):
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(model, opt_state, pipe.batch(step))
        loss = float(metrics["loss"])           # waits for the step
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        step_ids.append(step)
        if step % log_every == 0:
            log(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e}")
        return opt_state

    def save(step, opt_state):
        save_state(mgr, step, model, opt_state)

    def restore():
        if mgr.latest() is None:            # back to the initial state
            with torch.no_grad():
                fresh = init_model(cfg, policy, seed=seed, torch_device=dev)
                load_params(model, fresh.state_dict())
            del fresh                       # before the moments are drawn
            return 0, adamw.init(dict(model.named_parameters()), opt_cfg)
        return restore_state(mgr, model)

    sup = RestartSupervisor(
        one_step, save, restore, save_every=ckpt_every,
        injector=FailureInjector(rate=fail_rate, seed=FAULT_SEED),
        monitor=StragglerMonitor())
    t0 = time.perf_counter()
    try:
        opt_state = sup.run(
            steps, adamw.init(dict(model.named_parameters()), opt_cfg))
    finally:
        if own_dir and _rank() == 0:
            shutil.rmtree(mgr.directory, ignore_errors=True)
    return {"model": model, "opt_state": opt_state, "losses": losses,
            "steps": step_ids, "step_s": times,
            "wall_s": time.perf_counter() - t0, "stats": sup.stats}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a fresh temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-rate", type=float, default=0.0)
    ap.add_argument("--pathfind", action="store_true",
                    help="print the H100 cluster plan the pathfinder picks")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (raises without a GPU)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--model-par", type=int, default=1,
                    help="ranks per model group under torch.distributed.run")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ranked = init_from_env(dev)
    try:
        return _main(args, ranked or dev, ranked is not None)
    finally:
        if ranked is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args, dev: torch.device, ranked: bool) -> int:
    mesh = make_host_mesh(args.model_par, dev) if ranked else None
    rank = _rank()
    cfg = get_config(args.arch)
    if args.reduced or dev.type == "cpu":
        cfg = cfg.reduced()
    require_trainable(cfg)
    policy = (DTypePolicy.bf16() if args.dtype == "bfloat16"
              else DTypePolicy())
    if args.pathfind and rank == 0:
        plan = pathfind(cfg, args.batch, args.seq, verbose=True)
        print(f"[pathfind] chosen plan: {plan}")
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, fail_rate=args.fail_rate,
                log_every=args.log_every, policy=policy, torch_device=dev,
                log=(lambda line: print(line, flush=True)) if rank == 0
                else (lambda line: None), mesh=mesh)
    losses, stats = out["losses"], out["stats"]
    if rank:
        return 0 if losses[-1] < losses[0] else 1
    if mesh is not None:
        print(f"[train] mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
              f" of {mesh.size()} ranks")
    print(f"[train] {cfg.name} on {dev}: {args.steps} steps in "
          f"{out['wall_s']:.1f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"restarts={stats.restarts} replayed={stats.replayed_steps} "
          f"stragglers={stats.straggler_steps}; step p50 "
          f"{np.median(out['step_s']) * 1e3:.1f}ms")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
