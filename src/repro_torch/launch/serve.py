"""Serving entry point: batched prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduced --batch 2 --prompt-len 16 --gen 4    # smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --batch 4 --prompt-len 1024 --gen 32   # on cuda: 32.8 GB fp32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
        --dtype bfloat16 --batch 4 --prompt-len 512 --gen 32  # 29.5 GB
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --batch 4 --prompt-len 512 --gen 32            # on cuda, full width
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --device cpu --reduced --batch 2 --prompt-len 16 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --batch 4 --prompt-len 3072 --gen 32
        # on cuda, full width: 34.3 GB of float32 weights
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --device cpu --reduced --batch 2 \
        --prompt-len 40 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-236b --reduced --device cpu --batch 2 \
        --prompt-len 16 --gen 4             # MLA, shared + routed experts
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-maverick-400b-a17b --reduced --device cpu \
        --batch 2 --prompt-len 16 --gen 4   # GQA, interleaved experts

Draws the model's weights from a seeded ``torch.Generator`` and the
prompts from numpy, prefills the batch, then runs the decode loop
through ``serve_step`` (one new token per sequence per step against the
cache), reporting per-step latency as the JAX package's serve CLI does. The
config is reduced with ``--reduced`` or on the CPU, as there; on cuda it
serves at full width. It refuses the audio (encoder-only) and vlm
families with the JAX CLI's messages (their steps are
``repro_torch.launch.steps``' ``eval_step``, ``prefill_step`` and
``serve_step``). ``--dtype`` picks ``DTypePolicy()`` (float32, the
JAX package CLI's policy) or ``DTypePolicy.bf16()``. Without a GPU it
raises unless ``--device cpu`` is given. On cuda it refuses, before
drawing a weight, a config whose weights exceed the card's free memory:
the two MoE configs at full depth (471.5 GB and 795.4 GB in bf16) fit
no single card, and, as in the JAX package's CLI, there is no depth
flag.

``--model-par N`` serves on a (data, model) mesh of the ranks that
``python -m torch.distributed.run --nproc-per-node R`` starts (gloo on
the CPU, nccl on cuda, a card per rank), N ranks per model group: the
prefill and decode steps of ``launch/steps.py`` built on it, the
weights, caches and batch placed by the JAX package's rules. Rank 0
prints. Without that environment the CLI serves on one device.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.mesh import init_from_env, make_host_mesh
from repro_torch.launch.steps import (
    build_prefill_step,
    build_serve_step,
    serve_step,
)
from repro_torch.models.common import DTypePolicy
from repro_torch.models.transformer import LM, init_model, prefill


def weight_bytes(cfg, policy: DTypePolicy) -> int:
    """The bytes of ``cfg``'s weights under ``policy``: the model built
    on the meta device, which allocates nothing."""
    model = LM(cfg, policy, None, torch.device("meta"))
    return sum(p.numel() * p.element_size() for p in model.parameters())


def require_fits(cfg, policy: DTypePolicy, free_bytes: int) -> None:
    """Raise when ``cfg``'s weights alone exceed ``free_bytes``."""
    need = weight_bytes(cfg, policy)
    if need > free_bytes:
        raise RuntimeError(
            f"{cfg.name}: its weights take {need} bytes under "
            f"{policy.param_dtype}, more than the card's {free_bytes} free "
            "bytes; serve it with --reduced")


def make_prompts(vocab: int, batch: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    """(batch, prompt_len) int32 token ids drawn by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, prompt_len), dtype=np.int32)
    return torch.as_tensor(ids, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _percentile(xs: List[float], q: float):
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


@torch.inference_mode()
def generate(model: LM, prompts: torch.Tensor, gen: int,
             mesh=None) -> Dict:
    """Prefill ``prompts``, then ``gen - 1`` greedy decode steps, each
    timed on the host clock up to a device synchronize. Returns the
    tokens (B, gen), the prefill time, the per-step times, their p50/p90
    over the steady steps (all but the first) and whether every logit of
    every step was finite. On a ``DeviceMesh`` the steps are the ones
    ``launch/steps.py`` builds on it."""
    dev = prompts.device
    b, s = prompts.shape
    step = serve_step
    if mesh is not None:
        step = build_serve_step(model.cfg, mesh)[0]
    _sync(dev)
    t0 = time.perf_counter()
    if mesh is None:
        logits, cache, length = prefill(model, prompts, s + gen)
    else:
        logits, cache, length = build_prefill_step(model.cfg, mesh)[0](
            model, {"tokens": prompts}, cache_len=s + gen)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    generated = [token]
    times = []
    for _ in range(gen - 1):
        t0 = time.perf_counter()
        token, logits, cache, length = step(model, cache, token, length)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        finite &= torch.isfinite(logits).all()
        generated.append(token)
    steady = times[1:] or times
    decode_s = sum(times)
    return {
        "tokens": torch.stack(generated, dim=1),
        "prefill_ms": prefill_s * 1e3,
        "decode_ms": [t * 1e3 for t in times],
        "decode_p50_ms": None if not steady else
        _percentile(steady, 0.5) * 1e3,
        "decode_p90_ms": None if not steady else
        _percentile(steady, 0.9) * 1e3,
        "decode_tokens_per_s": (b * len(times) / decode_s) if times
        else None,
        "all_finite": bool(finite),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (raises without a GPU)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--model-par", type=int, default=1,
                    help="ranks per model group under torch.distributed.run")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh, rank = None, 0
    ranked = init_from_env(dev)
    if ranked is not None:
        import torch.distributed as dist

        dev, rank = ranked, dist.get_rank()
        mesh = make_host_mesh(args.model_par, dev)
    try:
        return _serve(args, dev, mesh, rank)
    finally:
        if ranked is not None:
            dist.destroy_process_group()


def _serve(args, dev, mesh, rank: int) -> int:
    cfg = get_config(args.arch)
    if args.reduced or dev.type == "cpu":
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit("encoder-only architectures have no decode step")
    if cfg.family == "vlm":
        raise SystemExit("vlm serving runs via the dry-run decode cells")
    policy = (DTypePolicy.bf16() if args.dtype == "bfloat16"
              else DTypePolicy())
    if dev.type == "cuda":
        require_fits(cfg, policy, torch.cuda.mem_get_info(dev)[0])
    model = init_model(cfg, policy, seed=0, torch_device=dev)
    prompts = make_prompts(cfg.vocab, args.batch, args.prompt_len, 1, dev)
    n_params = sum(p.numel() for p in model.parameters())
    out = generate(model, prompts, args.gen, mesh)
    if rank:
        return 0 if out["all_finite"] else 1
    if mesh is not None:
        print(f"[serve] mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
              f" of {mesh.size()} ranks")
    print(f"[serve] {cfg.name}: {n_params} parameters, {model.embed.dtype}")
    print(f"[serve] {cfg.name} on {dev}: prefill {args.batch}x"
          f"{args.prompt_len} in {out['prefill_ms']:.1f}ms")
    if out["decode_ms"]:
        print(f"[serve] generated {tuple(out['tokens'].shape)} tokens; "
              f"decode latency p50 {out['decode_p50_ms']:.2f}ms "
              f"(first step {out['decode_ms'][0]:.1f}ms)")
    print(f"[serve] sample row 0: {out['tokens'][0][:16].tolist()}")
    if not out["all_finite"]:
        print("[serve] non-finite logits")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
