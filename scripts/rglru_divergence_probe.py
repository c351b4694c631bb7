#!/usr/bin/env python3
"""Where ``recurrentgemma-9b`` training turns NaN, through the kernel and
through its plain version.

    python3 scripts/rglru_divergence_probe.py [--lr 3e-3] [--steps 8]

``recurrentgemma-9b`` at full width cut to 6 layers (two groups), float32,
batch 8 x 256, AdamW with warmup 10 to the peak ``--lr``: each step's
loss and gradient norm, the RG-LRU decays of the first four recurrent
layers (the largest a, the least 1 - a^2) and the leaves whose gradient
is not finite, first with ``rglru`` launching its kernel, then with the
plain version in its place on the card. The RG-LRU computes
sqrt(1 - a^2) as exp(0.5 log1p(-a^2 + 1e-12)); in float32 the 1e-12 is
lost beside 1, so a decay that rounds to 1 has an infinite gradient.
Stops a run at its first non-finite parameter. One JSON line a step,
with the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rglru_divergence_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels.rglru import ops as rops
    from repro_torch.kernels.rglru.ref import rglru_plain
    from repro_torch.launch.steps import train_step
    from repro_torch.models import rglru as rg_mod
    from repro_torch.models.transformer import init_model, loss_fn
    from repro_torch.optim import adamw

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    decays, real_coeffs, real_run = [], rg_mod._rg_lru_coeffs, rops._run

    def coeffs(p, xi):
        a, b = real_coeffs(p, xi)
        with torch.no_grad():
            decays.append((float(a.max()), float((1 - a * a).min())))
        return a, b

    def plain_run(a, b, h0, h_out):
        return rglru_plain(a, b, h0)

    rg_mod._rg_lru_coeffs = coeffs
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=6)
    for path in ("kernel", "plain"):
        rops._run = real_run if path == "kernel" else plain_run
        model = init_model(cfg, seed=0, torch_device="cuda", trainable=True)
        opt = adamw.AdamWConfig(lr_peak=args.lr, warmup_steps=10,
                                total_steps=args.steps)
        state = adamw.init(dict(model.named_parameters()), opt)
        pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab, 256, 8),
                                      torch_device="cuda")
        for i in range(args.steps):
            decays.clear()
            batch = pipe.batch(i)
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(loss_fn(model, batch, remat=True),
                                        list(params.values()))
            bad = [k for k, g in zip(params, grads)
                   if not torch.isfinite(g).all()]
            del grads
            first = decays[:4]                  # the forward, not remat's
            state, m = train_step(model, state, batch, opt)
            print(json.dumps(dict(
                path=path, lr=args.lr, step=i, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]),
                max_decay=[d[0] for d in first],
                min_one_minus_a2=[d[1] for d in first],
                nonfinite_grads=len(bad), first_nonfinite=bad[:3],
                card=card)), flush=True)
            if not all(torch.isfinite(p).all() for p in model.parameters()):
                break
        del model, state
        torch.cuda.empty_cache()
    rops._run = real_run
    rg_mod._rg_lru_coeffs = real_coeffs
    return 0


if __name__ == "__main__":
    sys.exit(main())
