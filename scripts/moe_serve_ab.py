#!/usr/bin/env python3
"""Serve times of the two MoE configs, with the port's package taken from
a given source tree, for an A/B of two trees on one card.

    python3 scripts/moe_serve_ab.py                       # this tree
    python3 scripts/moe_serve_ab.py --src /path/to/other/src --reps 3

``deepseek-v2-236b`` cut to 8 layers and ``llama4-maverick-400b-a17b``
cut to 2, at full width in bf16, batch 4, prompt 512, 32 tokens:
``chip_smoke.py``'s ``serve_moe`` and ``serve_moe_gqa`` cells. After a
warm-up ``generate`` at the full prompt, ``--reps`` timed ``generate``
calls, each giving its prefill time and decode p50 (the host clock
around each step, as ``launch/serve.py`` measures them). One JSON line
per config with the card's name and power limit. To compare two trees,
run them alternately in one call (A, B, B, A). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUTS = {"deepseek-v2-236b": 8, "llama4-maverick-400b-a17b": 2}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def serve_times(arch: str, reps: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model

    cfg = dataclasses.replace(get_config(arch), n_layers=CUTS[arch])
    model = init_model(cfg, DTypePolicy.bf16(), seed=0, torch_device="cuda")
    prompts = make_prompts(cfg.vocab, 4, 512, seed=1, device="cuda")
    generate(model, prompts, 32)                          # warm-up
    runs = [generate(model, prompts, 32) for _ in range(reps)]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.n_layers, batch=4, prompt_len=512,
                gen=32, prefill_ms=[r["prefill_ms"] for r in runs],
                decode_p50_ms=[r["decode_p50_ms"] for r in runs])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(REPO, "src"),
                    help="the source tree whose repro_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_serve_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    for arch in CUTS:
        rec = serve_times(arch, args.reps)
        rec.update(src=args.src, card=name)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
