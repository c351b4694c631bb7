#!/usr/bin/env python3
"""Serve times of the two recurrent configs, with the port's package taken
from a given source tree, for an A/B of two trees on one card.

    python3 scripts/recurrent_serve_ab.py                 # this tree
    python3 scripts/recurrent_serve_ab.py --src /path/to/other/src --reps 3

``rwkv6-3b`` (prompt 512, the ``wkv6`` kernel each decode step) and
``recurrentgemma-9b`` (prompt 3072, the ``rglru`` kernel), both at full
size in float32, batch 4, 32 tokens: ``chip_smoke.py``'s ``serve`` and
``serve_hybrid`` cells. After a warm-up ``generate`` at the full prompt,
``--reps`` timed ``generate`` calls, each giving its prefill time and
decode p50 (the host clock around each step, as ``launch/serve.py``
measures them). One JSON line per config with the card's name and power
limit. To compare two trees, run them alternately in one call (A, B, B,
A). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"rwkv6-3b": 512, "recurrentgemma-9b": 3072}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def serve_times(arch: str, prompt_len: int, reps: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model

    cfg = get_config(arch)
    model = init_model(cfg, DTypePolicy(), seed=0, torch_device="cuda")
    prompts = make_prompts(cfg.vocab, 4, prompt_len, seed=1, device="cuda")
    generate(model, prompts, 32)                          # warm-up
    runs = [generate(model, prompts, 32) for _ in range(reps)]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.n_layers, batch=4,
                prompt_len=prompt_len, gen=32,
                prefill_ms=[r["prefill_ms"] for r in runs],
                decode_p50_ms=[r["decode_p50_ms"] for r in runs])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(REPO, "src"),
                    help="the source tree whose repro_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("recurrent_serve_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    for arch, prompt_len in CELLS.items():
        rec = serve_times(arch, prompt_len, args.reps)
        rec.update(src=args.src, card=name)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
