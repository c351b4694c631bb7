#!/usr/bin/env python3
"""Serve times of ``chip_smoke.py``'s four serve cells, with the port's
package taken from one or more source trees, alternated on one card.

    python3 scripts/serve_ab.py                                   # this tree
    python3 scripts/serve_ab.py --src build/parent/src --src src --reps 3

The cells, each at full width, batch 4, 32 tokens: ``serve`` (rwkv6-3b,
float32, prompt 512, the ``wkv6`` kernel), ``serve_hybrid``
(recurrentgemma-9b, float32, prompt 3072, the ``rglru`` kernel),
``serve_dense`` (qwen3-8b, float32, prompt 1024) and ``serve_moe``
(deepseek-v2-236b cut to 8 layers, bfloat16, prompt 512). Each tree runs
in a process of its own; two trees run A, B, B, A. In each process,
after a warm-up ``generate`` at the full prompt, ``--reps`` timed
``generate`` calls per cell, each giving its prefill time and decode
p50 (the host clock around each step, as ``launch/serve.py`` measures
them). One JSON line per (process, cell), then one summary line per
cell: the median over every timed call of each tree. The card's name
and power limit are on every line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cell: (arch, prompt length, layers kept or None, bfloat16)
CELLS = {"serve": ("rwkv6-3b", 512, None, False),
         "serve_hybrid": ("recurrentgemma-9b", 3072, None, False),
         "serve_dense": ("qwen3-8b", 1024, None, False),
         "serve_moe": ("deepseek-v2-236b", 512, 8, True)}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def serve_times(cell: str, reps: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model

    arch, prompt_len, layers, bf16 = CELLS[cell]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    policy = DTypePolicy.bf16() if bf16 else DTypePolicy()
    model = init_model(cfg, policy, seed=0, torch_device="cuda")
    prompts = make_prompts(cfg.vocab, 4, prompt_len, seed=1, device="cuda")
    generate(model, prompts, 32)                          # warm-up
    runs = [generate(model, prompts, 32) for _ in range(reps)]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(cell=cell, arch=cfg.name, layers=cfg.n_layers, batch=4,
                prompt_len=prompt_len, gen=32,
                prefill_ms=[r["prefill_ms"] for r in runs],
                decode_p50_ms=[r["decode_p50_ms"] for r in runs])


def worker(src: str, reps: int) -> int:
    sys.path.insert(0, os.path.abspath(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    for cell in CELLS:
        rec = serve_times(cell, reps)
        rec.update(src=src, card=name)
        print(json.dumps(rec), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append",
                    help="a source tree whose repro_torch is timed "
                         "(repeat for an A/B; default this tree's src)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device available", file=sys.stderr)
        return 2
    srcs = args.src or [os.path.join(REPO, "src")]
    if args.worker:
        return worker(srcs[0], args.reps)
    order = srcs if len(srcs) == 1 else srcs + srcs[::-1]
    recs = []
    for src in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--src", src, "--reps", str(args.reps)],
            capture_output=True, text=True, cwd=REPO)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                recs.append(json.loads(line))
    name = card()
    for cell in CELLS:
        summary = dict(cell=cell, card=name)
        for src in srcs:
            mine = [r for r in recs if r["cell"] == cell and r["src"] == src]
            summary[src] = dict(
                prefill_ms=statistics.median(
                    x for r in mine for x in r["prefill_ms"]),
                decode_p50_ms=statistics.median(
                    x for r in mine for x in r["decode_p50_ms"]))
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
