#!/usr/bin/env python3
"""What a full-width train state costs outside the step, on the card.

    python3 scripts/train_state_probe.py                    # both configs
    python3 scripts/train_state_probe.py --arch rwkv6-3b

For ``rwkv6-3b`` (32 layers) and ``recurrentgemma-9b`` cut to 6 layers,
in float32 at batch 8 x 256 (``chip_smoke.py``'s ``train_ssm`` and
``train_hybrid`` cells): one warm ``train_step``, then the step timed;
``launch/train.py``'s ``save_state`` of the parameters and both moments
into ``build/train_state_probe`` and its ``restore_state``, each timed;
and one step under ``torch.profiler`` (device busy time, idle share,
kernels) with the time the profiler itself took. Also the disk space
free under the checkout and the host's memory. One JSON line per
config, each with the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"rwkv6-3b": None, "recurrentgemma-9b": 6}      # arch -> depth


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def probe(arch: str, depth, work: str) -> dict:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    model = init_model(cfg, seed=0, torch_device="cuda", trainable=True)
    opt_cfg = adamw.AdamWConfig(lr_peak=3e-4, warmup_steps=10, total_steps=8)
    state = adamw.init(dict(model.named_parameters()), opt_cfg)
    batch = SyntheticTokenPipeline(DataConfig(cfg.vocab, 256, 8),
                                   torch_device="cuda").batch(0)
    state, _ = train_step(model, state, batch, opt_cfg)          # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, _ = train_step(model, state, batch, opt_cfg)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    mgr = CheckpointManager(work, keep=1)
    t = time.perf_counter()
    train_mod.save_state(mgr, 2, model, state)
    save_s = time.perf_counter() - t
    ckpt_bytes = sum(os.path.getsize(os.path.join(mgr.latest(), f))
                     for f in os.listdir(mgr.latest()))
    t = time.perf_counter()
    train_mod.restore_state(mgr, model)
    restore_s = time.perf_counter() - t
    shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w = time.perf_counter()
        train_step(model, state, batch, opt_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(float(getattr(e, "self_device_time_total", 0) or 0)
               for e in kern) / 1e6
    profiler_s = time.perf_counter() - t
    return dict(arch=arch, layers=cfg.n_layers,
                params=sum(p.numel() for p in model.parameters()),
                batch=8, seq=256, step_s=step_s, checkpoint_bytes=ckpt_bytes,
                save_s=save_s, restore_s=restore_s, profiled_wall_s=wall,
                device_busy_s=busy or None,
                idle_share=(1 - busy / wall) if busy else None,
                device_kernels=sum(e.count for e in kern),
                profiler_s=profiler_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(CASES), action="append")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_state_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    work = os.path.join(REPO, "build", "train_state_probe")
    disk = shutil.disk_usage(os.path.dirname(work) if os.path.isdir(
        os.path.dirname(work)) else REPO)
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    for arch in args.arch or sorted(CASES):
        rec = probe(arch, CASES[arch], work)
        rec.update(disk_free_bytes=disk.free, host_memory_bytes=host,
                   card=card())
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
