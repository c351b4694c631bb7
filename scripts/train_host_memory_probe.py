#!/usr/bin/env python3
"""The host memory that ``chip_smoke.py``'s ``train_ssm`` phase takes
around ``launch/train.py``'s checkpoint saves and restores, on the card.

    python3 scripts/train_host_memory_probe.py

Runs the phase (``rwkv6-3b`` at full width, its checkpoints in host
memory) with a thread that reads the process's resident set
(``VmRSS``) every 50 ms, and prints one line before and after each
``save_state``, ``restore_state``, ``init_model``, the final compare and
the profiled step: the resident set then, and the peak so far with the
step it came in. Ends with the phase's seconds and the peak. Needs a
CUDA device.
"""
from __future__ import annotations

import os
import sys
import threading
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1e6
    return float("nan")


def main() -> int:
    if not torch.cuda.is_available():
        print("train_host_memory_probe: no CUDA device available",
              file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import chip_smoke as cs
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.launch import train as train_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    peak, label = [0.0, "start"], ["start"]

    def sample():
        while True:
            now = rss_gb()
            if now > peak[0]:
                peak[:] = [now, label[0]]
            time.sleep(0.05)

    def mark(what: str) -> None:
        label[0] = what
        print(f"RSS {rss_gb():.2f} GB at {what}; peak so far {peak[0]:.2f} "
              f"GB during {peak[1]}", flush=True)

    def watched(mod, name: str) -> None:
        fn = getattr(mod, name)

        def call(*args, **kw):
            mark("before " + name)
            out = fn(*args, **kw)
            mark("after " + name)
            return out

        setattr(mod, name, call)

    threading.Thread(target=sample, daemon=True).start()
    for name in ("save_state", "restore_state", "init_model"):
        watched(train_mod, name)
    watched(cs, "_same_as_checkpoint")
    watched(cs, "_profiled")
    wops.build()
    card = cs.card_line()
    mark("begin train_ssm")
    t = time.perf_counter()
    cs.phase_train_ssm(card)
    print(f"train_ssm {time.perf_counter() - t:.2f} s; peak RSS "
          f"{peak[0]:.2f} GB during {peak[1]}; {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
