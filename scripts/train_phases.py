#!/usr/bin/env python3
"""``chip_smoke.py``'s full-width train phases alone, each timed.

    python3 scripts/train_phases.py

Builds the ``wkv6`` and ``rglru`` kernels, then runs the phases
``train_hybrid``, ``train_moe`` and ``train_ssm`` as the script does
(their records print as there), and after each a line with its seconds;
at the end the peak resident set of the process. The quickest way to
rerun them on the card (about 5 minutes against the whole script's
13). Needs a CUDA device.
"""
from __future__ import annotations

import gc
import os
import resource
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("train_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import chip_smoke as cs
    from repro_torch.kernels.rglru import ops as rops
    from repro_torch.kernels.wkv6 import ops as wops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    t = time.perf_counter()
    wops.build()
    rops.build()
    print(f"build {time.perf_counter() - t:.2f} s", flush=True)
    for phase in (cs.phase_train_hybrid, cs.phase_train_moe,
                  cs.phase_train_ssm):
        t = time.perf_counter()
        phase(card)
        print(f"{phase.__name__} {time.perf_counter() - t:.2f} s; {card}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"peak RSS {peak:.2f} GB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
