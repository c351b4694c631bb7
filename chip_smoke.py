#!/usr/bin/env python3
"""On-card smoke test of the torch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package. Phases, each printing
one JSON line that carries the card's name and power limit:

1. ``build``    — compile every CUDA kernel of the port's paths from the
   sources in the checkout (``nvcc``, sm_90a, one process per source,
   all started together): ``prefix_select.cu``, ``prefix_segment.cu``,
   ``topology.cu``, ``wkv6.cu``, ``rglru.cu`` and ``systolic_gemm.cu``.
   Then ``launch_floor`` — ``graph_ms`` of an in-place add on a
   one-element tensor: the least time one kernel launch takes in the
   harness that times every kernel. Each kernel phase's record carries
   ``over_floor``, its ``ms`` less this floor.
2. ``kernel``   — ``prefix_select`` on the card against its plain torch
   version on the card, bitwise (``torch.equal``), on the real int64
   tables of workload 1 (single layout) and workloads 1+6 (stacked
   layout), at P = 16, 256, 300, 320, 512, 1024 and 4096 sampled systems
   plus edge rows; kernel and plain times by CUDA events (per call, in a CUDA
   graph and eager), the bound, the launch geometry and the ``ptxas``
   registers and spills.
   Then ``topology_kernel`` — the fused evaluator's ``topology`` kernel
   on the card against its plain torch version on the card, bitwise, at
   P = 512 and 16 in the workload-1 and mesh-NoC/window spaces: the
   launch in a CUDA graph and eager, the whole call, the plain version
   eager, the bound and the ``ptxas`` registers and spills.
3. ``evaluate`` — ``DeviceEvaluator(workload(1))`` on 4096 systems on
   cuda against the same calls on the CPU: tile assignment and reduction
   destinations equal, float outputs within 1e-6 relative; every
   ``_topology`` output of the kernel equal to the plain version's on the
   card, bitwise; one ``topology`` launch an evaluation.
4. ``golden``   — replays ``tests/goldens/device_pt_wl1_t1.json`` on the
   card (rtol 1e-6).
5. ``search``   — the main path: ``Pathfinder(workload(1), "T1")
   .search(ParallelTempering(n_chains=512, sweeps=100), key=0)`` with
   the default normalizer fit, timed, with the kernel launch counts of
   that run; the best design is re-evaluated on the card and on the CPU.
6. ``profile``  — device busy share of a short search window.
7. ``sa_golden`` — replays ``tests/goldens/sa_wl6_t1.json`` through the
   port (``Pathfinder(workload(6), "T1")``, scalar normalizer fit,
   ``SimulatedAnnealing``; rtol 1e-9, evaluations and best design
   equal), timed. Annealing is host code by design: ``random.Random``
   and scalar ``evaluate``.
8. ``pareto``   — the multi-objective path: ``Pathfinder(workload(1),
   "T1").pareto_front(key=0)`` on the card (``ScalarizationSweep()``: 16
   directions x 4 chains, 100 sweeps, per-chain weight rows and the
   exchange pair mask), timed, with sweeps/s, evaluations/s, frontier
   size, hypervolume and the ``prefix_select`` launches of that run;
   the same sweep at 10 sweeps on the card and on the CPU (frontier
   encodings equal, vectors, history and best cost within 1e-6); the
   device busy share of a 5-sweep window.
9. ``strategies`` — ``RandomSearch(batch_size=512)`` at budget 2048 and
   the full ``GridSweep()`` (4 memories x 12 mappings x 43 package
   combinations = 2,064 systems) on the card and on the CPU: best and
   frontier encodings equal, costs within 1e-6; each card run's wall
   time and ``prefix_select`` launches.
10. ``scenario`` — the stacked scenario path: ``Pathfinder(workload(1),
    "T1").run_scenarios(workloads=[workload(1), workload(6)], key=0)``
    on the card (``ScenarioSweep()``: the five default regions x two
    workloads = 10 cells of 8 directions x 4 chains, 40 sweeps, one
    [10 * 32] population a sweep), timed (normalizer fits, the tempering
    loop and the host's per-cell archive feeds inside it, sweeps/s,
    evaluations/s), with each cell's frontier size and
    best cost, the ``prefix_select`` launches of that run (exactly 1 +
    40 + 1) and peak memory; frontier vectors must be finite and the
    cells' frontiers must differ. The same strategy on one cell
    (``world-avg``, workload 1) must launch as many times, and a
    profiled 5-sweep loop at S = 10 may issue at most 1.02x the device
    kernels of S = 1. Then a 10-sweep 5 x 2 grid and a 2-region x 2
    workload grid of ``Region`` specs (price, embodied factor, 24h grid
    and price profiles) on a mesh-NoC + window space, each on the card
    and on the CPU: best designs and frontier encodings equal; history,
    best cost and frontier vectors within 1e-6.
11. ``resume`` — checkpoint/resume: ``DeviceEvaluator.parallel_tempering``
    at the reference benchmark's shape (workload 1, T1, 512 chains x 100
    sweeps, swap 5, seed 11, ``ParetoArchive(256)``) monolithic, in
    50-sweep segments and checkpointed (``SearchCheckpointer``), once
    each, all bit-identical, with ms per save, snapshot bytes and the
    save share of the wall; a run preempted after its
    first snapshot and resumed, bit-identical; ``run_scenarios()`` at its
    defaults in 10-sweep segments, killed in a subprocess after its
    first snapshot (``scripts/torch_resume_worker.py``) and resumed by a
    second one, bit-identical to an uninterrupted run; the card's
    sweep-50 snapshot resumed on the CPU and a CPU snapshot resumed on
    the card, each against both devices' uninterrupted runs: final
    populations equal, floats within 1e-6, best and frontier designs
    equal up to rounding ties (``tests/test_torch_ties.py``'s
    ``assert_same_up_to_ties``: the same points, and at each only
    designs the uninterrupted run holds there or that score within
    1e-13 of one it holds when re-evaluated on the CPU); the two
    uninterrupted runs against each other with equal designs; with the
    ``prefix_select`` launches of the card's runs.
12. ``service`` — ``PathfinderService`` on the card: the six-job table
    of ``scripts/torch_serve_pathfinder.py`` run solo and packed
    (bit-identical), packed on the CPU (designs equal, floats within
    1e-6), then served by a subprocess killed after 9 snapshots and
    resumed by a restarted one (bit-identical to solo); the reference
    serving benchmark's 8 jobs (16 sweeps, segment 2, 4 slots,
    ``norm_samples`` 60) drained by one warm service and by 8 cold ones
    (each building its own engine), jobs/s of each, with the device idle
    share of one profiled tick; 4 jobs of the default
    ``ScalarizationSweep()`` (16 directions x 4 chains, 100 sweeps) in
    one bucket with segment 10: wall, sweeps/s,
    evaluations/s, peak memory; with the ``prefix_select`` launches.
13. ``wkv6_kernel`` — ``wkv6`` on the card against its plain torch
    version on the card, within 1e-6 x M, at the serve phase's shapes:
    prefill (G = 160, T = 512, zero start) as (G, T, D) rows and in the
    model's (B, T, H, D) = (4, 512, 40, 64) layout (y equal to the rows'
    to the bit), decode (G = 160, T = 1, nonzero start; the in-place
    update equal to the bit to the out-of-place one) and an edge case
    (G = 1, T = 37); max errors of ``y`` and ``S_T``, kernel and plain
    times (in a CUDA graph and eager), the bound, the launch geometry and,
    on the first case, the ``ptxas`` registers and spills.
14. ``lm_parity`` — the reduced RWKV-6 at four heads (d_model 256, two
    layers) on cuda against the same weights on the CPU: prefill and
    eight teacher-forced greedy steps (the CPU's tokens fed to both).
15. ``serve``    — the language-model path: ``rwkv6-3b`` at full width in
    float32 through ``repro_torch.launch.serve`` (batch 4, prompt 512,
    32 generated tokens, seeded weights and prompts), timed, with the
    ``wkv6`` launch count of that run (32 + 31 * 32 = 1024) and every
    logit checked finite.
16. ``rglru_kernel`` — ``rglru`` on the card against its plain torch
    version on the card, bitwise (``torch.equal``), at the serve_hybrid
    phase's shapes: prefill (B = 4, T = 3072, C = 4096, zero start),
    decode (T = 1, nonzero start, ``h_out`` aliasing ``h0``), an edge
    case (1, 37, 200) and a ``stage_edge`` case (2, 333, 1000; a start
    state aliased by ``h_out``; a partial ring stage and a partial
    channel block); kernel and plain times (in a CUDA graph and eager),
    the bound, the launch geometry and the ``ptxas`` registers and
    spills.
17. ``hybrid_parity`` — a reduced RecurrentGemma (d_model 256, 4 heads
    of 64, 1 KV head, RG-LRU width 256, 5 layers: one group and the
    2-layer tail, window 32) on cuda against the same weights on the
    CPU: a 48-token prompt (beyond the window, so the ring cache is
    rotated) and eight teacher-forced greedy steps.
18. ``serve_hybrid`` — ``recurrentgemma-9b`` at full width in float32
    through ``repro_torch.launch.serve`` (batch 4, prompt 3072, 1.5x the
    2048 window, 32 generated tokens, seeded weights and prompts), timed,
    with the ``rglru`` launch count of that run (26 RG-LRU layers x 32 =
    832) and every logit checked finite.
19. ``dense_parity`` — the dense family's three variants, ``qwen3-8b``
    (qk-norm), ``qwen2.5-14b`` (QKV bias) and ``smollm-135m`` (tied
    embeddings), reduced and widened to d_model 256 (4 heads of 64, 2
    layers), with every norm weight and bias drawn non-default from a
    seed, on cuda against the same weights on the CPU in float32: a
    48-token prompt and eight teacher-forced greedy steps.
20. ``serve_dense`` — ``qwen3-8b`` at full width (36 layers, d_model
    4096, 32.8 GB of weights) in float32 through
    ``repro_torch.launch.serve`` (batch 4, prompt 1024, 32 generated
    tokens), timed beside the cell's least times (a decode step's
    weight and cache read; the prefill's operations at the float32
    rate, TF32 off), with one decode step profiled after a fresh
    prefill (device busy time and idle share, kernels); no hand-written
    kernel may launch (the path has none) and every logit must be
    finite.
21. ``serve_dense_bf16`` — ``qwen2.5-14b`` at full width (48 layers,
    d_model 5120, 29.5 GB) in bfloat16 (``DTypePolicy.bf16()``; norms,
    attention scores and the softmax in float32), batch 4, prompt 512,
    32 tokens, with its bounds at the bf16 rate; the same checks.
22. ``moe_parity`` — ``deepseek-v2-236b`` (MLA, a leading dense layer,
    top-2 of 8 experts and a shared one) and
    ``llama4-maverick-400b-a17b`` (GQA, a (dense, MoE) group, top-1),
    reduced and widened to d_model 256, every norm weight (MLA's latent
    norms too) drawn non-default, on cuda against the CPU in float32: a
    48-token prompt and eight teacher-forced steps under the
    ``dense_parity`` rule; at every routing call of every step and layer
    each token's experts equal on both devices, or differing only where
    the CPU's k-th and (k+1)-th router logits lie within 1e-5 of the
    row's max |logit| (the near-ties are counted).
23. ``serve_moe`` — ``deepseek-v2-236b`` at full width in bf16, depth cut
    60 -> 8 (the leading dense layer and 7 MoE layers, 29.2 billion
    parameters, 58.4 GB), batch 4, prompt 512, 32 tokens, beside
    ``moe_serve_bound`` (a decode step reads every non-expert weight and
    only the experts it routed to, the distinct experts of each MoE
    layer counted in one step; the all-experts bound reads all 160);
    one decode step's routed experts a layer, host syncs (torch's sync
    debug mode) and profile; no hand-written kernel may launch and every
    logit must be finite.
24. ``serve_moe_gqa`` — ``llama4-maverick-400b-a17b`` the same way, depth
    cut 48 -> 2 (one group, 18.6 billion parameters, 37.1 GB).
25. ``scenario_llm`` — ``ScenarioSweep(ScalarizationSweep(directions=2,
    n_chains=4, sweeps=10), shard=True)`` over
    ``workloads_from_configs(["smollm-135m", "qwen3-8b"])`` (the two
    models' MLP GEMMs x the five default regions), on the card and on
    the CPU: the cells must pass through the one-device scenario mesh
    of each run's device, launch ``prefix_select`` 1 + 10 + 1 times on
    the card, equal the card's ``shard=False`` run bit for bit, and
    agree with the CPU by the ``scenario`` phase's rule.
26. ``train_parity`` — the reduced ``smollm-135m`` widened to d_model
    256 (4 heads of 64, 2 layers) on cuda against the same weights and
    batches on the CPU: the first step's gradients within 1e-5 of each
    leaf's max; five ``train_step``s (AdamW, warmup 2), each step's
    loss, grad norm and lr within 1e-5 relative, the pipelines' tokens
    equal; the parameters after them within 2e-3 of each leaf's max with
    at most 0.1 % of a leaf's elements beyond 1e-5 (Adam moves an element
    whose gradient lies at the float32 noise by ~lr either way); then
    ``chunked_attention``'s output and gradients (causal, non-causal, a
    window of 100; S = 300 in chunks of 128, G = 2) within 1e-5.
27. ``train`` — ``smollm-135m`` at full width and depth in float32
    through ``repro_torch.launch.train.train`` (batch 8, seq 256, 30
    steps, remat), once with checkpoints every 10 steps and fault seed 11
    at rate 0.12 (step 19 fails once and replays from step 10) and once
    fault-free, both under ``torch.use_deterministic_algorithms(True)``:
    the loss must fall, a restart must happen, and the two runs must end
    with equal parameters and moments; step p50 and p90, tokens/s, peak
    memory, one profiled step (device busy time, idle share, kernels)
    and its AdamW update profiled alone, and the step's least time (``lm_step_bound``: 6 operations a matrix
    weight a token and the causal attention's products, at the float32
    rate, TF32 off) with the share of it reached. No hand-written kernel
    may launch.
28. ``vlm_audio_parity`` — the reduced ``internvl2-26b`` and
    ``hubert-xlarge`` widened to d_model 256, every norm weight drawn
    non-default, on cuda against the CPU in float32: ``forward`` on a
    4-row patch prefix and 48 tokens (vlm) and on 64 frame embeddings
    (audio, bidirectional) within 1e-4 of max |logit|, and the vlm
    backbone's prefill and eight teacher-forced steps under the
    ``dense_parity`` rule.
29. ``vlm`` — ``internvl2-26b`` at full width and depth in bf16
    (19,861,260,288 parameters, 39.7 GB): ``prefill_step`` on the token
    stream (batch 4, prompt 512), 32 ``serve_step``s, then ``forward`` of
    one sequence of a 256-row stub patch prefix drawn by numpy and 512
    tokens; times beside ``dense_serve_bound`` and ``lm_step_bound``,
    peak memory, every logit finite, no hand-written kernel launched.
30. ``audio`` — ``hubert-xlarge`` at full width in float32, built to
    train: ``eval_step`` on 4 x 2048 stub frame embeddings, then two
    ``train_step``s on 2 x 1024 frames with frame labels; times beside
    ``lm_step_bound``, peak memory, outputs, loss and grad norm finite,
    no hand-written kernel launched.
31. ``gemm_kernel`` — the systolic GEMM path: first every case once
    through ``systolic_gemm`` (its output within tolerance of
    ``gemm_plain``), with the launch count of each of the four kernel
    sites, and of each site's path ("simt", "wgmma"), over that run;
    then each case's kernel (``os_gemm``, ``os_gemm_splitk``,
    ``ws_gemm_partials`` or ``is_gemm_partials``, on the path
    ``kernel_path`` names) on the padded operands against its plain
    version on the card, within 1e-5 x Mag for float32 outputs and slabs
    and 2^-7 x Mag for 16-bit outputs (Mag = max_mn sum_k |a_mk| |b_kn|,
    per slab), and four times, each from 50 calls in one CUDA graph: the
    kernel alone (preallocated output), the whole ``systolic_gemm``, the
    plain version and ``torch.matmul`` (TF32 off); WS/IS rows also give
    ``bmm_ms``, ``torch.bmm`` over the same k-block views (the one
    PyTorch call that computes the slabs; in 16-bit it writes 16-bit
    slabs, an easier yardstick); with the bound on the true shape, the
    padded shape and its work factor. 16-bit cases at the 128^3 tile
    must take "wgmma" at every site. Cases (69): the six Table IV
    workloads in float32 at the 128^3 tile under OS, OS split-K 2 and 4,
    WS and IS; bfloat16 at WL1 and WL2 under OS, OS split-K 2, WS and IS;
    the reference tests' tile sweep at WL1; ``rwkv6-3b``'s channel-mix
    key product at the serve cell's prefill (2048 x 2560 x 8960) under
    the five settings in float32 and under OS, OS split-K 2, WS and IS in
    bfloat16; float16 OS and WS at WL2.
32. ``prefix_segment_kernel`` — ``prefix_segment_gather`` once per case
    (the launch count of that run, by kernel: the unrolled and the
    grouped kernel must both have run), bitwise against its plain version
    on the card: the workload-1 int64 cycles plane and its float64 copy
    at P = 512 and 4096 (C = 6), a synthetic int32 table (64 x 1025,
    P = 4096), a float64 table of non-integer values (P = 4096), a
    float32 one at C = 9 (P = 512) and one system of one slot on one row;
    kernel and plain times (in a CUDA graph and eager), the eager time of
    the whole public call, the bound, the launch geometry and the
    ``ptxas`` registers and spills (a spill fails the phase).

33. ``train_grad_kernels`` — the autograd nodes of ``rglru`` (backward:
    the adjoint recurrence, the same kernel over the reversed sequence)
    and ``wkv6`` (backward: the plain recurrence recomputed under
    autograd) on the card against autograd through their plain versions
    on the card, at (B, T, C) = (8, 256, 4096) and (B, T, H, D) = (8,
    256, 40, 64), with and without a start state, under cotangents of
    the sequence and of the final state: every gradient within 1e-5 of
    its max |value|; forward and backward times, the memory the ``wkv6``
    backward adds, and ``rglru``'s reverse launch alone in a CUDA graph
    beside its bound.
34. ``train_families_parity`` — the reduced ``deepseek-v2-236b``,
    ``llama4-maverick-400b-a17b`` and ``rwkv6-3b`` widened to d_model
    256, and ``recurrentgemma-9b`` widened to 256 at 5 layers (one
    group and the 2-layer tail), every norm weight and bias drawn
    non-default, on cuda against the CPU in float32 (batch 4 x 64): the
    first step's gradients (remat on) within 1e-5 of each leaf's max,
    one ``train_step``'s loss, grad norm and lr within 1e-5 relative;
    routing by ``moe_parity``'s near-tie rule with at least one pair over
    the experts' capacity; ``wkv6`` / ``rglru`` launched.
35. ``train_ssm`` — ``rwkv6-3b`` at full width and depth in float32
    (batch 8 x 256, 4 steps) through ``launch/train.py``'s ``train``,
    its checkpoints kept in host memory by a stand-in for its
    ``CheckpointManager`` (a 37.2 GB save to disk took 64 s and the
    card's disk had 80.2 GB free): once with fault seed 11 at rate 0.7
    and a checkpoint every 2 steps (steps 1, 2 and 3 fail once each;
    step 1 restarts from the initial weights, steps 2 and 3 restore the
    step-2 checkpoint, and step 3's restart replays step 2), once
    fault-free, both under deterministic algorithms: a restart must
    restore a checkpoint after step 0 and replay a step, the loss must
    fall, the fault-free run's parameters, moments and step must equal
    the faulty run's last checkpoint to the bit, and ``wkv6`` must
    launch twice a layer an executed step (the forward and remat's
    recompute); step p50 and p90, tokens/s, peak memory, the extended
    ``lm_step_bound`` and one profiled step of a 2-layer cut.
36. ``train_hybrid`` — ``recurrentgemma-9b`` at full width cut to 6
    layers (two whole groups) the same way at a peak lr of 3e-4 (at 3e-3
    it diverges, ROADMAP R12); ``rglru`` must launch three
    times a recurrent layer an executed step (forward, recompute, the
    backward's reverse launch); one profiled step of the 6 layers.
37. ``train_moe`` — both moe configs at ``_widened`` width (d_model
    256) the same way (batch 8 x 256, 30 steps, checkpoints every 10,
    rate 0.12: step 19 fails once and replays from the step-10
    checkpoint): the capacity drops are counted (at least one); no
    hand-written kernel may launch; then the table of train-state sizes
    against the card that sets this width and ``train_hybrid``'s depth.
    A ``train_time`` line gives the seconds of phases 33-37.
38. ``dryrun`` — the counted work of a step (``repro_torch.analysis``:
    one ``TorchDispatchMode`` counts FLOPs, bytes, collectives and live
    bytes op by op; ``wkv6`` and ``rglru`` by their formulas): (a)
    ``launch/dryrun.py``'s cells on meta for one arch of each family at
    train_4k and decode_32k (the ssm family's train_4k aside: its plain
    WKV backward takes ~110 s of host time on meta), every record ok or
    skipped; (b) ``smollm-135m``'s train step (8 x 256),
    ``qwen3-8b``'s decode step (batch 4, cache 1024 + 32) and
    ``rwkv6-3b``'s prefill (4 x 512, through the ``wkv6`` kernel),
    float32, each counted on the card and on meta: FLOPs and bytes
    equal to the unit; the CUDA-event median step time beside the
    counted roofline bound and its share (``mfu_counted_bound``), the
    model-FLOPs utilization, the hand-counted bound, and the counted
    peak of live bytes beside ``torch.cuda.max_memory_allocated``.
    (a) also counts one production-mesh cell, ``smollm-135m`` train_4k on
    the 16 x 16 single pod, one rank of a fake 256-rank process group
    in its own worker (``dryrun.run_mesh_cell``): ok, per-device bytes.
39. ``mesh_one`` — the multi-rank paths over NCCL at world size 1 (a
    process group of this one process, after ``scenario_llm``): (i)
    ``scenario_llm``'s grid with ``shard=True``, whose mesh is now the
    group's one-rank ``DeviceMesh``, equal to ``shard=False`` bit for
    bit (its ``prefix_select`` launches count in the kernels line);
    (ii) the reduced ``smollm-135m`` train step built on a 1 x 1 cuda
    ``DeviceMesh`` (parameters, moments and batch as DTensors) against
    the plain step, three steps under deterministic algorithms: losses
    and parameters bit for bit, or within 1e-6 of each leaf's max (the
    record says which).
40. ``ep_shards`` — the expert-parallel split on the card: ``_ep_shard``
    of ranks 0-3 of the reduced ``deepseek-v2-236b``'s first MoE layer,
    summed, exact and with the capacity drops, within 1e-5 of max |y|
    of the same sums on the CPU; the exact sum plus the shared experts
    within 1e-5 of ``moe_forward(exact=True)`` on the card.
A ``seconds`` line gives the whole script's time.

Then a line with the card (``nvidia-smi``), the ``kernels`` JSON line (the
``prefix_select`` launches are those of the search, pareto, strategies,
scenario, resume, service, scenario_llm and mesh_one phases; the ``wkv6`` and
``rglru`` launches those of ``serve`` and ``train_ssm``, of
``serve_hybrid`` and ``train_hybrid``) and, last,
``{"ok": true, "device": {...}}``. Any failure raises and the
script exits non-zero without that last line. Without CUDA, or outside a
checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
# the H100's rates and the hand-counted step bounds; outside a checkout
# of the repository this import fails and the script exits non-zero
from repro_torch.analysis.roofline import (  # noqa: E402
    H100,
    dense_serve_bound,
    lm_step_bound,
    moe_serve_bound,
)

TOL = 1e-6
WKV_TOL = 1e-6                 # of the recurrence's magnitude M (phase_wkv6)
LM_TOL = 1e-4                  # of max |logit|, cuda vs CPU (_decode_parity)
# of Mag = max_mn sum_k |a_mk| |b_kn| (phase_gemm), by output dtype
GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -7}
GEMM_SETTINGS = (("OS", 1), ("OS", 2), ("OS", 4), ("WS", 1), ("IS", 1))
GEMM_TILES = ((64, 64, 64), (32, 64, 32), (32, 32, 32), (64, 128, 32),
              (128, 64, 96))
DEV = "cuda"                   # the card the phases run on
# phase kernel: systems P of prefix_select, in both layouts
# 16: a service tick, 4 slots x 4 chains; 320: the scenario grid, 10 x 32
KERNEL_PS = (16, 256, 300, 320, 512, 1024, 4096)
# phase rglru_kernel: (shape, (B, T, C), a start state, which the kernel
# updates in place)
RGLRU_SHAPES = (("prefill", (4, 3072, 4096), False),
                ("decode", (4, 1, 4096), True),
                ("edge", (1, 37, 200), False),
                ("stage_edge", (2, 333, 1000), True))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Per-call device time of ``iters`` calls captured in one CUDA graph
    and replayed: the host's issue time drops out, leaving the kernels'
    own run plus the gaps between them."""
    if DEV != "cuda":
        return cuda_ms(fn, iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    return cuda_ms(g.replay, iters=5, warmup=2) / iters


FLOOR = {}                     # phase_launch_floor's result


def phase_launch_floor(card: str) -> dict:
    """The least time one kernel launch takes in the harness that times
    every kernel: ``graph_ms`` of an in-place add on a one-element
    tensor. Each kernel record's ``over_floor`` is its ``ms`` less this."""
    x = torch.zeros(1, device=DEV)
    rec = dict(phase="launch_floor", floor_ms=graph_ms(lambda: x.add_(1)),
               eager_ms=cuda_ms(lambda: x.add_(1)), card=card)
    FLOOR["ms"] = rec["floor_ms"]
    emit(rec)
    return rec


def with_floor(rec: dict) -> dict:
    """``rec`` with ``over_floor``: its ``ms`` above the launch floor."""
    rec["over_floor"] = rec["ms"] - FLOOR["ms"]
    return rec


# ---------------------------------------------------------------------------
# kernel phase: prefix_select against its plain version
# ---------------------------------------------------------------------------


def _padded(pref, bucket: int):
    """Edge-pad a ``[F, R, T+1]`` table's tile axis to ``bucket + 1``."""
    pad = bucket + 1 - pref.shape[-1]
    return torch.cat([pref, pref[..., -1:].expand(*pref.shape[:-1], pad)],
                     dim=-1)


def _bucket(t: int) -> int:
    return max(64, 1 << (int(t) - 1).bit_length())


def kernel_inputs(layout: str, P: int, seed: int, dev):
    """Tables, indices and bounds for one prefix_select call, from
    systems drawn by DesignSpace.sample and assigned by Algorithm 1,
    with edge rows appended (ranges outside [0, T], empty ranges, both
    split values)."""
    from repro_torch.core import workload
    from repro_torch.pathfinding.device import DeviceEvaluator, _slots
    from repro_torch.pathfinding.space import COL_DATAFLOW, COL_SPLITK

    wls = [workload(1)] if layout == "single" else [workload(1),
                                                    workload(6)]
    evs = [DeviceEvaluator(wl, torch_device=dev) for wl in wls]
    cfg = evs[0].cfg
    if layout == "single":
        p0, p1 = evs[0].tables["pref0_flat"], evs[0].tables["pref1_flat"]
    else:
        # the workload-stacked layout: each workload's tables edge-padded
        # to a shared tile bucket, concatenated along rows
        b0 = _bucket(max(e.cfg.T0 for e in evs))
        b1 = _bucket(max(e.cfg.T1 for e in evs))
        p0 = torch.cat([_padded(e.tables["pref0_flat"], b0) for e in evs], 1)
        p1 = torch.cat([_padded(e.tables["pref1_flat"], b1) for e in evs], 1)
    rng = np.random.default_rng(seed)
    enc = evs[0].space.sample(P, key=int(rng.integers(1 << 30)))
    wi = (np.zeros(P, np.int64) if layout == "single"
          else rng.integers(0, len(wls), P))
    starts, ends = [], []
    for k, ev in enumerate(evs):
        st = _slots(ev._enc(enc), ev.tables, ev.cfg)
        starts.append(st["start"].cpu().numpy())
        ends.append(st["end"].cpu().numpy())
        if k == 0:
            a = st["a_idx"].cpu().numpy()
            s = st["s_idx"].cpu().numpy()
    start = np.choose(wi[:, None], starts)
    end = np.choose(wi[:, None], ends)
    rows = ((a * cfg.S + s) * 3 + enc[:, COL_DATAFLOW][:, None]
            + wi[:, None] * cfg.A * cfg.S * 3)
    split = enc[:, COL_SPLITK].astype(np.int64)
    t0 = np.array([evs[w].cfg.T0 for w in wi])
    t1 = np.array([evs[w].cfg.T1 for w in wi])
    # edge rows: out-of-range starts/ends, empty ranges, both splits
    m = min(64, P // 4)
    C = rows.shape[1]
    start[:m] = rng.integers(-8, t1[:m, None] + 16, (m, C))
    end[:m] = rng.integers(-8, t1[:m, None] + 16, (m, C))
    end[:m // 2, ::2] = start[:m // 2, ::2]
    split[:m] = np.arange(m) % 2

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=dev)

    i32 = torch.int32
    return (p0.contiguous(), p1.contiguous(), t(rows, i32),
            t(start, i32), t(end, i32), t(split, i32), t(t0, i32),
            t(t1, i32))


def segment_inputs(P: int, seed: int, dev, dtype=torch.int64):
    """One ``prefix_segment_gather`` call on real data: the workload-1
    cycles plane ``[R, T+1]`` of the single-layout table that
    :func:`kernel_inputs` builds, in ``dtype``, with its rows and its
    ranges clipped into ``[0, T]`` (the kernel does not clip)."""
    p0, _, rows, start, end, _, t0, _ = kernel_inputs("single", P, seed, dev)
    t = t0[:, None]
    start = torch.minimum(start.clamp(min=0), t).contiguous()
    end = torch.minimum(end.clamp(min=0), t).contiguous()
    return p0[0].to(dtype).contiguous(), rows, start, end


def kernel_bound(args) -> dict:
    """Least time for the work: the distinct table entries this run's
    inputs touch, the indices read once, the outputs written once, over
    HBM bandwidth; against one subtract + one add per output over the
    non-tensor-core rate."""
    p0, p1, rows, start, end, split, t0, t1 = args
    F, R = p0.shape[:2]
    P, C = rows.shape
    sp = (split == 1)[:, None]
    t = torch.where(sp, t1[:, None], t0[:, None]).long()
    s = torch.minimum(start.long().clamp(min=0), t)
    e = torch.minimum(end.long().clamp(min=0), t)
    which = sp.long().expand(P, C)
    ids = []
    for idx in (s, e):
        flat = (which * R + rows.long()) * 4096 + idx  # T_b + 1 <= 4096
        ids.append(flat.reshape(-1))
    if max(p0.shape[2], p1.shape[2]) > 4096:
        raise ValueError("tile axis longer than the id packing allows")
    n_entries = int(torch.unique(torch.cat(ids)).numel()) * F
    nbytes = (n_entries * 8 + (3 * P * C + 3 * P) * 4
              + (P * C * F + P * F) * 8)
    ops = 2 * P * C * F
    t_bytes = nbytes / H100.hbm_bytes_per_s * 1e3
    t_ops = ops / H100.fp32_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def phase_kernel(card: str) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.kernels.prefix_gather import prefix_select_plain

    lib = kops.build()
    regs = _ptxas_regs(_build.ptxas_report(kops.SOURCE))
    main = None
    worst = 0
    for layout in ("single", "stacked"):
        for P in KERNEL_PS:
            args = kernel_inputs(layout, P, seed=P, dev=DEV)
            sel_k, tot_k = kops.prefix_select(*args)
            sel_p, tot_p = prefix_select_plain(*args)
            torch.cuda.synchronize()
            equal = torch.equal(sel_k, sel_p) and torch.equal(tot_k, tot_p)
            err = int(max((sel_k - sel_p).abs().max(),
                          (tot_k - tot_p).abs().max()))
            worst = max(worst, err)
            if not equal:
                raise AssertionError(
                    f"prefix_select != plain ({layout}, P={P}): max abs "
                    f"err {err}")
            p0, p1, rows, start, end, split, t0, t1 = args
            Pn, C = rows.shape
            F = p0.shape[0]
            sel = torch.empty((Pn, C, F), dtype=torch.int64, device=DEV)
            tot = torch.empty((Pn, F), dtype=torch.int64, device=DEV)
            def launch():
                # the current stream is read per call, so a CUDA-graph
                # capture records the launch on its capture stream
                stream = torch.cuda.current_stream().cuda_stream
                rc = lib.prefix_select_launch(
                    p0.data_ptr(), p1.data_ptr(), p0.shape[1], p0.shape[2],
                    p1.shape[2], F, rows.data_ptr(), start.data_ptr(),
                    end.data_ptr(), split.data_ptr(), t0.data_ptr(),
                    t1.data_ptr(), Pn, C, sel.data_ptr(), tot.data_ptr(),
                    stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            # ms: the device time per call, from a CUDA-graph replay;
            # eager_ms: back-to-back calls from Python, where host issue
            # can dominate a kernel this small
            plain = lambda: prefix_select_plain(*args)  # noqa: E731
            rec = dict(phase="kernel", kernel="prefix_select", layout=layout,
                       P=P, equal=equal, max_abs_err=err,
                       ms=graph_ms(launch), plain_ms=graph_ms(plain),
                       eager_ms=cuda_ms(launch), plain_eager_ms=cuda_ms(plain),
                       **kernel_bound(args), geometry=kops.geometry(Pn, C, F),
                       ptxas_regs=regs, card=card)
            emit(with_floor(rec))
            if layout == "single" and P == 512:
                main = rec
    main = dict(main, max_abs_err=worst)
    return main


# ---------------------------------------------------------------------------
# topology phase: the topology kernel against its plain version
# ---------------------------------------------------------------------------

TOPOLOGY_SPACES = {"wl1": (1, "legacy", "fixed"),
                   "wl6": (6, "mesh_noc", "window")}


def topology_bound(v, areas, tb, out) -> dict:
    """Least time for one ``topology`` launch: the six columns of each
    row it reads, its areas and the four tables read once and every
    output written once, over HBM bandwidth. Its operations (a few
    thousand float64 and integer steps a row) would take far less."""
    from repro_torch.kernels.topology.ops import LAYOUT

    nbytes = (v.shape[0] * (len(LAYOUT) - 4) * 8
              + areas.numel() * areas.element_size()
              + sum(tb[k].numel() * tb[k].element_size()
                    for k in ("m_bw", "p25", "p25_interp", "p3"))
              + sum(t.numel() * t.element_size() for t in out.values()))
    return dict(bound_ms=nbytes / H100.hbm_bytes_per_s * 1e3,
                bound_by="bytes", bytes=nbytes)


def phase_topology(card: str) -> dict:
    """The kernel at the search's population (P = 512) and a service
    tick's (P = 16) in both benchmark spaces, bitwise against the plain
    version on the card: the launch alone in a CUDA graph (``ms``) and
    eager, the whole public call with its bonding tail (``call_ms``),
    and the plain version eager (``plain_eager_ms``; its uploads of the
    pair lists cannot be captured in a graph)."""
    from repro_torch.core import workload
    from repro_torch.kernels import _build
    from repro_torch.kernels.topology import ops as tops
    from repro_torch.kernels.topology import topology_plain
    from repro_torch.pathfinding import DesignSpace, DeviceEvaluator
    from repro_torch.pathfinding.device import _slots

    lib = tops.build()
    regs = _ptxas_regs(_build.ptxas_report(tops.SOURCE))
    main = None
    for name, (wl, comm, sched) in TOPOLOGY_SPACES.items():
        ev = DeviceEvaluator(workload(wl), torch_device=DEV,
                             space=DesignSpace(comm=comm, schedule=sched))
        tb, cfg = ev.tables, ev.cfg
        for P in (512, 16):
            v = ev._enc(ev.space.sample(P, key=P + wl))
            areas = _slots(v, tb, cfg)["areas"]
            got = tops.topology(v, areas, tb, cfg)
            want = topology_plain(v, areas, tb, cfg)
            for k, x in got.items():
                if not torch.equal(x, want[k]):
                    raise AssertionError(f"topology ({name}, P={P}): output "
                                         f"{k} != plain")
            out = tops.empty_outputs(P, cfg.C, cfg.L, DEV)

            def launch():
                rc = tops.launch(lib, v, areas, tb, cfg, out)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            def call():
                return tops.topology(v, areas, tb, cfg)

            def plain():
                return topology_plain(v, areas, tb, cfg)

            rec = dict(phase="topology_kernel", kernel="topology",
                       space=name, P=P, C=cfg.C, equal=True, max_abs_err=0,
                       ms=graph_ms(launch), eager_ms=cuda_ms(launch),
                       call_ms=cuda_ms(call),
                       plain_eager_ms=cuda_ms(plain, iters=10, warmup=2),
                       **topology_bound(v, areas, tb, out),
                       ptxas_regs=regs, card=card)
            emit(with_floor(rec))
            if name == "wl1" and P == 512:
                main = rec
    return main


# ---------------------------------------------------------------------------
# evaluate / golden / search phases
# ---------------------------------------------------------------------------


def _allclose(name, got, ref, rtol=TOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: shape {got.shape} vs {ref.shape} or "
                             "non-finite values")
    dev = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
    dev = np.where(got == ref, 0.0, dev)
    worst = float(dev.max()) if dev.size else 0.0
    if worst > rtol:
        raise AssertionError(f"{name}: max rel deviation {worst} > {rtol}")
    return worst


def phase_evaluate(card: str) -> dict:
    from repro_torch.core import TEMPLATES, workload
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.kernels.topology import ops as tops
    from repro_torch.kernels.topology import topology_plain
    from repro_torch.pathfinding import (
        DeviceEvaluator,
        MetricsBatch,
        fit_normalizer_batched,
    )
    from repro_torch.pathfinding.device import _slots, _topology

    wl = workload(1)
    gpu = DeviceEvaluator(wl, torch_device=DEV)
    cpu = DeviceEvaluator(wl, torch_device="cpu")
    enc = gpu.space.sample(4096, key=11)
    norm = fit_normalizer_batched(wl, samples=400, seed=7,
                                  torch_device="cpu")
    tmpl = TEMPLATES["T1"]
    kops.reset_launch_count()
    tops.reset_launch_count()
    t = time.perf_counter()
    mb_g, cost_g, vec_g = gpu.evaluate_cost_vector(enc, norm, tmpl)
    gpu_s = time.perf_counter() - t
    launches = kops.launch_count()
    if launches < 1:
        raise AssertionError("evaluate on cuda did not launch prefix_select")
    if tops.launch_count() != 1:
        raise AssertionError(f"evaluate on cuda launched topology "
                             f"{tops.launch_count()} times, not once")
    mb_c, cost_c, vec_c = cpu.evaluate_cost_vector(enc, norm, tmpl)
    met_g, met_c = gpu.metrics(enc), cpu.metrics(enc)
    worst = 0.0
    for f in MetricsBatch.__dataclass_fields__:
        worst = max(worst, _allclose(f, getattr(mb_g, f), getattr(mb_c, f)),
                    _allclose(f, getattr(met_g, f), getattr(met_c, f)))
    worst = max(worst, _allclose("cost", cost_g, cost_c),
                _allclose("vec", vec_g, vec_c))
    ints = {}
    for name, ev in (("gpu", gpu), ("cpu", cpu)):
        v = ev._enc(enc)
        st = _slots(v, ev.tables, ev.cfg)
        topo = _topology(v, st["areas"], ev.tables, ev.cfg)
        ints[name] = [x.cpu().numpy() for x in
                      (st["start"], st["end"], topo["dest"], topo["hops"])]
        if name == "gpu":
            # every output of the kernel against the plain version on the
            # same card, bitwise
            plain = topology_plain(v, st["areas"], ev.tables, ev.cfg)
            for k, x in topo.items():
                y = plain[k]
                if (x.dtype, x.shape, x.stride()) != (y.dtype, y.shape,
                                                      y.stride()) or \
                        not torch.equal(x, y):
                    raise AssertionError(f"topology output {k}: kernel != "
                                         "plain on the card")
    for a, b, what in zip(ints["gpu"], ints["cpu"],
                          ("start", "end", "dest", "hops")):
        if not np.array_equal(a, b):
            raise AssertionError(f"integer output {what} differs cuda/cpu")
    torch.cuda.synchronize()
    rec = dict(phase="evaluate", P=len(enc), max_rel_dev=worst,
               ints_equal=True, topology_equal=True,
               kernel_launches=launches, topology_launches=1,
               gpu_eval_s=gpu_s, card=card)
    emit(rec)
    return rec


def phase_golden(card: str) -> dict:
    from repro_torch.core import TEMPLATES, workload
    from repro_torch.pathfinding import (
        DesignSpace,
        ParallelTempering,
        Pathfinder,
        fit_normalizer_batched,
    )

    with open(os.path.join(REPO, "tests", "goldens",
                           "device_pt_wl1_t1.json")) as f:
        golden = json.load(f)
    space = DesignSpace()
    wl = workload(1)
    norm = fit_normalizer_batched(wl, samples=400, seed=7, space=space,
                                  torch_device=DEV)
    pf = Pathfinder(wl, TEMPLATES["T1"], norm=norm, space=space,
                    torch_device=DEV)
    t = time.perf_counter()
    res = pf.search(ParallelTempering(n_chains=4, sweeps=20), key=3)
    wall = time.perf_counter() - t
    if len(res.frontier) < 3:
        raise AssertionError(f"golden frontier too small: {len(res.frontier)}")
    got = {"history": res.history, "best_cost": res.best_cost,
           "evaluations": res.evaluations,
           "frontier_latency_min": float(res.frontier.vectors[:, 0].min()),
           "frontier_cfp_min": float(res.frontier.vectors[:, 2].min())}
    if got["evaluations"] != golden["evaluations"]:
        raise AssertionError("golden evaluations differ")
    worst = 0.0
    for k in ("history", "best_cost", "frontier_latency_min",
              "frontier_cfp_min"):
        worst = max(worst, _allclose(f"golden.{k}", np.asarray(got[k]),
                                     np.asarray(golden[k])))
    rec = dict(phase="golden", max_rel_dev=worst,
               frontier=len(res.frontier), wall_s=wall, card=card)
    emit(rec)
    return rec


def phase_search(card: str) -> dict:
    from repro_torch.core import workload
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.kernels.topology import ops as tops
    from repro_torch.pathfinding import (
        DeviceEvaluator,
        ParallelTempering,
        Pathfinder,
    )

    n_chains, sweeps = 512, 100
    pf = Pathfinder(workload(1), "T1", torch_device=DEV)
    torch.cuda.synchronize()
    t = time.perf_counter()
    norm = pf.norm                       # default fit: 2000 samples
    fit_s = time.perf_counter() - t
    strat = ParallelTempering(n_chains=n_chains, sweeps=sweeps)
    kops.reset_launch_count()
    tops.reset_launch_count()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = pf.search(strat, key=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"prefix_select": kops.launch_count(),
                "topology": tops.launch_count()}
    if launches["prefix_select"] < 1:
        raise AssertionError("search did not launch prefix_select")
    if launches["topology"] != sweeps + 1:     # one an evaluation
        raise AssertionError(f"search launched topology "
                             f"{launches['topology']} times")
    if not (math.isfinite(res.best_cost) and len(res.history) == sweeps + 1
            and res.evaluations == n_chains * (sweeps + 1)
            and len(res.frontier) > 0):
        raise AssertionError(f"search output malformed: {res!r}")
    best = pf.space.encode(res.best)[None]
    costs = {}
    for dev in (DEV, "cpu"):
        ev = DeviceEvaluator(pf.wl, space=pf.space, torch_device=dev)
        costs[dev] = float(ev.evaluate_cost(best, norm, pf.template)[1][0])
    for dev, c in costs.items():
        if abs(c - res.best_cost) > TOL * abs(res.best_cost):
            raise AssertionError(
                f"best re-evaluated on {dev}: {c} != {res.best_cost}")
    vec = res.frontier.vectors
    if not np.all(np.isfinite(vec)):
        raise AssertionError("non-finite frontier vectors")
    rec = dict(phase="search", n_chains=n_chains, sweeps=sweeps,
               fit_s=fit_s, wall_s=wall, sweeps_per_s=sweeps / wall,
               evals_per_s=res.evaluations / wall, best_cost=res.best_cost,
               best_cost_cuda=costs[DEV], best_cost_cpu=costs["cpu"],
               frontier=len(res.frontier), launches=launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    emit(rec)
    return rec


def _profiled(fn) -> dict:
    """Wall time and device busy share of one call of ``fn`` (warmed
    first), from torch.profiler (``null`` shares when the tracer reports
    no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()                                       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # device-side events only (their self time is the kernel's run)
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = sum(float(getattr(e, "self_device_time_total", 0) or 0)
                 for e in kern)
    top = sorted(kern, key=lambda e: -float(
        getattr(e, "self_device_time_total", 0) or 0))[:8]
    return dict(wall_s=wall,
                device_busy_s=dev_us / 1e6 if dev_us else None,
                idle_share=(1 - dev_us / 1e6 / wall) if dev_us else None,
                device_kernels=sum(e.count for e in kern),
                top=[(e.key[:80], e.count,
                      float(getattr(e, "self_device_time_total", 0) or 0))
                     for e in top])


def phase_profile(card: str) -> dict:
    """Device busy share of a short steady search window."""
    from repro_torch.core import workload
    from repro_torch.pathfinding import ParallelTempering, Pathfinder

    pf = Pathfinder(workload(1), "T1", torch_device=DEV)
    pf.norm
    strat = ParallelTempering(n_chains=512, sweeps=5, frontier_size=0)
    rec = dict(phase="profile", n_chains=512, sweeps=5,
               **_profiled(lambda: pf.search(strat, key=1)), card=card)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# sa_golden / pareto / strategies phases: the rest of the search strategies
# ---------------------------------------------------------------------------


def phase_sa_golden(card: str) -> dict:
    """``tests/goldens/sa_wl6_t1.json`` through the port, driven as
    ``tests/test_goldens.py`` drives the reference. Simulated annealing
    is host code by design (``random.Random`` and scalar ``evaluate``
    through the SimCache): the card runs nothing here."""
    from repro_torch.core import TEMPLATES, SAConfig, workload
    from repro_torch.pathfinding import Pathfinder, SimulatedAnnealing

    with open(os.path.join(REPO, "tests", "goldens", "sa_wl6_t1.json")) as f:
        golden = json.load(f)
    pf = Pathfinder(workload(6), TEMPLATES["T1"], torch_device=DEV)
    t = time.perf_counter()
    pf.fit_normalizer(samples=200, seed=1, method="scalar")
    fit_s = time.perf_counter() - t
    cfg = SAConfig(t_initial=50.0, t_final=0.05, cooling=0.85,
                   moves_per_temp=15, seed=2)
    t = time.perf_counter()
    res = pf.search(SimulatedAnnealing(cfg))
    wall = time.perf_counter() - t
    if res.evaluations != golden["evaluations"]:
        raise AssertionError(f"sa golden evaluations {res.evaluations} != "
                             f"{golden['evaluations']}")
    if res.best.describe() != golden["best"]:
        raise AssertionError(f"sa golden best {res.best.describe()!r}")
    worst = max(_allclose("sa_golden.history", res.history,
                          golden["history"], rtol=1e-9),
                _allclose("sa_golden.best_cost", res.best_cost,
                          golden["best_cost"], rtol=1e-9))
    rec = dict(phase="sa_golden", path="host", max_rel_dev=worst,
               evaluations=res.evaluations, fit_s=fit_s, wall_s=wall,
               evals_per_s=res.evaluations / wall, card=card)
    emit(rec)
    return rec


def _same_result(name: str, got, ref, space) -> float:
    """Two runs of one strategy agree: best design and frontier
    encodings equal, costs and frontier vectors within TOL."""
    if not np.array_equal(space.encode(got.best), space.encode(ref.best)):
        raise AssertionError(f"{name}: best designs differ cuda/cpu")
    if got.evaluations != ref.evaluations:
        raise AssertionError(f"{name}: evaluations differ cuda/cpu")
    if not np.array_equal(got.frontier.encoded, ref.frontier.encoded):
        raise AssertionError(f"{name}: frontier encodings differ cuda/cpu")
    return max(_allclose(f"{name}.best_cost", got.best_cost, ref.best_cost),
               _allclose(f"{name}.history", got.history, ref.history),
               _allclose(f"{name}.frontier", got.frontier.vectors,
                         ref.frontier.vectors))


def phase_pareto(card: str) -> dict:
    """The slice's main path: ``Pathfinder(workload(1), "T1")
    .pareto_front()`` on the card (``ScalarizationSweep()``: 16
    directions x 4 chains, 100 sweeps), with the ``prefix_select``
    launches of that run; then the same sweep at 10 sweeps on the card
    and on the CPU, and a profiled 5-sweep window."""
    from repro_torch.core import workload
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.pathfinding import Pathfinder, ScalarizationSweep

    pf = Pathfinder(workload(1), "T1", torch_device=DEV)
    t = time.perf_counter()
    norm = pf.norm                       # default fit: 2000 samples
    fit_s = time.perf_counter() - t
    strat = ScalarizationSweep()
    chains = strat.directions * strat.n_chains
    evals = chains * (strat.sweeps + 1)
    kops.reset_launch_count()
    torch.cuda.synchronize()
    t = time.perf_counter()
    front = pf.pareto_front(key=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"prefix_select": kops.launch_count()}
    if launches["prefix_select"] < 1:
        raise AssertionError("pareto did not launch prefix_select")
    vec = front.vectors
    if len(front) < 1 or not np.all(np.isfinite(vec)):
        raise AssertionError(f"pareto frontier malformed: {front!r}")
    hv = front.hypervolume()
    if not (math.isfinite(hv) and hv > 0):
        raise AssertionError(f"pareto hypervolume {hv}")

    short = ScalarizationSweep(sweeps=10)
    res = {}
    for dev in (DEV, "cpu"):
        pfd = Pathfinder(pf.wl, pf.template, norm=norm, space=pf.space,
                         torch_device=dev)
        t = time.perf_counter()
        res[dev] = pfd.search(short, key=0)
        res[dev + "_s"] = time.perf_counter() - t
    worst = _same_result("pareto", res[DEV], res["cpu"], pf.space)
    prof = _profiled(lambda: pf.search(ScalarizationSweep(sweeps=5), key=1))
    rec = dict(phase="pareto", directions=strat.directions,
               n_chains=strat.n_chains, sweeps=strat.sweeps,
               evaluations=evals, fit_s=fit_s, wall_s=wall,
               sweeps_per_s=strat.sweeps / wall, evals_per_s=evals / wall,
               frontier=len(front), hypervolume=hv, launches=launches,
               parity_sweeps=short.sweeps, parity_max_rel_dev=worst,
               parity_frontier=len(res[DEV].frontier),
               parity_cuda_s=res[DEV + "_s"], parity_cpu_s=res["cpu_s"],
               profile=dict(sweeps=5, **prof), card=card)
    emit(rec)
    return rec


def phase_strategies(card: str) -> dict:
    """``RandomSearch(batch_size=512)`` at budget 2048 and the full
    default ``GridSweep()`` (4 memories x 12 mappings x 43 package
    combinations) on the card and on the CPU: best design and frontier
    encodings equal, costs within TOL; the card's wall time and
    ``prefix_select`` launches of each run."""
    from repro_torch.core import workload
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.pathfinding import GridSweep, Pathfinder, RandomSearch

    pf = Pathfinder(workload(1), "T1", torch_device=DEV)
    norm = pf.norm
    pfc = Pathfinder(pf.wl, pf.template, norm=norm, space=pf.space,
                     torch_device="cpu")
    rec = dict(phase="strategies", card=card)
    total = 0
    for name, strat, budget, want in (
            ("random", RandomSearch(batch_size=512), 2048, 2048),
            ("grid", GridSweep(), None, 4 * 12 * 43)):
        pf.search(strat, budget=budget, key=0)            # warm
        kops.reset_launch_count()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = pf.search(strat, budget=budget, key=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kops.launch_count()
        if launches < 1:
            raise AssertionError(f"{name} did not launch prefix_select")
        if got.evaluations != want:
            raise AssertionError(f"{name}: {got.evaluations} evaluations")
        t = time.perf_counter()
        ref = pfc.search(strat, budget=budget, key=0)
        cpu_s = time.perf_counter() - t
        rec[name] = dict(evaluations=got.evaluations, wall_s=wall,
                         evals_per_s=got.evaluations / wall, cpu_s=cpu_s,
                         best_cost=got.best_cost, frontier=len(got.frontier),
                         max_rel_dev=_same_result(name, got, ref, pf.space),
                         launches={"prefix_select": launches})
        total += launches
    rec["launches"] = {"prefix_select": total}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# scenario phase: the stacked region x workload grid
# ---------------------------------------------------------------------------


class _Recorder:
    """Wraps ``owner.name`` for the lifetime of a ``with`` block: every
    call is timed to a synchronize and its arguments kept, so a phase can
    split a facade's wall time and replay one of its inner calls."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name
        self.calls = []

    def __enter__(self):
        real = getattr(self.owner, self.name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((args, kwargs, time.perf_counter() - t))
            return out

        self.real = real
        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)

    def seconds(self) -> float:
        return sum(c[2] for c in self.calls)


def _scenario_run(pf, workloads, sweep):
    """One ``run_scenarios`` call on the card: the frontier, the
    ``prefix_select`` launches of that run, its wall time split into the
    normalizer fits, the tempering loop and, inside the loop, the host's
    per-cell archive feeds, and the loop's call (the engine and its
    arguments) for a replay."""
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.pathfinding import ParetoArchive, ScenarioEngine
    from repro_torch.pathfinding import batch as batch_mod

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_count()
    with _Recorder(batch_mod, "fit_region_normalizers") as fits, \
            _Recorder(ScenarioEngine, "parallel_tempering") as loop, \
            _Recorder(ParetoArchive, "insert") as feeds:
        t = time.perf_counter()
        sf = pf.run_scenarios(sweep, workloads=workloads, key=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return dict(sf=sf, launches=kops.launch_count(), wall_s=wall,
                fit_s=fits.seconds(), loop_s=loop.seconds(),
                archive_s=feeds.seconds(), archive_feeds=len(feeds.calls),
                loop_call=loop.calls[0][:2],
                peak_mem_bytes=torch.cuda.max_memory_allocated())


def _replay_loop(call, sweeps: int):
    """The recorded tempering call again at ``sweeps`` sweeps, feeding
    fresh archives as the facade does."""
    from repro_torch.pathfinding import ParetoArchive

    (engine, v0, temps, _, swap), kw = call[0][:5], dict(call[1])
    kw["archives"] = [ParetoArchive(max_size=a.max_size)
                      for a in kw["archives"]]
    return engine.parallel_tempering(v0, temps, sweeps, swap, **kw)


def phase_scenario(card: str) -> dict:
    """The stacked scenario path: the full-width grid through
    ``run_scenarios``, the one-cell grid of the same strategy, a profiled
    5-sweep loop at S = 1 and at S = 10, and two grids on the card
    against the CPU."""
    from repro_torch.core import workload
    from repro_torch.core.regions import Region, diurnal_profile
    from repro_torch.pathfinding import (
        DesignSpace,
        Pathfinder,
        ScalarizationSweep,
        ScenarioSweep,
    )

    wls = [workload(1), workload(6)]
    pf = Pathfinder(workload(1), "T1", torch_device=DEV)
    sweep = ScenarioSweep()
    strat = sweep.strategy
    chains = strat.directions * strat.n_chains
    want = 1 + strat.sweeps + 1
    full = _scenario_run(pf, wls, sweep)
    sf = full["sf"]
    S = len(sf.scenarios)
    if full["launches"] != want:
        raise AssertionError(f"scenario launched prefix_select "
                             f"{full['launches']} times, not {want}")
    cells = {}
    for s in sf.scenarios:
        res = sf.results[s.key]
        vec = res.frontier.vectors
        if len(vec) < 1 or not np.all(np.isfinite(vec)) \
                or not math.isfinite(res.best_cost):
            raise AssertionError(f"scenario cell {s.key} malformed")
        cells["/".join(s.key)] = dict(frontier=len(vec),
                                      best_cost=res.best_cost)
    fronts = [sf.results[s.key].frontier.vectors for s in sf.scenarios]
    for i in range(S):
        for j in range(i + 1, S):
            if np.array_equal(fronts[i], fronts[j]):
                raise AssertionError(f"scenario cells {i} and {j} have the "
                                     "same frontier")
    evals = S * chains * (strat.sweeps + 1)

    one = _scenario_run(pf, [workload(1)], dataclasses.replace(
        sweep, regions={"world-avg": 0.475}))
    if one["launches"] != want:
        raise AssertionError(f"one-cell scenario launched prefix_select "
                             f"{one['launches']} times, not {want}")
    prof = {n_cells: _profiled(lambda c=run["loop_call"]: _replay_loop(c, 5))
            for n_cells, run in ((1, one), (S, full))}
    k1, k10 = prof[1]["device_kernels"], prof[S]["device_kernels"]
    if not k1 or k10 > 1.02 * k1:
        raise AssertionError(f"S = {S} issued {k10} kernels, S = 1 {k1}")

    worst, parity = 0.0, {}
    region_grid = {
        "a": Region(0.3, electricity_price=0.12, emb_factor=1.3,
                    grid_profile=diurnal_profile(0.3, swing=0.4),
                    price_profile=diurnal_profile(0.12, swing=0.25,
                                                  peak_hour=18)),
        "b": Region(0.7, electricity_price=0.05, emb_factor=0.9,
                    grid_profile=diurnal_profile(0.7, peak_hour=7))}
    for name, psweep, space in (
            ("grid", ScenarioSweep(
                strategy=ScalarizationSweep(directions=2, n_chains=2,
                                            sweeps=10),
                norm_samples=100), DesignSpace()),
            ("regions_mesh_window", ScenarioSweep(
                strategy=ScalarizationSweep(directions=2, n_chains=2,
                                            sweeps=5),
                regions=region_grid, norm_samples=100, comm="mesh_noc",
                schedule="window"),
             DesignSpace(comm="mesh_noc", schedule="window"))):
        got = {}
        for dev in (DEV, "cpu"):
            t = time.perf_counter()
            got[dev] = psweep.run(wls, key=0, torch_device=dev)
            if dev == DEV:
                torch.cuda.synchronize()
            got[dev + "_s"] = time.perf_counter() - t
        dev_max = 0.0
        for s in got["cpu"].scenarios:
            dev_max = max(dev_max, _same_result(
                f"scenario.{name}.{'/'.join(s.key)}",
                got[DEV].results[s.key], got["cpu"].results[s.key], space))
        worst = max(worst, dev_max)
        parity[name] = dict(cells=len(got["cpu"].scenarios),
                            sweeps=psweep.strategy.sweeps,
                            max_rel_dev=dev_max, cuda_s=got[DEV + "_s"],
                            cpu_s=got["cpu_s"])

    rec = dict(phase="scenario", cells=S, chains_per_cell=chains,
               rows_per_sweep=S * chains, sweeps=strat.sweeps,
               norm_samples=sweep.norm_samples, evaluations=evals,
               wall_s=full["wall_s"], fit_s=full["fit_s"],
               loop_s=full["loop_s"], archive_s=full["archive_s"],
               archive_feeds=full["archive_feeds"],
               sweeps_per_s=strat.sweeps / full["loop_s"],
               evals_per_s=evals / full["loop_s"],
               launches={"prefix_select": full["launches"]
                         + one["launches"]},
               full_launches=full["launches"],
               peak_mem_bytes=full["peak_mem_bytes"], cells_out=cells,
               one_cell=dict(wall_s=one["wall_s"], fit_s=one["fit_s"],
                             loop_s=one["loop_s"], archive_s=one["archive_s"],
                             archive_feeds=one["archive_feeds"],
                             launches=one["launches"]),
               profile={f"S{k}": dict(sweeps=5, **v)
                        for k, v in prof.items()},
               kernel_ratio=k10 / k1, parity=parity,
               parity_max_rel_dev=worst, card=card)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# resume / service phases: checkpoint/resume and the pathfinding service
# ---------------------------------------------------------------------------

WORK = os.path.join(REPO, "build", "chip_smoke_work")   # snapshots, .npz
SCRIPTS = os.path.join(REPO, "scripts")


def _work_dir(name: str) -> str:
    path = os.path.join(WORK, name)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    return path


def _script(name: str, *args: str, expect: int = 0) -> dict:
    """Run ``scripts/<name>`` in a fresh process (``PYTHONPATH=src``);
    its exit code must be ``expect``. Returns the process's wall time
    and, for a clean exit, the JSON object its last line prints."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(SCRIPTS, name),
                           *args], env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t
    if proc.returncode != expect:
        raise AssertionError(
            f"{name} {' '.join(args)} exited {proc.returncode}, not "
            f"{expect}:\n{proc.stderr[-3000:]}")
    out = dict(process_s=wall)
    if expect == 0:
        out.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    return out


def _same_arrays(name: str, got: dict, ref: dict) -> None:
    """Two dicts of arrays equal key for key, to the bit."""
    if set(got) != set(ref):
        raise AssertionError(f"{name}: keys {sorted(got)} vs {sorted(ref)}")
    for k in sorted(ref):
        if not np.array_equal(got[k], ref[k]):
            raise AssertionError(f"{name}: {k} differs")


def _pt_equal(name: str, got, ref) -> None:
    """Two runs of the tempering engine on one device, bit for bit:
    history, best, final population and frontier."""
    (res, arch), (rres, rarch) = got, ref
    same = (res.history == rres.history and res.best_cost == rres.best_cost
            and all(np.array_equal(getattr(res, f), getattr(rres, f))
                    for f in ("best_enc", "final_enc", "final_costs"))
            and np.array_equal(arch.encoded, rarch.encoded)
            and np.array_equal(arch.vectors, rarch.vectors))
    if not same:
        raise AssertionError(f"{name}: not bit-identical")


def _pt_close(name: str, got, ref, judge=None) -> dict:
    """Two runs of the tempering engine on different devices: final
    population equal, history and costs within TOL. Without ``judge``
    (two uninterrupted runs) best and frontier designs equal, frontier
    vectors within TOL. With ``judge`` (a run resumed from the other
    device's snapshot) best and frontier designs equal up to rounding
    ties, by the tests' rule (``assert_same_up_to_ties`` of
    ``tests/test_torch_ties.py``; ``judge`` gives ``(costs,
    vectors)`` of rows on the CPU). Returns the largest deviation and
    the number of designs accepted as ties."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_ties import assert_same_up_to_ties

    (res, arch), (rres, rarch) = got, ref
    if not np.array_equal(res.final_enc, rres.final_enc):
        raise AssertionError(f"{name}: final populations differ")
    dev = max(_allclose(f"{name}.history", res.history, rres.history),
              _allclose(f"{name}.best_cost", res.best_cost, rres.best_cost),
              _allclose(f"{name}.final_costs", res.final_costs,
                        rres.final_costs))
    if judge is None:
        for f, a, b in (("best_enc", res.best_enc, rres.best_enc),
                        ("frontier", arch.encoded, rarch.encoded)):
            if not (a.shape == b.shape and np.array_equal(a, b)):
                raise AssertionError(f"{name}: {f} differs")
        dev = max(dev, _allclose(f"{name}.frontier", arch.vectors,
                                 rarch.vectors))
        tied = dict(best=0, frontier=0)
    else:
        try:
            tied = dict(
                best=assert_same_up_to_ties(
                    res.best_enc[None], [[res.best_cost]],
                    rres.best_enc[None], [[rres.best_cost]], rtol=TOL,
                    score=lambda e: judge(e)[0]),
                frontier=assert_same_up_to_ties(
                    arch.encoded, arch.vectors, rarch.encoded,
                    rarch.vectors, rtol=TOL, score=lambda e: judge(e)[1]))
        except AssertionError as exc:
            raise AssertionError(f"{name}: {exc}") from exc
    return dict(max_rel_dev=dev, tied_designs=tied, frontier=len(arch),
                ref_frontier=len(rarch))


class _Dying:
    """A checkpointer that raises after its first save (a preemption
    between a finished snapshot and the next segment)."""

    def __init__(self, directory: str):
        from repro_torch.pathfinding import SearchCheckpointer

        self.inner = SearchCheckpointer(directory)

    def save(self, *a, **kw):
        self.inner.save(*a, **kw)
        raise KeyboardInterrupt("preempted after the first snapshot")

    def restore(self, *a, **kw):
        return self.inner.restore(*a, **kw)


def phase_resume(card: str) -> dict:
    """Checkpoint/resume: (a) the reference benchmark's shape (workload
    1, T1, 512 chains x 100 sweeps, swap 5, seed 11, ParetoArchive(256))
    monolithic, in 50-sweep segments and checkpointed, once each, bit
    for bit, with ms per save; (b) preempted after its first snapshot
    and resumed, bit for bit; (c) ``run_scenarios`` at its defaults (5 x 2
    grid, 40 sweeps) in 10-sweep segments, a subprocess killed after its
    first snapshot and a second resuming it, bit for bit against an
    uninterrupted run; (d) the sweep-50 snapshot of (b) resumed on the
    CPU, and a CPU snapshot resumed on the card."""
    from repro_torch.core import TEMPLATES, workload
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.pathfinding import (
        DesignSpace,
        ParetoArchive,
        SearchCheckpointer,
        fit_normalizer_batched,
    )
    from repro_torch.pathfinding.device import get_device_evaluator

    sys.path.insert(0, SCRIPTS)
    import torch_resume_worker as worker

    wl, space, tpl = workload(1), DesignSpace(), TEMPLATES["T1"]
    n, sweeps, seg = 512, 100, 50
    norm = fit_normalizer_batched(wl, samples=2000, seed=1234, space=space,
                                  torch_device=DEV)
    v0 = space.sample(n, key=3)
    ratio = (1.0 / 4000.0) ** (1.0 / (n - 1))
    temps = np.array([4000.0 * ratio ** i for i in range(n)])

    def run(dev=DEV, **kw):
        ev = get_device_evaluator(wl, space=space, torch_device=dev)
        archive = ParetoArchive(max_size=256)
        if dev == DEV:
            torch.cuda.synchronize()
        t = time.perf_counter()
        res = ev.parallel_tempering(v0, temps, sweeps, 5, seed=11,
                                    norm=norm, template=tpl,
                                    archive=archive, **kw)
        if dev == DEV:
            torch.cuda.synchronize()
        return (res, archive), time.perf_counter() - t

    get_device_evaluator(wl, space=space, torch_device=DEV)  # not timed
    kops.reset_launch_count()
    # (a) three ways, once each
    walls, results = {}, {}
    for way in ("monolithic", "segmented", "checkpointed"):
        kw = {} if way == "monolithic" else dict(segment=seg)
        if way == "checkpointed":
            kw["checkpoint"] = SearchCheckpointer(_work_dir("ck"))
            with _Recorder(SearchCheckpointer, "save") as rec:
                results[way], walls[way] = run(**kw)
            saves = [c[2] for c in rec.calls]
            snap = kw["checkpoint"].manager.latest()
            snap_bytes = sum(os.path.getsize(os.path.join(snap, f))
                             for f in os.listdir(snap))
        else:
            results[way], walls[way] = run(**kw)
    mono = results["monolithic"]
    _pt_equal("resume.segmented", results["segmented"], mono)
    _pt_equal("resume.checkpointed", results["checkpointed"], mono)
    if not (math.isfinite(mono[0].best_cost)
            and len(mono[0].history) == sweeps + 1 and len(mono[1]) > 0
            and np.all(np.isfinite(mono[1].vectors))):
        raise AssertionError("resume: malformed result")
    save_ms = 1e3 * float(np.mean(saves))
    launches_a = kops.launch_count()

    # (b) preempted after the first snapshot (sweep 50), then resumed
    d_b = _work_dir("interrupt")
    try:
        run(segment=seg, checkpoint=_Dying(d_b))
        raise AssertionError("resume: the preempted run did not stop")
    except KeyboardInterrupt:
        pass
    d_cuda50 = _work_dir("cuda50")
    shutil.copytree(d_b, d_cuda50, dirs_exist_ok=True)
    resumed_b, resume_b_s = run(segment=seg,
                                checkpoint=SearchCheckpointer(d_b))
    _pt_equal("resume.interrupted", resumed_b, mono)

    # (d) across devices: the card's sweep-50 snapshot on the CPU, and a
    # CPU snapshot at sweep 50 on the card, against both uninterrupted
    cpu_full, cpu_full_s = run("cpu", segment=seg)
    cpu_resumed, cpu_resumed_s = run(
        "cpu", segment=seg, checkpoint=SearchCheckpointer(d_cuda50))
    d_cpu50 = _work_dir("cpu50")
    try:
        run("cpu", segment=seg, checkpoint=_Dying(d_cpu50))
        raise AssertionError("resume: the preempted CPU run did not stop")
    except KeyboardInterrupt:
        pass
    card_resumed, card_resumed_s = run(
        segment=seg, checkpoint=SearchCheckpointer(d_cpu50))
    cpu_ev = get_device_evaluator(wl, space=space, torch_device="cpu")

    def judge(enc):        # ties are judged on the CPU: no launches
        return cpu_ev.evaluate_cost_vector(enc, norm, tpl)[1:]

    across = {
        "cuda_to_cpu": dict(
            vs_cuda=_pt_close("resume.cuda_to_cpu", cpu_resumed, mono,
                              judge),
            vs_cpu=_pt_close("resume.cuda_to_cpu.cpu", cpu_resumed,
                             cpu_full, judge), cpu_s=cpu_resumed_s),
        "cpu_to_cuda": dict(
            vs_cuda=_pt_close("resume.cpu_to_cuda", card_resumed, mono,
                              judge),
            vs_cpu=_pt_close("resume.cpu_to_cuda.cpu", card_resumed,
                             cpu_full, judge), cuda_s=card_resumed_s),
        "cpu_vs_cuda_uninterrupted": _pt_close("resume.cpu_full", cpu_full,
                                               mono),
        "cpu_full_s": cpu_full_s}

    launches_abd = kops.launch_count()   # the card's runs of (a), (b), (d)

    # (c) the default scenario grid killed in a subprocess and resumed
    kops.reset_launch_count()
    t = time.perf_counter()
    sf = worker.run_grid("defaults", None, DEV)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t
    launches_c = kops.launch_count()
    ref = {}
    for i, s in enumerate(sf.scenarios):
        res = sf.results[s.key]
        ref.update({f"enc_{i}": res.frontier.encoded,
                    f"vec_{i}": res.frontier.vectors,
                    f"hist_{i}": np.asarray(res.history),
                    f"best_cost_{i}": np.float64(res.best_cost)})
    d_c = _work_dir("grid")
    args = ("run", "--grid", "defaults", "--torch-device", DEV,
            "--checkpoint-dir", d_c)
    killed = _script("torch_resume_worker.py", *args, "--max-segments", "1",
                     expect=3)
    steps = SearchCheckpointer(d_c).manager.all_steps()
    if steps != [worker.DEFAULTS_SEGMENT]:
        raise AssertionError(f"resume: killed grid left steps {steps}")
    out_npz = os.path.join(d_c, "resumed.npz")
    resumed = _script("torch_resume_worker.py", *args, "--out", out_npz)
    got = dict(np.load(out_npz))
    _same_arrays("resume.grid", got, ref)

    rec = dict(
        phase="resume", n_chains=n, sweeps=sweeps, segment=seg,
        walls_s=walls, saves=len(saves), save_ms=save_ms,
        save_ms_max=1e3 * max(saves), snapshot_bytes=snap_bytes,
        overhead_share=1e-3 * save_ms * len(saves) / walls["checkpointed"],
        ck_vs_mono=walls["checkpointed"] / walls["monolithic"] - 1,
        seg_vs_mono=walls["segmented"] / walls["monolithic"] - 1,
        frontier=len(mono[1]), best_cost=mono[0].best_cost,
        interrupted_resume_s=resume_b_s, across=across,
        grid=dict(cells=len(sf.scenarios), segment=worker.DEFAULTS_SEGMENT,
                  uninterrupted_s=grid_s, killed_process_s=killed[
                      "process_s"], resumed_process_s=resumed["process_s"],
                  resumed_sweep_s=resumed["wall_s"],
                  launches_uninterrupted=launches_c,
                  launches_resumed=resumed["launches"]),
        launches={"prefix_select": launches_abd + launches_c
                  + resumed["launches"]},
        launches_a=launches_a, card=card)
    emit(rec)
    return rec


def _throughput_specs(prefix: str, n_jobs: int = 8, sweeps: int = 16):
    """The reference serving benchmark's job mix: ``n_jobs`` jobs of 2
    directions x 2 chains, workloads 1 and 6 in turn, four regions."""
    from repro_torch.core.regions import Region
    from repro_torch.pathfinding import ScalarizationSweep
    from repro_torch.serving import JobSpec

    wls = _serve_workloads()
    return [JobSpec(job_id=f"{prefix}-{i}", workload=wls[i % 2].name,
                    strategy=ScalarizationSweep(directions=2, n_chains=2,
                                                sweeps=sweeps),
                    region=Region([0.024, 0.3, 0.475, 0.82][i % 4]))
            for i in range(n_jobs)]


def _serve_workloads():
    from repro_torch.core import workload

    return [workload(1), workload(6)]


def _drain(svc, specs) -> float:
    """Submit ``specs``, drain, read every result; the wall time."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for sp in specs:
        svc.submit(sp)
    svc.drain()
    results = [svc.result(sp.job_id) for sp in specs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for r in results:
        if not (math.isfinite(r.best_cost) and len(r.frontier) > 0
                and np.all(np.isfinite(r.frontier.vectors))):
            raise AssertionError(f"service: job {r.job_id} malformed")
    return wall


def phase_service(card: str) -> dict:
    """The pathfinding service on the card: (a) the six-job table of
    ``scripts/torch_serve_pathfinder.py`` solo and packed, bit for bit,
    packed on the CPU (designs equal, floats within TOL), then served by
    a subprocess killed after 9 snapshots and resumed by a restarted
    one, bit for bit against the solo runs; (b) the reference serving
    benchmark's 8 jobs (16 sweeps, segment 2, 4 slots, ``norm_samples``
    60) drained by one warm service and by 8 cold runs (each building
    its own engine), with the device idle share of one profiled tick;
    (c) 4 jobs of the default ``ScalarizationSweep()`` (16 directions x
    4 chains, 100 sweeps) in one bucket, segment 10."""
    import repro_torch.pathfinding.device as device_mod
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.pathfinding import ScalarizationSweep
    from repro_torch.serving import JobSpec, JobState, PathfinderService

    sys.path.insert(0, SCRIPTS)
    import torch_serve_pathfinder as table

    kops.reset_launch_count()
    # (a) solo == packed, and kill-and-resume of the whole service
    t = time.perf_counter()
    solo = table.serve_table("solo", torch_device=DEV)
    solo_s = time.perf_counter() - t
    t = time.perf_counter()
    packed = table.serve_table("service", torch_device=DEV)
    packed_s = time.perf_counter() - t
    _same_arrays("service.packed", packed, solo)
    t = time.perf_counter()
    on_cpu = table.serve_table("service", torch_device="cpu")
    cpu_s = time.perf_counter() - t
    if set(on_cpu) != set(packed):
        raise AssertionError("service.cpu: other jobs or fields")
    cpu_dev = 0.0
    for k in sorted(packed):
        if k.split("_")[0] in ("enc", "sweeps") or k.startswith("best_enc"):
            if not np.array_equal(on_cpu[k], packed[k]):
                raise AssertionError(f"service.cpu: {k} differs")
        else:
            cpu_dev = max(cpu_dev, _allclose(f"service.cpu.{k}", on_cpu[k],
                                             packed[k]))
    root = _work_dir("serve")
    args = ("run", "--torch-device", DEV, "--checkpoint-root", root)
    killed = _script("torch_serve_pathfinder.py", *args, "--max-segments",
                     "9", expect=3)
    out_npz = os.path.join(WORK, "serve_resumed.npz")
    resumed = _script("torch_serve_pathfinder.py", *args, "--out", out_npz)
    _same_arrays("service.resumed", dict(np.load(out_npz)), solo)

    # (b) throughput: one warm packed service against cold runs
    def svc_b():
        return PathfinderService(_serve_workloads(), slots=4, segment=2,
                                 norm_samples=60, torch_device=DEV)

    _drain(svc_b(), _throughput_specs("warmup"))
    before = kops.launch_count()
    packed_b = _drain(svc_b(), _throughput_specs("warm"))
    packed_launches = kops.launch_count() - before
    cold = []
    for sp in _throughput_specs("cold"):
        device_mod._SCENARIO_ENGINES.clear()
        cold.append(_drain(svc_b(), [sp]))
    svc = svc_b()
    for sp in _throughput_specs("prof", n_jobs=4):
        svc.submit(sp)
    svc.step()                          # warmup, admission, one segment
    tick = _profiled(svc.step)
    n_jobs = 8

    # (c) full width: 4 default sweeps in one bucket, 10-sweep segments
    strat = ScalarizationSweep()
    chains = strat.directions * strat.n_chains
    wls = _serve_workloads()
    from repro_torch.core.regions import Region

    specs = [JobSpec(job_id=f"full-{i}", workload=wls[i % 2].name,
                     strategy=strat,
                     region=Region([0.024, 0.3, 0.475, 0.82][i]))
             for i in range(4)]
    svc = PathfinderService(wls, slots=4, segment=10, torch_device=DEV)
    torch.cuda.reset_peak_memory_stats()
    before = kops.launch_count()
    full_s = _drain(svc, specs)
    full_launches = kops.launch_count() - before
    for sp in specs:
        r = svc.result(sp.job_id)
        if svc.status(sp.job_id) is not JobState.DONE or r.sweeps != \
                strat.sweeps or len(r.history) != strat.sweeps + 1:
            raise AssertionError(f"service: {sp.job_id} ran {r.sweeps}")

    rec = dict(
        phase="service",
        table=dict(jobs=len(table.JOBS), solo_s=solo_s, packed_s=packed_s,
                   cpu_s=cpu_s, cpu_max_rel_dev=cpu_dev,
                   killed_process_s=killed["process_s"],
                   resumed_process_s=resumed["process_s"],
                   resumed_drain_s=resumed["wall_s"],
                   resumed_launches=resumed["launches"]),
        throughput=dict(
            jobs=n_jobs, sweeps=16, segment=2, slots=4,
            packed_s=packed_b, packed_jobs_per_s=n_jobs / packed_b,
            cold_s=sum(cold), cold_jobs_per_s=n_jobs / sum(cold),
            cold_each_s=cold,
            packed_vs_cold=sum(cold) / packed_b,
            packed_launches=packed_launches,
            tick=dict(slots=4, chains_per_slot=4, sweeps=2, **tick)),
        full=dict(jobs=len(specs), chains_per_job=chains,
                  sweeps=strat.sweeps, segment=10, wall_s=full_s,
                  sweeps_per_s=strat.sweeps / full_s,
                  evals_per_s=len(specs) * chains * (strat.sweeps + 1)
                  / full_s,
                  peak_mem_bytes=torch.cuda.max_memory_allocated(),
                  launches=full_launches),
        launches={"prefix_select": kops.launch_count()
                  + resumed["launches"]},
        card=card)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# wkv6 kernel / lm_parity / serve phases: the RWKV-6 serving path
# ---------------------------------------------------------------------------


def wkv6_inputs(G: int, T: int, heads: int, with_state: bool, seed: int):
    """Recurrence inputs in the model's regime: normal r, k, v; decays
    ``exp(-exp(-6 + noise))`` (about 0.9975); per-head ``u`` at the
    model's init scale; a random start state when asked."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=DEV)

    D = 64
    r, k, v = n(G, T, D), n(G, T, D), n(G, T, D)
    w = torch.exp(-torch.exp(-6 + n(G, T, D)))
    u = n(heads, D) * (0.5 / math.sqrt(heads))
    s0 = n(G, D, D) if with_state else None
    return r, k, v, w, u, s0


def wkv6_bound(r, u, s0) -> dict:
    """The least time of one ``wkv6`` call: its bytes
    (``kernels/wkv6/ops.py::work``: r, k, v, w, u and the start state
    read once, y and S_T written once) over HBM bandwidth, against its
    operations (5 D^2 + 5 D a row and step) over the fp32
    non-tensor-core rate."""
    from repro_torch.kernels.wkv6.ops import work

    ops, nbytes = work(r, u, s0)
    t_bytes = nbytes / H100.hbm_bytes_per_s * 1e3
    t_ops = ops / H100.fp32_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def _ptxas_regs(lines) -> list:
    """Registers and spill bytes of each kernel in ``ptxas_report`` lines
    (a function's spill line comes before its register line)."""
    import re

    out, spill = [], {}
    for ln in lines:
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = dict(spill_stores=int(m.group(1)),
                         spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(dict(registers=int(m.group(1)), **spill))
            spill = {}
    return out


def phase_wkv6(card: str) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6 import wkv6_plain

    lib = wops.build()
    ptxas = _build.ptxas_report(wops.SOURCE)
    recs = {}
    worst = 0.0
    for shape, G, T, heads, with_state in (
            ("prefill", 160, 512, 40, False),
            ("prefill_bthd", 160, 512, 40, False),
            ("decode", 160, 1, 40, True), ("edge", 1, 37, 1, False)):
        r, k, v, w, u, s0 = wkv6_inputs(G, T, heads, with_state, seed=T)
        B, H = G, 1
        if shape == "prefill_bthd":       # the model's (B, T, H, D) layout
            B, H = G // heads, heads
            y_rows = wops.wkv6(r, k, v, w, u)[0]
            r, k, v, w = (x.reshape(B, H, T, 64).transpose(1, 2).contiguous()
                          for x in (r, k, v, w))
        y_k, s_k = wops.wkv6(r, k, v, w, u, s0)
        y_p, s_p = wkv6_plain(r, k, v, w, u, s0)
        # M: the largest sum of absolute terms an output accumulates
        m_y, m_s = (float(x.max()) for x in wkv6_plain(
            r.abs(), k.abs(), v.abs(), w, u.abs(),
            None if s0 is None else s0.abs()))
        torch.cuda.synchronize()
        err_y = float((y_k - y_p).abs().max())
        err_s = float((s_k - s_p).abs().max())
        if not (err_y <= WKV_TOL * m_y and err_s <= WKV_TOL * m_s):
            raise AssertionError(
                f"wkv6 != plain ({shape}): max abs err y {err_y} (M {m_y}),"
                f" S {err_s} (M {m_s}), tolerance {WKV_TOL} x M")
        checks = {}
        if shape == "prefill_bthd":       # the same rows, read in place
            checks["rows_equal"] = torch.equal(
                y_k.transpose(1, 2).reshape(G, T, 64), y_rows)
        if s0 is not None:                # the decode cache's update
            state = s0.clone()
            y_i, s_i = wops.wkv6(r, k, v, w, u, state, s_out=state)
            torch.cuda.synchronize()
            checks["in_place_equal"] = (s_i.data_ptr() == state.data_ptr()
                                        and torch.equal(state, s_k)
                                        and torch.equal(y_i, y_k))
        if not all(checks.values()):
            raise AssertionError(f"wkv6 ({shape}): {checks}")
        worst = max(worst, err_y, err_s)
        y = torch.empty_like(r)
        s_out = torch.empty((G, 64, 64), device=DEV)
        s0_ptr = None if s0 is None else s0.data_ptr()

        def launch():
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 w.data_ptr(), u.data_ptr(), u.shape[0],
                                 s0_ptr, y.data_ptr(), s_out.data_ptr(), B,
                                 T, H, 64, stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        plain = lambda: wkv6_plain(r, k, v, w, u, s0)  # noqa: E731
        p_iters = 3 if T > 64 else 20
        rec = dict(phase="wkv6_kernel", kernel="wkv6", shape=shape, G=G, T=T,
                   B=B, H=H, D=64, s0=with_state, **checks,
                   geometry=wops.geometry(G), max_abs_err_y=err_y,
                   max_abs_err_s=err_s,
                   rel_err_y=err_y / float(y_p.abs().max()),
                   rel_err_s=err_s / float(s_p.abs().max()),
                   err_y_over_M=err_y / m_y, err_s_over_M=err_s / m_s,
                   ms=graph_ms(launch), eager_ms=cuda_ms(launch),
                   plain_ms=graph_ms(plain, iters=p_iters),
                   plain_eager_ms=cuda_ms(plain, iters=p_iters, warmup=1),
                   **wkv6_bound(r, u, s0), card=card)
        if shape == "prefill":
            rec.update(ptxas=ptxas, ptxas_regs=_ptxas_regs(ptxas))
        emit(with_floor(rec))
        recs[shape] = rec
    return dict(recs["prefill_bthd"], max_abs_err=worst,
                decode=recs["decode"])


def _decode_parity(cfg, prompt_len: int, seed: int, steps: int = 8,
                   batch: int = 2, prepare=None) -> dict:
    """The model of ``cfg`` on cuda against the same weights on the CPU:
    prefill of a ``prompt_len`` prompt, then ``steps`` teacher-forced
    greedy steps (the CPU's tokens fed to both); every step's logits
    within ``LM_TOL`` of max |logit| and the greedy tokens equal where
    the CPU's top-2 gap exceeds that. ``prepare(model, seed)`` edits the
    CPU model's weights before they are copied to the card."""
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.transformer import decode_step, init_model, prefill

    cpu = init_model(cfg, seed=seed, torch_device="cpu")
    if prepare is not None:
        prepare(cpu, seed)
    gpu = init_model(cfg, seed=seed, torch_device=DEV)
    gpu.load_state_dict(cpu.state_dict())
    prompts = make_prompts(cfg.vocab, batch, prompt_len, seed=seed + 1,
                           device="cpu")
    lc, cc, nc = prefill(cpu, prompts, prompt_len + steps)
    lg, cg, ng = prefill(gpu, prompts.to(DEV), prompt_len + steps)
    worst, compared = 0.0, 0
    for i in range(steps + 1):
        lg_c = lg.cpu()
        scale = float(lc.abs().max())
        err = float((lg_c - lc).abs().max())
        if not (torch.isfinite(lg_c).all() and err <= LM_TOL * scale):
            raise AssertionError(f"{cfg.name} parity step {i}: max abs err "
                                 f"{err} > {LM_TOL} x {scale}")
        worst = max(worst, err / scale)
        top2 = lc.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LM_TOL * scale
        if not torch.equal(lg_c.argmax(-1)[clear], lc.argmax(-1)[clear]):
            raise AssertionError(f"{cfg.name} parity step {i}: greedy "
                                 "tokens differ")
        compared += int(clear.sum())
        if i == steps:
            break
        token = lc.argmax(-1).to(torch.int32)        # the CPU's token
        lc, cc = decode_step(cpu, token, cc, nc)
        lg, cg = decode_step(gpu, token.to(DEV), cg, ng)
        nc, ng = nc + 1, ng + 1
    return dict(d_model=cfg.d_model, layers=cfg.n_layers,
                batch=batch, prompt=prompt_len, steps=steps,
                max_rel_err=worst, tol=LM_TOL, tokens_compared=compared)


def phase_lm_parity(card: str) -> dict:
    from repro_torch.configs import get_config

    from repro_torch.models.rwkv6 import n_heads

    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(), d_model=256)
    rec = dict(phase="lm_parity", **_decode_parity(cfg, 32, seed=3),
               heads=n_heads(cfg), card=card)
    emit(rec)
    return rec


def _launch_counters() -> dict:
    """Every kernel wrapper of the port by name; each keeps its launch
    count in ``.launches``."""
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.kernels.rglru import ops as rops
    from repro_torch.kernels.systolic_gemm import ops as gops
    from repro_torch.kernels.topology import ops as tops
    from repro_torch.kernels.wkv6 import ops as wops

    return {"prefix_select": kops.prefix_select,
            "prefix_segment": kops.prefix_segment_gather, "wkv6": wops.wkv6,
            "rglru": rops.rglru, "topology": tops.topology,
            **{fn.__name__: fn for fn in gops.KERNELS}}


def _kernel_sources() -> dict:
    """Every CUDA source of the port, with the function that loads its
    library."""
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.kernels.rglru import ops as rops
    from repro_torch.kernels.systolic_gemm import ops as gops
    from repro_torch.kernels.topology import ops as tops
    from repro_torch.kernels.wkv6 import ops as wops

    return {"prefix_select": (kops.SOURCE, kops.build),
            "prefix_segment": (kops.SEGMENT_SOURCE, kops.build_segment),
            "topology": (tops.SOURCE, tops.build),
            "wkv6": (wops.SOURCE, wops.build),
            "rglru": (rops.SOURCE, rops.build),
            "systolic_gemm": (gops.SOURCE, gops.build)}


def _serve(card: str, phase: str, arch, prompt_len: int,
           expect: dict, batch: int = 4, gen: int = 32, policy=None,
           extra=None) -> dict:
    """``arch`` (a name, served at its full size, or a ``ModelConfig``)
    under ``policy`` (default float32) through ``generate`` (prefill,
    then ``gen - 1`` greedy steps), after a short warm-up run; the kernel
    launch counts of the timed run must equal ``expect``.
    ``extra(cfg, model, prompts)`` adds to the record."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model

    cfg = get_config(arch) if isinstance(arch, str) else arch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = init_model(cfg, policy or DTypePolicy(), seed=0,
                       torch_device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    prompts = make_prompts(cfg.vocab, batch, prompt_len, seed=1, device=DEV)
    warm = generate(model, prompts[:, :16], gen=2)       # cuBLAS warm-up
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    out = generate(model, prompts, gen)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, want in expect.items():
        if launches[name] != want:
            raise AssertionError(f"{phase} launched {name} "
                                 f"{launches[name]} times, expected {want}")
    toks = out["tokens"]
    if not (out["all_finite"] and toks.shape == (batch, gen)
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab):
        raise AssertionError(f"{phase} output malformed: finite="
                             f"{out['all_finite']}, tokens {tuple(toks.shape)}")
    rec = dict(phase=phase, arch=cfg.name,
               dtype=str(model.embed.dtype).removeprefix("torch."),
               params=n_params, batch=batch, prompt_len=prompt_len, gen=gen,
               init_s=init_s, warmup_prefill_ms=warm["prefill_ms"],
               prefill_ms=out["prefill_ms"],
               prefill_tokens_per_s=batch * prompt_len / out["prefill_ms"]
               * 1e3,
               decode_first_ms=out["decode_ms"][0],
               decode_p50_ms=out["decode_p50_ms"],
               decode_p90_ms=out["decode_p90_ms"],
               decode_tokens_per_s=out["decode_tokens_per_s"],
               launches=launches, all_finite=out["all_finite"],
               sample_row0=toks[0][:16].tolist(),
               peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    if extra is not None:
        rec.update(extra(cfg, model, prompts))
        rec["prefill_over_bound"] = rec["prefill_ms"] / rec["prefill_bound_ms"]
        rec["decode_p50_over_bound"] = (rec["decode_p50_ms"]
                                        / rec["decode_bound_ms"])
        if "decode_bound_all_experts_ms" in rec:
            rec["decode_p50_over_bound_all_experts"] = (
                rec["decode_p50_ms"] / rec["decode_bound_all_experts_ms"])
    emit(rec)
    return rec


def phase_serve(card: str) -> dict:
    from repro_torch.configs import get_config

    gen = 32
    n_layers = get_config("rwkv6-3b").n_layers
    return _serve(card, "serve", "rwkv6-3b", 512,
                  {"wkv6": n_layers * gen}, gen=gen)


# ---------------------------------------------------------------------------
# rglru kernel / hybrid_parity / serve_hybrid phases: the RecurrentGemma
# serving path
# ---------------------------------------------------------------------------


def rglru_inputs(B: int, T: int, C: int, with_state: bool, seed: int):
    """Recurrence inputs in the model's regime: a = exp(-8 softplus(lam)
    r) with lam uniform in [0.2, 0.9) and r = sigmoid(n); b = sqrt(1 -
    a^2) * sigmoid(n) * n; a standard normal start state when asked."""
    import torch.nn.functional as F

    g = torch.Generator(device=DEV).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=DEV)

    lam = torch.rand((C,), generator=g, device=DEV) * 0.7 + 0.2
    a = torch.exp(-8.0 * F.softplus(lam) * torch.sigmoid(n(B, T, C)))
    b = torch.sqrt(1 - a * a) * torch.sigmoid(n(B, T, C)) * n(B, T, C)
    h0 = n(B, C) if with_state else None
    return a, b, h0


def rglru_bound(a, h0) -> dict:
    """The least time of one ``rglru`` call: its bytes
    (``kernels/rglru/ops.py::work``: a, b and the start state read once,
    h and the final state written once) over HBM bandwidth, against one
    multiply and one add per element over the fp32 non-tensor-core
    rate."""
    from repro_torch.kernels.rglru.ops import work

    ops, nbytes = work(a, h0)
    t_bytes = nbytes / H100.hbm_bytes_per_s * 1e3
    t_ops = ops / H100.fp32_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def phase_rglru(card: str) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import ops as rops
    from repro_torch.kernels.rglru import rglru_plain

    lib = rops.build()
    regs = _ptxas_regs(_build.ptxas_report(rops.SOURCE))
    recs = {}
    for shape, (B, T, C), with_state in RGLRU_SHAPES:
        a, b, h0 = rglru_inputs(B, T, C, with_state, seed=T)
        aliased = None
        if with_state:                  # the decode cache's in-place update
            state = h0.clone()
            h_k, t_k = rops.rglru(a, b, state, h_out=state)
            aliased = t_k.data_ptr() == state.data_ptr()
        else:
            h_k, t_k = rops.rglru(a, b)
        h_p, t_p = rglru_plain(a, b, h0)
        torch.cuda.synchronize()
        equal = torch.equal(h_k, h_p) and torch.equal(t_k, t_p)
        err = float(max((h_k - h_p).abs().max(), (t_k - t_p).abs().max()))
        if not equal or aliased is False:
            raise AssertionError(f"rglru != plain ({shape}): max abs err "
                                 f"{err}, h_out aliased {aliased}")
        h = torch.empty_like(a)
        h_out = torch.empty((B, C), device=DEV)
        h0_ptr = None if h0 is None else h0.data_ptr()

        def launch():
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.rglru_launch(a.data_ptr(), b.data_ptr(), h0_ptr,
                                  h.data_ptr(), h_out.data_ptr(), B, T, C,
                                  stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        plain = lambda: rglru_plain(a, b, h0)  # noqa: E731
        p_iters = 3 if T > 64 else 20
        rec = dict(phase="rglru_kernel", kernel="rglru", shape=shape, B=B,
                   T=T, C=C, h0=with_state, equal=equal, max_abs_err=err,
                   h_out_aliased=aliased, ms=graph_ms(launch),
                   eager_ms=cuda_ms(launch),
                   plain_ms=graph_ms(plain, iters=p_iters),
                   plain_eager_ms=cuda_ms(plain, iters=p_iters, warmup=1),
                   **rglru_bound(a, h0),
                   geometry=rops.geometry(a, b, h0, h, h_out),
                   ptxas_regs=regs, card=card)
        emit(with_floor(rec))
        recs[shape] = rec
    return dict(recs["prefill"], decode=recs["decode"])


def phase_hybrid_parity(card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru import ops as rops

    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              d_model=256, d_head=64, rg_lru_width=256,
                              n_layers=5)
    steps = 8
    rops.reset_launch_count()
    rec = dict(phase="hybrid_parity", **_decode_parity(cfg, 48, seed=3,
                                                       steps=steps),
               heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
               window=cfg.local_window,
               rglru_launches=rops.launch_count(), card=card)
    want = 4 * (1 + steps)                 # 4 RG-LRU layers on the card
    if rec["rglru_launches"] != want:
        raise AssertionError(f"hybrid_parity launched rglru "
                             f"{rec['rglru_launches']} times, expected {want}")
    emit(rec)
    return rec


def phase_serve_hybrid(card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import hybrid_layout

    gen = 32
    n_groups, tail = hybrid_layout(get_config("recurrentgemma-9b"))
    n_rg = 2 * n_groups + tail
    return _serve(card, "serve_hybrid", "recurrentgemma-9b", 3072,
                  {"rglru": n_rg * gen}, gen=gen)


# ---------------------------------------------------------------------------
# dense_parity / serve_dense / serve_dense_bf16 / scenario_llm phases: the
# dense LM family (no hand-written kernel on its path) and the one-device
# scenario mesh over its MLP GEMMs
# ---------------------------------------------------------------------------

DENSE_PARITY = ("qwen3-8b", "qwen2.5-14b", "smollm-135m")


def _nondefault_norms_and_biases(model, seed: int) -> None:
    """Every norm weight (MLA's latent ``q_norm`` and ``kv_norm`` too)
    ``1 + 0.2 N`` and every QKV bias ``0.5 N``, drawn by numpy from
    ``seed``: the JAX package inits them to one and zero, which would
    leave qk-norm, the latent norms and the biases unexercised."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln1", "ln2", "final_norm", "q_norm", "k_norm",
                        "kv_norm"):
                draw = 1.0 + 0.2 * rng.standard_normal(p.shape)
            elif leaf in ("bq", "bk", "bv"):
                draw = 0.5 * rng.standard_normal(p.shape)
            else:
                continue
            p.copy_(torch.as_tensor(draw, dtype=p.dtype))


def phase_dense_parity(card: str) -> dict:
    """The three dense variants (qk-norm, QKV bias, tied embeddings)
    reduced, widened to d_model 256 with 4 heads of 64, on cuda against
    the CPU in float32, with non-default norm weights and biases."""
    from repro_torch.configs import get_config

    out = {}
    for i, arch in enumerate(DENSE_PARITY):
        cfg = dataclasses.replace(get_config(arch).reduced(), d_model=256,
                                  d_head=64)
        out[arch] = dict(qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                         tied=cfg.tie_embeddings, heads=cfg.n_heads,
                         kv_heads=cfg.n_kv_heads,
                         **_decode_parity(cfg, 48, seed=11 + i,
                                          prepare=_nondefault_norms_and_biases))
    rec = dict(phase="dense_parity", variants=out,
               max_rel_err=max(v["max_rel_err"] for v in out.values()),
               tol=LM_TOL, card=card)
    emit(rec)
    return rec


def _dense_extra(cfg, model, prompts) -> dict:
    """The dense serve cell's least times and a profile of one decode
    step after a prefill of ``prompts`` (device busy share, kernels)."""
    from repro_torch.models.transformer import decode_step, prefill

    batch, prompt_len = prompts.shape
    logits, cache, length = prefill(model, prompts, prompt_len + 1)
    token = logits.argmax(-1).to(torch.int32)
    # the step writes position ``length`` in place each call: repeatable
    prof = _profiled(lambda: decode_step(model, token, cache, length))
    return dict(dense_serve_bound(cfg, model, batch, prompt_len),
                decode_step_profile=prof)


def phase_serve_dense(card: str) -> dict:
    """``qwen3-8b`` at full width in float32: no hand-written kernel may
    launch (the dense path has none)."""
    return _serve(card, "serve_dense", "qwen3-8b", 1024,
                  {name: 0 for name in _launch_counters()},
                  extra=_dense_extra)


def phase_serve_dense_bf16(card: str) -> dict:
    """``qwen2.5-14b`` at full width in bfloat16 (59 GB in float32)."""
    from repro_torch.models.common import DTypePolicy

    return _serve(card, "serve_dense_bf16", "qwen2.5-14b", 512,
                  {name: 0 for name in _launch_counters()},
                  policy=DTypePolicy.bf16(), extra=_dense_extra)


# ---------------------------------------------------------------------------
# moe_parity / serve_moe / serve_moe_gqa phases: the moe family (no
# hand-written kernel on its path)
# ---------------------------------------------------------------------------

MOE_PARITY = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
# a routed set may differ between the devices only where the CPU's k-th
# and (k+1)-th router logits are this close, relative to the row's max
ROUTE_TIE = 1e-5
# the depth each serve cell keeps: deepseek's leading dense layer and 7 MoE
# layers (58.4 GB in bf16), llama4's one (dense, MoE) group (37.1 GB)
MOE_CUTS = {"deepseek-v2-236b": 8, "llama4-maverick-400b-a17b": 2}


class _Routes:
    """Records every ``repro_torch.models.moe._route`` call's router
    logits and expert ids while the ``with`` block runs."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.mod, self.real, self.calls = moe_mod, moe_mod._route, []

        def route(logits, top_k):
            gates, idx = self.real(logits, top_k)
            self.calls.append((logits, idx))
            return gates, idx

        moe_mod._route = route
        return self

    def __exit__(self, *exc):
        self.mod._route = self.real


def _same_routes(calls, top_k: int) -> dict:
    """The CPU's and the card's routing calls, paired in order: each
    token's set of experts equal, or differing only where the CPU's k-th
    and (k+1)-th logits lie within ``ROUTE_TIE`` of the row's max
    |logit| (a near-tie, counted)."""
    cpu = [c for c in calls if c[0].device.type == "cpu"]
    dev = [c for c in calls if c[0].device.type != "cpu"]
    if len(cpu) != len(dev) or not cpu:
        raise AssertionError(f"moe_parity routed {len(cpu)} times on the "
                             f"CPU and {len(dev)} on the card")
    tokens = ties = 0
    for (logits, want), (_, got) in zip(cpu, dev):
        want = want.sort(-1).values
        got = got.cpu().sort(-1).values
        tokens += want.shape[0]
        for row in torch.nonzero((want != got).any(-1)).flatten().tolist():
            top = logits[row].sort(descending=True).values
            gap = float(top[top_k - 1] - top[top_k])
            if gap >= ROUTE_TIE * float(logits[row].abs().max()):
                raise AssertionError(
                    f"moe_parity: token {row} routed to {got[row].tolist()} "
                    f"on the card, {want[row].tolist()} on the CPU, gap {gap}")
            ties += 1
    return dict(routing_calls=len(cpu), tokens_routed=tokens,
                route_near_ties=ties, route_tie_tol=ROUTE_TIE)


def phase_moe_parity(card: str) -> dict:
    """Both moe configs reduced, widened to d_model 256 (4 heads of 64; 8
    experts, top-2 / top-1, one shared expert), every norm weight drawn
    non-default, on cuda against the CPU in float32: a 48-token prompt
    and eight teacher-forced greedy steps; every routing call's expert
    sets equal on both devices but for counted near-ties."""
    from repro_torch.configs import get_config

    out = {}
    for i, arch in enumerate(MOE_PARITY):
        cfg = dataclasses.replace(get_config(arch).reduced(), d_model=256,
                                  d_head=64)
        with _Routes() as routes:
            rec = _decode_parity(cfg, 48, seed=21 + i,
                                 prepare=_nondefault_norms_and_biases)
        out[arch] = dict(rec, mla=cfg.use_mla, experts=cfg.n_experts,
                         top_k=cfg.top_k, moe_every=cfg.moe_every,
                         **_same_routes(routes.calls, cfg.top_k))
    rec = dict(phase="moe_parity", variants=out,
               max_rel_err=max(v["max_rel_err"] for v in out.values()),
               route_near_ties=sum(v["route_near_ties"]
                                   for v in out.values()),
               tol=LM_TOL, card=card)
    emit(rec)
    return rec


def _host_syncs(fn) -> dict:
    """Device-to-host synchronisations one call of ``fn`` makes, counted
    by torch's sync debug mode (one warning each), with the source line
    each warning names and its count."""
    import collections
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return dict(host_syncs_per_step=sum(sites.values()),
                host_sync_sites=dict(sites))


def _moe_extra(cfg, model, prompts) -> dict:
    """The MoE serve cell's depth cut, one decode step after a prefill of
    ``prompts`` with its routed experts and host syncs, its profile
    (device busy share, kernels) and the cell's least times."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import decode_step, prefill

    batch, prompt_len = prompts.shape
    logits, cache, length = prefill(model, prompts, prompt_len + 1)
    token = logits.argmax(-1).to(torch.int32)

    def step():   # writes position ``length`` in place: repeatable
        return decode_step(model, token, cache, length)

    step()                                            # warm
    _host_syncs(step)           # the first count carries torch.cuda's own
    with _Routes() as routes:   # one-time setup (a sync in its __init__)
        syncs = _host_syncs(step)      # one a MoE layer: the run lengths
    routed = [int(torch.unique(idx).numel()) for _, idx in routes.calls]
    prof = _profiled(step)
    bound = moe_serve_bound(cfg, model, batch, prompt_len, routed)
    full = get_config(cfg.name).n_layers
    return dict(bound, decode_step_profile=prof,
                reduced={"n_layers": [full, cfg.n_layers],
                         "note": "depth cut to fit one 80 GB card, every "
                                 "width and expert kept; fewer layers raise "
                                 "the host's share of a step"},
                experts_routed_per_layer=routed, moe_layers=len(routed),
                **syncs)


def _serve_moe(card: str, phase: str, arch: str) -> dict:
    """``arch`` at full width in bf16, depth cut to ``MOE_CUTS``, batch 4,
    prompt 512, 32 tokens: no hand-written kernel may launch (the moe
    path has none); the decode step's ratio to the all-experts bound
    beside the routed one."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import DTypePolicy

    cfg = dataclasses.replace(get_config(arch), n_layers=MOE_CUTS[arch])
    return _serve(card, phase, cfg, 512,
                  {name: 0 for name in _launch_counters()},
                  policy=DTypePolicy.bf16(), extra=_moe_extra)


def phase_serve_moe(card: str) -> dict:
    """``deepseek-v2-236b``: MLA, 2 shared and 160 routed experts, top-6,
    8 of 60 layers."""
    return _serve_moe(card, "serve_moe", "deepseek-v2-236b")


def phase_serve_moe_gqa(card: str) -> dict:
    """``llama4-maverick-400b-a17b``: GQA, 1 shared and 128 routed
    experts, top-1, one (dense, MoE) group of 48 layers."""
    return _serve_moe(card, "serve_moe_gqa", "llama4-maverick-400b-a17b")


def phase_scenario_llm(card: str) -> dict:
    """A carbon-aware grid over two dense LLMs' MLP GEMMs
    (``workloads_from_configs``) with ``shard=True``, so the cells pass
    through the one-device scenario mesh: on the card bit for bit the
    unsharded run, and against the CPU by the ``scenario`` phase's
    rule."""
    from repro_torch import distributed
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.pathfinding import (
        DesignSpace,
        ScalarizationSweep,
        ScenarioSweep,
        workloads_from_configs,
    )

    wls = workloads_from_configs(["smollm-135m", "qwen3-8b"])
    sweep = ScenarioSweep(strategy=ScalarizationSweep(
        directions=2, n_chains=4, sweeps=10), shard=True)
    got, walls, meshes = {}, {}, {}
    for dev in (DEV, "cpu"):
        torch.cuda.synchronize()
        kops.reset_launch_count()
        with _Recorder(distributed, "shard_scenarios") as placed:
            t = time.perf_counter()
            got[dev] = sweep.run(wls, key=0, torch_device=dev)
            torch.cuda.synchronize()
            walls[dev] = time.perf_counter() - t
        if dev == DEV:
            launches = kops.launch_count()
        meshes[dev] = [[str(d) for d in call[0][1]] for call in placed.calls]
    for dev in (DEV, "cpu"):
        want = torch.device(dev).type
        if len(meshes[dev]) != 1 or len(meshes[dev][0]) != 1 \
                or not meshes[dev][0][0].startswith(want):
            raise AssertionError(f"scenario_llm on {dev} placed its cells "
                                 f"on {meshes[dev]}, not one {want} device")
    want = 1 + sweep.strategy.sweeps + 1
    if launches != want:
        raise AssertionError(f"scenario_llm launched prefix_select "
                             f"{launches} times, not {want}")
    plain = dataclasses.replace(sweep, shard=False).run(wls, key=0,
                                                        torch_device=DEV)
    for s in plain.scenarios:
        a, b = got[DEV].results[s.key], plain.results[s.key]
        if not (a.best == b.best and a.best_cost == b.best_cost
                and a.history == b.history
                and np.array_equal(a.frontier.encoded, b.frontier.encoded)
                and np.array_equal(a.frontier.vectors, b.frontier.vectors)):
            raise AssertionError(f"scenario_llm cell {s.key}: shard=True "
                                 "differs from shard=False on the card")
    space, worst, cells = DesignSpace(), 0.0, {}
    for s in got["cpu"].scenarios:
        res = got[DEV].results[s.key]
        if not (np.all(np.isfinite(res.frontier.vectors))
                and math.isfinite(res.best_cost)):
            raise AssertionError(f"scenario_llm cell {s.key} malformed")
        worst = max(worst, _same_result(f"scenario_llm.{'/'.join(s.key)}",
                                        res, got["cpu"].results[s.key],
                                        space))
        cells["/".join(s.key)] = dict(frontier=len(res.frontier),
                                      best_cost=res.best_cost)
    rec = dict(phase="scenario_llm",
               workloads=[[w.name, w.M, w.K, w.N] for w in wls],
               cells=len(cells), sweeps=sweep.strategy.sweeps,
               chains_per_cell=sweep.strategy.directions
               * sweep.strategy.n_chains, mesh=meshes,
               shard_false_equal=True,
               launches={"prefix_select": launches},
               cuda_s=walls[DEV], cpu_s=walls["cpu"], max_rel_dev=worst,
               cells_out=cells, card=card)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# mesh_one / ep_shards phases: the multi-rank paths at one rank on the card
# ---------------------------------------------------------------------------

MESH_TOL = 1e-6           # of each leaf's max |value|: the 1 x 1 mesh step
EP_TOL = 1e-5             # of max |y|: the summed expert-parallel shards
MESH_RUN = dict(seq=64, batch=4, steps=3)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_mesh_one(card: str) -> dict:
    """NCCL at world size 1: (i) scenario_llm's grid split over the live
    group's one rank against ``shard=False``, bit for bit; (ii) the
    reduced smollm train step on a 1 x 1 cuda ``DeviceMesh`` against
    the plain step."""
    import torch.distributed as dist

    from repro_torch import distributed
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw
    from repro_torch.pathfinding import (
        ScalarizationSweep,
        ScenarioSweep,
        workloads_from_configs,
    )

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    prior = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        init_s = time.perf_counter() - t0
        # (i) the scenario grid over the group
        wls = workloads_from_configs(["smollm-135m", "qwen3-8b"])
        sweep = ScenarioSweep(strategy=ScalarizationSweep(
            directions=2, n_chains=4, sweeps=10), shard=True)
        torch.cuda.synchronize()
        kops.reset_launch_count()
        with _Recorder(distributed, "shard_scenarios") as placed:
            t = time.perf_counter()
            got = sweep.run(wls, key=0, torch_device=DEV)
            torch.cuda.synchronize()
            split_s = time.perf_counter() - t
        launches = kops.launch_count()
        meshes = [call[0][1] for call in placed.calls]
        if len(meshes) != 1 or type(meshes[0]).__name__ != "DeviceMesh" \
                or meshes[0].size() != 1 \
                or meshes[0].device_type != torch.device(DEV).type:
            raise AssertionError(f"mesh_one placed its cells on {meshes}, "
                                 f"not the group's one-rank {DEV} mesh")
        want = 1 + sweep.strategy.sweeps + 1
        if launches != want:
            raise AssertionError(f"mesh_one launched prefix_select "
                                 f"{launches} times, not {want}")
        plain = dataclasses.replace(sweep, shard=False).run(
            wls, key=0, torch_device=DEV)
        for sc in plain.scenarios:
            a, b = got.results[sc.key], plain.results[sc.key]
            if not (a.best == b.best and a.best_cost == b.best_cost
                    and a.history == b.history
                    and np.array_equal(a.frontier.encoded,
                                       b.frontier.encoded)
                    and np.array_equal(a.frontier.vectors,
                                       b.frontier.vectors)):
                raise AssertionError(f"mesh_one cell {sc.key}: the split "
                                     "grid differs from shard=False")
        # (ii) the train step on a 1 x 1 DeviceMesh against the plain one
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        cfg = get_config("smollm-135m").reduced()
        policy = DTypePolicy()
        opt_cfg = adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2,
                                    total_steps=30)
        pipe = SyntheticTokenPipeline(DataConfig(
            cfg.vocab, MESH_RUN["seq"], MESH_RUN["batch"]), torch_device=DEV)
        runs, step_ms = {}, {}
        mesh = make_host_mesh(1, DEV)
        for name, m in (("plain", None), ("mesh", mesh)):
            model = init_model(cfg, policy, seed=0, torch_device=DEV,
                               trainable=True)
            step = build_train_step(cfg, m, opt_cfg, policy, remat=True)[0]
            state = adamw.init(dict(model.named_parameters()), opt_cfg)
            losses, times = [], []
            for i in range(MESH_RUN["steps"]):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = step(model, state, pipe.batch(i))
                losses.append(float(metrics["loss"]))
                times.append((time.perf_counter() - t) * 1e3)
            params = dict(model.named_parameters())
            dtensors = sum(distributed.sharding.is_dtensor(p)
                           for p in params.values())
            if (m is not None) != (dtensors == len(params)):
                raise AssertionError(f"mesh_one {name}: {dtensors} of "
                                     f"{len(params)} parameters are "
                                     "DTensors")
            runs[name] = (losses, {k: distributed.sharding.full(p).detach()
                                   for k, p in params.items()})
            step_ms[name] = times
        (la, pa), (lb, pb) = runs["plain"], runs["mesh"]
        bitwise = la == lb and all(torch.equal(pa[k], pb[k]) for k in pa)
        worst = max(float((pa[k] - pb[k]).abs().max())
                    / max(float(pa[k].abs().max()), 1e-30) for k in pa)
        loss_rel = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
        if not bitwise and max(worst, loss_rel) > MESH_TOL:
            raise AssertionError(f"mesh_one: the 1 x 1 mesh step is "
                                 f"{worst} (params) / {loss_rel} (loss) "
                                 f"off the plain step, > {MESH_TOL}")
    finally:
        torch.use_deterministic_algorithms(False)
        if prior is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior
        dist.destroy_process_group()
    rec = dict(phase="mesh_one", backend="nccl", world_size=1,
               init_s=init_s, scenario_cells=len(plain.scenarios),
               scenario_split_equal=True, scenario_split_s=split_s,
               launches={"prefix_select": launches},
               train_steps=MESH_RUN, train_bitwise=bitwise,
               train_max_rel_param=worst, train_max_rel_loss=loss_rel,
               train_losses=runs["mesh"][0], step_ms=step_ms,
               seconds=time.perf_counter() - t0, card=card)
    emit(rec)
    return rec


def phase_ep_shards(card: str) -> dict:
    """The four ranks' ``_ep_shard`` of the reduced deepseek-v2-236b's
    first MoE layer summed on the card, against the CPU and against
    ``moe_forward(exact=True)``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import init_model

    t0 = time.perf_counter()
    cfg = get_config("deepseek-v2-236b").reduced()
    layer = init_model(cfg, DTypePolicy(), seed=0,
                       torch_device="cpu").moe_layers[0].moe
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    ep = 4
    e_loc = cfg.n_experts // ep

    def summed(lay, xs, exact):
        return sum(moe_mod._ep_shard(
            lay.router, *(w[r * e_loc:(r + 1) * e_loc]
                          for w in (lay.w_gate, lay.w_up, lay.w_down)),
            xs, cfg, r, ep, exact=exact) for r in range(ep))

    errs = {}
    with torch.inference_mode():
        card_layer = copy.deepcopy(layer).to(DEV)
        xd = x.to(DEV)
        for exact in (True, False):
            got = summed(card_layer, xd, exact).cpu()
            want = summed(layer, x, exact)
            errs[f"vs_cpu_{'exact' if exact else 'capped'}"] = float(
                (got - want).abs().max()) / float(want.abs().max())
        whole = moe_mod.moe_forward(card_layer, xd, cfg, exact=True)
        split = summed(card_layer, xd, True) + moe_mod.mlp_forward(
            card_layer.shared, xd)
        errs["vs_moe_forward"] = float((split - whole).abs().max()) \
            / float(whole.abs().max())
    for name, err in errs.items():
        if not err <= EP_TOL:
            raise AssertionError(f"ep_shards {name}: {err} > {EP_TOL}")
    rec = dict(phase="ep_shards", arch=cfg.name, ranks=ep,
               tokens=int(x.shape[0] * x.shape[1]), max_rel=errs,
               seconds=time.perf_counter() - t0, card=card)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# train_parity / train / vlm_audio_parity / vlm / audio phases: the training
# path and the vlm and audio families (no hand-written kernel on their
# paths)
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-5          # relative: a step's loss, grad norm, lr, cuda vs CPU
GRAD_TOL = 1e-5           # of max |value|: first-step gradients, attention's
# The parameters after five steps, cuda vs CPU, of each leaf's max |value|.
# Adam moves an element by about lr * sign(g) whatever |g|, so an element
# whose gradient lies at the float32 summation noise (~2e-6 of the leaf's
# max here) can move the other way on the other device: up to 2 lr = 3e-3
# absolute at step 1. Such elements must stay rare (TRAIN_PARAM_SHARE of a
# leaf beyond GRAD_TOL) and within TRAIN_PARAM_TOL.
TRAIN_PARAM_TOL = 2e-3
TRAIN_PARAM_SHARE = 1e-3
# smollm-135m at full width: fault seed 11 at rate 0.12 fails step 19 once,
# which replays from the step-10 checkpoint
TRAIN_RUN = dict(batch=8, seq=256, steps=30, ckpt_every=10, fail_rate=0.12)


def _widened(name: str):
    """``name`` reduced, then widened to d_model 256 in heads of 64."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name).reduced(), d_model=256,
                               d_head=64)


def _max_rel(got, want) -> float:
    """max |got - want| over max |want|, on the CPU in float32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def _no_kernel_launched(phase: str, counters: dict) -> dict:
    launches = {name: fn.launches for name, fn in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"{phase} launched hand-written kernels "
                             f"{launches}; its path has none")
    return launches


def phase_train_parity(card: str) -> dict:
    """The reduced ``smollm-135m`` widened to d_model 256 on cuda against
    the same weights and batches on the CPU: the first step's gradients,
    then five ``train_step``s; then ``chunked_attention``'s gradients on
    both devices (causal, non-causal, a window of 100) at S = 300 in
    chunks of 128 (a ragged last chunk), G = 2."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import train_step
    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.transformer import init_model, loss_fn
    from repro_torch.optim import adamw

    cfg = _widened("smollm-135m")
    opt_cfg = adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=5)
    models = {"cpu": init_model(cfg, seed=21, torch_device="cpu",
                                trainable=True)}
    models[DEV] = init_model(cfg, seed=21, torch_device=DEV, trainable=True)
    models[DEV].load_state_dict(models["cpu"].state_dict())
    states = {d: adamw.init(dict(m.named_parameters()), opt_cfg)
              for d, m in models.items()}
    pipes = {d: SyntheticTokenPipeline(DataConfig(cfg.vocab, 64, 4),
                                       torch_device=d) for d in models}
    grads = {}
    for d, m in models.items():
        params = dict(m.named_parameters())
        loss = loss_fn(m, pipes[d].batch(0))
        grads[d] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    grad_err = max(_max_rel(grads[DEV][k], g) for k, g in grads["cpu"].items())
    if grad_err > GRAD_TOL:
        raise AssertionError(f"train_parity first-step gradients: {grad_err} "
                             f"> {GRAD_TOL}")
    steps = []
    for i in range(5):
        batches = {d: p.batch(i) for d, p in pipes.items()}
        if not torch.equal(batches[DEV]["tokens"].cpu(),
                           batches["cpu"]["tokens"]):
            raise AssertionError(f"train_parity step {i}: the pipelines' "
                                 "tokens differ")
        metrics = {}
        for d, m in models.items():
            states[d], metrics[d] = train_step(m, states[d], batches[d],
                                               opt_cfg)
        errs = {k: abs(float(metrics[DEV][k]) - float(metrics["cpu"][k]))
                / abs(float(metrics["cpu"][k])) for k in
                ("loss", "grad_norm", "lr")}
        if max(errs.values()) > TRAIN_TOL:
            raise AssertionError(f"train_parity step {i}: {errs} > "
                                 f"{TRAIN_TOL}")
        steps.append(dict(loss=float(metrics["cpu"]["loss"]),
                          grad_norm=float(metrics["cpu"]["grad_norm"]),
                          **{f"{k}_rel_err": v for k, v in errs.items()}))
    param_err, share = 0.0, 0.0
    for p, q in zip(models[DEV].parameters(), models["cpu"].parameters()):
        diff = (p.detach().cpu() - q.detach()).abs()
        scale = q.detach().abs().max()
        param_err = max(param_err, float(diff.max() / scale))
        share = max(share, float((diff > GRAD_TOL * scale).float().mean()))
    if param_err > TRAIN_PARAM_TOL or share > TRAIN_PARAM_SHARE:
        raise AssertionError(f"train_parity parameters after 5 steps: "
                             f"{param_err} > {TRAIN_PARAM_TOL} or a share "
                             f"{share} > {TRAIN_PARAM_SHARE} beyond {GRAD_TOL}")
    rng = np.random.default_rng(5)
    b, s, kv, g, dh = 2, 300, 2, 2, 64
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, kv, g, dh), (b, s, kv, dh), (b, s, kv, dh), (b, s, kv, g, dh))]
    attn = {}
    for name, causal, window in (("causal", True, None),
                                 ("noncausal", False, None),
                                 ("window", True, 100)):
        out = {}
        for d in (DEV, "cpu"):
            q, k, v, do = (torch.tensor(a, device=d) for a in arrays)
            q, k, v = (x.requires_grad_() for x in (q, k, v))
            o = chunked_attention(q, k, v, causal=causal, window=window,
                                  q_chunk=128, kv_chunk=128)
            out[d] = (o.detach(),) + torch.autograd.grad(o, (q, k, v), do)
        errs = dict(zip(("out", "dq", "dk", "dv"), (
            _max_rel(a, c) for a, c in zip(out[DEV], out["cpu"]))))
        if max(errs.values()) > GRAD_TOL:
            raise AssertionError(f"train_parity attention {name}: {errs} > "
                                 f"{GRAD_TOL}")
        attn[name] = errs
    rec = dict(phase="train_parity", d_model=cfg.d_model,
               layers=cfg.n_layers, batch=4, seq=64, steps=steps,
               tol=TRAIN_TOL, first_grads_max_rel_err=grad_err,
               grad_tol=GRAD_TOL, param_max_rel_err=param_err,
               param_tol=TRAIN_PARAM_TOL, param_share_beyond_grad_tol=share,
               param_share_tol=TRAIN_PARAM_SHARE, attention_grads=attn,
               attention_shape=[b, s, kv, g, dh],
               card=card)
    emit(rec)
    return rec


def phase_train(card: str) -> dict:
    """``smollm-135m`` at full width and depth in float32 through
    ``repro_torch.launch.train.train``: once with an injected failure
    (checkpoints every 10 steps) and once fault-free, both under
    ``torch.use_deterministic_algorithms(True)``, which must end with
    equal parameters and moments; then one profiled step and, apart,
    its AdamW update."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import train_step
    from repro_torch.optim import adamw

    cfg, run = get_config("smollm-135m"), TRAIN_RUN
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    prior = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"   # read at each call
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {}
        for tag, rate, every in (("faulty", run["fail_rate"],
                                  run["ckpt_every"]),
                                 ("clean", 0.0, run["steps"])):
            t = time.perf_counter()
            out[tag] = train_mod.train(
                cfg, steps=run["steps"], batch=run["batch"], seq=run["seq"],
                ckpt_every=every, fail_rate=rate, torch_device=DEV,
                log=lambda line: None)
            torch.cuda.synchronize()
            out[tag]["run_s"] = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(False)
        if prior is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior
    launches = _no_kernel_launched("train", counters)
    faulty, clean = out["faulty"], out["clean"]
    if faulty["stats"].restarts < 1:
        raise AssertionError("train: no failure was injected")
    losses = faulty["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train: the loss did not fall "
                             f"({losses[0]} -> {losses[-1]})")
    pairs = list(zip(faulty["model"].parameters(), clean["model"].parameters()))
    for moments in ("mu", "nu"):
        pairs += [(getattr(faulty["opt_state"], moments)[k], m)
                  for k, m in getattr(clean["opt_state"], moments).items()]
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(
            "train: the run with a restart differs from the fault-free run "
            f"(max rel diff {max(_max_rel(a, b) for a, b in pairs)})")
    model, opt_state = clean["model"], clean["opt_state"]
    steady = clean["step_s"][2:]
    p50_ms = float(np.median(steady)) * 1e3
    tokens = run["batch"] * run["seq"]
    bound = lm_step_bound(cfg, model, run["batch"], run["seq"], train=True)
    batch = SyntheticTokenPipeline(DataConfig(
        cfg.vocab, run["seq"], run["batch"]), torch_device=DEV).batch(0)
    opt_cfg = adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=10,
                                total_steps=run["steps"])
    prof = _profiled(lambda: train_step(model, opt_state, batch, opt_cfg))
    params = dict(model.named_parameters())
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    opt_prof = _profiled(lambda: adamw.apply_updates(params, grads,
                                                     opt_state, opt_cfg))
    stats = faulty["stats"]
    rec = dict(phase="train", arch=cfg.name, dtype="float32",
               params=sum(p.numel() for p in model.parameters()),
               batch=run["batch"], seq=run["seq"], steps=run["steps"],
               ckpt_every=run["ckpt_every"], fail_rate=run["fail_rate"],
               fault_seed=train_mod.FAULT_SEED, loss_first=losses[0],
               loss_last=losses[-1], restarts=stats.restarts,
               replayed_steps=stats.replayed_steps,
               executed_steps=len(losses), params_equal_fault_free=True,
               deterministic=True, faulty_run_s=faulty["run_s"],
               clean_run_s=clean["run_s"], step_p50_ms=p50_ms,
               step_p90_ms=float(np.percentile(steady, 90)) * 1e3,
               first_step_ms=clean["step_s"][0] * 1e3,
               tokens_per_s=tokens / p50_ms * 1e3, peak_mem_bytes=peak,
               **bound, bound_share=bound["bound_ms"] / p50_ms,
               step_profile=prof, optimizer_profile=opt_prof,
               launches=launches, card=card)
    emit(rec)
    return rec


def phase_vlm_audio_parity(card: str) -> dict:
    """The reduced ``internvl2-26b`` and ``hubert-xlarge`` widened to
    d_model 256, every norm weight drawn non-default, on cuda against the
    CPU in float32: ``forward`` on a 4-row patch prefix and 48 tokens
    (vlm) and on 64 frame embeddings (audio), within ``LM_TOL`` of max
    |logit|; the vlm backbone's 48-token prefill and eight teacher-forced
    steps by ``_decode_parity``."""
    from repro_torch.models.transformer import forward, init_model

    out = {}
    for arch, seed in (("internvl2-26b", 31), ("hubert-xlarge", 33)):
        cfg = _widened(arch)
        cpu = init_model(cfg, seed=seed, torch_device="cpu")
        _nondefault_norms_and_biases(cpu, seed)
        gpu = init_model(cfg, seed=seed, torch_device=DEV)
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(seed)
        if cfg.family == "vlm":
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 48)))
            embeds = torch.as_tensor(rng.standard_normal(
                (2, cfg.frontend_prefix, cfg.d_model)).astype(np.float32))
        else:
            tokens = None
            embeds = torch.as_tensor(rng.standard_normal(
                (2, 64, cfg.d_model)).astype(np.float32))
        want = forward(cpu, tokens, embeds)[0]
        got = forward(gpu, None if tokens is None else tokens.to(DEV),
                      embeds.to(DEV))[0]
        err = _max_rel(got, want)
        if not (torch.isfinite(got).all() and err <= LM_TOL):
            raise AssertionError(f"vlm_audio_parity {arch} forward: {err} > "
                                 f"{LM_TOL}")
        out[arch] = dict(family=cfg.family, forward_shape=list(want.shape),
                         forward_max_rel_err=err)
    out["internvl2-26b"]["decode"] = _decode_parity(
        _widened("internvl2-26b"), 48, seed=35,
        prepare=_nondefault_norms_and_biases)
    rec = dict(phase="vlm_audio_parity", families=out, tol=LM_TOL, card=card)
    emit(rec)
    return rec


def phase_vlm(card: str) -> dict:
    """``internvl2-26b`` at full width and depth in bf16 (39.7 GB;
    whether ``require_fits`` takes its 79.4 GB of float32 weights on the
    card's free memory is recorded): ``prefill_step`` of 4 x 512 tokens,
    32 ``serve_step``s, then ``forward`` of one sequence of a 256-row
    stub patch prefix (numpy draws) and 512 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, require_fits
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models.common import DTypePolicy
    from repro_torch.models.transformer import forward, init_model

    cfg, batch, prompt_len, gen = get_config("internvl2-26b"), 4, 512, 32
    free = torch.cuda.mem_get_info()[0] if DEV == "cuda" else 1 << 62
    try:
        require_fits(cfg, DTypePolicy(), free)
        fp32_fits = True
    except RuntimeError:
        fp32_fits = False
    policy = DTypePolicy.bf16()
    require_fits(cfg, policy, free)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = init_model(cfg, policy, seed=0, torch_device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    prompts = make_prompts(cfg.vocab, batch, prompt_len, seed=1, device=DEV)
    logits, cache, length = prefill_step(model, {"tokens": prompts[:, :16]},
                                         18)                  # warm-up
    serve_step(model, cache, logits.argmax(-1).to(torch.int32), length)
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache, length = prefill_step(model, {"tokens": prompts},
                                         prompt_len + gen)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    finite = torch.isfinite(logits).all()
    token, times, tokens = logits.argmax(-1).to(torch.int32), [], []
    for _ in range(gen):
        t = time.perf_counter()
        token, logits, cache, length = serve_step(model, cache, token, length)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        finite &= torch.isfinite(logits).all()
        tokens.append(token)
    rng = np.random.default_rng(2)
    embeds = torch.as_tensor(rng.standard_normal(
        (1, cfg.frontend_prefix, cfg.d_model)).astype(np.float32),
        device=DEV).to(torch.bfloat16)
    torch.cuda.synchronize()
    t = time.perf_counter()
    full, _ = forward(model, prompts[:1], embeds)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t) * 1e3
    launches = _no_kernel_launched("vlm", counters)
    want_shape = (1, cfg.frontend_prefix + prompt_len, cfg.vocab)
    if not (bool(finite) and torch.isfinite(full).all()
            and tuple(full.shape) == want_shape):
        raise AssertionError(f"vlm output malformed: finite={bool(finite)}, "
                             f"forward {tuple(full.shape)}")
    steady = times[1:]
    p50_ms = float(np.median(steady)) * 1e3
    bound = dense_serve_bound(cfg, model, batch, prompt_len)
    fwd = lm_step_bound(cfg, model, 1, cfg.frontend_prefix + prompt_len,
                        train=False)
    rec = dict(phase="vlm", arch=cfg.name, dtype="bfloat16",
               params=sum(p.numel() for p in model.parameters()),
               weight_bytes=sum(p.numel() * p.element_size()
                                for p in model.parameters()),
               free_bytes_before=free, fp32_weights_fit=fp32_fits,
               init_s=init_s, batch=batch,
               prompt_len=prompt_len, gen=gen, prefill_ms=prefill_ms,
               prefill_tokens_per_s=batch * prompt_len / prefill_ms * 1e3,
               decode_first_ms=times[0] * 1e3, decode_p50_ms=p50_ms,
               decode_p90_ms=float(np.percentile(steady, 90)) * 1e3,
               decode_tokens_per_s=batch / p50_ms * 1e3, **bound,
               prefill_over_bound=prefill_ms / bound["prefill_bound_ms"],
               decode_p50_over_bound=p50_ms / bound["decode_bound_ms"],
               forward_prefix=cfg.frontend_prefix,
               forward_tokens=prompt_len, forward_ms=forward_ms,
               forward_bound_ms=fwd["bound_ms"],
               forward_bound_by=fwd["bound_by"],
               sample_row0=torch.stack(tokens, 1)[0][:16].tolist(),
               all_finite=True, launches=launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    emit(rec)
    return rec


def phase_audio(card: str) -> dict:
    """``hubert-xlarge`` at full width in float32, built to train:
    ``eval_step`` on 4 x 2048 stub frame embeddings, then two
    ``train_step``s on 2 x 1024 frames with frame labels (numpy draws)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import eval_step, train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw

    cfg = get_config("hubert-xlarge")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, seed=0, torch_device=DEV, trainable=True)
    rng = np.random.default_rng(4)

    def frames(b, s):
        return torch.as_tensor(rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32), device=DEV)

    eval_step(model, {"embeds": frames(1, 128)})            # warm-up
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    embeds = frames(4, 2048)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = eval_step(model, {"embeds": embeds})
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t) * 1e3
    if not (tuple(logits.shape) == (4, 2048, cfg.vocab)
            and torch.isfinite(logits).all()):
        raise AssertionError(f"audio eval output malformed: "
                             f"{tuple(logits.shape)}")
    del logits, embeds
    opt_cfg = adamw.AdamWConfig()
    state = adamw.init(dict(model.named_parameters()), opt_cfg)
    batch = {"embeds": frames(2, 1024), "labels": torch.as_tensor(
        rng.integers(0, cfg.vocab, (2, 1024)), device=DEV)}
    steps = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = train_step(model, state, batch, opt_cfg)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t) * 1e3,
                          loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"])))
    launches = _no_kernel_launched("audio", counters)
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in steps):
        raise AssertionError(f"audio train steps not finite: {steps}")
    ev = lm_step_bound(cfg, model, 4, 2048, train=False)
    tr = lm_step_bound(cfg, model, 2, 1024, train=True)
    rec = dict(phase="audio", arch=cfg.name, dtype="float32",
               params=sum(p.numel() for p in model.parameters()),
               eval_batch=4, eval_frames=2048, eval_ms=eval_ms,
               eval_bound_ms=ev["bound_ms"], eval_bound_by=ev["bound_by"],
               eval_frames_per_s=4 * 2048 / eval_ms * 1e3,
               train_batch=2, train_frames=1024, train_steps=steps,
               train_bound_ms=tr["bound_ms"], train_bound_by=tr["bound_by"],
               train_second_over_bound=steps[1]["ms"] / tr["bound_ms"],
               all_finite=True, launches=launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated(), card=card)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# train_grad_kernels / train_families_parity / train_ssm / train_hybrid /
# train_moe phases: training of the moe, ssm and hybrid families, with
# gradients through the wkv6 and rglru kernels
# ---------------------------------------------------------------------------

TRAIN_FAMILIES = ("deepseek-v2-236b", "llama4-maverick-400b-a17b", "rwkv6-3b",
                  "recurrentgemma-9b")
# (B, T, C) of rglru and (B, T, H, D) of wkv6 at the train phases' shapes
# (batch 8 x 256 of recurrentgemma-9b's 4096-wide RG-LRU and of rwkv6-3b's
# 40 heads)
GRAD_KERNEL_SHAPES = {"rglru": (8, 256, 4096), "wkv6": (8, 256, 40, 64)}
# rwkv6-3b and recurrentgemma-9b at full width, the reference CLI's batch,
# 4 steps with a checkpoint every 2: fault seed 11 draws 0.898, 0.249,
# 0.172 and 0.663 for steps 0-3 (0-based), so rate 0.7 fails steps 1, 2
# and 3 once each. Step 1 restarts from the initial weights, step 2 from
# the step-2 checkpoint just taken, and step 3 from that checkpoint too,
# which replays step 2. The checkpoints live in host memory
# (_HostCheckpoints)
RECURRENT_RUN = dict(batch=8, seq=256, steps=4, ckpt_every=2, fail_rate=0.7,
                     lr=3e-3)
# recurrentgemma-9b at full width diverges at train's peak lr of 3e-3: its
# loss went 9.85 -> 19.75 at step 5 and the gradients turned NaN where an
# RG-LRU decay rounded to 1 (ROADMAP, R12), alike through the kernel and
# its plain version; AdamW's default peak of 3e-4 keeps it stable. At that
# lr it takes 8 steps, with a checkpoint every 4 and rate 0.5 (steps 1, 2
# and 6 fail; step 6 restores the step-4 checkpoint and replays steps 4
# and 5)
HYBRID_RUN = dict(RECURRENT_RUN, steps=8, ckpt_every=4, fail_rate=0.5,
                  lr=3e-4)
# recurrentgemma-9b cut 38 -> 6 layers: two whole (RG-LRU, RG-LRU, local
# attention) groups, a 65.75 GB peak on the card; a third group (9 layers)
# adds 0.59 billion parameters, 11.8 GB of train state, past 75 GB
HYBRID_TRAIN_LAYERS = 6
# train_ssm profiles a step of rwkv6-3b cut to this depth at full width:
# the profiler took 210 s to read the 312,203 kernels of a 32-layer step
# (scripts/train_state_probe.py)
SSM_PROFILE_LAYERS = 2
# the train state of each config and depth cut, against the card (the
# reason for train_hybrid's depth and train_moe's width)
TRAIN_FIT = (("rwkv6-3b", None), ("recurrentgemma-9b", None),
             ("recurrentgemma-9b", 6), ("recurrentgemma-9b", 8),
             ("deepseek-v2-236b", 2), ("llama4-maverick-400b-a17b", 2))
TRAIN_STATE_BYTES = 20     # a fp32 parameter, its gradient, the clipped
#                           gradient and two fp32 moments


def _train_cfg(arch: str):
    """The train_families_parity config of ``arch``: reduced and widened
    to d_model 256 in heads of 64; the hybrid at 5 layers (one group and
    the 2-layer tail) with a 256-wide RG-LRU."""
    if arch == "recurrentgemma-9b":
        from repro_torch.configs import get_config

        return dataclasses.replace(get_config(arch).reduced(), d_model=256,
                                   d_head=64, rg_lru_width=256, n_layers=5)
    return _widened(arch)


def _drops(calls, cfg) -> int:
    """Pairs over their expert's capacity in the recorded routing calls
    of one device (``_Routes``), as ``moe_forward`` sizes it in
    training."""
    total = 0
    for _, idx in calls:
        t, k = idx.shape
        cap = int(t * k / cfg.n_experts * cfg.capacity_factor) + 1
        counts = torch.bincount(idx.reshape(-1).cpu(),
                                minlength=cfg.n_experts)
        total += int((counts - cap).clamp(min=0).sum())
    return total


def _grad_err(got, want) -> float:
    return max(_max_rel(g, w) for g, w in zip(got, want))


def phase_train_grad_kernels(card: str) -> dict:
    """The two recurrences' autograd nodes on the card against autograd
    through their plain versions on the card, at the train phases'
    shapes, with and without a start state, under random cotangents of
    the sequence and of the final state: every gradient within
    ``GRAD_TOL`` of its max |value|; forward and backward times (CUDA
    events, eager), the peak memory the backward adds, and for
    ``rglru`` the backward's reverse launch alone in a CUDA graph with
    its bound."""
    from repro_torch.kernels.rglru import ops as rops
    from repro_torch.kernels.rglru import rglru_plain
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6 import wkv6_plain

    out = {}
    B, T, C = GRAD_KERNEL_SHAPES["rglru"]
    for with_state in (False, True):
        a, b, h0 = rglru_inputs(B, T, C, with_state, seed=T + 7)
        args = [x.requires_grad_() for x in (a, b, h0) if x is not None]
        g, g_fin = torch.randn_like(a), torch.randn_like(a[:, 0])
        before = rops.launch_count()
        got = torch.autograd.grad(rops.rglru(*args), args, (g, g_fin))
        launches = rops.launch_count() - before
        want = torch.autograd.grad(rglru_plain(*args), args, (g, g_fin))
        err = _grad_err(got, want)
        if launches != 2 or err > GRAD_TOL:
            raise AssertionError(f"train_grad_kernels rglru h0={with_state}: "
                                 f"{launches} launches, grad err {err}")
        fwd_ms = cuda_ms(lambda: rops.rglru(*args), iters=20)
        both_ms = cuda_ms(lambda: torch.autograd.grad(
            rops.rglru(*args), args, (g, g_fin)), iters=20)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            rglru_plain(*args), args, (g, g_fin)), iters=3, warmup=1)
        rec = dict(kernel="rglru", B=B, T=T, C=C, h0=with_state,
                   launches=launches, grad_max_rel_err=err, tol=GRAD_TOL,
                   forward_ms=fwd_ms, backward_ms=both_ms - fwd_ms,
                   plain_forward_backward_ms=plain_ms)
        if with_state:                   # the reverse launch alone
            lib = rops.build()
            a_rev = torch.cat([torch.ones_like(a[:, :1]),
                               a.detach()[:, 1:].flip(1)], dim=1)
            g_rev, lam = g.flip(1), torch.empty_like(a)
            lam_t = torch.empty_like(g_fin)

            def reverse():
                stream = torch.cuda.current_stream().cuda_stream
                rc = lib.rglru_launch(a_rev.data_ptr(), g_rev.data_ptr(),
                                      g_fin.data_ptr(), lam.data_ptr(),
                                      lam_t.data_ptr(), B, T, C, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            rev = rglru_bound(a_rev, g_fin)
            rec.update(reverse_ms=graph_ms(reverse),
                       reverse_bound_ms=rev["bound_ms"],
                       reverse_bound_by=rev["bound_by"])
        out[f"rglru_h0={with_state}"] = rec
    B, T, H, D = GRAD_KERNEL_SHAPES["wkv6"]
    for with_state in (False, True):
        rows = wkv6_inputs(B * H, T, H, with_state, seed=T + 8)
        r, k, v, w = (x.reshape(B, H, T, D).transpose(1, 2).contiguous()
                      for x in rows[:4])
        u, s0 = rows[4], rows[5]
        s0 = None if s0 is None else s0.reshape(B, H, D, D)
        args = [x.requires_grad_() for x in (r, k, v, w, u, s0)
                if x is not None]
        gy = torch.randn_like(r)
        gs = torch.randn((B, H, D, D), device=DEV)
        before = wops.launch_count()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = torch.autograd.grad(wops.wkv6(*args), args, (gy, gs))
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        launches = wops.launch_count() - before
        want = torch.autograd.grad(wkv6_plain(*args), args, (gy, gs))
        err = _grad_err(got, want)
        if launches != 1 or err > GRAD_TOL:
            raise AssertionError(f"train_grad_kernels wkv6 s0={with_state}: "
                                 f"{launches} launches, grad err {err}")
        fwd_ms = cuda_ms(lambda: wops.wkv6(*args), iters=20)
        both_ms = cuda_ms(lambda: torch.autograd.grad(
            wops.wkv6(*args), args, (gy, gs)), iters=3, warmup=1)
        out[f"wkv6_s0={with_state}"] = dict(
            kernel="wkv6", B=B, T=T, H=H, D=D, s0=with_state,
            launches=launches, grad_max_rel_err=err, tol=GRAD_TOL,
            forward_ms=fwd_ms, backward_ms=both_ms - fwd_ms,
            backward_peak_extra_bytes=extra)
    rec = dict(phase="train_grad_kernels", cases=out, card=card)
    emit(rec)
    return rec


def phase_train_families_parity(card: str) -> dict:
    """The four families (``_train_cfg``), every norm weight and bias
    drawn non-default, on cuda against the same weights and batch (4 x
    64) on the CPU in float32: the first step's gradients (remat on)
    within ``GRAD_TOL`` of each leaf's max, then one ``train_step``'s
    loss, grad norm and lr within ``TRAIN_TOL`` relative; MoE routing
    by ``moe_parity``'s near-tie rule, with at least one pair over the
    capacity; ``wkv6`` / ``rglru`` launched on the card."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import train_step
    from repro_torch.models.transformer import init_model, loss_fn
    from repro_torch.optim import adamw

    opt_cfg = adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=5)
    counters = _launch_counters()
    out = {}
    for i, arch in enumerate(TRAIN_FAMILIES):
        cfg, seed = _train_cfg(arch), 51 + i
        models = {"cpu": init_model(cfg, seed=seed, torch_device="cpu",
                                    trainable=True)}
        _nondefault_norms_and_biases(models["cpu"], seed)
        models[DEV] = init_model(cfg, seed=seed, torch_device=DEV,
                                 trainable=True)
        models[DEV].load_state_dict(models["cpu"].state_dict())
        for fn in counters.values():
            fn.launches = 0
        grads, metrics = {}, {}
        with _Routes() as routes:
            for d, m in models.items():
                batch = SyntheticTokenPipeline(DataConfig(cfg.vocab, 64, 4),
                                               torch_device=d).batch(0)
                params = dict(m.named_parameters())
                loss = loss_fn(m, batch, remat=True)
                grads[d] = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
                _, metrics[d] = train_step(
                    m, adamw.init(params, opt_cfg), batch, opt_cfg)
        launches = {name: fn.launches for name, fn in counters.items()}
        grad_err = max(_max_rel(grads[DEV][k], g)
                       for k, g in grads["cpu"].items())
        errs = {k: abs(float(metrics[DEV][k]) - float(metrics["cpu"][k]))
                / abs(float(metrics["cpu"][k])) for k in
                ("loss", "grad_norm", "lr")}
        if grad_err > GRAD_TOL or max(errs.values()) > TRAIN_TOL:
            raise AssertionError(f"train_families_parity {arch}: grads "
                                 f"{grad_err}, step {errs}")
        rec = dict(family=cfg.family, d_model=cfg.d_model,
                   layers=cfg.n_layers, loss=float(metrics["cpu"]["loss"]),
                   grad_norm=float(metrics["cpu"]["grad_norm"]),
                   first_grads_max_rel_err=grad_err,
                   **{f"{k}_rel_err": v for k, v in errs.items()},
                   launches={k: v for k, v in launches.items() if v})
        if cfg.moe:
            cpu_calls = [c for c in routes.calls if c[0].device.type == "cpu"]
            rec.update(_same_routes(routes.calls, cfg.top_k),
                       capacity_drops=_drops(cpu_calls, cfg))
            if rec["capacity_drops"] < 1:
                raise AssertionError(f"train_families_parity {arch}: no "
                                     "pair over capacity")
        else:
            kernel = "wkv6" if cfg.family == "ssm" else "rglru"
            if launches[kernel] < 1:
                raise AssertionError(f"train_families_parity {arch}: "
                                     f"{kernel} never launched")
        out[arch] = rec
    rec = dict(phase="train_families_parity", families=out, batch=4, seq=64,
               grad_tol=GRAD_TOL, tol=TRAIN_TOL, card=card)
    emit(rec)
    return rec


class _HostCheckpoints:
    """The part of ``CheckpointManager`` that ``launch/train.py``'s
    ``train`` calls (``latest``, ``save``, ``restore``), keeping the
    newest checkpoint tree (the JAX package's keys, as numpy) in host
    memory instead of on disk: rwkv6-3b's train state is 37.2 GB on
    disk, a save of it took 64 s and a restore 106 s on the card's
    machine, whose disk had 80.2 GB free (scripts/train_state_probe.py).
    It keeps a tree only when ``hold``."""

    directory = "<host memory>"

    def __init__(self, hold: bool):
        self.hold, self.step, self.tree = hold, None, None

    def latest(self):
        return None if self.tree is None else f"step {self.step}"

    def save(self, step: int, tree: dict) -> str:
        self.step, self.tree = step, tree
        return self.latest()

    def restore(self, like):
        if self.tree is None:
            raise FileNotFoundError("no checkpoint in host memory")
        return self.step, self.tree


@contextlib.contextmanager
def _host_checkpoints(hold: bool):
    """One run of ``train`` with its checkpoints in a
    ``_HostCheckpoints``: its ``CheckpointManager`` is the store, its
    ``save_state`` frees the store's last tree before it builds the next
    (host memory holds one train state at a time) and builds none when
    the store does not hold, and its ``restore_state`` records the step
    it restores. Yields (the store, the restored steps)."""
    from repro_torch.launch import train as train_mod

    store, restored = _HostCheckpoints(hold), []
    prior = (train_mod.CheckpointManager, train_mod.save_state,
             train_mod.restore_state)

    def save_state(mgr, step, model, opt_state):
        mgr.tree = None
        if mgr.hold:
            return prior[1](mgr, step, model, opt_state)

    def restore_state(mgr, model):
        step, opt_state = prior[2](mgr, model)
        restored.append(step)
        return step, opt_state

    train_mod.CheckpointManager = lambda directory, keep: store
    train_mod.save_state, train_mod.restore_state = save_state, restore_state
    try:
        yield store, restored
    finally:
        (train_mod.CheckpointManager, train_mod.save_state,
         train_mod.restore_state) = prior


def _same_as_checkpoint(phase: str, tree: dict, model, opt_state) -> int:
    """``model``'s parameters and ``opt_state``'s moments and step equal
    to ``tree``'s (a ``_HostCheckpoints`` tree, the layers stacked as
    ``lm_params_to_reference`` stacks them), each leaf copied to the
    card and compared there. Returns the bytes compared."""
    if int(opt_state.step) != int(tree["opt_step"]):
        raise AssertionError(f"{phase}: step {int(opt_state.step)} against "
                             f"the checkpoint's {int(tree['opt_step'])}")
    nbytes = 0
    for key, got in (("params", dict(model.named_parameters())),
                     ("opt_mu", opt_state.mu), ("opt_nu", opt_state.nu)):
        for name, x in got.items():
            first, *path = name.split(".")
            layer = int(path.pop(0)) if path and path[0].isdigit() else None
            want = tree[key][first]
            for part in path:
                want = want[part]
            want = torch.from_numpy(want if layer is None else want[layer])
            if not torch.equal(x.detach(), want.to(x.device)):
                raise AssertionError(f"{phase}: {key} {name} differs from "
                                     "the faulty run's")
            nbytes += x.numel() * x.element_size()
    held = sum(x.nbytes for x in _leaves(tree)) - tree["opt_step"].nbytes
    if nbytes != held:
        raise AssertionError(f"{phase}: the checkpoint holds other leaves")
    return nbytes


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _train_twice(card: str, phase: str, cfg, run: dict, kernel=None,
                 per_step: int = 0, profile_cfg=None) -> dict:
    """``cfg`` trained twice by ``repro_torch.launch.train.train`` under
    ``torch.use_deterministic_algorithms(True)``, its checkpoints in host
    memory (``_host_checkpoints``): once with fault seed 11 at
    ``run["fail_rate"]`` and a checkpoint every ``run["ckpt_every"]``
    steps, once fault-free; the faulty run's model is freed before the
    clean one starts. A restart must restore a checkpoint taken after
    step 0 and replay at least one step; the clean run's parameters,
    moments and step must equal the faulty run's last checkpoint to the
    bit, and the loss must fall. ``kernel`` must launch ``per_step``
    times an executed step (no hand-written kernel may launch when
    None). A moe config's capacity drops are counted over the clean
    run's forwards. Then step times against ``lm_step_bound``, peak
    memory and one profiled step, of ``profile_cfg`` when given (a depth
    cut)."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw

    lr = run.get("lr", 3e-3)
    counters = _launch_counters()
    prior = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"   # read at each call
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {}
        for tag, rate, every in (("faulty", run["fail_rate"],
                                  run["ckpt_every"]),
                                 ("clean", 0.0, run["steps"])):
            for fn in counters.values():
                fn.launches = 0
            t = time.perf_counter()
            with _Routes() as routes, \
                    _host_checkpoints(hold=tag == "faulty") as (store, back):
                res = train_mod.train(
                    cfg, steps=run["steps"], batch=run["batch"],
                    seq=run["seq"], lr=lr, ckpt_dir=store.directory,
                    ckpt_every=every, fail_rate=rate, torch_device=DEV,
                    log=lambda line: None)
                torch.cuda.synchronize()
            res.update(run_s=time.perf_counter() - t, restored=back,
                       checkpoint=store.tree, routes=routes.calls,
                       launches={n: fn.launches
                                 for n, fn in counters.items()})
            if tag == "faulty":
                del res["model"], res["opt_state"], res["routes"]
                gc.collect()
                torch.cuda.empty_cache()
            out[tag] = res
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(False)
        if prior is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prior
    faulty, clean = out["faulty"], out["clean"]
    stats = faulty["stats"]
    if not (faulty["restored"] and min(faulty["restored"]) > 0
            and stats.replayed_steps > 0):
        raise AssertionError(f"{phase}: no restart restored a checkpoint and "
                             f"replayed a step (restored "
                             f"{faulty['restored']}, replayed "
                             f"{stats.replayed_steps})")
    losses = faulty["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: the loss did not fall "
                             f"({losses[0]} -> {losses[-1]})")
    model = clean["model"]
    t = time.perf_counter()
    compared = _same_as_checkpoint(phase, faulty.pop("checkpoint"), model,
                                   clean["opt_state"])
    compare_s = time.perf_counter() - t
    launches = {}
    for tag, res in out.items():
        executed = len(res["losses"])
        launches[tag] = {n: c for n, c in res["launches"].items() if c}
        got = res["launches"][kernel] if kernel else sum(
            res["launches"].values())
        if got != executed * per_step or (kernel and per_step < 1):
            raise AssertionError(f"{phase} {tag}: {kernel} launched {got} "
                                 f"times in {executed} steps, expected "
                                 f"{per_step} a step")
    steady = clean["step_s"][2:]
    p50_ms = float(np.median(steady)) * 1e3
    tokens = run["batch"] * run["seq"]
    rec = dict(phase=phase, arch=cfg.name, layers=cfg.n_layers,
               dtype="float32", params=sum(p.numel() for p in
                                           model.parameters()),
               batch=run["batch"], seq=run["seq"], steps=run["steps"],
               ckpt_every=run["ckpt_every"], lr_peak=lr,
               checkpoints="host memory", fail_rate=run["fail_rate"],
               fault_seed=train_mod.FAULT_SEED, loss_first=losses[0],
               loss_last=losses[-1], restarts=stats.restarts,
               restored_steps=faulty["restored"],
               replayed_steps=stats.replayed_steps,
               executed_steps=len(losses), equal_to_fault_free=True,
               bytes_compared=compared, compare_s=compare_s,
               deterministic=True, faulty_run_s=faulty["run_s"],
               clean_run_s=clean["run_s"], step_p50_ms=p50_ms,
               step_p90_ms=float(np.percentile(steady, 90)) * 1e3,
               first_step_ms=clean["step_s"][0] * 1e3,
               tokens_per_s=tokens / p50_ms * 1e3, peak_mem_bytes=peak,
               launches=launches, kernel_launches_per_step=per_step,
               card=card)
    routed = None
    if cfg.moe:
        # each step routes a MoE layer twice: its forward and remat's
        # recompute, which drops the same pairs
        drops = _drops(clean["routes"], cfg) // 2
        routed = (tokens * cfg.top_k * cfg.moe_layout()[0]
                  - drops / run["steps"])
        rec.update(capacity_drops=drops, routed_pairs_per_step=routed)
        if drops < 1:
            raise AssertionError(f"{phase} {cfg.name}: no pair over "
                                 "capacity")
    bound = lm_step_bound(cfg, model, run["batch"], run["seq"], train=True,
                          routed_pairs=routed)
    rec.update(bound, bound_share=bound["bound_ms"] / p50_ms)
    batch = SyntheticTokenPipeline(DataConfig(
        cfg.vocab, run["seq"], run["batch"]), torch_device=DEV).batch(0)
    opt_cfg = adamw.AdamWConfig(lr_peak=lr, warmup_steps=10,
                                total_steps=run["steps"])
    opt_state = clean["opt_state"]
    if profile_cfg is not None:
        del model, clean, out, opt_state
        gc.collect()
        torch.cuda.empty_cache()
        model = init_model(profile_cfg, seed=0, torch_device=DEV,
                           trainable=True)
        opt_state = adamw.init(dict(model.named_parameters()), opt_cfg)
        rec["profile_layers"] = profile_cfg.n_layers
    rec["step_profile"] = _profiled(
        lambda: train_step(model, opt_state, batch, opt_cfg))
    emit(rec)
    return rec


def phase_train_ssm(card: str) -> dict:
    """``rwkv6-3b`` at full width and depth in float32 by
    ``_train_twice`` (``RECURRENT_RUN``); ``wkv6`` launches twice a layer a step (the forward and remat's
    recompute; the backward is the plain recompute, no launch). The
    profiled step is of a ``SSM_PROFILE_LAYERS``-layer cut at full
    width."""
    from repro_torch.configs import get_config

    cfg = get_config("rwkv6-3b")
    return _train_twice(
        card, "train_ssm", cfg, RECURRENT_RUN, "wkv6", 2 * cfg.n_layers,
        profile_cfg=dataclasses.replace(cfg, n_layers=SSM_PROFILE_LAYERS))


def phase_train_hybrid(card: str) -> dict:
    """``recurrentgemma-9b`` at full width cut to ``HYBRID_TRAIN_LAYERS``
    (whole groups) in float32 by ``_train_twice`` (``HYBRID_RUN``: peak
    lr 3e-4); ``rglru`` launches three times a recurrent layer a step (the
    forward, remat's recompute and the backward's reverse launch)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import hybrid_layout

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              n_layers=HYBRID_TRAIN_LAYERS)
    n_groups, tail = hybrid_layout(cfg)
    return _train_twice(card, "train_hybrid", cfg, HYBRID_RUN, "rglru",
                        3 * (2 * n_groups + tail))


def _fit_table() -> list:
    """``TRAIN_FIT``'s rows: parameters, the train state at
    ``TRAIN_STATE_BYTES`` a parameter, the largest leaf in fp32, and
    whether the state and five fp32 temporaries of that leaf fit the
    card's memory."""
    from repro_torch.configs import get_config

    total = torch.cuda.get_device_properties(0).total_memory
    rows = []
    for arch, depth in TRAIN_FIT:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        n = cfg.param_count()
        leaf = 4 * max(cfg.vocab * cfg.d_model,
                       cfg.n_experts * cfg.d_model * cfg.moe_d_ff)
        state = TRAIN_STATE_BYTES * n
        rows.append(dict(arch=arch, layers=cfg.n_layers, params=n,
                         train_state_bytes=state, largest_leaf_bytes=leaf,
                         fits=state + 5 * leaf < total))
    return rows


def phase_train_moe(card: str) -> dict:
    """The two moe configs at ``_widened`` width (d_model 256; the fit
    table says why no published width trains on one card) by
    ``_train_twice`` with ``TRAIN_RUN`` (30 steps, checkpoints every 10,
    step 19 fails once), the capacity drops counted. No hand-written
    kernel may launch."""
    out = {arch: _train_twice(card, "train_moe", _widened(arch), TRAIN_RUN)
           for arch in MOE_PARITY}
    rec = dict(phase="train_moe", configs={a: dict(
        step_p50_ms=r["step_p50_ms"], loss_first=r["loss_first"],
        loss_last=r["loss_last"], capacity_drops=r["capacity_drops"])
        for a, r in out.items()}, fit=_fit_table(), card=card)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# dryrun phase: the counted work of a step (``repro_torch.analysis``), on
# meta and on the card
# ---------------------------------------------------------------------------

# (a) on meta, bf16, two depths extrapolated: one arch of each family at
# train_4k and decode_32k, but the ssm family's train_4k, whose plain WKV
# backward recomputes its 4,096 steps op by op (minutes of host time).
# Serially these cells take ~46 s of host time; the whole 40-cell sweep
# takes ~20 min (prefill_32k cells up to minutes each); PERF.md has it
# from the CLI.
DRYRUN_SWEEP = tuple((arch, shape) for arch in (
    "smollm-135m", "internvl2-26b", "hubert-xlarge",
    "llama4-maverick-400b-a17b", "rwkv6-3b", "recurrentgemma-9b")
    for shape in ("train_4k", "decode_32k")
    if (arch, shape) != ("rwkv6-3b", "train_4k"))
# (b) on the card and on meta at full depth, fp32, the shapes of the
# train, serve_dense and serve phases: (arch, kind, seq, batch)
DRYRUN_CARD = (("smollm-135m", "train", 256, 8),
               ("qwen3-8b", "decode", 1024 + 32, 4),
               ("rwkv6-3b", "prefill", 512, 4))
DRYRUN_REPS = {"train": 5, "decode": 20, "prefill": 5}
DRYRUN_WORKERS = 4             # of the card's machine's 8 cores
# (a) one rank of the production single pod (16 x 16), in its own worker
DRYRUN_MESH_CELL = ("smollm-135m", "train_4k", "single")


def _card_cell(cfg, kind: str, seq: int, batch: int):
    """The step of a (kind, seq, batch) cell with its arguments on the
    card: a model drawn from seed 0 in float32 (trainable for a train
    step), the synthetic pipeline's first batch, a zero cache holding
    ``seq - 32`` positions for a decode step. Returns (fn, args,
    static)."""

    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import prefill_step, serve_step, train_step
    from repro_torch.models.transformer import init_cache, init_model
    from repro_torch.optim import adamw

    model = init_model(cfg, seed=0, torch_device=DEV,
                       trainable=kind == "train")
    if kind == "decode":
        cache = init_cache(cfg, batch, seq, torch_device=DEV)
        token = torch.zeros((batch,), dtype=torch.int32, device=DEV)
        length = torch.full((batch,), seq - 32, dtype=torch.int32,
                            device=DEV)
        return serve_step, (model, cache, token, length), {}
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch), torch_device=DEV)
    data = {k: v.contiguous() for k, v in pipe.batch(0).items()}
    if kind == "train":
        fn = functools.partial(train_step, opt_cfg=adamw.AdamWConfig(),
                               remat=True)
        opt = adamw.init(dict(model.named_parameters()), adamw.AdamWConfig())
        return fn, (model, opt, data), {}
    return prefill_step, (model, {"tokens": data["tokens"]}), \
        {"cache_len": seq}


def phase_dryrun(card: str) -> dict:
    """(a) ``launch/dryrun.py``'s ``run_cell`` on meta for the cells of
    ``DRYRUN_SWEEP``: every record ``ok`` or ``skipped``.
    (b) three steps counted on the card and on meta at full depth in
    float32: ``smollm-135m``'s train step (8 x 256), ``qwen3-8b``'s decode
    step (batch 4, cache 1024 + 32) and ``rwkv6-3b``'s prefill (4 x 512,
    the ``wkv6`` kernel): the card's counted FLOPs and bytes must equal
    meta's to the unit; each with its CUDA-event median step time, the
    counted roofline bound and its share of the step (``mfu_*``), the
    hand-counted bound beside it, and the counted peak of live bytes
    beside ``torch.cuda.max_memory_allocated``. (a) runs in worker
    processes while (b) runs on the card."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    # (a) meta counting is host work: its cells run in DRYRUN_WORKERS
    # processes, which touch no card, while (b) runs here; the workers
    # are stopped on leaving the pool
    with multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS) as pool:
        pending = pool.starmap_async(
            functools.partial(dryrun.run_cell, verbose=False), DRYRUN_SWEEP)
        on_mesh = pool.apply_async(dryrun.run_mesh_cell, DRYRUN_MESH_CELL)
        cells = _dryrun_card_cells()
        card_s = time.perf_counter() - t0
        recs = pending.get()
        mesh_rec = on_mesh.get()
    sweep_s = time.perf_counter() - t0
    sweep = []
    for (arch, shape), rec in zip(DRYRUN_SWEEP, recs):
        if rec["status"] not in ("ok", "skipped"):
            raise AssertionError(f"dryrun {arch} x {shape}: {rec}")
        sweep.append({k: rec.get(k) for k in (
            "arch", "shape", "status", "flops", "bytes_accessed",
            "argument_size_in_bytes", "temp_size_in_bytes",
            "fits_one_card", "compile_s")})
    if mesh_rec["status"] != "ok" or mesh_rec["chips"] != 256:
        raise AssertionError(f"dryrun {DRYRUN_MESH_CELL}: {mesh_rec}")
    mesh_cell = {k: mesh_rec.get(k) for k in (
        "arch", "shape", "mesh", "chips", "status", "flops",
        "bytes_accessed", "collectives", "argument_size_in_bytes",
        "param_size_in_bytes", "temp_size_in_bytes", "fits_one_card",
        "compile_s")}
    rec = dict(phase="dryrun", sweep=sweep, sweep_s=sweep_s, cells=cells,
               mesh_cell=mesh_cell, card_s=card_s,
               seconds=time.perf_counter() - t0, card=card)
    emit(rec)
    return rec


def _dryrun_card_cells() -> list:
    """``phase_dryrun``'s (b): the cells of ``DRYRUN_CARD`` counted on
    meta and on the card, timed, each with its bounds and peak."""
    from repro_torch.analysis.roofline import Roofline, model_flops_for
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.common import DTypePolicy

    cells = []
    for arch, kind, seq, batch in DRYRUN_CARD:
        cfg = get_config(arch)
        shape = ShapeCell(f"{kind}_{batch}x{seq}", kind, seq, batch)
        fn, args, _, _, static = build_cell(cfg, shape, None, DTypePolicy())
        meta = dryrun.count_step(fn, args, static, "meta")
        del fn, args
        fn, args, static = _card_cell(cfg, kind, seq, batch)
        model = args[0]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = dryrun.count_step(fn, args, static, DEV)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        for key in ("flops", "bytes"):
            if got[key] != meta[key]:
                raise AssertionError(f"dryrun {arch} {kind}: {key} counted "
                                     f"on the card {got[key]}, on meta "
                                     f"{meta[key]}")
        times = []
        for _ in range(DRYRUN_REPS[kind]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(*args, **static)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        step_ms = float(np.median(times))
        peak_flops = H100.peak_flops(model.embed.dtype)
        rl = Roofline(arch, shape.name, "one", 1, got["flops"], got["bytes"],
                      got["collectives"]["total"],
                      model_flops_for(cfg, shape), H100, peak_flops)
        if kind == "decode":
            hand = dense_serve_bound(cfg, model, batch, seq - 32)
            hand = dict(bound_ms=hand["decode_bound_ms"],
                        bound_by=hand["decode_bound_by"])
        else:
            hand = lm_step_bound(cfg, model, batch, seq,
                                 train=kind == "train")
        bound_ms = rl.step_time_lb * 1e3
        cells.append(dict(
            arch=arch, kind=kind, batch=batch, seq=seq, dtype="float32",
            counted_flops=got["flops"], counted_bytes=got["bytes"],
            meta_flops=meta["flops"], meta_bytes=meta["bytes"],
            kernels=got["kernels"], step_ms=step_ms, step_ms_all=times,
            counted_bound_ms=bound_ms, bottleneck=rl.bottleneck,
            mfu_counted_bound=bound_ms / step_ms,
            mfu_model_flops=rl.model_flops / (peak_flops * step_ms * 1e-3),
            useful_flops_fraction=rl.useful_flops_fraction,
            hand_bound_ms=hand["bound_ms"], hand_bound_by=hand["bound_by"],
            counted_temp_size_in_bytes=got["temp"],
            meta_temp_size_in_bytes=meta["temp"],
            max_memory_allocated_delta=peak))
        del fn, args, static, model, got
        gc.collect()
        torch.cuda.empty_cache()
    return cells


# ---------------------------------------------------------------------------
# gemm_kernel phase: the systolic GEMM's four kernels against their plain
# versions, and systolic_gemm against torch.matmul
# ---------------------------------------------------------------------------


def gemm_cases() -> list:
    """(name, M, K, N, dtype, tile, dataflow, split_k) of every case: the
    six Table IV workloads in float32 at the 128^3 tile under OS, OS
    split-K 2 and 4, WS and IS; bfloat16 at WL1 and WL2 under OS, OS
    split-K 2, WS and IS; the reference tests' tile sweep at WL1;
    rwkv6-3b's channel-mix key product at the serve cell's prefill (batch
    4 x prompt 512 rows, d_model -> d_ff) under the five settings in
    float32 and under OS, OS split-K 2, WS and IS in bfloat16; and
    float16 OS and WS at WL2."""
    from repro_torch.configs import get_config
    from repro_torch.core import WORKLOADS

    f32, bf16, full = torch.float32, torch.bfloat16, (128, 128, 128)
    wls = [(wl.name.split("-")[0], wl.M, wl.K, wl.N) for wl in WORKLOADS]
    lm = get_config("rwkv6-3b")
    lm_key = ("rwkv6-3b-ffn-key", 4 * 512, lm.d_model, lm.d_ff)
    cases = [(*w, f32, full, df, sk) for w in wls for df, sk in GEMM_SETTINGS]
    cases += [(*w, bf16, full, df, sk) for w in wls[:2]
              for df, sk in (("OS", 1), ("OS", 2), ("WS", 1), ("IS", 1))]
    cases += [(*wls[0], f32, tile, df, sk) for tile in GEMM_TILES
              for df, sk in (("OS", 1), ("OS", 2), ("WS", 1), ("IS", 1))]
    cases += [(*lm_key, f32, full, df, sk) for df, sk in GEMM_SETTINGS]
    cases += [(*lm_key, bf16, full, df, sk)
              for df, sk in (("OS", 1), ("OS", 2), ("WS", 1), ("IS", 1))]
    cases += [(*wls[1], torch.float16, full, df, 1) for df in ("OS", "WS")]
    return cases


def _gemm_site(df: str, sk: int) -> str:
    if df == "OS":
        return "os_gemm" if sk <= 1 else "os_gemm_splitk"
    return "ws_gemm_partials" if df == "WS" else "is_gemm_partials"


def _gemm_operands(case, seed: int):
    _, M, K, N, dtype = case[:5]
    g = torch.Generator(device=DEV).manual_seed(seed)
    a = torch.randn((M, K), generator=g, device=DEV).to(dtype)
    b = torch.randn((K, N), generator=g, device=DEV).to(dtype)
    return a, b


def _magnitudes(a, b, n_slabs: int = 1) -> list:
    """Mag of each of ``n_slabs`` equal k-ranges: max over (m, n) of
    sum_k |a_mk| |b_kn|, in float64."""
    kq = a.shape[1] // n_slabs
    return [float((a[:, s * kq:(s + 1) * kq].double().abs()
                   @ b[s * kq:(s + 1) * kq].double().abs()).max())
            for s in range(n_slabs)]


def gemm_bound(M: int, K: int, N: int, dtype, site: str,
               n_slabs: int) -> dict:
    """On the true (unpadded) shape: a and b read once and the kernel's
    own outputs written once (the float32 slabs for split-K, WS and IS),
    over HBM bandwidth; against 2 M N K operations at the fp32 FFMA rate
    (bf16: the dense tensor-core rate)."""
    isz = torch.empty((), dtype=dtype).element_size()
    out_bytes = M * N * (isz if site == "os_gemm" else 4 * n_slabs)
    nbytes = (M * K + K * N) * isz + out_bytes
    ops = 2 * M * N * K
    rate = H100.fp32_flops if dtype == torch.float32 else H100.bf16_flops
    t_bytes = nbytes / H100.hbm_bytes_per_s * 1e3
    t_ops = ops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def _gemm_pad(a, b, tile, df: str, sk: int):
    """The operands zero-padded as ``systolic_gemm`` pads them."""
    import torch.nn.functional as F

    bm, bk, bn = tile
    kq = bk * sk if df == "OS" and sk > 1 else bk
    (M, K), N = a.shape, b.shape[1]
    pm, pk, pn = -M % bm, -K % kq, -N % bn
    return (F.pad(a, (0, pk, 0, pm)).contiguous(),
            F.pad(b, (0, pn, 0, pk)).contiguous())


def _gemm_launcher(lib, site, ap, bp, out, tile, sk):
    """One launch of ``site``'s kernel through the library, into the
    preallocated ``out``, on the current stream."""
    from repro_torch.kernels.systolic_gemm import ops as gops

    bm, bk, bn = tile
    (Mp, Kp), Np = ap.shape, bp.shape[1]
    code = gops.DTYPES[ap.dtype]
    path = gops.PATHS.index(gops.kernel_path(ap.dtype, bm, bk, bn))
    fn = getattr(lib, f"{site}_launch")
    head = (ap.data_ptr(), bp.data_ptr(), out.data_ptr(), Mp, Kp, Np)
    if site == "os_gemm":
        args = (*head, bm, bk, bn, code, gops.DTYPES[out.dtype], path)
    elif site == "os_gemm_splitk":
        args = (*head, sk, bm, bk, bn, code, path)
    else:
        args = (*head, bm, bk, bn, code, path)

    def launch():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return launch


def phase_gemm(card: str) -> dict:
    from repro_torch.kernels.systolic_gemm import ops as gops
    from repro_torch.kernels.systolic_gemm import ref as G

    lib = gops.build()
    cases = gemm_cases()
    # the main path: every case once through the public entry point,
    # with the launch counts of that run; its output against gemm_plain
    gops.reset_launch_count()
    wrapper_err = []
    for i, case in enumerate(cases):
        name, M, K, N, dtype, (bm, bk, bn), df, sk = case
        a, b = _gemm_operands(case, seed=i)
        out = gops.systolic_gemm(a, b, bm=bm, bk=bk, bn=bn, dataflow=df,
                              split_k=sk)
        want = G.gemm_plain(a, b)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        mag = _magnitudes(a, b)[0]
        if not (out.shape == (M, N) and out.dtype == dtype
                and err <= GEMM_TOL[dtype] * mag):
            raise AssertionError(f"systolic_gemm != gemm_plain ({case}): "
                                 f"max abs err {err}, Mag {mag}")
        wrapper_err.append(err / mag)
    launches = {fn.__name__: fn.launches for fn in gops.KERNELS}
    for fn in gops.KERNELS:
        for path, n in fn.path_launches.items():
            launches[f"{fn.__name__}/{path}"] = n
    idle = [name for name, n in launches.items() if n < 1]
    if idle:
        raise AssertionError(f"gemm_kernel never launched {idle}")
    # each kernel against its plain version on the padded operands, and
    # the times
    main, worst = {}, {}
    for i, case in enumerate(cases):
        name, M, K, N, dtype, tile, df, sk = case
        bm, bk, bn = tile
        site = _gemm_site(df, sk)
        path = gops.kernel_path(dtype, bm, bk, bn)   # the kernel it takes
        if dtype != torch.float32 and tile == (128, 128, 128) \
                and path != "wgmma":
            raise AssertionError(f"{site} {case} took {path}")
        key = f"{site}/{path}"
        plain = getattr(G, f"{site}_plain")
        a, b = _gemm_operands(case, seed=i)
        ap, bp = _gemm_pad(a, b, tile, df, sk)
        (Mp, Kp), Np = ap.shape, bp.shape[1]
        kw = dict(bm=bm, bk=bk, bn=bn)
        if site == "os_gemm":
            kw["out_dtype"] = dtype
        elif site == "os_gemm_splitk":
            kw["splits"] = sk
        got = getattr(gops, site)(ap, bp, **kw)
        want = plain(ap, bp, **kw)
        torch.cuda.synchronize()
        slabs = got.shape[0] if got.dim() == 3 else 1
        mags = _magnitudes(ap, bp, slabs)
        errs = [float((g.float() - w.float()).abs().max()) for g, w in
                zip(got.reshape(slabs, Mp, Np), want.reshape(slabs, Mp, Np))]
        tol = GEMM_TOL[dtype] if site == "os_gemm" else GEMM_TOL[torch.float32]
        if not all(e <= tol * m for e, m in zip(errs, mags)):
            raise AssertionError(f"{site} != plain ({case}): max abs errs "
                                 f"{errs}, Mag {mags}, tolerance {tol} x Mag")
        worst[key] = max(worst.get(key, 0.0), max(errs))
        out = torch.empty_like(got)
        del got, want
        launch = _gemm_launcher(lib, site, ap, bp, out, tile, sk)
        grid = {"os_gemm": Mp // bm * (Np // bn),
                "os_gemm_splitk": Mp // bm * (Np // bn) * sk,
                "ws_gemm_partials": Np // bn * (Kp // bk),
                "is_gemm_partials": Mp // bm * (Kp // bk)}[site]
        spill = site in ("ws_gemm_partials", "is_gemm_partials")
        if spill:
            # the one PyTorch call that computes the same slabs (in the
            # operand dtype: 16-bit slabs, half the bytes of float32)
            a3 = ap.view(Mp, Kp // bk, bk).transpose(0, 1)
            b3 = bp.view(Kp // bk, bk, Np)
        rec = dict(phase="gemm_kernel", kernel=site, path=path, case=name,
                   M=M, K=K, N=N, dtype=str(dtype).replace("torch.", ""),
                   tile=tile, dataflow=df, split_k=sk, padded=(Mp, Kp, Np),
                   pad_work=Mp * Kp * Np / (M * K * N), ctas=grid,
                   smem_bytes=gops.smem_bytes(df, bm, bk, bn),
                   max_abs_err=max(errs),
                   err_over_mag=max(e / m if m else e
                                    for e, m in zip(errs, mags)),
                   wrapper_err_over_mag=wrapper_err[i],
                   ms=graph_ms(launch),
                   gemm_ms=graph_ms(lambda: gops.systolic_gemm(
                       a, b, bm=bm, bk=bk, bn=bn, dataflow=df, split_k=sk)),
                   plain_ms=graph_ms(lambda: plain(ap, bp, **kw)),
                   library_ms=graph_ms(lambda: torch.matmul(a, b)),
                   **gemm_bound(M, K, N, dtype, site, slabs), card=card)
        rec["tflops"] = rec["ops"] / rec["ms"] / 1e9
        rec["over_bound"] = rec["ms"] / rec["bound_ms"]
        rec["over_library"] = rec["ms"] / rec["library_ms"]
        with_floor(rec)
        if spill:
            rec["bmm_ms"] = graph_ms(lambda: torch.bmm(a3, b3))
            rec["over_bmm"] = rec["ms"] / rec["bmm_ms"]
            del a3, b3
        emit(rec)
        # the main case of each site and path: WL2 at 128^3, split-K 2,
        # float32 on simt and bfloat16 on wgmma
        if (name, tile) == ("WL2", (128, 128, 128)) and sk in (1, 2) \
                and dtype == (torch.float32 if path == "simt"
                              else torch.bfloat16):
            main[key] = rec
        del out, ap, bp, a, b
    torch.cuda.empty_cache()
    return {key: dict(rec, launches=launches[key], max_abs_err=worst[key])
            for key, rec in main.items()}


# ---------------------------------------------------------------------------
# prefix_segment_kernel phase: the single-table gather against its plain
# version
# ---------------------------------------------------------------------------


def segment_bound(pref, rows, start, end) -> dict:
    """The distinct table entries these indices touch, the indices read
    once and the outputs written once, over HBM bandwidth; against one
    subtract and one add per slot over the non-tensor-core rate."""
    R, T1 = pref.shape
    P, C = rows.shape
    ids = torch.cat([(rows.long() * T1 + idx.long()).reshape(-1)
                     for idx in (start, end)])
    isz = pref.element_size()
    nbytes = (int(torch.unique(ids).numel()) * isz + 3 * P * C * 4
              + (P * C + P) * isz)
    ops = 2 * P * C
    t_bytes = nbytes / H100.hbm_bytes_per_s * 1e3
    t_ops = ops / H100.fp32_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def segment_cases() -> list:
    """(name, pref, rows, start, end): the workload-1 int64 plane and its
    float64 copy at P = 512 and 4096; a synthetic int32 table; a float64
    table of non-integer values, so the slot order of the sums shows; a
    float32 one at C = 9, past the unrolled kernel's 8 slots; and an edge
    case of one system, one slot, one row."""
    cases = []
    for dtype in (torch.int64, torch.float64):
        for P in (512, 4096):
            name = f"wl1-{str(dtype).replace('torch.', '')}-P{P}"
            cases.append((name, *segment_inputs(P, seed=P, dev=DEV,
                                                dtype=dtype)))
    rng = np.random.default_rng(5)

    def t(x, dt=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=DEV)

    def indices(R, T1, P, C):
        start = rng.integers(0, T1, (P, C))
        end = np.minimum(start + rng.integers(0, T1, (P, C)), T1 - 1)
        return t(rng.integers(0, R, (P, C))), t(start), t(end)

    R, T1, P, C = 64, 1025, 4096, 6
    pref = np.cumsum(rng.integers(0, 1000, (R, T1)), axis=1)
    cases.append(("synthetic-int32-P4096", t(pref), *indices(R, T1, P, C)))
    frac = np.cumsum(rng.random((R, T1)), axis=1)
    cases.append(("frac-float64-P4096", t(frac, torch.float64),
                  *indices(R, T1, P, C)))
    cases.append(("frac-float32-C9-P512", t(frac, torch.float32),
                  *indices(R, T1, 512, 9)))
    cases.append(("edge-P1-C1-R1", t(np.arange(5)[None] * 7, torch.int64),
                  t([[0]]), t([[1]]), t([[4]])))
    return cases


def phase_prefix_segment(card: str) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.prefix_gather import ops as kops
    from repro_torch.kernels.prefix_gather import prefix_segment_plain

    lib = kops.build_segment()
    regs = _ptxas_regs(_build.ptxas_report(kops.SEGMENT_SOURCE))
    if any(r.get("spill_stores") or r.get("spill_loads") for r in regs):
        raise AssertionError(f"prefix_segment: ptxas spilled: {regs}")
    cases = segment_cases()
    # the main path: every case once through the public entry point
    kops.reset_launch_count()
    outs = [kops.prefix_segment_gather(*args) for _, *args in cases]
    torch.cuda.synchronize()
    launches = kops.prefix_segment_gather.launches
    paths = dict(kops.prefix_segment_gather.path_launches)
    if launches != len(cases) or not all(paths.values()):
        raise AssertionError(f"prefix_segment: {launches} launches for "
                             f"{len(cases)} cases, by path {paths}")
    main = None
    for (name, pref, rows, start, end), (diff, total) in zip(cases, outs):
        d_p, t_p = prefix_segment_plain(pref, rows, start, end)
        equal = torch.equal(diff, d_p) and torch.equal(total, t_p)
        if not equal:
            err = float(max((diff - d_p).abs().max(),
                            (total - t_p).abs().max()))
            raise AssertionError(f"prefix_segment != plain ({name}): max "
                                 f"abs err {err}")
        P, C = rows.shape
        d_out, t_out = torch.empty_like(diff), torch.empty_like(total)
        code = kops.SEGMENT_DTYPES[pref.dtype]
        geo = kops.segment_geometry(P, C)

        def launch():
            rc = lib.prefix_segment_launch(
                pref.data_ptr(), pref.shape[1], rows.data_ptr(),
                start.data_ptr(), end.data_ptr(), P, C, d_out.data_ptr(),
                t_out.data_ptr(), code,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        def plain():
            return prefix_segment_plain(pref, rows, start, end)

        def call():
            return kops.prefix_segment_gather(pref, rows, start, end)

        # call_ms: the whole public call, eager, as a caller pays it (the
        # index range check with its host sync, the int32 casts, the
        # allocations and the launch)
        rec = dict(phase="prefix_segment_kernel", kernel="prefix_segment",
                   case=name, dtype=str(pref.dtype).replace("torch.", ""),
                   R=pref.shape[0], T1=pref.shape[1], P=P, C=C, equal=equal,
                   max_abs_err=0, ms=graph_ms(launch),
                   eager_ms=cuda_ms(launch), call_ms=cuda_ms(call),
                   plain_ms=graph_ms(plain), plain_eager_ms=cuda_ms(plain),
                   **segment_bound(pref, rows, start, end), geometry=geo,
                   ptxas_regs=regs, card=card)
        emit(with_floor(rec))
        if name == "wl1-int64-P512":
            main = rec
    return dict(main, launches=launches, path_launches=paths)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    from repro_torch.kernels import _build

    sources = _kernel_sources()
    t = time.perf_counter()
    _build.compile_sources([src for src, _ in sources.values()])
    for _, build in sources.values():                  # built in parallel
        build()
    emit(dict(phase="build", kernels=list(sources),
              seconds=time.perf_counter() - t,
              ptxas={name: _build.ptxas_report(src)
                     for name, (src, _) in sources.items()},
              card=card))
    phase_launch_floor(card)
    kmain = phase_kernel(card)
    tmain = phase_topology(card)
    evaluate = phase_evaluate(card)
    phase_golden(card)
    search = phase_search(card)
    phase_profile(card)
    phase_sa_golden(card)
    pareto = phase_pareto(card)
    strategies = phase_strategies(card)
    scenario = phase_scenario(card)
    resume = phase_resume(card)
    service = phase_service(card)
    shutil.rmtree(WORK, ignore_errors=True)
    wmain = phase_wkv6(card)
    phase_lm_parity(card)
    serve = phase_serve(card)
    gc.collect()                          # free the RWKV-6 model's memory
    torch.cuda.empty_cache()
    rmain = phase_rglru(card)
    phase_hybrid_parity(card)
    serve_h = phase_serve_hybrid(card)
    gc.collect()                          # free the hybrid model's memory
    torch.cuda.empty_cache()
    phase_dense_parity(card)
    phase_serve_dense(card)
    gc.collect()                          # free qwen3-8b's 32.8 GB
    torch.cuda.empty_cache()
    phase_serve_dense_bf16(card)
    gc.collect()                          # free qwen2.5-14b's 29.5 GB
    torch.cuda.empty_cache()
    phase_moe_parity(card)
    phase_serve_moe(card)
    gc.collect()                          # free deepseek's 58.4 GB
    torch.cuda.empty_cache()
    phase_serve_moe_gqa(card)
    gc.collect()                          # free llama4's 37.1 GB
    torch.cuda.empty_cache()
    scen_llm = phase_scenario_llm(card)
    mesh_one = phase_mesh_one(card)
    phase_ep_shards(card)
    phase_train_parity(card)
    phase_train(card)
    gc.collect()                          # free the two trained smollms
    torch.cuda.empty_cache()
    phase_vlm_audio_parity(card)
    phase_vlm(card)
    gc.collect()                          # free internvl2-26b's 39.7 GB
    torch.cuda.empty_cache()
    phase_audio(card)
    gc.collect()                          # free hubert-xlarge's train state
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    phase_train_grad_kernels(card)
    phase_train_families_parity(card)
    gc.collect()
    torch.cuda.empty_cache()
    tssm = phase_train_ssm(card)
    gc.collect()                          # free rwkv6-3b's train state
    torch.cuda.empty_cache()
    thyb = phase_train_hybrid(card)
    gc.collect()                          # free recurrentgemma's train state
    torch.cuda.empty_cache()
    phase_train_moe(card)
    emit(dict(phase="train_time", seconds=time.perf_counter() - t_train,
              card=card))
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun(card)
    gmain = phase_gemm(card)
    smain = phase_prefix_segment(card)
    emit(dict(phase="seconds", seconds=time.perf_counter() - t_script,
              card=card))

    print(card)
    emit({"kernels": [{
        "name": "prefix_select", "route": "cuda",
        "source": "src/repro_torch/kernels/prefix_gather/csrc/"
                  "prefix_select.cu",
        "replaces": "src/repro/kernels/prefix_gather/kernel.py:79",
        "launches": sum(p["launches"]["prefix_select"]
                        for p in (search, pareto, strategies, scenario,
                                  resume, service, scen_llm, mesh_one)),
        "max_abs_err": kmain["max_abs_err"], "ms": kmain["ms"],
        "plain_ms": kmain["plain_ms"], "bound_ms": kmain["bound_ms"],
        "bound_by": kmain["bound_by"], "library_ms": None}, {
        "name": "topology", "route": "cuda",
        "source": "src/repro_torch/kernels/topology/csrc/topology.cu",
        "replaces": None,
        "launches": (evaluate["topology_launches"]
                     + search["launches"]["topology"]),
        "max_abs_err": tmain["max_abs_err"], "ms": tmain["ms"],
        "plain_ms": tmain["plain_eager_ms"], "bound_ms": tmain["bound_ms"],
        "bound_by": tmain["bound_by"], "library_ms": None}, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:28",
        "launches": serve["launches"]["wkv6"] + sum(
            run.get("wkv6", 0) for run in tssm["launches"].values()),
        "max_abs_err": wmain["max_abs_err"], "ms": wmain["ms"],
        "plain_ms": wmain["plain_ms"], "bound_ms": wmain["bound_ms"],
        "bound_by": wmain["bound_by"], "library_ms": None}, {
        "name": "rglru", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru/csrc/rglru.cu",
        "replaces": "src/repro/kernels/rglru/kernel.py:23",
        "launches": serve_h["launches"]["rglru"] + sum(
            run.get("rglru", 0) for run in thyb["launches"].values()),
        "max_abs_err": rmain["max_abs_err"], "ms": rmain["ms"],
        "plain_ms": rmain["plain_ms"], "bound_ms": rmain["bound_ms"],
        "bound_by": rmain["bound_by"], "library_ms": None}, {
        "name": "prefix_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/prefix_gather/csrc/"
                  "prefix_segment.cu",
        "replaces": "src/repro/kernels/prefix_gather/kernel.py:44",
        "launches": smain["launches"], "max_abs_err": smain["max_abs_err"],
        "ms": smain["ms"], "plain_ms": smain["plain_ms"],
        "bound_ms": smain["bound_ms"], "bound_by": smain["bound_by"],
        "library_ms": None}] + [{
        "name": site, "route": "cuda",
        "source": "src/repro_torch/kernels/systolic_gemm/csrc/"
                  "systolic_gemm.cu",
        "replaces": f"src/repro/kernels/systolic_gemm/kernel.py:{line}",
        "launches": gmain[site]["launches"],
        "max_abs_err": gmain[site]["max_abs_err"], "ms": gmain[site]["ms"],
        "plain_ms": gmain[site]["plain_ms"],
        "bound_ms": gmain[site]["bound_ms"],
        "bound_by": gmain[site]["bound_by"],
        "library_ms": gmain[site]["library_ms"]} for site, line in (
            ("os_gemm/simt", 38), ("os_gemm/wgmma", 38),
            ("os_gemm_splitk/simt", 54), ("os_gemm_splitk/wgmma", 54),
            ("ws_gemm_partials/simt", 71), ("ws_gemm_partials/wgmma", 71),
            ("is_gemm_partials/simt", 71), ("is_gemm_partials/wgmma", 71))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
