#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--tasks N]
    python3 chip_smoke.py --time-overlap [--src DIR] [--tasks N]
    python3 chip_smoke.py --time-kernels [--src DIR]
    python3 chip_smoke.py --lm-sharded

Run from the root of a checkout. Phases, each of which exits non-zero on
failure:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels from src/repro_torch/csrc (seven
     sources, one nvcc each, in parallel) and prints the build seconds;
  3. holds each kernel bit for bit against its plain PyTorch version on
     the card: conflict at W in {1, 37, 128, 129, 1000, 4096}, nr in
     {1, 21}, nw in {1, 2}, both hazard rules, at wide footprints (W in
     {129, 512}, nr in {193, 600, 2358}, and SIS's padded layout at nr =
     3057), on the inputs hardest for a join over the ids (a chain —
     every task writes id 0 —, ids over 4 values, ids repeated within a
     row, tasks that read what they write, ids near 2^31 - 1, every slot
     unused, every task invalid) at W in {37, 4096}, and at W = 16384;
     levels at the same W on random
     lower-triangular matrices of three densities, with and without a
     base floor, plus one matrix with entries above the diagonal, sparse
     windows of 8193 and 16384 with and without a base, a pure chain
     (depth = W) at W = 4096, a sparse window and a chain at W = 57,345
     (the level vector past shared memory) and serving-shaped windows
     of 8 — the
     passes each case took and whether the blocked sweep finished it
     printed per case; the cross-window block at (Wi, Wj) in {(1, 1),
     (37, 129), (128, 128), (4096, 4096), (1000, 37)} with each side's
     (nr, nw) in {(1, 1), (21, 2)}, at (129, 512) with nr in {193,
     600, 2358} on one side or both and padded at 3057 on both, on the
     hard inputs at (Wi, Wj) in {(129, 37), (4096, 1000)}, and at
     Wi = Wj = 16384, both rules, invalid tails; the
     Axelrod wave at W in {1, 37, 128, 4096} x F in {1, 3, 37, 128, 500}
     with masks of three densities, ties forced among the uniforms and
     rows with every feature equal; the SIRS wave at W in {1, 8, 37,
     4096} x (s, k) in {(10, 6), (50, 14), (400, 14), (1000, 14), (25, 2),
     (10, 2100)} on rings of N in {4,000, 4,003, 10^6}, random and all
     infected,
     subsets at both ends of the ring, and W = 1 at the first and the
     last subset for s in {10, 25, 50};
     and the flash kernel against ``attention_ref`` (TF32 off) in float32
     and bfloat16 at the reference's five sweep shapes, smollm-360m's
     prefill (H 15, Hkv 5, D 64, T = S = 2048), danube's (H 32, Hkv 8,
     D 120, T = S = 8192, window 4096), deepseek's (H = Hkv = 32, D 128),
     an odd T, S > T with and without a window, a decode shape,
     hymba-1.5b's window-1024 and global layers (H 25, Hkv 5, D 64,
     T = S = 128 + 2048) and seamless-m4t's cross-attention (H = Hkv =
     16, no mask, T in {1, 64, 600} against S = 512: T > S included),
     each on inputs of std 0.3 (a flat softmax) and of std 1 (a peaked
     one) — float32 within atol 2e-5 / rtol 1e-4 (atol 1e-4 from
     S = 2048 on), bfloat16 within atol 2e-3 / rtol 1e-2, the max error
     printed per case; on the
     peaked inputs the bfloat16 tolerance must reject attention with
     uniform weights (q = 0), so a kernel that mis-weights its keys
     fails; and the wkv6 kernel against
     ``wkv6_ref`` in float32 and bfloat16 inputs at the reference's four
     sweep shapes, rwkv6-3b's prefill (B 1, H 40, T 2048, D 64), ragged
     T in {1, 37, 129}, D = 128 and a decode step (B 8, T 1), D in {1,
     33, 100}, D = 128 at T = 1, T in {8, 9, 15, 16, 17} (the kernels'
     edges) and B·H in {41, 21}, each from s0 = 0 and from a random s0,
     with decays near 1 and spread over (0, 1) — o and the final state
     within WKV6_ATOL x the case's largest output + WKV6_RTOL x
     |output|, the max error printed per case; the tolerance must reject
     a recurrence without the u bonus and one that decays S before the
     read, so a loose tolerance fails; and the state written in place
     (``s_out=s0``, and into another tensor) under a partial, full and
     empty ``commit`` mask and none, at a decode wave, a prefill chunk
     and two odd shapes: committed rows within the same tolerance, the
     others bit for bit as they were;
  4. drives the barrier path — ``run_engine(engine="wavefront")`` on voter
     and SIS over ``watts_strogatz(n=1_000_000, k=10, beta=0.1)`` built
     on the card, W = 4096, 2^19 tasks each (``--tasks`` cuts the task
     count of both paths, never n or W) — with the kernel launch
     counters set to 0 just before each model's run and read just
     after; each kernel must have launched once per window. Then, on
     the first 8 windows, the final state must equal the port's
     sequential oracle bit for bit, and state and stats must equal a
     CPU run of the port;
  5. splits 16 windows of each model into creation, record check,
     levels and waves (host clock, each step fenced by a synchronize),
     and profiles 16 more (torch.profiler) for the device's busy share;
  6. drives the overlap path — ``run_engine(engine="wavefront_overlap")``
     at W = 4096 and 2^19 tasks on four models built on the
     card: voter and SIS on the graph above, Axelrod (n = 10^6, F = 3,
     q = 3, omega = 0.95, complete mixing) and SIRS (n = 10^6 on the ring
     of degree 14, subsets of 50). The counters are set to 0 before each
     run and read after: conflict and levels once per window, the block
     kernel once per boundary, the Axelrod or SIRS wave kernel once per
     ``execute_wave`` call of its model (fused waves x 2 plus the last
     drain's waves), the other models none. On the first 8 windows the
     result must equal the oracle, the barrier run and a CPU run of the
     port (state and stats; the CPU run takes the plain versions), and
     the overlap stats must keep the monotone envelope (no more waves
     than the barrier run). Then the same split and profile as phase 5
     for the overlap path;
  7. the task-size phase, at the widest tasks the paper sweeps: Axelrod
     with F = 500 (n = 10^6, complete mixing, 2 GB of traits) and SIRS
     with s = 1000 (n = 10^6 ring, k = 14), each through
     ``run_engine(engine="wavefront_overlap")`` at W = 4096 for 2^18
     tasks, wave kernel launches counted as in phase 6. The first window
     must equal a CPU run of the port, and the first 1024 tasks the
     oracle (at W = 4096 and at W = 256, where the pairs fuse);
  8. a traced run: 16 windows of the overlap path for Axelrod and SIRS
     under ``repro_torch.obs.tracing()``, exported to
     build/trace_<model>.json. ``validate_chrome_trace`` must accept it;
     per window one ``schedule`` and one ``execute`` span, one
     ``boundary`` per transition, ``wave`` spans whose widths sum to the
     tasks; state and stats equal to the untraced run's. Prints the
     traced schedule / boundary / execute split per window;
  9. counts the host syncs per window of each path over 16 windows
     (``torch.cuda.set_sync_debug_mode("warn")``), tracing off; more
     than 19 per 16 windows on the overlap path fails;
 10. wide footprints and big windows: SIS on a graph built in numpy
     from the seed (preferential attachment over 10^5 nodes, m = 3, with
     hubs of 2400, 1500 and 800 random neighbours planted: a task reads
     up to 1 + max degree ids) through ``wavefront`` and
     ``wavefront_overlap`` at W = 4096 for 8 windows — launches counted,
     the final state against the oracle and a CPU run of the port
     (state and stats), ms per window, and both conflict kernels on a
     real window and boundary, each bit for bit against its plain
     version under both rules, their ms beside their bounds; then voter
     at W = 16384 for two windows
     through both engines against the oracle;
 11. the sharded engines (``torch.distributed``): (a) at world size 1
     under NCCL (a one-rank default group on a FileStore under build/),
     ``sharded`` and ``sharded_overlap`` on SIS (the graph above) and
     SIRS (the phase-6 ring, s = 50) at n = 10^6, W = 4096 and 2^18 tasks
     (2^20 before the lm sharded phase came, 2^19 before the cost phase;
     ``--tasks`` cuts it), each
     against ``wavefront`` /
     ``wavefront_overlap`` on the card with the same seed and window:
     the final state bit for bit, the schedule stats equal, conflict and
     levels launched once per window, the block kernel once per
     boundary, the SIRS wave kernel once per ``execute_wave``, n_devices
     1, the collective call sites' byte count equal to
     ``comm_bytes_total``; tasks/s of both; a fenced split of 16 windows
     (schedule, split layout, gathers with their collective, scatters,
     waves, the rest); the host syncs per window, more than 19 per 16
     windows of ``sharded_overlap`` failing. (b) Four ``gloo`` ranks on
     the one card, carrying CUDA tensors (NCCL puts no two ranks on one
     GPU), spawned by the script: the four engines on voter, SIS,
     Axelrod (F = 3) and SIRS (s = 50) at n = 10^6, W = 4096 for 8
     windows; every rank's state equal to its ``wavefront`` run on the
     card, the stats equal across ranks, each rank's byte count equal to
     ``comm_bytes_total``; a rank's non-zero exit or a 400 s timeout
     fails. Prints the comm ladder per model (``comm_modes``,
     ``per_wave_comm_bytes``, ``window_halo_bytes``, ``full_state_bytes``,
     ``comm_reduction_vs_window_halo``);
 12. the generators and the DES: (a) ``erdos_renyi(10^6, 4/10^6)``
     with ``connect_isolated`` and ``barabasi_albert(10^6, 2)`` exact and
     with ``chunk=4096``, built on the card, their seconds, edges and max
     degree printed (the reference's BENCH_topology.json figures beside,
     as a note), the attachment kernel's launches counted (set to 0 just
     before each BA build, read just after: one launch a build, exact or
     chunked); (b) the attachment kernel against its plain version
     (``ref.py``, another algorithm over the same draws) at n = 10^5 and
     10^6, exact and chunked — targets and the whole endpoint multiset
     bit for bit — timed at 10^6 (CUDA events around the launch of each
     of 5 builds, enqueued behind a sleep so none waits for the host; the
     median, and the first call's wall time beside) against the plain
     version, its bound and a model of its critical path (the longest
     chain of dependent lookups, ``chain_depth`` of the plain run,
     printed beside, and the same operations at the INT32 rate), and
     one exact build, then 20, under torch.profiler (whether it records
     the kernel); the card's ER graphs equal the CPU's builds at 10^5
     and 10^6, its BA graphs (exact and chunked) at 10^5; (c) SIS on
     the exact BA graph at n = 10^6 (a task reads up to 1 + max degree ids) through
     ``wavefront`` and ``wavefront_overlap`` at W = 4096 for 8 windows,
     as phase 10 drives the hub graph: launches counted, the final
     state against the oracle and a CPU run of the port (state and
     stats), ms per window, both conflict kernels on a real window and
     boundary bit for bit against their plain versions and timed beside
     their bounds; (d) ``simulate_protocol`` on the ``des_model`` of
     Axelrod (n = 10^4, F = 500, on ``watts_strogatz(10^4, 10, 0.1)``
     built on the card) and of SIRS (n = 10^6 ring, k = 14, s = 50),
     2,000 tasks at n_workers 1 and 4: each ``DESResult`` equal, field
     for field, to the one of the same model built on the CPU;
 13. the LM serving path at smollm-360m's full width (d_model 960,
     vocab 49152; its 32 layers cut to 16, the cut order's third step),
     random weights from the seed: 16 requests
     with prompt lengths 64-1536 drawn from the seed, 64 new tokens each,
     8 slots, max_len 2048, prefill chunks of 128. Checked (float32
     weights, TF32 off): the ``ServingEngine``'s tokens must equal
     per-request sequential decoding whose one-shot prefill runs through
     the flash kernel (``attn_impl="pallas"``, 16 launches a request),
     under one tie rule — a token that differs at a top-two margin above
     1e-4 fails, at or below it the request is a float32 tie and its
     remaining tokens are not compared, more than one tie fails; the
     levels counter is set to 0 just before the engine's run and the
     flash counter just before the sequential decoding, each read just
     after and above 0; the one-shot prefill's last logits through the
     kernel must equal those through ``attention_ref`` within 1e-3 at
     T = 2048.
     Timed (bf16 weights, the same requests): generated tokens/s,
     iterations and mean wave, fenced ms per decode wave and per prefill
     chunk, the device's idle share over iterations 40-49
     (torch.profiler), host syncs per iteration, and one-shot prefill ms
     at T = 2048 with "pallas" and with "chunked".
     Then the RWKV6 serving path at rwkv6-3b's full width and depth (32
     layers, d_model 2560, 40 WKV heads of 64, d_ff 8960, vocab 65536),
     the same requests with 16 new tokens each (the cut order's second
     step; 32 before), every
     time-mix through
     the wkv6 kernel (``attn_impl="pallas"``). Checked (float32, TF32
     off): the engine's tokens against sequential decoding under the tie
     rule; the wkv6 counter set to 0 just before each run and read just
     after, exactly 32 x (prefill chunks + decode waves) over the
     engine's run and 32 x 16 x 16 over the sequential decoding; levels
     once per iteration; the one-shot prefill at T = 2048 through
     "pallas" against "chunked" — last-token logits and layer 0's state
     within RWKV_PREFILL_TOL. Timed (bf16): as for smollm, the idle share
     over iterations 30-39 (the run has 49);
 14. the training path (``train/``), after serving, through
     ``attn_impl="chunked"`` (the reference trains through plain math;
     neither hand-written LM kernel has a backward, and their launch
     counters must stay 0): the refusal — ``"pallas"`` under grad raises
     for flash and for wkv6 before launching either (reduced configs);
     smollm-360m at full width and depth, one float32 step (TF32 off, B 2,
     T 128, lr 1e-5 without warm-up) on the card and the same step on the
     host's CPU from the same parameters — loss within TRAIN_LOSS_RTOL,
     grad_norm within TRAIN_GNORM_RTOL, mu and nu per leaf within
     TRAIN_MOMENT_TOL of the leaf's largest value, every parameter within
     2·lr and at most TRAIN_FLIP_SHARE of them with updates more than
     lr / 100 apart (Adam's first step moves each element by about lr
     whatever its gradient, so the moments and that share carry the
     parameters' check) — and the step at microbatches 2 against 1 on the
     card (loss within 1e-5, the reference test's bound; mu and the
     parameters as above); a NaN anywhere fails;
     timed at bf16 (B 8, T 1024, remat): 3 warm-up and 5 timed steps,
     tokens/s, ms per step, peak memory, host syncs inside ``step_fn``
     over one step (sync debug mode; any fails), the device's idle share
     over 3 profiled steps (kernels only), a finite loss at every step
     (the checkpoint round trip and ``train_loop``'s resume are phase
     16's elastic round trip);
     rwkv6-3b checked the same
     way at full width with 2 layers (the host CPU's memory and time) and
     timed at full width and depth (B 4, T 512, 2 warm-up and 3 timed
     steps, 1 profiled), its peak memory printed;
 15. the families phase: hymba-1.5b at full width and depth (32
     layers, d_model 1600, 25 heads over 5, window 1024, global layers
     0/16/31, 128 meta tokens, SSM 25 x 64 with state 16, vocab 32001),
     the serving cell's 16 requests with 16 new tokens. Checked (float32,
     TF32 off; the first 8 requests, 4 past the window): the engine's
     tokens against sequential decoding whose
     one-shot prefill runs through flash (32 launches a request), under
     the tie rule, levels once per iteration; apply_train's logits on the
     card (flash) against the host CPU's within HYMBA_CPU_TOL, which must
     reject the SSM branch without ``d_skip``. Timed (bf16): tokens/s,
     iterations, idle share over iterations 30-39, kernels per iteration,
     one-shot prefill ms at 128 + 2048 tokens through flash and chunked.
     Then qwen3-moe-235b-a22b (d 4096, 64/4 heads of 128, 128 experts
     top-8, vocab 151936; 6 of 94 layers at float32, 13 at bf16),
     seamless-m4t-medium (12 + 12 layers, d 1024, vocab 256206) and
     internvl2-76b (d 8192, 64/8 heads of 128, vocab 128256; 18 of 80
     layers at float32, 38 at bf16) at full width, through "pallas":
     float32 (MoE at dropless capacity 8.0) — a prefill of T - 1 tokens
     and one decode step against the teacher-forced logits within
     FAMILY_TOL, which must reject a decode at the wrong position (and
     MoE routed top-7, the VLM's prefill without its patches), flash
     once per attention layer and forward; bf16 — one-shot prefill ms
     (B 8, T 512, patches or source frames as ``input_specs`` lays
     them out), ms per decode step over 8, MoE's overflow fraction;
 16. the lm sharded phase (``drive_lm_sharded``): (a) world size 1 under
     NCCL on a (1, 1) ("data", "model") DeviceMesh: smollm-360m at full
     width and depth, float32 — one sharded train step (the state placed
     by ``train_state_shardings``, ZeRO-1 moments) against the unsharded
     step on the card under phase 14's bounds; the bf16 step on the
     mesh timed at B 8, T 1024 and the elastic round trip of that state
     (bf16 parameters, float32 moments, 3.6 GB: saved as logical arrays
     under build/, ``train_loop`` resumed from it on a new (1, 1) mesh
     with ``layout="dp"`` through ``state_shardings`` and ``put_batch``
     — resumed from the saved step, every leaf's bits equal and on the
     new mesh, two steps equal to two uninterrupted steps —, the files
     deleted);
     qwen3-moe at full width (6 layers, float32): ``moe_impl="shard_map"``
     against the dense dispatch, loss and aux terms within 1e-5;
     the sharded one-shot prefill (B 2, T 512) and 8 decode steps, the
     states placed by ``states_shardings``, of smollm-360m (16 layers)
     through flash and rwkv6-3b (32 layers) through wkv6, float32, against
     the unsharded runs within 1e-4, each kernel launched at least once
     per layer in the sharded run (counted); (b) four ``gloo`` ranks on
     the card (DTensor's all-gather through host memory:
     ``collectives.stage_gloo_all_gather``) at the reference tests'
     widths on (2, 2): the sharded train step against one rank (4
     steps, rtol 2e-4), rwkv6 ``layout="dp"`` against ``"tp"``, the
     ``shard_map`` and ``shard_map_wg`` MoE in the train step against
     dense (rtol 3e-3), the ``tp_shard_map`` block (deepseek; danube with
     a window and one KV head) against the plain loss (1e-4),
     ``crosspod_allreduce_compressed`` on (2, 1, 2), and the elastic
     restore of the (2, 2) checkpoint of step 3 onto a (2, 1) mesh over
     ranks 0 and 1, as the reference's test restores onto a sub-mesh
     (step 4, rtol 2e-4), each against the unsharded runs the parent
     makes meanwhile (the ranks run beside (a)'s untimed checks and (c);
     (a)'s timed part runs after them, alone); (c) the dry run's 80 cells
     on the meta device:
     ok / skipped / failed and the largest per-rank argument bytes per
     mesh;
 17. times each kernel at W = 4096 on real windows (CUDA events, median
     of 25) beside its plain version and its bound, the levels kernel
     with its passes, and on random windows of density 0.3; the summary
     line holds SIS's conflict and levels times (the widest footprint of
     the Watts–Strogatz graph), and the wave kernels at F = 500 and
     s = 1000 (and SIRS at s = 50); flash at smollm-360m's prefill
     shape in bf16 beside its plain version and
     ``scaled_dot_product_attention`` (the library
     yardstick, which the port never calls), bound by max(bytes /
     3.35 TB/s, causal flops / 989 TFLOP/s), and in float32 beside the
     same two (printed, not in the summary line); wkv6 at rwkv6-3b's prefill shape (B 1, H 40, T 2048,
     D 64, bf16, s0 = 0) beside its plain version (no library call
     computes the recurrence), bound by max(bytes / 3.35 TB/s, flops /
     67 TFLOP/s, the float32 CUDA-core rate). The kernels line lists
     all eight kernels, SIRS at both subset sizes and the attachment
     kernel exact and chunked (phase 12's times);
 18. the cost phase (``repro_torch.obs.costs``), in four parts run
     where their inputs are: (a) after phase 7, ``compiled_costs`` of
     ``wavefront`` on phase 7's Axelrod (F = 500) and SIRS (s = 1000)
     models at n = 10^6, W = 4096 — one window's schedule through the
     conflict and levels kernels, its executor run once on clones
     through the wave kernel: the wave kernel's reported launches, and
     its counter, equal to the window's waves (``levels.max() + 1``),
     its reported bytes and operations equal to the waves times its
     ``work()`` on the same inputs, the caller's state bit for bit
     unchanged; prints ``as_row()``, the allocator's peak over the call
     and the seconds; (b) in phase 11, ``ledger_cross_check`` of
     ``sharded`` and ``sharded_window_halo`` on SIS and SIRS for 8
     windows at world size 1 under NCCL, and on each of the four gloo
     ranks for every model: exact (``rtol = 0``), the ratio printed;
     (c) in phase 9, no cost recorder installed while the host syncs are
     counted (the count and its cap as before); (d) started before phase
     3 and waited for after it (phase 3 is untimed, so no timed phase
     shares the host's CPU with them), the dry run's collectives for two
     cells in processes of their own, smollm-360m ``train_4k`` and
     qwen3-moe-235b-a22b ``train_4k`` on the single-pod mesh (rank 0's
     step on the meta device over a fake process group of 256 ranks,
     every layer, the first microbatch standing for the others): each
     ``ok`` with non-null collectives, its totals printed; the other 78
     cells stay placement-only (phase 16).

The line before the last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits non-zero and
prints no result.

``--time-kernels`` runs none of the above either: it prints the device ms
(CUDA events, median of 25) of the conflict and block kernels on real
voter and SIS windows and boundaries (Watts–Strogatz, n = 10^6, W = 4096;
for SIS also the host µs per call, launches back to back, and the
device's busy ms per window over 16 windows of the barrier and overlap
paths, all kernels and the conflict kernels alone), on the hub
graph's window and boundary (3,057 slots), on a chain (SIS's slots, every
task writes id 0) and on a hot-id window (SIS's slots, ids over 100
values, density ~0.3), each with its density; of the levels kernel on the
voter and SIS windows, on a random window of density 0.3 and on a chain
at W = 4096, and on serving-shaped windows of 8 (no conflict, a chain;
also the host µs per call); of the flash kernel at smollm-360m's
prefill in bf16; of wkv6 in bf16 at rwkv6-3b's one-shot prefill (B 1,
H 40, T 2048), prefill chunk (T 128, with a state) and decode wave (B 8,
T 1, with a state); of the SIRS wave on the first window's inputs at
s = 50 and s = 1000 (n = 10^6 ring, k = 14, W = 4096) — each new one
with its bound; the floor of the timing (a one-element ``add_``); and
rwkv6-3b decode waves at full width (8 slots, half committed) under
torch.profiler — device ms and kernels per wave, the wkv6 kernel's
share — with the port package under ``--src``, so that the kernels of
two trees can be compared in one call, each tree in its own process.

``--lm-sharded`` runs only phases 1, 2 and 16 (the build, then the lm
sharded phase), to iterate on that phase alone; it prints no result.

``--profile-attach`` runs only phases 1 and 2 and then phase 12's
profile of the attachment kernel (one exact build at n = 10^6, then 20,
under torch.profiler) in this fresh process; it prints no result.

``--time-overlap`` runs none of the above: it prints the overlap path's
wall ms per window for Axelrod (F = 3) and SIRS (s = 50) at n = 10^6,
W = 4096, over ``--tasks`` tasks (default 2^20), with the port package
found under ``--src`` (default ./src) — so that two trees can be
compared in one call, each in its own process.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_NODES = 1_000_000
DEGREE = 10
REWIRE = 0.1
WINDOW = 4096
TOTAL_TASKS = 1 << 19
CHECK_WINDOWS = 8
SEED = 0
DEVICE = "cuda"

PARITY_WINDOWS = (1, 37, 128, 129, 1000, 4096)
BLOCK_SHAPES = ((1, 1), (37, 129), (128, 128), (4096, 4096), (1000, 37))
SLOTS = ((1, 1), (21, 2))
LEVEL_DENSITIES = (0.001, 0.02, 0.3)
#: wide footprints (nr + nw > 192, past the first kernels' 48 KB stage);
#: 2358 = 1 + the max degree of a Barabási–Albert graph at n = 10^6
#: (BENCH_topology.json)
WIDE_READS = (193, 600, 2358)
WIDE_WINDOWS = (129, 512)
#: SIS's layout at the hub-SIS phase's width (1 + max degree 3,056): every
#: row padded with -1 past a short used prefix (up to PADDED_PREFIX slots),
#: a few hub rows using every slot
PADDED_READS = 3057
PADDED_PREFIX = 12
PADDED_HUBS = 0.02
#: levels beyond the old 8192 limit: (W, density) of sparse windows
BIG_LEVEL_WINDOWS = ((8193, 1e-4), (8193, 1e-3), (16384, 1e-4))
#: a window whose level vector does not fit a CTA's shared memory (the
#: kernel keeps it in L2 past 56,320)
LEVELS_L2_WINDOW = 57_345
#: the hub-graph SIS phase: a preferential-attachment graph at n = 10^5
#: (m = 3 edges per arrival) with hubs planted up to HUB_DEGREES, so a
#: task reads up to 1 + max degree ids
HUB_NODES = 100_000
HUB_M = 3
HUB_DEGREES = (2400, 1500, 800)
#: the conflict kernels' hard inputs (the kinds of tests/conflict_cases.py;
#: see hard_footprint), on the prefix matrix at HARD_WINDOWS and on the
#: block at HARD_BLOCKS, then random footprints at BIG_PARITY_WINDOW (the
#: big-window phase's width)
HARD_KINDS = ("chain", "hot", "duplicates", "self_read", "near_max",
              "unused", "invalid")
HARD_WINDOWS = (37, 4096)
HARD_BLOCKS = ((129, 37), (4096, 1000))
BIG_PARITY_WINDOW = 16384
INT32_MAX = 2**31 - 1
#: --time-kernels' hot-id window: SIS's slots (18 reads, 1 write) over 100
#: ids conflict at a density of about 0.3, as the levels kernel's dense
#: windows do
HOT_IDS = 100
AXELROD_WINDOWS = (1, 37, 128, 4096)
AXELROD_FEATURES = (1, 3, 37, 128, 500)
MASK_DENSITIES = (0.2, 0.7, 1.0)
SIR_WINDOWS = (1, 8, 37, 4096)
SIR_SHAPES = ((10, 6), (50, 14), (400, 14), (1000, 14), (25, 2),
              (10, 2100))  # the last past the kernel's threshold table
SIR_RINGS = (4_000, 4_003, 1_000_000)
#: W = 1 at the ring's first and last subset, s not a multiple of 4
SIR_EDGE_SIZES = ((10, 6), (25, 2), (50, 14))
SIR_RATES = {"p_si": 0.8, "p_ir": 0.1, "p_rs": 0.3}

# the task-size phase: the widest tasks of the paper's sweeps
# (benchmarks/fig2_axelrod.py: F up to 500; benchmarks/kernels_bench.py:
# s up to 1000)
WIDE_F = 500
WIDE_S = 1000
WIDE_TASKS = 1 << 18
ORACLE_TASKS = 1024
TRACE_WINDOWS = 16
#: the overlap path's host syncs per window by design (16 wave counts,
#: the key, two stats reads over 16 windows); with tracing off no more
OVERLAP_SYNCS_MAX = 19 / 16

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the CUDA-core
# (non-tensor) float32 rate, taken as the rate of the kernels' integer
# compares and maxes
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- parity
def random_footprint(torch, gen, w, nr, nw, device, ids=None, pad=False):
    """Ids in [0, ids), 20 % of the slots unused (-1), an invalid tail.
    pad: SIS's layout besides — each row's reads unused past a prefix of
    1..PADDED_PREFIX slots, except PADDED_HUBS of the rows, which use every
    slot."""
    ids = ids or max(4, w)
    reads = torch.randint(0, ids, (w, nr), generator=gen, dtype=torch.int32)
    writes = torch.randint(0, ids, (w, nw), generator=gen, dtype=torch.int32)
    reads[torch.rand((w, nr), generator=gen) < 0.2] = -1
    writes[torch.rand((w, nw), generator=gen) < 0.2] = -1
    if pad:
        used = torch.randint(1, PADDED_PREFIX + 1, (w, 1), generator=gen)
        used[torch.rand((w, 1), generator=gen) < PADDED_HUBS] = nr
        reads[torch.arange(nr)[None, :] >= used] = -1
    valid = torch.arange(w) < w - w // 7  # an invalid tail
    return reads.to(device), writes.to(device), valid.to(device)


def hard_footprint(torch, gen, kind, w, nr, nw, device):
    """One side's footprint of a hard kind (tests/conflict_cases.py makes
    the same kinds with numpy): ids over max(4, w) values, 20 % of the
    slots unused, an invalid tail, and then
      chain       every task writes id 0 (and its other write slots none);
      hot         every id over 4 values, no slot unused;
      duplicates  each row repeats its ids across its slots;
      self_read   every task reads the id it writes;
      near_max    ids within 8 of 2^31 - 1;
      unused      every slot unused;
      invalid     every task invalid;
      random      nothing more."""
    span = 4 if kind == "hot" else max(4, w)
    reads = torch.randint(0, span, (w, nr), generator=gen, dtype=torch.int32)
    writes = torch.randint(0, span, (w, nw), generator=gen, dtype=torch.int32)
    if kind not in ("hot", "chain"):
        reads[torch.rand((w, nr), generator=gen) < 0.2] = -1
        writes[torch.rand((w, nw), generator=gen) < 0.2] = -1
    valid = torch.arange(w) < w - w // 7
    if kind == "chain":
        writes.fill_(-1)
        writes[:, 0] = 0
    elif kind == "duplicates":
        reads[:] = reads[:, :1]
        writes[:] = writes[:, :1]
    elif kind == "self_read":
        reads[:, 0] = writes[:, 0]
    elif kind == "near_max":
        reads = torch.where(reads >= 0, INT32_MAX - reads % 8, reads)
        writes = torch.where(writes >= 0, INT32_MAX - writes % 8, writes)
    elif kind == "unused":
        reads.fill_(-1)
        writes.fill_(-1)
    elif kind == "invalid":
        valid.fill_(False)
    return reads.to(device), writes.to(device), valid.to(device)


def hard_slots(w):
    """(nr, nw) of the row side and of the column side of a hard case:
    SIS's 18 reads from W = 4096 on, 3 below; two writes on the row side."""
    nr = 18 if w >= 4096 else 3
    return (nr, 2), (nr, 1)


def check_conflict_parity(torch, conflict_matrix) -> int:
    """Narrow footprints at PARITY_WINDOWS, then wide ones with ids over
    8·nr·nw values, so that some cells conflict and some do not, then
    SIS's padded layout at PADDED_READS slots; then the hard inputs at
    HARD_WINDOWS and random footprints at BIG_PARITY_WINDOW."""
    gen = torch.Generator().manual_seed(1)
    cases = 0
    shapes = ([(w, nr, nw, None, False) for w in PARITY_WINDOWS
               for nr in (1, 21) for nw in (1, 2)]
              + [(w, nr, nw, 8 * nr * nw, False) for w in WIDE_WINDOWS
                 for nr in WIDE_READS for nw in (1, 2)]
              + [(w, PADDED_READS, nw, 4 * w, True) for w in WIDE_WINDOWS
                 for nw in (1, 2)])
    shapes += [(w, *hard_slots(w)[0], kind, False) for w in HARD_WINDOWS
               for kind in HARD_KINDS]
    shapes += [(BIG_PARITY_WINDOW, 18, 1, "random", False)]
    for w, nr, nw, ids, pad in shapes:
        for strict in (True, False):
            if isinstance(ids, str):
                reads, writes, valid = hard_footprint(torch, gen, ids, w, nr,
                                                      nw, "cuda")
            else:
                reads, writes, valid = random_footprint(
                    torch, gen, w, nr, nw, "cuda", ids=ids, pad=pad)
            got = conflict_matrix(reads, writes, valid, strict=strict,
                                  backend="cuda")
            want = conflict_matrix(reads, writes, valid, strict=strict,
                                   backend="torch")
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"conflict kernel != plain version at W={w} nr={nr} "
                     f"nw={nw} strict={strict} padded={pad} ids={ids}: "
                     f"{int((got != want).sum())} cells")
            cases += 1
            del got, want
    log(f"parity conflict: {cases} cases bit-exact (nr up to "
        f"{PADDED_READS}, padded as SIS pads; hard inputs "
        f"{', '.join(HARD_KINDS)} at W in {HARD_WINDOWS}; W = "
        f"{BIG_PARITY_WINDOW})")
    return 0  # a case that differs fails: the worst error is 0


def check_levels_parity(torch, wave_levels) -> int:
    """The levels kernel against its plain version: random lower-triangular
    windows at PARITY_WINDOWS of three densities with and without a base,
    one matrix with entries above the diagonal, windows beyond 8192
    (BIG_LEVEL_WINDOWS, with a base and an invalid tail), a pure chain
    (depth = W) at W = 4096 and serving-shaped windows of 8. Prints the
    passes each case took and whether the blocked sweep finished it."""
    from repro_torch.kernels.levels import levels as levels_kernel

    gen = torch.Generator().manual_seed(2)
    worst, cases, runs = 0, 0, []

    def one(conf, valid, base, what):
        nonlocal worst, cases
        got = wave_levels(conf, valid, base=base, backend="cuda")
        passes, swept = levels_kernel.last_run()
        want = wave_levels(conf, valid, base=base, backend="torch")
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        worst = max(worst, err)
        cases += 1
        runs.append({"case": what, "passes": passes, "swept": swept,
                     "levels": int(want.max()) + 1})
        if err:
            fail(f"levels kernel != plain version: {what}")

    for w in PARITY_WINDOWS:
        valid = (torch.arange(w) < w - w // 7).cuda()
        for density in LEVEL_DENSITIES:
            conf = torch.rand((w, w), generator=gen) < density
            conf = conf.tril(diagonal=-1).cuda()
            base = torch.randint(0, 5, (w,), generator=gen,
                                 dtype=torch.int32).cuda()
            one(conf, valid, None, f"W={w} density={density}")
            one(conf, valid, base, f"W={w} density={density} base")
    w = 1000
    conf = (torch.rand((w, w), generator=gen) < 0.05).cuda()  # not triangular
    one(conf, torch.ones(w, dtype=torch.bool, device="cuda"), None,
        "entries above the diagonal")
    gen_card = torch.Generator(device="cuda").manual_seed(2)
    for w, density in BIG_LEVEL_WINDOWS:  # the level vector past 32 KB
        valid = (torch.arange(w) < w - w // 7).cuda()
        conf = (torch.rand((w, w), generator=gen_card, device="cuda")
                < density).tril(diagonal=-1)
        base = torch.randint(0, 5, (w,), generator=gen,
                             dtype=torch.int32).cuda()
        one(conf, valid, None, f"W={w} density={density}")
        one(conf, valid, base, f"W={w} density={density} base")
    w = 4096
    chain = torch.zeros((w, w), dtype=torch.bool, device="cuda")
    idx = torch.arange(1, w, device="cuda")
    chain[idx, idx - 1] = True
    one(chain, torch.ones(w, dtype=torch.bool, device="cuda"), None,
        f"chain W={w}")
    # past the levels that fit a CTA's shared memory (the vector in L2):
    # a sparse window (the relaxation) and a chain (the sweep)
    w = LEVELS_L2_WINDOW
    valid = torch.ones(w, dtype=torch.bool, device="cuda")
    conf = torch.zeros((w, w), dtype=torch.bool, device="cuda")
    rows = torch.randint(1, w, (w // 2,), generator=gen_card, device="cuda")
    cols = (torch.rand(w // 2, generator=gen_card, device="cuda")
            * rows).long()
    conf[rows, cols] = True
    one(conf, valid, None, f"W={w} sparse")
    conf.zero_()
    idx = torch.arange(1, w, device="cuda")
    conf[idx, idx - 1] = True
    one(conf, valid, None, f"chain W={w}")
    del conf
    # serving: 8 slots, one task each (no conflict), and chains of one
    # request's tasks, with a floor
    serving = torch.zeros((8, 8), dtype=torch.bool)
    one(serving.cuda(), torch.ones(8, dtype=torch.bool, device="cuda"),
        None, "serving W=8")
    for i, j in ((1, 0), (2, 1), (5, 3), (7, 5), (7, 6)):
        serving[i, j] = True
    one(serving.cuda(), torch.tensor([1, 1, 1, 1, 1, 1, 0, 1],
                                     dtype=torch.bool, device="cuda"),
        torch.tensor([0, 0, 2, 0, 1, 0, 0, 0], dtype=torch.int32,
                     device="cuda"), "serving W=8 chains base")
    for r in runs:
        log("levels passes: " + json.dumps(r))
    log(f"parity levels: {cases} cases bit-exact (W up to "
        f"{max(w for w, _ in BIG_LEVEL_WINDOWS)})")
    return worst


def check_block_parity(torch, conflict_block) -> int:
    """Narrow footprints at BLOCK_SHAPES with each side's slots in SLOTS,
    then wide ones on one side or both at WIDE_WINDOWS, ids over 16·nr
    values, then SIS's padded layout at PADDED_READS slots on both sides;
    ids drawn over one range, so the two sides collide. Then the hard
    inputs at HARD_BLOCKS and random footprints at BIG_PARITY_WINDOW on
    both sides."""
    gen = torch.Generator().manual_seed(3)
    cases = 0
    pr = PADDED_READS
    shapes = ([(wi, wj, si, sj, None, False) for wi, wj in BLOCK_SHAPES
               for si in SLOTS for sj in SLOTS]
              + [(*WIDE_WINDOWS, si, sj, 16 * nr, False) for nr in WIDE_READS
                 for si, sj in (((nr, 1), (nr, 2)), ((nr, 2), (1, 1)),
                                ((21, 2), (nr, 1)))]
              + [(*WIDE_WINDOWS, si, sj, 4 * WIDE_WINDOWS[1], True)
                 for si, sj in (((pr, 1), (pr, 1)), ((pr, 2), (pr, 1)))])
    shapes += [(wi, wj, *hard_slots(wi), kind, False)
               for wi, wj in HARD_BLOCKS for kind in HARD_KINDS]
    big = BIG_PARITY_WINDOW
    shapes += [(big, big, (18, 1), (18, 1), "random", False)]
    for wi, wj, (nr_i, nw_i), (nr_j, nw_j), ids, pad in shapes:
        for strict in (True, False):
            if isinstance(ids, str):
                ri, wri, vi = hard_footprint(torch, gen, ids, wi, nr_i, nw_i,
                                             "cuda")
                rj, wrj, vj = hard_footprint(torch, gen, ids, wj, nr_j, nw_j,
                                             "cuda")
            else:
                ri, wri, vi = random_footprint(torch, gen, wi, nr_i, nw_i,
                                               "cuda", ids=ids, pad=pad)
                rj, wrj, vj = random_footprint(torch, gen, wj, nr_j, nw_j,
                                               "cuda", ids=ids, pad=pad)
            args = (ri, wri, rj, wrj, vi, vj)
            got = conflict_block(*args, strict=strict, backend="cuda")
            want = conflict_block(*args, strict=strict, backend="torch")
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"conflict_block kernel != plain version at Wi={wi} "
                     f"Wj={wj} (nr, nw)_i=({nr_i}, {nw_i}) (nr, nw)_j="
                     f"({nr_j}, {nw_j}) strict={strict} padded={pad} "
                     f"ids={ids}: {int((got != want).sum())} cells")
            cases += 1
            del got, want
    log(f"parity conflict_block: {cases} cases bit-exact (nr up to "
        f"{PADDED_READS}, padded as SIS pads; hard inputs "
        f"{', '.join(HARD_KINDS)} at (Wi, Wj) in {HARD_BLOCKS}; Wi = Wj = "
        f"{big})")
    return 0  # a case that differs fails: the worst error is 0


def check_axelrod_parity(torch, axelrod_wave) -> int:
    """Traits over 3 values, every fifth row with all features equal,
    uniforms on a grid of quarters (ties in the gate and the pick)."""
    gen = torch.Generator().manual_seed(4)
    worst, cases = 0, 0
    for w in AXELROD_WINDOWS:
        for f in AXELROD_FEATURES:
            for density, omega in zip(MASK_DENSITIES, (0.95, 0.5, 0.3)):
                s = torch.randint(0, 3, (w, f), generator=gen,
                                  dtype=torch.int32)
                t = torch.randint(0, 3, (w, f), generator=gen,
                                  dtype=torch.int32)
                t[::5] = s[::5]
                u = torch.randint(0, 4, (w,), generator=gen) / 4
                g = torch.randint(0, 4, (w, f), generator=gen) / 4
                m = torch.rand(w, generator=gen) < density
                args = [x.cuda() for x in (s, t, u, g, m)]
                got = axelrod_wave(*args, omega=omega, backend="cuda")
                want = axelrod_wave(*args, omega=omega, backend="torch")
                torch.cuda.synchronize()
                err = max(int((got[0] - want[0]).abs().max()),
                          int((got[1].int() - want[1].int()).abs().max()))
                worst = max(worst, err)
                cases += 1
                if err:
                    fail(f"axelrod_wave kernel != plain version at W={w} "
                         f"F={f} mask density={density} omega={omega}")
    log(f"parity axelrod_wave: {cases} cases bit-exact")
    return worst


def check_sir_parity(torch, sir_wave) -> int:
    """Random states (a third infected) and an all-I ring (every
    neighbour infected), on rings of N = 4,000, 4,003 (the wrapped
    halo's second range misaligned) and 10^6; subsets at both ends of
    the ring among random ones, and W = 1 at the first and at the last
    subset for s in {10, 25, 50} (rows of uniforms not 16-byte
    aligned)."""
    gen = torch.Generator().manual_seed(5)
    worst, cases = 0, 0

    def case(states, subsets, n, s, k):
        nonlocal worst, cases
        u = torch.rand((subsets.numel(), s), generator=gen)
        args = (states, subsets.cuda(), u.cuda())
        kw = dict(n_agents=n, k=k, subset_size=s, **SIR_RATES)
        got = sir_wave(*args, backend="cuda", **kw)
        want = sir_wave(*args, backend="torch", **kw)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        worst = max(worst, err)
        cases += 1
        if err:
            fail(f"sir_wave kernel != plain version at W={subsets.numel()} "
                 f"s={s} k={k} N={n} subsets {subsets[:2].tolist()}...")

    for n in SIR_RINGS:
        for fill in ("random", "all I"):
            states = torch.randint(0, 3, (n,), generator=gen).to(torch.int8)
            if fill == "all I":
                states.fill_(1)
            states = states.cuda()
            for s, k in SIR_SHAPES:
                for w in SIR_WINDOWS:
                    m = n // s
                    subsets = torch.randint(0, m, (w,), generator=gen,
                                            dtype=torch.int32)
                    subsets[0] = m - 1 if w == 1 else 0
                    subsets[-1] = m - 1
                    case(states, subsets, n, s, k)
            for s, k in SIR_EDGE_SIZES:
                for b in (0, n // s - 1):
                    case(states, torch.tensor([b], dtype=torch.int32), n, s,
                         k)
    log(f"parity sir_wave: {cases} cases bit-exact")
    return worst


# ------------------------------------------------------------ main path
#: inclusive value range of every state leaf, per model
STATE_RANGE = {"voter": (0, 1), "sis": (0, 1), "axelrod": (0, 2),
               "sirs": (0, 2)}


def check_state(model_name, state, shapes):
    lo_ok, hi_ok = STATE_RANGE[model_name]
    for key, x in state.items():
        if tuple(x.shape) != shapes[key]:
            fail(f"{model_name}: final {key} has shape {tuple(x.shape)}, "
                 f"expected {shapes[key]}")
        lo, hi = int(x.min()), int(x.max())
        if lo < lo_ok or hi > hi_ok:
            fail(f"{model_name}: final {key} holds values outside "
                 f"[{lo_ok}, {hi_ok}]: [{lo}, {hi}]")


def states_equal(a: dict, b: dict) -> bool:
    return all(bool((a[k].cpu() == b[k].cpu()).all()) for k in a)


def drive_main_path(torch, total_tasks):
    """Voter and SIS through run_engine(engine="wavefront") at full size;
    returns (per-model results, summed launches, the models, the
    topology)."""
    from repro_torch.core import ProtocolConfig, run_engine, run_oracle
    from repro_torch.kernels.conflict import conflict as conflict_kernel
    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.mabs import SISModel, VoterModel
    from repro_torch.topology import watts_strogatz
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    results, launches, models = {}, {"conflict": 0, "levels": 0}, {}
    t0 = time.perf_counter()
    topo = watts_strogatz(N_NODES, DEGREE, REWIRE, prng.key(SEED))
    torch.cuda.synchronize()
    topo_s = time.perf_counter() - t0
    for name, cls in (("voter", VoterModel), ("sis", SISModel)):
        model = cls(topo)
        state0 = model.init_state(prng.key(SEED + 1))

        conflict_kernel.launches = 0
        levels_kernel.launches = 0
        t0 = time.perf_counter()
        out, stats = run_engine(model, state0, total_tasks, seed=SEED,
                                config=cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_conf, n_lev = conflict_kernel.launches, levels_kernel.launches
        launches["conflict"] += n_conf
        launches["levels"] += n_lev
        if not (n_conf == n_lev == stats["n_windows"]):
            fail(f"{name}: kernel launches conflict={n_conf} levels={n_lev}"
                 f" != n_windows={stats['n_windows']}")
        check_state(name, out, {k: (N_NODES,) for k in out})

        # the first CHECK_WINDOWS windows: oracle and a CPU run of the port
        prefix = min(CHECK_WINDOWS * WINDOW, total_tasks)
        t1 = time.perf_counter()
        wf, wf_stats = run_engine(model, state0, prefix, seed=SEED,
                                  config=cfg)
        oracle = run_oracle(model, state0, prefix, seed=SEED, config=cfg)
        if not states_equal(wf, oracle):
            fail(f"{name}: wavefront != sequential oracle on the first "
                 f"{prefix} tasks")
        cpu_model = cls(topo.to("cpu"))
        cpu_state0 = {k: v.cpu() for k, v in state0.items()}
        cpu_out, cpu_stats = run_engine(cpu_model, cpu_state0, prefix,
                                        seed=SEED, config=cfg, device="cpu")
        if cpu_stats != wf_stats or not states_equal(cpu_out, wf):
            fail(f"{name}: GPU run != CPU run of the port on the first "
                 f"{prefix} tasks: {wf_stats} vs {cpu_stats}")
        check_s = time.perf_counter() - t1
        results[name] = {
            "n_nodes": N_NODES, "max_degree": topo.max_degree,
            "window": WINDOW, "total_tasks": total_tasks,
            "n_windows": stats["n_windows"],
            "total_waves": stats["total_waves"],
            "mean_parallelism": stats["mean_parallelism"],
            "seconds": secs, "tasks_per_s": total_tasks / secs,
            "topology_seconds": topo_s, "check_seconds": check_s,
            "checked_tasks": prefix,
        }
        log(f"main path {name}: " + json.dumps(results[name]))
        models[name] = model
    return results, launches, models, topo


def window_breakdown(torch, models, n_windows: int = 16):
    """Host-clock split of one window of the main path into its steps,
    each fenced by a synchronize (so the sum exceeds an unfenced
    window): creation, record check, levels, waves."""
    from repro_torch.core.records import wave_levels, window_conflicts
    from repro_torch.core.wavefront import execute_window
    from repro_torch.utils import prng

    def fenced(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for name, model in models.items():
        base_key = prng.key(SEED)
        state = model.init_state(prng.key(SEED + 1))
        valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)
        split = {"create": 0.0, "conflict": 0.0, "levels": 0.0,
                 "waves": 0.0}
        waves = 0
        for k in range(n_windows):
            rec, t = fenced(lambda: model.create_tasks(base_key, k * WINDOW,
                                                       WINDOW))
            split["create"] += t
            conf, t = fenced(lambda: window_conflicts(model, rec, valid))
            split["conflict"] += t
            lv, t = fenced(lambda: wave_levels(conf, valid))
            split["levels"] += t
            (state, n), t = fenced(lambda: execute_window(
                model, state, rec, valid, levels=lv))
            split["waves"] += t
            waves += n
        row = {f"{k}_ms": v / n_windows * 1e3 for k, v in split.items()}
        row["waves_per_window"] = waves / n_windows
        log(f"window breakdown {name} W={WINDOW}: " + json.dumps(row))


def profile_kernels(torch, name, model, engine, n_windows):
    """(device µs, launches) by kernel name over n_windows windows of one
    path (torch.profiler)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ProtocolConfig, run_engine
    from repro_torch.utils import prng

    state0 = model.init_state(prng.key(SEED + 1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_engine(model, state0, n_windows * WINDOW, seed=SEED,
                   config=ProtocolConfig(window=WINDOW), engine=engine)
        torch.cuda.synchronize()
    # the protocol.* ranges (obs/profiler.py) appear on the device
    # timeline as user annotations spanning their kernels: not kernels
    kernels = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")
               and not e.is_user_annotation]
    if not kernels:
        fail(f"{name}: the profiler saw no device time")
    ranges = {e.name for e in kernels if e.name.startswith("protocol.")}
    if ranges:
        fail(f"{name}: profiler ranges counted as kernels: {ranges}")
    us, calls = Counter(), Counter()
    for e in kernels:
        us[e.name] += e.device_time
        calls[e.name] += 1
    return us, calls


def device_busy(torch, models, results, engine="wavefront",
                n_windows: int = 16):
    """Device time per window of a path (torch.profiler: the
    durations of the kernels the card ran) against the unprofiled main
    path's wall time per window: the device's busy and idle shares, and
    the kernels that take the most device time. The profiler's host
    overhead stretches the profiled wall clock, so the wall time comes
    from the path's unprofiled run."""
    for name, model in models.items():
        us, calls = profile_kernels(torch, name, model, engine, n_windows)
        busy = sum(us.values()) / 1e3 / n_windows
        wall_ms = results[name]["seconds"] / results[name]["n_windows"] * 1e3
        row = {"device_ms_per_window": busy,
               "wall_ms_per_window": wall_ms,
               "busy_share": busy / wall_ms,
               "idle_share": 1.0 - busy / wall_ms,
               "kernels_per_window": sum(calls.values()) / n_windows,
               "top": [[k[:60], t / 1e3 / n_windows, calls[k] / n_windows]
                       for k, t in us.most_common(4)]}
        log(f"device time {engine} {name} W={WINDOW}: " + json.dumps(row))


# --------------------------------------------------------- overlap path
def build_overlap_models(torch, topo):
    """The overlap path's four models on the card, with a function that
    rebuilds each on the CPU (for the CPU run of the port)."""
    from repro_torch.mabs import (
        AxelrodConfig,
        AxelrodModel,
        SIRConfig,
        SIRModel,
        SISModel,
        VoterModel,
    )

    ax_cfg = AxelrodConfig(n_agents=N_NODES, n_features=3, q=3, omega=0.95)
    sir_cfg = SIRConfig(n_agents=N_NODES, k=14, subset_size=50)
    t0 = time.perf_counter()
    models = {"voter": VoterModel(topo), "sis": SISModel(topo),
              "axelrod": AxelrodModel(ax_cfg),
              "sirs": SIRModel(sir_cfg)}
    torch.cuda.synchronize()
    log(f"overlap models built: {time.perf_counter() - t0:.2f} s (SIRS "
        f"block graph: {models['sirs'].block_topo.n_nodes} blocks, "
        f"max degree {models['sirs'].block_topo.max_degree})")
    cpu = {"voter": lambda m: VoterModel(m.topology.to("cpu")),
           "sis": lambda m: SISModel(m.topology.to("cpu")),
           "axelrod": lambda m: AxelrodModel(m.cfg, device="cpu"),
           "sirs": lambda m: SIRModel(m.cfg,
                                      topology=m.topology.to("cpu"))}
    return models, cpu


def check_overlap_envelope(name, stats, barrier):
    """The reference's monotone envelope of the overlap stats
    (tests/conftest.py::assert_overlap_stats_monotone)."""
    ok = (stats["overlap"] is True
          and stats["n_boundaries"] == max(stats["n_windows"] - 1, 0)
          and 0 <= stats["mean_overlap_depth"] <= WINDOW
          and 0 <= stats["max_overlap_depth"] <= WINDOW
          and (stats["mean_overlap_depth"] <= stats["max_overlap_depth"]
               or stats["n_boundaries"] == 0)
          and 0 <= stats["overlap_tasks_early"] <= stats["total_tasks"]
          and (0 <= stats["carry_frontier_mean"]
               <= stats["carry_frontier_max"]
               or stats["n_boundaries"] == 0)
          and stats["carry_frontier_max"] <= WINDOW
          and (stats["max_overlap_depth"] > 0
               or stats["overlap_tasks_early"] == 0)
          and stats["total_waves"] <= barrier["total_waves"]
          and stats["total_tasks"] == barrier["total_tasks"])
    if not ok:
        fail(f"{name}: overlap stats outside the monotone envelope: "
             f"{stats} vs barrier {barrier}")


@contextmanager
def counting_waves(model):
    """Count the ``execute_wave`` calls the engines make on ``model``
    inside the block: yields [count]."""
    calls = [0]
    execute_wave = model.execute_wave

    def counted(*args, **kwargs):
        calls[0] += 1
        return execute_wave(*args, **kwargs)

    model.execute_wave = counted
    try:
        yield calls
    finally:
        del model.execute_wave


def wave_kernels():
    """The wave kernels' bindings, by the model that launches each."""
    from repro_torch.kernels.axelrod import axelrod as axelrod_kernel
    from repro_torch.kernels.sir import sir as sir_kernel

    return {"axelrod_wave": ("axelrod", axelrod_kernel),
            "sir_wave": ("sirs", sir_kernel)}


def check_wave_launches(name, family, calls):
    """Each wave kernel launched once per execute_wave call of its own
    model's family and never for another; returns the counts."""
    n = {}
    for kname, (owner, kernel) in wave_kernels().items():
        n[kname] = kernel.launches
        want = calls if owner == family else 0
        if kernel.launches != want:
            fail(f"{name}: {kname} launched {kernel.launches} times for "
                 f"{calls} execute_wave calls (expected {want})")
    log(f"wave kernel launches {name}: execute_wave calls {calls}, "
        + json.dumps(n))
    return n


def drive_overlap_path(torch, total_tasks, models, cpu_twin, barrier):
    """The four models through run_engine(engine="wavefront_overlap") at
    full size; returns (per-model results, summed launches)."""
    from repro_torch.core import ProtocolConfig, run_engine, run_oracle
    from repro_torch.kernels.conflict import conflict as conflict_kernel
    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    results = {}
    launches = {"conflict": 0, "levels": 0, "conflict_block": 0,
                "axelrod_wave": 0, "sir_wave": 0}
    for name, model in models.items():
        state0 = model.init_state(prng.key(SEED + 1))
        torch.cuda.synchronize()

        with counting_waves(model) as calls:
            conflict_kernel.launches = 0
            conflict_kernel.block_launches = 0
            levels_kernel.launches = 0
            for _, kernel in wave_kernels().values():
                kernel.launches = 0
            t0 = time.perf_counter()
            out, stats = run_engine(model, state0, total_tasks, seed=SEED,
                                    config=cfg, engine="wavefront_overlap")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        n = {"conflict": conflict_kernel.launches,
             "levels": levels_kernel.launches,
             "conflict_block": conflict_kernel.block_launches}
        nw = stats["n_windows"]
        if n != {"conflict": nw, "levels": nw,
                 "conflict_block": max(nw - 1, 0)}:
            fail(f"{name}: overlap launches {n}, expected conflict = levels"
                 f" = n_windows = {nw} and conflict_block = {nw - 1}")
        n.update(check_wave_launches(name, name, calls[0]))
        for k, v in n.items():
            launches[k] += v
        check_state(name, out, {k: tuple(v.shape)
                                for k, v in state0.items()})
        if name in barrier:  # the barrier path ran the same chain
            check_overlap_envelope(name, stats, barrier[name])

        # the first CHECK_WINDOWS windows: oracle, barrier run, CPU run
        prefix = min(CHECK_WINDOWS * WINDOW, total_tasks)
        t1 = time.perf_counter()
        ov, ov_stats = run_engine(model, state0, prefix, seed=SEED,
                                  config=cfg, engine="wavefront_overlap")
        wf, wf_stats = run_engine(model, state0, prefix, seed=SEED,
                                  config=cfg, engine="wavefront")
        if not states_equal(ov, wf):
            fail(f"{name}: wavefront_overlap != wavefront on the first "
                 f"{prefix} tasks")
        check_overlap_envelope(name, ov_stats, wf_stats)
        oracle = run_oracle(model, state0, prefix, seed=SEED, config=cfg)
        if not states_equal(ov, oracle):
            fail(f"{name}: wavefront_overlap != sequential oracle on the "
                 f"first {prefix} tasks")
        cpu_out, cpu_stats = run_engine(
            cpu_twin[name](model), {k: v.cpu() for k, v in state0.items()},
            prefix, seed=SEED, config=cfg, engine="wavefront_overlap",
            device="cpu")
        if cpu_stats != ov_stats or not states_equal(cpu_out, ov):
            fail(f"{name}: GPU overlap run != CPU run of the port on the "
                 f"first {prefix} tasks: {ov_stats} vs {cpu_stats}")
        check_s = time.perf_counter() - t1
        results[name] = {
            "window": WINDOW, "total_tasks": total_tasks,
            "n_windows": nw, "total_waves": stats["total_waves"],
            "mean_parallelism": stats["mean_parallelism"],
            "seconds": secs, "tasks_per_s": total_tasks / secs,
            "barrier_total_waves": barrier.get(name, {}).get("total_waves"),
            "checked_tasks": prefix,
            "checked_barrier_waves": wf_stats["total_waves"],
            "checked_overlap_waves": ov_stats["total_waves"],
            "check_seconds": check_s, "execute_wave_calls": calls[0],
            **{k: stats[k] for k in (
                "n_boundaries", "mean_overlap_depth", "max_overlap_depth",
                "overlap_tasks_early", "carry_frontier_mean",
                "carry_frontier_max")},
        }
        log(f"main path overlap {name}: " + json.dumps(results[name]))
    return results, launches


def overlap_breakdown(torch, models, n_windows: int = 16):
    """Host-clock split of the overlap path's windows, each step fenced
    by a synchronize: the next window's schedule (creation + record
    check), the boundary step (block kernel, carry frontier, floored
    levels) and the fused drain."""
    from repro_torch.core.records import wave_levels
    from repro_torch.engine import make_engine
    from repro_torch.utils import prng

    def fenced(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for name, model in models.items():
        eng = make_engine("wavefront_overlap", model, window=WINDOW)
        base_key = prng.key(SEED)
        state = model.init_state(prng.key(SEED + 1))
        cur = eng._schedule_ov(base_key, 0, WINDOW)
        lv = wave_levels(cur[2], cur[1])
        split = {"schedule": 0.0, "boundary": 0.0, "drain": 0.0}
        waves = 0
        for k in range(1, n_windows + 1):
            nxt, t = fenced(lambda: eng._schedule_ov(base_key, k * WINDOW,
                                                     WINDOW))
            split["schedule"] += t
            (lv_nxt, _), t = fenced(lambda: eng._boundary(
                cur[0], lv, nxt[0], nxt[1], nxt[2]))
            split["boundary"] += t
            (state, n, lv_nxt), t = fenced(lambda: eng._execute_pair(
                state, cur, lv, nxt, lv_nxt))
            split["drain"] += t
            waves += n
            cur, lv = nxt, lv_nxt
        row = {f"{k}_ms": v / n_windows * 1e3 for k, v in split.items()}
        row["fused_waves_per_window"] = waves / n_windows
        log(f"window breakdown overlap {name} W={WINDOW}: "
            + json.dumps(row))


def drive_task_size(torch, total_tasks):
    """Axelrod at F = 500 and SIRS at s = 1000 (n = 10^6) through
    run_engine(engine="wavefront_overlap") at W = 4096, wave kernel
    launches counted; then the first window against a CPU run of the port
    and the first ORACLE_TASKS tasks against the oracle. Returns
    (per-model results, summed launches, {name: (model, state0)})."""
    from repro_torch.core import ProtocolConfig, run_engine, run_oracle
    from repro_torch.mabs import (
        AxelrodConfig,
        AxelrodModel,
        SIRConfig,
        SIRModel,
    )
    from repro_torch.utils import prng

    cases = {
        f"axelrod F={WIDE_F}": (
            "axelrod",
            lambda: AxelrodModel(AxelrodConfig(
                n_agents=N_NODES, n_features=WIDE_F, q=3, omega=0.95)),
            lambda m: AxelrodModel(m.cfg, device="cpu")),
        f"sirs s={WIDE_S}": (
            "sirs",
            lambda: SIRModel(SIRConfig(n_agents=N_NODES, k=14,
                                       subset_size=WIDE_S)),
            lambda m: SIRModel(m.cfg, topology=m.topology.to("cpu"))),
    }
    cfg = ProtocolConfig(window=WINDOW)
    results, kept = {}, {}
    launches = {"axelrod_wave": 0, "sir_wave": 0}
    for name, (family, make, on_cpu) in cases.items():
        model = make()
        state0 = model.init_state(prng.key(SEED + 1))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the init's temporaries
        with counting_waves(model) as calls:
            for _, kernel in wave_kernels().values():
                kernel.launches = 0
            t0 = time.perf_counter()
            out, stats = run_engine(model, state0, total_tasks, seed=SEED,
                                    config=cfg, engine="wavefront_overlap")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        for k, v in check_wave_launches(name, family, calls[0]).items():
            launches[k] += v
        check_state(family, out, {k: tuple(v.shape)
                                  for k, v in state0.items()})
        del out

        t1 = time.perf_counter()
        first, first_stats = run_engine(model, state0, WINDOW, seed=SEED,
                                        config=cfg,
                                        engine="wavefront_overlap")
        cpu_out, cpu_stats = run_engine(
            on_cpu(model), {k: v.cpu() for k, v in state0.items()}, WINDOW,
            seed=SEED, config=cfg, engine="wavefront_overlap", device="cpu")
        if cpu_stats != first_stats or not states_equal(cpu_out, first):
            fail(f"{name}: GPU run != CPU run of the port on the first "
                 f"window: {first_stats} vs {cpu_stats}")
        del first, cpu_out
        oracle = run_oracle(model, state0, ORACLE_TASKS, seed=SEED,
                            config=ProtocolConfig(window=256))
        for w in (WINDOW, 256):
            ov, _ = run_engine(model, state0, ORACLE_TASKS, seed=SEED,
                               config=ProtocolConfig(window=w),
                               engine="wavefront_overlap")
            if not states_equal(ov, oracle):
                fail(f"{name}: wavefront_overlap at W={w} != sequential "
                     f"oracle on the first {ORACLE_TASKS} tasks")
        del oracle, ov
        check_s = time.perf_counter() - t1
        results[name] = {
            "n_agents": N_NODES, "window": WINDOW,
            "total_tasks": total_tasks, "n_windows": stats["n_windows"],
            "total_waves": stats["total_waves"],
            "mean_parallelism": stats["mean_parallelism"],
            "seconds": secs, "tasks_per_s": total_tasks / secs,
            "ms_per_window": secs / stats["n_windows"] * 1e3,
            "execute_wave_calls": calls[0],
            "overlap_tasks_early": stats["overlap_tasks_early"],
            "check_seconds": check_s,
        }
        log(f"task size {name}: " + json.dumps(results[name]))
        kept[name] = (model, state0)
    return results, launches, kept


def drive_costs(torch, wide):
    """Phase 18 (a): ``compiled_costs`` of ``wavefront`` on the task-size
    phase's models (Axelrod F = 500, SIRS s = 1000; n = 10^6, W = 4096):
    the wave kernel's reported launches and counter against the window's
    waves, its reported work against ``work()`` on the same inputs, the
    caller's state unchanged; prints ``as_row()`` and the allocator's
    peak."""
    from repro_torch.engine import make_engine
    from repro_torch.kernels.axelrod import axelrod as axelrod_kernel
    from repro_torch.kernels.axelrod.ops import work as axelrod_work
    from repro_torch.kernels.sir import sir as sir_kernel
    from repro_torch.kernels.sir.ops import work as sir_work
    from repro_torch.utils import prng

    for name, (model, state0) in wide.items():
        eng = make_engine("wavefront", model, window=WINDOW)
        _, _, levels = eng._schedule(prng.key(SEED), 0, WINDOW)
        waves = int(levels.max()) + 1
        if name.startswith("axelrod"):
            kname, kernel = "axelrod_wave", axelrod_kernel
            one = axelrod_work(WINDOW, model.cfg.n_features)
        else:
            kname, kernel = "sir_wave", sir_kernel
            rec = model.create_tasks(prng.key(SEED), 0, WINDOW)
            one = sir_work(rec["subset"], n_agents=model.cfg.n_agents,
                           k=model.topology.ring_k,
                           subset_size=model.cfg.subset_size)
            del rec
        before = {k: v.clone() for k, v in state0.items()}
        kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        costs = eng.compiled_costs(state0, seed=SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        (cost,) = costs.values()
        want = {kname: {"launches": waves, "bytes": waves * one[0],
                        "ops": waves * one[1]}}
        if cost.kernels != want or kernel.launches != waves:
            fail(f"costs {name}: the kernels reported {cost.kernels} "
                 f"({kernel.launches} counted), the window's {waves} waves "
                 f"of work() make {want}")
        if not states_equal(state0, before):
            fail(f"costs {name}: compiled_costs changed the caller's state")
        del before
        log(f"costs wavefront {name} W={WINDOW}: " + json.dumps(
            {**cost.as_row(), "kernels": cost.kernels, "waves": waves,
             "device_peak_bytes": cost.device_peak_bytes,
             "seconds": secs}))


#: the dry run's cells whose collectives the cost phase counts
DRYRUN_CELLS = (("smollm-360m", "train_4k"),
                ("qwen3-moe-235b-a22b", "train_4k"))
DRYRUN_TIMEOUT_S = 600


def start_dryrun_cells(src):
    """Phase 18 (d): start the dry run of each ``DRYRUN_CELLS`` cell on
    the single-pod mesh, collectives counted, flops not, in a process of
    its own (each makes itself rank 0 of a fake world of 256). Returns
    (processes, output directory, start time)."""
    import os

    out = ROOT / "build" / "dryrun_costs"
    out.mkdir(parents=True, exist_ok=True)
    for f in out.iterdir():
        f.unlink()
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log_f = open(out / f"{arch}__{shape}.log", "w")
        procs.append((arch, shape, log_f, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--no-flops",
             "--out", str(out)], env=env, stdout=log_f,
            stderr=subprocess.STDOUT)))
    return procs, out, time.perf_counter()


def check_dryrun_cells(procs, out, t0) -> None:
    """Phase 18 (d): wait for the dry-run cells; each must be ``ok`` with
    non-null collectives. Prints their collectives and bytes accessed."""
    try:
        for arch, shape, log_f, p in procs:
            try:
                p.wait(max(DRYRUN_TIMEOUT_S - (time.perf_counter() - t0), 1))
            except subprocess.TimeoutExpired:
                fail(f"dry run {arch} {shape}: not done in "
                     f"{DRYRUN_TIMEOUT_S} s")
            log_f.close()
            path = out / f"{arch}__{shape}__single.json"
            if p.returncode != 0 or not path.exists():
                fail(f"dry run {arch} {shape} exited {p.returncode}: "
                     + (out / f"{arch}__{shape}.log").read_text()[-3000:])
            rec = json.loads(path.read_text())
            if rec.get("status") != "ok" or rec.get("collectives") is None:
                fail(f"dry run {arch} {shape}: {rec.get('status')}, "
                     f"collectives {rec.get('collectives')}: "
                     f"{rec.get('not_measured')}")
            log(f"dry run collectives {arch} {shape} single: " + json.dumps(
                {"collectives": rec["collectives"],
                 "bytes_accessed": rec["cost_analysis"]["bytes_accessed"],
                 "microbatches": rec.get("microbatches"),
                 "argument_bytes": rec["memory"]["argument_bytes"],
                 "collectives_s": rec["collectives_s"]}))
    finally:
        stop_dryrun_cells(procs)


def stop_dryrun_cells(procs) -> None:
    """Kill the dry-run cells still running and close their logs."""
    for _, _, log_f, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(10)
        log_f.close()


def span_split(events, n_windows):
    """ms per window of each B/E span name on the windows thread."""
    from collections import defaultdict

    total, stack = defaultdict(float), []
    for e in events:
        if e.get("tid") != 0 or e["ph"] not in ("B", "E"):
            continue
        if e["ph"] == "B":
            stack.append(e)
        else:
            b = stack.pop()
            total[b["name"]] += (e["ts"] - b["ts"]) / 1e3
    return {f"{k}_ms": v / n_windows for k, v in total.items()
            if k != "run"}


def traced_run(torch, models, n_windows: int = TRACE_WINDOWS):
    """n_windows windows of the overlap path under tracing() for Axelrod
    and SIRS: a valid Chrome trace with the reference's taxonomy, and the
    untraced run's state and stats."""
    from collections import Counter

    from repro_torch.core import ProtocolConfig, run_engine
    from repro_torch.obs import tracing, validate_chrome_trace
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    total = n_windows * WINDOW
    (ROOT / "build").mkdir(exist_ok=True)
    for name in ("axelrod", "sirs"):
        model = models[name]
        state0 = model.init_state(prng.key(SEED + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain, plain_stats = run_engine(model, state0, total, seed=SEED,
                                        config=cfg,
                                        engine="wavefront_overlap")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with tracing() as tr:
            out, stats = run_engine(model, state0, total, seed=SEED,
                                    config=cfg, engine="wavefront_overlap")
        traced_s = time.perf_counter() - t0
        path = ROOT / "build" / f"trace_{name}.json"
        payload = tr.export(str(path))
        n_events = validate_chrome_trace(payload)
        if stats != plain_stats or not states_equal(out, plain):
            fail(f"{name}: the traced run != the untraced run: {stats} vs "
                 f"{plain_stats}")
        events = payload["traceEvents"]
        spans = Counter(e["name"] for e in events if e["ph"] == "B")
        want = {"run": 1, "schedule": n_windows, "execute": n_windows,
                "boundary": n_windows - 1}
        if dict(spans) != want:
            fail(f"{name}: trace spans {dict(spans)}, expected {want}")
        waves = [e for e in events if e["name"] == "wave"]
        widths = sum(e["args"]["width"] for e in waves)
        if len(waves) != stats["total_waves"] or widths != total:
            fail(f"{name}: {len(waves)} wave spans of total width {widths}"
                 f" for {stats['total_waves']} waves and {total} tasks")
        row = {"events": n_events, "trace": str(path.relative_to(ROOT)),
               "waves": len(waves),
               "traced_ms_per_window": traced_s / n_windows * 1e3,
               "untraced_ms_per_window": plain_s / n_windows * 1e3,
               **span_split(events, n_windows)}
        log(f"traced run overlap {name} W={WINDOW}: " + json.dumps(row))


def time_overlap(torch, total_tasks):
    """Wall ms per window of the overlap path for Axelrod (F = 3) and
    SIRS (s = 50), n = 10^6, W = 4096, after a two-window warm-up, with
    whichever port package is first on sys.path."""
    import repro_torch
    from repro_torch.core import ProtocolConfig, run_engine
    from repro_torch.mabs import (
        AxelrodConfig,
        AxelrodModel,
        SIRConfig,
        SIRModel,
    )
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    models = {"axelrod": AxelrodModel(AxelrodConfig(
                  n_agents=N_NODES, n_features=3, q=3, omega=0.95)),
              "sirs": SIRModel(SIRConfig(n_agents=N_NODES, k=14,
                                         subset_size=50))}
    row = {"package": str(Path(repro_torch.__file__).parent.parent)}
    for name, model in models.items():
        state0 = model.init_state(prng.key(SEED + 1))
        run_engine(model, state0, 2 * WINDOW, seed=SEED, config=cfg,
                   engine="wavefront_overlap")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, stats = run_engine(model, state0, total_tasks, seed=SEED,
                              config=cfg, engine="wavefront_overlap")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        row[f"{name}_ms_per_window"] = secs / stats["n_windows"] * 1e3
        row[f"{name}_total_waves"] = stats["total_waves"]
    log("overlap wall per window: " + json.dumps(row))


def host_us(torch, fn, calls=500):
    """Host µs per call of fn, launched back to back (one synchronize
    before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def time_kernels(torch):
    """Device ms of the conflict, block, levels, flash, wkv6 and SIRS
    kernels on inputs made from the seed, with whichever port package is
    first on sys.path (see --time-kernels)."""
    import repro_torch
    from repro_torch.kernels.conflict.ops import (
        conflict_block,
        conflict_matrix,
    )
    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.levels.ops import wave_levels
    from repro_torch.kernels.sir.ops import sir_wave
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ops import work as wkv6_work
    from repro_torch.mabs import SIRConfig, SIRModel, SISModel, VoterModel
    from repro_torch.topology import watts_strogatz
    from repro_torch.utils import prng
    from repro_torch.utils.timing import cuda_event_ms

    row = {"package": str(Path(repro_torch.__file__).parent.parent)}
    topo = watts_strogatz(N_NODES, DEGREE, REWIRE, prng.key(SEED))
    valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)

    def conflict_pair(name, r0, w0, r1, w1):
        """The prefix matrix of window (r0, w0) and the block of the next
        window (r1, w1) against it, timed, with their densities."""
        row[f"conflict_{name}_ms"] = cuda_event_ms(
            lambda: conflict_matrix(r0, w0, valid, backend="cuda"))
        row[f"block_{name}_ms"] = cuda_event_ms(lambda: conflict_block(
            r1, w1, r0, w0, valid, valid, backend="cuda"))
        row[f"conflict_{name}_density"] = float(
            conflict_matrix(r0, w0, valid).sum()) / (WINDOW * (WINDOW - 1)
                                                     / 2)
        row[f"block_{name}_density"] = float(conflict_block(
            r1, w1, r0, w0, valid, valid).sum()) / (WINDOW * WINDOW)

    for name, model in (("voter", VoterModel(topo)), ("sis", SISModel(topo))):
        r0, w0 = window_footprints(model)
        r1, w1 = window_footprints(model, WINDOW)
        conflict_pair(name, r0, w0, r1, w1)
        if name == "sis":  # the host's cost of a call, back to back
            row["conflict_sis_host_us"] = host_us(
                torch, lambda: conflict_matrix(r0, w0, valid, backend="cuda"))
            row["block_sis_host_us"] = host_us(torch, lambda: conflict_block(
                r1, w1, r0, w0, valid, valid, backend="cuda"))
        conf = conflict_matrix(r0, w0, valid)
        row[f"levels_{name}_ms"] = cuda_event_ms(
            lambda: wave_levels(conf, valid, backend="cuda"))
        if name == "sis":  # the device's busy ms per window on both paths
            for engine in ("wavefront", "wavefront_overlap"):
                us, _ = profile_kernels(torch, name, model, engine, 16)
                row[f"busy_sis_{engine}_ms"] = sum(us.values()) / 16e3
                row[f"busy_sis_{engine}_conflict_ms"] = sum(
                    t for k, t in us.items() if "conflict" in k) / 16e3
    # the hub graph's window and boundary (3,057 slots), a chain (SIS's
    # slots, every task writes id 0) and a hot-id window (SIS's slots, ids
    # over HOT_IDS values)
    hub, _, _ = hub_topology(torch)
    hub_sis = SISModel(hub)
    conflict_pair("hub", *window_footprints(hub_sis),
                  *window_footprints(hub_sis, WINDOW))
    del hub, hub_sis
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for name, span in (("chain", N_NODES), ("hot", HOT_IDS)):
        r0, w0, r1, w1 = (torch.randint(0, span, (WINDOW, n), generator=gen,
                                        dtype=torch.int32, device=DEVICE)
                          for n in (18, 1, 18, 1))
        if name == "chain":
            w0.zero_()
            w1.zero_()
        conflict_pair(name, r0, w0, r1, w1)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    dense = (torch.rand((WINDOW, WINDOW), generator=gen, device=DEVICE)
             < 0.3).tril(diagonal=-1)
    row["levels_density_0.3_ms"] = cuda_event_ms(
        lambda: wave_levels(dense, valid, backend="cuda"))
    chain = torch.zeros((WINDOW, WINDOW), dtype=torch.bool, device=DEVICE)
    idx = torch.arange(1, WINDOW, device=DEVICE)
    chain[idx, idx - 1] = True
    row["levels_chain_ms"] = cuda_event_ms(
        lambda: wave_levels(chain, valid, backend="cuda"))
    del dense, chain
    v8 = torch.ones(8, dtype=torch.bool, device=DEVICE)
    for what, c8 in (("none", torch.zeros((8, 8), dtype=torch.bool)),
                     ("chain", torch.ones((8, 8), dtype=torch.bool)
                      .tril(diagonal=-1))):
        c8 = c8.to(DEVICE)
        row[f"levels_w8_{what}_ms"] = cuda_event_ms(
            lambda: wave_levels(c8, v8, backend="cuda"))
        row[f"levels_w8_{what}_host_us"] = host_us(
            torch, lambda: wave_levels(c8, v8, backend="cuda"))
    q, k, v = flash_inputs(torch, 1, 15, 5, 2048, 2048, 64, torch.bfloat16,
                           99)
    row["flash_bf16_ms"] = cuda_event_ms(
        lambda: flash_attention(q, k, v, causal=True))
    del q, k, v
    # wkv6 in bf16 at rwkv6-3b's one-shot prefill, the engine's prefill
    # chunk and decode wave (both with a carried state)
    for name, (b, h, t, d), s0 in (
            ("prefill", (1, 40, 2048, 64), False),
            ("chunk", (1, 40, LM_PREFILL_CHUNK, 64), True),
            ("decode", (LM_SLOTS, 40, 1, 64), True)):
        args, state = wkv6_inputs(torch, b, h, t, d, torch.bfloat16, 98,
                                  "spread", s0)
        row[f"wkv6_{name}_ms"] = cuda_event_ms(
            lambda: wkv6(*args, s0=state))
        row[f"wkv6_{name}_bound_ms"] = bound_ms(*wkv6_work(b, h, t, d,
                                                           s0))[0]
    # SIRS on the first wave's inputs of a real window at s = 50 (the
    # overlap path's) and s = 1000 (the task-size phase's)
    for s_sz in (50, WIDE_S):
        model = SIRModel(SIRConfig(n_agents=N_NODES, k=14,
                                   subset_size=s_sz))
        args, kw, nbytes, ops, _ = sir_wave_case(torch, model)
        row[f"sir_s{s_sz}_ms"] = cuda_event_ms(
            lambda: sir_wave(*args, backend="cuda", **kw))
        row[f"sir_s{s_sz}_bound_ms"] = bound_ms(nbytes, ops)[0]
        del model, args
    # the floor of this timing: a one-element add_, launch to launch
    one = torch.zeros(1, device=DEVICE)
    row["floor_add_ms"] = cuda_event_ms(lambda: one.add_(1))
    row.update(rwkv_wave_profile(torch))
    log("kernel times: " + json.dumps(row))


def rwkv_wave_profile(torch, waves: int = 10) -> dict:
    """rwkv6-3b decode waves at full width (bf16 weights, LM_SLOTS slots,
    every other slot committed, the time-mixes through the wkv6 kernel)
    under torch.profiler: device ms and kernels per wave, the wkv6
    kernel's share and the five costliest kernels — the state's writes
    included."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    model = lm_model(torch, "bfloat16", "pallas", RWKV_ARCH)
    params = model.init(SEED, device=DEVICE)
    states = model.init_states(LM_SLOTS, LM_MAX_LEN)
    tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=DEVICE)
    commit = torch.arange(LM_SLOTS, device=DEVICE) % 2 == 0
    for _ in range(3):
        model.decode_step(params, tok, states, commit=commit)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(waves):
            model.decode_step(params, tok, states, commit=commit)
        torch.cuda.synchronize()
    us = Counter()
    n = 0
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and not e.is_user_annotation:
            us[e.name] += e.device_time
            n += 1
    if not us:
        fail("rwkv wave profile: the profiler saw no device time")
    return {"rwkv_wave_device_ms": sum(us.values()) / waves / 1e3,
            "rwkv_wave_kernels": n / waves,
            "rwkv_wave_wkv6_ms": sum(t for k, t in us.items()
                                     if "wkv6" in k) / waves / 1e3,
            "rwkv_wave_top": [[k[:70], t / waves / 1e3]
                              for k, t in us.most_common(5)]}


#: the text of the warning sync debug mode gives for each host sync (its
#: one-time notice that the mode is a prototype also holds the word
#: "synchronizing", and is not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


def sync_warnings(caught) -> list[str]:
    """The messages of the host-sync warnings among ``caught``."""
    return [str(w.message) for w in caught
            if SYNC_WARNING in str(w.message)]


def count_syncs(torch, models, engine, n_windows: int = 16) -> dict:
    """Host syncs per window of one path over n_windows windows, as
    torch.cuda's sync debug mode reports them. The known one per window
    (the wave count) must show, or the count is not to be trusted."""
    from repro_torch.core import ProtocolConfig, run_engine
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    per_window = {}
    for name, model in models.items():
        state0 = model.init_state(prng.key(SEED + 1))
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_engine(model, state0, n_windows * WINDOW, seed=SEED,
                           config=cfg, engine=engine)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = len(sync_warnings(caught))
        if syncs < n_windows:
            fail(f"{engine} {name}: sync debug mode saw {syncs} syncs in "
                 f"{n_windows} windows, fewer than the wave counts read")
        per_window[name] = syncs / n_windows
    log(f"host syncs per window {engine} ({n_windows} windows): "
        + json.dumps(per_window))
    return per_window


# ----------------------------------------------------- wide footprints
def hub_graph_edges():
    """[E, 2] int64 edges of a graph built in numpy from the seed:
    preferential attachment over HUB_NODES nodes (each arrival links to
    HUB_M distinct nodes drawn from the repeated-nodes list, as in the
    Barabási–Albert model), plus hubs planted at nodes 0, 1, ... with
    HUB_DEGREES random neighbours each."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    targets, repeated, edges = list(range(HUB_M)), [], []
    for v in range(HUB_M, HUB_NODES):
        edges += [(v, t) for t in targets]
        repeated += targets + [v] * HUB_M
        chosen = set()
        while len(chosen) < HUB_M:
            chosen.add(repeated[rng.randint(len(repeated))])
        targets = sorted(chosen)
    for hub, degree in enumerate(HUB_DEGREES):
        edges += [(hub, int(u)) for u in
                  rng.choice(HUB_NODES, degree, replace=False)]
    return np.asarray(edges, dtype=np.int64)


def window_footprints(model, first=0):
    """(reads, writes), contiguous, of the window of WINDOW tasks that
    starts at task `first`, drawn from the seed."""
    from repro_torch.utils import prng

    recipes = model.create_tasks(prng.key(SEED), first, WINDOW)
    return tuple(x.contiguous() for x in model.task_footprint(recipes))


def bound_ms(nbytes, ops, ops_per_s=CUDA_CORE_OPS_PER_S):
    """(max(bytes / HBM rate, ops / ops_per_s) in ms, which bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def hub_topology(torch):
    """The hub graph on the card, and the seconds its build took."""
    from repro_torch.topology import from_edges

    t0 = time.perf_counter()
    edges = hub_graph_edges()
    topo = from_edges(HUB_NODES, edges, device=DEVICE)
    torch.cuda.synchronize()
    return topo, len(edges), time.perf_counter() - t0


def drive_hub_sis(torch):
    """SIS on the hub graph (a task reads 1 + max degree ids, 3,057
    slots): ``drive_wide_sis`` on it. Returns the launches."""
    topo, n_edges, build_s = hub_topology(torch)
    return drive_wide_sis(torch, "hub SIS", topo, n_edges, build_s)


def drive_wide_sis(torch, label, topo, n_edges, build_s):
    """SIS on a graph of wide rows through wavefront and wavefront_overlap
    at W = 4096 for CHECK_WINDOWS windows: launches counted, the final
    state against the oracle and a CPU run of the port (state and stats).
    Then both conflict kernels on a real window and boundary at that
    width: each equal to its plain version bit for bit under both hazard
    rules, timed beside its bound. Returns the launches."""
    from repro_torch.core import ProtocolConfig, run_engine, run_oracle
    from repro_torch.kernels.conflict import conflict as conflict_kernel
    from repro_torch.kernels.conflict.ops import (
        conflict_block,
        conflict_matrix,
    )
    from repro_torch.kernels.conflict.ops import work as conflict_cost
    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.mabs import SISModel
    from repro_torch.utils import prng
    from repro_torch.utils.timing import cuda_event_ms

    model = SISModel(topo)
    cpu_model = SISModel(topo.to("cpu"))
    state0 = model.init_state(prng.key(SEED + 1))
    cfg = ProtocolConfig(window=WINDOW)
    total = CHECK_WINDOWS * WINDOW
    oracle = run_oracle(model, state0, total, seed=SEED, config=cfg)
    launches = {"conflict": 0, "levels": 0, "conflict_block": 0}
    row = {"n_nodes": topo.n_nodes, "edges": n_edges,
           "max_degree": topo.max_degree, "read_slots": 1 + topo.max_degree,
           "window": WINDOW, "tasks": total, "build_seconds": build_s}
    for engine in ("wavefront", "wavefront_overlap"):
        conflict_kernel.launches = conflict_kernel.block_launches = 0
        levels_kernel.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, stats = run_engine(model, state0, total, seed=SEED, config=cfg,
                                engine=engine)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        nw = stats["n_windows"]
        n = {"conflict": conflict_kernel.launches,
             "levels": levels_kernel.launches,
             "conflict_block": conflict_kernel.block_launches}
        want = {"conflict": nw, "levels": nw,
                "conflict_block": nw - 1 if engine != "wavefront" else 0}
        if n != want:
            fail(f"{label} {engine}: launches {n}, expected {want}")
        for k, v in n.items():
            launches[k] += v
        if not states_equal(out, oracle):
            fail(f"{label} {engine} != sequential oracle on {total} tasks")
        cpu_out, cpu_stats = run_engine(
            cpu_model, {k: v.cpu() for k, v in state0.items()}, total,
            seed=SEED, config=cfg, engine=engine, device="cpu")
        if cpu_stats != stats or not states_equal(cpu_out, out):
            fail(f"{label} {engine}: GPU run != CPU run of the port: "
                 f"{stats} vs {cpu_stats}")
        row[engine] = {"ms_per_window": secs / nw * 1e3,
                       "total_waves": stats["total_waves"],
                       "launches": n}
    # both kernels on a real window and boundary at that width
    reads, writes = window_footprints(model)
    reads_n, writes_n = window_footprints(model, WINDOW)
    valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)
    for strict in (True, False):
        pairs = {
            "conflict": [conflict_matrix(reads, writes, valid, strict=strict,
                                         backend=b) for b in ("cuda", "torch")],
            "conflict_block": [conflict_block(
                reads_n, writes_n, reads, writes, valid, valid, strict=strict,
                backend=b) for b in ("cuda", "torch")]}
        for kname, (got, want) in pairs.items():
            if not torch.equal(got, want):
                fail(f"{label}: {kname} kernel != plain version on a real "
                     f"window (W={WINDOW}, nr={reads.shape[1]}, "
                     f"strict={strict}): {int((got != want).sum())} cells")
        row[f"parity_cells_hit_strict_{strict}"] = {
            k: int(v[1].sum()) for k, v in pairs.items()}
        del pairs
    row["conflict_ms"] = cuda_event_ms(lambda: conflict_matrix(
        reads, writes, valid, backend="cuda"))
    row["block_ms"] = cuda_event_ms(lambda: conflict_block(
        reads_n, writes_n, reads, writes, valid, valid, backend="cuda"))
    conf = conflict_matrix(reads, writes, valid)
    cross = conflict_block(reads_n, writes_n, reads, writes, valid, valid)
    row["conflict_bound_ms"], row["conflict_bound_by"] = bound_ms(
        *conflict_cost([(reads, writes, valid)], conf))
    row["block_bound_ms"], row["block_bound_by"] = bound_ms(*conflict_cost(
        [(reads_n, writes_n, valid), (reads, writes, valid)], cross))
    row["conflict_density"] = float(conf.sum()) / (WINDOW * (WINDOW - 1) / 2)
    del conf, cross
    row["used_read_slots_mean"] = float((reads >= 0).sum()) / WINDOW
    log(f"{label}: " + json.dumps(row))
    del topo, model, cpu_model, oracle
    torch.cuda.empty_cache()
    return launches


def drive_big_window(torch, models):
    """Windows past the old 8192 limit: voter through wavefront and
    wavefront_overlap at W = 16384 for two windows, against the oracle;
    the levels kernel launched once per window."""
    from repro_torch.core import ProtocolConfig, run_engine, run_oracle
    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.utils import prng

    w = 16384
    model = models["voter"]
    state0 = model.init_state(prng.key(SEED + 1))
    cfg = ProtocolConfig(window=w)
    oracle = run_oracle(model, state0, 2 * w, seed=SEED, config=cfg)
    row = {}
    for engine in ("wavefront", "wavefront_overlap"):
        levels_kernel.launches = 0
        out, stats = run_engine(model, state0, 2 * w, seed=SEED, config=cfg,
                                engine=engine)
        if levels_kernel.launches != stats["n_windows"]:
            fail(f"W={w} {engine}: {levels_kernel.launches} levels launches "
                 f"for {stats['n_windows']} windows")
        if not states_equal(out, oracle):
            fail(f"W={w} {engine} != sequential oracle on {2 * w} tasks")
        row[engine] = {"total_waves": stats["total_waves"],
                       "levels_passes": levels_kernel.last_run()[0]}
    log(f"window {w}: equals the oracle " + json.dumps(row))


# ------------------------------------------------------- the sharded phase
#: (a): tasks of each world-1 NCCL run; (b): windows of each four-rank run
SHARDED_TASKS = 1 << 18
SHARDED_RANKS = 4
SHARDED_RANK_WINDOWS = 8
SHARDED_RANK_TIMEOUT_S = 400
SHARDED_ENGINES = ("sharded", "sharded_window_halo", "sharded_replicated",
                   "sharded_overlap")
#: the stats that depend only on the schedule, equal across engines
SCHEDULE_KEYS = ("total_tasks", "n_windows", "total_waves",
                 "mean_parallelism", "overlap", "n_boundaries",
                 "mean_overlap_depth", "max_overlap_depth",
                 "overlap_tasks_early", "carry_frontier_mean",
                 "carry_frontier_max")
LADDER_KEYS = ("comm_modes", "per_wave_comm_bytes", "window_halo_bytes",
               "full_state_bytes", "comm_reduction_vs_window_halo")


def drive_sharded_nccl(torch, models, total_tasks):
    """(a) World size 1 under NCCL: ``sharded`` and ``sharded_overlap`` on
    SIS and SIRS against ``wavefront`` / ``wavefront_overlap`` on the
    card (same seed and window): state, schedule stats, kernel launches,
    n_devices, the call sites' byte count; tasks/s of both; then the
    host syncs per window. Returns the summed launches."""
    import torch.distributed as dist

    from repro_torch.core import ProtocolConfig, run_engine
    from repro_torch.engine import make_engine
    from repro_torch.kernels.conflict import conflict as conflict_kernel
    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    launches = {"conflict": 0, "levels": 0, "conflict_block": 0,
                "axelrod_wave": 0, "sir_wave": 0}
    store = ROOT / "build" / "sharded_nccl_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        # the communicator is made at the first collective: not timed
        dist.all_reduce(torch.zeros(1, device=DEVICE))
        torch.cuda.synchronize()
        for name in ("sis", "sirs"):
            model = models[name]
            state0 = model.init_state(prng.key(SEED + 1))
            for engine, plain in (("sharded", "wavefront"),
                                  ("sharded_overlap", "wavefront_overlap")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                wf, wf_stats = run_engine(model, state0, total_tasks,
                                          seed=SEED, config=cfg,
                                          engine=plain)
                torch.cuda.synchronize()
                wf_s = time.perf_counter() - t0
                eng = make_engine(engine, model, window=WINDOW)
                if eng.agents.group is not dist.group.WORLD:
                    fail(f"{engine} {name}: the engine did not take the "
                         "default NCCL group")
                with counting_waves(model) as calls:
                    conflict_kernel.launches = 0
                    conflict_kernel.block_launches = 0
                    levels_kernel.launches = 0
                    for _, kernel in wave_kernels().values():
                        kernel.launches = 0
                    t0 = time.perf_counter()
                    out, stats = eng.run(state0, total_tasks, seed=SEED)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                nw = stats["n_windows"]
                n = {"conflict": conflict_kernel.launches,
                     "levels": levels_kernel.launches,
                     "conflict_block": conflict_kernel.block_launches}
                want = {"conflict": nw, "levels": nw, "conflict_block":
                        stats["n_boundaries"] if stats["overlap"] else 0}
                if n != want:
                    fail(f"{engine} {name}: launches {n}, expected {want}")
                n.update(check_wave_launches(f"{engine} {name}", name,
                                             calls[0]))
                for k, v in n.items():
                    launches[k] += v
                if not states_equal(out, wf):
                    fail(f"{engine} {name} != {plain} on the card")
                sched = {k: stats.get(k) for k in SCHEDULE_KEYS}
                if sched != {k: wf_stats.get(k) for k in SCHEDULE_KEYS}:
                    fail(f"{engine} {name}: schedule stats {stats} != "
                         f"{plain}'s {wf_stats}")
                if stats["n_devices"] != 1:
                    fail(f"{engine} {name}: n_devices {stats['n_devices']}")
                if eng.agents.comm_bytes != stats["comm_bytes_total"]:
                    fail(f"{engine} {name}: the call sites counted "
                         f"{eng.agents.comm_bytes} bytes, the stats say "
                         f"{stats['comm_bytes_total']}")
                row = {"tasks": total_tasks, "n_windows": nw,
                       "total_waves": stats["total_waves"],
                       "seconds": secs, "tasks_per_s": total_tasks / secs,
                       "wall_ms_per_window": secs / nw * 1e3,
                       f"{plain}_seconds": wf_s,
                       f"{plain}_tasks_per_s": total_tasks / wf_s,
                       f"{plain}_wall_ms_per_window": wf_s / nw * 1e3,
                       "collectives": eng.agents.collectives,
                       **{k: stats[k] for k in LADDER_KEYS}}
                log(f"sharded world 1 nccl {engine} {name}: "
                    + json.dumps(row))
        sync_models = {k: models[k] for k in ("sis", "sirs")}
        sharded_breakdown(torch, sync_models)
        count_syncs(torch, sync_models, "sharded")
        syncs = count_syncs(torch, sync_models, "sharded_overlap")
        worst = max(syncs.values())
        if worst > OVERLAP_SYNCS_MAX:
            fail(f"sharded_overlap syncs the host {worst} times per window, "
                 f"more than {OVERLAP_SYNCS_MAX}")
        checks = {}
        for name, model in sync_models.items():
            state0 = model.init_state(prng.key(SEED + 1))
            for engine in COST_ENGINES:
                eng = make_engine(engine, model, window=WINDOW)
                _, stats = eng.run(state0, CHECK_WINDOWS * WINDOW,
                                   seed=SEED)
                checks[f"{engine} {name}"] = cross_check(eng, state0,
                                                         stats)
        for what, chk in checks.items():
            if not chk["ok"]:
                fail(f"cost cross-check world 1 nccl {what}: {chk}")
        log("cost cross-check world 1 nccl (8 windows): "
            + json.dumps(checks))
    finally:
        dist.destroy_process_group()
    return launches


#: the barrier engines whose executor costs the cross-check reads
COST_ENGINES = ("sharded", "sharded_window_halo")


def cross_check(eng, state0, stats) -> dict:
    """Just after ``eng``'s run that gave ``stats``: the executed
    iteration counts, then ``compiled_costs`` (which re-prepares the
    state) and the reference's identity against ``comm_bytes_total``,
    exact."""
    from repro_torch.obs.costs import ledger_cross_check

    iters = eng.comm_iteration_counts(stats)
    costs = eng.compiled_costs(state0, seed=SEED)
    chk = ledger_cross_check(costs, iters, stats["comm_bytes_total"])
    return {"executors": sorted(costs), "iters": iters,
            "parsed_bytes": chk.parsed_bytes,
            "ledger_bytes": chk.ledger_bytes, "ratio": chk.ratio,
            "ok": chk.ok}


def sharded_breakdown(torch, models, n_windows: int = 16):
    """Host-clock split of 16 ``sharded`` windows per model at world size
    1, each step fenced by a synchronize before and after (so the sum
    exceeds an unfenced window): the schedule (creation, record check,
    levels, the row contracts), the split layout (``wave_halo_split``),
    the gathers (row gather, pack, owner mask and the collective:
    ``wave_halo_gather``), the scatters into the scratch
    (``halo_scatter``), the waves (``execute_wave``) and the rest (owner
    masks, block refresh and slice, the host copy)."""
    import repro_torch.engine.sharded as sharded_mod
    from repro_torch.engine import make_engine
    from repro_torch.utils import prng

    steps = dict.fromkeys(("schedule", "split", "gather", "scatter",
                           "execute_wave"), 0.0)
    calls = dict.fromkeys(steps, 0)

    def fenced(key, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            steps[key] += time.perf_counter() - t0
            calls[key] += 1
            return out
        return timed

    names = {"split": "wave_halo_split", "gather": "wave_halo_gather",
             "scatter": "halo_scatter"}
    saved = {k: getattr(sharded_mod, n) for k, n in names.items()}
    try:
        for k, n in names.items():
            setattr(sharded_mod, n, fenced(k, saved[k]))
        for name, model in models.items():
            eng = make_engine("sharded", model, window=WINDOW)
            eng._schedule = fenced("schedule", eng._schedule)
            model.execute_wave = fenced("execute_wave", model.execute_wave)
            state0 = model.init_state(prng.key(SEED + 1))
            for k in steps:
                steps[k], calls[k] = 0.0, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                _, stats = eng.run(state0, n_windows * WINDOW, seed=SEED)
                torch.cuda.synchronize()
            finally:
                del model.execute_wave
            wall = time.perf_counter() - t0
            waves = stats["total_waves"]
            row = {f"{k}_ms": v / n_windows * 1e3 for k, v in steps.items()}
            row["rest_ms"] = (wall - sum(steps.values())) / n_windows * 1e3
            row["wall_ms"] = wall / n_windows * 1e3
            row["waves_per_window"] = waves / n_windows
            row["gather_ms_per_wave"] = steps["gather"] / waves * 1e3
            row["gathers"] = calls["gather"]
            row["scatters"] = calls["scatter"]
            log(f"sharded breakdown {name} W={WINDOW} (fenced, world 1 "
                "nccl): " + json.dumps(row))
    finally:
        for k, n in names.items():
            setattr(sharded_mod, n, saved[k])


def sharded_rank(rank, store, out_dir, tasks):
    """(b) One of SHARDED_RANKS gloo ranks on the one card (spawned by
    ``drive_sharded_ranks``): the four engines on voter, SIS, Axelrod
    F = 3 and SIRS s = 50 at n = 10^6, each against this rank's
    ``wavefront`` run on the card. Writes ``sharded_rank<r>.json``, or
    ``sharded_rank<r>.err`` and exits 1."""
    out_dir = Path(out_dir)
    try:
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(0)
        torch.set_num_threads(1)  # four ranks share the host's cores
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, SHARDED_RANKS), rank=rank,
            world_size=SHARDED_RANKS)
        try:
            res = _sharded_rank_runs(torch, tasks)
        finally:
            dist.destroy_process_group()
        (out_dir / f"sharded_rank{rank}.json").write_text(json.dumps(res))
    except BaseException:
        import traceback

        (out_dir / f"sharded_rank{rank}.err").write_text(
            traceback.format_exc())
        sys.exit(1)


def _sharded_rank_runs(torch, tasks):
    from repro_torch.core import ProtocolConfig, run_engine
    from repro_torch.engine import make_engine
    from repro_torch.mabs import (
        AxelrodConfig,
        AxelrodModel,
        SIRConfig,
        SIRModel,
        SISModel,
        VoterModel,
    )
    from repro_torch.topology import watts_strogatz
    from repro_torch.utils import prng

    topo = watts_strogatz(N_NODES, DEGREE, REWIRE, prng.key(SEED))
    models = {"voter": VoterModel(topo), "sis": SISModel(topo),
              "axelrod": AxelrodModel(AxelrodConfig(
                  n_agents=N_NODES, n_features=3, q=3, omega=0.95)),
              "sirs": SIRModel(SIRConfig(n_agents=N_NODES, k=14,
                                         subset_size=50))}
    res = {}
    for name, model in models.items():
        state0 = model.init_state(prng.key(SEED + 1))
        wf, _ = run_engine(model, state0, tasks, seed=SEED,
                           config=ProtocolConfig(window=WINDOW))
        res[name] = {}
        for engine in SHARDED_ENGINES:
            eng = make_engine(engine, model, window=WINDOW)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, stats = eng.run(state0, tasks, seed=SEED)
            torch.cuda.synchronize()
            res[name][engine] = {
                "stats": stats, "equal": states_equal(out, wf),
                "comm_bytes": eng.agents.comm_bytes,
                "collectives": eng.agents.collectives,
                "world_size": eng.agents.world_size,
                "seconds": time.perf_counter() - t0}
            if engine in COST_ENGINES:
                res[name][engine]["cross_check"] = cross_check(
                    eng, state0, stats)
    return res


def drive_sharded_ranks(torch, tasks):
    """(b) Four gloo ranks on the one card, carrying CUDA tensors (NCCL
    puts no two ranks on one GPU): every rank's state equals its
    ``wavefront`` run, the stats are equal across ranks, each rank's call
    sites count ``comm_bytes_total``; prints the comm ladder per model."""
    import torch.multiprocessing as mp

    out_dir = ROOT / "build" / "sharded_ranks"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, str(out_dir / "store"), str(out_dir),
                               tasks))
             for r in range(SHARDED_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for r, p in enumerate(procs):
            p.join(max(SHARDED_RANK_TIMEOUT_S - (time.perf_counter() - t0),
                       1))
            if p.is_alive():
                fail(f"sharded rank {r} did not finish in "
                     f"{SHARDED_RANK_TIMEOUT_S} s")
            if p.exitcode != 0:
                err = out_dir / f"sharded_rank{r}.err"
                fail(f"sharded rank {r} exited {p.exitcode}: "
                     + (err.read_text() if err.exists() else ""))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    ranks = [json.loads((out_dir / f"sharded_rank{r}.json").read_text())
             for r in range(SHARDED_RANKS)]
    for name, engines in ranks[0].items():
        ladder = {}
        for engine, res in engines.items():
            for r, rr in enumerate(ranks):
                got = rr[name][engine]
                what = f"{SHARDED_RANKS} ranks {engine} {name} rank {r}"
                if not got["equal"]:
                    fail(f"{what}: state != wavefront on the card")
                if got["stats"] != res["stats"]:
                    fail(f"{what}: stats {got['stats']} != rank 0's "
                         f"{res['stats']}")
                if got["world_size"] != SHARDED_RANKS or \
                        got["stats"]["n_devices"] != SHARDED_RANKS:
                    fail(f"{what}: world size {got['world_size']}")
                if got["comm_bytes"] != got["stats"]["comm_bytes_total"]:
                    fail(f"{what}: the call sites counted "
                         f"{got['comm_bytes']} bytes, the stats say "
                         f"{got['stats']['comm_bytes_total']}")
                chk = got.get("cross_check")
                if engine in COST_ENGINES and not (chk and chk["ok"]):
                    fail(f"{what}: cost cross-check {chk}")
            ladder[engine] = {
                **{k: res["stats"][k] for k in LADDER_KEYS},
                "total_waves": res["stats"]["total_waves"],
                "collectives": res["collectives"],
                "seconds": max(rr[name][engine]["seconds"] for rr in ranks)}
            if engine in COST_ENGINES:
                ladder[engine]["cross_check_ratio"] = [
                    rr[name][engine]["cross_check"]["ratio"]
                    for rr in ranks]
        log(f"sharded {SHARDED_RANKS} ranks gloo {name} ({tasks} tasks): "
            + json.dumps(ladder))


# ------------------------------------------- the generators and the DES
GEN_NODES = 1_000_000
GEN_M = 2
GEN_CHUNK = 4096
GEN_PARITY_NODES = 100_000
#: the reference's build rows at n = 10^6 in BENCH_topology.json, taken
#: under jax 0.4.37, whose random stream is not jax 0.9.0's (the port's):
#: printed beside the card's, never a gate
BENCH_TOPOLOGY_NOTE = {"barabasi_albert": {"n_edges": 1999997,
                                           "max_degree": 2357},
                       "erdos_renyi": {"n_edges": 1996103, "max_degree": 17}}
DES_TASKS = 2000
DES_WORKERS = (1, 4)
DES_AXELROD = {"n_agents": 10_000, "n_features": 500}
#: the attachment kernel's critical path, in seconds at the H100's
#: 1.98 GHz and ~4 cycles a dependent integer op: a Threefry hash's
#: latency (20 steps of 3 dependent ops, 5 injections of 2)
HASH_LATENCY_S = (20 * 3 + 5 * 2) * 4 / 1.98e9


def draws_latency_s(m):
    """One attachment thread's draws before its first lookup: the
    fold_in, m hashes along the key chain, the last round's two dependent
    pairs and its three remainders (~15 ops each)."""
    return (1 + m + 2) * HASH_LATENCY_S + 3 * 15 * 4 / 1.98e9


#: one dependent lookup: the owner's store reaching L2 and the waiter's
#: poll reading it back (~300 cycles each way)
LOOKUP_LATENCY_S = 2 * 300 / 1.98e9
#: the sleep (~0.1 s at 1.98 GHz) that the timed attachment launch is
#: enqueued behind: far above the host's dispatch of the build's ops
ATTACH_SLEEP_CYCLES = 200_000_000
#: timed builds of each attachment row (the median is its ms)
ATTACH_TIMED = 5
#: builds in the second profiled window of ``profile_attach``
ATTACH_PROFILED = 20
#: the H100 SXM's INT32 rate: 64 INT32 lanes an SM (NVIDIA's Hopper
#: white paper), 132 SMs, the 1.98 GHz boost clock — the attachment
#: kernel's hashes are adds, xors and shifts on those lanes
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def fenced_call(torch, fn):
    """(fn(), seconds), fenced by synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def attach_device_ms(torch, fn):
    """The device ms of each attachment kernel launch in one call of fn,
    in launch order: CUDA events around each launch of the wrapper, all
    enqueued behind a sleep on the card, so that no launch waits for the
    host's dispatch (fails unless the sleep outlasts the host's
    enqueueing)."""
    from repro_torch.kernels.attach import ops as attach_ops

    launch = attach_ops.attach_cuda
    pairs = []

    def timed(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    slept = torch.cuda.Event()
    torch.cuda.synchronize()
    attach_ops.attach_cuda = timed
    try:
        torch.cuda._sleep(ATTACH_SLEEP_CYCLES)
        slept.record()
        fn()
        behind = not slept.query()
    finally:
        attach_ops.attach_cuda = launch
    torch.cuda.synchronize()
    if not behind:
        fail("attachment timing: the host's dispatch outlasted the sleep")
    return [start.elapsed_time(end) for start, end in pairs]


def profile_attach(torch, event_ms=None):
    """Exact attachment builds at n = GEN_NODES under torch.profiler, one
    and then ATTACH_PROFILED in a window: how many device events and
    ``attach_kernel`` events it records and the kernel's device µs, beside
    the CUDA events' ms where given (printed, not a gate; phase 12 and
    ``--profile-attach``, which runs it alone in a fresh process)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.topology.generators import attachment
    from repro_torch.utils import prng

    key = prng.key(SEED)
    attachment(GEN_NODES, GEN_M, key, backend="cuda")
    row = {"cuda_event_ms": event_ms}
    for builds in (1, ATTACH_PROFILED):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(builds):
                attachment(GEN_NODES, GEN_M, key, backend="cuda")
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and not e.is_user_annotation]
        us = sorted(e.device_time for e in device
                    if "attach_kernel" in e.name)
        row[f"{builds} builds"] = {
            "device_events": len(device), "attach_kernel_events": len(us),
            "attach_kernel_us_min_median_max":
            [us[0], us[len(us) // 2], us[-1]] if us else None}
    log("attach under torch.profiler: " + json.dumps(row))


def drive_generators(torch):
    """Phase 12 (a)-(b): the generators on the card — erdos_renyi(10^6,
    4/10^6) with connect_isolated, barabasi_albert(10^6, 2) exact and
    chunked, the attachment kernel's launches counted (counters at 0
    just before each build, read just after) — against the CPU's builds
    (ER at 10^5 and 10^6, BA at 10^5) and the kernel against its plain
    version at 10^5 and 10^6, exact and chunked. Returns (the exact BA
    graph, its build row, the kernel's attach rows)."""
    from repro_torch.kernels.attach import attach as attach_kernel
    from repro_torch.kernels.attach import ref as attach_ref
    from repro_torch.kernels.attach.ops import work as attach_work
    from repro_torch.topology import (
        barabasi_albert,
        connect_isolated,
        erdos_renyi,
    )
    from repro_torch.topology.generators import attachment
    from repro_torch.utils import prng

    key = prng.key(SEED)
    k_er, k_iso = prng.split(key).unbind(0)

    def er(n, dev):
        return connect_isolated(erdos_renyi(n, 4 / n, k_er.to(dev),
                                            device=dev), k_iso.to(dev))

    builds, graphs = {}, {}
    # (a) the builds at 10^6, the main path of the phase
    topo, secs = fenced_call(torch, lambda: er(GEN_NODES, DEVICE))
    graphs["erdos_renyi"] = topo
    builds["erdos_renyi"] = {"seconds": secs, "edges": int(topo.n_edges),
                             "max_degree": topo.max_degree}
    for name, chunk in (("barabasi_albert", None),
                        ("barabasi_albert chunk=4096", GEN_CHUNK)):
        attach_kernel.launches = 0
        topo, secs = fenced_call(torch, lambda: barabasi_albert(
            GEN_NODES, GEN_M, key, chunk=chunk))
        n = attach_kernel.launches
        if n != 1:
            fail(f"{name}: {n} attachment launches, expected 1")
        graphs[name] = topo
        builds[name] = {"seconds": secs, "edges": int(topo.n_edges),
                        "max_degree": topo.max_degree, "launches": n}
    log(f"generators on the card, n = {GEN_NODES}: " + json.dumps(builds)
        + "; BENCH_topology.json (jax 0.4.37, CPU, another stream; a "
        "note, not a gate): " + json.dumps(BENCH_TOPOLOGY_NOTE))
    # (b) the kernel against its plain version, then the card's graphs
    # against the CPU's
    rows = []
    for n in (GEN_PARITY_NODES, GEN_NODES):
        for chunk in (None, GEN_CHUNK):
            (kernel, kernel_ends), wall_s = fenced_call(
                torch, lambda: attachment(n, GEN_M, key, chunk=chunk,
                                          backend="cuda"))
            before = attach_ref.rounds_drawn
            (plain, plain_ends), plain_s = fenced_call(
                torch, lambda: attachment(n, GEN_M, key, chunk=chunk,
                                          backend="torch"))
            rounds = attach_ref.rounds_drawn - before
            depth = attach_ref.chain_depth
            if not (torch.equal(kernel, plain)
                    and torch.equal(kernel_ends, plain_ends)):
                fail(f"attach kernel != plain version at n = {n}, chunk = "
                     f"{chunk}: {int((kernel != plain).sum())} targets")
            del plain, plain_ends
            if n != GEN_NODES:
                continue
            name = ("barabasi_albert" if chunk is None
                    else "barabasi_albert chunk=4096")
            each = sorted(attach_device_ms(torch, lambda: [attachment(
                n, GEN_M, key, chunk=chunk, backend="cuda")
                for _ in range(ATTACH_TIMED)]))
            if len(each) != ATTACH_TIMED:
                fail(f"{name}: {len(each)} attachment launches timed in "
                     f"{ATTACH_TIMED} builds")
            count = kernel.shape[0]
            # the key and the seed's ends read; every slab and target
            # written; the rounds this run's draws took
            nbytes, ops = attach_work(count, GEN_M, rounds)
            row = kernel_row(
                "attach" if chunk is None else "attach chunk=4096",
                "src/repro_torch/csrc/attach.cu",
                "src/repro/topology/generators.py:216",
                builds[name]["launches"], 0, each[len(each) // 2],
                plain_s * 1e3, nbytes, ops)
            # the design's own floor: the hashes (the row's bound) or the
            # critical path, whichever is longer
            path_ms = (draws_latency_s(GEN_M)
                       + depth * LOOKUP_LATENCY_S) * 1e3
            log(f"kernel times {row['name']} n={n}: " + json.dumps(
                {"ms": row["ms"], "ms_min_max": [each[0], each[-1]],
                 "launches": row["launches"],
                 "attachment_wall_ms": wall_s * 1e3,
                 "plain_ms": row["plain_ms"], "arrivals": count,
                 "rounds": rounds, "rounds_per_arrival": rounds / count,
                 "chain_depth": depth, "critical_path_model_ms": path_ms,
                 "bytes": nbytes, "ops": ops,
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "design_bound_ms": max(row["bound_ms"], path_ms),
                 "int32_rate_ms": ops / INT32_OPS_PER_S * 1e3}))
            if chunk is None:
                profile_attach(torch, row["ms"])
            rows.append(row)
        del kernel, kernel_ends
    torch.cuda.empty_cache()
    checked = {}
    for n in (GEN_PARITY_NODES, GEN_NODES):
        card = graphs["erdos_renyi"] if n == GEN_NODES else er(n, DEVICE)
        cpu = er(n, "cpu")
        if not (torch.equal(card.neighbors.cpu(), cpu.neighbors)
                and torch.equal(card.degrees.cpu(), cpu.degrees)):
            fail(f"erdos_renyi({n}) on the card != the CPU's build")
        checked[f"erdos_renyi {n}"] = cpu.max_degree
    for chunk in (None, GEN_CHUNK):
        card = barabasi_albert(GEN_PARITY_NODES, GEN_M, key, chunk=chunk)
        cpu = barabasi_albert(GEN_PARITY_NODES, GEN_M, key.cpu(),
                              chunk=chunk, device="cpu")
        if not (torch.equal(card.neighbors.cpu(), cpu.neighbors)
                and torch.equal(card.degrees.cpu(), cpu.degrees)):
            fail(f"barabasi_albert({GEN_PARITY_NODES}, chunk={chunk}) on "
                 "the card != the CPU's build")
        checked[f"barabasi_albert {GEN_PARITY_NODES} chunk={chunk}"] = (
            cpu.max_degree)
    log("generators: the card's graphs equal the CPU's (max degree): "
        + json.dumps(checked))
    ba = graphs.pop("barabasi_albert")
    del graphs
    torch.cuda.empty_cache()
    return ba, builds["barabasi_albert"], rows


def drive_des(torch):
    """Phase 12 (d): simulate_protocol on the des_model of Axelrod (n =
    10^4, F = 500, on a Watts–Strogatz graph built on the card) and of
    SIRS (n = 10^6 ring, k = 14, s = 50), DES_TASKS tasks at each
    n_workers of DES_WORKERS; every DESResult equal, field for field, to
    the one of the same model built on the CPU."""
    import dataclasses

    from repro_torch.core import ProtocolConfig, simulate_protocol
    from repro_torch.mabs import (
        AxelrodConfig,
        AxelrodModel,
        SIRConfig,
        SIRModel,
    )
    from repro_torch.topology import watts_strogatz
    from repro_torch.utils import prng

    key = prng.key(SEED)
    ax_cfg = AxelrodConfig(**DES_AXELROD)
    sir_cfg = SIRConfig(n_agents=N_NODES, k=14, subset_size=50)
    n = ax_cfg.n_agents
    models = {
        "axelrod": (
            AxelrodModel(ax_cfg, topology=watts_strogatz(
                n, DEGREE, REWIRE, key)),
            AxelrodModel(ax_cfg, topology=watts_strogatz(
                n, DEGREE, REWIRE, key.cpu(), device="cpu"))),
        "sirs": (SIRModel(sir_cfg), SIRModel(sir_cfg, device="cpu")),
    }
    rows = {}
    for name, (card, cpu) in models.items():
        for workers in DES_WORKERS:
            cfg = ProtocolConfig(n_workers=workers)
            t0 = time.perf_counter()
            got = simulate_protocol(card.des_model(), DES_TASKS, config=cfg)
            secs = time.perf_counter() - t0
            want = simulate_protocol(cpu.des_model(), DES_TASKS, config=cfg)
            if dataclasses.asdict(got) != dataclasses.asdict(want):
                fail(f"DES {name} n_workers={workers}: the card-built "
                     f"model's result != the CPU-built one's: {got} vs "
                     f"{want}")
            rows[f"{name} n_workers={workers}"] = {
                "makespan": got.makespan, "events": got.events,
                "max_chain_len": got.max_chain_len,
                "executed_per_worker": got.executed_per_worker,
                "host_seconds": secs}
    log(f"DES, {DES_TASKS} tasks, equal to the CPU-built models': "
        + json.dumps(rows))


# ----------------------------------------------------------- kernel times
def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes,
               ops, ops_per_s=CUDA_CORE_OPS_PER_S):
    """One entry of the kernels line: bound = max(bytes / HBM rate,
    ops / ``ops_per_s``, the CUDA-core rate unless given), in ms."""
    bound, by = bound_ms(nbytes, ops, ops_per_s)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def kernel_rows(torch, models, overlap_models, launches, errs):
    from repro_torch.kernels.conflict.ops import (
        conflict_block,
        conflict_matrix,
    )
    from repro_torch.kernels.conflict.ops import work as conflict_cost
    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.kernels.levels.ops import wave_levels
    from repro_torch.kernels.levels.ops import work as levels_work
    from repro_torch.utils.timing import cuda_event_ms

    rows = {}
    # the levels kernel on random windows of density 0.3 (thousands of
    # levels deep: the blocked sweep finishes them)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)
    dense = (torch.rand((WINDOW, WINDOW), generator=gen, device=DEVICE)
             < 0.3).tril(diagonal=-1)
    d_ms = cuda_event_ms(lambda: wave_levels(dense, valid, backend="cuda"))
    passes, swept = levels_kernel.last_run()
    log(f"kernel times levels density 0.3 W={WINDOW}: " + json.dumps(
        {"levels_ms": d_ms, "passes": passes, "swept": swept,
         "levels": int(wave_levels(dense, valid).max()) + 1}))
    del dense
    for name, model in models.items():
        reads, writes = window_footprints(model)
        valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)
        conf = conflict_matrix(reads, writes, valid)

        c_ms = cuda_event_ms(lambda: conflict_matrix(
            reads, writes, valid, backend="cuda"))
        c_plain = cuda_event_ms(lambda: conflict_matrix(
            reads, writes, valid, backend="torch"), reps=5)
        nr, nw = reads.shape[1], writes.shape[1]
        c_bytes, c_ops = conflict_cost([(reads, writes, valid)], conf)

        l_ms = cuda_event_ms(lambda: wave_levels(conf, valid,
                                                    backend="cuda"))
        l_passes, l_swept = levels_kernel.last_run()
        l_plain = cuda_event_ms(lambda: wave_levels(
            conf, valid, backend="torch"), reps=3)
        l_bytes = levels_work(WINDOW)[0]
        info = {
            "nr": nr, "nw": nw,
            "conflict_ms": c_ms, "conflict_plain_ms": c_plain,
            "conflict_bytes": c_bytes, "conflict_ops": c_ops,
            "conflict_density": float(conf.sum())
            / (WINDOW * (WINDOW - 1) / 2),
            "levels_ms": l_ms, "levels_plain_ms": l_plain,
            "levels_bytes": l_bytes, "levels_passes": l_passes,
            "levels_swept": l_swept,
            "waves": int(wave_levels(conf, valid).max()) + 1,
        }
        log(f"kernel times {name} W={WINDOW}: " + json.dumps(info))
        if name == "sis":  # the summary line holds the wider footprint
            rows["conflict"] = kernel_row(
                "conflict_matrix", "src/repro_torch/csrc/conflict.cu",
                "src/repro/kernels/conflict/conflict.py:150",
                launches["conflict"], errs["conflict"], c_ms, c_plain,
                c_bytes, c_ops)
            rows["levels"] = kernel_row(
                "wave_levels", "src/repro_torch/csrc/levels.cu",
                "src/repro/kernels/levels/levels.py:109",
                launches["levels"], errs["levels"], l_ms, l_plain, l_bytes,
                0.0)

    # the cross-window block on a real boundary: window 1's tasks against
    # window 0's, all alive (window 0 has not drained yet)
    for name, model in overlap_models.items():
        reads_j, writes_j = window_footprints(model)
        reads_i, writes_i = window_footprints(model, WINDOW)
        valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)
        lv_a = wave_levels(conflict_matrix(reads_j, writes_j, valid), valid)
        alive = lv_a >= 0
        args = (reads_i, writes_i, reads_j, writes_j, valid, alive)
        cross = conflict_block(*args)
        b_ms = cuda_event_ms(lambda: conflict_block(*args,
                                                       backend="cuda"))
        b_plain = cuda_event_ms(lambda: conflict_block(
            *args, backend="torch"), reps=5)
        nr_i, nw_i = reads_i.shape[1], writes_i.shape[1]
        nr_j, nw_j = reads_j.shape[1], writes_j.shape[1]
        b_bytes, b_ops = conflict_cost(
            [(reads_i, writes_i, valid), (reads_j, writes_j, alive)], cross)
        info = {"nr_i": nr_i, "nw_i": nw_i, "nr_j": nr_j, "nw_j": nw_j,
                "block_ms": b_ms, "block_plain_ms": b_plain,
                "block_bytes": b_bytes, "block_ops": b_ops,
                "block_density": float(cross.sum()) / (WINDOW * WINDOW)}
        log(f"kernel times block {name} W={WINDOW}: " + json.dumps(info))
        if name == "sis":
            rows["conflict_block"] = kernel_row(
                "conflict_block", "src/repro_torch/csrc/conflict.cu",
                "src/repro/kernels/conflict/conflict.py:219",
                launches["conflict_block"], errs["conflict_block"], b_ms,
                b_plain, b_bytes, b_ops)
    return [rows["conflict"], rows["levels"], rows["conflict_block"]]


def first_wave(torch, model, rec):
    """The mask of the first wave of window ``rec`` (W = WINDOW)."""
    from repro_torch.core.records import wave_levels, window_conflicts

    valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)
    return wave_levels(window_conflicts(model, rec, valid), valid) == 0


def sir_wave_case(torch, model, state=None):
    """The SIRS wave kernel's inputs on the first window of ``model``
    (state from the seed unless given) and its cost: (args, kwargs,
    bytes, ops, info). Bytes: the distinct halo states (1 byte), the
    uniforms (4 bytes per agent), the subset ids (4 per row), the next
    states (1); ops: a compare and an add per neighbour and agent."""
    from repro_torch.kernels.sir.ops import work as sir_work
    from repro_torch.utils import prng

    if state is None:
        state = model.init_state(prng.key(SEED + 1))
    rec = model.create_tasks(prng.key(SEED), 0, WINDOW)
    cfg = model.cfg
    s_sz, k = cfg.subset_size, model.topology.ring_k
    args = (state["states"], rec["subset"], model._draws(rec))
    kw = dict(n_agents=cfg.n_agents, k=k, subset_size=s_sz,
              p_si=cfg.p_si, p_ir=cfg.p_ir, p_rs=cfg.p_rs)
    nbytes, ops = sir_work(rec["subset"], n_agents=cfg.n_agents, k=k,
                           subset_size=s_sz)
    halo_bytes = nbytes - WINDOW * (5 * s_sz + 4)
    info = {"s": s_sz, "k": k, "halo_bytes": halo_bytes,
            "first_wave_tasks": int(first_wave(torch, model, rec).sum())}
    return args, kw, nbytes, ops, info


def wave_kernel_rows(torch, ov_models, wide, launches, errs):
    """The wave kernels on real windows of their models at W = 4096 —
    Axelrod at F = 3 and F = 500, SIRS at s = 50 and s = 1000: the
    window's first wave as the mask, the draws its recipes bind. The
    summary rows hold the widest tasks, and SIRS at s = 50 besides;
    ``launches`` maps each row to its phase's count (SIRS at s = 50: the
    overlap path and the sharded phase, the widest tasks: the task-size
    phase)."""
    from repro_torch.kernels.axelrod.ops import axelrod_wave
    from repro_torch.kernels.axelrod.ops import work as axelrod_work
    from repro_torch.kernels.sir.ops import sir_wave
    from repro_torch.utils import prng
    from repro_torch.utils.timing import cuda_event_ms

    cases = {"axelrod F=3": (ov_models["axelrod"], None),
             "sirs s=50": (ov_models["sirs"], None),
             **{k: v for k, v in wide.items()}}
    rows = {}
    for name, (model, state) in cases.items():
        if name.startswith("axelrod"):
            if state is None:
                state = model.init_state(prng.key(SEED + 1))
            rec = model.create_tasks(prng.key(SEED), 0, WINDOW)
            draws = model._draws(rec)
            mask = first_wave(torch, model, rec)
            f = model.cfg.n_features
            traits = state["traits"]
            args = (traits[rec["src"].long()], traits[rec["tgt"].long()],
                    *draws, mask)
            kw = {"omega": model.cfg.omega}
            fn, kname = axelrod_wave, "axelrod_wave"
            nbytes, ops = axelrod_work(WINDOW, f)
            extra = {"F": f, "first_wave_tasks": int(mask.sum())}
        else:
            args, kw, nbytes, ops, extra = sir_wave_case(torch, model,
                                                         state)
            fn, kname = sir_wave, "sir_wave"
        ms = cuda_event_ms(lambda: fn(*args, backend="cuda", **kw))
        plain = cuda_event_ms(lambda: fn(*args, backend="torch", **kw),
                              reps=5)
        key = "sir_wave s=50" if name == "sirs s=50" else kname
        row = kernel_row(key, f"src/repro_torch/csrc/"
                         f"{kname.split('_')[0]}.cu",
                         {"axelrod_wave":
                          "src/repro/kernels/axelrod/axelrod.py:70",
                          "sir_wave": "src/repro/kernels/sir/sir.py:71"
                          }[kname], launches[key], errs[kname], ms, plain,
                         nbytes, ops)
        log(f"kernel times {name} W={WINDOW}: " + json.dumps(
            {**extra, "ms": ms, "plain_ms": plain, "bytes": nbytes,
             "ops": ops, "bound_ms": row["bound_ms"]}))
        rows[key] = row  # the widest case comes last
    return [rows["axelrod_wave"], rows["sir_wave"], rows["sir_wave s=50"]]

# ------------------------------------------------------- the LM serving path
#: flash parity cases: (name, B, H, Hkv, T, S, D, causal, window)
FLASH_CASES = (
    ("sweep 1", 2, 4, 2, 128, 128, 64, True, None),
    ("sweep 2", 1, 8, 2, 128, 256, 64, True, None),
    ("sweep 3", 2, 4, 2, 256, 256, 64, True, 128),
    ("sweep 4", 1, 2, 1, 128, 128, 128, False, None),
    ("sweep 5", 1, 4, 4, 256, 256, 32, True, 64),
    ("smollm prefill", 1, 15, 5, 2048, 2048, 64, True, None),
    ("danube prefill", 1, 32, 8, 8192, 8192, 120, True, 4096),
    ("deepseek prefill", 1, 32, 32, 2048, 2048, 128, True, None),
    ("odd T", 1, 15, 5, 1001, 1001, 64, True, None),
    ("S > T", 1, 15, 5, 333, 2048, 64, True, None),
    ("S > T window", 1, 32, 8, 77, 5000, 120, True, 4096),
    ("decode", 8, 15, 5, 1, 1600, 64, True, None),
    # hymba-1.5b's one-shot prefill: 128 meta tokens + 2,048, 25 heads
    # over 5, its window-1024 and global layers
    ("hymba local", 1, 25, 5, 2176, 2176, 64, True, 1024),
    ("hymba global", 1, 25, 5, 2176, 2176, 64, True, None),
    # seamless-m4t's cross-attention (no mask, 16 heads): T below, and
    # above, S = 512 source frames (T > S without a mask)
    ("cross T=1", 1, 16, 16, 1, 512, 64, False, None),
    ("cross T=64", 1, 16, 16, 64, 512, 64, False, None),
    ("cross T=600", 1, 16, 16, 600, 512, 64, False, None),
)
#: std of the parity inputs: 0.3 (scores of std ~0.1, a flat softmax, as
#: the reference's sweep) and 1 (scores of std ~1, a peaked one)
FLASH_SCALES = (0.3, 1.0)
LM_ARCH = "smollm-360m"
#: the serving phase's depth: smollm-360m's 32 layers cut to 16 (the
#: cut order's third step, to keep the script within 900 s); its width,
#: and the training phase's depth, stay full
LM_SERVING_LAYERS = {LM_ARCH: 16}
LM_REQUESTS = 16
LM_PROMPT_LENS = (64, 1536)      # inclusive range of the prompt lengths
LM_MAX_NEW = 64
LM_SLOTS = 8
LM_MAX_LEN = 2048
LM_PREFILL_CHUNK = 128
#: a token that differs at a top-two margin at or below this is a float32
#: tie (at most one request may end in one)
TIE_MARGIN = 1e-4
#: the profiled sample: iterations [PROFILE_START, PROFILE_START + 10)
PROFILE_START = 40
PROFILE_ITERATIONS = 10
WARMUP_ITERATIONS = 20
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_TENSOR_OPS_PER_S = 989e12

# the RWKV6 serving phase: the same requests, slots, max_len and chunks,
# 16 new tokens (the cut order's second step; 32 before)
RWKV_ARCH = "rwkv6-3b"
RWKV_MAX_NEW = 16
#: the 16-token runs have 49 iterations: their profiled sample is
#: iterations [SHORT_PROFILE_START, SHORT_PROFILE_START + 10)
SHORT_PROFILE_START = 30
#: wkv6 parity cases: (name, B, H, T, D)
WKV6_CASES = (
    ("sweep 1", 1, 2, 128, 64),
    ("sweep 2", 2, 3, 256, 64),
    ("sweep 3", 1, 1, 64, 128),
    ("sweep 4", 1, 2, 32, 64),
    ("rwkv6-3b prefill", 1, 40, 2048, 64),
    ("ragged T=1", 1, 40, 1, 64),
    ("ragged T=37", 1, 40, 37, 64),
    ("ragged T=129", 1, 40, 129, 64),
    ("D=128", 1, 8, 256, 128),
    ("decode", 8, 40, 1, 64),
    # the redesigned kernel's edges: D padded to 32 (1, 33, 100) and at
    # its 128 limit; T at the short kernel's limit (8) and at +-1 of the
    # staged tile of 16 steps; B·H = 41 and 21 (odd row counts)
    ("D=1", 2, 3, 37, 1),
    ("D=33", 2, 3, 37, 33),
    ("D=100", 1, 4, 129, 100),
    ("D=128 decode", 8, 4, 1, 128),
    ("T=8", 1, 40, 8, 64),
    ("T=9", 1, 40, 9, 64),
    ("T=15", 1, 40, 15, 64),
    ("T=16", 1, 40, 16, 64),
    ("T=17", 1, 40, 17, 64),
    ("B·H=41", 1, 41, 33, 64),
    ("B·H=21", 3, 7, 3, 64),
)
#: in-place parity: (name, B, H, T, D), the state written into s0 itself
#: and into another tensor under a commit mask
WKV6_INPLACE_CASES = (
    ("decode wave", 8, 40, 1, 64),
    ("prefill chunk", 1, 40, 128, 64),
    ("chunk B=3", 3, 5, 17, 33),
    ("D=128", 2, 3, 9, 128),
)
#: std of r, k, v, u and a random s0; the decay logit log(-log w) is
#: N(-5, 0.5) (w near 1: long memory) or N(0, 1) (w spread over (0, 1))
WKV6_STD = 0.5
WKV6_DECAYS = {"near 1": (-5.0, 0.5), "spread": (0.0, 1.0)}
#: wkv6 tolerance: |kernel - plain| <= atol·max|plain| + rtol·|plain|,
#: the atol scaled by the case's largest output (float32 sums of D
#: products in another order; bf16 inputs are read as float32 by both).
#: Measured on an H100: at most 4.5e-7 x max|o| (22x room); the two
#: faulty recurrences are off by at least 6.8e-3 x max|o|
WKV6_ATOL, WKV6_RTOL = 1e-5, 1e-5
#: one-shot prefill at T = 2048, "pallas" against "chunked" (float32):
#: last-token logits and layer 0's state within this absolute error
#: (measured on an H100: 1.55e-5 and 5.7e-6, with |s| up to 10.6)
RWKV_PREFILL_TOL = 2e-4


def no_tf32(torch) -> None:
    """Full float32 products for the checks (hopper-kernels guide, §6)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def flash_inputs(torch, b, h, hkv, t, s, d, dtype, seed, scale=0.3):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [(torch.randn(sh, generator=gen, device=DEVICE) * scale).to(dtype)
            for sh in ((b, h, t, d), (b, hkv, s, d), (b, hkv, s, d))]


def check_flash_parity(torch) -> float:
    """The flash kernel against attention_ref on the card, float32 and
    bfloat16, at every FLASH_CASES shape and FLASH_SCALES input std.
    Tolerances: float32 atol 2e-5, rtol 1e-4 (the reference's flash
    sweep), atol 1e-4 from S = 2048 on (longer sums in another order);
    bfloat16 atol 2e-3, rtol 1e-2 (one bf16 rounding of the output is at
    most 2^-8 of it; the measured error is ~5e-4). On the peaked inputs
    the bfloat16 tolerance must reject uniform attention (q = 0), which
    shows that it would catch a kernel that mis-weights its keys.
    Returns the bfloat16 error at smollm's prefill shape on the flat
    inputs (the kernels line's)."""
    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.flash.ref import attention_ref

    no_tf32(torch)
    row_err = None
    for i, (name, b, h, hkv, t, s, d, causal, window) in enumerate(
            FLASH_CASES):
        for scale in FLASH_SCALES:
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = flash_inputs(torch, b, h, hkv, t, s, d, dtype, i,
                                       scale)
                got = flash_attention(q, k, v, causal=causal, window=window)
                want = attention_ref(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != want.shape:
                    fail(f"flash {name}: {got.dtype} {tuple(got.shape)}, "
                         f"expected {dtype} {tuple(want.shape)}")
                if dtype == torch.float32:
                    atol, rtol = (1e-4 if s >= 2048 else 2e-5), 1e-4
                else:
                    atol, rtol = 2e-3, 1e-2
                limit = atol + rtol * want.float().abs()
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                if not torch.isfinite(got.float()).all() or bool(
                        (diff > limit).any()):
                    fail(f"flash kernel != plain version at {name} "
                         f"(B={b} H={h} Hkv={hkv} T={t} S={s} D={d} "
                         f"causal={causal} window={window} std={scale}) "
                         f"{dtype}: max abs err {err}")
                errs[str(dtype).split(".")[-1]] = err
                if scale == 1.0 and dtype == torch.bfloat16:
                    flat = attention_ref(torch.zeros_like(q), k, v,
                                         causal=causal, window=window)
                    off = (flat.float() - want.float()).abs()
                    if not bool((off > limit).any()):
                        fail(f"flash {name}: the bfloat16 tolerance "
                             f"accepts uniform attention (max abs err "
                             f"{float(off.max())})")
                    errs["uniform_bfloat16"] = float(off.max())
                    del flat, off
                if (name == "smollm prefill" and scale == FLASH_SCALES[0]
                        and dtype == torch.bfloat16):
                    row_err = err
                del q, k, v, got, want, diff, limit
            log(f"parity flash {name} (B={b} H={h} Hkv={hkv} T={t} S={s} "
                f"D={d} causal={causal} window={window} std={scale}): max "
                f"abs err " + json.dumps(errs))
    torch.cuda.empty_cache()
    log(f"parity flash: {2 * len(FLASH_SCALES) * len(FLASH_CASES)} cases "
        f"within tolerance")
    return row_err


def wkv6_inputs(torch, b, h, t, d, dtype, seed, decay, s0):
    """r, k, v, w [B, H, T, D] in ``dtype``, u [H, D] float32 and s0 (a
    random [B, H, D, D] float32 state, or None), on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def f(*sh):
        return torch.randn(sh, generator=gen, device=DEVICE)

    mean, std = WKV6_DECAYS[decay]
    r, k, v = (f(b, h, t, d) * WKV6_STD for _ in range(3))
    w = torch.exp(-torch.exp(f(b, h, t, d) * std + mean))
    u = f(h, d) * WKV6_STD
    state = f(b, h, d, d) * WKV6_STD if s0 else None
    return [x.to(dtype) for x in (r, k, v, w)] + [u], state


def wkv6_wrong(torch, r, k, v, w, u, s0, *, drop_u=False,
               decay_first=False):
    """The recurrence with one fault, in float32: no ``u`` bonus, or the
    decay applied to S before the read instead of after."""
    b, h, t, d = r.shape
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    s = (torch.zeros((b, h, d, d), device=DEVICE) if s0 is None
         else s0.clone())
    o = torch.empty((b, h, t, d), device=DEVICE)
    for i in range(t):
        rt, kt, vt, wt = (x[:, :, i] for x in (r, k, v, w))
        if decay_first:
            s = wt[..., None] * s
        bonus = 0.0 if drop_u else (rt * u * kt).sum(-1, keepdim=True)
        o[:, :, i] = torch.einsum("bhk,bhkd->bhd", rt, s) + bonus * vt
        if not decay_first:
            s = wt[..., None] * s
        s = s + kt[..., None] * vt[..., None, :]
    return o


def check_wkv6_parity(torch) -> float:
    """The wkv6 kernel against the plain recurrence (kernels/wkv6/ref.py)
    on the card, float32 and bfloat16 inputs, at every WKV6_CASES shape,
    with s0 = 0 (no state) and a random s0, decays near 1 and spread over
    (0, 1). Tolerance WKV6_ATOL / WKV6_RTOL on o and on the final state;
    it must reject two wrong recurrences on o (the state is the same for
    both): one without the u bonus, and one that decays S before the read
    (except at T = 1 from s0 = 0, where the two orders agree). Returns the
    bf16 error at rwkv6-3b's prefill shape, s0 = 0, spread decays."""
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    no_tf32(torch)
    row_err, cases = None, 0
    for i, (name, b, h, t, d) in enumerate(WKV6_CASES):
        for decay in WKV6_DECAYS:
            for s0 in (False, True):
                errs = {}
                for dtype in (torch.float32, torch.bfloat16):
                    args, state = wkv6_inputs(torch, b, h, t, d, dtype, i,
                                              decay, s0)
                    o, sf = wkv6(*args, s0=state)
                    want_o, want_s = wkv6_ref(*args, s0=state)
                    torch.cuda.synchronize()
                    if (o.shape != want_o.shape or sf.shape != want_s.shape
                            or o.dtype != torch.float32):
                        fail(f"wkv6 {name}: o {o.dtype} {tuple(o.shape)}, "
                             f"s {tuple(sf.shape)}")
                    key = str(dtype).split(".")[-1]
                    for what, got, want in (("o", o, want_o),
                                            ("s", sf, want_s)):
                        limit = (WKV6_ATOL * float(want.abs().max())
                                 + WKV6_RTOL * want.abs())
                        diff = (got - want).abs()
                        err = float(diff.max())
                        if not torch.isfinite(got).all() or bool(
                                (diff > limit).any()):
                            fail(f"wkv6 kernel != plain version at {name} "
                                 f"(B={b} H={h} T={t} D={d} decay={decay} "
                                 f"s0={s0}) {dtype} {what}: max abs err "
                                 f"{err} (max |plain| "
                                 f"{float(want.abs().max())})")
                        errs[f"{what}_{key}"] = err
                    errs[f"max_abs_o_{key}"] = float(want_o.abs().max())
                    limit = (WKV6_ATOL * float(want_o.abs().max())
                             + WKV6_RTOL * want_o.abs())
                    for fault in ("drop_u", "decay_first"):
                        if fault == "decay_first" and t == 1 and not s0:
                            continue
                        bad = wkv6_wrong(torch, *args, state,
                                         **{fault: True})
                        off = (bad - want_o).abs()
                        if not bool((off > limit).any()):
                            fail(f"wkv6 {name} ({decay}, s0={s0}, {dtype}):"
                                 f" the tolerance accepts a kernel with "
                                 f"{fault} (max abs err {float(off.max())})")
                        errs[f"{fault}_{key}"] = float(off.max())
                    if (name == "rwkv6-3b prefill" and decay == "spread"
                            and not s0 and dtype == torch.bfloat16):
                        row_err = max(errs["o_bfloat16"], errs["s_bfloat16"])
                    cases += 1
                    del args, state, o, sf, want_o, want_s
                log(f"parity wkv6 {name} (B={b} H={h} T={t} D={d} "
                    f"decay={decay} s0={'random' if s0 else 0}): "
                    + json.dumps(errs))
    torch.cuda.empty_cache()
    log(f"parity wkv6: {cases} cases within tolerance, both faults "
        f"rejected")
    return row_err


def check_wkv6_inplace(torch) -> float:
    """The kernel's in-place state contract on the card (the serving
    path's: ``s_out=s0`` with the wave's ``commit``): at every
    WKV6_INPLACE_CASES shape, float32 and bfloat16 inputs, with s0 as
    the output and with another output tensor, under a partial, a full
    and an empty mask and none — one launch per call, o and the committed
    rows' state within WKV6_ATOL / WKV6_RTOL of ``wkv6_ref``, every other
    row ``torch.equal`` to what the output held before. Returns the
    largest error."""
    from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    no_tf32(torch)
    worst, cases = 0.0, 0
    for i, (name, b, h, t, d) in enumerate(WKV6_INPLACE_CASES):
        masks = {"partial": torch.arange(b, device=DEVICE) % 2 == 0,
                 "all": torch.ones(b, dtype=torch.bool, device=DEVICE),
                 "none": torch.zeros(b, dtype=torch.bool, device=DEVICE),
                 "no mask": None}
        for dtype in (torch.float32, torch.bfloat16):
            for alias in (True, False):
                for mname, commit in masks.items():
                    args, state = wkv6_inputs(torch, b, h, t, d, dtype,
                                              50 + i, "spread", True)
                    want_o, want_s = wkv6_ref(*args, s0=state)
                    out = state if alias else torch.full_like(state, 7.0)
                    before = out.clone()
                    n0 = wkv6_kernel.launches
                    o, sf = wkv6(*args, s0=state, s_out=out, commit=commit)
                    torch.cuda.synchronize()
                    rows = (torch.ones(b, dtype=torch.bool, device=DEVICE)
                            if commit is None else commit)
                    where = (f"{name} (B={b} H={h} T={t} D={d}) {dtype} "
                             f"{'s_out=s0' if alias else 'other s_out'} "
                             f"{mname}")
                    if wkv6_kernel.launches != n0 + 1 or sf is not out:
                        fail(f"wkv6 in place {where}: "
                             f"{wkv6_kernel.launches - n0} launches, "
                             f"returned state is s_out: {sf is out}")
                    for what, got, want in (("o", o, want_o),
                                            ("s", out[rows], want_s[rows])):
                        if got.numel() == 0:
                            continue
                        limit = (WKV6_ATOL * float(want.abs().max())
                                 + WKV6_RTOL * want.abs())
                        diff = (got - want).abs()
                        if bool((diff > limit).any()):
                            fail(f"wkv6 in place {where} {what}: max abs "
                                 f"err {float(diff.max())}")
                        worst = max(worst, float(diff.max()))
                    if not torch.equal(out[~rows], before[~rows]):
                        fail(f"wkv6 in place {where}: uncommitted rows "
                             f"were written")
                    cases += 1
    log(f"parity wkv6 in place: {cases} cases, committed rows within "
        f"tolerance (max abs err {worst}), the others untouched")
    return worst


def lm_prompts(vocab):
    import numpy as np

    rng = np.random.RandomState(SEED)
    lo, hi = LM_PROMPT_LENS
    lens = rng.randint(lo, hi + 1, size=LM_REQUESTS)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lens]


def lm_model(torch, dtype: str, attn_impl: str = "chunked",
             arch: str = LM_ARCH):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).replace(param_dtype=dtype, attn_impl=attn_impl)
    if arch in LM_SERVING_LAYERS:
        cfg = cfg.replace(n_layers=LM_SERVING_LAYERS[arch])
    return build_model(cfg, DEVICE)


def run_engine_lm(torch, model, params, prompts, on_step=None,
                  max_new=LM_MAX_NEW):
    """The serving engine over every prompt; returns (engine, seconds:
    host clock around the run, ending in a synchronize)."""
    from repro_torch.serving import Request, ServingEngine

    eng = ServingEngine(model, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                        prefill_chunk=LM_PREFILL_CHUNK, device=DEVICE)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.step():
        if on_step is not None:
            on_step(eng, t0)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def sequential_lm(torch, model, params, prompt, max_new=LM_MAX_NEW):
    """Per-request decoding: one-shot prefill (through the model's
    attn_impl), then decode_step. Returns (tokens, top-two margins)."""
    states = model.init_states(1, LM_MAX_LEN)
    logits, states = model.prefill(
        params, {"tokens": torch.as_tensor(prompt, device=DEVICE)[None]},
        states)
    toks, margins = [], []
    for i in range(max_new):
        top = torch.topk(logits[0], 2).values
        host = torch.stack([logits[0].argmax().float(),
                            top[0] - top[1]]).cpu()
        toks.append(int(host[0]))
        margins.append(float(host[1]))
        if i + 1 < max_new:
            logits, states = model.decode_step(
                params, torch.tensor([[toks[-1]]], dtype=torch.int32,
                                     device=DEVICE), states)
    return toks, margins


def check_tokens(label, eng, seq, max_new) -> list:
    """The engine's tokens against sequential decoding under the tie rule:
    a token that differs at a top-two margin above TIE_MARGIN fails; at or
    below it the request is a float32 tie and its remaining tokens are
    not compared; more than one tie fails. Returns the tied requests."""
    by_rid = {r.rid: r for r in eng.finished}
    if sorted(by_rid) != list(range(len(seq))):
        fail(f"{label}: finished {sorted(by_rid)}")
    ties = []
    for rid, (toks, margins) in enumerate(seq):
        got = by_rid[rid].out_tokens
        if len(got) != max_new:
            fail(f"{label}: request {rid} made {len(got)} tokens")
        diff = next((i for i, (a, b) in enumerate(zip(got, toks))
                     if a != b), None)
        if diff is None:
            continue
        log(f"{label}: request {rid} differs from sequential decoding at "
            f"step {diff}: engine {got[diff]}, sequential {toks[diff]}, "
            f"top-two margin {margins[diff]}")
        if margins[diff] > TIE_MARGIN:
            fail(f"{label}: request {rid} differs at step {diff} at a "
                 f"top-two margin {margins[diff]} > {TIE_MARGIN}")
        ties.append(rid)
    if len(ties) > 1:
        fail(f"{label}: {len(ties)} float32 ties (requests {ties}); at "
             f"most one is allowed")
    return ties


def serving_checked(torch):
    """smollm-360m at full width (the depth cut to LM_SERVING_LAYERS),
    float32 weights, TF32 off: the engine's tokens against per-request
    sequential decoding whose one-shot prefill runs through the flash
    kernel, under one tie rule; levels
    launches counted over the engine's run, flash launches over the
    sequential decoding; then the one-shot prefill with "pallas" against
    "ref". Returns the launches."""
    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.kernels.levels import levels as levels_kernel

    no_tf32(torch)
    model = lm_model(torch, "float32")
    params = model.init(SEED, device=DEVICE)
    seq_model = lm_model(torch, "float32", "pallas")
    prompts = lm_prompts(model.cfg.vocab)

    levels_kernel.launches = 0
    eng, secs = run_engine_lm(torch, model, params, prompts)
    n_levels = levels_kernel.launches
    t0 = time.perf_counter()
    flash_kernel.launches = 0
    seq = [sequential_lm(torch, seq_model, params, p) for p in prompts]
    seq_s = time.perf_counter() - t0
    n_flash = flash_kernel.launches
    launches = {"flash_attention": n_flash, "wave_levels": n_levels}
    if n_flash != model.cfg.n_layers * LM_REQUESTS:
        fail(f"serving: {n_flash} flash launches, expected one per layer "
             f"and request ({model.cfg.n_layers * LM_REQUESTS})")
    if n_levels != eng.iterations or n_levels == 0:
        fail(f"serving: {n_levels} levels launches for {eng.iterations} "
             f"iterations")

    ties = check_tokens("serving", eng, seq, LM_MAX_NEW)

    # one-shot prefill: the flash kernel against the plain attention
    import numpy as np

    prompt = np.random.RandomState(SEED + 1).randint(
        0, model.cfg.vocab, size=LM_MAX_LEN).astype(np.int32)
    lp = {}
    for impl in ("pallas", "ref"):
        m = lm_model(torch, "float32", impl)
        logits, _ = m.prefill(params, {"tokens": torch.as_tensor(
            prompt, device=DEVICE)[None]}, m.init_states(1, LM_MAX_LEN))
        lp[impl] = logits.float()
    prefill_err = float((lp["pallas"] - lp["ref"]).abs().max())
    if not torch.isfinite(lp["pallas"]).all() or prefill_err > 1e-3:
        fail(f"one-shot prefill at T={LM_MAX_LEN}: pallas vs ref logits "
             f"differ by {prefill_err} (> 1e-3)")
    row = {"arch": LM_ARCH, "params": "float32", "requests": LM_REQUESTS,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "generated_tokens": sum(len(r.out_tokens) for r in eng.finished),
           "iterations": eng.iterations, "ties": ties,
           "engine_seconds": secs, "sequential_seconds": seq_s,
           "prefill_pallas_vs_ref_max_abs": prefill_err,
           "launches": launches, "stats": eng.run_stats()}
    log("serving checked: " + json.dumps(row))
    del params, lp
    torch.cuda.empty_cache()
    return launches


def rwkv_serving_checked(torch):
    """rwkv6-3b at full width, float32 weights, TF32 off, every time-mix
    through the wkv6 kernel (``attn_impl="pallas"``) in the engine and in
    the sequential decoding: the engine's tokens against sequential
    decoding under the tie rule; the wkv6 counter set to 0 just before
    each run and read just after — one launch per layer and prefill chunk
    or decode wave over the engine's run, per layer and token over the
    sequential decoding; then the one-shot prefill at T = 2048 through
    "pallas" against "chunked" (the plain chunked math on the card):
    last-token logits and layer 0's state. Returns the engine's launches
    (wkv6 and levels)."""
    import numpy as np

    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel

    no_tf32(torch)
    model = lm_model(torch, "float32", "pallas", RWKV_ARCH)
    params = model.init(SEED, device=DEVICE)
    prompts = lm_prompts(model.cfg.vocab)
    n_layers = model.cfg.n_layers

    waves = {"n": 0, "decode_tasks": 0}

    def count_waves(e, _t0):  # a step whose decode tasks grew ran a wave
        waves["n"] += e.decode_tasks > waves["decode_tasks"]
        waves["decode_tasks"] = e.decode_tasks

    wkv6_kernel.launches = 0
    levels_kernel.launches = 0
    eng, secs = run_engine_lm(torch, model, params, prompts, count_waves,
                              max_new=RWKV_MAX_NEW)
    n_engine, n_levels = wkv6_kernel.launches, levels_kernel.launches
    decode_waves = waves["n"]
    want = n_layers * (eng.prefill_tasks + decode_waves)
    if n_engine != want:
        fail(f"rwkv serving: {n_engine} wkv6 launches over the engine's run, "
             f"expected {n_layers} x ({eng.prefill_tasks} prefill chunks + "
             f"{decode_waves} decode waves) = {want}")
    if n_levels != eng.iterations or n_levels == 0:
        fail(f"rwkv serving: {n_levels} levels launches for "
             f"{eng.iterations} iterations")

    t0 = time.perf_counter()
    wkv6_kernel.launches = 0
    seq = [sequential_lm(torch, model, params, p, RWKV_MAX_NEW)
           for p in prompts]
    seq_s = time.perf_counter() - t0
    n_seq = wkv6_kernel.launches
    if n_seq != n_layers * LM_REQUESTS * RWKV_MAX_NEW:
        fail(f"rwkv serving: {n_seq} wkv6 launches over the sequential "
             f"decoding, expected {n_layers} x {LM_REQUESTS} x "
             f"{RWKV_MAX_NEW}")
    ties = check_tokens("rwkv serving", eng, seq, RWKV_MAX_NEW)

    prompt = torch.as_tensor(np.random.RandomState(SEED + 1).randint(
        0, model.cfg.vocab, size=LM_MAX_LEN).astype(np.int32),
        device=DEVICE)[None]
    out = {}
    for impl in ("pallas", "chunked"):
        m = lm_model(torch, "float32", impl, RWKV_ARCH)
        logits, st = m.prefill(params, {"tokens": prompt},
                               m.init_states(1, LM_MAX_LEN))
        out[impl] = (logits.float(), st["segs"][0]["tm"]["s"][0].clone())
        del st
    err_logits = float((out["pallas"][0] - out["chunked"][0]).abs().max())
    err_s = float((out["pallas"][1] - out["chunked"][1]).abs().max())
    if (not torch.isfinite(out["pallas"][0]).all()
            or max(err_logits, err_s) > RWKV_PREFILL_TOL):
        fail(f"rwkv one-shot prefill at T={LM_MAX_LEN}: pallas vs chunked "
             f"logits differ by {err_logits}, layer-0 s by {err_s} "
             f"(> {RWKV_PREFILL_TOL})")
    row = {"arch": RWKV_ARCH, "params": "float32", "attn_impl": "pallas",
           "requests": LM_REQUESTS, "max_new_tokens": RWKV_MAX_NEW,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "generated_tokens": sum(len(r.out_tokens) for r in eng.finished),
           "iterations": eng.iterations, "prefill_chunks": eng.prefill_tasks,
           "decode_waves": decode_waves, "ties": ties,
           "engine_seconds": secs, "sequential_seconds": seq_s,
           "prefill_pallas_vs_chunked_logits_max_abs": err_logits,
           "prefill_pallas_vs_chunked_s_max_abs": err_s,
           "max_abs_s": float(out["chunked"][1].abs().max()),
           "launches": {"wkv6 engine": n_engine, "wkv6 sequential": n_seq,
                        "wave_levels": n_levels},
           "stats": eng.run_stats()}
    log("rwkv serving checked: " + json.dumps(row))
    del params, out, eng, model
    torch.cuda.empty_cache()
    return {"wkv6": n_engine, "wave_levels": n_levels}


def serving_timed(torch, arch=LM_ARCH, max_new=LM_MAX_NEW,
                  engine_impl="chunked", profile_start=PROFILE_START,
                  fenced_and_syncs=True, warmup=WARMUP_ITERATIONS):
    """bf16 weights, the same requests: tokens/s, iterations and mean
    wave; fenced ms per decode wave and per prefill chunk; the device's
    idle share over a sample of PROFILE_ITERATIONS iterations from
    ``profile_start``; host syncs per iteration; one-shot prefill ms at
    T = 2048 ("pallas" and "chunked"; the meta tokens in front where the
    model has them). The engine's model runs through ``engine_impl``.
    ``fenced_and_syncs=False`` skips the fenced run and the sync count,
    and ``warmup`` sets the warm-up's iterations (the families phase's
    budget). Returns the row."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.utils.timing import median_time

    model = lm_model(torch, "bfloat16", engine_impl, arch)
    params = model.init(SEED, device=DEVICE)
    prompts = lm_prompts(model.cfg.vocab)
    marks = {}

    def first_iterations(n):
        """A fresh engine over the requests, stepped n iterations."""
        e = ServingEngine(model, params, n_slots=LM_SLOTS,
                          max_len=LM_MAX_LEN, prefill_chunk=LM_PREFILL_CHUNK,
                          device=DEVICE)
        for i, p in enumerate(prompts):
            e.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
        for _ in range(n):
            e.step()
        torch.cuda.synchronize()
        return e

    def mark(eng, t0):
        if eng.iterations in (profile_start,
                              profile_start + PROFILE_ITERATIONS):
            torch.cuda.synchronize()
            marks[eng.iterations] = time.perf_counter()

    phase_s = {}
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        t_phase = now

    first_iterations(warmup)                               # warm-up
    levels_kernel.launches = 0
    eng, secs = run_engine_lm(torch, model, params, prompts, mark, max_new)
    n_levels = levels_kernel.launches
    lap("throughput")
    if n_levels != eng.iterations or n_levels == 0:
        fail(f"serving timed {arch}: {n_levels} levels launches for "
             f"{eng.iterations} iterations")
    tokens = sum(len(r.out_tokens) for r in eng.finished)
    row = {"arch": arch, "params": "bfloat16", "attn_impl": engine_impl,
           "requests": LM_REQUESTS, "max_new_tokens": max_new,
           "generated_tokens": tokens, "seconds": secs,
           "tokens_per_s": tokens / secs, "iterations": eng.iterations,
           "levels_launches": n_levels,
           "mean_wave": sum(eng.wave_sizes) / len(eng.wave_sizes),
           "ms_per_iteration": secs / eng.iterations * 1e3}

    if eng.iterations < profile_start + PROFILE_ITERATIONS:
        fail(f"serving timed {arch}: {eng.iterations} iterations, the "
             f"profiled sample needs {profile_start + PROFILE_ITERATIONS}")
    if fenced_and_syncs:
        serving_fenced(torch, model, params, prompts, max_new, row)
    lap("fenced")

    # device busy / idle over iterations [profile_start, + 10): the same
    # iterations of the unprofiled throughput run give the wall time
    sample = first_iterations(profile_start)
    # device activity only: the kernels' times are what is read (the wall
    # comes from the unprofiled run), and the host's op events would cost
    # the profiler more than the sample itself
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_ITERATIONS):
            sample.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")
               and not e.is_user_annotation]
    if not kernels:
        fail("serving: the profiler saw no device time")
    if {e.name for e in kernels if e.name.startswith("protocol.")}:
        fail("serving: profiler ranges counted as kernels")
    us = Counter()
    for e in kernels:
        us[e.name] += e.device_time
    busy_s = sum(us.values()) / 1e6
    wall_s = marks[profile_start + PROFILE_ITERATIONS] - marks[profile_start]
    row["profiled_iterations"] = [profile_start,
                                  profile_start + PROFILE_ITERATIONS]
    row["device_busy_ms"] = busy_s * 1e3
    row["wall_ms"] = wall_s * 1e3
    row["idle_share"] = 1.0 - busy_s / wall_s
    row["kernels_per_iteration"] = len(kernels) / PROFILE_ITERATIONS
    row["top"] = [[k[:60], t / 1e3] for k, t in us.most_common(5)]
    lap("profile")

    # host syncs per iteration, over the first profile_start iterations
    if fenced_and_syncs:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                first_iterations(profile_start)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = len(sync_warnings(caught))
        row["host_syncs_per_iteration"] = syncs / profile_start
    lap("syncs")

    # one-shot prefill at B = 1, T = 2048
    import numpy as np

    prompt = torch.as_tensor(np.random.RandomState(SEED + 1).randint(
        0, model.cfg.vocab, size=LM_MAX_LEN).astype(np.int32),
        device=DEVICE)[None]
    max_len = LM_MAX_LEN + model.cfg.n_prefix_tokens
    for impl in ("pallas", "chunked"):
        m = lm_model(torch, "bfloat16", impl, arch)
        row[f"prefill_{impl}_ms"] = median_time(
            lambda: m.prefill(params, {"tokens": prompt},
                              m.init_states(1, max_len))[0],
            repeats=5) * 1e3
    lap("prefill")
    row["phase_seconds"] = phase_s
    log(f"serving timed {arch}: " + json.dumps(row))
    del params
    torch.cuda.empty_cache()
    return row


def serving_fenced(torch, model, params, prompts, max_new, row) -> None:
    """Fenced ms per decode wave and per prefill chunk over one more run
    of the engine, into ``row``."""
    from repro_torch.serving import ServingEngine

    fenced = {"_exec_prefill": [], "_exec_decode_wave": []}
    originals = {k: getattr(ServingEngine, k) for k in fenced}

    def wrap(name):
        def timed(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](self, *args)
            torch.cuda.synchronize()
            fenced[name].append(time.perf_counter() - t0)
            return out
        return timed

    for k in fenced:
        setattr(ServingEngine, k, wrap(k))
    try:
        run_engine_lm(torch, model, params, prompts, max_new=max_new)
    finally:
        for k, fn in originals.items():
            setattr(ServingEngine, k, fn)
    row["decode_wave_ms"] = (sum(fenced["_exec_decode_wave"])
                             / len(fenced["_exec_decode_wave"]) * 1e3)
    row["prefill_chunk_ms"] = (sum(fenced["_exec_prefill"])
                               / len(fenced["_exec_prefill"]) * 1e3)
    row["decode_waves"] = len(fenced["_exec_decode_wave"])
    row["prefill_chunks"] = len(fenced["_exec_prefill"])


def flash_row(torch, launches, err):
    """The flash kernel at smollm-360m's prefill shape in bf16 (B = 1,
    H 15, Hkv 5, D 64, T = S = 2048, causal): kernel, plain version and
    SDPA (the library yardstick, used nowhere in the port)."""
    from torch.nn.functional import scaled_dot_product_attention

    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.flash.ops import work as flash_work
    from repro_torch.kernels.flash.ref import attention_ref
    from repro_torch.utils.timing import cuda_event_ms

    b, h, hkv, t, s, d = 1, 15, 5, 2048, 2048, 64
    q, k, v = flash_inputs(torch, b, h, hkv, t, s, d, torch.bfloat16, 99)
    ms = cuda_event_ms(lambda: flash_attention(q, k, v, causal=True))
    plain = cuda_event_ms(lambda: attention_ref(q, k, v, causal=True),
                          reps=5)
    lib = cuda_event_ms(lambda: scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    # the float32 kernel (CUDA cores) at the same shape
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32 = {"ms": cuda_event_ms(lambda: flash_attention(q32, k32, v32,
                                                       causal=True)),
           "plain_ms": cuda_event_ms(lambda: attention_ref(
               q32, k32, v32, causal=True), reps=5),
           "library_ms": cuda_event_ms(lambda: scaled_dot_product_attention(
               q32, k32, v32, is_causal=True, enable_gqa=True))}
    del q32, k32, v32
    nbytes, flops = flash_work(b, h, hkv, t, s, d, causal=True)
    row = kernel_row("flash_attention", "src/repro_torch/csrc/flash.cu",
                     "src/repro/kernels/flash/flash.py:127", launches, err,
                     ms, plain, nbytes, flops,
                     ops_per_s=BF16_TENSOR_OPS_PER_S)
    row["library_ms"] = lib
    log("kernel times flash smollm prefill bf16: " + json.dumps(
        {"ms": ms, "plain_ms": plain,
         "library_ms": lib, "bytes": nbytes, "flops": flops,
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}))
    log("kernel times flash smollm prefill float32: " + json.dumps(f32))
    return row


def wkv6_row(torch, launches, err):
    """The wkv6 kernel at rwkv6-3b's prefill shape (B = 1, H 40, T = 2048,
    D 64, bf16 inputs, s0 = 0): kernel and plain version; no single
    PyTorch call computes the recurrence, so no library time. The bound's
    operations (5·D² + 5·D per step and head: r·S, the decay and the outer
    product of the update, the bonus) are float32 CUDA-core work."""
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ops import work as wkv6_cost
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.utils.timing import cuda_event_ms

    b, h, t, d = 1, 40, 2048, 64
    args, _ = wkv6_inputs(torch, b, h, t, d, torch.bfloat16, 99, "spread",
                          False)
    ms = cuda_event_ms(lambda: wkv6(*args))
    plain = cuda_event_ms(lambda: wkv6_ref(*args), reps=5)
    nbytes, ops = wkv6_cost(b, h, t, d, False)
    row = kernel_row("wkv6", "src/repro_torch/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6/wkv6.py:133", launches, err,
                     ms, plain, nbytes, ops)
    log("kernel times wkv6 rwkv6-3b prefill bf16: " + json.dumps(
        {"ms": ms, "plain_ms": plain, "library_ms": None, "bytes": nbytes,
         "ops": ops, "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"]}))
    # the engine's own shapes: a prefill chunk and a decode wave, with a
    # carried state
    for name, (b, h, t, d) in (("prefill chunk", (1, 40, LM_PREFILL_CHUNK,
                                                  64)),
                               ("decode wave", (LM_SLOTS, 40, 1, 64))):
        args, state = wkv6_inputs(torch, b, h, t, d, torch.bfloat16, 98,
                                  "spread", True)
        shape_ms = cuda_event_ms(lambda: wkv6(*args, s0=state))
        nbytes, ops = wkv6_cost(b, h, t, d, True)
        shape_row = kernel_row("wkv6", "", "", 0, 0.0, shape_ms, None,
                               nbytes, ops)
        log(f"kernel times wkv6 rwkv6-3b {name} bf16 (B={b} T={t}): "
            + json.dumps({"ms": shape_ms, "bytes": nbytes, "ops": ops,
                          "bound_ms": shape_row["bound_ms"],
                          "bound_by": shape_row["bound_by"]}))
    return row


def drive_lm(torch) -> tuple[dict, dict]:
    """The serving path's phases, smollm-360m then rwkv6-3b; returns the
    kernel launches of each."""
    t0 = time.perf_counter()
    launches = serving_checked(torch)
    log(f"serving checked: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving_timed(torch)
    log(f"serving timed: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rwkv_launches = rwkv_serving_checked(torch)
    log(f"rwkv serving checked: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving_timed(torch, RWKV_ARCH, RWKV_MAX_NEW, "pallas",
                  SHORT_PROFILE_START)
    log(f"rwkv serving timed: {time.perf_counter() - t0:.1f} s")
    return launches, rwkv_launches


# ------------------------------------------------------ the training phase
#: the float32 checks: one step at B x T, peak lr with no warm-up. Adam's
#: first step moves each element by about lr (m / sqrt(v) = sign(g)), so a
#: gradient near zero whose sign the two sides round apart moves 2·lr
#: apart, and a bound on the parameters alone passes any two updates: the
#: moments and the share of elements whose updates differ carry the check
TRAIN_CHECK_BATCH = (2, 128)
TRAIN_CHECK_LR = 1e-5
RWKV_CHECK_LAYERS = 2
#: card against the host's CPU, float32, TF32 off: loss and grad_norm
#: relative; mu and nu per leaf within TRAIN_MOMENT_TOL x the leaf's
#: largest |value|; params within 2·lr, and at most TRAIN_FLIP_SHARE of
#: the elements with updates more than lr / 100 apart
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_MOMENT_TOL = 1e-3
TRAIN_FLIP_SHARE = 1e-3
#: microbatches=2 against 1 on the card: the reference test's loss bound
#: (tests/test_train_substrate.py); mu and the updates as above
MICRO_LOSS_RTOL = 1e-5
#: the timed runs (bf16 weights, remat on): B, T, warm-up, timed and
#: profiled steps (rwkv6-3b's step is ~61k kernels, and the profiler's
#: bookkeeping of three of them took most of a minute)
TRAIN_TIMED = {LM_ARCH: (8, 1024, 3, 5, 3), RWKV_ARCH: (4, 512, 2, 3, 1)}
TRAIN_SYNC_STEPS = 1


def train_cfg(arch: str, dtype: str, **changes):
    from repro_torch.configs import get_config

    return get_config(arch).replace(param_dtype=dtype, attn_impl="chunked",
                                    **changes)


def train_batches(torch, vocab, b, t, n, device=None):
    """n batches of the synthetic stream (seed SEED), on ``device``
    (default: DEVICE)."""
    from repro_torch.train.data import DataConfig, SyntheticLMStream
    from repro_torch.train.loop import batch_to_device

    stream = SyntheticLMStream(DataConfig(vocab=vocab, seq_len=t,
                                          global_batch=b, seed=SEED))
    return [batch_to_device(stream.batch_at(s), torch.device(device or DEVICE))
            for s in range(n)]


def lm_kernel_launches() -> dict:
    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel

    return {"flash_attention": flash_kernel.launches,
            "wkv6": wkv6_kernel.launches}


def zero_lm_kernel_launches() -> None:
    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel

    flash_kernel.launches = 0
    wkv6_kernel.launches = 0


def check_no_kernel(label: str) -> None:
    """The training path runs no hand-written kernel (the reference's
    trains through plain math; neither kernel has a backward)."""
    launches = lm_kernel_launches()
    if any(launches.values()):
        fail(f"{label}: the training path launched {launches}")


def train_refusal(torch) -> None:
    """``attn_impl="pallas"`` under grad raises on the card for both
    kernels, before launching either (reduced configs)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
    )

    for arch, kernel in ((LM_ARCH, "flash_attention"), (RWKV_ARCH, "wkv6")):
        cfg = get_config(arch).reduced().replace(attn_impl="pallas")
        model = build_model(cfg, DEVICE)
        state = init_train_state(model, SEED, device=DEVICE)
        batch = train_batches(torch, cfg.vocab, 2, 64, 1)[0]
        zero_lm_kernel_launches()
        try:
            make_train_step(model, TrainHParams())(state, batch)
        except RuntimeError as e:
            if f"{kernel} has no backward" not in str(e):
                raise
            log(f"training refusal {arch}: {e}")
        else:
            fail(f"training {arch} through attn_impl='pallas' did not "
                 f"raise")
        check_no_kernel(f"training refusal {arch}")


def rel_err(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def worst(a: float, b: float) -> float:
    """The larger of two errors; a NaN stays a NaN."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def step_gaps(torch, got, want, before, lr, parts=("mu", "nu")) -> dict:
    """How far the train state ``got`` lies from ``want``, both one float32
    step from the parameters ``before`` (full tensors or DTensors, on any
    device; compared on ``want``'s, ``before`` on ``got``'s): the
    moments ``parts``, per leaf, over the leaf's largest |value| in
    ``want``; the updates' largest gap; the share of updates more than
    lr / 100 apart; how many of ``got``'s parameters are not finite. A
    NaN in a gap stays a NaN."""
    from repro_torch.distributed.spmd import full_tensor

    moment, update, flips, n_el, bad = 0.0, 0.0, 0, 0, 0
    want_params = dict(want.params.named_parameters())
    for name, p in got.params.named_parameters():
        w = full_tensor(want_params[name]).detach()
        for part in parts:
            y = full_tensor(getattr(want.opt, part)[name])
            x = full_tensor(getattr(got.opt, part)[name]).to(y.device)
            moment = worst(moment, float((x - y).abs().max())
                           / float(y.abs().max().clamp(min=1e-30)))
        p = full_tensor(p).detach()
        gap = ((p - before[name]).to(w.device)
               - (w - before[name].to(w.device))).abs()
        update = worst(update, float(gap.max()))
        flips += int((~(gap <= lr / 100)).sum())
        n_el += p.numel()
        bad += int((~torch.isfinite(p)).sum())
    return {"moment_err_over_leaf_max": moment, "params_max_abs_err": update,
            "update_share_over_lr_100": flips / n_el,
            "params_not_finite": bad}


def step_within_bounds(row: dict, lr: float) -> bool:
    """The training phase's bounds on one float32 step against another
    (``rel_err`` of loss and grad norm, ``step_gaps``); a NaN fails."""
    return (row["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and row["grad_norm_rel_err"] <= TRAIN_GNORM_RTOL
            and row["moment_err_over_leaf_max"] <= TRAIN_MOMENT_TOL
            and row["params_max_abs_err"] <= 2 * lr * (1 + 1e-3)
            and row["update_share_over_lr_100"] <= TRAIN_FLIP_SHARE
            and row["params_not_finite"] == 0)


def train_checked(torch, arch, **changes) -> dict:
    """One float32 step (TF32 off) of ``arch`` at full width on the card
    and the same step on the host's CPU from the same parameters (drawn on
    the CPU, carried to the card through the bridge), B x T =
    TRAIN_CHECK_BATCH; then the step at microbatches=2 on the card against
    the one at 1. ``changes`` cut the config (rwkv6-3b's depth: the host's
    memory and time)."""
    from repro_torch import bridge
    from repro_torch.models import build_model
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
    )

    no_tf32(torch)
    cfg = train_cfg(arch, "float32", **changes)
    hp = dict(peak_lr=TRAIN_CHECK_LR, warmup_steps=0, total_steps=100)
    b, t = TRAIN_CHECK_BATCH
    t0 = time.perf_counter()
    cpu_model, card_model = build_model(cfg, "cpu"), build_model(cfg, DEVICE)
    cpu = init_train_state(cpu_model, SEED, device="cpu")
    card = bridge.train_state_from_numpy(card_model,
                                         bridge.train_state_to_numpy(cpu))
    card_mb2 = copy.deepcopy(card)
    before = {k: p.detach().clone() for k, p in cpu.params.named_parameters()}
    setup_s = time.perf_counter() - t0

    zero_lm_kernel_launches()
    batch = train_batches(torch, cfg.vocab, b, t, 1)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card, m_card = make_train_step(card_model, TrainHParams(**hp))(card,
                                                                   batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card_mb2, m_mb2 = make_train_step(card_model, TrainHParams(
        **hp, microbatches=2))(card_mb2, batch)
    check_no_kernel(f"training {arch} float32")
    t0 = time.perf_counter()
    cpu, m_cpu = make_train_step(cpu_model, TrainHParams(**hp))(
        cpu, train_batches(torch, cfg.vocab, b, t, 1, device="cpu")[0])
    cpu_s = time.perf_counter() - t0

    before = {k: v.to(DEVICE) for k, v in before.items()}
    card_gaps = step_gaps(torch, card, cpu, before, TRAIN_CHECK_LR)
    micro = step_gaps(torch, card_mb2, card, before, TRAIN_CHECK_LR,
                      parts=("mu",))
    row = {"arch": arch, "params": "float32", "layers": cfg.n_layers,
           "batch": [b, t], "lr": TRAIN_CHECK_LR,
           "loss_card": float(m_card["loss"]), "loss_cpu": float(m_cpu["loss"]),
           "grad_norm_card": float(m_card["grad_norm"]),
           "grad_norm_cpu": float(m_cpu["grad_norm"]),
           "loss_rel_err": rel_err(m_card["loss"], m_cpu["loss"]),
           "grad_norm_rel_err": rel_err(m_card["grad_norm"],
                                        m_cpu["grad_norm"]),
           **card_gaps,
           "microbatch2_loss_rel_err": rel_err(m_mb2["loss"], m_card["loss"]),
           **{"microbatch2_" + k: v for k, v in micro.items()},
           "card_step_s": card_s, "cpu_step_s": cpu_s, "setup_s": setup_s}
    log(f"training checked {arch}: " + json.dumps(row))
    if not step_within_bounds(row, TRAIN_CHECK_LR):
        fail(f"training {arch}: the card's float32 step differs from the "
             f"CPU's beyond the stated tolerances: {row}")
    if not (row["microbatch2_loss_rel_err"] <= MICRO_LOSS_RTOL
            and micro["moment_err_over_leaf_max"] <= TRAIN_MOMENT_TOL
            and micro["update_share_over_lr_100"] <= TRAIN_FLIP_SHARE
            and micro["params_not_finite"] == 0):
        fail(f"training {arch}: microbatches=2 differs from 1: {row}")
    del cpu, card, card_mb2, before
    torch.cuda.empty_cache()
    return row


def train_timed(torch, arch):
    """bf16 weights, remat on, at full width and depth: tokens/s and ms
    per step over the timed steps, peak device memory, host syncs inside
    ``step_fn`` (sync debug mode; must be 0), the device's idle share
    over the profiled steps (kernels only) against the timed steps' ms,
    and a finite loss at every step."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
    )
    from repro_torch.utils.pytree import tree_bytes, tree_param_count

    b, t, warmup, steps, profiled = TRAIN_TIMED[arch]
    cfg = train_cfg(arch, "bfloat16")
    model = build_model(cfg, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, SEED, device=DEVICE)
    step_fn = make_train_step(model, TrainHParams(warmup_steps=2,
                                                  total_steps=100))
    n = warmup + steps + TRAIN_SYNC_STEPS + profiled
    batches = iter(train_batches(torch, cfg.vocab, b, t, n))
    losses = []

    def run(k):
        nonlocal state
        for _ in range(k):
            state, metrics = step_fn(state, next(batches))
            losses.append(metrics["loss"])

    zero_lm_kernel_launches()
    t0 = time.perf_counter()
    run(warmup)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(TRAIN_SYNC_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sync_warnings(caught)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(profiled)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")
               and not e.is_user_annotation]
    if not kernels:
        fail(f"training {arch}: the profiler saw no device time")
    us = Counter()
    for e in kernels:
        us[e.name] += e.device_time
    busy_ms = sum(us.values()) / 1e3 / profiled
    check_no_kernel(f"training {arch} bf16")
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    ms = secs / steps * 1e3
    row = {"arch": arch, "params": "bfloat16", "layers": cfg.n_layers,
           "batch": [b, t], "remat": cfg.remat,
           "n_params": tree_param_count(state.params),
           "state_gb": tree_bytes(state) / 1e9,
           "warmup_steps": warmup, "warmup_s": warmup_s,
           "timed_steps": steps, "ms_per_step": ms,
           "tokens_per_s": steps * b * t / secs,
           "peak_memory_gb": peak / 1e9,
           "host_syncs_in_step_fn": len(syncs),
           "device_busy_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / ms,
           "profiled_steps": profiled,
           "kernels_per_step": len(kernels) / profiled,
           "top_ms_per_step": [[k[:60], t / 1e3 / profiled]
                               for k, t in us.most_common(8)],
           "losses": [float(x) for x in losses]}
    log(f"training timed {arch}: " + json.dumps(row))
    if syncs:
        fail(f"training {arch}: {len(syncs)} host syncs inside step_fn "
             f"over {TRAIN_SYNC_STEPS} steps, e.g. {syncs[:3]}")
    if not finite:
        fail(f"training {arch}: a loss is not finite: {row['losses']}")


def drive_training(torch) -> None:
    """The training phase: the refusal, smollm-360m checked at float32 and
    timed at bf16, then rwkv6-3b checked at float32 (RWKV_CHECK_LAYERS
    layers) and timed at bf16. (The checkpoint round trip is the lm
    sharded phase's elastic round trip.)"""
    t0 = time.perf_counter()
    train_refusal(torch)
    train_checked(torch, LM_ARCH)
    log(f"training checked {LM_ARCH}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_timed(torch, LM_ARCH)
    torch.cuda.empty_cache()
    log(f"training timed {LM_ARCH}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_checked(torch, RWKV_ARCH, n_layers=RWKV_CHECK_LAYERS)
    log(f"training checked {RWKV_ARCH}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_timed(torch, RWKV_ARCH)
    torch.cuda.empty_cache()
    log(f"training timed {RWKV_ARCH}: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------ the families phase
#: hymba-1.5b's serving cell: the serving phase's 16 requests (64-1,536
#: prompt tokens, 6 of them past the window of 1,024 with the 128 meta
#: tokens), 8 slots, max_len 2048, chunks of 128; 16 new tokens
HYMBA_ARCH = "hymba-1.5b"
HYMBA_MAX_NEW = 16
#: the float32 check takes the first 8 of the requests (4 past the
#: window; the cut order's fourth step), the bf16 timing all 16; the
#: timing's warm-up is 5 iterations
HYMBA_CHECK_REQUESTS = 8
HYMBA_WARMUP = 5
#: apply_train on the card against the host's CPU, float32, full width and
#: depth: one sequence of this many tokens (+ the 128 meta tokens)
HYMBA_CPU_TOKENS = 32
#: float32 logits tolerances (absolute; logits are O(1)): the card against
#: the host's CPU, and prefill + decode against the teacher-forced logits.
#: Each must reject its planted fault (logged beside).
HYMBA_CPU_TOL = 1e-3
FAMILY_TOL = 1e-3
#: the other families: the float32 check at B x T, the bf16 timing at
#: B x T prompt tokens (patches or source frames included) and decode steps
FAMILY_CHECK = (2, 16)
FAMILY_TIMED = (8, 512, 8)
#: depth (float32 check, bf16 timing): full width always; the depth cut
#: only where one card's 80 GB forces it — qwen3-moe's 94 layers are 9.7 GB
#: each in float32 (4.8 in bf16), internvl2's 80 are 3.4 GB (1.7), beside
#: 5.0 / 8.4 GB of embeddings in float32
FAMILY_LAYERS = {"qwen3-moe-235b-a22b": (6, 13),
                 "seamless-m4t-medium": (None, None),
                 "internvl2-76b": (18, 38)}


def family_cfg(arch, dtype, attn_impl="pallas", n_layers=None, **changes):
    """The config at full width in ``dtype`` through ``attn_impl``, its
    depth cut to ``n_layers`` when given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(param_dtype=dtype, attn_impl=attn_impl,
                                   **changes)
    return cfg if n_layers is None else cfg.replace(n_layers=n_layers)


def family_batch(torch, cfg, b, t, seed, dtype):
    """A prompt batch of ``t`` positions as ``input_specs`` lays out a
    prefill cell: the vision stub's patches take min(1024, t // 4) of
    them, the encoder-decoder gets ``t`` source frames beside ``t``
    tokens; embeddings of std 0.1 in ``dtype``."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    n_patch = min(1024, t // 4) if cfg.frontend == "vision_stub" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, t - n_patch),
                                     generator=gen, device=DEVICE,
                                     dtype=torch.int32)}
    if n_patch:
        batch["patch_embeds"] = (torch.randn(
            (b, n_patch, cfg.d_model), generator=gen, device=DEVICE)
            * 0.1).to(dtype)
    if cfg.is_encdec:
        batch["src_embeds"] = (torch.randn(
            (b, t, cfg.d_model), generator=gen, device=DEVICE) * 0.1).to(dtype)
    return batch


def attention_layers(cfg) -> int:
    """Flash launches of one forward through "pallas": one per attention
    layer (the encoder's too)."""
    return cfg.n_layers + cfg.enc_layers


def hymba_checked(torch) -> dict:
    """hymba-1.5b at full width and depth, float32, TF32 off: the engine's
    tokens (levels launches counted) against per-request sequential
    decoding whose one-shot prefill runs through flash (one launch per
    layer and request), under the tie rule; then apply_train's logits on
    the card (through flash) against the host CPU's, which must reject
    the SSM branch without its ``d_skip`` term. Returns the launches."""
    import numpy as np

    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.models import build_model

    no_tf32(torch)
    model = lm_model(torch, "float32", "chunked", HYMBA_ARCH)
    params = model.init(SEED, device=DEVICE)
    seq_model = lm_model(torch, "float32", "pallas", HYMBA_ARCH)
    cfg = model.cfg
    prompts = lm_prompts(cfg.vocab)[:HYMBA_CHECK_REQUESTS]
    past = sum(len(p) + cfg.n_prefix_tokens > cfg.sliding_window
               for p in prompts)

    levels_kernel.launches = 0
    eng, secs = run_engine_lm(torch, model, params, prompts,
                              max_new=HYMBA_MAX_NEW)
    n_levels = levels_kernel.launches
    t0 = time.perf_counter()
    flash_kernel.launches = 0
    seq = [sequential_lm(torch, seq_model, params, p, HYMBA_MAX_NEW)
           for p in prompts]
    seq_s = time.perf_counter() - t0
    n_flash = flash_kernel.launches
    if n_flash != cfg.n_layers * len(prompts):
        fail(f"hymba serving: {n_flash} flash launches, expected one per "
             f"layer and request ({cfg.n_layers * len(prompts)})")
    if n_levels != eng.iterations or n_levels == 0:
        fail(f"hymba serving: {n_levels} levels launches for "
             f"{eng.iterations} iterations")
    ties = check_tokens("hymba serving", eng, seq, HYMBA_MAX_NEW)

    # apply_train at full width: the card (flash) against the host's CPU
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (1, HYMBA_CPU_TOKENS), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    flash_kernel.launches = 0
    with torch.no_grad():
        card, _ = seq_model.apply_train(params, {"tokens": toks})
    if flash_kernel.launches != cfg.n_layers:
        fail(f"hymba apply_train: {flash_kernel.launches} flash launches, "
             f"expected {cfg.n_layers}")
    cpu_model = build_model(seq_model.cfg, "cpu")
    cpu_params = cpu_model.empty_params()
    cpu_params.load_state_dict(params.state_dict())
    del params
    torch.cuda.empty_cache()
    with torch.no_grad():
        host, _ = cpu_model.apply_train(cpu_params, {"tokens": toks.cpu()})
        cpu_err = float((card.cpu() - host).abs().max())
        for seg in cpu_params.segments:     # the planted fault
            for layer in seg:
                layer.hymba.ssm.d_skip.zero_()
        bad, _ = cpu_model.apply_train(cpu_params, {"tokens": toks.cpu()})
        fault_err = float((card.cpu() - bad).abs().max())
    if not torch.isfinite(card).all() or cpu_err > HYMBA_CPU_TOL:
        fail(f"hymba apply_train: the card's float32 logits differ from "
             f"the CPU's by {cpu_err} (> {HYMBA_CPU_TOL})")
    if fault_err <= HYMBA_CPU_TOL:
        fail(f"hymba apply_train: the tolerance {HYMBA_CPU_TOL} accepts "
             f"the SSM branch without d_skip ({fault_err})")
    row = {"arch": HYMBA_ARCH, "params": "float32", "requests": len(prompts),
           "prompts_past_window": past, "max_new_tokens": HYMBA_MAX_NEW,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "generated_tokens": sum(len(r.out_tokens) for r in eng.finished),
           "iterations": eng.iterations, "ties": ties,
           "ring_slots_window": int(eng.states["segs"][1]["kv"].k.shape[3]),
           "engine_seconds": secs, "sequential_seconds": seq_s,
           "apply_train_card_vs_cpu_max_abs": cpu_err,
           "apply_train_without_d_skip_max_abs": fault_err,
           "max_abs_logit": float(host.abs().max()),
           "launches": {"flash_attention": n_flash, "wave_levels": n_levels},
           "stats": eng.run_stats()}
    log("hymba checked: " + json.dumps(row))
    del cpu_params, cpu_model, model, seq_model, eng
    return {"flash_attention": n_flash + cfg.n_layers,
            "wave_levels": n_levels}


def encoder_checked(torch, params, src, cfg) -> tuple[dict, int]:
    """The encoder-decoder's encoder at full width, float32: ``run_encoder``
    on the card (flash in every encoder layer, no mask) against the host
    CPU's on the same weights and ``src`` frames, within FAMILY_TOL (the
    reference's plan gives the decoder no cross-attention, so no logit
    reads the encoder); a causal encoder and a zeroed ``enc_final_norm``
    on the CPU must fall outside it. Returns (row, flash launches)."""
    import copy
    from types import SimpleNamespace

    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import (
        Segment,
        run_encoder,
        run_segment,
    )

    flash_kernel.launches = 0
    with torch.no_grad():
        card = run_encoder(params, src, cfg).cpu()
    n_flash = flash_kernel.launches
    if n_flash != cfg.enc_layers:
        fail(f"encoder: {n_flash} flash launches, expected {cfg.enc_layers}")
    host = SimpleNamespace(
        enc_segments=copy.deepcopy(params.enc_segments).cpu(),
        enc_final_norm=copy.deepcopy(params.enc_final_norm).cpu())
    x = src.cpu()

    def causal(p):
        h = x
        pos = torch.arange(x.shape[1])
        for layers in p.enc_segments:
            h, _ = run_segment(Segment("attn", len(layers)), layers, h, cfg,
                               positions=pos, mode="train")
        return rmsnorm(p.enc_final_norm, h, cfg.norm_eps)

    with torch.no_grad():
        err = float((card - run_encoder(host, x, cfg)).abs().max())
        faults = {"causal encoder": causal(host)}
        host.enc_final_norm.scale.zero_()
        faults["enc_final_norm zeroed"] = run_encoder(host, x, cfg)
    if not torch.isfinite(card).all() or err > FAMILY_TOL:
        fail(f"encoder: the card's float32 output differs from the CPU's "
             f"by {err} (> {FAMILY_TOL})")
    fault_errs = {}
    for name, out in faults.items():
        fault_errs[name] = float((card - out).abs().max())
        if fault_errs[name] <= FAMILY_TOL:
            fail(f"encoder: the tolerance {FAMILY_TOL} accepts the "
                 f"{name} ({fault_errs[name]})")
    return {"src": list(src.shape), "card_vs_cpu_max_abs": err,
            "planted_faults_max_abs": fault_errs,
            "max_abs": float(card.abs().max()),
            "flash_launches": n_flash}, n_flash


def family_checked(torch, arch, n_layers) -> int:
    """Float32, TF32 off, through "pallas" (flash in every attention layer
    of the teacher-forced pass and the prefill), MoE at dropless capacity
    (8.0, as the reference's own check): the last-prompt-token logits of a
    prefill of T - 1 tokens and those of one decode step against the
    teacher-forced logits at those positions, within FAMILY_TOL; a decode
    with a planted fault must fall outside it. The encoder-decoder's
    encoder is held against the host CPU's (``encoder_checked``). Returns
    flash launches."""
    import dataclasses

    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.models import build_model

    no_tf32(torch)
    cfg = family_cfg(arch, "float32", n_layers=n_layers)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    model = build_model(cfg, DEVICE)
    params = model.init(SEED, device=DEVICE)
    b, t = FAMILY_CHECK
    batch = family_batch(torch, cfg, b, t, SEED + 3, torch.float32)
    toks = batch["tokens"]
    tn = toks.shape[1]
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    flash_kernel.launches = 0
    with torch.no_grad():
        lt, aux = model.apply_train(params, batch)
    n_train = flash_kernel.launches

    def prefill_decode(fault=None):
        st = model.init_states(b, t + 8)
        pre = {"tokens": toks[:, :tn - 1], **extra}
        if fault == "patches dropped":
            pre.pop("patch_embeds")
        lp, st = model.prefill(params, pre, st)
        if fault == "position off by one":
            with torch.inference_mode():   # the states are inference tensors
                st["pos"].add_(1)
        m, p_ = model, params
        if fault == "top-7 routing":
            m = build_model(cfg.replace(moe=dataclasses.replace(
                cfg.moe, top_k=cfg.moe.top_k - 1)), DEVICE)
        ld, _ = m.decode_step(p_, toks[:, tn - 1:], st)
        return lp, ld

    flash_kernel.launches = 0
    lp, ld = prefill_decode()
    n_prefill = flash_kernel.launches
    want = attention_layers(cfg)
    if n_train != want or n_prefill != want:
        fail(f"{arch} float32: flash launched {n_train} times in the "
             f"teacher-forced pass and {n_prefill} in prefill + decode, "
             f"expected {want} each")
    err = max(float((lp - lt[:, tn - 2]).abs().max()),
              float((ld - lt[:, tn - 1]).abs().max()))
    if not torch.isfinite(lt).all() or err > FAMILY_TOL:
        fail(f"{arch} float32: prefill/decode logits differ from the "
             f"teacher-forced ones by {err} (> {FAMILY_TOL})")
    faults = ["position off by one"]
    if cfg.moe is not None:
        faults.append("top-7 routing")
    if cfg.frontend == "vision_stub":
        faults.append("patches dropped")
    fault_errs = {}
    for fault in faults:
        flp, fld = prefill_decode(fault)
        fault_errs[fault] = max(float((flp - lt[:, tn - 2]).abs().max()),
                                float((fld - lt[:, tn - 1]).abs().max()))
        if fault_errs[fault] <= FAMILY_TOL:
            fail(f"{arch} float32: the tolerance {FAMILY_TOL} accepts a "
                 f"decode with {fault} ({fault_errs[fault]})")
    row = {"arch": arch, "params": "float32", "n_layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "batch": [b, t],
           "inputs": {k: list(v.shape) for k, v in batch.items()},
           "prefill_decode_vs_train_max_abs": err,
           "planted_faults_max_abs": fault_errs,
           "max_abs_logit": float(lt.abs().max()),
           "overflow_fraction": float(aux["overflow_fraction"]),
           "flash_launches": {"train": n_train, "prefill": n_prefill}}
    n_enc = 0
    if cfg.is_encdec:
        row["encoder"], n_enc = encoder_checked(torch, params,
                                                batch["src_embeds"], cfg)
    log(f"family checked {arch}: " + json.dumps(row))
    del params, model, lt
    torch.cuda.empty_cache()
    return n_train + n_prefill + n_enc


def family_timed(torch, arch, n_layers) -> int:
    """bf16 through "pallas": one-shot prefill ms (median of 3, after a
    warm-up) at FAMILY_TIMED's B x T, then ms per decode step over its
    steps after one more prefill (flash launches counted over all five);
    MoE's overflow fraction (mean over the layers) of the same batch in a
    train pass at the config's capacity. Returns flash launches."""
    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.models import build_model
    from repro_torch.models.transformer import forward_hidden
    from repro_torch.utils.timing import median_time

    cfg = family_cfg(arch, "bfloat16", n_layers=n_layers)
    model = build_model(cfg, DEVICE)
    params = model.init(SEED, device=DEVICE)
    b, t, steps = FAMILY_TIMED
    batch = family_batch(torch, cfg, b, t, SEED + 4, torch.bfloat16)
    max_len = t + steps + 8
    torch.cuda.reset_peak_memory_stats()
    flash_kernel.launches = 0
    prefill = median_time(lambda: model.prefill(
        params, batch, model.init_states(b, max_len))[0], repeats=3,
        warmup=1)
    st = model.init_states(b, max_len)
    logits, st = model.prefill(params, batch, st)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, st = model.decode_step(params, tok, st)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / steps * 1e3
    n_flash = flash_kernel.launches
    if n_flash != 5 * attention_layers(cfg):
        fail(f"{arch} bf16: {n_flash} flash launches over 5 prefills and "
             f"{steps} decode steps, expected {5 * attention_layers(cfg)}")
    if not torch.isfinite(logits).all():
        fail(f"{arch} bf16: non-finite decode logits")
    row = {"arch": arch, "params": "bfloat16", "n_layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "batch": [b, t],
           "inputs": {k: list(v.shape) for k, v in batch.items()},
           "prefill_ms": prefill * 1e3,
           "prefill_ms_samples": [x * 1e3 for x in prefill.samples],
           "prefill_tokens_per_s": b * t / prefill,
           "decode_steps": steps, "decode_ms_per_step": decode_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.moe is not None:
        with torch.no_grad():
            x, _ = model._embed_inputs(params, batch)
            _, _, aux = forward_hidden(
                params, x, cfg, positions=torch.arange(x.shape[1],
                                                       device=DEVICE))
        row["overflow_fraction"] = float(aux["overflow_fraction"]) \
            / cfg.n_layers
        row["capacity_factor"] = cfg.moe.capacity_factor
    log(f"family timed {arch}: " + json.dumps(row))
    del params, model, st
    torch.cuda.empty_cache()
    return n_flash


def drive_families(torch) -> dict:
    """The families phase: hymba-1.5b checked at float32 and timed at bf16
    through the serving engine (the slice's main path: flash in the
    one-shot prefill, the levels kernel in the scheduler), then the MoE,
    encoder-decoder and vision-stub families through prefill / decode /
    apply_train. Returns the launches of flash and levels."""
    t0 = time.perf_counter()
    launches = hymba_checked(torch)
    log(f"hymba checked: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    row = serving_timed(torch, HYMBA_ARCH, HYMBA_MAX_NEW, "chunked",
                        SHORT_PROFILE_START, fenced_and_syncs=False,
                        warmup=HYMBA_WARMUP)
    launches["wave_levels"] += row["levels_launches"]
    log(f"hymba timed: {time.perf_counter() - t0:.1f} s")
    for arch, (check_layers, timed_layers) in FAMILY_LAYERS.items():
        t0 = time.perf_counter()
        launches["flash_attention"] += family_checked(torch, arch,
                                                      check_layers)
        launches["flash_attention"] += family_timed(torch, arch,
                                                    timed_layers)
        log(f"family {arch}: {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------ the lm sharded phase
#: the phase's gloo ranks (reduced widths, the reference tests'
#: configurations) and their deadline
LM_SHARDED_RANKS = 4
LM_SHARDED_TIMEOUT_S = 300
#: world size 1: the sharded prefill's depth per arch (smollm at the
#: serving cut), its B x T, and the sharded decode steps after it
LM_SHARDED_PREFILL = {LM_ARCH: LM_SERVING_LAYERS[LM_ARCH], RWKV_ARCH: 32}
LM_SHARDED_PROMPT = (2, 512)
LM_SHARDED_DECODE = 8
#: sharded against unsharded at world size 1, float32: the same local
#: operations on the same shapes (a (1, 1) mesh shards nothing), so the
#: logits agree to float32 rounding; the bound leaves room for a reduction
#: order that differs
LM_SHARDED_LOGIT_TOL = 1e-4
#: the MoE at world size 1 (qwen3-moe, the families' float32 depth cut): the
#: capacity is the whole batch's and no sum crosses a rank, so the
#: expert-parallel layer computes the dense dispatch's operations:
#: loss and aux terms within float32 rounding
LM_SHARDED_MOE_RTOL = 1e-5
#: the bf16 step timed on the (1, 1) mesh: the training phase's timed shape
LM_SHARDED_TIMED = (8, 1024, 1, 3)
LM_SHARDED_CKPT_DIR = ROOT / "build" / "lm_sharded_ckpt"
#: steps ``train_loop`` takes after the elastic restore
LM_SHARDED_RESUMED = 2
#: the four ranks' contracts (the reference tests' bounds)
LM_STEP_RTOL = 2e-4
LM_MOE_STEP_RTOL = 3e-3
LM_BLOCK_ATOL = 1e-4
#: (arch, changes to .reduced()) of the reference tests' configurations
LM_RANK_CONFIGS = {
    "smollm": ("smollm-360m", dict(d_model=64, n_heads=4, n_kv_heads=2,
                                   d_ff=128, vocab=256, n_layers=2,
                                   param_dtype="float32")),
    "rwkv": ("rwkv6-3b", dict(d_model=64, n_layers=2, vocab=256, d_ff=128,
                              param_dtype="float32", head_dim=32,
                              n_heads=2, n_kv_heads=2)),
    "moe": ("qwen3-moe-235b-a22b", dict(param_dtype="float32")),
    "deepseek": ("deepseek-7b", dict(param_dtype="float32", n_heads=4,
                                     n_kv_heads=4)),
    "danube": ("h2o-danube-3-4b", dict(param_dtype="float32", n_heads=4,
                                       n_kv_heads=1, sliding_window=16)),
}


def lm_rank_cfg(key, **extra):
    import dataclasses

    from repro_torch.configs import get_config

    arch, changes = LM_RANK_CONFIGS[key]
    cfg = get_config(arch).reduced().replace(attn_impl="chunked", **changes)
    if key == "moe":
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=64, capacity_factor=8.0))
    return cfg.replace(**extra)


def placed_batch(batch, mesh, layout="tp"):
    from repro_torch.distributed.sharding import distribute
    from repro_torch.train.step import train_batch_shardings

    sh = train_batch_shardings(batch, mesh, layout=layout)
    return {k: distribute(v, sh[k]) for k, v in batch.items()}


def lm_train_losses(torch, key, mesh, steps, batch_size, save=None,
                    **extra):
    """Losses of ``steps`` train steps of the reduced config ``key`` from
    seed SEED, on ``mesh`` (None: unsharded), batches of the synthetic
    stream (B ``batch_size``, T 32)."""
    from repro_torch.distributed.context import mesh_context
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
        place_train_state,
        train_state_shardings,
    )

    cfg = lm_rank_cfg(key, **extra)
    model = build_model(cfg, DEVICE)
    state = init_train_state(model, SEED, device=DEVICE)
    if mesh is not None:
        state = place_train_state(state, train_state_shardings(state, cfg,
                                                               mesh))
    step = make_train_step(model, TrainHParams(total_steps=10))
    losses = []
    with mesh_context(mesh):
        for b in train_batches(torch, cfg.vocab, batch_size, 32, steps):
            if mesh is not None:
                b = placed_batch(b, mesh, cfg.layout)
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    if save:
        CheckpointManager(save).save(steps, state, blocking=True)
    return losses


def lm_block_loss(torch, key, mesh=None):
    """The reduced config ``key``'s loss on one batch from seed SEED:
    plain (no mesh), or with ``tp_shard_map`` on ``mesh`` (then also
    whether its gradients are finite, and the collectives issued)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.sharding import (
        params_shardings,
        place_module,
    )
    from repro_torch.distributed.spmd import full_tensor
    from repro_torch.models import build_model

    cfg = lm_rank_cfg(key)
    params = build_model(cfg, DEVICE).init(SEED, device=DEVICE)
    batch = train_batches(torch, cfg.vocab, 2, 32, 1)[0]
    if mesh is None:
        return float(build_model(cfg, DEVICE).loss(params, batch)[0])
    params.requires_grad_(True)
    place_module(params, params_shardings(params, cfg, mesh))
    collectives.LEDGER.reset()
    with mesh_context(mesh):
        loss, _ = build_model(cfg.replace(tp_shard_map=True), DEVICE).loss(
            params, placed_batch(batch, mesh))
        loss = full_tensor(loss)
        grads = torch.autograd.grad(loss, list(params.parameters()))
    return {"tp_shard_map": float(loss),
            "grads_finite": all(bool(torch.isfinite(full_tensor(g)).all())
                                for g in grads),
            "ledger": dict(collectives.LEDGER.count)}


def lm_one_rank_runs(torch) -> dict:
    """The unsharded runs the four ranks are held against (the parent
    makes them while the ranks start)."""
    return {"smollm": lm_train_losses(torch, "smollm", None, 4, 4),
            "rwkv": lm_train_losses(torch, "rwkv", None, 3, 8),
            "moe": lm_train_losses(torch, "moe", None, 3, 8),
            **{k: lm_block_loss(torch, k) for k in ("deepseek", "danube")}}


def _lm_rank_checks(torch, rank, out_dir):
    """One rank's sharded runs on (2, 2): the train step (3 steps, then
    saved), its elastic restore onto a (2, 1) mesh over ranks 0 and 1 (the
    reference's test restores onto a sub-mesh of its devices) and a fourth
    step there, rwkv6 in both layouts, the expert-parallel MoE in the
    train step, the tp_shard_map block, and the int8 cross-pod reduction
    on (2, 1, 2)."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.distributed.compress import (
        compress_grads,
        crosspod_allreduce_compressed,
        ef_init,
    )
    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.elastic import (
        make_mesh_from_devices,
        rescale,
    )
    from repro_torch.distributed.spmd import full_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
    )

    mesh = make_host_mesh((2, 2), device_type=DEVICE)
    res = {"smollm": lm_train_losses(torch, "smollm", mesh, 3, 4,
                                     save=str(out_dir / "ckpt"))}
    mesh2 = make_mesh_from_devices([0, 1], (2, 1), ("data", "model"),
                                   device_type=DEVICE)
    if mesh2.get_coordinate() is not None:
        cfg = lm_rank_cfg("smollm")
        model = build_model(cfg, DEVICE)
        state, _, at = rescale(CheckpointManager(str(out_dir / "ckpt")),
                               init_train_state(model, SEED + 1,
                                                device=DEVICE), cfg, mesh2)
        batch = train_batches(torch, cfg.vocab, 4, 32, 4)[3]
        with mesh_context(mesh2):
            state, m = make_train_step(model, TrainHParams(total_steps=10))(
                state, placed_batch(batch, mesh2))
        res["restore"] = {"at": at, "step": int(full_tensor(state.step)),
                          "loss": float(m["loss"])}
        del state
    dist.barrier()
    res["rwkv"] = {layout: lm_train_losses(torch, "rwkv", mesh, 3, 8,
                                           layout=layout)
                   for layout in ("tp", "dp")}
    collectives.LEDGER.reset()
    res["moe"] = {impl: lm_train_losses(torch, "moe", mesh, 3, 8,
                                        moe_impl=impl)
                  for impl in ("shard_map", "shard_map_wg")}
    res["moe"]["ledger"] = dict(collectives.LEDGER.count)
    for key in ("deepseek", "danube"):
        res[key] = lm_block_loss(torch, key, mesh)
    pmesh = make_host_mesh((2, 1, 2), ("pod", "data", "model"),
                           device_type=DEVICE)

    def grads_of(r):
        gen = torch.Generator(device=DEVICE).manual_seed(100 + r)
        return {"a": torch.randn(600, 50, generator=gen, device=DEVICE),
                "b": torch.randn(7, generator=gen, device=DEVICE)}

    mine = grads_of(rank)
    reduced, _ = crosspod_allreduce_compressed(mine, ef_init(mine),
                                               mesh=pmesh)
    comp = [compress_grads(grads_of(r), ef_init(mine))[0]
            for r in range(LM_SHARDED_RANKS) if r % 2 == rank % 2]
    res["crosspod_err"] = max(float(
        (reduced[k] - sum(c[k] for c in comp) / len(comp)).abs().max())
        for k in mine)
    res["staged"] = dict(collectives.LEDGER.staged)
    return res


def lm_sharded_rank(rank, store, out_dir, device):
    """One of LM_SHARDED_RANKS gloo ranks on the one card (spawned by
    ``start_lm_ranks``; ``device``: the parent's DEVICE). Writes
    ``lm_rank<r>.json``, or ``lm_rank<r>.err`` and exits 1."""
    global DEVICE
    DEVICE = device
    out_dir = Path(out_dir)
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.distributed.collectives import stage_gloo_all_gather

        if DEVICE == "cuda":
            torch.cuda.set_device(0)
            stage_gloo_all_gather()
        torch.set_num_threads(1)  # four ranks share the host's cores
        no_tf32(torch)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, LM_SHARDED_RANKS), rank=rank,
            world_size=LM_SHARDED_RANKS)
        try:
            res = _lm_rank_checks(torch, rank, out_dir)
        finally:
            dist.destroy_process_group()
        (out_dir / f"lm_rank{rank}.json").write_text(json.dumps(res))
    except BaseException:
        import traceback

        (out_dir / f"lm_rank{rank}.err").write_text(traceback.format_exc())
        sys.exit(1)


def start_lm_ranks():
    """Spawn the LM_SHARDED_RANKS gloo ranks on the card; returns what
    ``check_lm_ranks`` joins."""
    import shutil

    import torch.multiprocessing as mp

    out_dir = ROOT / "build" / "lm_sharded_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=lm_sharded_rank,
                         args=(r, str(out_dir / "store"), str(out_dir),
                               DEVICE))
             for r in range(LM_SHARDED_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    return procs, out_dir, t0


def check_lm_ranks(procs, out_dir, t0, one) -> None:
    """Join the ranks and hold rank 0's results against ``one``, the
    unsharded runs (``lm_one_rank_runs``); each contract checked."""
    try:
        for r, p in enumerate(procs):
            p.join(max(LM_SHARDED_TIMEOUT_S - (time.perf_counter() - t0), 1))
            if p.is_alive():
                fail(f"lm sharded rank {r} did not finish in "
                     f"{LM_SHARDED_TIMEOUT_S} s")
            if p.exitcode != 0:
                err = out_dir / f"lm_rank{r}.err"
                fail(f"lm sharded rank {r} exited {p.exitcode}: "
                     + (err.read_text() if err.exists() else ""))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    res = json.loads((out_dir / "lm_rank0.json").read_text())
    log("lm sharded four ranks gloo: " + json.dumps(
        {"one_rank": one, **res, "seconds": time.perf_counter() - t0}))

    def close(a, b, rtol):
        return len(a) == len(b) and all(abs(x - y) <= rtol * abs(y)
                                        for x, y in zip(a, b))

    if not close(res["smollm"], one["smollm"][:3], LM_STEP_RTOL):
        fail(f"lm sharded: the (2, 2) step differs from one rank: {res}")
    rst = res["restore"]
    if not (rst["at"] == 3 and rst["step"] == 4
            and close([rst["loss"]], one["smollm"][3:], LM_STEP_RTOL)):
        fail(f"lm sharded: the elastic restore onto (2, 1): {rst}")
    rw = res["rwkv"]
    if not (close(rw["tp"], one["rwkv"], LM_STEP_RTOL)
            and close(rw["dp"], rw["tp"], LM_STEP_RTOL)):
        fail(f"lm sharded: rwkv6 dp != tp: {rw}")
    moe = res["moe"]
    for impl in ("shard_map", "shard_map_wg"):
        if not close(moe[impl], one["moe"], LM_MOE_STEP_RTOL):
            fail(f"lm sharded: MoE {impl} != dense: {moe}")
    if not moe["ledger"].get("all-to-all"):
        fail("lm sharded: the expert-parallel MoE issued no all-to-all")
    for key in ("deepseek", "danube"):
        r = res[key]
        if not (abs(r["tp_shard_map"] - one[key]) < LM_BLOCK_ATOL
                and r["grads_finite"] and r["ledger"].get("reduce-scatter")):
            fail(f"lm sharded: the tp_shard_map block on {key}: {r}")
    if res["crosspod_err"] > 1e-6:
        fail(f"lm sharded: crosspod_allreduce_compressed: {res}")


def lm_sharded_train(torch, mesh) -> None:
    """smollm-360m at full width and depth, world size 1: one float32
    sharded step against the unsharded step on the card (B x T =
    TRAIN_CHECK_BATCH) under the training phase's bounds; then the bf16
    step timed on the mesh at the training phase's timed shape, and the
    elastic round trip of that bf16 state (``lm_sharded_elastic``)."""
    from repro_torch.distributed.context import mesh_context
    from repro_torch.models import build_model
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
        place_train_state,
        train_state_shardings,
    )

    no_tf32(torch)
    cfg = train_cfg(LM_ARCH, "float32")
    model = build_model(cfg, DEVICE)
    hp = TrainHParams(peak_lr=TRAIN_CHECK_LR, warmup_steps=0,
                      total_steps=100)
    step_fn = make_train_step(model, hp)
    b, t = TRAIN_CHECK_BATCH
    batch = train_batches(torch, cfg.vocab, b, t, 1)[0]
    plain = init_train_state(model, SEED, device=DEVICE)
    sharded = copy.deepcopy(plain)
    before = {k: p.detach().clone()
              for k, p in plain.params.named_parameters()}
    sharded = place_train_state(sharded, train_state_shardings(
        sharded, cfg, mesh))
    with mesh_context(mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded, m_sh = step_fn(sharded, placed_batch(batch, mesh))
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
    plain, m_plain = step_fn(plain, batch)
    row = {"loss_sharded": float(m_sh["loss"]),
           "loss_plain": float(m_plain["loss"]),
           "loss_rel_err": rel_err(m_sh["loss"], m_plain["loss"]),
           "grad_norm_rel_err": rel_err(m_sh["grad_norm"],
                                        m_plain["grad_norm"]),
           **step_gaps(torch, sharded, plain, before, TRAIN_CHECK_LR),
           "layers": cfg.n_layers, "batch": [b, t],
           "sharded_step_s": sharded_s}
    log(f"lm sharded train {LM_ARCH} float32 (1, 1): " + json.dumps(row))
    if not step_within_bounds(row, TRAIN_CHECK_LR):
        fail(f"lm sharded: the sharded step differs from the unsharded "
             f"one beyond the training phase's bounds: {row}")
    del plain, sharded, before
    torch.cuda.empty_cache()

    # the bf16 step on the mesh, timed at the training phase's shape
    b, t, warmup, steps = LM_SHARDED_TIMED
    cfg = train_cfg(LM_ARCH, "bfloat16")
    model = build_model(cfg, DEVICE)
    state = init_train_state(model, SEED, device=DEVICE)
    state = place_train_state(state, train_state_shardings(state, cfg, mesh))
    step_fn = make_train_step(model, TrainHParams(warmup_steps=2,
                                                  total_steps=100))
    batches = [placed_batch(x, mesh) for x in train_batches(
        torch, cfg.vocab, b, t, warmup + steps)]
    losses = []
    with mesh_context(mesh):
        for i, bt in enumerate(batches):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step_fn(state, bt)
            losses.append(m["loss"])
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    row = {"arch": LM_ARCH, "params": "bfloat16", "mesh": [1, 1],
           "batch": [b, t], "timed_steps": steps,
           "ms_per_step": secs / steps * 1e3,
           "tokens_per_s": steps * b * t / secs,
           "losses": [float(x) for x in losses]}
    log("lm sharded train timed: " + json.dumps(row))
    if not all(math.isfinite(x) for x in row["losses"]):
        fail(f"lm sharded: a timed loss is not finite: {row}")
    del batches
    lm_sharded_elastic(torch, model, cfg, state, step_fn, mesh)
    del state
    torch.cuda.empty_cache()


def lm_sharded_elastic(torch, model, cfg, state, step_fn, mesh) -> None:
    """The elastic round trip of the timed bf16 state on ``mesh`` (bf16
    parameters, float32 moments, 3.6 GB): saved as logical arrays under
    build/ (the bf16 leaves as ``|V2`` records), then ``train_loop``
    resumed from it on a new (1, 1) mesh with ``layout="dp"`` — the
    restore placed by ``state_shardings`` (``train_state_shardings`` for
    that mesh, as ``rescale`` computes them), the batches by
    ``put_batch`` — for LM_SHARDED_RESUMED steps of the synthetic stream
    at B x T = TRAIN_CHECK_BATCH. It must resume from the saved step and
    run those steps; when its first step begins every leaf must hold the
    saved bits, on the new mesh; its losses must equal those of the
    uninterrupted state on the same batches. The files are deleted."""
    import shutil

    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.elastic import make_mesh_from_devices
    from repro_torch.distributed.spmd import full_tensor, is_dtensor, local
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import DataConfig, SyntheticLMStream
    from repro_torch.train.loop import LoopConfig, batch_to_device, train_loop
    from repro_torch.train.step import init_train_state, train_state_shardings
    from repro_torch.utils.pytree import named_leaves

    def bits(x):
        x = full_tensor(x)
        return x.view(torch.int16) if x.dtype == torch.bfloat16 else x

    saved = int(local(state.step))
    n = LM_SHARDED_RESUMED
    b, t = TRAIN_CHECK_BATCH
    stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, seq_len=t,
                                          global_batch=b, seed=SEED))
    mesh2 = make_mesh_from_devices([0], (1, 1), ("data", "model"),
                                   device_type=DEVICE)
    want = dict(named_leaves(state))
    seen = {"leaves": 0, "bf16_leaves": 0, "losses": []}

    def resumed_step(st, batch):
        if not seen["losses"]:          # the restored state, unstepped
            for name, x in named_leaves(st):
                w = want[name]
                if not (x.dtype == w.dtype and is_dtensor(x)
                        and tuple(x.placements)
                        == placements[name].placements(x.ndim)
                        and torch.equal(bits(x), bits(w))):
                    fail(f"lm sharded: elastic restore: {name} differs "
                         f"from the saved state or is not placed by the "
                         f"new mesh's shardings")
                seen["leaves"] += 1
                seen["bf16_leaves"] += x.dtype == torch.bfloat16
        st, m = step_fn(st, batch)
        seen["losses"].append(float(m["loss"]))
        return st, m

    shutil.rmtree(LM_SHARDED_CKPT_DIR, ignore_errors=True)
    try:
        mgr = CheckpointManager(str(LM_SHARDED_CKPT_DIR))
        t0 = time.perf_counter()
        mgr.save(saved, state, blocking=True)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in LM_SHARDED_CKPT_DIR.rglob("*")
                     if f.is_file())
        like = init_train_state(model, SEED + 1, device=DEVICE)
        shardings = train_state_shardings(like, cfg.replace(layout="dp"),
                                          mesh2)
        placements = {"opt.count": shardings.opt.count,
                      "step": shardings.step}
        for group, tree in (("params", shardings.params),
                            ("opt.mu", shardings.opt.mu),
                            ("opt.nu", shardings.opt.nu)):
            placements.update({f"{group}.{k}": v for k, v in tree.items()})
        t0 = time.perf_counter()
        with mesh_context(mesh2):
            resumed, rep = train_loop(
                resumed_step, like, stream,
                LoopConfig(total_steps=saved + n, ckpt_every=10 ** 9,
                           ckpt_dir=str(LM_SHARDED_CKPT_DIR)),
                state_shardings=shardings,
                put_batch=lambda bt: placed_batch(bt, mesh2, "dp"))
        loop_s = time.perf_counter() - t0
        del like, resumed_step
        uninterrupted = []
        with mesh_context(mesh):
            for s in range(saved, saved + n):
                bt = batch_to_device(stream.batch_at(s), torch.device(DEVICE))
                state, m = step_fn(state, placed_batch(bt, mesh))
                uninterrupted.append(float(m["loss"]))
        row = {"saved_step": saved, "leaves": seen["leaves"],
               "bf16_leaves": seen["bf16_leaves"], "bytes": nbytes,
               "save_s": save_s, "loop_s": loop_s,
               "resumed_from": rep.resumed_from, "steps_run": rep.steps_run,
               "step_after": int(local(resumed.step)),
               "resumed_dp": seen["losses"], "uninterrupted": uninterrupted}
        log(f"lm sharded elastic {LM_ARCH} bf16: " + json.dumps(row))
        if not (rep.resumed_from == saved and rep.steps_run == n
                and row["step_after"] == saved + n
                and seen["leaves"] == len(want) and seen["bf16_leaves"]
                and len(seen["losses"]) == len(uninterrupted) == n
                and all(abs(x - y) <= TRAIN_LOSS_RTOL * abs(y)
                        for x, y in zip(seen["losses"], uninterrupted))):
            fail(f"lm sharded: the elastic round trip: {row}")
    finally:
        shutil.rmtree(LM_SHARDED_CKPT_DIR, ignore_errors=True)


def lm_sharded_moe(torch, mesh) -> None:
    """qwen3-moe-235b-a22b at full width, the families' float32 depth cut:
    the loss and the three aux terms of ``moe_impl="shard_map"`` against
    the dense dispatch, on the same placed parameters and batch."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.sharding import (
        params_shardings,
        place_module,
    )
    from repro_torch.distributed.spmd import full_tensor
    from repro_torch.models import build_model

    no_tf32(torch)
    arch = "qwen3-moe-235b-a22b"
    cfg = family_cfg(arch, "float32", attn_impl="chunked",
                     n_layers=FAMILY_LAYERS[arch][0])
    dense = build_model(cfg, DEVICE)
    params = dense.init(SEED, device=DEVICE)
    place_module(params, params_shardings(params, cfg, mesh))
    batch = placed_batch(train_batches(torch, cfg.vocab,
                                       *TRAIN_CHECK_BATCH, 1)[0], mesh)
    out = {}
    with torch.no_grad(), mesh_context(mesh):
        for impl in ("dense", "shard_map"):
            model = build_model(cfg.replace(moe_impl=impl), DEVICE)
            collectives.LEDGER.reset()
            loss, metrics = model.loss(params, batch)
            out[impl] = {"loss": float(full_tensor(loss)),
                         **{k: float(full_tensor(v))
                            for k, v in metrics.items() if k != "ce"}}
    errs = {k: abs(out["shard_map"][k] - v) / max(abs(v), 1e-30)
            for k, v in out["dense"].items()}
    log(f"lm sharded moe {arch} ({cfg.n_layers} layers, float32, (1, 1)): "
        + json.dumps({**out, "rel_errs": errs}))
    if not all(e <= LM_SHARDED_MOE_RTOL for e in errs.values()):
        fail(f"lm sharded: shard_map MoE != dense at world size 1: {out}")
    del params
    torch.cuda.empty_cache()


def lm_sharded_serving(torch, mesh) -> dict:
    """The sharded one-shot prefill at full width through the kernels
    (smollm-360m at the serving cut through flash, rwkv6-3b through
    wkv6), float32, against the unsharded prefill; then LM_SHARDED_DECODE
    sharded decode steps, the states placed by ``states_shardings``,
    against unsharded decoding. Returns the kernel launches of the
    sharded runs."""
    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.sharding import (
        batch_shardings,
        distribute,
        params_shardings,
        place,
        place_module,
        states_shardings,
    )
    from repro_torch.distributed.spmd import full_tensor
    from repro_torch.models import build_model

    no_tf32(torch)
    launches = {"flash_attention": 0, "wkv6": 0}
    b, t = LM_SHARDED_PROMPT
    for arch, layers in LM_SHARDED_PREFILL.items():
        cfg = family_cfg(arch, "float32", n_layers=layers)
        model = build_model(cfg, DEVICE)
        params = model.init(SEED, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        tokens = torch.randint(0, cfg.vocab, (b, t + LM_SHARDED_DECODE),
                               generator=gen, device=DEVICE,
                               dtype=torch.int32)
        logits = {}
        for sharded in (False, True):
            states = model.init_states(b, t + LM_SHARDED_DECODE)
            toks = tokens
            if sharded:
                place_module(params, params_shardings(params, cfg, mesh))
                states = place(states, states_shardings(
                    states, cfg, mesh, global_batch=b))
                toks = distribute(tokens, batch_shardings(
                    {"t": tokens}, mesh)["t"])
                zero_lm_kernel_launches()
            out = []
            with mesh_context(mesh if sharded else None):
                lg, states = model.prefill(params, {"tokens": toks[:, :t]},
                                           states)
                out.append(full_tensor(lg))
                for i in range(LM_SHARDED_DECODE):
                    lg, states = model.decode_step(params,
                                                   toks[:, t + i:t + i + 1],
                                                   states)
                    out.append(full_tensor(lg))
            logits[sharded] = torch.stack(out)
            if sharded:
                got = lm_kernel_launches()
                for k in launches:
                    launches[k] += got[k]
                kernel = "wkv6" if arch == RWKV_ARCH else "flash_attention"
                if got[kernel] < cfg.n_layers:
                    fail(f"lm sharded: the {arch} prefill launched {kernel} "
                         f"{got[kernel]} times, under its {cfg.n_layers} "
                         f"layers")
        err = float((logits[True] - logits[False]).abs().max())
        log(f"lm sharded serving {arch} ({cfg.n_layers} layers, prefill "
            f"{b} x {t}, {LM_SHARDED_DECODE} decode steps, float32): "
            + json.dumps({"max_abs_err": err,
                          "launches": lm_kernel_launches()}))
        if not err <= LM_SHARDED_LOGIT_TOL:
            fail(f"lm sharded: {arch} sharded logits differ by {err}")
        del params, states, logits
        torch.cuda.empty_cache()
    return launches


def lm_sharded_dryrun() -> None:
    """The dry run's 80 cells on the meta device (placement only; the
    FLOP count is the CLI's): ok / skipped / failed, and the largest
    per-rank argument bytes per mesh."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch.dryrun import run_cell

    out_dir = ROOT / "build" / "dryrun"
    counts = {"ok": 0, "skipped": 0, "failed": 0}
    largest = {}
    for mesh in ("single", "multi"):
        for arch in ARCHS:
            for shape in SHAPES:
                try:
                    rec = run_cell(arch, shape, mesh == "multi",
                                   str(out_dir), flops=False, verbose=False)
                except Exception as e:
                    counts["failed"] += 1
                    log(f"dry run {arch} {shape} {mesh}: {e!r}")
                    continue
                counts[rec["status"]] += 1
                if rec["status"] == "ok":
                    nb = rec["memory"]["argument_bytes"]
                    if nb > largest.get(mesh, (0, ""))[0]:
                        largest[mesh] = (nb, f"{arch} {shape}")
    log("lm sharded dry run: " + json.dumps(
        {**counts, "largest_argument_bytes_per_rank": largest}))
    if counts["failed"] or counts["ok"] + counts["skipped"] != 80:
        fail(f"the dry run: {counts}")


def drive_lm_sharded(torch) -> dict:
    """The lm sharded phase. The four gloo ranks start first and run
    beside the checks that time nothing (world size 1 under NCCL on a
    (1, 1) mesh: the MoE, the sharded prefill and decode through the
    kernels; the unsharded runs the ranks are held against; the dry run);
    then, the ranks joined, the timed part alone: the sharded train step,
    the bf16 step and its elastic round trip. Returns the kernel launches
    of the sharded prefills."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    ranks = start_lm_ranks()
    store = ROOT / "build" / "lm_sharded_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh(DEVICE, (1, 1),
                                mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        lm_sharded_moe(torch, mesh)
        log(f"lm sharded moe: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches = lm_sharded_serving(torch, mesh)
        log(f"lm sharded serving: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        one = lm_one_rank_runs(torch)
        lm_sharded_dryrun()
        check_lm_ranks(*ranks, one)
        log(f"lm sharded four ranks and dry run: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        lm_sharded_train(torch, mesh)
        log(f"lm sharded train: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
        for p in ranks[0]:
            if p.is_alive():
                p.kill()
    return launches

def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tasks", type=int, default=None,
                        help="tasks per model on both paths "
                             f"(default 2^19 = {TOTAL_TASKS}; with "
                             "--time-overlap 2^20)")
    parser.add_argument("--time-kernels", action="store_true",
                        help="only time the conflict, block, levels, "
                             "flash, wkv6 and SIRS kernels (device ms)")
    parser.add_argument("--time-overlap", action="store_true",
                        help="only time the overlap path of Axelrod and "
                             "SIRS (wall ms per window)")
    parser.add_argument("--lm-sharded", action="store_true",
                        help="only the lm sharded phase, after the build")
    parser.add_argument("--profile-attach", action="store_true",
                        help="only the attachment builds under "
                             "torch.profiler, after the build")
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="directory holding the repro_torch package "
                             "(--time-overlap, --time-kernels)")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if not (args.src / "repro_torch").is_dir():
        fail(f"no repro_torch under {args.src}")
    sys.path.insert(0, str(args.src))
    if args.time_overlap:
        time_overlap(torch, args.tasks or 1 << 20)
        return
    if args.time_kernels:
        time_kernels(torch)
        return
    tasks = args.tasks or TOTAL_TASKS
    from repro_torch.kernels import _build
    from repro_torch.kernels.axelrod.ops import axelrod_wave
    from repro_torch.kernels.conflict.ops import (
        conflict_block,
        conflict_matrix,
    )
    from repro_torch.kernels.levels.ops import wave_levels
    from repro_torch.kernels.sir.ops import sir_wave

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    build_logs = _build.build(["conflict", "levels", "axelrod", "sir",
                               "flash", "wkv6", "attach"])
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(build_logs) or 'cached'})")
    for name, text in build_logs.items():
        entry = ""  # the kernel and template arguments of the entry, mangled
        for line in text.splitlines():
            if "Compiling entry function" in line:
                at = line.find("_kernel")
                entry = line[max(at - 12, 0):at + 28].split("'")[0]
            if "registers" in line or "spill" in line:
                log(f"  {name} {entry}: {line.strip()}")
    if args.lm_sharded:
        t0 = time.perf_counter()
        log("lm sharded phase launches: "
            + json.dumps(drive_lm_sharded(torch)))
        log(f"lm sharded phase: {time.perf_counter() - t0:.1f} s")
        return
    if args.profile_attach:
        profile_attach(torch)
        return

    # the dry-run cells work the host's CPU: they run beside the untimed
    # parity checks and are waited for before the first timed path
    dry_cells = start_dryrun_cells(args.src)
    t0 = time.perf_counter()
    try:
        errs = {"conflict": check_conflict_parity(torch, conflict_matrix),
                "levels": check_levels_parity(torch, wave_levels),
                "conflict_block": check_block_parity(torch, conflict_block),
                "axelrod_wave": check_axelrod_parity(torch, axelrod_wave),
                "sir_wave": check_sir_parity(torch, sir_wave),
                "flash_attention": check_flash_parity(torch),
                "wkv6": check_wkv6_parity(torch)}
        check_wkv6_inplace(torch)
    except BaseException:
        stop_dryrun_cells(dry_cells[0])
        raise
    log(f"parity: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_dryrun_cells(*dry_cells)
    log(f"cost phase (d), waited: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    results, launches, models, topo = drive_main_path(torch, tasks)
    window_breakdown(torch, models)
    device_busy(torch, models, results)
    log(f"barrier path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ov_models, cpu_twin = build_overlap_models(torch, topo)
    ov_results, ov_launches = drive_overlap_path(
        torch, tasks, ov_models, cpu_twin, results)
    overlap_breakdown(torch, ov_models)
    device_busy(torch, ov_models, ov_results, engine="wavefront_overlap")
    log(f"overlap path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _, wide_launches, wide = drive_task_size(torch, WIDE_TASKS)
    log(f"task-size phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    drive_costs(torch, wide)
    log(f"cost phase (a): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    traced_run(torch, ov_models)
    log(f"traced run: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    from repro_torch.obs import current_tracer

    from repro_torch.obs.costs import current_recorder

    if current_tracer() is not None:
        fail("a tracer is still installed: the sync count needs it off")
    if current_recorder() is not None:
        fail("a cost recorder is installed: the sync count needs it off")
    count_syncs(torch, models, "wavefront")
    syncs = count_syncs(torch, ov_models, "wavefront_overlap")
    worst = max(syncs.values())
    if worst > OVERLAP_SYNCS_MAX:
        fail(f"the overlap path syncs the host {worst} times per window, "
             f"more than {OVERLAP_SYNCS_MAX}")
    log(f"sync count: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    hub_launches = drive_hub_sis(torch)
    drive_big_window(torch, models)
    log(f"wide footprints and big windows: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sharded_launches = drive_sharded_nccl(torch, ov_models,
                                          min(SHARDED_TASKS, tasks))
    drive_sharded_ranks(torch, min(SHARDED_RANK_WINDOWS * WINDOW, tasks))
    log(f"sharded phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ba, ba_build, attach_rows = drive_generators(torch)
    ba_launches = drive_wide_sis(torch, "SIS on BA", ba, ba_build["edges"],
                                 ba_build["seconds"])
    del ba
    drive_des(torch)
    log(f"generators and DES: {time.perf_counter() - t0:.1f} s")

    lm_launches, rwkv_launches = drive_lm(torch)

    t0 = time.perf_counter()
    drive_training(torch)
    log(f"training phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    family_launches = drive_families(torch)
    log(f"families phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sharded_lm_launches = drive_lm_sharded(torch)
    log(f"lm sharded phase: {time.perf_counter() - t0:.1f} s")

    log("launches barrier path: " + json.dumps(launches)
        + "; overlap path: " + json.dumps(ov_launches)
        + "; task-size phase: " + json.dumps(wide_launches)
        + "; hub SIS: " + json.dumps(hub_launches)
        + "; sharded phase: " + json.dumps(sharded_launches)
        + "; SIS on BA: " + json.dumps(ba_launches)
        + "; serving path: " + json.dumps(lm_launches)
        + "; rwkv serving path: " + json.dumps(rwkv_launches)
        + "; families phase: " + json.dumps(family_launches)
        + "; lm sharded phase: " + json.dumps(sharded_lm_launches))
    total = {k: launches.get(k, 0) + v + wide_launches.get(k, 0)
             + hub_launches.get(k, 0) + sharded_launches[k]
             + ba_launches.get(k, 0) for k, v in ov_launches.items()}
    total["levels"] += (lm_launches["wave_levels"]
                        + rwkv_launches["wave_levels"]
                        + family_launches["wave_levels"])
    rows = kernel_rows(torch, models, ov_models, total, errs)
    rows += wave_kernel_rows(
        torch, ov_models, wide,
        {"axelrod_wave": total["axelrod_wave"],
         "sir_wave": wide_launches["sir_wave"],
         "sir_wave s=50": ov_launches["sir_wave"]
         + sharded_launches["sir_wave"]}, errs)
    rows.append(wkv6_row(torch, rwkv_launches["wkv6"]
                         + sharded_lm_launches["wkv6"], errs["wkv6"]))
    rows.append(flash_row(torch, lm_launches["flash_attention"]
                          + family_launches["flash_attention"]
                          + sharded_lm_launches["flash_attention"],
                          errs["flash_attention"]))
    rows += attach_rows
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
