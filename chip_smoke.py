#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # every phase (the proof)
    python3 chip_smoke.py --phases 1-3,11  # a part (phase 1 always runs)

Needs one NVIDIA Hopper card, ``nvcc`` and this checkout; imports nothing of
JAX or of the reference package. Phases, each of which fails the run:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off for the plain versions;
2. build: the runtime-k library and the static-k builds phases 3 and 7
   need, one ``nvcc`` per library, ``BUILD_WORKERS`` at a time; the rest
   (below) go on building while phase 3 runs, and the census waits for
   them (printed as 2b, after phase 3): the registers of every
   kernel (``nvcc -Xptxas -v``, no spills allowed), ``loop_regions.cu``
   included, and of every ``fa_kernel_h256`` instance, run-time and
   static; the SASS FADD count of the static fp probe, matmul and
   attention (hd 128 and 256) at k=4 and k=24 (the fp adds must survive);
   the loop regions'
   SASS census between static k=8 and k=24: FADD for fp_add, FFMA for
   fp_fma, LDG for l1_ld, mem_ld and chase, at least 16 more in each of the
   six region kernels, and l1_ld's extra loads neither .STRONG nor volatile
   (they must stay L1 hits); the same census in each of the four DECAN loop
   kernels (``decan_loops.cu``: Table 3's token, stream and scatter_dep
   loops, Livermore), and each DECAN removal variant keeping only its class
   (the FP variant without the loop's LDG, the LS variant without the
   chains' FMUL or FADD); each graph-level noise mode's kernel
   (``graph_noise.cu``) growing by >= 20 of its pattern instruction (FADD,
   HGMMA, LDS, LDG, LDG) from k=4 to k=24; the libraries' SASS dumped in a
   thread pool first; the rest of the builds: the static audit's (k = 4, 12
   and clean of every pair phases 4 and 11 audit, the sabotaged probe's)
   and the static builds of phase 4's and 14's payload checks
   (``PAYLOAD_KS``, ``EXAMPLE_PAYLOAD_KS``);
3. check: every kernel, mode and k in {0, 1, 24, K_MAX+7} against its plain
   PyTorch version on the card at moderate sizes (attention: B=2, H=8,
   KH=2, S=512, hd 64, 128 and 256, causal / non-causal / window 128, f32
   and bf16, and seq 24, hd 256 at seq 24 and window 128 too), and every
   mode at k in {0, 1} at the main path's shapes (attention at gemma-2b's
   widths too: 8 heads on 1 KV head, hd 256, seq 4096, f32 and bf16); the
   K_MAX clamp; runtime k bitwise equal to static k at k=24 (attention:
   hd 128 f32, hd 256 f32 and bf16). The outputs of attention
   and the matmul are held row by row (``row_excess``); the same check must
   refuse each kernel fed bf16-rounded operands (a control that the
   tolerance is tight enough). The one-launch reduction of the probe and
   spmv: nacc bitwise equal to the plain versions (mxu to TF32) at 1, 31,
   33, 64 and 1056 probe CTAs and at 500 and 33 spmv CTAs (partial last
   chunks; spmv at L = 16, 112 and 128, the ring's three and two stages
   and the register path), after 200 calls back to back without a
   synchronize and on two streams at once; runtime k equal to static k
   (probe at 1056 steps, spmv at L=128); every workspace counter 0
   afterwards; every loop region (STREAM at chunk 512 and at an odd chunk,
   lat_mem_rd, HACCmk, SPMXV at L=16, 12 and 5, matmul O0 and O3) x
   every loop mode at k in {0, 1, 5, 24} against its plain version: outputs
   and aux bitwise equal (the plain versions add in the kernels' order),
   outputs bitwise equal across k (the noise leaves the region's result
   alone), runtime k bitwise equal to static k at k=24; the same at k in
   {0, 5} on the main path's own inputs (STREAM n=2^25 and SPMXV n=2^21,
   15.5 and 7.8 iterations a warp, grid-stride; lat_mem_rd on the 2^26
   table; HACCmk at width 135,168, 1,000 iterations; matmul n=192);
   matmul O3 at the edges of its trips, load ring and shared stage
   (``CHECK_O3_SHAPES``: n = 8, 33, 192 and 384, and an n_iter no multiple
   of its trip) x every loop mode at k in {0, 5}, runtime == static k=24;
   every
   DECAN variant (3 x 4 Table 3 scenarios, 3 Livermore) at phase 4's shapes
   on seeded random inputs (N=2^25; token and scatter_dep at 200
   iterations; Livermore at the edges of its trips and load ring,
   ``CHECK_LIV_SHAPES``: the main path's 60,000 iterations, past one wrap,
   a wrap landing past 0, every trip stepped, fewer iterations than the
   ring; the stream scenarios' whole triad buffer too) and the reference
   variant under every loop mode at k in {0, 5} (Livermore's main path at
   k = 0), bitwise against its plain version (``plain=True``); every graph-level mode at the card's scale, static
   and run-time k in {0, 5}: aux and new state bitwise against the plain
   version, static equal to run-time k, the input state unchanged; the
   mxu and hbm_stream emitters at their edges (``GRAPH_STREAM_TILES``,
   ``graph_noise.ref.MXU_RANDOM_C_TOL``): mxu at c = I, a permutation and a random c,
   hbm_stream at five tile counts and k at the edges of its load ring,
   run-time k = 24 equal to static; the fp_add32 and vmem_ld emitters at
   their edges (``GRAPH_VMEM_ROWS``, ``GRAPH_FP_ES``, ``GRAPH_EDGE_KS``):
   vmem at five buffer heights, fp on one block (the ici fallback), four,
   eight (one cluster) and twelve (the ticket), run-time and static k,
   states and aux bitwise against the plain version;
4. the main path, through the user's entry points, each path driven with
   every launch count set to 0 just before it and read just after (each
   ``python -m`` command below runs through its ``main`` in this process,
   ``_run_cli``; only 4b's shards are processes of their own):
   a. the main fleet plan: Qwen3-30B-A3B's attention (32 query heads, 4
      KV heads, head_dim 128, batch 1, seq 4096, causal), the probe at
      1056 steps, spmxv n=2^21 L=16 q=0, the matmul at n=4096 and
      gemma-2b's attention (8 heads on 1 KV head, head_dim 256, seq 4096:
      ``fa_kernel_h256``), one shard, run by ``python -m
      repro_torch.fleet run --in-process`` (the shard in the fleet's
      process) under the default ``--audit gate`` (every pair audited
      first), then ``run --resume --expect-no-measure`` (must audit and
      measure nothing), ``fleet audit --expect-clean`` (every pair
      intact), then ``status``, each region's sweep seconds printed; then
      ``fleet doctor --explain`` in this process (exit 0, a decision path
      for each of the five regions, its label the report's);
   b. an attention family at seq 256 and 512 (the region's default widths)
      on two subprocess shards writing segmented stores
      (``store_format="segments"``), merged incrementally (one new segment
      adopted per worker store, none skipped); in this process: ``fleet
      watch --once`` and ``fleet doctor`` (exit 0), ``campaign compact``
      (one sealed segment left); then the compacted store replayed
      (0 measured, no new audit record) and ``status`` (1 sealed segment,
      0 unsealed). The added in-process calls' seconds are printed;
   c. ``repro_torch.launch.probe --pallas attention --pallas-n 1024``;
   d. the first slice's paths through the same spine: spmxv n=2^21 L=16
      q=0 and q=1, matmul n=4096, probe 1056 steps;
   e. the paper's studies on the loop kernels, each through
      ``python -m repro_torch.bench`` with a store directory: Fig. 7 (SPMXV
      n=2^21 and 2^17, q in {0, 0.25, 0.5, 1}, fp_add and l1_ld), Fig. 5
      (STREAM n=2^25, lat_mem_rd on a 2^26 table, HACCmk 60,000 iterations
      at width 135,168; fp_add, l1_ld, mem_ld) and Fig. 4 (matmul O0 and
      O3, n=192; with ``--pallas`` the tiled matmul kernel at n=128 and the
      compile-once vs trace-per-k sweep cost), Table 3 (the four scenarios,
      N=2^25, DECAN variants and fp_add / l1_ld sweeps), Fig. 6 (Livermore,
      width 135,168, 60,000 iterations), Table 1 (fig5's sweeps replayed,
      the analytic rows, every graph mode's cost a pattern on the card) and
      Table 4 (analytic); then ``python -m repro_torch.fleet calibrate
      run``;
   every payload check must pass, and every store must replay with 0
   measured (the studies and the calibration too);
5. each kernel's launch counter above 0 and its plain version's at 0 on the
   main path (fleet workers and the study processes report their counts in
   stats files);
6. timings with CUDA events (median of 25) at the main path's shapes, k=0
   (spmv at q=0 and q=1): kernel, plain version, bound, and one PyTorch
   library call where one computes the same function (spmv: CSR ``@ x`` on
   the same matrix; attention: SDPA in f32 as ``library_ms``, and beside it
   SDPA with TF32 allowed and SDPA in bf16, at Qwen3-30B-A3B's widths and,
   as the row ``flash_attention_h256``, at gemma-2b's); the kernel's and
   the library
   call's device time from a ``torch.profiler`` trace (each kernel averaged
   over its own records), the kernels each call launches (1 for the probe,
   spmv and the loop regions, or the run fails), each
   kernel's share of its bound and its ratio to the library call on both
   clocks; the launch floor (an empty kernel through ``_build.launch``);
   the probe's µs a pattern for fp, vmem and mxu (``launch/slot_cost.py``);
   each loop kernel at its phase-4 shape through the region's runtime-k
   call at k=0 (STREAM: torch.add with alpha 3 as the library call; SPMXV
   large at q=0: CSR ``@ x``), lat_mem_rd's ns a dependent hop beside it,
   and the noise slot's own cost: each mode's run-time kernel at k=0 and
   k=8 and its static build at k=8, against the clean kernel; the DECAN
   loops at their phase-4 shapes (Table 3's data-bound scenario with
   torch.add alpha 3 as the library call, Livermore; the triads' row and
   clean build read 5 times in turns beside torch.add, Livermore's beside
   its FP32 issue bound, matmul O3's beside its warp-issue floor at the
   card's SM clock); both matmuls' slot costs in device ms too; each
   graph-level
   mode's kernel at k=64 and its µs a pattern, the slope of event and
   device time over k in {0, 128, 256, 512}, beside
   ``pattern_cost(H100_SXM)``'s: hbm_stream and hbm_latency on lines the
   call before did not leave in the L2 (``studies.fresh_calls``), and
   beside that on the same lines every call; the fp_add32, mxu_fma128,
   vmem_ld and hbm_stream emitters' device time read 5 times in turns at
   k in {0, 64, 128, 256, 512}, their k = 0 call and µs a pattern beside
   the pattern's floor (fp 2 and vmem 8 clocks, mxu's one-SM tensor-core
   1,024 clocks at the card's SM clock; hbm_stream's bytes bound, 131,072
   B at 3.35 TB/s), mxu_fma128's library call 64 chained
   ``torch.matmul(m, c)`` in bf16 in one CUDA graph.

7. serving, driven as phase 4's paths are (counts at 0 just before each,
   read just after; the graph-noise kernels' launches here join their
   rows'): gemma-2b at full width and depth in bf16 (random weights drawn
   on the card) through ``launch/serve.py``'s path at its defaults (8
   requests on 4 slots, prompts of 2-11 tokens, max_new 16, max_seq 256,
   page 16), paged, dense and paged again: greedy tokens equal, tok/s of
   the warm paged run; the engine's prefill and decode tick (4 slots of
   128 tokens, two ticks in) as step regions: the clean step a CUDA
   graph, the noisy output bitwise equal to the clean one and payload =
   k for fp_add32, mxu_fma128, vmem_ld and hbm_stream at k in {1, 64},
   static and run-time; a profiler trace of a noisy tick (mxu_fma128, k =
   512) with the noise kernel under ``NOISE_SCOPE`` on a stream of its
   own, overlapping the tick's kernels; t(0) of both regions from the
   graph and eagerly (CUDA events, median of 10); both characterized
   over the four modes into a store once at 5 reps a point and replayed
   with 0 measured; then ``python -m
   repro_torch.launch.probe --serve --arch gemma-2b`` and ``--arch
   gemma-2b --kind decode`` at the smoke config, each again with
   ``--expect-no-measure``;
8. the MoE family, as phase 7 (phase 7's model freed first):
   qwen3-moe-30b-a3b at full width and 4 of its 48 layers in bf16 (~3.1
   B parameters, 6 GB, drawn on the card; its bytes and the card's free
   memory printed; the depth cut keeps the script inside its limit with
   phases 9, 12 and 13) served paged, dense and paged (greedy tokens equal,
   tok/s, the (token, choice) pairs its dispatch drops a prefill); its
   prefill and decode tick as CUDA-graph step regions with the same
   checks, each step's kernels a call and top device operations from a
   trace of its graph, beside the time to read every weight once; both
   read once into a store at 2 reps a point (phase 7: 5) and replayed
   with 0 measured; then ``python -m
   repro_torch.launch.probe --arch mixtral-8x22b --kind decode`` (the ring
   cache), ``--arch llava-next-34b`` (the image embeds) and ``--serve
   --arch qwen3-moe-30b-a3b`` at the smoke configs, each again with
   ``--expect-no-measure``;
9. the SSM, hybrid and encoder-decoder families (each model freed before
   the next is drawn; random weights from seed 0 drawn on the card):
   mamba2-780m at full width and depth, in f32 with TF32 off, its
   forward's logits at every position of 2 x 256 tokens (two chunks and
   the inter-chunk recurrence) against 256 ``decode_step`` calls on the
   same tokens (replayed from a CUDA graph), within ``F32_CHECK_SHARE``
   of the largest |logit|; in bf16 at 24 of its 48 layers served as
   phase 7 (dense, sequential prefill; max_new 8), its greedy tokens
   equal to a greedy loop through ``decode_step`` for each request alone;
   its forward loss at batch 4 x 512 and its decode tick at batch 4 as
   CUDA-graph step regions with phase 7's checks, read once into a store
   at 1 rep a point and replayed with 0 measured; zamba2-1.2b at full
   width and depth checked in f32 as mamba2 and, at 19 of its 38 layers,
   served as mamba2;
   whisper-large-v3 at full width and depth checked in f32 over 1,500
   frames and 32 decoder positions, then in bf16 ``decode_init`` with
   frames and 16 greedy decode steps; then ``python -m
   repro_torch.launch.probe --arch zamba2-1.2b --kind decode``, ``--arch
   whisper-large-v3`` and ``--arch mamba2-780m --kind decode`` at the
   smoke configs, each again with
   ``--expect-no-measure``, and the routes the reference fails (``--serve``
   on the three, whisper ``--kind decode``), each refused with its fault
   named;
10. training (phase 9's models freed first, each path's before the next;
   no hand-written kernel on these paths: the flash VJP is plain
   PyTorch, as the reference's is plain jnp): gemma-2b at full width and
   depth in bf16 with f32 masters (random weights drawn on the card from
   seed 0), ``TrainConfig``'s defaults (AdamW, remat "nothing") with
   warmup 1, 2 x 4096 tokens a step (train_4k's length) in 2
   microbatches, the lcg task, ``Trainer.run`` for 4 steps: step 0's loss
   within 2e-2 of ``api.loss`` computed before the step, finite losses and
   grad norms; the state's bytes, the peak memory, each step's metrics
   and wall seconds, tokens a second over steps 2-4 beside the step's
   bound, and one more step traced (device time, kernels, top
   operations); the flash VJP (``FlashAttention``) at gemma-2b's attention
   widths (8 heads on 1 KV head, hd 256, seq 4096, f32, TF32 off, causal
   and window 1024) against autograd through the blocked path, within
   1e-4 of each result's largest |value|; the remat policies at full
   width and 2 layers in f32 (1 x 1024 tokens), "nothing" and "dots"
   within 1e-5 of each leaf's largest |g| under "full" (bitwise or not,
   printed), the peak memory each adds; mamba2-780m at full width and depth
   in bf16, 2 steps at 4 x 512 (the SSD's backward through autograd) and
   one more traced;
   ``python -m repro_torch.launch.train`` at the smoke config for 10
   steps with checkpoints every 5, rerun to 20 (it must resume from step
   10 and end below the first run's first loss), and ``Trainer.run`` with
   a failure injected at step 7 (checkpoints every 3): step 7 run once
   after the replay from step 6, its loss within 1e-6 of the uninterrupted
   run's.

11. the static noise audit (no measurement but the sabotage's ``warn``
   run): phase 4's main plan (each pair intact; its verdict, survival a
   pattern, predicted resource and census delta printed), a loop-region
   plan (the calibration regions' stream_kernel x fp_add, l1_ld, mem_ld)
   and gemma-2b's decode step (the graph-noise kernels), in this process
   (the census timed); the golden fixtures captured again, their reports
   equal to ``tests/golden_torch/audit_expected.json``; |body| from the clean SASS
   of every region the port builds (nonzero; a step region's 0; an
   iteration's where the innermost loop is an unrolled trip: Livermore's
   over its LIV_UNROLL, matmul O3's over its MM_O3_UNROLL); the
   loop and step payload census (payload = k, overhead and body_ops from
   the SASS); the probe's fp under ``REPRO_NOISE_SABOTAGE=const`` through
   ``python -m repro_torch.launch.probe --plan``: the audit reads it dead
   with its class and the gate refuses it with no point stored, ``--audit
   warn`` measures it.

12. the parallel layer on W = min(4, cards) ranks, one process a card and
   an NCCL group (a FileStore under the phase's directory; a 120 s group
   timeout, every rank joined within 600 s or killed, W printed first and
   beside every figure; at W = 1 NCCL's collectives are local copies):
   gemma-2b at full width and 2 layers (bf16, f32 masters, 4 x 512
   tokens, warmup 1) one ``Trainer(mesh=...)`` step on (W, 1) and, at W =
   4, (2, 2), plain and ``compress="int8"``, against the one-rank step on
   the same global batch (int8: ``compress_int8`` by reference leaf on its
   gradients): bitwise at W = 1, else every f32 master within 2·lr, at
   most 1% past lr / 10, the loss within 1e-3 and the grad norm within
   1e-2; qwen3-moe-30b-a3b at full width and 2 layers on (W, 1), held the
   same way against the one-rank step with n_groups = W, its balance loss
   printed beside that one's; each rank's state bytes and peak memory;
   gemma-2b's smoke config in f32 saved at W ranks after a mesh step and
   restored on rank 0 alone, whose next step equals the mesh's (bitwise at
   W = 1, within 1e-4 else); the three ICI modes at the default
   ``NoiseScale`` over the mesh's "model" axis, static and run-time k in
   {1, 3}, within 1e-6 of the reference's formula, and their µs a pattern
   (run-time k in {0, 64}) beside ``pattern_cost(H100_SXM)``'s d_r;
   gemma-2b's decode tick (2 layers, phase 7's probe engine) as a step
   region under each ICI mode: payload = k at k in {1, 64}, one
   characterization at 3 reps a point (rank 0's sensitivity reading picks
   every rank's sweep, and no sweep stops early, so the ranks' collectives
   match), rank 0's store replayed with 0 measured.

13. the dry-run surfaces (no hand-written kernel on this path, as the
   reference's dry-run reaches no Pallas call): the production-mesh cells
   of gemma-2b traced on the host by ``python -m
   repro_torch.launch.dryrun`` (``decode_32k`` and ``train_4k`` on 16 x
   16, ``decode_32k`` on 2 x 16 x 16; one process each, started before
   phase 12 so they overlap it and the card's cells), each ``OK`` with argument bytes inside
   80 GiB; beside them gemma-2b at full width and 2 of 18 layers, a
   training step (4 x 512 tokens, M = 1) and a decode tick (4 sequences,
   a cache of 4,096 positions) traced on meta over a one-rank fake group
   and then run on the card over a one-rank NCCL group (FileStore): the
   card's tensors' bytes equal the traced argument bytes exactly, the
   card runs the traced ops (name, shapes, dtypes, in order, collectives
   included), its CUDA-event time (median of ``DRYRUN_REPS``) is at or
   above the traced bound max(Tc, Tm, Ti), and its peak memory lies
   within ``DRYRUN_MEM_SHARE`` of the traced argument + temp; then the
   16 x 16 records' report and ``launch.probe --analytic`` on train_4k's
   record through the probe's entry point twice, the second replaying 0
   measured.

14. the port's four examples (``examples/torch_*.py``) in this process
   through their ``main``s at their defaults on the card, each driven as
   phase 4's paths are (counts at 0 just before it, read just after), its
   seconds printed beside the card: the quickstart (STREAM n = 2^22 and
   HACCmk 60,000 iterations on ``stream_kernel`` and ``haccmk_kernel``,
   fp_add, l1_ld and mem_ld at 3 reps; payload = expected for each);
   probe_train_step (gemma-2b's smoke train step at 128 x 4 under
   fp_add32, mxu_fma128, vmem_ld and hbm_stream on the graph-noise
   kernels, payload = expected for each; the analytic half on phase 13's
   train_4k 16 x 16 record when phase 13 ran, else traced on the host);
   serve_lm (deepseek-coder-33b's smoke config, 10 requests on 4 slots:
   every request done, its greedy tokens equal to the same request served
   alone on one slot); train_lm at the reference's full class (``--dim
   768 --layers 12``, 109.3M parameters) for 150 steps with the failure
   at step 75: steps 50-74 replayed from the step-50 checkpoint, every
   replayed loss bitwise equal to its first run's; the loss trajectory
   and seconds a step printed.

The last lines are the card, one ``{"kernels": [...]}`` JSON object (when
phase 6 ran), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
# one FADD or FMUL per FP32 lane and clock (132 SMs x 128 lanes x 1.98 GHz):
# the most the loop kernels can reach, whose arithmetic is unfused by design
# (__fadd_rn / __fmul_rn, rounded as their plain versions round); the
# published FP32 peak counts an FFMA as two operations
FP32_ISSUE_OPS = 33.5e12
UNFUSED_FP32 = ("stream_triad", "lat_mem_rd", "haccmk", "spmxv", "matmul_O0",
                "matmul_O3", "decan_table3", "decan_livermore")
# the two STREAM triads (csrc/triad.cuh): their device time is held to
# torch.add's and their run-time build at k=0 to their clean build's; the
# rows whose targets are read in turns (Livermore: its run-time build at
# k=0 against its clean build, and its share of the FP32 issue bound)
TRIAD_ROWS = ("stream_triad", "decan_table3")
TARGET_ROWS = TRIAD_ROWS + ("decan_livermore", "matmul_O3")
# matmul O3's targets: its row at or below O3_TARGET_MS device ms, and at
# least O3_FLOOR_SHARE of its warp-issue floor (``o3_issue_floor``)
O3_TARGET_MS = 0.100
O3_FLOOR_SHARE = 0.50

CHECK_KS = (0, 1, 24)           # plus K_MAX + 7 (the clamp)
STATIC_CHECK_K = 24
TIMING_REPS = 25

MAIN_SPMXV_N = 2 ** 21
MAIN_MATMUL_N = 4096
MAIN_PROBE_STEPS = 1056
# Qwen3-30B-A3B's attention widths (src/repro/configs/qwen3_moe_30b_a3b.py)
MAIN_ATTENTION = {"batch": 1, "heads": 32, "kv_heads": 4, "seq": 4096,
                  "head_dim": 128}
# gemma-2b's attention widths (src/repro/configs/gemma_2b.py: 8 heads on 1
# KV head, hd 256): phase 4a's fifth target, phase 3's MQA case and phase
# 6's hd-256 row
GEMMA_ATTENTION = {"batch": 1, "heads": 8, "kv_heads": 1, "seq": 4096,
                   "head_dim": 256}
# (label, hd, dtype, seq, causal, window, static): the attention cases of
# phase 3 at B=2, H=8, KH=2; ``static`` also checks the clamp and static k
ATTENTION_CASES = (
    ("hd128 f32 causal", 128, "float32", 512, True, 0, True),
    ("hd64 f32 causal", 64, "float32", 512, True, 0, False),
    ("hd128 f32 non-causal", 128, "float32", 512, False, 0, False),
    ("hd128 f32 window 128", 128, "float32", 512, True, 128, False),
    ("hd128 bf16 causal", 128, "bfloat16", 512, True, 0, False),
    ("hd64 bf16 non-causal window 128", 64, "bfloat16", 512, False, 128,
     False),
    ("hd128 f32 causal seq 24", 128, "float32", 24, True, 0, False),
    ("hd256 f32 causal", 256, "float32", 512, True, 0, True),
    ("hd256 bf16 causal", 256, "bfloat16", 512, True, 0, True),
    ("hd256 f32 causal seq 24", 256, "float32", 24, True, 0, False),
    ("hd256 f32 window 128", 256, "float32", 512, True, 128, False),
    ("hd256 bf16 window 128", 256, "bfloat16", 512, True, 128, False),
)


# the loop regions (csrc/loop_regions.cu) and their noise modes
LOOP_MODES = ("fp_add", "fp_fma", "l1_ld", "mem_ld", "chase")
LOOP_CHECK_KS = (0, 1, 5, 24)
LOOP_MAIN_CHECK_KS = (0, 5)     # at the main path's shapes
LOOP_SASS = {"fp_add": "FADD", "fp_fma": "FFMA", "l1_ld": "LDG",
             "mem_ld": "LDG", "chase": "LDG"}
# the six region kernels of csrc/loop_regions.cu
LOOP_KERNEL_FNS = ("stream_kernel", "lat_kernel", "haccmk_kernel",
                   "spmxv_kernel", "mm_o0_kernel", "mm_o3_kernel")
# the main path's loop shapes (src/repro_torch/bench/studies.py)
MAIN_STREAM_N = 2 ** 25
MAIN_LAT = {"table_len": 2 ** 26, "n_iter": 1024, "hops_per_iter": 8}
MAIN_HACC = {"n_iter": 60_000, "width": 132 * 1024}
MAIN_MM_N = 192
# the DECAN loops (csrc/decan_loops.cu) at phase 4's shapes
# (src/repro_torch/bench/studies.py T3_SIZES, FIG6_SIZES); the loops whose
# every lane group runs every iteration are checked at CHECK_DECAN_ITERS,
# on seeded random inputs
MAIN_T3 = {"n": 2 ** 25, "width": 132 * 512}
MAIN_LIV = {"n": 2 ** 18, "n_iter": 60_000, "width": 132 * 1024}
CHECK_DECAN_ITERS = 200
CHECK_DECAN_SEED = 0
DECAN_CHECK_KS = (0, 5)
# Livermore's (n, n_iter, noise ks) at MAIN_LIV's width, each at the edges
# of liv_kernel's schedule (trips of LIV_UNROLL = 8, a ring of LIV_RING = 8
# loads, the wrap checked once a trip): the main path's (14 wraps of its
# stepped offset (i*64) % (n-64), each inside a trip; the noise at k = 0,
# the sweeps' t(0), whose plain aux is cheap); past one wrap with n_iter %
# 8 != 0; n - 64 not a multiple of 64, the wrap landing past 0; a buffer
# whose every trip steps its loads; n_iter below the ring. Run-time k is
# held to static k at every shape but the main path's.
CHECK_LIV_SHAPES = ((2 ** 18, 60_000, (0,)), (2 ** 18, 5003, DECAN_CHECK_KS),
                    (4096 + 40, 1001, DECAN_CHECK_KS),
                    (130, 50, DECAN_CHECK_KS), (2 ** 12, 3, DECAN_CHECK_KS))
# matmul O3's (n, n_iter) at the edges of mm_o3_kernel (trips of
# MM_O3_UNROLL = 8, a ring of MM_O3_RING = 8 loads, a[:8, :n] staged in
# shared memory): the smallest n (one trip a wrap of n); n = 33, whose
# wraps fall inside trips; the main path's n with an n_iter no multiple of
# the trip; --full's n = 384 (a 12 KiB stage, six blocks) over 4 passes of
# its rows; n = 13 with fewer iterations than the ring. The main path's
# own n = 192 at 16 n is checked with the other regions' main shapes.
CHECK_O3_SHAPES = ((8, 128), (33, 531), (192, 8 * 192 + 5), (384, 4 * 384),
                   (13, 5))
# the graph-level noise modes (csrc/graph_noise.cu): their kernels, the SASS
# opcode of one pattern, the quantities of phase 3 and the timed k
GRAPH_MODES = ("fp_add32", "mxu_fma128", "vmem_ld", "hbm_stream",
               "hbm_latency")
GRAPH_SASS = {"fp_add32": ("gfp_kernel", "FADD"),
              "mxu_fma128": ("gmxu_kernel", "HGMMA"),
              "vmem_ld": ("gvmem_kernel", "LDS"),
              "hbm_stream": ("gstream_kernel", "LDG"),
              "hbm_latency": ("gchase_kernel", "LDG")}
GRAPH_CHECK_KS = (0, 5)
GRAPH_ROW_K = 64
GRAPH_SLOPE_KS = (0, 128, 256, 512)
GRAPH_KS = tuple(sorted({*GRAPH_SLOPE_KS, GRAPH_ROW_K}))   # read in turns
BF16_FLOPS = 989e12
# mxu_fma128's floor on the one SM its kernel runs on: a Hopper SM's bf16
# tensor cores do 4,096 dense operations a clock (989.4 TFLOP/s over 132
# SMs at 1.83 GHz), so one 2 x 128^3 pattern takes 1,024 clocks
MXU_PATTERN_CLOCKS = 2 * 128 ** 3 // 4096
# the per-pattern floors of the fp_add32 and vmem_ld emitters on each of
# the four SMs they run on (a block of 8 warps an SM), in SM clocks: fp one
# FADD a warp, 8 warps over 4 schedulers that issue one a clock: 2 clocks;
# vmem one conflict-free LDS.32 a warp, 8 x 128 B at 128 B a clock: 8
GRAPH_PATTERN_CLOCKS = {"fp_add32": 2, "vmem_ld": 8}
# the graph emitters whose device time phase 6 reads TARGET_READINGS times
# in turns (graph_readings; the chase once)
GRAPH_TARGET_MODES = ("fp_add32", "mxu_fma128", "vmem_ld", "hbm_stream")
# phase 3's edges of fp_add32 and vmem_ld: vmem at these buffer heights
# (m = max(rows - 8, 1) is 1 twice, 13 (the stride's own), 56 and the
# largest), fp at these E (the ici fallback's one block, the default
# scale's four, the largest cluster's eight, twelve through the ticket),
# each at run-time k in GRAPH_EDGE_KS (a ring of 8 loads: one partial
# trip, whole trips, the most) and at the static builds phase 2 makes
# first among them (GRAPH_EDGE_STATIC_KS)
GRAPH_VMEM_ROWS = (8, 9, 21, 64, 448)
GRAPH_FP_ES = (128, 1024, 2048, 3072)
GRAPH_EDGE_KS = (0, 1, 3, 4, 5, 13, 64, 512)
GRAPH_EDGE_STATIC_KS = (0, 1, 5, 64)
# phase 3's edge shapes of the two: hbm_stream at these tile counts (one
# tile; fewer tiles than the 197 step; the step's neighbours; the card's
# whole 256 MiB buffer), each at run-time k in {0, 1, R - 1, R, 64, K_MAX +
# 3} (R: its ring of loads in flight, csrc/graph_noise.cu G_STREAM_RING)
# and static k = 24 against run-time; mxu_fma128 at c = I, a permutation
# that is not its own transpose (exact products: bitwise) and a random c
# (seeded, N(0, 1/128) in bf16), within graph_noise.ref.MXU_RANDOM_C_TOL
# of the largest element a pattern
GRAPH_STREAM_TILES = (1, 13, 196, 197, 2048)


def attention_variant(hd: int, dtype: str) -> tuple:
    """The defines of one static attention build (``kernel.py``)."""
    return (("REPRO_STATIC_HD", hd),
            ("REPRO_STATIC_BF16", int(dtype == "bfloat16")))


def banner(title: str) -> None:
    print(f"\n=== {title}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def card_state() -> str:
    """The card's SM clock, power draw and temperature (``nvidia-smi``):
    printed around the long sweeps, where a falling clock would read as
    saturation."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's highest SM clock in MHz (``nvidia-smi clocks.max.sm``):
    the clock of a warp-issue floor."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def mxu_sm_floor(k: int, mhz: float) -> dict:
    """mxu_fma128's floor at k patterns on the one SM its kernel runs on:
    ``MXU_PATTERN_CLOCKS`` a pattern at the SM clock."""
    clocks = MXU_PATTERN_CLOCKS * k
    return {"ms": clocks / (mhz * 1e3), "clocks": clocks,
            "us_per_pattern": MXU_PATTERN_CLOCKS / mhz, "sm_clock_mhz": mhz,
            "formula": f"{MXU_PATTERN_CLOCKS} clocks x {k} patterns / "
                       f"{mhz:g} MHz"}


def graph_floor_us(name: str, state: dict, mhz: float) -> tuple:
    """(µs, what) of the least time one pattern of a graph emitter takes on
    the card: mxu_fma128's one-SM tensor-core floor, fp_add32's and
    vmem_ld's GRAPH_PATTERN_CLOCKS at the SM clock ``mhz``, hbm_stream's
    tile over the device-memory rate."""
    if name == "mxu_fma128":
        return mxu_sm_floor(1, mhz)["us_per_pattern"], "one-SM tensor-core floor"
    if name in GRAPH_PATTERN_CLOCKS:
        what = "FP32 issue" if name == "fp_add32" else "shared-memory"
        return (GRAPH_PATTERN_CLOCKS[name] / mhz,
                f"{what} floor ({GRAPH_PATTERN_CLOCKS[name]} clocks)")
    return state["acc"].numel() * 4 / HBM_BYTES_PER_S * 1e6, "bytes bound"


def mxu_library_graph(m, c, k: int):
    """k chained ``torch.matmul(m, c)`` in bf16 (one mxu_fma128 pattern a
    call) captured in one CUDA graph; returns its replay. The library's
    yardstick for the mxu emitter; the port never calls it."""
    import torch

    def chain():
        x = m
        for _ in range(k):
            x = torch.matmul(x, c)
        return x

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()
    return graph.replay


def o3_issue_floor(n: int, n_iter: int, threads: int, mhz: float) -> dict:
    """matmul O3's warp-issue floor: each warp issues 16 FADD/FMUL an
    iteration (never contracted into FFMA), a scheduler one a clock, and a
    block's warps are dealt to its SM's 4 schedulers (one block an SM: the
    n / ``threads`` blocks are fewer than the 132 SMs), so the floor is 16 x
    n_iter x the warps of the busiest scheduler clocks at the SM clock."""
    warps = -(-min(threads, n) // 32)
    busiest = -(-warps // 4)
    clocks = 16 * n_iter * busiest
    return {"ms": clocks / (mhz * 1e3), "clocks": clocks,
            "warps_a_block": warps, "warps_busiest_scheduler": busiest,
            "sm_clock_mhz": mhz,
            "formula": f"16 FADD/FMUL x {n_iter} iterations x {busiest} "
                       f"warp(s) on the busiest scheduler / {mhz:g} MHz"}


def host_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median host-clock time of one call of ``fn`` and a synchronize —
    what a sweep point sees (``core/absorption.py`` times this way)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# a spin kernel of ~50 ms (at 1.98 GHz) opens every profiler window: the
# trace drops the kernels that start within the window's first X ms, X
# growing with the process's age as its host and device clocks drift apart
# (late in one run every window lost its first call's kernels, 24 records
# for 25 one-kernel calls; with a 5 ms spin the windows timed after ~9
# minutes still did), so the calls timed start after it. Later in a run the
# windows lose records behind the 50 ms spin too, and more behind a longer
# one (retries at 4x and 16x the spin lost every record of a row), so a
# window traced again spins SPIN_SHRINK times shorter than the one before,
# and the most complete window is kept
SPIN_CYCLES = 100_000_000
SPIN_SHRINK = 8


def device_ms(fn, reps: int = TIMING_REPS, windows: int = 3):
    """Device time of one call of ``fn`` from a torch.profiler trace (CUPTI):
    (ms per call summed over its kernels, {kernel: ms per call}, kernels
    launched per call, complete); (None, {}, 0, False) when the trace holds
    no device events. A kernel's ms per call is the mean of its own records
    times its launches a call (its records / reps, rounded), so a record the
    trace dropped leaves it unbiased. The window opens with a spin kernel
    (``SPIN_CYCLES``), left out; a window in which a kernel's records are
    not a whole number a call is traced again behind a spin
    ``SPIN_SHRINK`` times shorter, at most ``windows`` times; the first
    whole window, else the one with the most records, is kept, and
    ``complete`` says whether it was whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None     # (complete, records kept, {kernel: [ms, records]})
    for attempt in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES // SPIN_SHRINK ** attempt)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        records: dict = {}     # kernel -> [ms summed, records]
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" not in e.name):
                name = e.name.split("(")[0].replace("void ", "")
                rec = records.setdefault(name, [0.0, 0])
                rec[0] += e.time_range.elapsed_us() / 1e3
                rec[1] += 1
        per_call = {name: max(1, round(n / reps))
                    for name, (_, n) in records.items()}
        complete = bool(records) and all(
            n == per_call[name] * reps for name, (_, n) in records.items())
        window = (complete, sum(n for _, n in records.values()), records)
        if best is None or window[:2] > best[:2]:
            best = window
        if complete:
            break
    complete, _, records = best
    if not records:
        return None, {}, 0, False
    per_call = {name: max(1, round(n / reps))
                for name, (_, n) in records.items()}
    per_kernel = {name: ms / n * per_call[name]
                  for name, (ms, n) in records.items()}
    return (sum(per_kernel.values()), per_kernel, sum(per_call.values()),
            complete)


def time_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Kernels:
    """The kernels of the path: their modules and counters, plus the counts
    fleet worker subprocesses report."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import kernel as fa_k
        from repro_torch.kernels.noise_probes import kernel as probe_k
        from repro_torch.kernels.noisy_matmul import kernel as matmul_k
        from repro_torch.kernels.spmv_ell import kernel as spmv_k

        self.rows = {
            "noise_probes": {
                "cuda": probe_k.probe_cuda, "plain": probe_k.probe_plain,
                "source": "src/repro_torch/csrc/noise_probes.cu",
                "replaces": "src/repro/kernels/noise_probes/kernel.py:42"},
            "spmv_ell": {
                "cuda": spmv_k.spmv_ell_cuda, "plain": spmv_k.spmv_ell_plain,
                "source": "src/repro_torch/csrc/spmv_ell.cu",
                "replaces": "src/repro/kernels/spmv_ell/kernel.py:98"},
            "noisy_matmul": {
                "cuda": matmul_k.matmul_cuda, "plain": matmul_k.matmul_plain,
                "source": "src/repro_torch/csrc/noisy_matmul.cu",
                "replaces": "src/repro/kernels/noisy_matmul/kernel.py:87"},
            "flash_attention": {
                "cuda": fa_k.flash_attention_cuda,
                "plain": fa_k.flash_attention_plain,
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:157"},
            # the wrapper's calls at hd 256: fa_kernel_h256
            "flash_attention_h256": {
                "cuda": fa_k.h256_launches,
                "plain": fa_k.flash_attention_plain,
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:157"},
        }
        from repro_torch.kernels.loop_regions.kernel import REGION_KERNELS

        replaces = {"stream_triad": 31, "lat_mem_rd": 58, "haccmk": 92,
                    "spmxv": 125, "matmul_O0": 160, "matmul_O3": 160}
        for name, (cuda, plain) in REGION_KERNELS.items():
            self.rows[name] = {
                "cuda": cuda, "plain": plain,
                "source": "src/repro_torch/csrc/loop_regions.cu",
                "replaces": f"src/repro/bench/kernels.py:{replaces[name]}"}
        from repro_torch.kernels.decan_loops.kernel import DECAN_KERNELS
        from repro_torch.kernels.graph_noise.kernel import GRAPH_KERNELS

        replaces = {"decan_table3": "benchmarks/table3_decan.py:46",
                    "decan_livermore": "benchmarks/fig6_overlap.py:27",
                    "graph_fp_add32": "src/repro/core/noise.py:101",
                    "graph_mxu_fma128": "src/repro/core/noise.py:132",
                    "graph_vmem_ld": "src/repro/core/noise.py:161",
                    "graph_hbm_stream": "src/repro/core/noise.py:200",
                    "graph_hbm_latency": "src/repro/core/noise.py:241"}
        for source, kernels in (("decan_loops", DECAN_KERNELS),
                                ("graph_noise", GRAPH_KERNELS)):
            for name, (cuda, plain) in kernels.items():
                self.rows[name] = {
                    "cuda": cuda, "plain": plain,
                    "source": f"src/repro_torch/csrc/{source}.cu",
                    "replaces": replaces[name]}
        self.workers = {name: [0, 0] for name in self.rows}

    def reset(self) -> None:
        for name, row in self.rows.items():
            row["cuda"].launches = 0
            row["plain"].launches = 0
            self.workers[name] = [0, 0]

    def add_worker(self, stats_path: str) -> None:
        """Add the launches a fleet worker reported in its stats file."""
        with open(stats_path) as f:
            launches = json.load(f)["launches"]
        for name, (n_cuda, n_plain) in launches.items():
            self.workers[name][0] += n_cuda
            self.workers[name][1] += n_plain

    def counts(self) -> dict:
        return {name: (row["cuda"].launches + self.workers[name][0],
                       row["plain"].launches + self.workers[name][1])
                for name, row in self.rows.items()}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env() -> str:
    import torch

    banner("1. environment")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} "
          f"(x{torch.cuda.device_count()})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("plain versions: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")
    return card


def _static_set():
    """(kernel source, mode id, k, variant defines[, sabotage]) of every
    static build phase 2 makes: the check's, the audit's and phase 4's
    payload checks'."""
    return list(dict.fromkeys(_check_set() + _audit_set() + _payload_set()))


# phase 4's payload checks: the static build at the last k of each sweep,
# (mode, k) as the main path's sweeps end on the card (the robust schedule
# at 320, the sensitive ones where saturation stops them); built with the
# rest in phase 2's pool rather than one after another in phase 4 (a sweep
# that ends elsewhere builds its own, as before)
PAYLOAD_KS = {"probe": (("fp", 320), ("vmem", 320)),
              "spmxv": (("fp", 320), ("vmem", 320)),
              "matmul": (("fp", 320), ("mxu", 8), ("vmem", 64)),
              "attention": (("fp", 320), ("mxu", 8), ("vmem", 64)),
              "attention hd64": (("fp", 320), ("fp", 64), ("mxu", 24),
                                 ("vmem", 320), ("vmem", 64)),
              "attention hd256": (("fp", 320), ("mxu", 16), ("vmem", 64))}


# phase 14's payload checks, built in the same pool: the quickstart's
# STREAM sweeps end at 320 and HACCmk's mem_ld at 2 (its fp_add at 24 and
# l1_ld at 12 are the census's and the audit's builds); probe_train_step's
# graph modes at 128, half the last k of a whole sweep
EXAMPLE_PAYLOAD_KS = {"loop_regions": (("fp_add", 320), ("l1_ld", 320),
                                       ("mem_ld", 320), ("mem_ld", 2)),
                      "graph_noise": (("fp_add32", 128), ("mxu_fma128", 128),
                                      ("vmem_ld", 128), ("hbm_stream", 128))}


def _payload_set():
    from repro_torch.core.loopnoise import MODE_IDS as LOOP_IDS
    from repro_torch.kernels.graph_noise.kernel import MODE_IDS as GRAPH_IDS
    from repro_torch.kernels.noise_slots import MODE_IDS

    src = {"probe": ("noise_probes", ()), "spmxv": ("spmv_ell", ()),
           "matmul": ("noisy_matmul", ()),
           "attention": ("flash_attention", attention_variant(128, "float32")),
           "attention hd64": ("flash_attention",
                              attention_variant(64, "float32")),
           "attention hd256": ("flash_attention",
                               attention_variant(256, "float32"))}
    ids = {"loop_regions": LOOP_IDS, "graph_noise": GRAPH_IDS}
    return [(src[kern][0], MODE_IDS[m], k, src[kern][1])
            for kern, pairs in PAYLOAD_KS.items() for m, k in pairs] + [
        (source, ids[source][m], k, ())
        for source, pairs in EXAMPLE_PAYLOAD_KS.items() for m, k in pairs]


def _check_set():
    """(kernel source, mode id, k, variant defines) of every static build
    the check needs."""
    from repro_torch.kernels.noise_slots import MODE_IDS
    from repro_torch.kernels.region import KERNEL_MODES

    src = {"probe": "noise_probes", "spmxv": "spmv_ell",
           "matmul": "noisy_matmul", "attention": "flash_attention"}
    want = [(src[kern], MODE_IDS[m], STATIC_CHECK_K, ())
            for kern in ("probe", "spmxv", "matmul")
            for m in KERNEL_MODES[kern]]
    want += [("flash_attention", MODE_IDS[m], STATIC_CHECK_K,
              attention_variant(hd, dtype))
             for _, hd, dtype, _, _, _, static in ATTENTION_CASES if static
             for m in KERNEL_MODES["attention"]]
    from repro_torch.core.loopnoise import MODE_IDS as LOOP_IDS

    want += [(src, LOOP_IDS[m], k, ()) for src in ("loop_regions",
                                                   "decan_loops")
             for m in LOOP_MODES for k in (8, STATIC_CHECK_K)]
    from repro_torch.kernels.graph_noise.kernel import MODE_IDS as GRAPH_IDS

    want += [("graph_noise", GRAPH_IDS[m], k, ()) for m in GRAPH_MODES
             for k in sorted({*GRAPH_CHECK_KS, STATIC_CHECK_K})]
    from repro_torch.analysis import K_LO

    # _check_graph_emitters: the audit's mxu build at the permutation c
    want += [("graph_noise", GRAPH_IDS["mxu_fma128"], K_LO, ())]
    # phase 7: the serve regions' payload checks, and the largest k of a
    # robust sweep (controller._ks_for)
    want += [("graph_noise", GRAPH_IDS[m], k, ()) for m in GRAPH_MODES[:4]
             for k in (*SERVE_KS, 320)]
    return want


def _audit_set():
    """The static builds the audit reads (clean, K_LO and K_HI of every
    pair phases 4 and 11 audit; the loop and DECAN clean builds the payload
    census reads), and the sabotaged probe fp's."""
    from repro_torch.analysis import K_HI, K_LO
    from repro_torch.core.calibration import CALIB_MODES
    from repro_torch.core.loopnoise import MODE_IDS as LOOP_IDS
    from repro_torch.kernels.graph_noise.kernel import MODE_IDS as GRAPH_IDS
    from repro_torch.kernels.noise_slots import MODE_IDS
    from repro_torch.kernels.region import KERNEL_MODES

    src = {"probe": ("noise_probes", ()), "spmxv": ("spmv_ell", ()),
           "matmul": ("noisy_matmul", ()),
           "attention": ("flash_attention", attention_variant(128, "float32")),
           "attention hd64": ("flash_attention",
                              attention_variant(64, "float32")),
           "attention hd256": ("flash_attention",
                               attention_variant(256, "float32"))}
    want = []
    for kern, (source, defines) in src.items():
        want.append((source, 0, 0, defines))
        want += [(source, MODE_IDS[m], k, defines)
                 for m in KERNEL_MODES[kern.split()[0]] for k in (K_LO, K_HI)]
    want += [("graph_noise", GRAPH_IDS[m], k, ()) for m in GRAPH_MODES
             for k in (0, K_LO, K_HI)]
    want += [("loop_regions", 0, 0, ()), ("decan_loops", 0, 0, ())]
    want += [("loop_regions", LOOP_IDS[m], k, ()) for m in CALIB_MODES
             for k in (K_LO, K_HI)]
    return want + [("noise_probes", m, k, (), True)
                   for m, k in ((0, 0), (MODE_IDS["fp"], K_LO),
                                (MODE_IDS["fp"], K_HI))]


def _fadd_grows(kernel: str, defines: tuple, per_pattern: int) -> None:
    from repro_torch.analysis import K_LO
    from repro_torch.kernels import _build

    lo = _build.sass_count(_build.static_lib_path(kernel, 1, K_LO, defines),
                           "FADD")
    hi = _build.sass_count(
        _build.static_lib_path(kernel, 1, STATIC_CHECK_K, defines), "FADD")
    print(f"SASS FADD in the static fp {kernel}: k={K_LO} -> {lo}, "
          f"k={STATIC_CHECK_K} -> {hi}")
    want = (STATIC_CHECK_K - K_LO) * per_pattern
    if lo is not None and hi - lo < want:
        raise RuntimeError(f"{kernel}: fp noise adds were folded: the "
                           f"k={STATIC_CHECK_K} build has {hi - lo} more FADD "
                           f"than k={K_LO}, want >= {want}")


def _h256_builds() -> list:
    """The static builds of ``fa_kernel_h256`` phase 2 makes: phase 3's at
    k=24, and the audit's and payload checks' of phase 4a's gemma-2b
    target."""
    want = dict(attention_variant(256, "float32")), dict(
        attention_variant(256, "bfloat16"))
    return [b for b in _static_set() if b[0] == "flash_attention"
            and dict(b[3]) in want]


def _h256_registers() -> None:
    """Registers and spills of every ``fa_kernel_h256`` instance (``nvcc
    -Xptxas -v``): the run-time library's (each dtype and mode) and each
    static build's; a spill fails the run."""
    from repro_torch.kernels import _build

    def short(entry):   # fa_kernel_h256<float, MODE, SK>
        name = entry.replace("(int)", "").replace("void ", "")
        return name[:name.find(">") + 1]

    usage = {short(name): u for name, u in
             _build.ptxas_usage("flash_attention").items()
             if "fa_kernel_h256" in name}
    for source, mode_id, k, defines, *_ in _h256_builds():
        path = _build.static_lib_path(source, mode_id, k, defines,
                                      sabotage=False)
        usage.update({short(name): u for name, u in
                      _build.static_ptxas_usage(path).items()
                      if "fa_kernel_h256" in name})
    print(f"ptxas registers, fa_kernel_h256 ({len(usage)} instances): "
          + "; ".join(f"{name} {regs}" + (f" SPILLS {st}/{ld}" if st or ld
                                           else "")
                      for name, (regs, st, ld) in sorted(usage.items())))
    spilled = [name for name, (_, st, ld) in usage.items() if st or ld]
    if spilled or not usage:
        raise RuntimeError(f"fa_kernel_h256: spills in {spilled}"
                           if spilled else "fa_kernel_h256: no instance")


def _census_paths() -> list:
    """The libraries phase 2's SASS census reads: the run-time library,
    the fp kernels' and the graph modes' static builds at K_LO and k=24,
    the loop and DECAN ones at k=8 and 24; and the loop builds of phase
    14's payload census."""
    from repro_torch.analysis import K_LO
    from repro_torch.core.loopnoise import MODE_IDS as LOOP_IDS
    from repro_torch.kernels import _build
    from repro_torch.kernels.graph_noise.kernel import MODE_IDS as GRAPH_IDS

    fp = [("noise_probes", ()), ("noisy_matmul", ()),
          ("flash_attention", attention_variant(128, "float32")),
          ("flash_attention", attention_variant(256, "float32"))]
    libs = [(src, 1, k, d) for src, d in fp for k in (K_LO, STATIC_CHECK_K)]
    libs += [("graph_noise", GRAPH_IDS[m], k, ()) for m in GRAPH_MODES
             for k in (K_LO, STATIC_CHECK_K)]
    libs += [(src, LOOP_IDS[m], k, ()) for src in ("loop_regions",
                                                   "decan_loops")
             for m in LOOP_MODES for k in (8, STATIC_CHECK_K)]
    # the quickstart's payload census: its loop builds against the clean one
    libs += [("loop_regions", LOOP_IDS[m], k, ())
             for m, k in EXAMPLE_PAYLOAD_KS["loop_regions"]]
    libs += [("loop_regions", 0, 0, ())]
    return [_build.runtime_lib_path()] + [
        _build.static_lib_path(*lib, sabotage=False) for lib in libs]


def _no_spills(usage: dict) -> None:
    """Print the registers of every kernel entry (``nvcc -Xptxas -v``); a
    spill in one of them fails the run."""
    spilled = []
    for kernel, entries in usage.items():
        names = []
        for entry, (regs, st, ld) in sorted(entries.items()):
            name = entry.replace("(int)", "").replace("void ", "")
            name = name[:name.rfind(">") + 1] or name.split("(")[0]
            names.append(f"{name} {regs}" + (f" SPILLS {st}/{ld}"
                                              if st or ld else ""))
            if st or ld:
                spilled.append(name)
        print(f"ptxas registers, {kernel}.cu: " + "; ".join(names))
    if spilled:
        raise RuntimeError(f"register spills in {spilled}")


# nvcc processes at once beside this process (the run-time library's seven
# count as one): every core but one, so the checks that run while the
# static builds finish keep a core of their own
BUILD_WORKERS = max(2, (os.cpu_count() or 8) - 1)


def phase_build():
    """Build the run-time library and phase 3's and 7's static builds, and
    start the rest (the audit's and the payload checks') in the
    background; returns the pool and the call that waits for them and
    reads the SASS census (``_finish_build``), which runs after phase 3."""
    from repro_torch.kernels import _build

    banner("2. build")

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    def static(source, mode_id, k, defines, sabotage=False):
        return _build.static_build(source, mode_id, k, defines,
                                   sabotage=sabotage)

    t0 = time.perf_counter()
    first = list(dict.fromkeys(_check_set()))
    rest = [s for s in _static_set() if s not in set(first)]
    pool = ThreadPoolExecutor(max_workers=BUILD_WORKERS)
    rt = pool.submit(timed, _build.runtime_lib)
    statics = {s: pool.submit(timed, static, *s) for s in first}
    later = {s: pool.submit(timed, static, *s) for s in rest}
    rt_s = rt.result()
    static_s = [f.result() for f in statics.values()]
    print(f"runtime-k library ({len(_build.KERNEL_SOURCES)} sources, "
          f"parallel nvcc + link): {rt_s:.1f} s; {len(statics)} static-k "
          f"builds of phases 3 and 7 alongside (slowest {max(static_s):.1f} "
          f"s), {BUILD_WORKERS} builds at a time: {time.perf_counter() - t0:.1f}"
          f" s; {len(later)} more building while phase 3 runs", flush=True)
    return pool, partial(_finish_build, statics, later, t0)


def _finish_build(statics: dict, later: dict, t0: float) -> None:
    """Wait for the static builds phase 2 left running, then read the SASS
    census of the libraries and the registers of every kernel."""
    from repro_torch.kernels import _build

    banner("2b. the rest of the static builds, and the SASS census")
    static_s = [f.result() for f in later.values()]
    h256 = [(statics | later)[b].result() for b in _h256_builds()]
    gemma = [(statics | later)[b].result() for b in _h256_builds()
             if b not in statics]
    print(f"fa_kernel_h256's {len(h256)} static builds: {sum(h256):.1f} s of "
          f"nvcc (slowest {max(h256):.1f} s), {sum(gemma):.1f} s of them for "
          f"phase 4a's gemma-2b target ({len(gemma)} builds, in the pool "
          f"beside the rest)", flush=True)
    n_audit = len(set(_audit_set()) - set(_check_set()))
    print(f"{len(later)} static-k builds ({n_audit} of them for the audit, "
          f"{len(later) - n_audit} for phase 4's and 14's payload checks; "
          f"slowest {max(static_s, default=0.0):.1f} s): all built "
          f"{time.perf_counter() - t0:.1f} s after phase 2 began")
    t0 = time.perf_counter()
    paths = _census_paths()
    with ThreadPoolExecutor(max_workers=16) as pool:
        list(pool.map(_build.sass_dump, paths))
    print(f"cuobjdump -sass of the {len(paths)} libraries the census reads "
          f"(a thread pool of 16): {time.perf_counter() - t0:.1f} s",
          flush=True)
    _no_spills({k: _build.ptxas_usage(k) for k in _build.KERNEL_SOURCES})
    # 4 elements per thread and pattern: k=24 holds 16 patterns more
    _fadd_grows("noise_probes", (), 4)
    _fadd_grows("noisy_matmul", (), 4)
    _fadd_grows("flash_attention", attention_variant(128, "float32"), 4)
    _fadd_grows("flash_attention", attention_variant(256, "float32"), 4)
    _h256_registers()
    _loop_census()
    _decan_census()
    _graph_census()


def _loop_census() -> None:
    """Static loop_regions builds at k=8 and k=24: each mode's pattern
    instruction grows by >= 16 in each of the six region kernels; l1_ld's
    extra loads are plain cached loads (not .STRONG, which bypasses L1)."""
    from repro_torch.core.loopnoise import MODE_IDS as LOOP_IDS
    from repro_torch.kernels import _build

    want = STATIC_CHECK_K - 8
    failed = []
    for mode in LOOP_MODES:
        op = LOOP_SASS[mode]
        census = {}
        for k in (8, STATIC_CHECK_K):
            path = _build.static_lib_path("loop_regions", LOOP_IDS[mode], k)
            census[k] = _build.sass_census(path, op)
            if census[k] is None:
                raise RuntimeError("cuobjdump not found: no SASS census")
        growth, strong = {}, {}
        for kern in LOOP_KERNEL_FNS:
            # mangled: _Z13stream_kernelILi1ELi8EE...
            ops = {k: [c for fn, c in census[k].items()
                       if f"{len(kern)}{kern}I" in fn] for k in census}
            if any(len(v) != 1 for v in ops.values()):
                raise RuntimeError(f"loop_regions {mode}: {kern} is not one "
                                   f"function of the static builds")
            ops = {k: v[0] for k, v in ops.items()}
            growth[kern] = (sum(ops[STATIC_CHECK_K].values())
                            - sum(ops[8].values()))
            strong[kern] = [sum(c for o, c in v.items()
                                if "STRONG" in o or "VOL" in o)
                            for v in ops.values()]
            if growth[kern] < want:
                failed.append(f"{mode} {kern}: {growth[kern]} more {op}")
            if mode == "l1_ld" and strong[kern][0] != strong[kern][1]:
                failed.append(f"l1_ld {kern}: strong/volatile loads (they "
                              f"bypass L1) {strong[kern]}")
        print(f"SASS {op} in the static {mode} loop_regions, k=8 -> "
              f"k={STATIC_CHECK_K}, growth a kernel: {growth}")
    if failed:
        raise RuntimeError(f"loop_regions SASS census (want >= {want} more "
                           f"pattern instructions a kernel): {failed}")


def _growth(source: str, mode_id: int, op: str, fn_prefixes,
            lo: int = 8) -> dict:
    """{function: pattern instructions of ``op`` in the static k=24 build
    minus the k=``lo`` build} for every function of ``source`` whose
    mangled name starts with one of ``fn_prefixes``. A kernel whose last
    template argument is the static k (``SK``) is matched across the two
    builds with that argument written ``Li#E``."""
    from repro_torch.kernels import _build

    census = {}
    for k in (lo, STATIC_CHECK_K):
        c = _build.sass_census(_build.static_lib_path(source, mode_id, k), op)
        if c is None:
            raise RuntimeError("cuobjdump not found: no SASS census")
        census[k] = {re.sub(rf"Li{k}E(?=Ev)", "Li#E", fn, count=1): ops
                     for fn, ops in c.items()}
    out = {}
    for fn in census[STATIC_CHECK_K]:
        if fn.startswith(tuple(fn_prefixes)):
            grown = sum(census[STATIC_CHECK_K][fn].values())
            out[fn] = grown - sum(census[lo].get(fn, {}).values())
    return out


# the DECAN kernels by mangled name prefix: t3_kernel<KIND, ...>, liv_kernel
DECAN_FNS = {"t3 token": "_Z9t3_kernelILi0E", "t3 stream": "_Z9t3_kernelILi1E",
             "t3 scatter_dep": "_Z9t3_kernelILi2E", "livermore": "_Z10liv_kernelI"}


def _decan_census() -> None:
    """decan_loops.cu: (1) each loop mode's static k=24 build holds >= 16
    more pattern instructions than k=8 in each of the four loop kernels;
    (2) in the run-time library each removal variant keeps only its class:
    the FP variant lost the loop's loads (LDG), the LS variant the chains'
    FMUL (Livermore: FADD), against the reference variant."""
    from repro_torch.core.loopnoise import MODE_IDS as LOOP_IDS
    from repro_torch.kernels import _build

    want = STATIC_CHECK_K - 8
    failed = []
    for mode in LOOP_MODES:
        growth = _growth("decan_loops", LOOP_IDS[mode], LOOP_SASS[mode],
                         DECAN_FNS.values())
        per = {label: [g for fn, g in growth.items() if fn.startswith(pre)]
               for label, pre in DECAN_FNS.items()}
        for label, gs in per.items():
            if len(gs) != 1 or gs[0] < want:
                failed.append(f"{mode} {label}: growth {gs}")
        print(f"SASS {LOOP_SASS[mode]} in the static {mode} decan_loops, "
              f"k=8 -> k={STATIC_CHECK_K}, growth a kernel: {per}")
    lib = _build.runtime_lib_path()
    ldg = _build.sass_census(lib, "LDG")
    ops = {"FMUL": _build.sass_census(lib, "FMUL"),
           "FADD": _build.sass_census(lib, "FADD")}

    def count(census, prefix):
        hits = [sum(c.values()) for fn, c in census.items()
                if fn.startswith(prefix)]
        if len(hits) != 1:
            raise RuntimeError(f"decan census: {prefix} is {len(hits)} "
                               "functions of the run-time library")
        return hits[0]

    # (prefix, chain op, least loads an iteration, least chain ops a step)
    kernels = {f"t3 {kind}": (f"_Z9t3_kernelILi{i}E", "FMUL", loads, 8)
               for i, (kind, loads) in enumerate((("token", 2), ("stream", 2),
                                                  ("scatter_dep", 4)))}
    kernels["livermore"] = ("_Z10liv_kernelI", "FADD", 1, 12)
    variants = {"ref": "Lb1ELb1ELi0ELin1E", "fp": "Lb1ELb0ELi0ELin1E",
                "ls": "Lb0ELb1ELi0ELin1E"}
    for label, (prefix, op, loads, chain) in kernels.items():
        n = {v: (count(ldg, prefix + tail), count(ops[op], prefix + tail))
             for v, tail in variants.items()}
        ok = (n["ref"][0] - n["fp"][0] >= loads and n["ls"][0] >= loads
              and n["ref"][1] - n["ls"][1] >= chain and n["fp"][1] >= chain)
        print(f"decan variants, {label}: (LDG, {op}) ref {n['ref']}, fp "
              f"{n['fp']}, ls {n['ls']}: each keeps only its class: {ok}")
        if not ok:
            failed.append(f"variants of {label}: {n}")
    if failed:
        raise RuntimeError(f"decan_loops SASS census (want >= {want} more "
                           f"pattern instructions a kernel): {failed}")


def _graph_census() -> None:
    """graph_noise.cu: each mode's static k=24 build holds >= 20 more
    pattern instructions than k=4 (the audit's K_LO) in its kernel (fp FADD, mxu HGMMA, vmem
    LDS, hbm_stream and hbm_latency LDG)."""
    from repro_torch.analysis import K_LO
    from repro_torch.kernels.graph_noise.kernel import MODE_IDS as GRAPH_IDS

    want = STATIC_CHECK_K - K_LO
    failed = []
    growth = {}
    for mode in GRAPH_MODES:
        fn, op = GRAPH_SASS[mode]
        g = _growth("graph_noise", GRAPH_IDS[mode], op,
                    (f"_Z{len(fn)}{fn}I",), lo=K_LO)
        growth[mode] = (op, list(g.values()))
        if len(g) != 1 or min(g.values()) < want:
            failed.append(f"{mode}: {op} growth {g}")
    print(f"SASS in the static graph_noise builds, k={K_LO} -> "
          f"k={STATIC_CHECK_K}: "
          f"{growth}")
    if failed:
        raise RuntimeError(f"graph_noise SASS census (want >= {want} more "
                           f"pattern instructions): {failed}")


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _close(got, want, what, failures, tol="exact"):
    """Hold ``got`` against ``want``: "exact" (rtol 1e-5, atol 1e-6),
    "tf32" (max|d| <= 1e-2 max|want|, the mxu nacc) or a float: a per-row
    limit of that share of each row's largest value (``row_excess`` <= 1;
    attention's and the matmul's output); returns max|d|."""
    import torch

    from repro_torch.kernels.flash_attention.ref import row_excess

    err = _max_err(got, want)
    if not torch.isfinite(got.float()).all():
        failures.append(f"{what}: non-finite values")
    elif isinstance(tol, float):
        excess = row_excess(got, want, tol)
        if excess > 1:
            failures.append(f"{what}: max|d|={err:.3g}, {excess:.3g} times "
                            f"its per-row limit (TF32 rows, {tol})")
    elif tol == "tf32":
        lim = 1e-2 * float(want.float().abs().max())
        if err > lim:
            failures.append(f"{what}: max|d|={err:.3g} > {lim:.3g} (TF32)")
    elif not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        failures.append(f"{what}: max|d|={err:.3g} beyond rtol 1e-5 atol 1e-6")
    return err


def _equal(a, b, what, failures):
    import torch

    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if not torch.equal(x, y):
            failures.append(f"{what}: not bitwise equal")


def _cases(noise, pnoise, n_steps, vals, cols, x, a, b):
    """name -> (modes, runtime-k call, static-k call, plain call, output
    tolerance)."""
    from repro_torch.kernels.noise_probes.kernel import (probe, probe_plain,
                                                         probe_rt)
    from repro_torch.kernels.noisy_matmul.kernel import (matmul, matmul_plain,
                                                         matmul_rt)
    from repro_torch.kernels.noisy_matmul.ref import TF32_ROW_TOL
    from repro_torch.kernels.spmv_ell.kernel import (spmv_ell, spmv_ell_plain,
                                                     spmv_ell_rt)

    return {
        "noise_probes": (("fp", "mxu", "vmem"),
                         lambda m, k: probe_rt(k, pnoise, mode=m, n_steps=n_steps),
                         lambda m, k: probe(pnoise, mode=m, k_noise=k, n_steps=n_steps),
                         lambda m, k: probe_plain(pnoise, mode=m, k_noise=k,
                                                  n_steps=n_steps), "exact"),
        "spmv_ell": (("fp", "vmem"),
                     lambda m, k: spmv_ell_rt(k, vals, cols, x, mode=m),
                     lambda m, k: spmv_ell(vals, cols, x, mode=m, k_noise=k),
                     lambda m, k: spmv_ell_plain(vals, cols, x, mode=m, k_noise=k),
                     "exact"),
        "noisy_matmul": (("fp", "mxu", "vmem"),
                         lambda m, k: matmul_rt(k, a, b, noise, mode=m),
                         lambda m, k: matmul(a, b, noise, mode=m, k_noise=k),
                         lambda m, k: matmul_plain(a, b, noise, mode=m, k_noise=k),
                         TF32_ROW_TOL),
    }


def _attention_case(q, k, v, noise, **kw):
    """(modes, runtime-k call, static-k call, plain call, output tolerance)
    of the attention kernel on one input set."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_plain, flash_attention_rt)
    from repro_torch.kernels.flash_attention.ref import TF32_ROW_TOL

    return (("fp", "mxu", "vmem"),
            lambda m, kn: flash_attention_rt(kn, q, k, v, noise, mode=m, **kw),
            lambda m, kn: flash_attention(q, k, v, noise, mode=m, k_noise=kn,
                                          **kw),
            lambda m, kn: flash_attention_plain(q, k, v, noise, mode=m,
                                                k_noise=kn, **kw),
            TF32_ROW_TOL)


def _check_cases(cases, ks, failures, max_err, full: bool) -> None:
    """Hold every kernel, mode and k against the plain version; with
    ``full`` also the K_MAX clamp and runtime k == static k."""
    import torch

    from repro_torch.kernels import noise_slots as ns

    for name, (modes, rt, static, plain, out_tol) in cases.items():
        worst = 0.0
        for mode in modes:
            for k in ks:
                got = rt(mode, k)
                want = plain(mode, ns.clip_k(k))
                torch.cuda.synchronize()
                got_t = got if isinstance(got, tuple) else (None, got)
                want_t = want if isinstance(want, tuple) else (None, want)
                what = f"{name}/{mode}/k={k}"
                if got_t[0] is not None:
                    worst = max(worst, _close(got_t[0], want_t[0],
                                              what + " out", failures,
                                              tol=out_tol))
                worst = max(worst, _close(got_t[1], want_t[1],
                                          what + " nacc", failures,
                                          tol="tf32" if mode == "mxu"
                                          else "exact"))
            if full:
                _equal(rt(mode, ns.K_MAX + 7), rt(mode, ns.K_MAX),
                       f"{name}/{mode} clamp at K_MAX", failures)
                _equal(rt(mode, STATIC_CHECK_K), static(mode, STATIC_CHECK_K),
                       f"{name}/{mode} runtime k vs static k={STATIC_CHECK_K}",
                       failures)
        torch.cuda.synchronize()
        key = name.split(" ")[0]
        max_err[key] = max(max_err.get(key, 0.0), worst)
        print(f"{name}: modes {', '.join(modes)} x k in {list(ks)}: "
              f"max|kernel - plain| = {worst:.3g}"
              + (f"; clamp and runtime==static(k={STATIC_CHECK_K}) checked"
                 if full else ""), flush=True)


def main_inputs() -> dict:
    """The main path's inputs, as its regions make them on the card."""
    from repro_torch.kernels.region import pallas_region

    vals, cols, x = pallas_region("spmxv", n=MAIN_SPMXV_N,
                                  nnz_per_row=16).args_for_rt("fp")
    a, b, noise = pallas_region("matmul", n=MAIN_MATMUL_N).args_for_rt("fp")
    q, k, v, _ = pallas_region("attention",
                               **MAIN_ATTENTION).args_for_rt("fp")
    return {"vals": vals, "cols": cols, "x": x, "a": a, "b": b,
            "noise": noise, "q": q, "k": k, "v": v}


def _attention_inputs(dev, B, H, KH, S, hd, dtype, seed):
    import numpy as np

    from repro_torch.convert import to_torch

    rs = np.random.RandomState(seed)
    arrays = (rs.standard_normal((B, H, S, hd)), rs.standard_normal(
        (B, KH, S, hd)), rs.standard_normal((B, KH, S, hd)))
    return tuple(t.to(dtype) for t in
                 to_torch([a.astype(np.float32) for a in arrays], dev))


def _bf16_control(name, rt, plain, operands, row_tol, label,
                  failures) -> None:
    """The per-row output check of kernel ``name`` must refuse what a
    kernel with bf16 operands would give: the TF32 kernel (``rt``) fed
    ``operands`` rounded to bf16, held against the plain version on the
    unrounded inputs."""
    from repro_torch.kernels.flash_attention.ref import row_excess

    want = plain(*operands)[0]
    tf32 = row_excess(rt(*operands)[0], want, row_tol)
    ctl = row_excess(rt(*(t.bfloat16().float() for t in operands))[0], want,
                     row_tol)
    print(f"{name} ({label}): per-row excess (<= 1 passes): TF32 kernel "
          f"{tf32:.3g}, bf16-operand control {ctl:.3g}", flush=True)
    if ctl <= 1:
        failures.append(f"{name} ({label}): the per-row check passes a "
                        f"bf16-operand control (excess {ctl:.3g})")


def _attention_control(q, k, v, noise, label, failures) -> None:
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attention_rt)
    from repro_torch.kernels.flash_attention.ref import TF32_ROW_TOL

    _bf16_control("flash_attention",
                  lambda *qkv: flash_attention_rt(0, *qkv, noise),
                  lambda *qkv: flash_attention_plain(*qkv, noise),
                  (q, k, v), TF32_ROW_TOL, label, failures)


def _matmul_control(a, b, noise, label, failures) -> None:
    from repro_torch.kernels.noisy_matmul.kernel import matmul_plain, matmul_rt
    from repro_torch.kernels.noisy_matmul.ref import TF32_ROW_TOL

    _bf16_control("noisy_matmul", lambda *ab: matmul_rt(0, *ab, noise),
                  lambda *ab: matmul_plain(*ab, noise), (a, b), TF32_ROW_TOL,
                  label, failures)


FUSED_PROBE_CTAS = (1, 31, 33, 64, MAIN_PROBE_STEPS)
# (rows, L): 500 and 33 CTAs (one 128-row block each), a last chunk of 20
# and of 1, in the ring's three stages (L=16) and two (L=112), and in the
# register path (L=128)
FUSED_SPMV = ((128 * 500, 16), (128 * 33, 16), (128 * 40, 112), (128 * 40, 128))
FUSED_K = 5
BACK_TO_BACK = 200


def _check_fused(main: dict, failures: list) -> None:
    """The one-launch reduction of the probe and spmv (``reduce_fused`` in
    ``csrc/noise_slots.cuh``): nacc bitwise equal to the plain versions
    (mxu to TF32) at CTA counts that fill, split and leave partial chunks;
    200 calls back to back without a synchronize; two streams at once, each
    with its own inputs; runtime k bitwise equal to static k at the main
    probe size; every workspace counter 0 afterwards."""
    import numpy as np
    import torch

    from repro_torch.convert import to_torch
    from repro_torch.kernels import noise_slots as ns
    from repro_torch.kernels.noise_probes.kernel import (probe, probe_plain,
                                                         probe_rt)
    from repro_torch.kernels.spmv_ell.kernel import (spmv_ell, spmv_ell_plain,
                                                     spmv_ell_rt)
    from repro_torch.kernels.spmv_ell.ref import make_band_ell

    noise = main["noise"]
    for n_steps in FUSED_PROBE_CTAS:
        for mode in ("fp", "vmem", "mxu"):
            got = probe_rt(FUSED_K, noise, mode=mode, n_steps=n_steps)
            want = probe_plain(noise, mode=mode, k_noise=FUSED_K,
                               n_steps=n_steps)
            torch.cuda.synchronize()
            what = f"fused probe {n_steps} CTAs {mode}"
            if mode == "mxu":
                _close(got, want, what, failures, tol="tf32")
            else:
                _equal(got, want, what, failures)
    for mode in ("fp", "vmem", "mxu"):
        _equal(probe_rt(STATIC_CHECK_K, noise, mode=mode,
                        n_steps=MAIN_PROBE_STEPS),
               probe(noise, mode=mode, k_noise=STATIC_CHECK_K,
                     n_steps=MAIN_PROBE_STEPS),
               f"fused probe {MAIN_PROBE_STEPS} CTAs {mode} runtime k vs "
               f"static k={STATIC_CHECK_K}", failures)
    dev = noise.device
    spmv_in = {}
    for n, L in FUSED_SPMV:
        vals, cols = make_band_ell(n, L, 0.5, seed=n + L)
        x = np.random.RandomState(n + 1).standard_normal(n).astype(np.float32)
        spmv_in[n, L] = to_torch((vals, cols, x), dev)
        for mode in ("fp", "vmem"):
            got = spmv_ell_rt(FUSED_K, *spmv_in[n, L], mode=mode)
            want = spmv_ell_plain(*spmv_in[n, L], mode=mode, k_noise=FUSED_K)
            torch.cuda.synchronize()
            what = f"fused spmv n={n} L={L} ({n // 128} CTAs) {mode}"
            _equal(got[1], want[1], what + " nacc", failures)
            _close(got[0], want[0], what + " y", failures)
    for mode in ("fp", "vmem"):   # the register path's static build
        _equal(spmv_ell_rt(STATIC_CHECK_K, *spmv_in[FUSED_SPMV[-1]], mode=mode),
               spmv_ell(*spmv_in[FUSED_SPMV[-1]], mode=mode,
                        k_noise=STATIC_CHECK_K),
               f"fused spmv L=128 {mode} runtime k vs static k="
               f"{STATIC_CHECK_K}", failures)

    # back to back: no synchronize between the calls
    n_spmv = FUSED_SPMV[0]
    calls = {
        f"probe {MAIN_PROBE_STEPS} CTAs vmem": (
            lambda: probe_rt(FUSED_K, noise, mode="vmem",
                             n_steps=MAIN_PROBE_STEPS),
            probe_plain(noise, mode="vmem", k_noise=FUSED_K,
                        n_steps=MAIN_PROBE_STEPS)),
        f"spmv (n, L)={n_spmv} vmem": (
            lambda: spmv_ell_rt(FUSED_K, *spmv_in[n_spmv], mode="vmem")[1],
            spmv_ell_plain(*spmv_in[n_spmv], mode="vmem",
                           k_noise=FUSED_K)[1]),
    }
    for what, (call, want) in calls.items():
        torch.cuda.synchronize()
        outs = [call() for _ in range(BACK_TO_BACK)]
        torch.cuda.synchronize()
        bad = sum(not torch.equal(o, want) for o in outs)
        if bad:
            failures.append(f"fused {what}: {bad} of {BACK_TO_BACK} "
                            f"back-to-back calls differ from the plain "
                            f"version")
    # two streams at once, each with its own inputs
    noise_b = noise.flip(0).contiguous()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    wants = (probe_plain(noise, mode="vmem", k_noise=FUSED_K,
                         n_steps=MAIN_PROBE_STEPS),
             probe_plain(noise_b, mode="vmem", k_noise=FUSED_K,
                         n_steps=MAIN_PROBE_STEPS))
    spmv_wants = tuple(spmv_ell_plain(*spmv_in[FUSED_SPMV[i]], mode="fp",
                                      k_noise=FUSED_K) for i in range(2))
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(BACK_TO_BACK // 4):
        for i, (st, nz) in enumerate(zip(streams, (noise, noise_b))):
            with torch.cuda.stream(st):
                outs[i].append((probe_rt(FUSED_K, nz, mode="vmem",
                                         n_steps=MAIN_PROBE_STEPS),
                                spmv_ell_rt(FUSED_K,
                                            *spmv_in[FUSED_SPMV[i]],
                                            mode="fp")))
    torch.cuda.synchronize()
    for i in range(2):
        bad = sum(not (torch.equal(p, wants[i])
                       and torch.equal(sp[1], spmv_wants[i][1]))
                  for p, sp in outs[i])
        if bad:
            failures.append(f"fused, stream {i}: {bad} of {len(outs[i])} "
                            f"probe + spmv calls differ from the plain "
                            f"versions")
    left = {f"{dev_}/{st:#x}": int(ws.counters.abs().sum())
            for (dev_, st), ws in ns.WORKSPACES.items()}
    if any(left.values()):
        failures.append(f"workspace counters not 0 after the phase: {left}")
    print(f"fused reduction: probe at {list(FUSED_PROBE_CTAS)} CTAs and spmv "
          f"at (CTAs, L) {[(n // 128, L) for n, L in FUSED_SPMV]} against "
          f"the plain versions (fp, vmem bitwise; mxu TF32), runtime == "
          f"static k at {MAIN_PROBE_STEPS} probe steps and spmv L=128, "
          f"{BACK_TO_BACK} back-to-back calls, two streams; {len(left)} "
          f"workspaces, counters {left}", flush=True)


def _loop_case(kernel, run, plain, *args, **kw):
    """(kernel, call(mode, k, static), plain(mode, k)) of one loop region
    on ``args``, with the modes' carries on the args' device."""
    from repro_torch.core.loopnoise import loop_carry

    dev = args[0].device

    def carry(mode):
        return None if mode == "none" else loop_carry(mode, dev)

    return (kernel,
            lambda m, k, static: run(*args, mode=m, k=k, carry=carry(m),
                                     static=static, **kw),
            lambda m, k: plain(*args, mode=m, k=k, carry=carry(m), **kw))


def _loop_cases(dev) -> dict:
    """label -> ``_loop_case`` of every loop region at moderate sizes: one
    iteration a warp at most, odd chunks and row widths."""
    import numpy as np
    import torch

    from repro_torch.convert import to_torch
    from repro_torch.core.loopnoise import chase_table
    from repro_torch.kernels.loop_regions import kernel as lk
    from repro_torch.kernels.loop_regions import ref as lref
    from repro_torch.kernels.spmv_ell.ref import make_band_ell

    rs = np.random.RandomState(7)

    def f32(*shape):
        return to_torch((rs.standard_normal(shape).astype(np.float32),),
                        dev)[0]

    table = chase_table(torch.from_numpy(
        rs.permutation(1 << 16).astype(np.int64))).to(torch.int32).to(dev)
    idx0 = torch.tensor([5], dtype=torch.int32, device=dev)
    spmv = {}
    for n, L in ((1 << 14, 16), (2000, 12), (1000, 5)):
        vals, cols = make_band_ell(n, L, 0.5, seed=n)
        x = rs.standard_normal(n).astype(np.float32)
        spmv[n] = (*to_torch((vals, cols, x), dev),
                   torch.zeros(n, dtype=torch.float32, device=dev))
    xs = to_torch((np.linspace(0.1, 0.9, 1000).astype(np.float32),), dev)[0]
    a32, b32 = f32(32, 32), f32(32, 32)
    return {
        "stream n=2^16 chunk 512": _loop_case(
            "stream_triad", lk.stream_triad, lref.stream_triad_plain,
            f32(1 << 16), f32(1 << 16), f32(1 << 16), chunk=512),
        "stream n=3000 chunk 100": _loop_case(
            "stream_triad", lk.stream_triad, lref.stream_triad_plain,
            f32(3000), f32(3000), f32(3000), chunk=100),
        "lat_mem_rd 2^16 table, 64 x 8 hops": _loop_case(
            "lat_mem_rd", lk.lat_mem_rd, lref.lat_mem_rd_plain, table, idx0,
            n_iter=64, hops=8),
        "haccmk width 1000, 200 iterations": _loop_case(
            "haccmk", lk.haccmk, lref.haccmk_plain, xs, n_iter=200),
        "spmxv n=2^14 L=16 q=0.5": _loop_case(
            "spmxv", lk.spmxv, lref.spmxv_plain, *spmv[1 << 14],
            rows_per_iter=64),
        "spmxv n=2000 L=12 q=0.5": _loop_case(
            "spmxv", lk.spmxv, lref.spmxv_plain, *spmv[2000],
            rows_per_iter=64),
        "spmxv n=1000 L=5 q=0.5": _loop_case(
            "spmxv", lk.spmxv, lref.spmxv_plain, *spmv[1000],
            rows_per_iter=64),
        "matmul_O0 n=32": _loop_case(
            "matmul_O0", lk.matmul_o0, lref.matmul_o0_plain, a32, b32,
            torch.zeros((1, 32), dtype=torch.float32, device=dev),
            n_iter=128),
        "matmul_O3 n=32": _loop_case(
            "matmul_O3", lk.matmul_o3, lref.matmul_o3_plain, a32, b32,
            n_iter=512),
    }


# HACCmk's iterations in the main-shape check (the main path runs 60,000;
# every thread runs every iteration, so the width sets the grouping)
CHECK_HACC_ITERS = 1000


def _loop_main_cases() -> dict:
    """label -> ``_loop_case`` of every loop region on the main path's own
    inputs (``repro_torch.bench.kernels``, phase 4's shapes): STREAM and
    SPMXV walk 15.5 and 7.8 iterations a warp, grid-stride, with a last
    round in which only some warps run; HACCmk at its full width."""
    from repro_torch.bench.kernels import (haccmk_region, lat_mem_rd_region,
                                           matmul_region, spmxv_region,
                                           stream_region)
    from repro_torch.kernels.loop_regions import kernel as lk
    from repro_torch.kernels.loop_regions import ref as lref

    def base(region):
        return region.args_for("", 0)

    n = MAIN_MM_N
    return {
        "stream n=2^25 chunk 512": _loop_case(
            "stream_triad", lk.stream_triad, lref.stream_triad_plain,
            *base(stream_region(n=MAIN_STREAM_N)), chunk=512),
        "lat_mem_rd 2^26 table, 1024 x 8 hops": _loop_case(
            "lat_mem_rd", lk.lat_mem_rd, lref.lat_mem_rd_plain,
            *base(lat_mem_rd_region(**MAIN_LAT)), n_iter=MAIN_LAT["n_iter"],
            hops=MAIN_LAT["hops_per_iter"]),
        f"haccmk width {MAIN_HACC['width']}, {CHECK_HACC_ITERS} iterations":
            _loop_case("haccmk", lk.haccmk, lref.haccmk_plain,
                       *base(haccmk_region(width=MAIN_HACC["width"])),
                       n_iter=CHECK_HACC_ITERS),
        "spmxv n=2^21 L=16 q=0.5": _loop_case(
            "spmxv", lk.spmxv, lref.spmxv_plain,
            *base(spmxv_region(n=MAIN_SPMXV_N, q=0.5)), rows_per_iter=64),
        f"matmul_O0 n={n}": _loop_case(
            "matmul_O0", lk.matmul_o0, lref.matmul_o0_plain,
            *base(matmul_region(n=n)), n_iter=32 * n // lref.UNROLL_O0),
        f"matmul_O3 n={n}": _loop_case(
            "matmul_O3", lk.matmul_o3, lref.matmul_o3_plain,
            *base(matmul_region(n=n, optimized=True)), n_iter=16 * n),
    }


def _o3_edge_cases(dev) -> dict:
    """label -> ``_loop_case`` of matmul O3 at ``CHECK_O3_SHAPES``, on
    standard normal a and b from ``RandomState(n)``."""
    import numpy as np

    from repro_torch.convert import to_torch
    from repro_torch.kernels.loop_regions import kernel as lk
    from repro_torch.kernels.loop_regions import ref as lref

    cases = {}
    for n, n_iter in CHECK_O3_SHAPES:
        rs = np.random.RandomState(n)
        a, b = to_torch(tuple(rs.standard_normal((n, n)).astype(np.float32)
                              for _ in range(2)), dev)
        cases[f"matmul_O3 n={n}, {n_iter} iterations"] = _loop_case(
            "matmul_O3", lk.matmul_o3, lref.matmul_o3_plain, a, b,
            n_iter=n_iter)
    return cases


def _check_loops(cases: dict, ks, failures: list, max_err: dict) -> None:
    """Every loop region x mode x k in ``ks`` against its plain version
    (outputs and aux bitwise), outputs unchanged across k, runtime k ==
    static k."""
    import torch

    for label, (kernel, run, plain) in cases.items():
        t0 = time.perf_counter()
        base = run("none", 0, False)[0]
        worst = _max_err(base, plain("none", 0)[0])
        _equal(base, plain("none", 0)[0], f"{label} none out", failures)
        for mode in LOOP_MODES:
            for k in ks:
                got, want = run(mode, k, False), plain(mode, k)
                torch.cuda.synchronize()
                what = f"{label} {mode} k={k}"
                worst = max(worst, _max_err(got[0], want[0]),
                            _max_err(got[1], want[1]))
                _equal(got, want, what + " (out, aux) vs plain", failures)
                _equal(got[0], base, what + " out vs k=0", failures)
            _equal(run(mode, STATIC_CHECK_K, False),
                   run(mode, STATIC_CHECK_K, True),
                   f"{label} {mode} runtime k vs static k={STATIC_CHECK_K}",
                   failures)
        max_err[kernel] = max(max_err.get(kernel, 0.0), worst)
        print(f"loop {label}: none + {', '.join(LOOP_MODES)} x k in "
              f"{list(ks)}: out and aux vs plain, out across k, "
              f"runtime == static k={STATIC_CHECK_K}; max|kernel - plain| = "
              f"{worst:.3g} ({time.perf_counter() - t0:.1f} s)", flush=True)


def _decan_targets(n_iter_replicated: int, n_iter_liv: int,
                   seed=None) -> dict:
    """label -> DecanTarget of every DECAN loop at phase 4's shapes; token
    and scatter_dep at ``n_iter_replicated`` iterations, Livermore at
    ``n_iter_liv`` (the stream scenarios at their own; None: Livermore at
    each of CHECK_LIV_SHAPES, labelled by it); the reference's inputs or,
    with ``seed``, seeded random ones."""
    from repro_torch.bench.kernels import livermore_target, table3_target
    from repro_torch.bench.studies import T3_SCENARIOS
    from repro_torch.kernels.decan_loops.ref import CHUNK

    out = {}
    for name, (kind, depth) in T3_SCENARIOS.items():
        stream = kind == "stream"
        out[f"t3 {name}"] = table3_target(
            f"t3_{name}", kind, depth,
            MAIN_T3["n"] // CHUNK if stream else n_iter_replicated,
            n=MAIN_T3["n"], width=None if stream else MAIN_T3["width"],
            seed=seed)
    if n_iter_liv is not None:
        out["livermore"] = livermore_target(n_iter_liv, n=MAIN_LIV["n"],
                                            width=MAIN_LIV["width"],
                                            seed=seed)
        return out
    for n, n_iter, _ in CHECK_LIV_SHAPES:
        out[f"livermore n={n} x {n_iter}"] = livermore_target(
            n_iter, n=n, width=MAIN_LIV["width"], seed=seed)
    return out


def _check_decan(failures: list, max_err: dict) -> None:
    """Every DECAN variant (3 x 4 scenarios + Livermore x 3) against its
    plain version at phase 4's shapes (token and scatter_dep at
    CHECK_DECAN_ITERS iterations, Livermore at each of CHECK_LIV_SHAPES),
    on seeded random inputs, bitwise: the output and, for the stream
    scenarios, the whole triad buffer; the reference variant under every
    loop mode at k in DECAN_CHECK_KS (Livermore: its shape's ks; run-time
    k) against its plain version, out and aux bitwise, out unchanged by the
    noise; run-time k == static k at k=24 (Table 3's compute-bound loop,
    Livermore but at the main path's shape)."""
    import torch

    from repro_torch.bench.studies import T3_SCENARIOS
    from repro_torch.core.decan import VARIANTS
    from repro_torch.core.loopnoise import loop_carry, make_loop_modes
    from repro_torch.kernels.decan_loops import kernel as dk
    from repro_torch.kernels.decan_loops import ref as dref

    modes = make_loop_modes()
    targets = _decan_targets(CHECK_DECAN_ITERS, None, seed=CHECK_DECAN_SEED)
    liv_ks = {f"livermore n={n} x {n_iter}": ks
              for n, n_iter, ks in CHECK_LIV_SHAPES}
    main_liv = f"livermore n={MAIN_LIV['n']} x {MAIN_LIV['n_iter']}"
    for label, target in targets.items():
        t0 = time.perf_counter()
        args = target.args_for()
        liv = label in liv_ks
        kernel = "decan_livermore" if liv else "decan_table3"
        ks = liv_ks.get(label, DECAN_CHECK_KS)
        stream = label in ("t3 data-bound", "t3 full-overlap")
        worst = 0.0
        for vname, (fp, ls) in VARIANTS.items():
            got = target.build(fp, ls)(*args)
            want = target.build_plain(fp, ls)(*args)
            worst = max(worst, _max_err(got, want))
            _equal(got, want, f"decan {label} variant {vname} vs plain",
                   failures)
            if stream:     # the triad buffer, whole (from c: the reference's)
                kw = {"kind": "stream", "depth": T3_SCENARIOS[label[3:]][1],
                      "n_iter": target.n_iter, "fp": fp, "ls": ls}
                cout, cplain = args[2].clone(), args[2].clone()
                dk.table3(*args, cout=cout, **kw)
                dref.table3_plain(*args, cout=cplain, **kw)
                torch.cuda.synchronize()
                worst = max(worst, _max_err(cout, cplain))
                _equal(cout, cplain, f"decan {label} variant {vname} triad "
                       "buffer vs plain", failures)
                if ls and torch.equal(cout, args[2]):
                    failures.append(f"decan {label} {vname}: the triad "
                                    "wrote nothing")
        clean = target.build(True, True)(*args)
        for mode in LOOP_MODES:
            carry = loop_carry(mode, target.device)
            for k in ks:
                got = target.build_noisy(modes[mode], k, static=False)(
                    *args, carry)
                want = target.build_noisy(modes[mode], k, plain=True)(
                    *args, carry)
                torch.cuda.synchronize()
                worst = max(worst, _max_err(got[0], want[0]),
                            _max_err(got[1], want[1]))
                what = f"decan {label} {mode} k={k}"
                _equal(got, want, what + " (out, aux) vs plain", failures)
                _equal(got[0], clean, what + " out vs no noise", failures)
            if label == "t3 compute-bound" or liv and label != main_liv:
                _equal(target.build_noisy(modes[mode], STATIC_CHECK_K,
                                          static=False)(*args, carry),
                       target.build_noisy(modes[mode], STATIC_CHECK_K)(
                           *args, carry),
                       f"decan {label} {mode} runtime k vs static "
                       f"k={STATIC_CHECK_K}", failures)
        max_err[kernel] = max(max_err.get(kernel, 0.0), worst)
        print(f"decan {label}: variants ref/fp/ls and ref x "
              f"{', '.join(LOOP_MODES)} x k in {list(ks)} vs "
              f"plain; max|kernel - plain| = {worst:.3g} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _graph_states() -> dict:
    """mode -> (NoiseMode, state) of every graph-level mode on the card at
    the card's scale (``core.noise.CARD_SCALE``), states from seed 0."""
    import torch

    from repro_torch.core.noise import make_modes

    return {name: (mode, mode.make_state(torch.Generator().manual_seed(0)))
            for name, mode in make_modes(device="cuda").items()}


def _check_graph(failures: list, max_err: dict) -> None:
    """Every graph-level mode's kernel at k in GRAPH_CHECK_KS, static
    (``apply``) and run-time (``apply_rt``), on the card's states: the aux
    and the new state bitwise equal to the plain version's; static k equal
    to run-time k for k >= 1; the input state unchanged."""
    import torch

    t0 = time.perf_counter()
    # the ici modes' no-mesh branch: fp_add32's kernel, or torch.sum (no
    # kernel: held against itself, as a check that it runs)
    kernel_of = {"ici_allreduce": "graph_fp_add32", "ici_allgather": None,
                 "ici_a2a": None}
    states = _graph_states()
    for name, (mode, state) in states.items():
        kernel = kernel_of.get(name, f"graph_{name}")
        before = {key: (tuple(t.clone() for t in v) if isinstance(v, tuple)
                        else v.clone()) for key, v in state.items()}
        worst = 0.0
        for k in GRAPH_CHECK_KS:
            for static, apply in ((True, mode.apply), (False, mode.apply_rt)):
                got = apply(state, k)
                want = apply(state, k, plain=True)
                torch.cuda.synchronize()
                worst = max(worst, _max_err(got[0], want[0]))
                what = f"graph {name} {'static' if static else 'runtime'} k={k}"
                _equal(got[0], want[0], what + " aux vs plain", failures)
                for key in state:
                    _equal(got[1][key], want[1][key],
                           f"{what} state[{key!r}] vs plain", failures)
            if k:
                _equal(mode.apply(state, k)[0], mode.apply_rt(state, k)[0],
                       f"graph {name} static vs runtime k={k}", failures)
        for key, v in before.items():
            _equal(state[key], v, f"graph {name} input state[{key!r}] kept",
                   failures)
        if kernel is not None:
            max_err[kernel] = max(max_err.get(kernel, 0.0), worst)
    print(f"graph modes: {', '.join(states)} x k in "
          f"{list(GRAPH_CHECK_KS)}, static and runtime, aux and state vs "
          f"plain ({time.perf_counter() - t0:.1f} s)", flush=True)


def _mxu_cs(dev) -> dict:
    """phase 3's c of mxu_fma128 besides the state's identity: a seeded
    permutation that is not its own transpose, and a seeded random c."""
    import torch

    g = torch.Generator().manual_seed(CHECK_DECAN_SEED)
    perm = torch.randperm(128, generator=g)
    p = torch.zeros(128, 128)
    p[torch.arange(128), perm] = 1.0
    if torch.equal(p, p.T):
        raise RuntimeError("phase 3's permutation is its own transpose")
    rand = torch.randn(128, 128, generator=g) / 128 ** 0.5
    return {"permutation": p.to(torch.bfloat16).to(dev),
            "random": rand.to(torch.bfloat16).to(dev)}


def _check_graph_emitters(failures: list, max_err: dict) -> None:
    """The mxu and hbm_stream emitters at their edges: mxu_fma128 at the
    state's m with c = I (its state), a permutation and a random c, static
    and run-time k in GRAPH_CHECK_KS (I and the permutation bitwise; the
    random c's m within MXU_RANDOM_C_TOL a pattern of the largest element
    and its aux bitwise ``one_block_sum`` of the kernel's own m, the aux's
    order being the plain version's), run-time k = 24 bitwise static, and
    the audit's static k = K_LO build at the permutation bitwise; the
    hbm_stream tile at GRAPH_STREAM_TILES tile counts of the state's
    buffer, run-time k at the edges of the ring bitwise against the plain
    version, static k in GRAPH_CHECK_KS too and static k = 24 bitwise
    run-time."""
    import torch

    from repro_torch.analysis import K_LO
    from repro_torch.kernels.graph_noise import kernel as gk
    from repro_torch.kernels.graph_noise.ref import (MXU_RANDOM_C_TOL,
                                                     STREAM_RING,
                                                     one_block_sum)
    from repro_torch.kernels.noise_slots import K_MAX

    t0 = time.perf_counter()
    states = _graph_states()
    m, eye = states["mxu_fma128"][1]["m"], states["mxu_fma128"][1]["c"]
    worst = {}
    cs = _mxu_cs(m.device)
    for name, c in {"identity": eye, **cs}.items():
        for k in GRAPH_CHECK_KS:
            for static in (True, False):
                what = (f"mxu_fma128 c={name} {'static' if static else 'runtime'}"
                        f" k={k}")
                aux, out = gk.mxu_fma128(m, c, k=k, static=static)
                paux, pout = gk.mxu_fma128(m, c, k=k, static=static, plain=True)
                torch.cuda.synchronize()
                err = _max_err(out, pout)
                worst[name] = max(worst.get(name, 0.0), err)
                if name != "random" or k == 0:
                    _equal((aux, out), (paux, pout), what + " vs plain", failures)
                    continue
                tol = k * MXU_RANDOM_C_TOL
                scale = float(pout.float().abs().max())
                if err > tol * scale:
                    failures.append(f"{what}: max|d| {err!r} > {tol!r} x "
                                    f"{scale!r}")
                _equal(aux, one_block_sum(out), what + " aux vs "
                       "one_block_sum of its own m", failures)
        _equal(gk.mxu_fma128(m, c, k=STATIC_CHECK_K, static=False),
               gk.mxu_fma128(m, c, k=STATIC_CHECK_K, static=True),
               f"mxu_fma128 c={name} runtime vs static k={STATIC_CHECK_K}",
               failures)
    c = cs["permutation"]
    _equal(gk.mxu_fma128(m, c, k=K_LO, static=True),
           gk.mxu_fma128(m, c, k=K_LO, static=True, plain=True),
           f"mxu_fma128 c=permutation static k={K_LO} vs plain", failures)
    max_err["graph_mxu_fma128"] = max(max_err.get("graph_mxu_fma128", 0.0),
                                      worst["identity"], worst["permutation"])
    buf, acc = states["hbm_stream"][1]["buf"], states["hbm_stream"][1]["acc"]
    tile = acc.shape[0]
    g = torch.Generator().manual_seed(CHECK_DECAN_SEED)
    acc = torch.randn(acc.shape, generator=g).to(acc.device)
    ks = (0, 1, STREAM_RING - 1, STREAM_RING, GRAPH_ROW_K, K_MAX + 3)
    for n in GRAPH_STREAM_TILES:
        b = buf[:n * tile]
        for k, static in ([(k, False) for k in ks]
                          + [(k, True) for k in GRAPH_CHECK_KS]):
            got = gk.hbm_stream(b, acc, k=k, tile_rows=tile, static=static)
            want = gk.hbm_stream(b, acc, k=k, tile_rows=tile, static=static,
                                 plain=True)
            torch.cuda.synchronize()
            _equal(got, want, f"hbm_stream {n} tiles {'static' if static else 'runtime'}"
                   f" k={k} vs plain", failures)
            max_err["graph_hbm_stream"] = max(
                max_err.get("graph_hbm_stream", 0.0), _max_err(got[1], want[1]))
        _equal(gk.hbm_stream(b, acc, k=STATIC_CHECK_K, tile_rows=tile,
                             static=False),
               gk.hbm_stream(b, acc, k=STATIC_CHECK_K, tile_rows=tile,
                             static=True),
               f"hbm_stream {n} tiles runtime vs static k={STATIC_CHECK_K}",
               failures)
    print(f"graph emitters at their edges: mxu_fma128 at c = I, a "
          f"permutation (bitwise) and a random c (m within "
          f"{MXU_RANDOM_C_TOL!r} x k of the largest element, the aux bitwise "
          f"one_block_sum of the kernel's m) x k in {list(GRAPH_CHECK_KS)}, "
          f"static and runtime, runtime = static at k={STATIC_CHECK_K}, "
          f"static k={K_LO} at the permutation; max|d| "
          f"{ {n: float(v) for n, v in worst.items()} }; hbm_stream at "
          f"{list(GRAPH_STREAM_TILES)} tiles x runtime k in {list(ks)} and "
          f"static k in {list(GRAPH_CHECK_KS)}, runtime = static at "
          f"k={STATIC_CHECK_K} ({time.perf_counter() - t0:.1f} s)", flush=True)


def _bitwise(a, b) -> bool:
    """Equal bit for bit, the signs of zero included."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _check_graph_fp_vmem(failures: list, max_err: dict) -> None:
    """The fp_add32 and vmem_ld emitters at their edges on seeded states:
    vmem_ld at GRAPH_VMEM_ROWS, fp_add32 at GRAPH_FP_ES (E = 128 through
    the ici fallback's c = v[:128] * 1e-3), run-time k in GRAPH_EDGE_KS and
    static k in GRAPH_EDGE_STATIC_KS, the aux and the new accumulators bit
    for bit against the plain version (the aux's sign of zero too), static
    equal to run-time at k >= 1."""
    import torch

    from repro_torch.kernels.graph_noise import kernel as gk

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(CHECK_DECAN_SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g).cuda()

    cases = {}
    for rows in GRAPH_VMEM_ROWS:
        buf, accs = randn(rows, 128), tuple(randn(8, 128) for _ in range(4))
        cases[f"vmem_ld rows={rows}"] = (
            "graph_vmem_ld", partial(gk.vmem_ld, buf, accs))
    for E in GRAPH_FP_ES:
        ici = E == 128
        rows = E // 128
        c = randn(4096) if ici else randn(rows, 128)
        accs = tuple(randn(rows, 128) for _ in range(4))
        path = "cluster" if gk.fp_cluster(E) else "ticket"
        cases[f"fp_add32 E={E} ({path})"] = (
            "graph_fp_add32", partial(gk.fp_add32, c, accs, ici=ici))
    for what, (kernel, fn) in cases.items():
        runs = ([(k, False) for k in GRAPH_EDGE_KS]
                + [(k, True) for k in GRAPH_EDGE_STATIC_KS])
        for k, static in runs:
            aux, new = fn(k=k, static=static)
            paux, pnew = fn(k=k, static=static, plain=True)
            torch.cuda.synchronize()
            label = f"{what} {'static' if static else 'runtime'} k={k}"
            if not _bitwise(aux, paux):
                failures.append(f"{label}: aux {float(aux)!r} against "
                                f"{float(paux)!r}, not bitwise")
            _equal(new, pnew, label + " accs vs plain", failures)
            max_err[kernel] = max(max_err.get(kernel, 0.0), max(
                _max_err(x, y) for x, y in zip(new, pnew)))
            if static and k:
                raux, rnew = fn(k=k, static=False)
                if not _bitwise(aux, raux):
                    failures.append(f"{label}: static aux differs from "
                                    "run-time")
                _equal(new, rnew, label + " static vs runtime", failures)
    print(f"graph emitters at their edges: {', '.join(cases)} x run-time k "
          f"in {list(GRAPH_EDGE_KS)} and static k in "
          f"{list(GRAPH_EDGE_STATIC_KS)}: aux and accumulators bitwise the "
          f"plain version's ({time.perf_counter() - t0:.1f} s)", flush=True)


def _check_gemma_attention(failures: list, max_err: dict) -> None:
    """The hd-256 kernel at gemma-2b's widths (8 heads on 1 KV head, seq
    4096, causal) in f32 and bf16, every mode at k in {0, 1}, and the
    bf16-operand control in f32."""
    import torch

    from repro_torch.kernels.region import pallas_region

    gq, gk, gv, noise = pallas_region(
        "attention", **GEMMA_ATTENTION).args_for_rt("fp")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in (gq, gk, gv))
        _check_cases({f"flash_attention_h256 (gemma-2b widths, {dtype})":
                      _attention_case(q, k, v, noise)}, (0, 1), failures,
                     max_err, full=False)
    _attention_control(gq, gk, gv, noise, "gemma-2b widths", failures)


def phase_check(main: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.convert import to_torch
    from repro_torch.kernels import noise_slots as ns
    from repro_torch.kernels.noisy_matmul.ref import default_noise_operand
    from repro_torch.kernels.spmv_ell.ref import make_band_ell

    banner("3. kernels against their plain versions")
    failures: list[str] = []
    max_err: dict = {}
    dev = torch.device("cuda")
    noise = default_noise_operand(dev)
    vals, cols = make_band_ell(16384, 16, 0.5, seed=0)
    x = np.random.RandomState(1).standard_normal(16384).astype(np.float32)
    vals, cols, x = to_torch((vals, cols, x), dev)
    a, b = to_torch((np.random.RandomState(0).standard_normal((512, 512))
                     .astype(np.float32),
                     np.random.RandomState(1).standard_normal((512, 512))
                     .astype(np.float32)), dev)
    print("moderate size: probe 64 steps, spmv n=16384 L=16 q=0.5, "
          "matmul n=512, attention B=2 H=8 KH=2 S=512")
    all_ks = CHECK_KS + (ns.K_MAX + 7,)
    _check_cases(_cases(noise, noise, 64, vals, cols, x, a, b), all_ks,
                 failures, max_err, full=True)
    _matmul_control(a, b, noise, "n=512", failures)
    h256_s = 0.0
    for i, (label, hd, dtype, seq, causal, window, static) in enumerate(
            ATTENTION_CASES):
        t0 = time.perf_counter()
        q, k, v = _attention_inputs(dev, 2, 8, 2, seq, hd,
                                    getattr(torch, dtype), seed=i)
        kern = "flash_attention_h256" if hd == 256 else "flash_attention"
        _check_cases({f"{kern} ({label})": _attention_case(
                         q, k, v, noise, causal=causal, window=window)},
                     all_ks, failures, max_err, full=static)
        if i == 0:
            _attention_control(q, k, v, noise, label, failures)
        if hd == 256:
            h256_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    _check_gemma_attention(failures, max_err)
    print(f"hd-256 attention checks: {h256_s:.1f} s at B=2 H=8 KH=2, "
          f"{time.perf_counter() - t0:.1f} s at gemma-2b's widths",
          flush=True)
    print(f"main path's shapes: probe {MAIN_PROBE_STEPS} steps, spmv "
          f"n={MAIN_SPMXV_N} L=16 q=0, matmul n={MAIN_MATMUL_N}, attention "
          f"{MAIN_ATTENTION}")
    main_cases = _cases(main["noise"], main["noise"], MAIN_PROBE_STEPS,
                        main["vals"], main["cols"], main["x"], main["a"],
                        main["b"])
    main_cases["flash_attention"] = _attention_case(
        main["q"], main["k"], main["v"], main["noise"])
    _check_cases(main_cases, (0, 1), failures, max_err, full=False)
    _attention_control(main["q"], main["k"], main["v"], main["noise"],
                       "main shape", failures)
    _matmul_control(main["a"], main["b"], main["noise"], f"n={MAIN_MATMUL_N}",
                    failures)
    _check_fused(main, failures)
    _check_loops(_loop_cases(dev), LOOP_CHECK_KS, failures, max_err)
    _check_loops(_loop_main_cases(), LOOP_MAIN_CHECK_KS, failures, max_err)
    _check_loops(_o3_edge_cases(dev), LOOP_MAIN_CHECK_KS, failures, max_err)
    _check_decan(failures, max_err)
    _check_graph(failures, max_err)
    _check_graph_emitters(failures, max_err)
    _check_graph_fp_vmem(failures, max_err)
    if failures:
        raise RuntimeError("kernel check failed:\n  " + "\n  ".join(failures))
    return max_err


def _payloads_ok(rep) -> None:
    for mode, res in rep.results.items():
        inj = res.injection
        if inj is None or inj.payload != inj.expected or not inj.expected:
            raise RuntimeError(f"{rep.region}/{mode}: payload check failed "
                               f"({inj})")
        fit = res.fit
        if not all(math.isfinite(v) for v in (fit.k1, fit.t0, fit.slope)):
            raise RuntimeError(f"{rep.region}/{mode}: non-finite fit {fit}")


@contextlib.contextmanager
def _cli_env():
    """The environment a user's shell gives a CLI (``PYTHONPATH`` holding
    the checkout's ``src``, for the worker processes it starts), restored
    afterwards with anything the CLI set (``calibrate run`` turns the
    synthetic clock on for its own sweeps)."""
    saved = dict(os.environ)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, saved.get("PYTHONPATH")) if p)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _run_cli(prog: str, main, argv: list) -> None:
    """``python -m PROG ARGV`` as a user runs it, through its ``main`` in
    this process (a process of its own costs seconds to reach the card);
    raises on a nonzero exit."""
    sys.stdout.flush()
    with _cli_env():
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            if not isinstance(e.code, int):
                print(e.code, flush=True)
    sys.stdout.flush()
    if rc:
        raise RuntimeError(f"python -m {prog} {' '.join(argv)}: exit {rc}")


def _fleet(*args) -> None:
    """``python -m repro_torch.fleet ARGS`` (``_run_cli``)."""
    from repro_torch.fleet.cli import main as fleet_cli

    _run_cli("repro_torch.fleet", fleet_cli, list(args))


def _bench(tmp: str, study: str, *extra) -> dict:
    """``python -m repro_torch.bench STUDY`` with a store directory
    (``_run_cli``; its launches count in this process's wrappers); prints
    the study's result."""
    from repro_torch.bench.studies import STUDIES
    from repro_torch.bench.studies import main as bench_main

    out = os.path.join(tmp, "bench_out")
    _run_cli("repro_torch.bench", bench_main,
             [study, "--store-dir", os.path.join(tmp, "bench_stores"),
              "--out", out, *extra])
    with open(os.path.join(out, f"{STUDIES[study][0]}.json")) as f:
        result = json.load(f)
    print(f"{study} result: {json.dumps(result)}", flush=True)
    return result


def _audit_records(store: str) -> int:
    """How many audit records a store holds (in either layout; every record
    written, superseded ones included)."""
    from repro_torch.core.segments import (SegmentStore, is_segmented,
                                           read_store_records)

    recs = (SegmentStore(store, readonly=True).load() if is_segmented(store)
            else read_store_records(store)[0])
    return sum(1 for rec in recs if rec.get("kind") == "audit")


def _in_process(seconds: dict, label: str, fn, argv: list) -> tuple:
    """Run a CLI ``main(argv)`` in this process as a user would run it
    (``repro_torch.fleet.cli.main`` or ``repro_torch.core.campaign._cli``),
    its output captured and echoed; adds its seconds to ``seconds[label]``.
    Returns (exit code, output)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = fn(argv)
    seconds[label] = seconds.get(label, 0.0) + time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="", flush=True)
    return code, out


def _segmented_checks(plan, path: str, seconds: dict) -> None:
    """A segmented fleet after its first run, in this process: the merge
    adopted one new segment per worker store and skipped none, ``fleet
    watch --once`` and ``fleet doctor`` exit 0 with every pair complete,
    and ``campaign compact`` leaves one sealed segment."""
    from repro_torch.core.campaign import _cli as campaign_cli
    from repro_torch.core.segments import manifest_status
    from repro_torch.fleet.cli import main as fleet_cli

    with open(plan.fleet_path()) as f:
        merge = json.load(f)["merge"]
    workers = [manifest_status(ws)["segments"] for ws in plan.worker_stores()]
    print(f"  merge: {merge.get('segments_new')} new segment(s), "
          f"{merge.get('segments_skipped')} skipped; worker stores' sealed "
          f"segments {workers}", flush=True)
    if workers != [1] * plan.shards or merge.get("segments_new") != \
            plan.shards or merge.get("segments_skipped") != 0:
        raise RuntimeError(f"{plan.name}: the merge did not adopt one new "
                           f"segment per worker store ({merge})")
    grid = len(plan.grid())
    code, out = _in_process(seconds, "watch", fleet_cli,
                            ["watch", "--plan", path, "--once"])
    if code or f"grid: {grid}/{grid} pair(s) done" not in out:
        raise RuntimeError(f"{plan.name}: fleet watch --once: exit {code}")
    code, _ = _in_process(seconds, "doctor", fleet_cli,
                          ["doctor", "--plan", path])
    if code:
        raise RuntimeError(f"{plan.name}: fleet doctor: exit {code}")
    code, _ = _in_process(seconds, "compact", campaign_cli,
                          ["compact", plan.store])
    ms = manifest_status(plan.store)
    if code or ms["segments"] != 1 or ms["orphans"]:
        raise RuntimeError(f"{plan.name}: compaction left {ms['segments']} "
                           f"sealed and {ms['orphans']} unsealed segment(s) "
                           f"(exit {code})")


def _explain_check(plan_path: str, report: dict, seconds: dict) -> None:
    """``fleet doctor --plan P --explain`` in this process: exit 0, and a
    decision path for every region whose label is the report's."""
    from repro_torch.fleet.cli import main as fleet_cli

    code, out = _in_process(seconds, "doctor_explain", fleet_cli,
                            ["doctor", "--plan", plan_path, "--explain"])
    if code:
        raise RuntimeError(f"fleet doctor --explain: exit {code}")
    section = out.split("== explain: decision path per region", 1)[-1]
    for region, rep in sorted(report.items()):
        want = rep["bottleneck"]["label"]
        m = re.search(rf"^  {re.escape(region)}: (\S+) \(confidence.*\n"
                      rf"(?:    .*\n)*?    path \[[^\]]*\]: .*\w\*",
                      section, re.M)
        if m is None or m.group(1) != want:
            raise RuntimeError(f"doctor --explain: {region}: "
                               f"{m.group(1) if m else 'no decision path'}"
                               f", the report says {want}")


def _fleet_plan_run(tmp: str, name: str, targets: list, shards: int,
                    kernels: Kernels, *launcher, store_format=None,
                    seconds=None) -> dict:
    """Save a plan, run it through the fleet CLI (its workers in
    subprocesses, or in this process with ``--in-process``; the default
    --audit gate audits every pair first), check its payloads and
    fits from the merged store and report, replay it with
    --expect-no-measure (it must audit and measure nothing), hold it to
    ``fleet audit --expect-clean`` (every pair intact), print its status;
    returns its report. A segmented plan (``store_format="segments"``) is
    also held to ``_segmented_checks`` before its replay, which then
    replays the compacted store; ``seconds`` collects the in-process
    calls' seconds."""
    from repro_torch.core.campaign import CampaignStore
    from repro_torch.fleet.cli import main as fleet_cli
    from repro_torch.fleet.plan import SweepPlan

    seconds = {} if seconds is None else seconds
    plan = SweepPlan(name=name, store=os.path.join(tmp, name, "store.jsonl"),
                     targets=targets, reps=2, shards=shards, backend="cuda",
                     store_format=store_format)
    path = plan.save(os.path.join(tmp, f"{name}.plan.json"))
    _fleet("run", "--plan", path, *launcher)
    audited = _audit_records(plan.store)
    if audited != len(plan.grid()):
        raise RuntimeError(f"{name}: the gate wrote {audited} audit records "
                           f"for {len(plan.grid())} pairs")
    if "--in-process" not in launcher:     # workers in processes of their own
        for ws in plan.worker_stores():
            kernels.add_worker(ws + ".stats.json")
    store = CampaignStore(plan.store, readonly=True)
    for key in plan.grid():
        pay = (store.done.get(key) or {}).get("payload") or {}
        if not pay.get("expected") or pay.get("payload") != pay["expected"]:
            raise RuntimeError(f"{name} {key}: payload check failed ({pay})")
    for (region, mode), ts in sorted(store.points.items()):
        print(f"  {region}/{mode} t(k) ms: "
              + ", ".join(f"{k}: {t * 1e3:.4f}" for k, t in sorted(ts.items())))
    with open(plan.report_path()) as f:
        report = json.load(f)
    for region, rep in report.items():
        for mode, row in rep["modes"].items():
            if not all(math.isfinite(row[f]) for f in
                       ("abs_raw", "t0_s", "slope_s_per_pattern")):
                raise RuntimeError(f"{region}/{mode}: non-finite fit {row}")
    if store_format == "segments":
        _segmented_checks(plan, path, seconds)
        audited = _audit_records(plan.store)
    _fleet("run", "--plan", path, "--resume", "--expect-no-measure")
    if _audit_records(plan.store) != audited:
        raise RuntimeError(f"{name}: the resume audited again")
    _fleet("audit", "--plan", path, "--expect-clean")
    if store_format != "segments":
        _fleet("status", "--plan", path)
        return report
    code, out = _in_process(seconds, "status", fleet_cli,
                            ["status", "--plan", path])
    canon = out.split("canonical store:", 1)[-1].split("\n")[1]
    if code or "segments: 1 sealed" not in canon \
            or "0 unsealed" not in canon:
        raise RuntimeError(f"{name}: status after the compacted replay "
                           f"(exit {code}): {canon.strip()}")
    return report


def main_targets() -> list:
    """Phase 4's main fleet plan: the four kernels at the main path's
    shapes (Qwen3-30B-A3B's attention widths at seq 4096), and gemma-2b's
    attention (hd 256, ``fa_kernel_h256``)."""
    from repro_torch.fleet.plan import TargetSpec

    fmv = ("fp", "mxu", "vmem")

    def attention(widths):
        return TargetSpec("pallas", fmv, {
            "kernel": "attention", "sizes": [widths["seq"]],
            **{k: v for k, v in widths.items() if k != "seq"}})

    return [
        attention(MAIN_ATTENTION),
        TargetSpec("pallas", fmv, {"kernel": "probe",
                                   "sizes": [MAIN_PROBE_STEPS]}),
        TargetSpec("pallas", ("fp", "vmem"), {
            "kernel": "spmxv", "sizes": [MAIN_SPMXV_N], "nnz_per_row": 16}),
        TargetSpec("pallas", fmv, {"kernel": "matmul",
                                   "sizes": [MAIN_MATMUL_N]}),
        attention(GEMMA_ATTENTION),
    ]


@contextlib.contextmanager
def _sweep_seconds(out: dict):
    """Add each (region, mode) sweep's wall seconds to ``out[region]``
    while the block runs (``Campaign.sweep_mode``: the sweeps of a fleet
    run in this process, its payload checks included; the audit gate's
    census before them is not)."""
    from repro_torch.core.campaign import Campaign

    orig = Campaign.sweep_mode

    def timed(self, target, mode):
        t0 = time.perf_counter()
        try:
            return orig(self, target, mode)
        finally:
            out[target.name] = (out.get(target.name, 0.0)
                                + time.perf_counter() - t0)

    Campaign.sweep_mode = timed
    try:
        yield out
    finally:
        Campaign.sweep_mode = orig


def _static_libs() -> set:
    """The static-k libraries built so far, by (source, mode, k[, variant])
    (their file names without the source hash)."""
    from repro_torch.kernels import _build

    return {os.path.basename(p)[len("librepro_"):].rsplit("_", 1)[0]
            for p in glob.glob(os.path.join(_build.BUILD_DIR,
                                            "librepro_*_m*_k*.so"))}


def drive(kernels: Kernels, counts: dict, seconds: dict, name: str, kernel,
          fn):
    """Drive one path with every count set to 0 just before it; read the
    counts just after (adding them to ``counts``), and fail unless it
    launched ``kernel`` (a name or a tuple of names). Prints the static
    builds the path made (each an ``nvcc`` run of seconds on its clock)."""
    kernels.reset()
    built = _static_libs()
    t0 = time.perf_counter()
    out = fn()
    seconds[name] = time.perf_counter() - t0
    path_counts = kernels.counts()
    for k, (n_cuda, n_plain) in path_counts.items():
        counts[k][0] += n_cuda
        counts[k][1] += n_plain
    new = sorted(_static_libs() - built)
    print(f"  ({name}: {seconds[name]:.1f} s; launches (kernel, plain): "
          f"{ {k: c for k, c in path_counts.items() if any(c)} }"
          + (f"; {len(new)} static build(s) phase 2 did not make: "
             f"{', '.join(new)}" if new else "") + ")", flush=True)
    for kern in (kernel,) if isinstance(kernel, str) else kernel:
        if path_counts[kern][0] <= 0:
            raise RuntimeError(f"{name}: the path never launched {kern}")
    return out


def phase_main(tmp: str, kernels: Kernels) -> dict:
    from repro_torch.fleet.executor import run_worker
    from repro_torch.fleet.plan import SweepPlan, TargetSpec
    from repro_torch.launch.probe import main as probe_main

    banner("4. main path")
    seconds, verdicts = {}, {}
    counts = {name: [0, 0] for name in kernels.rows}

    def timed(name, kernel, fn):
        return drive(kernels, counts, seconds, name, kernel, fn)

    print(f"== 4a. the main fleet plan: Qwen3-30B-A3B attention "
          f"{MAIN_ATTENTION}, probe {MAIN_PROBE_STEPS} steps, spmxv "
          f"n={MAIN_SPMXV_N} L=16 q=0, matmul n={MAIN_MATMUL_N}, gemma-2b "
          f"attention {GEMMA_ATTENTION}; one shard in the fleet's process, "
          f"audited at the gate; card before (SM clock, power, "
          f"temperature): {card_state()}", flush=True)
    with _sweep_seconds({}) as sweeps:
        report = timed("main_plan", ("flash_attention", "noise_probes",
                                     "spmv_ell", "noisy_matmul",
                                     "flash_attention_h256"),
                       lambda: _fleet_plan_run(tmp, "main_plan",
                                               main_targets(), 1, kernels,
                                               "--in-process"))
    print(f"  card after: {card_state()}; sweep seconds a region (its "
          f"three or two modes, payload checks included): "
          + json.dumps({k: round(v, 1) for k, v in sweeps.items()}),
          flush=True)
    added = {}      # the in-process store and doctor calls' seconds
    _explain_check(os.path.join(tmp, "main_plan.plan.json"), report, added)
    for region, rep in report.items():
        verdicts[region] = (rep["bottleneck"]["label"],
                            {m: row["abs_raw"] for m, row in
                             rep["modes"].items()},
                            {m: row["t0_s"] for m, row in
                             rep["modes"].items()})
    print("== 4b. attention family seq 256, 512 (default widths), two "
          "shards on one card, segmented stores", flush=True)
    timed("attention_family", "flash_attention", lambda: _fleet_plan_run(
        tmp, "attention_family",
        [TargetSpec("pallas", ("fp", "mxu", "vmem"),
                    {"kernel": "attention", "sizes": [256, 512]})],
        2, kernels, store_format="segments", seconds=added))
    print("in-process store and doctor calls (s): " + json.dumps(
        {k: round(v, 3) for k, v in added.items()}
        | {"total": round(sum(added.values()), 3)}), flush=True)

    cli = {
        "attention_1024": ["--pallas", "attention", "--pallas-n", "1024"],
        "spmxv_q0": ["--pallas", "spmxv", "--pallas-n", str(MAIN_SPMXV_N),
                     "--modes", "fp,vmem"],
        "matmul": ["--pallas", "matmul", "--pallas-n", str(MAIN_MATMUL_N)],
        "probe": ["--pallas", "probe", "--pallas-n", str(MAIN_PROBE_STEPS)],
    }
    stores = {name: os.path.join(tmp, f"{name}.jsonl")
              for name in (*cli, "spmxv_q1")}
    q1_plan = SweepPlan(name="spmxv_q1", store=stores["spmxv_q1"],
                        targets=[TargetSpec("pallas", ("fp", "vmem"), {
                            "kernel": "spmxv", "sizes": [MAIN_SPMXV_N],
                            "qs": [1.0], "nnz_per_row": 16})],
                        reps=3, backend="cuda")

    def run(name, expect_no_measure=False):
        if name == "spmxv_q1":
            return run_worker(q1_plan, expect_no_measure=expect_no_measure)
        return probe_main(cli[name] + ["--reps", "3", "--store", stores[name]]
                          + (["--expect-no-measure"] if expect_no_measure
                             else []))

    path_kernel = {"attention_1024": "flash_attention",
                   "spmxv_q0": "spmv_ell", "spmxv_q1": "spmv_ell",
                   "matmul": "noisy_matmul", "probe": "noise_probes"}
    for name, kernel in path_kernel.items():
        print(f"== 4{'c' if name == 'attention_1024' else 'd'}. {name}",
              flush=True)
        reports, _ = timed(name, kernel, lambda: run(name))
        for rep in reports.values():
            _payloads_ok(rep)
            verdicts[rep.region] = (rep.bottleneck.label, rep.absorptions(),
                                    {m: r.fit.t0 for m, r in
                                     rep.results.items()})

    # (study, its extra arguments, the kernels it must launch): table1
    # replays fig5's sweeps from the shared store and launches the graph
    # noise kernels (its cost a pattern); table4 is analytic
    graph = tuple(k for k in kernels.rows if k.startswith("graph_"))
    study_kernels = (
        ("fig7", (), ("spmxv",)),
        ("fig5", (), ("stream_triad", "lat_mem_rd", "haccmk")),
        ("fig4", ("--pallas",), ("matmul_O0", "matmul_O3", "noisy_matmul")),
        ("table3", (), ("decan_table3",)),
        ("fig6", (), ("decan_livermore",)),
        ("table1", (), graph),
        ("table4", (), ()),
    )
    for study, extra, kerns in study_kernels:
        print(f"== 4e. python -m repro_torch.bench {study} {' '.join(extra)}"
              f"; card before: {card_state()}", flush=True)
        timed(f"bench_{study}", kerns, lambda: _bench(tmp, study, *extra))
    print(f"== 4f. python -m repro_torch.fleet calibrate run; card: "
          f"{card_state()}", flush=True)
    calib_store = os.path.join(tmp, "calibrate", "calibrate.jsonl")
    _fleet("calibrate", "run", "--store", calib_store)

    banner("5. launches on the main path")
    for name, (n_cuda, n_plain) in counts.items():
        print(f"{name}: kernel {n_cuda} launches, plain version {n_plain}")
        if n_cuda <= 0:
            raise RuntimeError(f"{name}: the main path never launched it")
        if n_plain:
            raise RuntimeError(f"{name}: the main path took the plain version")

    banner("4g. every store replays with 0 measured")
    for name in path_kernel:
        run(name, expect_no_measure=True)
    for study, extra, _ in study_kernels:
        _bench(tmp, study, *extra, "--expect-no-measure")
    _fleet("calibrate", "run", "--store", calib_store, "--expect-no-measure")
    print("wall time per characterization (s): "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print("verdicts (label, Abs^raw per mode, t0 s per mode): "
          + json.dumps(verdicts))
    return {name: n_cuda for name, (n_cuda, _) in counts.items()}


def _attention_work(q, k, causal=True, window=0):
    """Bytes and operations of one attention call: q, k, v read and out
    written once; two products of 2*hd per (query, key) pair the mask
    keeps (key <= query when causal, query - key < window when set), not
    the masked half of each diagonal block the kernel also computes."""
    B, H, S, hd = q.shape
    pairs = sum((i + 1 if causal else S) - (max(0, i - window + 1)
                                              if window else 0)
                for i in range(S))
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return nbytes + 4 * 1024, 2 * 2 * hd * B * H * pairs


def _map_encode_us(a, n: int, iters: int = 10000) -> float:
    """Host microseconds of the two tensor-map encodes (A and B^T) that
    every matmul launch makes, the mean of ``iters`` pairs."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    fn = _build.runtime_lib().repro_matmul_map_us
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    fn.restype = ctypes.c_double
    bt = torch.empty_like(a)
    us = fn(a.data_ptr(), bt.data_ptr(), n, n, n, iters)
    if us < 0:
        raise RuntimeError("noisy_matmul: a tensor-map encode failed")
    print(f"noisy_matmul: two tensor-map encodes per launch take {us!r} us "
          f"on the host (mean of {iters})")
    return us


def _attention_row(name, q, k, v, noise) -> tuple:
    """Phase 6's row of an attention kernel (causal, k = 0, fp) on q, k, v:
    SDPA in f32 as the library call, and beside it SDPA with TF32 allowed
    and in bf16, each timed here."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attention_rt)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = _max_err(sdpa(q, k, v, is_causal=True, enable_gqa=True),
                       flash_attention_plain(q, k, v, noise)[0])
    fa_bytes, fa_ops = _attention_work(q, k)

    def tf32_sdpa():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    qh, kh, vh = (t.bfloat16() for t in (q, k, v))

    def bf16_sdpa():
        return sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)

    tf32_ms, tf32_dev = time_ms(tf32_sdpa), device_ms(tf32_sdpa)[0]
    bf16_ms, bf16_dev = time_ms(bf16_sdpa), device_ms(bf16_sdpa)[0]
    B, H, S, hd = q.shape
    return (name, f"{name} (B={B} H={H} KH={k.shape[1]} S={S} hd={hd})",
            lambda: flash_attention_rt(0, q, k, v, noise, mode="fp"),
            lambda: flash_attention_plain(q, k, v, noise, mode="fp",
                                          k_noise=0),
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
            fa_bytes, fa_ops, TF32_FLOPS,
            "scaled_dot_product_attention f32, is_causal, enable_gqa "
            f"(max|d| vs plain {lib_err:.3g}); beside it the same call "
            f"with TF32 allowed {tf32_ms!r} ms, {tf32_dev!r} ms on the "
            f"device (the like-for-like yardstick: TF32 products, as "
            f"the kernel's) and in bf16 {bf16_ms!r} ms, {bf16_dev!r} ms "
            f"on the device")


def phase_timing(main: dict, max_err: dict, launches: dict) -> list:
    import torch

    from repro_torch.kernels.noise_probes.kernel import probe_plain, probe_rt
    from repro_torch.kernels.noisy_matmul.kernel import matmul_plain, matmul_rt
    from repro_torch.kernels.region import pallas_region
    from repro_torch.kernels.spmv_ell.kernel import spmv_ell_plain, spmv_ell_rt

    banner("6. timings at the main path's shapes, k=0 (CUDA events, median "
           f"of {TIMING_REPS})")
    rows = []

    # spmv_ell, q=0 and q=1 (n=2^21, L=16), CSR @ x on the same matrix
    warnings.filterwarnings("ignore", message="Sparse")   # beta / invariants
    spmv_q1 = pallas_region("spmxv", n=MAIN_SPMXV_N, nnz_per_row=16,
                            q=1.0).args_for_rt("fp")
    for q, (vals, cols, x) in ((0, (main["vals"], main["cols"], main["x"])),
                               (1, spmv_q1)):
        R, L = vals.shape
        order = torch.argsort(cols, dim=1)
        csr = torch.sparse_csr_tensor(
            torch.arange(0, R * L + 1, L, device=vals.device,
                         dtype=torch.int64),
            torch.gather(cols, 1, order).flatten().long(),
            torch.gather(vals, 1, order).flatten(), size=(R, x.shape[0]))
        lib_err = _max_err(csr @ x, spmv_ell_plain(vals, cols, x)[0])
        rows.append((
            "spmv_ell", f"spmv_ell q={q}",
            lambda v=vals, c=cols, xx=x: spmv_ell_rt(0, v, c, xx, mode="fp"),
            lambda v=vals, c=cols, xx=x: spmv_ell_plain(v, c, xx, mode="fp",
                                                        k_noise=0),
            lambda m=csr, xx=x: m @ xx, 4 * (2 * R * L + x.shape[0] + R + 1024),
            2 * R * L, FP32_FLOPS,
            f"torch.sparse_csr_tensor @ x (max|d| vs plain {lib_err:.3g})"))

    # noisy_matmul, n=4096
    a, b, noise = main["a"], main["b"], main["noise"]
    n = MAIN_MATMUL_N

    def tf32_matmul():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    rows.append(("noisy_matmul", "noisy_matmul",
                 lambda: matmul_rt(0, a, b, noise, mode="fp"),
                 lambda: matmul_plain(a, b, noise, mode="fp", k_noise=0),
                 tf32_matmul, 4 * (3 * n * n + 1024), 2 * n ** 3, TF32_FLOPS,
                 "torch.matmul with TF32 allowed"))
    extra = {"noisy_matmul": {"map_encode_us": _map_encode_us(a, n)}}

    # noise_probes, 1056 steps
    pnoise = main["noise"]
    rows.append(("noise_probes", "noise_probes",
                 lambda: probe_rt(0, pnoise, mode="fp", n_steps=MAIN_PROBE_STEPS),
                 lambda: probe_plain(pnoise, mode="fp", k_noise=0,
                                     n_steps=MAIN_PROBE_STEPS),
                 None, 4 * (128 * 128 + 1024), 0, FP32_FLOPS, None))

    # flash_attention, Qwen3-30B-A3B widths, seq 4096, causal; and its
    # hd-256 kernel at gemma-2b's widths
    rows.append(_attention_row("flash_attention", main["q"], main["k"],
                               main["v"], noise))
    t0 = time.perf_counter()
    rows.append(_attention_row("flash_attention_h256", *pallas_region(
        "attention", **GEMMA_ATTENTION).args_for_rt("fp")))
    h256_s = time.perf_counter() - t0

    def all_rows():
        """The rows above, then the loop kernels' (built, and their slot
        costs timed, only after the rows above are timed)."""
        yield from rows
        loop_rows, loop_extra = _loop_rows()
        extra.update(loop_extra)
        yield from loop_rows
        new_rows, new_extra = _decan_graph_rows()
        extra.update(new_extra)
        yield from new_rows

    meta = Kernels().rows
    out = {}
    one_launch = []
    for (name, label, kern, plain, lib, nbytes, nops, peak,
         lib_what) in all_rows():
        t0 = time.perf_counter()
        kernel_ms = time_ms(kern)
        kernel_host_ms = host_ms(kern)
        dev_ms, per_kernel, n_kernels, dev_whole = device_ms(kern)
        # the loop regions' plain versions run their loops in Python (one
        # PyTorch call a step): a few calls are enough
        slow = name in LOOP_PLAIN_REPS
        plain_ms = time_ms(plain, reps=LOOP_PLAIN_REPS.get(name, TIMING_REPS),
                           warmup=1 if slow else 3)
        library_ms = time_ms(lib) if lib is not None else None
        lib_dev_ms = device_ms(lib)[0] if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        issue = {}
        if name in UNFUSED_FP32:
            t_issue = nops / FP32_ISSUE_OPS * 1e3
            issue = {"issue_bound_ms": max(t_bytes, t_issue),
                     "issue_bound_by": ("bytes" if t_bytes >= t_issue
                                        else "operations")}
        share = {"event": bound_ms / kernel_ms,
                 "device": bound_ms / dev_ms if dev_ms else None}
        vs_lib = {"event": kernel_ms / library_ms if library_ms else None,
                  "device": (dev_ms / lib_dev_ms
                             if dev_ms and lib_dev_ms else None)}
        print(f"{label}: kernel_ms={kernel_ms!r} (host clock with "
              f"synchronize: {kernel_host_ms!r}) plain_ms={plain_ms!r} "
              f"bound_ms={bound_ms!r} ({bound_by}; {nbytes} bytes, {nops} "
              f"operations) library_ms={library_ms!r}"
              + (f" [{lib_what}]" if lib_what else "")
              + f" launches on the main path={launches[name]}", flush=True)
        print(f"  device time per call (torch.profiler): {dev_ms!r} ms = "
              + ", ".join(f"{k} {v!r}" for k, v in per_kernel.items())
              + f"; library call on the device: {lib_dev_ms!r} ms; kernels "
              f"launched per call: {n_kernels!r}"
              + ("" if dev_whole else " (INCOMPLETE: the trace dropped "
                 "records in every window; each kernel is averaged over its "
                 "own records)"))
        print(f"  share of the bound (bound / time): {share}; kernel / "
              f"library call: {vs_lib}", flush=True)
        if issue:
            print(f"  FP32 issue-rate bound ({FP32_ISSUE_OPS:g} FADD/FMUL a "
                  f"second): {issue['issue_bound_ms']!r} ms "
                  f"({issue['issue_bound_by']}); device share "
                  f"{issue['issue_bound_ms'] / dev_ms if dev_ms else None!r}",
                  flush=True)
        tgt = extra.get(name, {}).get("slot_ms", {}).get("target")
        if tgt and all(None not in tgt[f] for f in tgt["median"]):
            med, ratios = tgt["median"], tgt["row_over_clean"]
            ratio = statistics.median(ratios)
            if "torch_add" in tgt:
                against = (f" <= torch.add's {med['torch_add']!r} "
                           f"[{min(tgt['torch_add'])!r}, "
                           f"{max(tgt['torch_add'])!r}]: "
                           f"{med['row'] <= med['torch_add']}")
            elif name == "matmul_O3":
                fl = extra[name]["warp_issue_floor"]["ms"]
                against = (f" (<= {O3_TARGET_MS} ms: "
                           f"{med['row'] <= O3_TARGET_MS}), {fl / med['row']!r}"
                           f" of the warp-issue floor {fl!r} ms (>= "
                           f"{O3_FLOOR_SHARE}: "
                           f"{fl / med['row'] >= O3_FLOOR_SHARE})")
            else:
                against = (f", {issue['issue_bound_ms'] / med['row']!r} of "
                           f"the FP32 issue bound (the median's; >= 0.70: "
                           f"{issue['issue_bound_ms'] / med['row'] >= 0.70})")
            print(f"  {name} targets over {TARGET_READINGS} device readings "
                  f"in turns (median [min, max]): device ms {med['row']!r} "
                  f"[{min(tgt['row'])!r}, {max(tgt['row'])!r}]{against}; "
                  f"run-time k=0 / clean build {ratio!r} [{min(ratios)!r}, "
                  f"{max(ratios)!r}] (median within 2%: "
                  f"{abs(ratio - 1) <= 0.02})", flush=True)
        if (name in ("noise_probes", "spmv_ell") or name in LOOP_PLAIN_REPS
                ) and n_kernels != 1:
            one_launch.append(f"{label}: {n_kernels!r} kernels a call")
        row = {"name": name, "route": "cuda",
               "source": meta[name]["source"],
               "replaces": meta[name]["replaces"],
               "launches": launches[name], "max_abs_err": max_err[name],
               "ms": kernel_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "device_ms": dev_ms,
               "device_records_whole": dev_whole,
               "library_device_ms": lib_dev_ms,
               "bound_share": share, "vs_library": vs_lib,
               "kernels_per_call": n_kernels, **issue,
               **extra.get(name, {})}
        if name == "flash_attention_h256":
            print(f"  (the hd-256 row's inputs and SDPA yardsticks "
                  f"{h256_s:.1f} s, its readings "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
        if name in out:     # spmv at q=1: beside the q=0 row
            out[name]["q1"] = {k: v for k, v in row.items()
                               if k not in ("name", "route", "source",
                                            "replaces", "launches",
                                            "max_abs_err")}
        else:
            out[name] = row
    out["noise_probes"]["launch_floor"] = _launch_floor()
    out["noise_probes"]["us_per_pattern"] = _probe_slot_costs()
    if one_launch:
        raise RuntimeError("the probe, spmv and loop regions must launch "
                           "one kernel a call: " + "; ".join(one_launch))
    return list(out.values())


# plain-version timing reps of the loop regions, the DECAN loops and the
# graph modes (their loops run in Python); every one launches one kernel a
# call
LOOP_PLAIN_REPS = {"stream_triad": 5, "spmxv": 5, "lat_mem_rd": 3,
                   "haccmk": 2, "matmul_O0": 3, "matmul_O3": 3,
                   "decan_table3": 5, "decan_livermore": 2,
                   "graph_fp_add32": 5, "graph_mxu_fma128": 5,
                   "graph_vmem_ld": 5, "graph_hbm_stream": 5,
                   "graph_hbm_latency": 3}


def _loop_rows():
    """Phase-6 rows of the loop kernels at their phase-4 shapes, each timed
    as the sweeps call it: the region's runtime-k callable (fp_add) at
    k=0. Returns (rows, extra keys by kernel)."""
    import torch

    from repro_torch.bench.kernels import (haccmk_region, lat_mem_rd_region,
                                           matmul_region, spmxv_region,
                                           stream_region)
    from repro_torch.kernels.loop_regions import kernel as lk
    from repro_torch.kernels.loop_regions import ref as lref

    def main_call(region, name, device=False):
        fn, args = region.build_rt("fp_add"), region.args_for_rt("fp_add")
        extra.setdefault(name, {})["slot_ms"] = _slot_ms(region, name,
                                                         device=device)
        return partial(fn, 0, *args), args

    # every call binds its tensors now (partial): the names are reused below
    rows, extra = [], {}
    # STREAM n=2^25, chunk 512: 12 bytes an element
    reg = stream_region(n=MAIN_STREAM_N)
    kern, (a, b, c, carry) = main_call(reg, "stream_triad")
    c_lib = torch.empty_like(c)
    rows.append(("stream_triad", "stream_triad n=2^25",
                 kern, partial(lref.stream_triad_plain, a, b, c, chunk=512,
                               mode="fp_add", k=0, carry=carry),
                 partial(torch.add, a, b, alpha=3.0, out=c_lib),
                 12 * MAIN_STREAM_N, 2 * MAIN_STREAM_N, FP32_FLOPS,
                 "torch.add(a, b, alpha=3.0, out=c)"))

    # lat_mem_rd: 1024 iterations x 8 dependent hops on a 2^26 table
    reg = lat_mem_rd_region(**MAIN_LAT)
    kern, (table, idx0, carry) = main_call(reg, "lat_mem_rd")
    n_iter, hops = MAIN_LAT["n_iter"], MAIN_LAT["hops_per_iter"]
    t8, t16 = (time_ms(partial(lk.lat_mem_rd, table, idx0, n_iter=n_iter,
                               hops=h, static=False)) for h in (8, 16))
    ns_hop = (t16 - t8) * 1e6 / (n_iter * 8)
    lat_bound = n_iter * hops * ns_hop * 1e-6
    print(f"lat_mem_rd: {ns_hop!r} ns a dependent hop on the 2^26 table "
          f"(8 against 16 hops an iteration: {t8!r} / {t16!r} ms); "
          f"latency bound {lat_bound!r} ms", flush=True)
    extra["lat_mem_rd"].update(ns_per_hop=ns_hop, latency_bound_ms=lat_bound)
    rows.append(("lat_mem_rd", "lat_mem_rd 2^26 table, 1024 x 8 hops",
                 kern, partial(lref.lat_mem_rd_plain, table, idx0,
                               n_iter=n_iter, hops=hops, mode="fp_add", k=0,
                               carry=carry),
                 None, 4 * n_iter * hops, 0, FP32_FLOPS, None))

    # HACCmk: 6 chains x 8 FP32 operations a lane and iteration
    reg = haccmk_region(**MAIN_HACC)
    kern, (x, carry) = main_call(reg, "haccmk")
    w, it = MAIN_HACC["width"], MAIN_HACC["n_iter"]
    rows.append(("haccmk", f"haccmk width {w}, {it} iterations",
                 kern, partial(lref.haccmk_plain, x, n_iter=it, mode="fp_add",
                               k=0, carry=carry),
                 None, 4 * w, w * it * lref.HACC_CHAINS * 8, FP32_FLOPS, None))

    # SPMXV large, q=0 (n=2^21, L=16): the bytes of spmv_ell's row
    warnings.filterwarnings("ignore", message="Sparse")
    reg = spmxv_region(n=MAIN_SPMXV_N, q=0.0, name="spmxv_large_q0.0")
    kern, (vals, cols, x, y, carry) = main_call(reg, "spmxv")
    R, L = vals.shape
    order = torch.argsort(cols, dim=1)
    csr = torch.sparse_csr_tensor(
        torch.arange(0, R * L + 1, L, device=vals.device, dtype=torch.int64),
        torch.gather(cols, 1, order).flatten().long(),
        torch.gather(vals, 1, order).flatten(), size=(R, x.shape[0]))
    lib_err = _max_err(csr @ x, kern()[0])
    rows.append(("spmxv", "spmxv n=2^21 L=16 q=0",
                 kern, partial(lref.spmxv_plain, vals, cols, x, y,
                               rows_per_iter=64, mode="fp_add", k=0,
                               carry=carry),
                 partial(torch.matmul, csr, x),
                 4 * (2 * R * L + x.shape[0] + R), 2 * R * L,
                 FP32_FLOPS,
                 f"torch.sparse_csr_tensor @ x (max|d| vs kernel {lib_err:.3g})"))

    # matmul O0 / O3, n=192 (Fig. 4)
    n = MAIN_MM_N
    for opt, name in ((False, "matmul_O0"), (True, "matmul_O3")):
        reg = matmul_region(n=n, optimized=opt)
        kern, args = main_call(reg, name, device=True)
        print(f"{name}: the noise slot at run-time k=0 over the clean build "
              f"(device ms): " + slot_costs(extra[name]["slot_ms"]),
              flush=True)
        it = 16 * n if opt else 32 * n // lref.UNROLL_O0
        if opt:
            a, b, carry = args
            plain = partial(lref.matmul_o3_plain, a, b, n_iter=it,
                            mode="fp_add", k=0, carry=carry)
            nbytes = 4 * (lref.ROWS_O3 * n + n * n)
            nops = 2 * it * lref.ROWS_O3 * n
            floor = o3_issue_floor(n, it, lref.MM_O3_THREADS, sm_clock_mhz())
            extra[name]["warp_issue_floor"] = floor
            print(f"{name}: warp-issue floor ({lref.MM_O3_THREADS}-thread "
                  f"blocks, {floor['warps_a_block']} warp(s) a block): "
                  f"{floor['formula']} = {floor['ms']!r} ms", flush=True)
        else:
            a, b, out0, carry = args
            plain = partial(lref.matmul_o0_plain, a, b, out0, n_iter=it,
                            mode="fp_add", k=0, carry=carry)
            nbytes = 4 * (n + n * n)
            nops = 2 * it * lref.UNROLL_O0 * n
            # one dependent chain: each step's volatile round trip to the
            # L2, at lat_mem_rd's hop above
            steps = it * lref.UNROLL_O0
            extra[name].update(chain_steps=steps, latency_bound_ms=(
                steps * ns_hop * 1e-6))
            print(f"{name}: latency bound {steps} dependent steps x "
                  f"{ns_hop!r} ns (lat_mem_rd's L2 hop) = "
                  f"{extra[name]['latency_bound_ms']!r} ms", flush=True)
        rows.append((name, f"{name} n={n}", kern, plain, None, nbytes, nops,
                     FP32_FLOPS, None))
    return rows, extra


def slot_costs(slot: dict) -> str:
    """Each mode's run-time build at k=0 over the clean build, from a
    ``_slot_ms`` result (device ms where it has them)."""
    def ms(v):
        return v["device"] if isinstance(v, dict) else v
    return ", ".join(f"{m} {ms(slot[m]['rt_k0']) / ms(slot['clean'])!r}"
                     for m in LOOP_MODES)


def _slot_ms(region, name: str, *, device: bool = False,
             static: bool = True) -> dict:
    """The noise slot's own cost in a loop kernel, event ms: the clean
    build against each mode's run-time build at k=0, and its run-time and
    (``static``) static builds at k=8; ``device``: each of these also in
    device ms (``tools/torch_triad_bench.py``, ``tools/torch_liv_bench.py``).
    For TARGET_ROWS also ``target``: TARGET_READINGS device readings each
    of the clean build, the row's call (fp_add's run-time build at k=0)
    and, for the triads (TRIAD_ROWS), torch.add on the same tensors, taken
    in turns, which phase 6 holds the row to."""
    import torch

    clean = partial(region.build("", 0), *region.args_for("", 0))

    def both(fn, reps):
        ms = time_ms(fn, reps=reps, warmup=1)
        return {"event": ms, "device": device_ms(fn)[0]} if device else ms

    slot = {"clean": both(clean, 5)}
    for mode in LOOP_MODES:
        rt, args = region.build_rt(mode), region.args_for_rt(mode)
        slot[mode] = {"rt_k0": both(partial(rt, 0, *args), 5),
                      "rt_k8": both(partial(rt, 8, *args), 3)}
        if static:
            slot[mode]["static_k8"] = time_ms(
                partial(region.build(mode, 8), *region.args_for(mode, 8)),
                reps=3, warmup=1)
    if name in TARGET_ROWS:
        fns = {"clean": clean,
               "row": partial(region.build_rt("fp_add"), 0,
                              *region.args_for_rt("fp_add"))}
        if name in TRIAD_ROWS:
            a, b = region.args_for("", 0)[:2]
            c_lib = torch.empty_like(a)
            fns["torch_add"] = partial(torch.add, a, b, alpha=3.0, out=c_lib)
        slot["target"] = _target_readings(fns)
    print(f"{region.name}: ms of the noise slot (clean kernel; each mode's "
          f"run-time kernel at k=0 and k=8, static k=8): {slot}", flush=True)
    return slot


# device readings a triad's targets are read from (each a mean over
# TIMING_REPS calls, the calls in turns)
TARGET_READINGS = 5


def _target_readings(fns: dict) -> dict:
    """{name: [device ms] * TARGET_READINGS} of ``fns``, read in turns,
    with the medians and, for "row", its ratio to "clean" reading by
    reading."""
    out = {name: [] for name in fns}
    for _ in range(TARGET_READINGS):
        for name, fn in fns.items():
            out[name].append(device_ms(fn)[0])
    out["median"] = {name: statistics.median(out[name]) for name in fns}
    out["row_over_clean"] = [r / c for r, c in zip(out["row"], out["clean"])]
    return out


def graph_readings(calls: dict, readings: int = TARGET_READINGS) -> dict:
    """{name: {"readings": {k: [device ms] * readings}, "median": {k: ms},
    "device_us_per_pattern": the medians' slope over GRAPH_SLOPE_KS}} of
    the graph-mode calls ``calls`` (name -> call(k)) at every k of
    GRAPH_KS, read in turns: each reading takes every name at every k
    once. A median or slope is None where a trace held no device time."""
    import numpy as np

    got = {name: {k: [] for k in GRAPH_KS} for name in calls}
    for _ in range(readings):
        for name, call in calls.items():
            for k in GRAPH_KS:
                got[name][k].append(device_ms(partial(call, k))[0])
    out = {}
    for name, by_k in got.items():
        med = {k: statistics.median(v) if None not in v else None
               for k, v in by_k.items()}
        dev = [med[k] for k in GRAPH_SLOPE_KS]
        out[name] = {"readings": by_k, "median": med,
                     "device_us_per_pattern": (
                         float(np.polyfit(GRAPH_SLOPE_KS, dev, 1)[0]) * 1e3
                         if None not in dev else None)}
    return out


def _graph_work(name: str, state: dict, k: int) -> tuple:
    """(bytes, operations, peak) of one graph-mode call at k: its state read
    once and its new state written once, plus the bytes its patterns read
    from device memory (hbm_stream: k distinct tiles; the chase: k 4-byte
    hops); its FP32 adds (mxu: 2*128^3 bf16 tensor-core operations a
    pattern)."""
    f32 = 4
    if name == "fp_add32":
        e = state["c"].numel()
        return 9 * e * f32, k * e, FP32_FLOPS
    if name == "vmem_ld":
        return (state["buf"].numel() + 8 * 1024) * f32, k * 1024, FP32_FLOPS
    if name == "mxu_fma128":
        d = state["m"].shape[0]
        return 3 * d * d * 2, 2 * d ** 3 * k, BF16_FLOPS
    if name == "hbm_stream":
        e = state["acc"].numel()
        return (k + 2) * e * f32, k * e, FP32_FLOPS
    return 4 * k + 12, k, FP32_FLOPS      # hbm_latency


def _decan_graph_rows():
    """Phase-6 rows of the DECAN loops at their phase-4 shapes, each timed
    as the sweeps call it (the region's runtime-k fp_add callable at k=0):
    Table 3's data-bound scenario (STREAM's triad and 4-step chains;
    torch.add with alpha 3 as the library call) and Livermore; then each
    graph-level mode's kernel at k = GRAPH_ROW_K through ``apply_rt``,
    called as ``studies.fresh_calls`` calls it (hbm_stream from a base tile
    that moves every call, the chase going on where it stopped: no call
    reads the L2's lines of the call before), with its µs a pattern (the
    slope of event time over GRAPH_SLOPE_KS) beside
    ``pattern_cost(H100_SXM)``'s; the GRAPH_TARGET_MODES' device time read
    TARGET_READINGS times in turns, their k = 0 call and slope beside
    ``graph_floor_us`` (the mxu emitter's one-SM tensor-core floor, the fp
    and vmem emitters' issue and shared-memory floors, hbm_stream's bytes
    bound a pattern), and the mxu row's library call
    (``mxu_library_graph``).
    Returns (rows, extra keys by kernel)."""
    import numpy as np
    import torch

    from repro_torch.bench.studies import fresh_calls
    from repro_torch.configs.base import H100_SXM

    rows, extra = [], {}
    targets = _decan_targets(MAIN_LIV["n_iter"], MAIN_LIV["n_iter"])
    # Table 3 data-bound: a, b read and the triad written, 12 bytes an
    # element; the chains' FP32 work of one 8-lane copy a warp
    tgt = targets["t3 data-bound"]
    reg = tgt.region()
    fn, args = reg.build_rt("fp_add"), reg.args_for_rt("fp_add")
    extra["decan_table3"] = {"slot_ms": _slot_ms(reg, "decan_table3")}
    a, b, c, x0, carry = args
    n = MAIN_T3["n"]
    c_lib = torch.empty_like(c)
    n_iter = tgt.n_iter
    rows.append(("decan_table3", "decan_table3 data-bound N=2^25",
                 partial(fn, 0, *args),
                 partial(tgt.build_plain(True, True), a, b, c, x0),
                 partial(torch.add, a, b, alpha=3.0, out=c_lib),
                 12 * n, 2 * n + n_iter * 8 * 4 * 4 * 3, FP32_FLOPS,
                 "torch.add(a, b, alpha=3.0, out=c), the triad alone"))
    tgt = targets["livermore"]
    reg = tgt.region()
    fn, args = reg.build_rt("fp_add"), reg.args_for_rt("fp_add")
    extra["decan_livermore"] = {"slot_ms": _slot_ms(reg, "decan_livermore")}
    w, it = MAIN_LIV["width"], MAIN_LIV["n_iter"]
    rows.append(("decan_livermore", f"decan_livermore width {w}, {it} "
                 "iterations", partial(fn, 0, *args),
                 partial(tgt.build_plain(True, True), args[0]),
                 None, 4 * MAIN_LIV["n"], w * it * 13, FP32_FLOPS, None))
    for name, (mode, state) in _graph_states().items():
        kernel = f"graph_{name}"
        if name.startswith("ici_"):      # fp_add32's kernel, or torch.sum
            continue
        # hbm_stream and the chase called so that no call reads the L2's
        # lines of the call before (studies.fresh_calls)
        call = fresh_calls(name, mode, state)
        ts = [time_ms(partial(call, k)) for k in GRAPH_SLOPE_KS]
        targeted = name in GRAPH_TARGET_MODES
        got = graph_readings({name: call},
                             TARGET_READINGS if targeted else 1)[name]
        dev = [got["median"][k] for k in GRAPH_SLOPE_KS]
        slope_us = float(np.polyfit(GRAPH_SLOPE_KS, ts, 1)[0]) * 1e3
        dev_slope_us = got["device_us_per_pattern"]
        model = mode.pattern_cost(H100_SXM).time_on(H100_SXM)
        extra[kernel] = {"mode": name, "slope_ks": list(GRAPH_SLOPE_KS),
                         "slope_event_ms": ts, "slope_device_ms": dev,
                         "us_per_pattern": slope_us,
                         "device_us_per_pattern": dev_slope_us,
                         "model_us_per_pattern": max(model.values()) * 1e6,
                         "model_per_resource_s": model, "k": GRAPH_ROW_K}
        if name in ("hbm_stream", "hbm_latency"):
            # beside it, every call on the unchanged state (as a step calls
            # the mode): the same lines each call, L2 hits while they fit
            warm = [time_ms(partial(mode.apply_rt, state, k))
                    for k in GRAPH_SLOPE_KS]
            extra[kernel]["same_lines_event_ms"] = warm
            extra[kernel]["same_lines_us_per_pattern"] = float(
                np.polyfit(GRAPH_SLOPE_KS, warm, 1)[0]) * 1e3
        lib, lib_what = None, None
        if targeted:
            readings = got["readings"]
            extra[kernel]["target_readings_device_ms"] = readings
            row_ms = got["median"][GRAPH_ROW_K]
            if name == "mxu_fma128":
                floor = mxu_sm_floor(GRAPH_ROW_K, sm_clock_mhz())
                extra[kernel]["sm_floor"] = floor
                lib = mxu_library_graph(state["m"], state["c"], GRAPH_ROW_K)
                lib_what = (f"{GRAPH_ROW_K} chained torch.matmul(m, c) in "
                            "bf16, one CUDA graph")
            per, floor_what = graph_floor_us(name, state, sm_clock_mhz())
            share = per / dev_slope_us if dev_slope_us else None
            extra[kernel].update(floor_us_per_pattern=per,
                                 floor_share=share, row_device_ms=row_ms,
                                 k0_device_ms=got["median"][0])
            print(f"graph {name}: device ms, {TARGET_READINGS} readings in "
                  "turns: " + ", ".join(
                      f"k={k} {v}" for k, v in readings.items())
                  + f"; k=0 {got['median'][0]!r} ms; {dev_slope_us!r} us a "
                  f"pattern against the {floor_what} {per!r} us ({share!r} "
                  f"of it); row at k={GRAPH_ROW_K} {row_ms!r} ms; "
                  f"{card_line()}", flush=True)
        print(f"graph {name}: {slope_us!r} us a pattern by events, "
              f"{dev_slope_us!r} on the device (k in {list(GRAPH_SLOPE_KS)}: "
              f"{ts} ms, {dev} ms); the same lines every call: "
              f"{extra[kernel].get('same_lines_us_per_pattern')!r} us "
              f"({extra[kernel].get('same_lines_event_ms')} ms); "
              f"pattern_cost(H100_SXM): {max(model.values()) * 1e6!r} us "
              f"{model}", flush=True)
        if name == "hbm_latency":
            # one dependent chain of k hops whose lines are not the L2's
            bound = GRAPH_ROW_K * H100_SXM.hbm_latency_s * 1e3
            extra[kernel]["latency_bound_ms"] = bound
            print(f"graph {name}: latency bound {GRAPH_ROW_K} hops x "
                  f"{H100_SXM.hbm_latency_s!r} s (H100_SXM.hbm_latency_s) "
                  f"= {bound!r} ms", flush=True)
        nbytes, nops, peak = _graph_work(name, state, GRAPH_ROW_K)
        rows.append((kernel, f"{kernel} ({name}) k={GRAPH_ROW_K}",
                     partial(call, GRAPH_ROW_K),
                     partial(mode.apply_rt, state, GRAPH_ROW_K, plain=True),
                     lib, nbytes, nops, peak, lib_what))
    return rows, extra


def _launch_floor() -> dict:
    """An empty kernel launched through ``_build.launch``: the least a
    wrapper call can cost, by events, host clock and on the device."""
    import torch

    from repro_torch.kernels import _build

    t = torch.empty(1, device="cuda")

    def empty():
        _build.launch("noise_probes", "empty", (t,), (), mode_id=0, k=0,
                      static=False)

    floor = {"ms": time_ms(empty), "host_ms": host_ms(empty),
             "device_ms": device_ms(empty)[0]}
    print(f"launch floor (an empty kernel through _build.launch): "
          f"{floor['ms']!r} ms by events, {floor['host_ms']!r} ms host clock "
          f"with synchronize, {floor['device_ms']!r} ms on the device",
          flush=True)
    return floor


def _probe_slot_costs() -> dict:
    """µs a noise pattern of each mode in the probe at 1056 steps
    (``launch/slot_cost.py``, k in {0, 64, 128, 256}: fp and vmem patterns
    are too cheap to resolve at smaller k), beside the earlier kernel's mxu
    in PERF.md (6.42 µs, fitted at k in {0, 4, 8, 16})."""
    from repro_torch.launch.slot_cost import slot_costs

    costs = slot_costs(("fp", "vmem", "mxu"), (0, 64, 128, 256),
                       kernels=("noise_probes",))["noise_probes s1056"]
    per = {m: c["us_per_pattern"] for m, c in costs.items()}
    print(f"probe, µs a pattern (launch/slot_cost.py): {per} (earlier, in "
          f"PERF.md: mxu 6.42)", flush=True)
    return per


# ---------------------------------------------------------------------------
# phase 7: step-level injection and the paged serving engine, gemma-2b
# ---------------------------------------------------------------------------

# gemma-2b at full width and depth in bf16 (src/repro_torch/configs/
# gemma_2b.py: 18 layers, d_model 2048, MQA, head_dim 256, GeGLU d_ff
# 16384, vocab 256,000, tied), served with launch/serve.py's defaults, the
# reference CLI's: 8 requests on 4 slots, prompts of 2-11 tokens from
# RandomState(0)
SERVE_ARCH = "gemma_2b"
SERVE_ARGS = {"requests": 8, "slots": 4, "max_new": 16, "max_seq": 256,
              "page_size": 16}
# the serve regions: a paged engine two ticks into a full-slot campaign
# (serve/load.py:engine_for_probe) at the probe CLI's defaults (prompt 128,
# 4 slots, max_new 8, page 16)
SERVE_PROBE = {"slots": 4, "prompt": 128, "max_new": 8, "page_size": 16}
SERVE_KS = (1, 64)
# the traced noisy tick: mxu_fma128 at the run-time cap (~0.57 us a pattern
# on the H100 at 700 W, PERF.md; ~0.29 ms a call), long enough to overlap
# the step's kernels
TRACE_MODE, TRACE_K = "mxu_fma128", 512
# reps of every sweep point (min of reps, the host clock): 5, in one
# reading (two readings at 10 reps, to show how far a region's values
# hold, until phase 13 was added; cut to pay for it)
SERVE_REPS = 5
# reading -> its store: one fresh reading, then replayed
SERVE_READINGS = {"reading": "serve.jsonl", "replay": "serve.jsonl"}
# graph replays in the trace that counts a step's kernels (device_ms)
STEP_TRACE_REPS = 5
# CUDA-event timings of a step region's t(0), graph and eager: the median
# of 10 (TIMING_REPS, 25, until phase 13 was added; cut to pay for it)
STEP_EVENT_REPS = 10
L2_NOTE = "(k tiles L2-resident below k~380)"


# phase 8: qwen3-moe-30b-a3b at full width in bf16 (src/repro_torch/
# configs/qwen3_moe_30b_a3b.py: d_model 2048, 32 / 4 heads of 128, 128
# experts top-8 of d_ff 768, vocab 151,936), its depth cut from 48 layers
# (61 GB) to MOE_LAYERS (~3.1 B parameters, 6 GB; 16 layers before phase
# 12, 8 before phase 13, cut to pay for each) so that the script stays
# inside its limit
# (PERF.md §4), served and probed as phase 7's model is, its regions read
# once and replayed; then the smoke configs
# of the other MoE and VLM paths through the probe CLI: mixtral's ring
# cache (a decode step at position 64 of a 16-slot ring), llava's image
# embeds (the forward loss with 8 image tokens in front) and qwen3's
# serving
MOE_ARCH = "qwen3_moe_30b_a3b"
MOE_LAYERS = 4
MOE_READINGS = {"reading": "moe.jsonl", "replay": "moe.jsonl"}
# reps of each sweep point of its one reading: 2 (5 before phase 12, 3
# before phase 13, cut to pay for each)
MOE_REPS = 2
MOE_CLI = {
    "probe_mixtral_decode_smoke": ["--arch", "mixtral-8x22b", "--kind",
                                   "decode"],
    "probe_llava_train_smoke": ["--arch", "llava-next-34b"],
    "probe_qwen3_serve_smoke": ["--serve", "--arch", "qwen3-moe-30b-a3b"]}


def _leaves(obj) -> list:
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _leaves(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _leaves(v)]
    return []


def _noise_overlap(trace_path: str, noise_name: str) -> dict:
    """Read a chrome trace of noisy calls: the kernels launched inside the
    ``NOISE_SCOPE`` ranges (by the correlation of their launch calls), their
    streams, the other kernels' (the step's) streams, and how much of each
    noise kernel's interval overlaps a step kernel. Fails unless a noise
    kernel named ``noise_name`` ran on a stream of its own, overlapping the
    step."""
    from repro_torch.core.noise import NOISE_SCOPE

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    scopes = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == NOISE_SCOPE]
    corr = set()
    for e in events:
        if e.get("cat") != "cuda_runtime":
            continue
        for sc in scopes:
            if (e.get("tid") == sc.get("tid")
                    and sc["ts"] <= e["ts"] <= sc["ts"] + sc.get("dur", 0)):
                corr.add(e.get("args", {}).get("correlation"))
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "spin_kernel" not in e.get("name", "")]
    noise = [e for e in kernels if e.get("args", {}).get("correlation")
             in corr]
    step = [e for e in kernels if e not in noise]
    noise_streams = sorted({e["args"].get("stream") for e in noise})
    step_streams = sorted({e["args"].get("stream") for e in step})
    overlap = []
    for n in noise:
        n0, n1 = n["ts"], n["ts"] + n["dur"]
        cover = sum(max(0.0, min(n1, s["ts"] + s["dur"]) - max(n0, s["ts"]))
                    for s in step)
        overlap.append(cover / max(n["dur"], 1e-9))
    out = {"scopes": len(scopes), "noise_kernels": sorted(
               {e["name"].split("(")[0] for e in noise}),
           "noise_streams": noise_streams, "step_streams": step_streams,
           "step_kernels": len(step),
           "noise_us": [e["dur"] for e in noise],
           "overlap_share": overlap}
    print(f"  trace of the noisy tick: {json.dumps(out)}", flush=True)
    if not any(noise_name in name for name in out["noise_kernels"]):
        raise RuntimeError(f"trace: no {noise_name} kernel under "
                           f"{NOISE_SCOPE} ({out})")
    if not step:
        raise RuntimeError("trace: no kernel of the step (the graph "
                           "replay's kernels are not in the trace)")
    if set(noise_streams) & set(step_streams):
        raise RuntimeError(f"trace: the noise ran on the step's stream "
                           f"({out})")
    if not any(o > 0 for o in overlap):
        raise RuntimeError(f"trace: the noise kernel overlaps no kernel of "
                           f"the step ({out})")
    return out


@contextlib.contextmanager
def _count_drops(record: dict):
    """Count the (token, choice) pairs the MoE dispatch drops (past an
    expert's capacity) while the block runs, per token count T of the call:
    ``record[T] = [calls, pairs, dropped (a device tensor), capacity]``. Host
    reads happen after the block, so the counting adds one reduction a layer
    and no sync."""
    from repro_torch.models import moe as moe_mod

    combine = moe_mod._group_combine

    def counting(out_buf, eg, slots, gates, capacity):
        rec = record.setdefault(slots.shape[0] * slots.shape[1],
                                [0, 0, 0, capacity])
        rec[0] += 1
        rec[1] += slots.numel()
        rec[2] = rec[2] + (slots >= capacity).sum()
        return combine(out_buf, eg, slots, gates, capacity)

    moe_mod._group_combine = counting
    try:
        yield record
    finally:
        moe_mod._group_combine = combine


def _drops(record: dict, n_layers: int) -> dict:
    """``_count_drops``' record per call of the model (its layers summed)."""
    out = {}
    for T, (calls, pairs, dropped, cap) in sorted(record.items()):
        n = calls / n_layers
        out[f"T={T}"] = {"calls": n, "capacity": cap,
                         "pairs_per_call": pairs / n,
                         "dropped_pairs_per_call": int(dropped) / n}
    return out


def _check_and_time(regions, eager: dict, weights_ms: float) -> dict:
    """Each step region: its clean step a CUDA graph; noisy out bitwise
    equal to clean out, static and run-time k in ``SERVE_KS``, and payload =
    k for the default graph modes; t(0) from the graph and eagerly (host
    clock and CUDA events), the device time and the kernels a call from a
    trace, and its top device operations. ``eager`` maps a region's name to
    its eager (fn, args)."""
    import torch

    from repro_torch.core.absorption import measure
    from repro_torch.core.injector import GraphStep
    from repro_torch.launch.probe import DEFAULT_GRAPH_MODES

    res = {}
    for region in regions:
        clean = region.build("", 0)
        if not isinstance(clean, GraphStep):
            raise RuntimeError(f"{region.name}: the clean step is not a "
                               "CUDA graph")
        want = [t.clone() for t in _leaves(clean(*region.args_for("", 0)))]
        torch.cuda.synchronize()
        for mode in DEFAULT_GRAPH_MODES:
            for k in SERVE_KS:
                for how, call in (
                        ("static", lambda: region.build(mode, k)(
                            *region.args_for(mode, k))),
                        ("runtime", lambda: region.build_rt(mode)(
                            k, *region.args_for_rt(mode)))):
                    got = _leaves(call()[0])
                    torch.cuda.synchronize()
                    if len(got) != len(want) or not all(
                            torch.equal(a, b) for a, b in zip(got, want)):
                        raise RuntimeError(f"{region.name}: noisy out != "
                                           f"clean out ({mode} {how} "
                                           f"k={k})")
                rep = region.payload_check(mode, k)
                if rep.payload != k:
                    raise RuntimeError(f"{region.name}: payload check "
                                       f"{mode} k={k}: {rep}")
        print(f"{region.name}: noisy out bitwise equal to clean out, "
              f"static and run-time k in {list(SERVE_KS)}, and payload "
              f"= k for {', '.join(DEFAULT_GRAPH_MODES)}", flush=True)
        fn, args = eager[region.name]
        t_graph = measure(clean, region.args_for("", 0), reps=10)
        t_eager = measure(fn, args, reps=10)
        ev_graph = time_ms(partial(clean, *region.args_for("", 0)),
                           reps=STEP_EVENT_REPS)
        ev_eager = time_ms(partial(fn, *args), reps=STEP_EVENT_REPS)
        dev_ms, per_kernel, n_kernels, whole = device_ms(
            partial(clean, *region.args_for("", 0)), reps=STEP_TRACE_REPS)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
        res[region.name] = {"t0_graph_ms": t_graph * 1e3,
                            "t0_eager_ms": t_eager * 1e3,
                            "event_graph_ms": ev_graph,
                            "event_eager_ms": ev_eager,
                            "device_ms": dev_ms,
                            "kernels_a_call": n_kernels,
                            "device_records_whole": whole,
                            "weights_read_ms": weights_ms}
        print(f"{region.name}: t(0) host clock with synchronize, min of "
              f"10: graph {t_graph * 1e3!r} ms, eager {t_eager * 1e3!r} "
              f"ms; CUDA events, median of {STEP_EVENT_REPS}: graph "
              f"{ev_graph!r} ms, eager {ev_eager!r} ms; device "
              f"{dev_ms!r} ms in {n_kernels} kernels a call (trace of "
              f"{STEP_TRACE_REPS} graph replays, whole: {whole}); every "
              f"weight read once: {weights_ms!r} ms; {card_line()}",
              flush=True)
        print(f"  top device operations (ms a call): "
              f"{json.dumps(dict(top))}", flush=True)
    return res


def _read_regions(tmp: str, regions, readings: dict, reps: int) -> dict:
    """Fresh readings at ``reps`` a point, each into its store, then a store
    replayed (it must measure 0); beside the fit's Abs^raw (the hinge's
    knee, k1) each mode prints the threshold reading (the last k within 5%
    of t(0)) and the largest t(k)/t(0) of its sweep."""
    from repro_torch.core.campaign import Campaign, CampaignStore
    from repro_torch.core.controller import Controller
    from repro_torch.launch.probe import DEFAULT_GRAPH_MODES

    verdicts = {}
    for reading, store in readings.items():
        camp = Campaign(CampaignStore(os.path.join(tmp, store)),
                        Controller(reps=reps))
        t_read = time.perf_counter()
        try:
            reps_ = {r.name: camp.characterize(r, DEFAULT_GRAPH_MODES)
                     for r in regions}
        finally:
            camp.store.close()
        print(f"characterize ({reading}, reps {reps}): "
              f"{camp.stats} in {time.perf_counter() - t_read:.1f} s",
              flush=True)
        if reading == "replay" and camp.stats.measured:
            raise RuntimeError(f"the serve store replayed with "
                               f"{camp.stats.measured} measured")
        for name, rep in reps_.items():
            _payloads_ok(rep)
            modes = {m: {"abs_raw": r.fit.k1,
                         "k1_threshold": r.fit.k1_threshold,
                         "max_ratio": float(max(r.curve.ratios())),
                         "ks": list(r.curve.ks),
                         "ratios": [float(x) for x in r.curve.ratios()],
                         "t0_ms": r.fit.t0 * 1e3}
                     for m, r in rep.results.items()}
            verdicts.setdefault(name, {})[reading] = {
                "label": rep.bottleneck.label, "modes": modes}
            print(f"{name} ({reading}): " + ", ".join(
                f"{m} Abs^raw={v['abs_raw']!r} threshold="
                f"{v['k1_threshold']!r} max t(k)/t(0)="
                f"{v['max_ratio']!r}" + (f" {L2_NOTE}"
                                         if m == "hbm_stream" else "")
                for m, v in modes.items())
                + f" => {rep.bottleneck.label}; {card_line()}",
                flush=True)
    return verdicts


def _probe_cli(tmp: str, kernels: Kernels, counts: dict, seconds: dict,
               cli: dict) -> None:
    """The probe CLI's paths ``cli`` (name -> argv) at the smoke configs,
    each driven once into its store (it must launch every default graph
    mode's kernel) and replayed with 0 measured."""
    from repro_torch.launch.probe import DEFAULT_GRAPH_MODES
    from repro_torch.launch.probe import main as probe_main

    graph = tuple(f"graph_{m}" for m in DEFAULT_GRAPH_MODES)
    for name, argv in cli.items():
        store = os.path.join(tmp, f"{name}.jsonl")
        print(f"== python -m repro_torch.launch.probe {' '.join(argv)}",
              flush=True)
        drive(kernels, counts, seconds, name, graph,
              lambda: probe_main(argv + ["--store", store]))
        _, stats = probe_main(argv + ["--store", store,
                                      "--expect-no-measure"])
        if stats.measured:
            raise RuntimeError(f"{name}: replay measured {stats.measured}")


def _serve_phase(tmp: str, kernels: Kernels, *, title: str, arch: str,
                 tag: str, readings: dict, reps: int, cli: dict,
                 n_layers: Optional[int] = None) -> dict:
    """A model at full width and depth, served (paged and dense, equal
    greedy tokens), its prefill and decode tick as step regions (noisy =
    clean bitwise, payload = k, the noise overlapping the step in a trace,
    the tick's kernels and top device operations, classified at ``reps``
    a point into a store and replayed with 0 measured, t(0) from the graph
    and eagerly), then
    the probe CLI's paths ``cli`` at the smoke configs. A MoE also prints
    the pairs its dispatch drops. ``n_layers`` cuts the depth. Returns the
    graph-noise kernels' launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.injector import step_modes
    from repro_torch.launch.probe import DEFAULT_GRAPH_MODES
    from repro_torch.launch.serve import report, serve
    from repro_torch.models.model import build
    from repro_torch.serve.load import (engine_for_probe, serve_names,
                                         serve_regions)

    banner(title)
    seconds: dict = {}
    counts = {name: [0, 0] for name in kernels.rows}
    graph = tuple(f"graph_{m}" for m in DEFAULT_GRAPH_MODES)
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    moe = bool(cfg.n_experts)
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(0, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    free, total = torch.cuda.mem_get_info()
    weights_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"{cfg.name}: {n_params} parameters ({n_bytes} bytes) drawn on "
          f"the card from seed 0 in {time.perf_counter() - t0:.1f} s, "
          f"{cfg.n_layers} layers; free memory after the draw {free} of "
          f"{total} bytes; reading every weight once takes {weights_ms!r} "
          f"ms at {HBM_BYTES_PER_S:.3g} B/s; {card_line()}", flush=True)

    def serve_both():
        out = {}
        drops: dict = {}
        for i, dense in enumerate((False, True, False)):
            with (_count_drops(drops) if moe and i == 0
                  else contextlib.nullcontext()):
                eng, reqs, dt = serve(api, params, dense=dense, **SERVE_ARGS)
            print(report(eng, reqs, dt), flush=True)
            out.setdefault(dense, []).append(([r.out for r in reqs], eng,
                                              dt))
        if out[False][0][0] != out[True][0][0]:
            raise RuntimeError("paged and dense greedy tokens differ")
        if out[False][0][0] != out[False][1][0]:
            raise RuntimeError("two paged runs gave different tokens")
        toks, eng, dt = out[False][1]
        rep = eng.report()
        n_tok = sum(len(t) for t in toks)
        res = {"tok_s": n_tok / dt, "decode_tok_s": rep["decode_tok_s"],
               "total_tok_s": rep["total_tok_s"], "ticks": rep["ticks"],
               "prefill_calls": rep["prefill_calls"], "wall_s": dt,
               "dense_wall_s": out[True][0][2]}
        if moe:
            res["dropped"] = _drops(drops, cfg.n_layers)
        print(f"{cfg.name} serve (paged, warm): {json.dumps(res)}; paged "
              f"and dense greedy tokens equal; {card_line()}", flush=True)
        return res

    served = drive(kernels, counts, seconds, f"serve_{tag}", (), serve_both)

    def regions_path():
        registry = step_modes("cuda")
        eng = engine_for_probe(api, params, **SERVE_PROBE)
        names = serve_names(cfg.name, **SERVE_PROBE)
        regions = serve_regions(eng, names, {m: registry[m]
                                             for m in DEFAULT_GRAPH_MODES})
        pf_fn, pf_args, tk_fn, tk_args = eng.probe_cells()
        eager = {names[0]: (pf_fn, pf_args), names[1]: (tk_fn, tk_args)}
        res = {}
        if moe:
            with _count_drops({}) as drops:
                pf_fn(*pf_args)
            res["prefill_dropped"] = _drops(drops, cfg.n_layers)
            print(f"{names[0]}: dispatch drops "
                  f"{json.dumps(res['prefill_dropped'])}", flush=True)
        res.update(_check_and_time(regions, eager, weights_ms))
        tick = regions[1]
        fn, args = tick.build_rt(TRACE_MODE), tick.args_for_rt(TRACE_MODE)
        fn(TRACE_K, *args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(3):
                fn(TRACE_K, *args)
            torch.cuda.synchronize()
        path = os.path.join(tmp, f"noisy_tick_trace_{tag}.json")
        prof.export_chrome_trace(path)
        res["trace"] = _noise_overlap(path, "gmxu")

        res["verdicts"] = _read_regions(tmp, regions, readings, reps)
        return res

    regions_res = drive(kernels, counts, seconds, f"serve_regions_{tag}",
                        graph, regions_path)

    _probe_cli(tmp, kernels, counts, seconds, cli)
    print(f"phase {title.split('.')[0]} wall time per path (s): "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print(f"serve results ({cfg.name}): " + json.dumps(
        {"served": served, **regions_res}), flush=True)
    for name, (n_cuda, n_plain) in counts.items():
        if n_cuda or n_plain:
            print(f"{name}: kernel {n_cuda} launches on the serving paths, "
                  f"plain version {n_plain} (the payload checks' oracle)")
    return {name: n_cuda for name, (n_cuda, _) in counts.items()}


def phase_serve(tmp: str, kernels: Kernels) -> dict:
    """Phase 7: gemma-2b (the dense family)."""
    return _serve_phase(
        tmp, kernels, arch=SERVE_ARCH, tag="gemma2b",
        title="7. serving: gemma-2b at full width and depth (bf16) and its "
              "step regions",
        readings=SERVE_READINGS, reps=SERVE_REPS,
        cli={"probe_serve_smoke": ["--serve", "--arch", "gemma-2b"],
             "probe_decode_smoke": ["--arch", "gemma-2b", "--kind",
                                    "decode"]})


def phase_moe(tmp: str, kernels: Kernels) -> dict:
    """Phase 8: qwen3-moe-30b-a3b (the MoE family), then the smoke probes of
    mixtral's ring cache, llava's image embeds and qwen3's serving. Phase
    7's model is freed before the draw."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"\nfree memory before phase 8: {free} of {total} bytes",
          flush=True)
    return _serve_phase(
        tmp, kernels, arch=MOE_ARCH, tag="qwen3moe",
        title=f"8. the MoE family: qwen3-moe-30b-a3b at full width, "
              f"{MOE_LAYERS} of its 48 layers (bf16), and its step regions",
        readings=MOE_READINGS, reps=MOE_REPS, cli=MOE_CLI,
        n_layers=MOE_LAYERS)


# ---------------------------------------------------------------------------
# phase 9: the SSM, hybrid and encoder-decoder families
# ---------------------------------------------------------------------------

# mamba2-780m (src/repro_torch/configs/mamba2_780m.py: 48 layers, d_model
# 1536, d_inner 3072, 48 SSD heads of 64, state 128, chunk 128, conv 4,
# vocab 50,280, tied), zamba2-1.2b (38 Mamba2 layers of d_model 2048, the
# shared attention + MLP block before layers 0, 6, ..., 36) and
# whisper-large-v3 (32 encoder and 32 decoder layers, d_model 1280, 1,500
# frames), each at full width and depth
SSM_ARCH = "mamba2_780m"
SSM_SERVED = ("mamba2_780m", "zamba2_1p2b")
WHISPER_ARCH = "whisper_large_v3"
# the f32 check: (arch, batch, positions) -- the forward's logits at every
# position against those of one decode_step a position on the same tokens
# (whisper's encoder over its 1,500 frames first)
F32_CHECKS = {"mamba2_780m": (2, 256), "zamba2_1p2b": (2, 256),
              "whisper_large_v3": (2, 32)}
# its tolerance, a share of the forward's largest |logit|
F32_CHECK_SHARE = 1e-3
# the step regions: the forward loss at batch x seq, and the decode tick at
# batch after SSM_WARM_STEPS tokens
SSM_REGION = {"batch": 4, "seq": 512}
SSM_WARM_STEPS = 8
SSM_READINGS = {"reading": "ssm.jsonl", "replay": "ssm.jsonl"}
SSM_REPS = 1                # 3, then 2, cut to pay for phases 12 and 13
# mamba2 and zamba2 served as phase 7's model at a decode budget of 8 (16,
# launch/serve.py's default, before phase 13; cut to pay for it): the
# greedy loops that hold each request alone are most of the path's time
SSM_SERVE_ARGS = dict(SERVE_ARGS, max_new=8)
# the bf16 models served and probed as step regions at half their depth
# (mamba2: 24 of 48 layers; zamba2: 19 of 38, the shared block at 4 of its
# 7 places; full depth before phase 13, cut to pay for it); the f32
# checks stay at full depth
SSM_SERVED_LAYERS = {"mamba2_780m": 24, "zamba2_1p2b": 19}
# whisper's greedy decode in bf16: slots, steps, self cache length
WHISPER_DECODE = {"batch": 4, "steps": 16, "max_seq": 64}
SSM_CLI = {
    "probe_zamba2_decode_smoke": ["--arch", "zamba2-1.2b", "--kind",
                                  "decode"],
    "probe_whisper_train_smoke": ["--arch", "whisper-large-v3"],
    "probe_mamba2_decode_smoke": ["--arch", "mamba2-780m", "--kind",
                                  "decode"]}
# the routes the reference fails, each refused with its fault named
PAGED_ONLY = "paged serving needs an attention KV cache"
SSM_REFUSED = (
    (["--serve", "--arch", "mamba2-780m"], PAGED_ONLY),
    (["--serve", "--arch", "zamba2-1.2b"], PAGED_ONLY),
    (["--serve", "--arch", "whisper-large-v3"], PAGED_ONLY),
    (["--arch", "whisper-large-v3", "--kind", "decode"], "KeyError: 'frames'"))


def _free(label: str) -> None:
    """Collect the models of the paths before and print the card's free
    memory."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"free memory {label}: {free} of {total} bytes", flush=True)


def _draw(arch: str, f32: bool = False, n_layers: Optional[int] = None):
    """(api, params) of ``arch`` at full width and depth (``n_layers`` of
    its layers when given), drawn on the card from seed 0 (in f32 with
    ``f32``); prints its size."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(0, "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"{cfg.name} ({cfg.param_dtype}): {n} parameters ({nbytes} "
          f"bytes; config param_count {cfg.param_count()}) drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    return api, params, nbytes


def _graph_decode(api, params, cache: dict, batch: int):
    """``api.decode_step`` at ``batch`` captured once as a CUDA graph on
    static token and position buffers (after two warm-up calls on a side
    stream, as ``GraphStep``): returns ``step(tokens, pos) -> logits`` (the
    graph's output, overwritten by every call). After each replay the
    cache tensors the step returned anew (an SSM state is out of place) are
    copied into ``cache``'s, which the graph reads."""
    import torch

    tok = torch.zeros((batch, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((), dtype=torch.int32, device="cuda")
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(2):
            api.decode_step(params, cache, tok, pos)
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, new = api.decode_step(params, cache, tok, pos)
    moved = [(cache[g][n], new[g][n]) for g in cache for n in cache[g]
             if new[g][n] is not cache[g][n]]

    def step(tokens, p: int):
        tok.copy_(tokens)
        pos.fill_(p)
        graph.replay()
        for old, fresh in moved:
            old.copy_(fresh)
        return logits

    return step


def _f32_check(arch: str) -> dict:
    """The chunked (or blocked) forward against the recurrence, in f32 with
    TF32 off: logits at every position of the forward against those of one
    decode_step a position on the same tokens (the step replayed from a
    CUDA graph: eagerly the host's dispatch of ~2,800 kernels a step would
    take most of the phase)."""
    import torch

    api, params, _ = _draw(arch, f32=True)
    cfg = api.cfg
    batch, positions = F32_CHECKS[arch]
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (batch, positions),
                         generator=gen, dtype=torch.int32).cuda()
    fwd_batch = {"tokens": toks}
    if cfg.family == "encdec":
        frames = torch.randn((batch, cfg.enc_frames, cfg.d_model),
                             generator=gen).cuda()
        fwd_batch["frames"] = frames
        init = {"frames": frames, "max_seq": positions}
    else:
        init = {"tokens": toks[:, :1], "max_seq": positions}
    t0 = time.perf_counter()
    logits, _ = api.forward(params, fwd_batch)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode = _graph_decode(api, params, api.decode_init(params, init), batch)
    err = torch.zeros((), device="cuda")
    for t in range(positions):
        step = decode(toks[:, t:t + 1], t)
        err = torch.maximum(err, (step[:, 0] - logits[:, t]).abs().max())
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    scale = float(logits.abs().max())
    res = {"batch": batch, "positions": positions,
           "max_abs_err": float(err), "max_abs_logit": scale,
           "tol": F32_CHECK_SHARE * scale, "forward_s": t_fwd,
           "decode_s": t_dec}
    print(f"{cfg.name} f32 (TF32 off), forward against {positions} "
          f"decode steps at batch {batch}: {json.dumps(res)}; "
          f"{card_line()}", flush=True)
    if not (math.isfinite(scale) and bool(torch.isfinite(logits).all())):
        raise RuntimeError(f"{cfg.name}: the f32 forward is not finite")
    if not res["max_abs_err"] <= res["tol"]:
        raise RuntimeError(f"{cfg.name}: forward and decode logits differ "
                           f"by {res['max_abs_err']!r} > {res['tol']!r}")
    return res


def _greedy_alone(api, params, prompt: list, max_new: int, slots: int,
                  max_seq: int) -> list:
    """Greedy tokens of one request through ``decode_step`` alone: its
    prompt one token at a time at batch 1 (as the engine's sequential
    prefill), then decode steps at the engine's tick batch with the request
    in every row (the card's product kernels depend on the batch shape; a
    row's result does not depend on the other rows)."""
    import torch

    dev = "cuda"
    p = torch.tensor(prompt, dtype=torch.int32, device=dev)[None]
    cache = api.decode_init(params, {"tokens": p[:, :1], "max_seq": max_seq})
    for i in range(len(prompt)):
        logits, cache = api.decode_step(
            params, cache, p[:, i:i + 1],
            torch.tensor(i, dtype=torch.int32, device=dev))
    out = [int(torch.argmax(logits[0, -1]))]
    cache = {group: {name: cache[group][name].repeat_interleave(
                         slots, logical.index("cache_batch"))
                     for name, logical in axes.items()}
             for group, axes in api.cache_spec().items()}
    pos = torch.full((slots,), len(prompt), dtype=torch.int32, device=dev)
    cur = torch.full((slots, 1), out[0], dtype=torch.int32, device=dev)
    while len(out) < max_new and int(pos[0]) < max_seq - 1:
        logits, cache = api.decode_step(params, cache, cur, pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        out.append(int(nxt[0]))
        pos = pos + 1
        cur = nxt[:, None]
    return out


def _serve_sequential(api, params) -> dict:
    """``launch/serve.py``'s path at phase 7's settings on the dense layout
    (sequential prefill), and each request's tokens against
    ``_greedy_alone``."""
    from repro_torch.launch.serve import report, serve

    eng, reqs, dt = serve(api, params, **SSM_SERVE_ARGS)
    print(report(eng, reqs, dt), flush=True)
    if eng.paged:
        raise RuntimeError(f"{api.cfg.name}: served paged, want dense")
    for r in reqs:
        alone = _greedy_alone(api, params, r.prompt, r.max_new,
                              SSM_SERVE_ARGS["slots"],
                              SSM_SERVE_ARGS["max_seq"])
        if alone != r.out:
            raise RuntimeError(f"{api.cfg.name}: request {r.uid} served "
                               f"{r.out}, alone {alone}")
    rep = eng.report()
    n_tok = sum(len(r.out) for r in reqs)
    res = {"tok_s": n_tok / dt, "decode_tok_s": rep["decode_tok_s"],
           "total_tok_s": rep["total_tok_s"], "ticks": rep["ticks"],
           "prefill_calls": rep["prefill_calls"],
           "prefill_tokens": rep["prefill_tokens"], "wall_s": dt}
    print(f"{api.cfg.name} serve (dense, sequential prefill): "
          f"{json.dumps(res)}; greedy tokens equal to each request's alone; "
          f"{card_line()}", flush=True)
    return res


def _ssm_regions(tmp: str, api, params, weights_ms: float) -> dict:
    """The forward loss at ``SSM_REGION`` and the decode tick at its batch
    as step regions: phase 7's checks and timings, read once into a store
    and replayed with 0 measured."""
    import torch

    from repro_torch.core.injector import step_modes, step_region
    from repro_torch.launch.probe import (DEFAULT_GRAPH_MODES,
                                          step_region_name)

    cfg = api.cfg
    B, S = SSM_REGION["batch"], SSM_REGION["seq"]
    registry = step_modes("cuda")
    registry = {m: registry[m] for m in DEFAULT_GRAPH_MODES}
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32).cuda()
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32).cuda()
    batch = {"tokens": toks, "labels": labels}

    def loss(p, b):
        return api.loss(p, b)[0]

    cache = api.decode_init(params, B)
    pos = torch.zeros((B,), dtype=torch.int32, device="cuda")
    for i in range(SSM_WARM_STEPS):
        _, cache = api.decode_step(params, cache, toks[:, i:i + 1], pos + i)
    pos = pos + SSM_WARM_STEPS
    cur = toks[:, SSM_WARM_STEPS:SSM_WARM_STEPS + 1]

    def tick(p, c, t):
        return api.decode_step(p, c, t, pos)[0]

    cells = {step_region_name(cfg.name, "train", S, B): (loss,
                                                         (params, batch)),
             step_region_name(cfg.name, "decode", S, B): (tick,
                                                          (params, cache,
                                                           cur))}
    regions = [step_region(name, fn, args, registry)
               for name, (fn, args) in cells.items()]
    res = _check_and_time(regions, cells, weights_ms)
    res["verdicts"] = _read_regions(tmp, regions, SSM_READINGS, SSM_REPS)
    return res


def _whisper_decode(api, params) -> dict:
    """``decode_init`` with frames, then greedy decode steps through the
    model API (the reference's decode cell, launch/steps.py)."""
    import torch

    cfg = api.cfg
    B, steps = WHISPER_DECODE["batch"], WHISPER_DECODE["steps"]
    gen = torch.Generator().manual_seed(2)
    frames = torch.randn((B, cfg.enc_frames, cfg.d_model),
                         generator=gen).to("cuda", torch.bfloat16)
    t0 = time.perf_counter()
    cache = api.decode_init(params, {"frames": frames,
                                     "max_seq": WHISPER_DECODE["max_seq"]})
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cur = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    out = []
    t0 = time.perf_counter()
    for t in range(steps):
        logits, cache = api.decode_step(
            params, cache, cur, torch.tensor(t, dtype=torch.int32,
                                             device="cuda"))
        if (logits.shape != (B, 1, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all())):
            raise RuntimeError(f"{cfg.name}: decode step {t} gave "
                               f"{tuple(logits.shape)} logits, or not "
                               "finite ones")
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out.append(cur[:, 0].tolist())
    torch.cuda.synchronize()
    res = {"batch": B, "steps": steps, "decode_init_s": t_init,
           "ms_a_step": (time.perf_counter() - t0) / steps * 1e3,
           "cross_kv_bytes": sum(t.numel() * t.element_size()
                                 for t in cache["cross"].values()),
           "tokens_row0": [row[0] for row in out]}
    print(f"{cfg.name} bf16: decode_init over {cfg.enc_frames} frames, "
          f"then {steps} greedy decode steps: {json.dumps(res)}; "
          f"{card_line()}", flush=True)
    return res


def _refused(tmp: str) -> None:
    """The routes the reference fails exit with their fault named and no
    traceback (a SystemExit with the message) and write no store."""
    from repro_torch.launch.probe import main as probe_main

    for argv, fault in SSM_REFUSED:
        store = os.path.join(tmp, "refused.jsonl")
        try:
            probe_main(argv + ["--store", store])
        except SystemExit as e:
            msg = str(e.code)
            if fault not in msg or os.path.exists(store):
                raise RuntimeError(f"{' '.join(argv)}: refused with {msg!r}"
                                   f", want {fault!r} and no store")
            print(f"== python -m repro_torch.launch.probe {' '.join(argv)}"
                  f": refused: {msg}", flush=True)
            continue
        raise RuntimeError(f"{' '.join(argv)}: ran; the reference fails it")


def phase_ssm(tmp: str, kernels: Kernels) -> dict:
    """Phase 9: mamba2-780m, zamba2-1.2b and whisper-large-v3 at full width
    (the f32 checks and whisper at full depth, mamba2's and zamba2's bf16
    paths at ``SSM_SERVED_LAYERS``), then the smoke probes of the three
    families and the refused routes. Phase 8's model is freed first, and
    each model before the next."""
    from repro_torch.launch.probe import DEFAULT_GRAPH_MODES

    banner("9. the SSM, hybrid and encoder-decoder families: mamba2-780m, "
           "zamba2-1.2b and whisper-large-v3 at full width and depth")
    seconds: dict = {}
    counts = {name: [0, 0] for name in kernels.rows}
    graph = tuple(f"graph_{m}" for m in DEFAULT_GRAPH_MODES)
    res: dict = {}
    for arch in (SSM_ARCH, "zamba2_1p2b", WHISPER_ARCH):
        _free(f"before {arch}")
        res[f"{arch}_f32"] = drive(kernels, counts, seconds,
                                   f"f32_check_{arch}", (),
                                   partial(_f32_check, arch))
        _free(f"after the f32 check of {arch}")
        api, params, nbytes = _draw(arch, n_layers=SSM_SERVED_LAYERS.get(
            arch))
        weights_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if arch in SSM_SERVED:
            res[f"{arch}_serve"] = drive(
                kernels, counts, seconds, f"serve_{arch}", (),
                partial(_serve_sequential, api, params))
        if arch == SSM_ARCH:
            res[f"{arch}_regions"] = drive(
                kernels, counts, seconds, f"regions_{arch}", graph,
                partial(_ssm_regions, tmp, api, params, weights_ms))
        if arch == WHISPER_ARCH:
            res[f"{arch}_decode"] = drive(
                kernels, counts, seconds, f"decode_{arch}", (),
                partial(_whisper_decode, api, params))
        del api, params
    _free("after the full-width models")
    _probe_cli(tmp, kernels, counts, seconds, SSM_CLI)
    _refused(tmp)
    print("phase 9 wall time per path (s): "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print("phase 9 results: " + json.dumps(res), flush=True)
    for name, (n_cuda, n_plain) in counts.items():
        if n_cuda or n_plain:
            print(f"{name}: kernel {n_cuda} launches on phase 9's paths, "
                  f"plain version {n_plain} (the payload checks' oracle)")
    return {name: n_cuda for name, (n_cuda, _) in counts.items()}


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

# gemma-2b at full width and depth (src/repro_torch/configs/gemma_2b.py),
# bf16 params with f32 masters, TrainConfig's defaults (AdamW, remat
# "nothing") but warmup_steps=1 (lr > 0 from the first update); train_4k's
# sequence length (configs.base.SHAPES) at global batch 2 in 2
# microbatches, the lcg task, Trainer.run for 4 steps
TRAIN_ARCH = "gemma_2b"
TRAIN_RUN = {"batch": 2, "microbatches": 2, "steps": 4}
# step 0's loss against api.loss on the same params and batch, before the
# step: the reference's own microbatch tolerance (tests/test_train.py)
TRAIN_LOSS_REL = 2e-2
# the flash VJP at gemma-2b's attention widths, f32, TF32 off, against
# autograd through the blocked path: within FLASH_SHARE of each result's
# largest |value|
FLASH_VJP = {"batch": 1, "heads": 8, "kv_heads": 1, "head_dim": 256,
             "seq": 4096, "windows": (0, 1024)}
FLASH_SHARE = 1e-4
# remat at full width, 2 of the 18 layers, f32, TF32 off: the gradients
# under "nothing" and "dots" against "full", within REMAT_SHARE of each
# leaf's largest |g|
REMAT_CHECK = {"layers": 2, "batch": 1, "seq": 1024}
REMAT_SHARE = 1e-5
# mamba2-780m at full width and depth in bf16, remat "nothing"
SSM_TRAIN = {"batch": 4, "seq": 512, "steps": 2}
# the CLI at the smoke config for CLI_STEPS[0] steps, then a rerun to
# CLI_STEPS[1] that resumes; the restart replay of Trainer.run (fail at step
# 7, checkpoints every 3 steps); cut to pay for phase 12 from 20 and 40
# steps with checkpoints every 10, and a 15-step replay failing at 12
TRAIN_CLI = ["--arch", "gemma-2b", "--smoke", "--seq", "128", "--batch",
             "16", "--ckpt-every", "5"]
CLI_STEPS = (10, 20)
RESTART = {"steps": 9, "fail_at": 7, "ckpt_every": 3, "seq": 128,
           "batch": 16}
RESTART_TOL = 1e-6


def _state_bytes(state, microbatches: int) -> dict:
    """The training state's bytes by part, with the f32 gradient
    accumulator a step of several microbatches holds."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    params = list(state.params.parameters())
    out = {"params": nbytes(params),
           "master": nbytes((state.opt.master or {}).values()),
           "mu": nbytes(state.opt.mu.values()),
           "nu": nbytes(state.opt.nu.values())}
    if microbatches > 1:
        out["f32_accumulator"] = sum(p.numel() * 4 for p in params)
    return out


def _train_steps(api, params, shape, tcfg, steps: int) -> dict:
    """``Trainer.run`` for ``steps`` steps on the lcg pipeline at
    ``shape`` from ``params`` (AdamW state drawn beside them): each step's
    metrics and wall seconds, the state's bytes and the peak memory; then
    one more step traced (``device_ms``): its device time, kernels and top
    device operations. Fails on a non-finite loss or grad norm."""
    import torch

    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.train import (Trainer, TrainState, adamw_init,
                                   make_train_step)

    cfg = api.cfg
    pipe = SyntheticPipeline(cfg, shape, task="lcg", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = TrainState(params=params, opt=adamw_init(params))
    trainer = Trainer(api, tcfg, device="cuda")
    state, hist = trainer.run(state, pipe, steps=steps)
    torch.cuda.synchronize()
    res = {"state_bytes": _state_bytes(state, tcfg.microbatches),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "steps": [{k: h[k] for k in ("step", "loss", "grad_norm", "lr",
                                        "wall_s")} for h in hist]}
    for h in hist:
        print(f"{cfg.name} step {h['step']}: loss {h['loss']!r} grad_norm "
              f"{h['grad_norm']!r} lr {h['lr']!r} wall {h['wall_s']!r} s",
              flush=True)
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise RuntimeError(f"{cfg.name}: step {h['step']} gave loss "
                               f"{h['loss']!r}, grad norm {h['grad_norm']!r}")
    dev_ms, per_kernel, n_kernels, whole = device_ms(
        partial(make_train_step(api, tcfg), state, pipe.batch(steps)),
        reps=1, windows=1)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    res["trace"] = {"device_ms": dev_ms, "kernels_a_step": n_kernels,
                    "device_records_whole": whole, "top_ms": dict(top)}
    print(f"{cfg.name}: one more step traced: device {dev_ms!r} ms in "
          f"{n_kernels} kernels (whole: {whole}); top device operations "
          f"(ms a step): {json.dumps(dict(top))}", flush=True)
    return res


def _train_bound(cfg, tokens: int, seq: int, batch_rows: int) -> dict:
    """The step's least time: max(FLOPs / the bf16 peak, the optimizer's
    bytes / the HBM rate). FLOPs: 8·N·D (forward, the recomputed forward
    of remat "nothing", and the backward's two) plus 4× the causal
    attention's forward products (QK^T and PV over the S(S+1)/2 pairs a
    head sees); optimizer bytes: each parameter's f32 gradient sum read,
    its master, mu and nu read and written, its bf16 copy written."""
    n = cfg.param_count()
    pairs = seq * (seq + 1) // 2
    attn_fwd = (2 * 2 * pairs * cfg.head_dim * cfg.n_heads * batch_rows
                * cfg.n_layers)
    flops = 8 * n * tokens + 4 * attn_fwd
    opt_bytes = n * (4 + 3 * 8 + 2)
    return {"flops": flops, "optimizer_bytes": opt_bytes,
            "flops_s": flops / BF16_FLOPS,
            "bytes_s": opt_bytes / HBM_BYTES_PER_S,
            "bound_s": max(flops / BF16_FLOPS, opt_bytes / HBM_BYTES_PER_S)}


def _train_gemma() -> dict:
    """(a) gemma-2b at full width and depth: step 0's loss against
    ``api.loss`` computed first, then 4 steps; tokens a second over steps
    2-4 beside the step's bound."""
    import torch

    from repro_torch.configs import SHAPES, ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticPipeline

    api, params, _ = _draw(TRAIN_ARCH)
    cfg = api.cfg
    seq = SHAPES["train_4k"].seq_len
    shape = ShapeConfig("train_4k", "train", seq, TRAIN_RUN["batch"])
    batch0 = SyntheticPipeline(cfg, shape, task="lcg", device="cuda").batch(0)
    with torch.no_grad():
        want = float(api.loss(params, batch0)[0])
    del batch0
    tcfg = TrainConfig(warmup_steps=1,
                       microbatches=TRAIN_RUN["microbatches"])
    res = _train_steps(api, params, shape, tcfg, TRAIN_RUN["steps"])
    del params
    tokens = TRAIN_RUN["batch"] * seq
    later = res["steps"][1:]
    res.update(forward_loss=want, tokens_per_step=tokens,
               tok_s_steps_2_4=tokens * len(later)
               / sum(h["wall_s"] for h in later),
               bound=_train_bound(cfg, tokens, seq, TRAIN_RUN["batch"]))
    got = res["steps"][0]["loss"]
    res["loss_rel_diff"] = abs(got - want) / abs(want)
    print(f"{cfg.name} training at full width and depth, {tokens} tokens a "
          f"step in {tcfg.microbatches} microbatches: {json.dumps(res)}; "
          f"{card_line()}", flush=True)
    if not res["loss_rel_diff"] <= TRAIN_LOSS_REL:
        raise RuntimeError(f"{cfg.name}: step 0's loss {got!r} against "
                           f"api.loss {want!r}: past {TRAIN_LOSS_REL}")
    return res


def _flash_vjp() -> dict:
    """(b) ``FlashAttention`` against autograd through the blocked path at
    gemma-2b's attention widths (the KV head repeated to the 8 query
    heads, so dk and dv sum over them), causal and windowed."""
    import torch

    from repro_torch.models import attention as attn

    c = FLASH_VJP
    B, H, KH, S, hd = (c["batch"], c["heads"], c["kv_heads"], c["seq"],
                       c["head_dim"])
    gen = torch.Generator().manual_seed(3)
    q0, do = (torch.randn((B, H, S, hd), generator=gen).cuda()
              for _ in range(2))
    k0, v0 = (torch.randn((B, KH, S, hd), generator=gen).cuda()
              for _ in range(2))
    pos = torch.arange(S, device="cuda")
    res = {}
    for window in c["windows"]:
        outs = {}
        for impl in ("flash", "blocked"):
            q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
            kf = k.repeat_interleave(H // KH, dim=1)
            vf = v.repeat_interleave(H // KH, dim=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if impl == "flash":
                out = attn.sdpa_flash(q, kf, vf, causal=True, window=window)
            else:
                def mask_fn(qpos, kidx, window=window):
                    keep = qpos[:, None] >= pos[kidx][None, :]
                    if window:
                        keep &= qpos[:, None] - pos[kidx][None, :] < window
                    return keep

                out = attn._sdpa_blocked(None, q, kf, vf, mask_fn, pos, 1024)
            grads = torch.autograd.grad(out, (q, k, v), do)
            torch.cuda.synchronize()
            outs[impl] = ((out.detach(),) + grads,
                          time.perf_counter() - t0)
        row = {"flash_s": outs["flash"][1], "blocked_s": outs["blocked"][1]}
        for name, got, want in zip(("out", "dq", "dk", "dv"),
                                   outs["flash"][0], outs["blocked"][0]):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            row[name] = {"max_abs_err": err, "tol": FLASH_SHARE * scale}
            if not err <= FLASH_SHARE * scale:
                raise RuntimeError(f"flash VJP, window {window}: {name} "
                                   f"differs by {err!r} > "
                                   f"{FLASH_SHARE * scale!r}")
        res[f"window_{window}"] = row
    print(f"flash VJP at B {B}, {H} heads (KV {KH} repeated), hd {hd}, seq "
          f"{S}, f32, TF32 off, against autograd through the blocked path:"
          f" {json.dumps(res)}", flush=True)
    return res


def _remat_check() -> dict:
    """(c) gemma-2b at full width and REMAT_CHECK's layers in f32: the
    gradients under every remat policy, against "full"; the peak memory
    each call adds to what was allocated before it."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build
    from repro_torch.train import loss_and_grads

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=REMAT_CHECK["layers"],
                              param_dtype="float32", compute_dtype="float32")
    api = build(cfg)
    params = api.init(0, "cuda")
    gen = torch.Generator().manual_seed(4)
    shape = (REMAT_CHECK["batch"], REMAT_CHECK["seq"])
    batch = {name: torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 dtype=torch.int32).cuda()
             for name in ("tokens", "labels")}
    grads, res = {}, {}
    for remat in ("full", "dots", "nothing"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, _, grads[remat] = loss_and_grads(api, params, batch, remat=remat)
        torch.cuda.synchronize()
        res[remat] = {"s": time.perf_counter() - t0,
                      "peak_bytes_above_start":
                          torch.cuda.max_memory_allocated() - base}
    for remat in ("dots", "nothing"):
        worst = 0.0
        for name, want in grads["full"].items():
            err = float((grads[remat][name] - want).abs().max())
            worst = max(worst, err / max(float(want.abs().max()), 1e-30))
        res[remat]["max_share_of_max_g"] = worst
        res[remat]["bitwise"] = all(
            torch.equal(grads[remat][n], g) for n, g in grads["full"].items())
        if not worst <= REMAT_SHARE:
            raise RuntimeError(f"remat {remat}: gradients differ from "
                               f"'full' by {worst!r} of a leaf's largest "
                               f"|g| > {REMAT_SHARE}")
    print(f"remat at full width, {cfg.n_layers} layers, f32, TF32 off, "
          f"{shape[0]} x {shape[1]} tokens: {json.dumps(res)}", flush=True)
    return res


def _train_ssm() -> dict:
    """(d) mamba2-780m at full width and depth: SSM_TRAIN's steps."""
    from repro_torch.configs import ShapeConfig, TrainConfig

    api, params, _ = _draw(SSM_ARCH)
    shape = ShapeConfig("ssm_train", "train", SSM_TRAIN["seq"],
                        SSM_TRAIN["batch"])
    res = _train_steps(api, params, shape, TrainConfig(warmup_steps=1),
                       SSM_TRAIN["steps"])
    print(f"{api.cfg.name} training at full width and depth, "
          f"{SSM_TRAIN['batch']} x {SSM_TRAIN['seq']} tokens: "
          f"{json.dumps(res)}; {card_line()}", flush=True)
    return res


def _final_losses(stdout: str) -> tuple:
    """(final, first) from the CLI's last line."""
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("final loss:")][-1]
    final, first = line.removeprefix("final loss:").split("(first:")
    return float(final), float(first.rstrip(") "))


def _train_cli(tmp: str) -> dict:
    """(e) the CLI at the smoke config, a rerun that resumes from its
    checkpoint; then ``Trainer.run`` with a failure at RESTART's step,
    against the same run without one."""
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import ShapeConfig, TrainConfig, get_smoke_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models.model import build
    from repro_torch.train import Trainer

    import logging

    from repro_torch.launch.train import main as train_main

    ckpt_dir = os.path.join(tmp, "train_ckpt")
    runs = []
    root = logging.getLogger()
    for steps in CLI_STEPS:
        argv = [*TRAIN_CLI, "--steps", str(steps), "--ckpt-dir", ckpt_dir]
        # its main in this process (_run_cli), its output captured; the
        # root logger's setting it makes is undone after it
        buf, level, handlers = io.StringIO(), root.level, root.handlers[:]
        try:
            with contextlib.redirect_stdout(buf):
                train_main(argv)
        except SystemExit as e:
            raise RuntimeError(f"launch.train --steps {steps} failed: "
                               f"{e.code}")
        finally:
            root.setLevel(level)
            root.handlers[:] = handlers
        print(f"== -m repro_torch.launch.train {' '.join(argv)}\n"
              f"{buf.getvalue()}", flush=True)
        runs.append(buf.getvalue())
    if f"resumed from checkpoint step {CLI_STEPS[0]}" not in runs[1]:
        raise RuntimeError(f"the rerun did not resume from step "
                           f"{CLI_STEPS[0]}")
    first_final, first_first = _final_losses(runs[0])
    second_final, _ = _final_losses(runs[1])
    if not second_final < first_first:
        raise RuntimeError(f"the resumed run's final loss {second_final} is "
                           f"not below the first run's first {first_first}")

    cfg = get_smoke_config(TRAIN_ARCH)
    api = build(cfg)
    shape = ShapeConfig("restart", "train", RESTART["seq"], RESTART["batch"])
    pipe = SyntheticPipeline(cfg, shape, task="lcg", device="cuda")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=20,
                       ckpt_every=RESTART["ckpt_every"])
    armed = [True]

    def fail(step):
        if step == RESTART["fail_at"] and armed[0]:
            armed[0] = False
            raise RuntimeError("injected failure")

    hists = []
    for injector, ckpt in ((fail, CheckpointManager(
            os.path.join(tmp, "restart_ckpt"), keep=2)), (None, None)):
        tr = Trainer(api, tcfg, ckpt_manager=ckpt, device="cuda")
        _, hist = tr.run(tr.init_state(), pipe, steps=RESTART["steps"],
                         fail_injector=injector)
        hists.append(hist)
    torch.cuda.synchronize()
    seen = [h["step"] for h in hists[0]]
    at = RESTART["fail_at"]
    replayed = [h["loss"] for h in hists[0] if h["step"] == at]
    clean = hists[1][at]["loss"]
    res = {"cli_first_run": {"first": first_first, "final": first_final},
           "cli_resumed_final": second_final, "steps_seen": seen,
           "replayed_loss": replayed, "uninterrupted_loss": clean,
           "bitwise": replayed == [clean]}
    print(f"train CLI and restart replay: {json.dumps(res)}", flush=True)
    if seen.count(at) != 1 or seen[-1] != RESTART["steps"] - 1:
        raise RuntimeError(f"restart: steps seen {seen}")
    if not abs(replayed[0] - clean) <= RESTART_TOL:
        raise RuntimeError(f"restart: step {at}'s replayed loss "
                           f"{replayed[0]!r} against {clean!r}")
    return res


def phase_train(tmp: str, kernels: Kernels) -> dict:
    """Phase 10: training. Phase 9's models are freed first, and each
    path's before the next."""
    banner("10. training: gemma-2b at full width and depth, the flash VJP, "
           "remat, mamba2-780m, the CLI and the restart replay")
    seconds: dict = {}
    counts = {name: [0, 0] for name in kernels.rows}
    res: dict = {}
    paths = (("gemma", _train_gemma), ("flash_vjp", _flash_vjp),
             ("remat", _remat_check), ("ssm", _train_ssm),
             ("cli", partial(_train_cli, tmp)))
    for name, fn in paths:
        _free(f"before the training path {name}")
        res[name] = drive(kernels, counts, seconds, f"train_{name}", (), fn)
    _free("after the training paths")
    print("phase 10 wall time per path (s): "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print("phase 10 results: " + json.dumps(res), flush=True)
    return {name: n_cuda for name, (n_cuda, _) in counts.items()}


# ---------------------------------------------------------------------------
# phase 11: the static noise audit
# ---------------------------------------------------------------------------

def _probe_out(*args, env: Optional[dict] = None) -> tuple:
    """``python -m repro_torch.launch.probe ARGS`` through its ``main`` in
    this process (``_run_cli``'s environment, ``env`` added and taken away
    after); its output and its exit message printed; (exit code,
    output)."""
    from repro_torch.launch.probe import main as probe_main

    buf, rc = io.StringIO(), 0
    sys.stdout.flush()
    with _cli_env(), contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(buf):
        os.environ.update(env or {})
        try:
            probe_main(list(args))
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            if not isinstance(e.code, int):
                print(e.code, file=sys.stderr)
    text = buf.getvalue()
    print(text, end="" if text.endswith("\n") else "\n", flush=True)
    return rc, text


def _save_plan(tmp: str, name: str, targets: list):
    from repro_torch.fleet.plan import SweepPlan

    plan = SweepPlan(name=name, store=os.path.join(tmp, name, "store.jsonl"),
                     targets=targets, reps=2, shards=1, backend="cuda")
    return plan, plan.save(os.path.join(tmp, f"{name}.plan.json"))


def _audit_table(plan) -> dict:
    """Print the plan's audit records (verdict, survival a pattern, the
    predicted resource and the census delta); returns them by pair."""
    from repro_torch.core.campaign import CampaignStore

    records = CampaignStore(plan.store, readonly=True).audits
    for (region, mode), rec in sorted(records.items()):
        print(f"  {region} × {mode}: {rec['verdict']}"
              f"{' (' + rec['corruption'] + ')' if rec['corruption'] else ''}"
              f", survival {rec['survival']} a pattern, target "
              f"{rec['target']}, predicts {rec['predicted']}, agrees "
              f"{rec['agrees']}, pressure {rec['resources']}; "
              f"{rec['detail']}")
    return records


def _derived_bodies() -> dict:
    """|l1.l2| from the clean SASS of every region the port builds (small
    sizes: the SASS does not depend on them), and a step region's 0."""
    import torch

    from repro_torch.bench import kernels as bk
    from repro_torch.bench.studies import T3_SCENARIOS
    from repro_torch.core.controller import derive_body_size
    from repro_torch.core.injector import step_modes, step_region
    from repro_torch.kernels.region import pallas_region

    regions = [
        pallas_region("probe", n_steps=64),
        pallas_region("spmxv", n=512, nnz_per_row=16),
        pallas_region("spmxv", n=512, nnz_per_row=128),
        pallas_region("matmul", n=256),
        pallas_region("attention", seq=128),
        pallas_region("attention", seq=128, head_dim=128),
        bk.stream_region(n=4096), bk.lat_mem_rd_region(table_len=4096,
                                                       n_iter=16),
        bk.haccmk_region(n_iter=16), bk.spmxv_region(n=4096),
        bk.matmul_region(n=64), bk.matmul_region(n=64, optimized=True),
        *(bk.table3_target(name, kind, depth, 16, n=4096).region()
          for name, (kind, depth) in T3_SCENARIOS.items()),
        bk.livermore_target(16, n=4096).region(),
    ]
    bodies = {}
    for region in regions:
        site = region.sass("", 0)
        label = f"{region.name} [{site.source} {site.kernels[0][0]}]"
        if site.unroll > 1:
            label += (f" (an iteration's: the innermost loop's count over "
                      f"its {site.unroll}-iteration trip)")
        bodies[label] = derive_body_size(region)
    x = torch.zeros(1, device="cuda")
    step = step_region("step", lambda t: t * 2, (x,),
                       {"fp_add32": step_modes("cuda")["fp_add32"]})
    bodies["step region (a CUDA graph)"] = derive_body_size(step)
    print("derived |body| from the clean SASS: " + json.dumps(bodies))
    zero = [k for k, v in bodies.items() if not v and "step" not in k]
    if zero:
        raise RuntimeError(f"derive_body_size gave 0 for {zero}")
    return bodies


def _census_reports() -> dict:
    """The payload census of loop and step InjectionReports: payload from
    the aux oracle, overhead and body_ops from the SASS."""
    import torch

    from repro_torch.bench.kernels import stream_region
    from repro_torch.core.injector import step_modes, step_region
    from repro_torch.launch.probe import DEFAULT_GRAPH_MODES

    out = {}
    loop = stream_region(n=1 << 16)
    for mode in LOOP_MODES:
        out[f"stream_triad × {mode} k={STATIC_CHECK_K}"] = loop.payload_check(
            mode, STATIC_CHECK_K)
    registry = step_modes("cuda")
    x = torch.ones(1024, device="cuda")
    step = step_region("step", lambda t: t * 2, (x,),
                       {m: registry[m] for m in DEFAULT_GRAPH_MODES})
    for mode in DEFAULT_GRAPH_MODES:
        out[f"step × {mode} k={SERVE_KS[-1]}"] = step.payload_check(
            mode, SERVE_KS[-1])
    rows = {}
    for label, rep in out.items():
        rows[label] = {"payload": rep.payload, "expected": rep.expected,
                       "overhead": rep.overhead, "body_ops": rep.body_ops}
        if rep.payload != rep.expected or not rep.body_ops:
            raise RuntimeError(f"{label}: payload census {rep}")
    print("payload census (payload from the aux oracle; overhead and "
          "body_ops from the SASS): " + json.dumps(rows))
    return rows


def _check_sabotage(tmp: str) -> dict:
    """The sabotaged static fp probe (``REPRO_NOISE_SABOTAGE=const``),
    through the probe CLI's plan entry (``run_worker``): under the default
    gate the audit reads it dead with its class named and refuses it with
    the store holding no point; ``--audit warn`` measures it (and its
    payload check reads 0 surviving patterns)."""
    from repro_torch.core.campaign import CampaignStore
    from repro_torch.fleet.plan import TargetSpec

    plan, path = _save_plan(tmp, "sabotage", [TargetSpec(
        "pallas", ("fp",), {"kernel": "probe", "sizes": [MAIN_PROBE_STEPS]})])
    env = {"REPRO_NOISE_SABOTAGE": "const"}
    rc, out = _probe_out("--plan", path, env=env)
    store = CampaignStore(plan.store, readonly=True)
    rec = store.audits.get((f"pallas_probe_s{MAIN_PROBE_STEPS}", "fp"))
    if rec is None or rec["verdict"] != "dead" or not rec["corruption"]:
        raise RuntimeError(f"sabotage: the audit's record {rec}")
    if rc == 0 or "audit gate" not in out or store.points:
        raise RuntimeError(f"sabotage: the gate let the run through (exit "
                           f"{rc}; {sum(map(len, store.points.values()))} "
                           "points)")
    rc, out = _probe_out("--plan", path, "--audit", "warn", env=env)
    store = CampaignStore(plan.store, readonly=True)
    n_points = sum(len(v) for v in store.points.values())
    pay = (next(iter(store.done.values()), {}) or {}).get("payload") or {}
    if rc != 0 or not n_points or "--audit warn: measuring anyway" not in out:
        raise RuntimeError(f"sabotage: --audit warn did not measure (exit "
                           f"{rc}, {n_points} points)")
    print(f"sabotage: audit {rec['verdict']} ({rec['corruption']}), the gate "
          f"refused with 0 points stored, --audit warn measured {n_points} "
          f"points; their payload check: {pay.get('payload')}/"
          f"{pay.get('expected')} patterns survived")
    return {"verdict": rec["verdict"], "corruption": rec["corruption"],
            "warn_points": n_points, "payload": pay.get("payload")}


def _check_fixtures(tmp: str) -> dict:
    """Capture the audit's golden fixtures again on this card
    (``repro_torch.analysis.capture``, the builds' dumps this process read
    already reused) and hold their reports to
    the committed ``tests/golden_torch/audit_expected.json``: verdict,
    corruption class and predicted resource of every pair must be the
    same (a changed toolkit would have to be captured anew)."""
    import gzip

    from repro_torch.analysis.capture import capture

    out = os.path.join(tmp, "golden", "sass")
    got = capture(out, os.path.join(tmp, "golden", "audit_expected.json"))
    golden = os.path.join(HERE, "tests", "golden_torch")
    with open(os.path.join(golden, "audit_expected.json")) as f:
        want = json.load(f)
    keys = ("verdict", "corruption", "predicted", "agrees")
    differ = {name: ({k: got.get(name, {}).get(k) for k in keys},
                     {k: rec.get(k) for k in keys})
              for name, rec in want.items()
              if any(got.get(name, {}).get(k) != rec.get(k) for k in keys)}
    same = 0
    for name in want:
        with gzip.open(os.path.join(out, name + ".json.gz"), "rt") as f:
            new = json.load(f)
        with gzip.open(os.path.join(golden, "sass", name + ".json.gz"),
                       "rt") as f:
            old = json.load(f)
        same += all(new[k] == old[k] for k in ("clean", "lo", "hi"))
    print(f"golden fixtures: {same}/{len(want)} pairs' dumps byte-identical "
          f"to the committed ones; reports equal in {len(want) - len(differ)}"
          f"/{len(want)}")
    if differ or sorted(got) != sorted(want):
        raise RuntimeError(f"the card's census disagrees with the golden "
                           f"fixtures: {differ}")
    return {"pairs": len(want), "dumps_identical": same}


def phase_audit(tmp: str) -> dict:
    from repro_torch.core.calibration import CALIB_MODES
    from repro_torch.fleet.executor import audit_fleet_plan
    from repro_torch.fleet.plan import TargetSpec
    from repro_torch.launch.probe import DEFAULT_GRAPH_MODES

    banner("11. the static noise audit (SASS census at k = 4 and 12 and "
           "clean)")
    seconds, result = {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 2)
        return out

    print("== 11a. phase 4's main plan, audited in this process (the "
          "builds' SASS dumped and parsed in a thread pool; phase 4a runs "
          "it through `fleet run` under the gate and `fleet audit "
          "--expect-clean`)", flush=True)
    from repro_torch.analysis import AuditReport, audit_plan
    from repro_torch.core.campaign import CampaignStore

    plan, _ = _save_plan(tmp, "audit_main", main_targets())
    reports = timed("main plan census (in process)", audit_plan, plan)
    store = CampaignStore(plan.store)
    for rep in reports:
        print("  " + rep.explain())
        store.append({"kind": "audit", **rep.to_dict()})
    store.close()
    records = _audit_table(plan)
    if sorted(rec["verdict"] for rec in records.values()) \
            != ["intact"] * len(plan.grid()):
        raise RuntimeError("a main-path pair is not intact: " + "; ".join(
            AuditReport.from_dict(r).explain() for r in records.values()))
    not_agreeing = sorted(f"{r} × {m}" for (r, m), rec in records.items()
                          if rec["agrees"] is not True)
    print(f"main-path pairs whose predicted resource is not their target's: "
          f"{not_agreeing or 'none'}")
    result["main"] = {f"{r} × {m}": rec for (r, m), rec in records.items()}
    print("== 11b. a loop-region plan (the calibration regions: "
          "stream_kernel) and gemma-2b's decode step (graph_noise), audited "
          "in this process", flush=True)
    for name, target in (
            ("loop", TargetSpec("calibrate", CALIB_MODES, {})),
            ("step", TargetSpec("step", DEFAULT_GRAPH_MODES,
                                {"arch": "gemma-2b", "kind": "decode"}))):
        sub, _ = _save_plan(tmp, f"audit_{name}", [target])
        records = timed(f"{name} plan audit", audit_fleet_plan, sub)
        if [r.get("verdict") for r in records.values()] \
                != ["intact"] * len(sub.grid()):
            raise RuntimeError(f"{name} plan: not every pair intact")
        result[name] = {f"{r} × {m}": rec
                        for (r, m), rec in _audit_table(sub).items()}
    print("== 11c. the golden fixtures captured again", flush=True)
    result["fixtures"] = timed("fixture capture", _check_fixtures, tmp)
    print("== 11d. |body| and the payload census", flush=True)
    result["bodies"] = timed("derived bodies", _derived_bodies)
    result["census"] = timed("payload census", _census_reports)
    print("== 11e. the sabotaged static fp build", flush=True)
    result["sabotage"] = timed("sabotage", _check_sabotage, tmp)
    print("phase 11 seconds: " + json.dumps(seconds))
    result["seconds"] = seconds
    return result


# ---------------------------------------------------------------------------
# phase 12: the parallel layer on W = min(4, cards) NCCL ranks
# ---------------------------------------------------------------------------

MESH_MAX_RANKS = 4
# the process group's timeout: a collective two ranks disagree on fails the
# phase instead of hanging to the script's limit
MESH_GROUP_TIMEOUT_S = 120
MESH_JOIN_TIMEOUT_S = 600
# gemma-2b and qwen3-moe-30b-a3b at full width, depth cut to 2 layers (the
# phase's budget; gemma-2b's 18 train in phase 10), bf16 with f32 masters,
# TrainConfig's defaults with warmup 1 (lr 3e-4 at the first update), one
# step of 4 x 512 tokens (the lcg pipeline's step 0); gemma-2b on (W, 1)
# and, at W = 4, on (2, 2) and (1, 4), where its heads, ff and vocabulary
# split over model (tensor parallelism)
MESH_TRAIN = {"arch": "gemma_2b", "moe_arch": "qwen3_moe_30b_a3b",
              "layers": 2, "batch": 4, "seq": 512}
# W > 1 against the one-rank step on the same global batch: the gradients
# are bf16 (the mean of W shard gradients in f32 against one full-batch
# bf16 gradient parts at ~2^-8 of each), and Adam's first update is about
# g / |g| · lr, so an element whose gradient is near 0 may move either way:
# every f32 master within 2·lr, all but MESH_FLIP_SHARE of them within
# lr / 10; the loss within MESH_LOSS_RTOL, the grad norm within
# MESH_GNORM_RTOL
MESH_FLIP_SHARE = 1e-2
MESH_LOSS_RTOL = 1e-3
MESH_GNORM_RTOL = 1e-2
# the checkpoint check: gemma-2b's smoke config in f32 (TF32 off), lr 1e-3:
# saved after one mesh step, restored on rank 0 alone into a one-device
# state; the next step against the mesh's within MESH_CKPT_TOL (bitwise at
# W = 1; the CPU tests measure 1.6e-5 between two f32 reductions at lr
# 1e-3, tests/test_torch_mesh_train.py)
MESH_CKPT_TOL = 1e-4
# the ICI modes at the default NoiseScale (ici_kib 256) over the mesh's
# "model" axis of a (1, W) (data, model) mesh; their µs a pattern from
# run-time k in {0, ICI_TIMED_K} (CUDA events, median of TIMING_REPS)
ICI_MODES = ("ici_allreduce", "ici_allgather", "ici_a2a")
ICI_CHECK_KS = (1, 3)
ICI_TIMED_K = 64
ICI_RTOL = 1e-6
# gemma-2b's decode tick (MESH_TRAIN's 2 layers; phase 7's probe engine:
# 4 slots, prompt 128, max_new 8, page 16) as a step region under each ICI
# mode: payload = k at k in {1, 64}; one characterization at 3 reps a
# point into a store, then replayed with 0 measured
ICI_REGION_KS = (1, 64)
ICI_REGION_REPS = 3


def _mesh_setup(rank: int, world: int, tmp: str):
    """This rank's card and its NCCL process group (a FileStore under
    ``tmp``: no port, no network)."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
    return torch.device("cuda", rank)


def _say(rank: int, text: str) -> None:
    print(f"[rank {rank}] {text}", flush=True)


def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                    b.view(torch.int16) if b.dtype == torch.bfloat16 else b))


def _int8_by_leaf(grads: dict, residuals: dict) -> tuple:
    """``compress_int8`` applied to one-rank gradients as the reference's
    leaves hold them: the port's per-layer tensors of one reference leaf
    stacked (one scale), compressed with their residuals, decompressed and
    split again; (gradients in their dtype, new residuals)."""
    import torch

    from repro_torch.convert import reference_leaf
    from repro_torch.train.grad_compression import (compress_int8,
                                                    decompress_int8)

    groups: dict = {}
    for name in grads:
        groups.setdefault(reference_leaf(name), []).append(name)
    out, res = {}, {}
    for names in groups.values():
        g = torch.stack([grads[n].to(torch.float32) for n in names])
        r = torch.stack([residuals[n] for n in names])
        q, scale, new_r = compress_int8(g, r)
        dq = decompress_int8(q, scale)
        for i, n in enumerate(names):
            out[n] = dq[i].to(grads[n].dtype)
            res[n] = new_r[i]
    # in the gradients' order: the clip's norm sums them in it
    return {n: out[n] for n in grads}, res


def _one_rank_step(api, tcfg, batch, dev, *, compress=None, n_groups=None):
    """The one-rank step on the global batch: ``make_train_step`` without a
    mesh; with ``compress`` its gradients through ``_int8_by_leaf``, and
    with ``n_groups`` (a MoE on W > 1 ranks) the MoE's dispatch groups set
    as the mesh step sets them. (state, metrics)."""
    from repro_torch.train import (Trainer, adamw_update, loss_and_grads,
                                   make_train_step)

    state = Trainer(api, tcfg, compress=compress, device=dev).init_state()
    if compress is None and n_groups is None:
        return make_train_step(api, tcfg)(state, batch)
    kw = {"remat": tcfg.remat}
    if n_groups is not None:
        kw["n_groups"] = n_groups
    loss, aux, grads = loss_and_grads(api, state.params, batch, **kw)
    if compress:
        grads, new_r = _int8_by_leaf(grads, state.residuals)
        for n, r in state.residuals.items():
            r.copy_(new_r[n])
    _, _, stats = adamw_update(tcfg, state.params, grads, state.opt)
    return state, {"loss": loss, **stats, **aux}


def _held(rank, world, label, mesh_state, want, metrics, want_metrics, lr):
    """The mesh step's state (gathered) against the one-rank ``want``:
    bitwise at W = 1, else within the tolerances above. Every rank gathers;
    rank 0 compares and returns the record."""
    import torch

    # W = 1: every tensor (a gather of one rank is the tensor itself); else
    # the f32 masters
    gathered = {n: mesh_state.layout.gather(n, t)
                for n, t in mesh_state.tensors().items()
                if world == 1 or n.startswith("opt/master/")}
    if rank != 0:
        return None
    wanted = want.tensors()
    rec = {"metrics": {k: float(v) for k, v in metrics.items()},
           "one_rank_metrics": {k: float(v) for k, v in want_metrics.items()}}
    if world == 1:
        bad = [n for n in wanted if not _bits_equal(gathered[n], wanted[n])]
        bad += [k for k in want_metrics
                if not _bits_equal(metrics[k].float().reshape(()),
                                   want_metrics[k].float().reshape(()))]
        rec["bitwise"] = not bad
        if bad:
            raise RuntimeError(f"{label}: W = 1 not bitwise equal to the "
                               f"one-rank step in {bad[:8]}")
    else:
        errs, shares = [], []
        for n, t in wanted.items():
            if n not in gathered:
                continue
            err = (gathered[n] - t).abs()
            errs.append(float(err.max()))
            shares.append(float((err > lr / 10).float().mean()))
        rec.update(master_max_err=max(errs), master_share_past_lr_10=max(
            shares))
        rel = {k: abs(rec["metrics"][k] - rec["one_rank_metrics"][k])
               / max(abs(rec["one_rank_metrics"][k]), 1e-30)
               for k in ("loss", "grad_norm")}
        rec["metric_rel_err"] = rel
        if not (rec["master_max_err"] <= 2 * lr * (1 + 1e-3)
                and rec["master_share_past_lr_10"] <= MESH_FLIP_SHARE
                and rel["loss"] <= MESH_LOSS_RTOL
                and rel["grad_norm"] <= MESH_GNORM_RTOL):
            raise RuntimeError(f"{label}: the mesh step parts from the "
                               f"one-rank step: {json.dumps(rec)}")
    del gathered
    torch.cuda.empty_cache()
    return rec


def _state_bytes_local(state) -> int:
    return sum(t.numel() * t.element_size() for t in state.tensors().values())


def _mesh_train(rank: int, world: int, dev) -> dict:
    """(a) gemma-2b's mesh step, plain and int8, on (W, 1) and, at W = 4,
    (2, 2) and (1, 4) (its attention, MLP and vocabulary split over
    ``model``: tensor parallelism); (b) qwen3-moe-30b-a3b's plain step on
    (W, 1)."""
    import torch

    from repro_torch.configs import (MeshConfig, ShapeConfig, TrainConfig,
                                     get_config)
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models.model import build
    from repro_torch.parallel.sharding import make_mesh_from_config
    from repro_torch.train import Trainer

    c = MESH_TRAIN
    tcfg = TrainConfig(warmup_steps=1)
    shapes = [(world, 1)] + ([(2, 2), (1, 4)] if world == 4 else [])
    out = {}
    for arch, cases in ((c["arch"], [(s, comp) for s in shapes
                                     for comp in (None, "int8")]),
                        (c["moe_arch"], [((world, 1), None)])):
        cfg = dataclasses.replace(get_config(arch), n_layers=c["layers"])
        api = build(cfg)
        batch = SyntheticPipeline(cfg, ShapeConfig(
            "mesh", "train", c["seq"], c["batch"]), task="lcg",
            device=dev).batch(0)
        for shape, compress in cases:
            label = f"{cfg.name} x{c['layers']} {shape} {compress or 'plain'}"
            want = want_m = None
            if rank == 0:
                groups = world if cfg.n_experts and world > 1 else None
                want, want_m = _one_rank_step(api, tcfg, batch, dev,
                                              compress=compress,
                                              n_groups=groups)
            mesh = make_mesh_from_config(MeshConfig(shape,
                                                    ("data", "model")))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(api, tcfg, mesh=mesh, compress=compress, device=dev)
            state = tr.init_state()
            t0 = time.perf_counter()
            state, metrics = tr._step(state, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            nbytes = _state_bytes_local(state)
            peak = torch.cuda.max_memory_allocated()
            full = sum(math.prod(s) * state.tensors()[n].element_size()
                       for n, s in state.layout.shapes.items())
            _say(rank, f"{label}: state {nbytes} of {full} bytes "
                       f"({nbytes / full:.4f}), peak {peak} bytes, step "
                       f"{step_s:.3f} s; W = {world}")
            rec = _held(rank, world, label, state, want, metrics, want_m,
                        tcfg.lr)
            if rank == 0:
                rec.update(state_bytes=nbytes, full_state_bytes=full,
                           peak_bytes=peak, step_s=step_s, world=world)
                if cfg.n_experts:
                    print(f"{label}: balance loss {rec['metrics']['moe_lb_loss']!r}"
                          f" on the mesh, {rec['one_rank_metrics']['moe_lb_loss']!r}"
                          f" one rank with n_groups = {world}; W = {world}",
                          flush=True)
                print(f"{label}: {json.dumps(rec)}; W = {world}", flush=True)
                out[label] = rec
            del state, tr, want
            torch.cuda.empty_cache()
        del api, batch
    return out


def _mesh_ckpt(rank: int, world: int, dev, tmp: str) -> dict:
    """(c) gemma-2b's smoke config in f32: one mesh step on (W, 1), a
    checkpoint, a second mesh step; rank 0 restores the checkpoint into a
    one-device state and takes the second step alone."""
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import (MeshConfig, ShapeConfig, TrainConfig,
                                     get_smoke_config)
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models.model import build
    from repro_torch.parallel.sharding import make_mesh_from_config
    from repro_torch.train import Trainer, make_train_step

    cfg = dataclasses.replace(get_smoke_config(MESH_TRAIN["arch"]),
                              param_dtype="float32", compute_dtype="float32")
    api = build(cfg)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1)
    pipe = SyntheticPipeline(cfg, ShapeConfig("ckpt", "train", 64, 8),
                             task="lcg", device=dev)
    mesh = make_mesh_from_config(MeshConfig((world, 1), ("data", "model")))
    tr = Trainer(api, tcfg, mesh=mesh, device=dev)
    state, _ = tr._step(tr.init_state(), pipe.batch(0))
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    mgr.save(1, state)
    state, metrics = tr._step(state, pipe.batch(1))
    gathered = {n: state.layout.gather(n, t)
                for n, t in state.tensors().items()}
    if rank != 0:
        dist.barrier()
        return {}
    one = Trainer(api, tcfg, device=dev).init_state(seed=1)
    mgr.restore(1, like=one)
    one, one_m = make_train_step(api, tcfg)(one, pipe.batch(1))
    err = max(float((gathered[n].double() - t.double()).abs().max())
              for n, t in one.tensors().items())
    rec = {"saved_at": world, "restored_at": 1, "max_err": err,
           "loss": [float(metrics["loss"]), float(one_m["loss"])]}
    _say(rank, f"checkpoint saved at W = {world}, restored at W = 1: the "
               f"next step's largest difference {err!r} "
               f"(limit {0.0 if world == 1 else MESH_CKPT_TOL})")
    dist.barrier()
    if err > (0.0 if world == 1 else MESH_CKPT_TOL):
        raise RuntimeError(f"checkpoint: the restored step parts by {err}")
    return rec


def _ici_plain(name: str, v, world: int, k: int):
    """The reference's formula on the full v (every rank's input known: the
    same generator), in f64: the output of rank r and the aux."""
    import torch

    x = v.double()
    n = x.numel()
    if name == "ici_allreduce":
        for _ in range(k):
            x = (x * world) * (1.0 / world)
        return (lambda r: x), float(x.sum())
    shards = x.view(world, n // world)
    if name == "ici_allgather":
        for _ in range(k):
            shards = shards.mean(0, keepdim=True).expand(world, -1)
        return (lambda r: shards[r]), float(shards.sum())
    chunk = (n // world) // world
    head = shards[:, :world * chunk].reshape(world, world, chunk)
    for _ in range(k):
        head = head.transpose(0, 1)
    out = torch.cat([head.reshape(world, -1), shards[:, world * chunk:]], 1)
    return (lambda r: out[r]), float(out.sum())


def _mesh_ici(rank: int, world: int, dev) -> dict:
    """(d) the three ICI modes over the "model" axis, static and run-time
    k, against the reference's formula; their µs a pattern beside the
    analytic model's d_r."""
    import torch

    from repro_torch.configs import MeshConfig
    from repro_torch.configs.base import H100_SXM
    from repro_torch.core import noise
    from repro_torch.parallel.sharding import make_mesh_from_config

    mesh = make_mesh_from_config(MeshConfig((1, world), ("data", "model")))
    modes = noise.make_modes(mesh=mesh, ici_axis="model", device=dev)
    out = {}
    for name in ICI_MODES:
        m = modes[name]
        state = m.make_state(torch.Generator().manual_seed(0))
        full = noise.make_modes(device=dev)[name].make_state(
            torch.Generator().manual_seed(0))["v"]
        for k in ICI_CHECK_KS:
            want_v, want_aux = _ici_plain(name, full, world, k)
            for form, apply in (("static", m.apply), ("rt", m.apply_rt)):
                aux, new = apply(state, k)
                got = new["v"].double()
                err = float((got - want_v(rank)).abs().max()
                            / want_v(rank).abs().max())
                aux_err = abs(float(aux) - want_aux) / max(
                    float(full.double().abs().sum()), 1e-30)
                if not (err <= ICI_RTOL and aux_err <= ICI_RTOL):
                    raise RuntimeError(f"{name} {form} k={k}: output "
                                       f"{err!r}, aux {aux_err!r} from the "
                                       f"formula (W = {world})")
        t0 = time_ms(lambda: m.apply_rt(state, 0))
        tk = time_ms(lambda: m.apply_rt(state, ICI_TIMED_K))
        us = (tk - t0) / ICI_TIMED_K * 1e3
        d_r = m.pattern_cost(H100_SXM).time_on(H100_SXM)["ici"] * 1e6
        out[name] = {"us_a_pattern": us, "analytic_d_r_us": d_r,
                     "t0_ms": t0, f"t{ICI_TIMED_K}_ms": tk, "world": world}
        if rank == 0:
            over = ("NCCL's collective is a local copy at W = 1, not "
                    "NVLink" if world == 1 else "NCCL over NVLink")
            print(f"{name}: {us!r} µs a pattern over W = {world} rank(s) "
                  f"({over}), analytic "
                  f"d_r {d_r!r} µs (H100_SXM.ici_bw); outputs and aux "
                  f"within {ICI_RTOL} of the formula at k in "
                  f"{ICI_CHECK_KS}, static and run-time k; {card_line()}",
                  flush=True)
    return out


def _rank_zero_controller(reps: int):
    """A Controller whose choices every rank shares: each rank measures the
    sensitivity probe, rank 0's reading is broadcast (it picks the k
    sweep), and no sweep stops early (that would be a timing too), so every
    rank runs the same collectives in the same order."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.controller import Controller

    class RankZero(Controller):
        def probe_sensitivity(self, target, mode, deadline=None):
            s = torch.tensor([super().probe_sensitivity(target, mode,
                                                        deadline)],
                             dtype=torch.float64, device="cuda")
            dist.broadcast(s, src=0)
            return float(s)

    return RankZero(reps=reps, stop_ratio=float("inf"))


def _mesh_ici_regions(rank: int, world: int, dev, tmp: str) -> dict:
    """(e) gemma-2b's decode tick as a step region under each ICI mode on
    every rank: payload = k at k in ICI_REGION_KS, then one
    characterization into a store (rank 0's is the store; the other ranks
    keep a throwaway one) and a replay with 0 measured."""
    import torch

    from repro_torch.configs import MeshConfig, get_config
    from repro_torch.core import noise
    from repro_torch.core.campaign import Campaign, CampaignStore
    from repro_torch.core.injector import step_region
    from repro_torch.models.model import build
    from repro_torch.parallel.sharding import make_mesh_from_config
    from repro_torch.serve.load import engine_for_probe

    cfg = dataclasses.replace(get_config(MESH_TRAIN["arch"]),
                              n_layers=MESH_TRAIN["layers"])
    api = build(cfg)
    eng = engine_for_probe(api, api.init(0, dev), **SERVE_PROBE)
    _, _, tick, tick_args = eng.probe_cells()
    mesh = make_mesh_from_config(MeshConfig((1, world), ("data", "model")))
    registry = {m: mode for m, mode in noise.make_modes(
        mesh=mesh, ici_axis="model", device=dev).items() if m in ICI_MODES}
    region = step_region(f"gemma2b_x{MESH_TRAIN['layers']}_tick_ici_w{world}",
                         tick, tick_args, registry)
    payloads = {}
    for mode in ICI_MODES:
        for k in ICI_REGION_KS:
            rep = region.payload_check(mode, k)
            payloads[f"{mode}@{k}"] = rep.payload
            if rep.payload != k:
                raise RuntimeError(f"{region.name} {mode} k={k}: payload "
                                   f"{rep.payload}")
    store_dir = tmp if rank == 0 else os.path.join(tmp, f"rank{rank}_store")
    os.makedirs(store_dir, exist_ok=True)
    path = os.path.join(store_dir, f"{region.name}.jsonl")
    stats = []
    for reading in ("fresh", "replay"):
        camp = Campaign(CampaignStore(path),
                        _rank_zero_controller(ICI_REGION_REPS))
        try:
            rep = camp.characterize(region, ICI_MODES)
        finally:
            camp.store.close()
        stats.append({"measured": camp.stats.measured,
                      "replayed": camp.stats.cached})
        if rank == 0:
            print(f"{region.name} ({reading}, W = {world}): "
                  + ", ".join(f"{m} Abs^raw={r.fit.k1!r} max t(k)/t(0)="
                              f"{float(max(r.curve.ratios()))!r}"
                              for m, r in rep.results.items())
                  + f" => {rep.bottleneck.label}; {camp.stats}", flush=True)
    if stats[1]["measured"]:
        raise RuntimeError(f"{region.name}: the replay measured "
                           f"{stats[1]['measured']}")
    torch.cuda.synchronize()
    return {"payloads": payloads, "stats": stats, "world": world}


def _mesh_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 12; its results in ``tmp/rank<r>.json``."""
    sys.path.insert(0, SRC)
    import torch.distributed as dist

    dev = _mesh_setup(rank, world, tmp)
    seconds, res = {}, {}
    for name, fn in (("train", partial(_mesh_train, rank, world, dev)),
                     ("checkpoint", partial(_mesh_ckpt, rank, world, dev,
                                            tmp)),
                     ("ici", partial(_mesh_ici, rank, world, dev)),
                     ("ici_regions", partial(_mesh_ici_regions, rank, world,
                                             dev, tmp))):
        t0 = time.perf_counter()
        res[name] = fn()
        seconds[name] = round(time.perf_counter() - t0, 1)
    res["seconds"] = seconds
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh(tmp: str) -> dict:
    """Phase 12: the parallel layer on W = min(4, cards) ranks, one process
    a card, an NCCL group; every rank must finish within the join timeout
    (a rank still running is killed and the phase fails)."""
    import multiprocessing as mp

    import torch

    world = min(MESH_MAX_RANKS, torch.cuda.device_count())
    banner(f"12. the parallel layer: W = {world} NCCL rank(s) (one a card): "
           "the mesh training step (gemma-2b, qwen3-moe-30b-a3b at full "
           "width, 2 layers), the sharded checkpoint, the ICI modes and "
           "gemma-2b's decode tick under them")
    print(f"W = {world}", flush=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, tmp))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = t0 + MESH_JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.perf_counter()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise RuntimeError(f"phase 12: ranks {hung} still ran after "
                           f"{MESH_JOIN_TIMEOUT_S} s and were killed")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"phase 12: rank exit codes {codes}")
    with open(os.path.join(tmp, "rank0.json")) as f:
        res = json.load(f)
    res["world"] = world
    res["wall_s"] = round(time.perf_counter() - t0, 1)
    print(f"phase 12 (W = {world}): {json.dumps(res)}; {card_line()}",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 13: the dry-run surfaces
# ---------------------------------------------------------------------------

# the one-rank cells: gemma-2b at full width, its depth cut to 2 of 18
# layers as phase 12 cuts it (bf16, f32 masters); a training step of 4 x
# 512 tokens (M = 1) and a decode tick of 4 sequences against a cache of
# 4,096 positions, each traced on meta over a one-rank fake group, then the
# same ``CellProgram.fn`` run on the card over a one-rank NCCL group
DRYRUN_ARCH = "gemma_2b"
DRYRUN_LAYERS = 2
DRYRUN_TRAIN = {"batch": 4, "seq": 512}
DRYRUN_DECODE = {"batch": 4, "seq": 4096}
DRYRUN_REPS = 10
# the card's peak (max_memory_allocated over what the cell's arguments
# found allocated) against the trace's argument + temp bytes: within this
# share of them (the prediction in PERF.md, written before the first
# card run of this phase)
DRYRUN_MEM_SHARE = 0.05
# the production-mesh cells, traced on the host in a subprocess while the
# card runs the one-rank cells: (shape, multi-pod)
DRYRUN_HOST_CELLS = (("decode_32k", False), ("train_4k", False),
                     ("decode_32k", True))


def _card_tensor_bytes(tree) -> int:
    """The bytes of every tensor of ``tree`` on the card (modules'
    parameters, dicts, lists, dataclasses), each storage once."""
    import torch

    seen, total = set(), 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            key = x.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += x.numel() * x.element_size()
        elif isinstance(x, torch.nn.Module):
            stack.extend(x.parameters())
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return total


def _dryrun_cell(kind: str, mesh, device):
    """(CellProgram, ShapeConfig, ModelConfig) of one one-rank cell."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.models.model import build

    cfg = dataclasses.replace(get_config(DRYRUN_ARCH),
                              n_layers=DRYRUN_LAYERS)
    api = build(cfg)
    if kind == "train":
        shape = ShapeConfig("train_4x512", "train", DRYRUN_TRAIN["seq"],
                            DRYRUN_TRAIN["batch"])
        prog = steps.train_cell(api, shape, mesh, microbatches=1,
                                scan_group=1, device=device)
    else:
        shape = ShapeConfig("decode_4x4096", "decode", DRYRUN_DECODE["seq"],
                            DRYRUN_DECODE["batch"])
        prog = steps.decode_cell(api, shape, mesh, device=device)
    return prog, shape, cfg


def _start_host_cells(tmp: str) -> dict:
    """The production-mesh cells through ``python -m
    repro_torch.launch.dryrun`` (16 x 16 and 2 x 16 x 16 fake ranks, on the
    host), one process each, all started at once: {(shape, multi-pod):
    (start time, process)}."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    return {(shape, multi): (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma-2b", "--shape", shape, "--out", os.path.join(tmp, "dryrun"),
         *(["--multi-pod"] if multi else [])], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for shape, multi in DRYRUN_HOST_CELLS}


def _host_cells(tmp: str, started: dict) -> dict:
    """Each production-mesh cell's process joined (within 900 s, else
    killed) and its record read: it must print the ``OK`` line and its
    argument bytes must fit the card's memory."""
    from repro_torch.configs.base import H100_SXM

    out_dir = os.path.join(tmp, "dryrun")
    cells = {}
    for (shape, multi), (t0, proc) in started.items():
        mesh = "2x16x16" if multi else "16x16"
        try:
            text, _ = proc.communicate(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode or not text.startswith(
                f"OK   gemma_2b_{shape} [{mesh}]"):
            raise RuntimeError(f"dry-run {shape} [{mesh}] (exit "
                               f"{proc.returncode}): {text[-3000:]}")
        with open(os.path.join(out_dir, mesh, f"gemma_2b_{shape}.json")) as f:
            rec = json.load(f)
        args = rec["memory"]["argument_size_in_bytes"]
        if args > H100_SXM.hbm_bytes:
            raise RuntimeError(f"{shape} [{mesh}]: argument bytes {args} "
                               f"exceed {H100_SXM.hbm_bytes}")
        cells[f"{shape} [{mesh}]"] = {
            "roofline": text.splitlines()[1].strip(),
            "memory": rec["memory"], "trace_s": rec["compile_s"],
            "n_ops": rec["n_ops"],
            "wall_s": round(time.perf_counter() - t0, 1), "record": rec}
    return cells


def _analytic_route(tmp: str) -> list:
    """The report of the 16 x 16 records and ``launch.probe --analytic``
    on train_4k's record through the probe's entry point, twice: the
    second must replay every prediction (``--expect-no-measure``)."""
    import io

    from repro_torch.launch import probe
    from repro_torch.roofline import report

    print(report.render(os.path.join(tmp, "dryrun", "16x16")), flush=True)
    args = ["--analytic", "--arch", "gemma-2b", "--shape", "train_4k",
            "--dryrun-dir", os.path.join(tmp, "dryrun", "16x16"), "--store",
            os.path.join(tmp, "pred.jsonl")]
    _, first = probe.main(args)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, again = probe.main(args + ["--expect-no-measure"])
    print(buf.getvalue(), end="", flush=True)
    if not first.measured or again.measured or \
            again.cached != first.measured:
        raise RuntimeError(f"the analytic probe: {first} then {again}")
    return [ln.strip() for ln in buf.getvalue().splitlines()
            if ln.strip().startswith(("=>", "["))]


def phase_dryrun(tmp: str, started: dict) -> dict:
    """Phase 13: the dry-run held against the card, and the production
    meshes traced on the host beside it (``started`` by
    ``_start_host_cells`` before phase 12, so they overlap phase 12 and
    the card's cells)."""
    from repro_torch.parallel import fake

    banner("13. the dry-run surfaces: gemma-2b (full width, 2 layers) "
           "one-rank training step and decode tick traced on meta and run "
           "on the card; the 16x16 and 2x16x16 cells on the host; the "
           "analytic probe")
    t_phase = time.perf_counter()
    print(f"FakeProcessGroup available: {fake.available()}", flush=True)
    return _dryrun_phase(tmp, started, t_phase)


def _stop(started: dict) -> None:
    """Kill the host cells' processes that are still running."""
    for _, proc in started.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _dryrun_phase(tmp: str, started: dict, t_phase: float) -> dict:
    """The one-rank cells traced on meta, then run on the card over a
    one-rank NCCL group and held to the trace; then the host cells
    (``started``) joined and the analytic route run on their records."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.configs import MeshConfig
    from repro_torch.configs.base import H100_SXM
    from repro_torch.launch.dryrun import trace_program
    from repro_torch.parallel import fake
    from repro_torch.parallel.sharding import make_mesh_from_config
    from repro_torch.roofline.terms import analyze_trace
    from repro_torch.roofline.trace import OpTrace

    one = MeshConfig((1, 1), ("data", "model"))
    traced, seconds = {}, {}
    t0 = time.perf_counter()
    with fake.fake_world(1):
        mesh = make_mesh_from_config(one, "cpu")
        for kind in ("train", "decode"):
            prog, shape, cfg = _dryrun_cell(kind, mesh, "meta")
            trace, mem, _ = trace_program(prog)
            rep = analyze_trace(trace.ops, arch=DRYRUN_ARCH, shape=shape,
                                mesh_name="1x1", n_chips=1, hw=H100_SXM,
                                cfg=cfg, memory_stats=mem)
            traced[kind] = {"sigs": trace.signatures(), "memory": mem,
                            "report": rep}
            print(f"traced {kind}: {len(trace.ops)} ops; "
                  f"{rep.summary()}; args {mem['argument_size_in_bytes']} "
                  f"temp {mem['temp_size_in_bytes']}", flush=True)
            del prog, trace
    seconds["trace"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(
            seconds=MESH_GROUP_TIMEOUT_S))
    results, failures = {}, []
    try:
        mesh = make_mesh_from_config(one, "cuda")
        for kind in ("train", "decode"):
            want = traced[kind]
            mem = want["memory"]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            prog, shape, cfg = _dryrun_cell(kind, mesh, "cuda")
            torch.cuda.synchronize()
            arg_card = _card_tensor_bytes(prog.args)
            arg_alloc = torch.cuda.memory_allocated() - base
            with OpTrace() as card_trace:
                out = prog.fn(*prog.args)
                torch.cuda.synchronize()
            del out
            sigs = card_trace.signatures()
            same_ops = sigs == want["sigs"]
            if not same_ops:
                first = next((i for i, (a, b) in enumerate(
                    zip(sigs, want["sigs"])) if a != b),
                    min(len(sigs), len(want["sigs"])))
                failures.append(
                    f"{kind}: the card ran {len(sigs)} ops, the trace "
                    f"{len(want['sigs'])}; first difference at {first}: "
                    f"{sigs[first] if first < len(sigs) else None} against "
                    f"{want['sigs'][first] if first < len(want['sigs']) else None}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = prog.fn(*prog.args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del out
            ms = time_ms(lambda: prog.fn(*prog.args), reps=DRYRUN_REPS,
                         warmup=2)
            rep = want["report"]
            bound_ms = rep.bound_time * 1e3
            predicted = mem["argument_size_in_bytes"] + \
                mem["temp_size_in_bytes"]
            results[kind] = {
                "ops": len(sigs), "same_ops": same_ops,
                "argument_bytes_trace": mem["argument_size_in_bytes"],
                "argument_bytes_card": arg_card,
                "argument_allocated_card": arg_alloc,
                "temp_bytes_trace": mem["temp_size_in_bytes"],
                "peak_bytes_card": peak,
                "peak_over_argument_plus_temp": peak / predicted,
                "ms": ms, "bound_ms": bound_ms,
                "t_compute_ms": rep.t_compute * 1e3,
                "t_memory_ms": rep.t_memory * 1e3,
                "t_ici_ms": rep.t_ici * 1e3, "dominant": rep.dominant,
                "ms_over_bound": ms / bound_ms}
            print(f"{kind} on the card: {json.dumps(results[kind])}; "
                  f"{card_line()}", flush=True)
            if arg_card != mem["argument_size_in_bytes"]:
                failures.append(f"{kind}: argument bytes {arg_card} on the "
                                f"card, {mem['argument_size_in_bytes']} "
                                "traced")
            if ms < bound_ms:
                failures.append(f"{kind}: {ms} ms on the card beats the "
                                f"dry-run's bound {bound_ms} ms")
            if abs(peak - predicted) > DRYRUN_MEM_SHARE * predicted:
                failures.append(f"{kind}: peak {peak} bytes on the card, "
                                f"argument + temp {predicted} traced")
            del prog
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    seconds["card"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    host = _host_cells(tmp, started)
    seconds["host_wait"] = round(time.perf_counter() - t0, 1)
    for name, cell in host.items():
        print(f"dry-run {name}: {cell['roofline']}; memory "
              f"{json.dumps(cell['memory'])}; {cell['n_ops']} ops traced in "
              f"{cell['trace_s']:.1f} s, {cell['wall_s']} s with the "
              "process (host)", flush=True)
    t0 = time.perf_counter()
    for line in _analytic_route(tmp):
        print(f"analytic probe (replay): {line}", flush=True)
    seconds["analytic"] = round(time.perf_counter() - t0, 1)
    seconds["phase"] = round(time.perf_counter() - t_phase, 1)
    print(f"phase 13 seconds: {json.dumps(seconds)}; {card_line()}",
          flush=True)
    if failures:
        raise RuntimeError("phase 13: " + "; ".join(failures))
    return {"cells": results, "host": host, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 14: the port's examples
# ---------------------------------------------------------------------------

# train_lm at the reference's full class; 150 steps fail at 75, after the
# step-50 checkpoint, so steps 50-74 run twice (200 would fail at 100, on a
# checkpoint, and replay nothing)
EXAMPLE_TRAIN_ARGS = ("--dim", "768", "--layers", "12", "--steps", "150")
EXAMPLE_TRAIN_REPLAYED = tuple(range(50, 75))


def _example(name: str):
    """``examples/<name>.py`` loaded as a module (its ``main`` not run)."""
    import importlib.util

    path = os.path.join(HERE, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _example_quickstart() -> dict:
    reports = _example("torch_quickstart").main([])
    # the verdict: every pattern survived (payload = k by the aux oracle
    # and the SASS census); the loads' address arithmetic is overhead
    bad = [f"{key}/{mode}" for key, rep in reports.items()
           for mode, res in rep.results.items()
           if res.injection is None
           or res.injection.payload != res.injection.expected]
    if bad:
        raise RuntimeError(f"quickstart: payload != expected: {bad}")
    return {key: {"label": rep.bottleneck.label,
                  "abs_raw": rep.absorptions(),
                  "payload": {m: [r.injection.payload, r.injection.expected,
                                  r.injection.overhead]
                              for m, r in rep.results.items()}}
            for key, rep in reports.items()}


def _example_probe(tmp: str, record: Optional[dict]) -> dict:
    dryrun_dir = os.path.join(tmp, "dryrun", "16x16")
    if record is not None:          # phase 13's train_4k record
        os.makedirs(dryrun_dir, exist_ok=True)
        with open(os.path.join(dryrun_dir, "gemma_2b_train_4k.json"),
                  "w") as f:
            json.dump(record, f)
    probes, rep = _example("torch_probe_train_step").main(
        ["--dryrun-dir", dryrun_dir, "--store",
         os.path.join(tmp, "pred.jsonl")])
    short = {m: (pr.injection.payload, pr.injection.expected)
             for m, pr in probes.items()
             if pr.injection.payload != pr.injection.expected}
    if short:
        raise RuntimeError(f"probe_train_step: payload != expected: {short}")
    return {"measured": {m: pr.fit.k1 for m, pr in probes.items()},
            "analytic": rep.bottleneck.label,
            "record": "phase 13" if record is not None else "traced"}


def _example_serve() -> dict:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build
    from repro_torch.serve import ServeEngine

    ex = _example("torch_serve_lm")
    requests, dt = ex.main([])
    if not all(r.done for r in requests):
        raise RuntimeError("serve_lm: a request is not done")
    api = build(get_smoke_config(ex.ARCH))
    params = api.init(0, "cuda")        # the example's weights (seed 0)
    alone = []
    for r in requests:
        engine = ServeEngine(api, params, n_slots=1, max_seq=ex.MAX_SEQ,
                             temperature=0.0)
        solo = engine.submit(r.prompt, max_new=ex.MAX_NEW)
        engine.run()
        alone.append(solo.out == r.out)
    if not all(alone):
        raise RuntimeError(f"serve_lm: {alone.count(False)} of "
                           f"{len(alone)} requests differ from the same "
                           "request served alone")
    total = sum(len(r.out) for r in requests)
    return {"tokens": total, "seconds": dt, "tok_s": total / dt,
            "equal_alone": len(alone)}


def _example_train(tmp: str) -> dict:
    ex = _example("torch_train_lm")
    _, hist = ex.main([*EXAMPLE_TRAIN_ARGS, "--ckpt-dir",
                       os.path.join(tmp, "ckpt")])
    again = ex.replays(hist)
    if tuple(step for step, _, _ in again) != EXAMPLE_TRAIN_REPLAYED:
        raise RuntimeError(f"train_lm: replayed steps "
                           f"{[step for step, _, _ in again]}, not 50-74")
    differ = [(step, a, b) for step, a, b in again if a != b]
    if differ:
        raise RuntimeError(f"train_lm: replayed losses not bitwise equal "
                           f"to their first run: {differ[:5]}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise RuntimeError("train_lm: a loss is not finite")
    walls = sorted(h["wall_s"] for h in hist[1:])
    return {"executed": len(hist), "replayed": len(again),
            "loss": [round(h["loss"], 4) for h in hist
                     if h["step"] % 25 == 0 or h["step"] == 149],
            "median_s_a_step": walls[len(walls) // 2],
            "first_step_s": hist[0]["wall_s"]}


def phase_examples(tmp: str, kernels: Kernels,
                   record: Optional[dict] = None) -> dict:
    """Phase 14: the four examples through their mains on the card.
    ``record``: phase 13's train_4k 16 x 16 dry-run record, when it
    ran."""
    banner("14. the port's examples on the card: quickstart, "
           "probe_train_step, serve_lm, train_lm (768 x 12, 150 steps)")
    seconds: dict = {}
    counts = {name: [0, 0] for name in kernels.rows}
    res: dict = {}
    paths = (("quickstart", ("stream_triad", "haccmk"), _example_quickstart),
             ("probe_train_step", ("graph_fp_add32", "graph_mxu_fma128",
                                   "graph_vmem_ld", "graph_hbm_stream"),
              partial(_example_probe, tmp, record)),
             ("serve_lm", (), _example_serve),
             ("train_lm", (), partial(_example_train, tmp)))
    for name, kernel, fn in paths:
        _free(f"before the example {name}")
        res[name] = drive(kernels, counts, seconds, f"example_{name}",
                          kernel, fn)
        print(f"example {name}: {json.dumps(res[name])}; "
              f"{seconds[f'example_{name}']:.1f} s; {card_line()}",
              flush=True)
    _free("after the examples")
    print("phase 14 wall time per example (s): "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()})
          + f"; {card_line()}", flush=True)
    return {name: n_cuda for name, (n_cuda, _) in counts.items()}


PHASES = (1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14)   # 4 runs 4 and 5


def parse_phases(text: Optional[str]) -> list:
    """``--phases`` (e.g. ``1-3,11``) as the phases to run, in order; every
    phase without it. Phase 1 always runs; 5 is part of 4; 6 needs 3 and 4
    (its rows hold their errors and launches)."""
    if not text:
        return list(PHASES)
    chosen = {1}
    for part in text.split(","):
        lo, _, hi = part.strip().partition("-")
        try:
            span = range(int(lo), int(hi or lo) + 1)
        except ValueError:
            raise SystemExit(f"--phases: {part!r} is not N or N-M")
        for n in span:
            if n == 5:
                n = 4
            if n not in PHASES:
                raise SystemExit(f"--phases: no phase {n}; phases "
                                 f"{PHASES} (5 runs with 4)")
            chosen.add(n)
    if 6 in chosen and not {3, 4} <= chosen:
        raise SystemExit("--phases: phase 6 needs phases 3 and 4")
    return sorted(chosen)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke run of the "
                                             "PyTorch/CUDA port.")
    ap.add_argument("--phases", default=None,
                    help="the phases to run, e.g. 1-3,11 (default: all; "
                         "the full run is the proof)")
    phases = parse_phases(ap.parse_args(argv).phases)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)

    t_start = time.perf_counter()
    elapsed = {}

    def lap(phase: str) -> None:
        elapsed[phase] = round(time.perf_counter() - t_start
                               - sum(elapsed.values()), 1)

    card = phase_env()
    build_pool = None
    try:
        if 2 in phases:
            build_pool, finish_build = phase_build()
        lap("1-2")
        main_args = main_inputs() if {3, 6} & set(phases) else None
        max_err, launches, rows = {}, {}, []
        if 3 in phases:
            max_err = phase_check(main_args)
            lap("3")
        if build_pool is not None:
            finish_build()
            lap("2b")
    finally:
        if build_pool is not None:  # a failure leaves no build running on
            build_pool.shutdown(wait=False, cancel_futures=True)
    kernels = Kernels()
    if 4 in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            launches = phase_main(tmp, kernels)
        lap("4-5")
    if 6 in phases:
        rows = phase_timing(main_args, max_err, launches)
        lap("6")
    serve_launches = []
    for n, phase, prefix in ((7, phase_serve, "serve"),
                             (8, phase_moe, "moe"), (9, phase_ssm, "ssm"),
                             (10, phase_train, "train")):
        if n in phases:
            with tempfile.TemporaryDirectory(
                    prefix=f"chip_smoke_{prefix}_") as tmp:
                serve_launches.append(phase(tmp, kernels))
            lap(str(n))
    if 11 in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_audit_") as tmp:
            phase_audit(tmp)
        lap("11")
    train_4k = None
    with contextlib.ExitStack() as stack:
        if 13 in phases:    # its host traces run beside phase 12
            dry_tmp = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_"))
            started = _start_host_cells(dry_tmp)
            stack.callback(_stop, started)  # a failure leaves none behind
        if 12 in phases:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
                phase_mesh(tmp)
            lap("12")
        if 13 in phases:
            train_4k = phase_dryrun(dry_tmp, started)[
                "host"]["train_4k [16x16]"]["record"]
            lap("13")
    if 14 in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
            serve_launches.append(phase_examples(tmp, kernels, train_4k))
        lap("14")
    print(f"\nwall time per phase (s): {json.dumps(elapsed)}")
    for row in rows:        # the serving, training and example paths too
        row["launches"] += sum(n[row["name"]] for n in serve_launches)
    print(f"\nchip_smoke: {'all phases' if phases == list(PHASES) else 'phases ' + ','.join(map(str, phases))} "
          f"passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    if rows:
        print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
