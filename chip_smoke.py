#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  (a) card: name and power limit from nvidia-smi; build every kernel from
      src/repro_torch/csrc, one nvcc per source, all started together, with
      each build's seconds, each kernel's registers and spills, and each
      library's count of HGMMA (tensor-core) instructions in its SASS,
      which must not be 0 for flash attention and A^T B;
  (b) each kernel against its plain PyTorch version on the card, at the main
      paths' shapes and small cases: flash attention in bf16 and fp32 (head
      dims 256, 128, 80 and 32), the chunked WKV in fp32 (two decay regimes,
      an initial state, rwkv6's training shape (2, 1024, 32, 64); at the main
      shape its three stages' scratch after the scan over the chunks against
      the plain stages, two runs bit for bit, each stage's ms, the scratch
      bytes, registers and spills), the chunked
      SSD forward in fp32 (three chunk-parallel stages and a scan over the
      chunks, the products in 3xTF32 on the tensor cores; Y and the final
      state against the plain version in fp32 and fp64, in three decays,
      the JAX sweep and from initial states; at the main shape its stage-2
      states against the plain stages and bit for bit against the
      backward's, two runs bit for bit, each stage's ms, registers and
      spills, both bounds and the design's bytes; at zamba2-2.7b's serving
      shape (4, 4224, 80, 64) from a zero state with the final state, its
      ms, both bounds and each stage's ms), A^T B in fp32 and bf16
      (the JAX sweep, a ragged shape, the
      METG ladder); error against the stated tolerance, kernel / plain /
      library ms and the bound, and the kernel and tiling each case took
      (bf16 flash and A^T B: the tensor cores), held equal to what the
      launchers' `route` / `plan` state; the gemma2 row's library call is
      torch.compile(flex_attention) with its softcap and band, the zamba2
      row's SDPA, at its training shape and at its serving shape (4, 4200,
      32, 80) in bf16, and the batch-1 shapes the served batches now run
      (flash (1, 4200, 16/4, 256) beside torch.compile(flex_attention),
      (1, 4200, 32, 80) beside SDPA and deepseek-7b's (1, 4200, 32/32,
      128) beside SDPA; deepseek-v2-lite-16b's MLA prefill at q/k head dim
      192 and v head dim 128, (1, 4200, 16/16, 192/128), qwen2-vl-2b's
      (1, 4200, 16/2, 128), qwen2.5-32b's (1, 4200, 48/8, 128) and
      deepseek-67b's and arctic-480b's (1, 4200, 64/8, 128), each beside
      SDPA (torch.compile(flex_attention) if SDPA refuses the shape; the
      last two in fp32 too), and the 192/128 pair at a ragged GQA case
      (2, 203, 8/2) in bf16 and fp32; the WKV at (1, 4224, 32, 64), the SSD
      at (1, 4224, 80, 64) with its final state: "serve_b1" in the JSON
      rows); flash at whisper-base's three served shapes in bf16 and
      fp32, each beside SDPA: the encoder (1, 1500, 16/8, 64) and the
      cross-attention (432 queries against 1500 keys) with causal=False,
      the decoder's self-attention (1, 432, 16/8, 64) causal; probs_bf16
      at the encoder's shape against the plain version with the flag at
      the kernel's 64-key tiles, and rows without an allowed key (not causal, a window) exactly 0; then
      the SSD backward kernels (three chunk-parallel
      stages and the sum over head groups, the products in 3xTF32 on the
      tensor cores) against autograd through the plain version and against
      the plain backward `ssd_chunked_bwd` (fp32 at the main shape in three
      decays and the JAX sweep, bf16 to one rounding), the states after
      their scan over the chunks against the plain stages, two runs bit for
      bit, its ms and each stage's, both bounds (fp32 rate; products at
      the TF32 rate), each product's route, beside the recompute's ms
      (autograd of the plain version, the op's backward before it had a
      kernel); the gradients through the flash op against autograd through
      its plain version, and its backward's ms, also not causal at 448
      queries against 1500 keys and at q/k 192 with v 128, each also
      against the plain version's fp64 autograd;
  (c) the main paths, each with the launch counts set to 0 just before and
      read just after: the paper's dwork scheduler running the METG ladder
      of A^T B tasks (launch.metg: n = 256 ... 4096, backlogs of up to
      20,000 tasks and a gather task each, through Client.run_loop,
      OverlapClient and the futures front door `repro_torch.client.Client`),
      with every task completed without error and one kernel launch per
      task besides the launches made without the scheduler; the front
      door's schedulers on the card: 2,000 A^T B tasks at n = 256 and 1024
      through `Client` as dwork, pmake and mpi_list (rank blocks through
      `map`), dwork on a ShardedHub of 4, dwork on two threads, dwork
      with a transient fault on every first attempt, retries and a journal,
      and dwork behind the forwarding tree (`transport="tree"`, 8 workers,
      4 a leaf), alone and composed with a ShardedHub of 4
      (every future ok, one C in 64 against the plain version, one launch a
      task run, completed == created with 0 errors, `Engine.recover` finds
      nothing to redo, the tree's stats and hop ops present; ms a task,
      efficiency, empirical overhead and its crosscheck printed, and the
      mean us of each `hop:L1` / `hop:L1:s<j>` op); the proc transport
      (`transport="proc"`, 4 worker processes, each with its own CUDA
      context launching `tiled_matmul` for its tasks,
      `launch.metg.proc_matmul`): 1,000 fp32 A^T B tasks at n = 256 and
      1024 (every future ok, each C's sum against the plain one, one C in
      64 held in the worker, the pids exactly `worker_pids()`' and none
      this process's, every worker launching, the launches summed over
      the processes equal to the tasks run; one /stats and /metrics scrape
      with `repro_worker_rss_bytes` for every worker and the xfer section;
      ms a task and efficiency beside the in-process dwork rows), a fan-in
      of 64 producers' 4 MiB C to 64 consumers (each consumer's sum held,
      peer fetches > 0, none lost, a producer's C materialized here), and
      a SIGKILL drill (one worker killed mid-run of 400 tasks: every
      future ok once, requeued >= 1, completed == created with 0 errors);
      the paper's other two schedulers: pmake's
      `launch.campaign` with its defaults (reduced gemma2-2b, 2 shards of 6
      steps, 2 nodes; 3 tasks done, 0 errors, a report of 2 shards of 6
      steps, one flash op call per layer and step in each shard's log)
      and its rerun (no task run, no log rewritten), then a campaign of the
      same shape at full width (gemma2-2b, 2 steps at batch 2 x 1024 a
      shard) through `PMake(..., total_nodes=1)`: 26 flash op calls a step
      in each shard's log, finite losses, 0 errors, the shards one after the
      other, each task's wall from `PMake.log` beside the train's own step
      ms; mpi-list's engine-backed `Context(16, engine_workers=4)` mapping
      2,000 fp32 A^T B elements at n = 1024, with and without seeded
      stragglers (one launch an element, one C in 64 against the plain
      version, `straggler_crosscheck()` and the mean sync gap printed);
      the DFM bridge `mesh_ops` on a seeded fp32 DFM of 2^26 rows and a
      pytree, against numpy (map, sum, reduce, scan, group into 7 buckets
      exactly against a stable argsort; each operation's ms), then the
      same DFMs (the fp32 one's first 2^22 rows) through the bridge on a
      1x1 mesh on the card (a world-size-1 group made and destroyed
      there), every result equal to the one-device path's bit for bit; the
      `ElasticPool` crash drill (256 A^T B shards, a worker crashing after
      3: all complete, at least one requeued, one launch a shard run,
      `remesh` at the live counts) and `run_pool` over a TaskServer of
      2,000 A^T B tasks (completed == created, 0 errors, one launch a
      task); `launch.metg`'s table of all three schedulers' METG (printed
      by the ladder's run) held to the paper's ordering; serve 4 requests of 4200-token prompts through
      `launch.serve`, which answers them through `Client.serve`'s
      METG-batching frontend at one worker (four batches of 1), for
      full-width gemma2-2b (26 layers) and full-width rwkv6-1.6b (24
      layers), random weights from a seed; every request ok, the batches
      the frontend formed, the backend's completed == created == batches
      with 0 errors and 0 requeues, the trace's latency p50/p95/p99; every
      kernel of the path must have launched once per layer and prefill
      batch, the kernel path's prefill must agree with the plain path's,
      and the served first tokens are the prefill's argmax in the batches
      they were served in.  After the gemma2-2b serve, one served prefill
      batch (1 x 4200, into the cache serve gives it) runs under
      `launch.hlo_analysis.analyze`: 26 flash launches inside, its FLOPs
      and HBM bytes equal exactly to the same call counted on meta
      tensors, and its roofline's compute and memory terms (H100 data-sheet
      rates) printed beside the measured prefill ms.  The gemma2-2b serve runs with its observability
      on (`--stats-port P --trace-out build/chip_trace/gemma2.trace.json`):
      a thread scrapes /health, /stats and /metrics at least 3 times while
      it serves (every scrape ok, /metrics Prometheus text whose
      repro_tasks_completed_total never decreases, /stats with the
      reference's engine keys), the Chrome trace loads with one task span
      a batch and one request span a request, and the critical path of the
      returned trace (the batches chained in the order the worker ran
      them) names every batch, its attribution summing to its makespan
      within 5 %; the makespan and its compute and scheduler shares are
      printed beside the p99.  Then the same traffic
      through full-width zamba2-2.7b (54 Mamba2 layers, the shared block 9
      times), through the front door as above: 54 SSD op calls and 9 flash
      launches per prefill batch and
      none in decode; the kernel path's prefill against the plain path's in
      bf16 (printed) and fp32 (held: logits, every layer's SSM state and
      conv ring, the K/V caches), the kernel path's prefills timed; in
      fp32 the chunked prefill of each prompt's first 130 tokens against
      130 decode steps (logits, states, rings, K/V); the served first
      tokens are the bf16 prefill's argmax; one bf16 prefill and one
      decode step under torch.profiler (device ms, idle share, the kernels
      with the most device time).  Then the same traffic through
      full-width deepseek-7b (30 layers, d_model 4096, 32 heads of 128,
      random weights from a seed): the front door's checks, 30 flash
      launches a prefill batch, the first served batch's prefill kernel
      path against plain path (held in fp32, printed in bf16), the served
      first tokens the bf16 prefill's argmax; prefill ms, decode ms a
      token, p50/p95/p99 and the peak memory printed.  Then the same
      traffic through full-width deepseek-v2-lite-16b (27 layers of MLA, the
      first with a dense FFN, 26 of MoE: 64 experts top-6 and 2 shared;
      15,706,484,224 parameters) and qwen2-vl-2b (28 layers, M-RoPE, the
      text positions on all 3 streams; 1,587,965,440 parameters): the
      front door's checks, one flash launch a layer and prefill batch, the
      first served batch's prefill kernel path against plain path in fp32
      and bf16 (deepseek-v2-lite: each MoE layer's expert choices recorded
      on both paths, the last position's printed, the (layer, token) pairs
      whose choices differ counted; the fp32 logits held within 1e-3 where
      none differ), the served first tokens the bf16 prefill's argmax, the
      MoE's dropped choices over the served prefills, prefill ms, decode
      ms a token, p50/p95/p99, the peak memory (held under 80 GB).  Then
      the same traffic and checks through the three largest configs at
      full width (LARGE_SERVES, a cut depth set by patching
      `launch.serve.get_config`): qwen2.5-32b whole, at all 64 layers (40
      query heads padded to 48 on 8 K/V heads, QKV bias), deepseek-67b at
      47 of 95 and arctic-480b at 1 of 35 (128 experts top-2 beside its dense
      residual; its kernel-vs-plain prefill on the first
      ARCTIC_CHECK_PREFIX tokens of the first prompt, its routing pinned
      where the paths choose differently, its dropped choices counted over
      the full served prefills), each decode ms a token printed beside
      its bound, the served params read once at the HBM rate.  Then
      the same traffic at whisper-base's text context (432-token prompts,
      16 new tokens) through full-width whisper-base (6 encoder and 6
      decoder layers, zero frames as launch.serve gives them; 80,117,760
      parameters): the front door's checks, 18 flash launches a prefill
      batch (72), the first served batch's prefill kernel path against
      plain path on seeded random frames (held in fp32, printed in bf16),
      the served first tokens the bf16 prefill's argmax; prefill ms, decode
      ms a token, p50/p95/p99, peak memory.  Then whisper-base trained 4
      steps at batch 2 x 448 (18 flash op calls a step) and
      deepseek-v2-lite-16b at full width and 2 layers trained 4 steps at
      batch 2 x 1024 (2 flash op calls a step at q/k 192, v 128; every
      step's router aux loss finite and > 0), through launch.train: step
      ms, losses, peak memory.  Then zamba2-2.7b
      training:
      one fp32 train step at full width and one group of depth, kernel path
      against plain path (loss, grad norm, every gradient; 6 SSD forward and
      6 backward op calls); then the full model (54 Mamba2 layers) trained 6
      steps through launch.train at batch 2 x 1024, with 54 SSD forward
      (3 kernels each) and 54 backward (4 kernels each) op calls and 9 flash
      launches per step, a finite, non-zero
      gradient on every leaf, and 4 more steps on one repeated batch whose
      loss must fall.  Then, the zamba2 model freed: (b) the WKV op under
      autograd at rwkv6's training shape (2, 1024, 32, 64), chunk 64, in two
      decays: its y and final state (the kernel's) against the plain
      chunked version's, and its gradients (the recompute of the plain
      version) against autograd through the plain version on the card, the
      plain fp32 autograd against fp64 (printed), the op's and
      the plain version's ms, the bound and the backward's ms; (b) the
      flash op's gradients at gemma2's training shape (2, 1024, 16/4, 256)
      with its softcap and window, fp32 (outputs and gradients), and in
      bf16 the kernel against its plain version, its ms, the plain
      version's, the bound, torch.compile(flex_attention)'s and the
      backward's ms; (c) one fp32 train step of gemma2-2b and of rwkv6-1.6b
      at full width and 2 layers, kernel path against plain path (loss,
      grad norm, every gradient; 2 op calls each); (c) full-width
      gemma2-2b (26 layers) trained 4 steps at batch 2 x 1024 through
      launch.train with 26 flash op calls a step, the same gradient,
      repeated-batch and profile checks as zamba2, then 2 steps with
      --remat full: 52 flash op calls a step (the forward and its rerun),
      step 1's loss and grad norm equal to the run without remat and a
      lower peak memory; (c) full-width rwkv6-1.6b (24 layers) trained
      likewise with 24 WKV op calls (72 kernel launches) a step; (c) reduced
      gemma2-2b on the card trained 4 steps with --ckpt-dir, then --resume
      to step 6: it resumes from step 4, the params and moments it restored
      onto the card equal step 4's arrays.npz bit for bit, in the tensors
      the run initialised (restored in place, the device memory grown by
      no more than its largest leaf), its losses are finite; step 4's
      params restored again onto a 1x1 mesh on the card with the port's
      `param_specs` (DTensors with their specs' placements, bit for bit);
      (c) full-width gemma2-2b at 2 layers (its 256000 x 2304 fp32
      embedding, 2.36 GB, a leaf past 2^31 bytes) trained 1 step at batch
      2 x 1024 and saved, then --resume one step further: held as the
      reduced run, and the resumed step's loss and grad norm against the
      saving run's state carried one step further on the same batch; the
      checkpoint's bytes and its save's and restore's seconds printed, the
      checkpoint deleted; beside it, on the CPU, the dry-run cells
      (DRYRUN_CELLS: `python -m repro_torch.launch.dryrun` subprocesses,
      gemma2-2b x decode_32k on a fake 16x16 mesh, the reduced zamba2-2.7b
      prefill_32k and train_4k cells on a fake 2x2 mesh): each must end ok
      within 120 s, its per-device FLOPs, bytes and collectives, roofline
      terms and seconds printed; then the seconds of the three large
      serves and of the full-width resume with the dry-run cells, and their
      total;
  (d) last lines: the card, a JSON line of per-kernel results (flash
      attention once per path; A^T B at the ladder's top, with every shape
      it was held at; the WKV row with its stages' ms, scratch bytes,
      registers and spills; the SSD row with its forward's fwd_* keys,
      stage ms, TF32-rate bound, design bytes, registers and spills, and
      its backward's bwd_* keys: ms, stage ms, both bounds, routes,
      registers and spills; the SSD row and the zamba2 flash row with
      zamba2 serving's op calls, serve_launches, and their serving shape's
      figures, serve_shape; every serving row's batch-1 figures, serve_b1;
      the A^T B row's front-door summary, front_door, its proc
      transport's summary, proc (ms a task, the launches by worker pid,
      the fan-in's fetches, the drill), and the other schedulers' runs:
      mpi_list, mesh_ops_ms, elastic, run_pool, metg_schedulers (the tree
      rows' mean us a hop, hop_us, in front_door); the gemma2 flash row's
      pmake campaigns, campaign, and its served run's observability,
      serve_obs (with the analysed prefill, analysis), the dry run's
      cells, dryrun, and the full-width resume, resume_full; the flash row
      with the served figures and the two
      profiles, serve; a third flash row, whisper-base's: its encoder
      shape's figures, cross, decoder, fp32, probs_bf16, grad_cross, its
      serve's launches and figures and its training's train_* keys; the
      gemma2 flash row with grad_mla, deepseek_v2_lite_train and
      deepseek-7b's serve,
      deepseek, and its batch-1 prefill shape's figures, deepseek_b1;
      deepseek-v2-lite-16b's and qwen2-vl-2b's serves, deepseek_v2_lite
      and qwen2_vl, and their prefill shapes' figures,
      deepseek_v2_lite_b1 and qwen2_vl_b1; the three largest configs'
      serves, qwen2_5_32b, deepseek_67b and arctic_480b, and their prefill
      shapes' figures, qwen2_5_32b_b1 and deepseek_67b_b1; the
      gemma2 flash row with its training run's train_launches,
      train_launches_per_forward, remat_launches, train_shape,
      train_bwd_ms and train_step_profile; the WKV row with
      rwkv6 training's train_launches, train_launches_per_forward,
      train_shape, bwd_ms (the recompute), bwd_fp64_err and
      train_step_profile), and
      {"ok": true, "device": {...}}.
Every exit with a non-zero code prints its reason on stdout: no card, a
failed import (as when the script stands alone, without src/), a failed
check or any exception, with the phase it happened in.
"""
from __future__ import annotations

import ast
import contextlib
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# dense bf16 tensor-core peak and the HBM3 rate, H100 SXM data sheet:
# `repro_torch.launch.mesh`'s PEAK_FLOPS_BF16 and HBM_BW, which `run` reads
# into H100_BF16_FLOPS and H100_BYTES_S once src/ is importable
H100_BF16_FLOPS = H100_BYTES_S = None
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, same sheet
H100_TF32_FLOPS = 495e12     # dense TF32 on the tensor cores, same sheet
# exp issue rate: 16 results per clock per SM for the special-function unit's
# base-2 exponential, which expf runs once (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), x 132 SMs x
# 1.98 GHz maximum boost clock (H100 SXM data sheet)
H100_EXP_S = 16 * 132 * 1.98e9
ARGV = ["--no-reduced", "--requests", "4", "--prompt-len", "4200",
        "--max-new", "16", "--device", "cuda", "--workers", "1"]
B, S, HQ, G, HD = 4, 4200, 16, 4, 256      # gemma2-2b prefill attention
SCALE, CAP = HD ** -0.5, 50.0              # 1/sqrt(query_pre_attn_scalar)
# deepseek-7b prefill attention: one served prompt, 32 query heads on 32 K/V
# heads of 128 (MHA), causal, no window, no softcap
DSH, DSHD = 32, 128
# deepseek-v2-lite-16b's MLA prefill attention: 16 heads, q/k head dim 192
# (128 no-rope + 64 rope), v head dim 128, causal; qwen2-vl-2b's: 12 query
# heads padded to 16 on 2 K/V heads of 128 (GQA ratio 8), causal
MLAH, MLAHD, MLAHDV = 16, 192, 128
VLH, VLG, VLHD = 16, 2, 128
# qwen2.5-32b's: 40 query heads padded to 48 on 8 K/V heads of 128 (GQA
# ratio 6); deepseek-67b's 64 and arctic-480b's 56 padded to 64, on 8
QWH, DS67H, BIGG, BIGHD = 48, 64, 8, 128
# The three largest configs at full width.  init_serving_params fills each
# stacked leaf a matrix at a time, so its peak is the served tree plus one
# fp32 matrix (the embedding or the head); the serve and the path checks
# then need a few GB beside the tree.  qwen2.5-32b is served whole, at all
# 64 layers (a 66.87 GB tree; its phase peaked at 74.58 GB, the path
# checks').  deepseek-67b at the deepest depth whose phase peak leaves 4 GB
# of the card's 80 free: the path checks peaked at 76.67 GB at 48 layers
# (a 69.80 GB tree), so 47 (68.41 GB; 1.384 GB a layer).
# arctic-480b stays at 1 layer: its padded MoE dispatch needs 31.45 GB
# beside the tree at 4200 tokens (on an H100 80GB), which 2 layers' 55.4
# GB tree would push past 80.  tests/test_torch_large_configs.py counts
# these on meta.
QWEN32_LAYERS, DS67_LAYERS, ARCTIC_LAYERS = 64, 47, 1
# arctic's kernel-vs-plain prefill runs on this prefix of the first served
# prompt.  At all 4200 tokens the fp32 pass alone would cross 80 GB: the
# padded dispatch's 525 groups x 128 experts x 8 slots hold 15.4 GB of
# expert inputs, each (G, E, C, 4864) product 10.5 GB, and each expert
# stack cast to fp32 17.9 GB, beside the 28.2 GB tree.  At 1024 tokens:
# 16 groups of 64, 16,384 slots.
ARCTIC_CHECK_PREFIX = 1024
# (arch, depth, dims (layers, d_model, heads, KV heads, head dim, vocab),
# parameters at that depth, the kernel-vs-plain prefill's prefix or None)
LARGE_SERVES = (
    ("qwen2.5-32b", QWEN32_LAYERS,
     (QWEN32_LAYERS, 5120, 40, 8, 128, 152064), 33_435_030_528, None),
    ("deepseek-67b", DS67_LAYERS,
     (DS67_LAYERS, 8192, 64, 8, 128, 102400), 34_205_327_360, None),
    ("arctic-480b", ARCTIC_LAYERS,
     (ARCTIC_LAYERS, 7168, 56, 8, 128, 32000), 14_084_625_408,
     ARCTIC_CHECK_PREFIX),
)
# its prefill, kernel path vs plain path in fp32: the two differ only in the
# order of their fp32 sums (the flash kernel's tiles against the blockwise
# version's), which moves the logits by far less than a wrong tile or a
# dropped key block would (those move them by O(0.1) and more)
DS_FP32_LOGIT_TOL = 1e-3
FP32_TOL = 1e-4       # fp32 output vs plain version: summation order only
# (arch, shape, mesh, arguments) of the dry-run cells, each a subprocess
# on the CPU: gemma2-2b's decode on the production 16x16 mesh, and zamba2's
# reduced prefill and train cells of tests/test_torch_dryrun.py on a 2x2
# mesh, which raised on torch 2.11 until DTensor's pad rule was bypassed
# (models.common.zero_pad); each ends ok within DRYRUN_TIMEOUT_S
_REDUCED_2X2 = ["--reduced", "--mesh-shape", "2x2", "--seq-len", "32",
                "--global-batch", "4", "--q-block", "16", "--kv-block", "16",
                "--moe-group", "64"]
DRYRUN_CELLS = (
    ("gemma2-2b", "decode_32k", "16x16", []),
    ("zamba2-2.7b", "prefill_32k", "2x2", _REDUCED_2X2),
    ("zamba2-2.7b", "train_4k", "2x2",
     _REDUCED_2X2 + ["--remat", "full", "--microbatches", "2"]),
)
DRYRUN_TIMEOUT_S = 120
MESH_ON_MESH_ROWS = 1 << 22   # the DFM bridge's rows on a 1x1 mesh
BF16_ATOL = 1e-5      # bf16 output: one rounding of the fp32 result, see below
LOGIT_TOL = 0.15               # prefill logits, kernel path vs plain path
# rwkv6-1.6b prefill WKV: 4200 tokens padded to 66 chunks of 64
WB, WS, WH, WHD, WQ = 4, 4224, 32, 64, 64
PREFILL_REPS = 3      # timed kernel-path prefills after the served one
# The kernel and the plain chunked version compute the same fp32 sums in
# other orders, so they differ by a few ulps of the largest terms: max |diff|
# <= 1e-5 * max(1, max |plain|), for y and for the final state alike.
WKV_TOL = 1e-5
# rwkv6 prefill, kernel path vs plain path, compared in fp32 compute: in
# bf16 the two paths' rounding flips compound over 24 layers (at full width
# their logits differ by ~0.3, more than LOGIT_TOL, though layer 0's state
# agrees to ~1e-6), so bf16 cannot tell a kernel fault from rounding; the
# bf16 figures are printed, not held.  States: layer 0 runs the WKV on the
# same inputs on both paths (WKV_TOL); later layers carry the summation-order
# differences forward, and 1e-3 of the layer's largest |S| lets them grow
# over 24 layers and still fails a wrong state, which is off by O(1).
STATE_TOL = 1e-3
# zamba2-2.7b training at batch 2 x 1024: the SSD at (B, S, H, hd, N, Q) and
# the shared block's attention at q/k/v (B, S, 32, 80), no GQA, causal only
SSD_MAIN = (2, 1024, 80, 64, 64, 64)
ZB, ZS, ZH, ZHD = 2, 1024, 32, 80
# zamba2-2.7b serving, 4 x 4200 (ARGV): each layer's prefill SSD at 66
# chunks of 64 (4200 padded to 4224), zero initial state, final state
# returned; the shared block's flash at q/k/v (4, 4200, 32, 80), causal
SSD_SERVE = (4, 4224, 80, 64, 64, 64)
ZSB, ZSS = 4, 4200
# the decode check: the first 130 tokens of each prompt (two chunks of 64
# and a ragged tail), chunked prefill against token-by-token decode
DECODE_CHECK_LEN = 130
TRAIN_ARGV = ["--arch", "zamba2-2.7b", "--no-reduced", "--steps", "6",
              "--global-batch", "2", "--seq", "1024", "--device", "cuda"]
# SSD kernel vs plain chunked version, fp32: summation order only, as WKV_TOL
SSD_TOL = 1e-5
# Gradients vs autograd through the plain version (and, for the SSD, vs the
# plain backward ssd_chunked_bwd), fp32: the SSD backward kernel computes
# the same fp32 terms in other orders (each sum in a fixed order, the heads'
# partials of dB and dC added in head order), and the flash op's backward
# is the plain version's own autograd; so only summation order differs:
# max |diff| <= 1e-5 * max(1, max |plain grad|).  bf16 SSD gradients: one
# rounding of the fp32 result beyond that (bf16_excess).
GRAD_TOL = 1e-5
# One fp32 train step at full width and one group of depth, kernel path vs
# plain path: the kernels' summation-order differences (~1e-6 relative) pass
# through 6 Mamba2 layers and the shared block and back.  Loss within 1e-5
# relative, grad norm within 1e-4 relative, each leaf's gradient within 1e-3
# of its largest |plain grad|; a wrong kernel or a dropped backward term is
# off by O(1).
STEP_LOSS_TOL, STEP_NORM_TOL, STEP_GRAD_TOL = 1e-5, 1e-4, 1e-3
REPEAT_LR = 1e-5     # the repeated-batch steps (see train_full_width)
# gemma2-2b and rwkv6-1.6b training at batch 2 x 1024 (ZB x ZS): flash at
# q (2, 1024, 16, 256), k/v 4 heads, the local layers' window; the WKV at
# (B, S, H, hd, Q)
GTRAIN = (ZB, ZS, HQ, G, HD, 4096)
WTRAIN = (ZB, ZS, 32, 64, 64)
GEMMA_TRAIN_ARGV = ["--arch", "gemma2-2b", "--no-reduced", "--steps", "4",
                    "--global-batch", "2", "--seq", "1024", "--device",
                    "cuda"]
RWKV_TRAIN_ARGV = ["--arch", "rwkv6-1.6b"] + GEMMA_TRAIN_ARGV[2:]
# gemma2 step 1 with --remat full against the run without: the same ops
# rerun, so only the order cuBLAS and the kernels sum in could differ
REMAT_LOSS_TOL, REMAT_NORM_TOL = 1e-5, 1e-3
# the full-width resume: gemma2-2b at 2 layers, batch 2 x 1024, one step
# saved, then resumed one step.  The resumed step runs the same ops as the
# saving run's own next step, on bit-equal params and moments and the same
# batch: the forward's loss may differ only if a sum's order did, which
# the forward never changes; the backward's grad norm by the order of its
# atomic sums (the embedding's gradient)
RESUME_SEQ, RESUME_BATCH = 1024, 2
RESUME_ARGV = ["--arch", "gemma2-2b", "--no-reduced", "--layers", "2",
               "--global-batch", str(RESUME_BATCH), "--seq", str(RESUME_SEQ),
               "--device", "cuda"]
RESUME_LOSS_TOL, RESUME_NORM_TOL = 1e-6, 1e-5
# A^T B as (K, M, N): the JAX kernel sweep (tests/test_kernels.py:18-29), a
# ragged shape, and the METG ladder's squares (launch/metg.py)
MATMUL_SWEEP = [(256, 256, 256), (512, 256, 384), (384, 128, 512),
                (128, 128, 128)]
MATMUL_RAGGED = [(1000, 130, 70)]
MATMUL_LADDER = [(n, n, n) for n in (256, 512, 1024, 2048, 4096)]
# A^T B kernel vs plain version.  fp32: only the order of the sums differs,
# so max |diff| <= 1e-5 * sqrt(K) * max(1, max|a| * max|b|)
# (`launch.metg.tolerance`: the roundings of K terms add up as a random walk;
# a wrong index or a dropped k-slice is off by O(1), inputs rounded to TF32
# by 5-7 times the limit).  At the JAX sweep's shapes also its own 1e-4
# absolute.  bf16: the kernel rounds its fp32 sum once, so it lies within
# half a bf16 ulp of the plain version's fp32 result plus that fp32 bound
# (bf16_excess); at the sweep's shapes also the sweep's 0.25 absolute.
MATMUL_SWEEP_ATOL = {"float32": 1e-4, "bfloat16": 0.25}
# whisper-base (6 encoder and 6 decoder layers, d_model 512, 8 heads of 64
# padded to 16 on 8 KV heads, 1500 frames; 80,117,760 parameters) served
# 4 requests of 432-token prompts and 16 new tokens (448, its text
# context), 4 batches of 1.  Its flash shapes: the encoder (1, 1500, 16/8,
# 64) and the cross-attention (432 queries against 1500 keys) without the
# causal mask, the decoder's self-attention (1, 432, 16/8, 64) causal: 18
# launches a prefill (6 + 6 + 6), none in decode
WH_ARGV = ["--arch", "whisper-base", "--no-reduced", "--requests", "4",
           "--prompt-len", "432", "--max-new", "16", "--device", "cuda",
           "--workers", "1"]
WHQ, WHG, WHD, WHF, WHS = 16, 8, 64, 1500, 432
# (name, batch, queries, keys, q heads, KV heads, q/k head dim, v head
# dim, causal): whisper's three served shapes, in bf16 and fp32, then in
# bf16 with the backward's ms the training shapes of whisper at 2 x 448
# and of deepseek-v2-lite's MLA at 2 x 1024
WHISPER_CASES = (("encoder", 1, WHF, WHF, WHQ, WHG, WHD, WHD, False),
                 ("cross", 1, WHS, WHF, WHQ, WHG, WHD, WHD, False),
                 ("decoder", 1, WHS, WHS, WHQ, WHG, WHD, WHD, True))
TRAIN_CASES = (("train_encoder", 2, WHF, WHF, WHQ, WHG, WHD, WHD, False),
               ("train_cross", 2, 448, WHF, WHQ, WHG, WHD, WHD, False),
               ("train_decoder", 2, 448, 448, WHQ, WHG, WHD, WHD, True),
               ("train_mla", 2, 1024, 1024, 16, 16, 192, 128, True))
WHISPER_TRAIN_ARGV = ["--arch", "whisper-base", "--no-reduced", "--steps",
                      "4", "--global-batch", "2", "--seq", "448", "--device",
                      "cuda"]
# deepseek-v2-lite-16b trained at full width and 2 layers (the dense first
# layer and one MoE layer; 1,085,287,424 parameters): MLA's flash at q/k
# 192, v 128 with its backward recompute, the loss with the router's aux
DSV2_TRAIN_ARGV = ["--arch", "deepseek-v2-lite-16b", "--no-reduced",
                   "--layers", "2", "--steps", "4", "--global-batch", "2",
                   "--seq", "1024", "--device", "cuda"]
# probs_bf16: P is rounded to bf16 before P.V.  The plain version run at
# the kernel's 64-key tiles (kv_block=64) keeps the kernel's running max
# tile by tile, so both round P at the same points; only P's fp32 value
# differs (exp2f against exp, the order of the score sums), which moves a
# rare P across a rounding midpoint to the neighbouring bf16 value.  One
# such flip moves an output by at most 2^-7 p_t |v_t| (p_t the key's final
# probability), <= 2^-7 max_t p_t max|v| in its row: the row's flip unit.
# Held: every element within BF16_ATOL beyond one bf16 rounding of the
# plain fp32 result plus one flip unit of its row, and at most
# PROBS_BF16_FLIP_SHARE of them beyond BF16_ATOL.  A fault moves most
# elements: the kernel's output without the flag (P_hi + P_lo) is held to
# the same check and must fail it
PROBS_BF16_FLIP_SHARE = 1e-3
# (c) the front door's schedulers: fp32 A^T B tasks a size, the sizes, and
# mpi_list's rank blocks (one `Client.map` element a rank)
FRONT_DOOR_TASKS, FRONT_DOOR_SIZES, FRONT_DOOR_RANKS = 2000, (256, 1024), 16
# (c) the proc transport: worker processes, fp32 A^T B tasks a size (the
# front door's sizes), the fan-in's producers (n = 1024, C 4 MiB) and
# consumers, the SIGKILL drill's tasks at n = 1024 and the sleep each holds
# its worker for after its kernel (so that the kill lands mid-run), the
# warm-up tasks a size and their sleep (each worker's first task makes its
# CUDA context and the operands), the operands' seed
PROC_WORKERS, PROC_TASKS, PROC_FAN = 4, 1000, 64
PROC_DRILL_TASKS, PROC_DRILL_HOLD_S = 400, 0.005
PROC_WARM_TASKS, PROC_WARM_HOLD_S, PROC_SEED = 16, 0.1, 5
# (c) pmake: a campaign of launch.campaign's shape at full width, its train
# tasks gemma2-2b at batch 2 x 1024 (one card holds one: 61 GB at its peak)
FULL_CAMPAIGN_STEPS, CAMPAIGN_TIMEOUT_S = 2, 600
FULL_CAMPAIGN_RULES = """
train:
  resources: {{time: 10, nrs: 1, cpu: 1}}
  out:
    metrics: "shard_{{n}}.jsonl"
  setup: export PYTHONPATH={src}
  script: |
    {python} -m repro_torch.launch.train --arch gemma2-2b --no-reduced \\
      --steps {steps} --global-batch 2 --seq 1024 --seed {{n}} \\
      --metrics-out shard_{{n}}.jsonl --device {device}
summarize:
  resources: {{time: 1, nrs: 1, cpu: 1}}
  inp:
    loop:
  out:
    report: "report.json"
  setup: export PYTHONPATH={src}
  script: |
    {python} -m repro_torch.launch.campaign --summarize-dir . --shards {shards}
"""
# (c) mpi-list, the elastic pool and run_pool: fp32 A^T B at n = MPI_N; the
# Context's ranks, engine workers, elements and injected straggler sigma (s)
MPI_N, MPI_RANKS, MPI_WORKERS = 1024, 16, 4
MPI_ELEMENTS, MPI_SIGMA = 2000, 1e-3
ELASTIC_SHARDS, RUN_POOL_TASKS = 256, 2000
# (c) the DFM bridge: rows of the fp32 DFM (256 MiB) and of the pytree.  Its
# fp32 sums are held within MESH_SUM_CHAIN roundings of sum |x|: torch's
# reduction on the card adds at most that many terms in a row (it splits
# 2^26 terms over far more threads), and the rest in a tree.
MESH_ROWS, MESH_TREE_ROWS, MESH_SUM_CHAIN = 1 << 26, 1 << 20, 2048


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bf16_excess(out, exact) -> float:
    """How far a bf16 `out` lies beyond one round-to-nearest of the fp32
    result `exact`: max(|out - exact| - half_ulp(exact)), half a bf16 ulp
    (8 significant bits) in exact's binade.  A kernel that computes the fp32
    result to within summation order and rounds it once scores at most that
    fp32 difference; truncation, or a lost term, shows at every magnitude."""
    import torch
    x = exact.float()
    _, e = torch.frexp(x)
    half_ulp = torch.where(x == 0, torch.zeros_like(x),
                           torch.ldexp(torch.ones_like(x), e - 9))
    return float(((out.float() - x).abs() - half_ulp).max())


def probs_bf16_excess(torch, fa_ref, outs, q, k, v, kw):
    """Each bf16 output in `outs` against the plain version with
    probs_bf16 at the kernel's 64-key tiles, in fp32 (q and k in fp32, v
    bf16, so P is rounded to bf16): for each, (the worst of (excess -
    BF16_ATOL) / the row's flip unit, the share of elements whose excess
    passes BF16_ATOL, the worst excess), the excess beyond one bf16
    rounding as in bf16_excess; see PROBS_BF16_FLIP_SHARE.  kw: causal and
    scale."""
    exact = fa_ref.flash_attention_blockwise(q.float(), k.float(), v,
                                             probs_bf16=True, kv_block=64,
                                             **kw)
    _, e = torch.frexp(exact)
    half_ulp = torch.where(exact == 0, torch.zeros_like(exact),
                           torch.ldexp(torch.ones_like(exact), e - 9))
    # each row's largest probability, exp(max_t s - logsumexp_t s)
    s = torch.einsum("bshd,bthd->bhst", q.float(),
                     fa_ref.expand_kv(k, q.shape[2]).float()) * kw["scale"]
    if kw["causal"]:
        S, T = s.shape[-2:]
        s = s.masked_fill(torch.ones(S, T, dtype=torch.bool,
                                     device=s.device).triu(1), -torch.inf)
    p_max = torch.exp(s.amax(-1) - torch.logsumexp(s, -1)).transpose(1, 2)
    unit = 2.0 ** -7 * p_max[..., None] * float(v.float().abs().max())
    res = []
    for out in outs:
        excess = (out.float() - exact).abs() - half_ulp
        res.append((float(((excess - BF16_ATOL) / unit).max()),
                    float((excess > BF16_ATOL).float().mean()),
                    float(excess.max())))
    return res


def attention_bound(b, s, hq, g, hd, window, itemsize, flops_peak, hd_v=None,
                    t=None, causal=True):
    """Least time for the function: allowed (q, k) pairs x 2*(hd + hd_v)
    FLOPs (Q.K^T at the q/k head dim hd, P.V at the v head dim hd_v,
    default hd), and q, k, v read once plus o written once.  s queries
    against t keys (default s); query i sees key j < t where (not causal
    or j <= i) and (no window or i - j < window)."""
    from repro_torch.kernels import cost
    flops, nbytes = cost.flash_attention(
        b, s, hq, g, hd, window=window, itemsize=itemsize, hd_v=hd_v, t=t,
        causal=causal)[:2]
    t_ops, t_bytes = flops / flops_peak, nbytes / H100_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops


def demangle(names):
    """C++ names as c++filt gives them, where the machine has c++filt."""
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    return subprocess.run([tool], input="\n".join(names), capture_output=True,
                          text=True, check=True).stdout.splitlines()


def cuobjdump():
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(found).exists():
        return found
    import triton
    return str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
               / "cuobjdump")


def build_all(_build, names):
    """One nvcc per source, all started together; each build's seconds,
    each kernel's registers and spills (-Xptxas -v) and each library's
    count of HGMMA (wgmma) instructions in its SASS.  Returns ({name: HGMMA
    count}, {name: [(kernel, registers, spill store B, spill load B)]})."""
    def one(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        done = dict(zip(names, pool.map(one, names)))
    tool = cuobjdump()
    hgmma, kernel_regs = {}, {}
    for name, (log, secs) in done.items():
        entries, cur, spill = [], None, (0, 0)
        for line in log.splitlines():
            if "Compiling entry function" in line:
                cur = line.split("'")[1]
            elif "spill stores" in line:
                nums = [int(w) for w in line.replace(",", " ").split()
                        if w.isdigit()]
                spill = (nums[1], nums[2])
            elif "Used" in line and "registers" in line and cur:
                regs = int(line.split("Used")[1].split()[0])
                entries.append((cur, regs) + spill)
                cur = None
            elif "error" in line:
                print(f"[a] {name}: {line.strip()}")
        names_ = demangle([e[0] for e in entries])
        entries = [(n,) + e[1:] for n, e in zip(names_, entries)]
        kernel_regs[name] = entries
        sass = subprocess.run(
            [tool, "-sass", str(_build._lib_path(_build.CSRC / f"{name}.cu"))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        hgmma[name] = sum("HGMMA" in line for line in sass.splitlines())
        print(f"[a] {name} built in {secs:.1f}s; {hgmma[name]} HGMMA "
              f"instructions in its SASS")
        for kern, regs, st, ld in entries:
            print(f"[a] {name}: {kern}: {regs} registers, {st} B spill "
                  f"stores, {ld} B spill loads")
    for name in ("flash_attention", "tiled_matmul"):
        if hgmma.get(name) == 0:
            raise SystemExit(f"{name}: no HGMMA in its SASS; the bf16 path "
                             f"does not reach the tensor cores")
    return hgmma, kernel_regs


def wkv_bound(b, s, h, hd, q, with_state):
    """Least time for the chunked WKV, from counts per chunk and (b, h):
    exps (intra-chunk pairs j < t over hd; r and k rescaled; the chunk's
    decay) at the exp issue rate; fp32 FLOPs (cumsum, the intra-chunk
    products, A.v, the bonus, r.S, the state update) at the fp32 rate; r, k,
    v, logw, u and the initial state read once, y and the final state
    written once.  Returns (ms, bound_by, exps, flops, bytes)."""
    from repro_torch.kernels import cost
    flops, nbytes, exps, _ = cost.wkv6(b, s, h, hd, q, with_state)
    t_ops = max(exps / H100_EXP_S, flops / H100_FP32_FLOPS)
    t_bytes = nbytes / H100_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", exps, flops,
            nbytes)


def phase_wkv(torch, wkv_ops, wkv_ref, wkv_kernel, regs):
    """Chunked-WKV kernels vs plain version in fp32, y and the final state
    within WKV_TOL, at the serving shape, small shapes, an initial state and
    rwkv6's training shape (WTRAIN).  At the main shape also the scratch
    after stage 2 (the state entering each chunk) against the plain stages
    1 and 2 within WKV_TOL, a second run the same bits, each stage's ms
    (torch.profiler), the scratch bytes and each stage's registers and
    spills (`regs`: the build's entries for wkv6).  Returns the row for
    the main-path case (rwkv6-1.6b prefill, test-sweep inputs)."""
    print("[b] wkv6 kernels vs plain chunked version")
    gen = torch.Generator(device="cuda").manual_seed(1)
    row = None
    main = (WB, WS, WH, WHD, WQ)
    # (name, (B, S, H, hd, Q), decay, initial state)
    cases = [("main", main, "sweep", False),
             ("main slow decay", main, "slow", False),
             ("small", (2, 96, 4, 32, 16), "sweep", False),
             ("small", (2, 96, 4, 32, 32), "sweep", False),
             ("small", (1, 64, 2, 64, 32), "sweep", False),
             ("initial state", (2, 256, 4, 64, 64), "sweep", True),
             ("training", WTRAIN, "sweep", False),
             ("training slow decay", WTRAIN, "slow", False),
             # a served batch through the front door: one prompt
             ("serve batch 1", (1, WS, WH, WHD, WQ), "sweep", False)]
    for name, (b, s, h, hd, q), decay, with_state in cases:
        n = lambda: torch.randn((b, s, h, hd), generator=gen,  # noqa: E731
                                device="cuda")
        # as tests/test_kernels.py draws them; "slow": near the model's
        # w0 init, log-decay ~ -exp(-6), so the state holds ~400 steps
        r, k, v = n() * 0.5, n() * 0.5, n()
        logw = -torch.exp(n() * 0.5 - 1.0 if decay == "sweep"
                          else n() * 0.1 - 6.0)
        u = torch.randn((h, hd), generator=gen, device="cuda") * 0.1
        s0 = (torch.randn((b, h, hd, hd), generator=gen, device="cuda")
              if with_state else None)
        args = (r, k, v, logw, u)
        y, st = wkv_ops.wkv6(*args, chunk=q, initial_state=s0)
        py, ps = wkv_ref.wkv6_chunked(*args, chunk=q, initial_state=s0)
        torch.cuda.synchronize()
        errs = {}
        for what, out, plain in (("y", y, py), ("state", st, ps)):
            err = float((out - plain).abs().max())
            lim = WKV_TOL * max(1.0, float(plain.abs().max()))
            errs[what] = (err, lim, err <= lim and
                          bool(torch.isfinite(out).all()))
        ok = all(e[2] for e in errs.values())
        is_main = (b, s, h, hd, q) == main
        is_b1 = name == "serve batch 1"
        ms = cuda_ms(lambda: wkv_ops.wkv6(*args, chunk=q, initial_state=s0),
                     5 if is_main or is_b1 else 20)
        plain_ms = cuda_ms(lambda: wkv_ref.wkv6_chunked(
            *args, chunk=q, initial_state=s0), 1 if is_main or is_b1 else 5)
        bound_ms, bound_by, exps, flops, nbytes = wkv_bound(
            b, s, h, hd, q, with_state)
        print(f"[b] wkv6 {name}: (B,S,H,hd)={(b, s, h, hd)} Q={q}: "
              + " ".join(f"{w}_max_abs_err={e:.3e} (tol {lim:.3e})"
                         for w, (e, lim, _) in errs.items())
              + f" kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}"
              f" bound_ms={bound_ms:.4f} ({bound_by}; {exps:.3e} exp,"
              f" {flops:.3e} FLOP, {nbytes:.3e} B) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"wkv6 disagrees with its plain version: "
                             f"{name} {(b, s, h, hd, q)} {errs}")
        if is_main and decay == "sweep":
            row = {"name": "wkv6", "route": "cuda",
                   "source": "src/repro_torch/csrc/wkv6.cu",
                   "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:19",
                   "launches": None, "max_abs_err": errs["y"][0], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by,
                   # no single PyTorch call computes the chunked WKV
                   "library_ms": None}
            row.update(wkv_stages(torch, wkv_ops, wkv_ref, wkv_kernel, regs,
                                  args, q, s0, y, st))
        if is_b1:
            row["serve_b1"] = {"shape": [b, s, h, hd, q],
                               "max_abs_err": errs["y"][0], "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by, "library_ms": None}
        del args, r, k, v, logw, y, st, py, ps
        torch.cuda.empty_cache()
    return row


def wkv_stages(torch, wkv_ops, wkv_ref, wkv_kernel, regs, args, q, s0, y,
               st):
    """The main case's stage checks (see phase_wkv), given the first run's
    y and final state.  Returns the row's keys for them."""
    _, _, states = wkv_kernel.wkv6_cuda(*args, chunk=q, initial_state=s0,
                                        return_states=True)
    want, _ = wkv_ref.wkv6_state_pass(
        *wkv_ref.wkv6_chunk_state(*args[1:4], chunk=q), s0)
    err = float((states - want).abs().max())
    lim = WKV_TOL * max(1.0, float(want.abs().max()))
    y2, st2 = wkv_ops.wkv6(*args, chunk=q, initial_state=s0)
    same = torch.equal(y, y2) and torch.equal(st, st2)
    ok = err <= lim and same and bool(torch.isfinite(states).all())
    print(f"[b] wkv6 main: states after the scan over the chunks vs "
          f"wkv6_state_pass: max_abs_err={err:.3e} (tol {lim:.3e}); a second "
          f"run the same bits: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("wkv6: the states after the scan over the chunks "
                         "disagree with the plain stages, or two runs differ")
    b, _, h, hd = args[0].shape
    scratch = 4 * (states.numel() + b * h * states.shape[2] * hd)
    del states, want, y2, st2
    stages = stage_ms(torch, wkv_kernel.KERNELS,
                      lambda: wkv_kernel.wkv6_cuda(*args, chunk=q,
                                                   initial_state=s0), reps=5)
    stage_regs = kernel_registers(regs, WKV_INSTANCES)
    print("[b] wkv6 main: kernels (torch.profiler) " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in stages.items())
        + f" ms; scratch_bytes={scratch} (dS, then S_in, and the decays); "
        + " ".join(f"{k}: {v['registers']} registers, "
                   f"{v['spill_store_bytes']} B spill stores, "
                   f"{v['spill_load_bytes']} B spill loads;"
                   for k, v in stage_regs.items()))
    return {"stages_ms": stages, "states_max_abs_err": err,
            "scratch_bytes": scratch, "regs": stage_regs}


def ssd_bound(b, s, h, hd, n, q, itemsize=4, with_state=False,
              final_state=False):
    """Least time for the chunked SSD, from counts of what the function
    needs: C.B^T over the lower triangle j <= t once per (b, chunk), since
    with one group B and C are shared by every head (the Pallas kernel
    computes it once for all heads); per (b, h, chunk) the cumsum, the
    decay exps and M over j <= t, M.x, C.S and its scaling, the state
    update.  x, dA, B and C (and the initial state, `with_state`) read
    once, Y written once (and the final state: `with_state` or
    `final_state`).  Two bounds: every FLOP at the fp32 rate;
    and the products (C.B^T, M.x, C.S, the state update) as 3xTF32 on the
    tensor cores, three TF32 products each at the TF32 rate, beside the
    rest at the fp32 rate (the two units run at once, so the larger).  Exps
    at the exp rate.  Returns (ms, bound_by, exps, flops, bytes, tc_ms)."""
    from repro_torch.kernels import cost
    flops, nbytes, exps, prod = cost.ssd(b, s, h, hd, n, q, itemsize,
                                         with_state, final_state)
    rest = flops - prod
    t_exp = exps / H100_EXP_S
    t_ops = max(t_exp, flops / H100_FP32_FLOPS)
    t_bytes = nbytes / H100_BYTES_S
    t_tc = max(t_exp, 3 * prod / H100_TF32_FLOPS, rest / H100_FP32_FLOPS,
               t_bytes)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", exps, flops,
            nbytes, t_tc * 1e3)


def ssd_design_bytes(b, s, h, hd, n, q, itemsize=4):
    """The bytes the forward's three kernels move at least, scratch
    included: stage 1 reads x, dA and B and writes the chunks' terms and
    decays (fp32); stage 2 reads and writes the terms and writes the final
    state; stage 3 reads x, dA, B, C and the states entering the chunks and
    writes Y."""
    states = 4 * b * h * (s // q) * hd * n
    decay = 4 * b * h * (s // q)
    x, da, bc = (itemsize * b * s * h * hd, itemsize * b * s * h,
                 itemsize * b * s * n)
    return ((x + da + bc + states + decay)
            + (2 * states + decay + 4 * b * h * hd * n)
            + (2 * x + da + 2 * bc + states))


def ssd_inputs(torch, gen, b, s, h, hd, n, decay):
    """As tests/test_kernels.py draws them: xdt, B, C ~ N(0, 0.25), dA =
    -softplus(N(0, 1)); "slow": dA scaled by 1e-3 (near 0, the state holds
    ~thousands of steps); "fast": dA - 5 (exp underflows within a chunk)."""
    nrm = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device="cuda")
    dA = -torch.nn.functional.softplus(nrm(b, s, h))
    dA = {"sweep": dA, "slow": dA * 1e-3, "fast": dA - 5.0}[decay]
    return [nrm(b, s, h, hd) * 0.5, dA, nrm(b, s, 1, n) * 0.5,
            nrm(b, s, 1, n) * 0.5]


def phase_ssd(torch, ssd_ops, ssd_ref, ssd_kernel, regs):
    """Chunked-SSD forward kernels (three launches a call) vs plain version
    in fp32: Y and the final state within SSD_TOL of the fp64 plain version
    on the same values, and of the fp32 plain version wherever that lies
    itself within SSD_TOL of fp64 (the kernel's two-float cumsum follows
    neither's order; the line prints the fp32 plain version's distance).
    The main shape in three decays, the JAX sweep, and initial states.  At
    the main shape also the scratch after the scan over the chunks against
    the plain stages 1 and 2 and bit for bit against the backward's S_in,
    two runs the same bits, each stage's ms (torch.profiler), registers and
    spills (`regs`: the build's entries for mamba2_ssd), both bounds and the
    design's bytes.  At zamba2-2.7b's serving shape (SSD_SERVE, from a zero
    state with the final state, as the prefill calls it) its ms with the
    final state, both bounds and each stage's ms.  Returns the row for the
    main-path case (zamba2-2.7b training, test-sweep inputs), with the
    serving shape's figures under "serve_shape"."""
    print("[b] mamba2_ssd forward kernels vs plain chunked version; products: "
          + ", ".join(f"{k} {v}" for k, v in ssd_kernel.FWD_ROUTES.items()))
    gen = torch.Generator(device="cuda").manual_seed(2)
    row = None
    # (name, (B, S, H, hd, N, Q), decay, initial state)
    cases = [("main", SSD_MAIN, "sweep", False),
             ("main slow decay", SSD_MAIN, "slow", False),
             ("main fast decay", SSD_MAIN, "fast", False),
             ("zamba2 serve", SSD_SERVE, "sweep", False),
             # a served batch through the front door: one prompt
             ("zamba2 serve batch 1", (1,) + SSD_SERVE[1:], "sweep", False)]
    cases += [("JAX sweep", (b, s, h, hd, n, q), "sweep", False)
              for b, s, h, hd, n in [(2, 128, 8, 16, 16), (1, 64, 4, 32, 8)]
              for q in (16, 32)]
    cases += [("initial state", SSD_MAIN, "sweep", True),
              ("initial state", (2, 128, 5, 16, 16, 32), "fast", True),
              ("initial state", (1, 64, 3, 32, 8, 64), "sweep", True)]
    for name, (b, s, h, hd, n, q), decay, with_state in cases:
        args = ssd_inputs(torch, gen, b, s, h, hd, n, decay)
        s0 = (torch.randn((b, h, hd, n), generator=gen, device="cuda")
              if with_state else None)
        with torch.no_grad():
            y, st = ssd_ops.ssd(*args, chunk=q, initial_state=s0,
                                return_state=True)
        plain = ssd_ref.ssd_chunked(*args, chunk=q, initial_state=s0)
        exact = ssd_ref.ssd_chunked(
            *(t.double() for t in args), chunk=q,
            initial_state=None if s0 is None else s0.double())
        torch.cuda.synchronize()

        def rel(out, ref):
            return (float((out.double() - ref.double()).abs().max())
                    / max(1.0, float(ref.abs().max())))
        e32 = [rel(u, v) for u, v in zip((y, st), plain)]
        e64 = [rel(u, v) for u, v in zip((y, st), exact)]
        own = [rel(u, v) for u, v in zip(plain, exact)]
        held32 = [e for e, o in zip(e32, own) if o <= SSD_TOL]
        ok = (max(e64 + held32) <= SSD_TOL
              and all(bool(torch.isfinite(t).all()) for t in (y, st)))
        is_main = (b, s, h, hd, n, q) == SSD_MAIN
        is_b1 = name == "zamba2 serve batch 1"
        is_serve = (b, s, h, hd, n, q) == SSD_SERVE or is_b1
        big = is_main or is_serve
        with torch.no_grad():
            ms = cuda_ms(lambda: ssd_ops.ssd(*args, chunk=q,
                                             return_state=is_serve),
                         10 if big else 20)
        plain_ms = cuda_ms(lambda: ssd_ref.ssd_chunked(*args, chunk=q),
                           3 if big else 5)
        bound_ms, bound_by, exps, flops, nbytes, tc_ms = ssd_bound(
            b, s, h, hd, n, q, with_state=with_state, final_state=is_serve)
        print(f"[b] mamba2_ssd {name}: (B,S,H,hd,N)={(b, s, h, hd, n)} Q={q}"
              f" {decay} decay: max|diff|/max(1, max|ref|) of Y, final state"
              f" vs fp64 plain {e64[0]:.2e}, {e64[1]:.2e}; vs fp32 plain "
              f"{e32[0]:.2e}, {e32[1]:.2e} (fp32 plain to fp64 {own[0]:.2e}"
              f", {own[1]:.2e}; held where within tol: {len(held32)} of 2)"
              f" (tol {SSD_TOL:.0e}) kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}; "
              f"{exps:.3e} exp, {flops:.3e} FLOP, {nbytes:.3e} B) "
              f"bound_tc_ms={tc_ms:.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"mamba2_ssd disagrees with its plain version: "
                             f"{name} {(b, s, h, hd, n, q)} {e64} {e32}")
        if is_main and decay == "sweep" and not with_state:
            row = {"name": "mamba2_ssd", "path": "zamba2-2.7b train",
                   "route": "cuda", "source": "src/repro_torch/csrc/mamba2_ssd.cu",
                   "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:17",
                   "launches": None,
                   "max_abs_err": float((y - plain[0]).abs().max()),
                   "fwd_max_rel_err_fp64": max(e64), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "fwd_bound_tc_ms": tc_ms,
                   # no single PyTorch call computes the chunked SSD
                   "library_ms": None}
            row.update(ssd_fwd_stages(torch, ssd_ref, ssd_kernel, regs,
                                      args, q))
        if is_serve:
            stages = stage_ms(torch, ssd_kernel.FWD_KERNELS,
                              lambda: ssd_kernel.ssd_cuda(*args, chunk=q))
            print(f"[b] mamba2_ssd {name}: kernels (torch.profiler) "
                  + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                             else f"{k} {v}" for k, v in stages.items())
                  + " ms")
            row["serve_b1" if is_b1 else "serve_shape"] = {
                "shape": [b, s, h, hd, n, q],
                "max_abs_err": float((y - plain[0]).abs().max()),
                "fwd_max_rel_err_fp64": max(e64), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_tc_ms": tc_ms,
                "library_ms": None, "stages_ms": stages}
        del args, y, st, plain, exact
        torch.cuda.empty_cache()
    return row


def ssd_fwd_stages(torch, ssd_ref, ssd_kernel, regs, args, q):
    """The main case's stage checks (see phase_ssd).  Returns the row's keys
    for them."""
    (y, st), (states, decay) = ssd_kernel.ssd_cuda(*args, chunk=q,
                                                   return_states=True)
    want, _ = ssd_ref.ssd_fwd_state_pass(
        *ssd_ref.ssd_fwd_chunk_state(*args, chunk=q))
    err = (float((states - want).abs().max())
           / max(1.0, float(want.abs().max())))
    g = torch.randn_like(args[0])
    _, (s_in, _) = ssd_kernel.ssd_bwd_cuda(*args, g, chunk=q,
                                           return_states=True)
    as_bwd = torch.equal(states, s_in)
    y2, st2 = ssd_kernel.ssd_cuda(*args, chunk=q)
    same = torch.equal(y, y2) and torch.equal(st, st2)
    ok = (err <= SSD_TOL and as_bwd and same
          and bool(torch.isfinite(states).all()))
    print(f"[b] mamba2_ssd main: states after the scan over the chunks vs "
          f"ssd_fwd_state_pass: max|diff|/max(1, max|ref|)={err:.2e} (tol "
          f"{SSD_TOL:.0e}); the backward's S_in the same bits: {as_bwd}; a "
          f"second run the same bits: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("mamba2_ssd: the states after the scan over the "
                         "chunks disagree with the plain stages or the "
                         "backward's, or two runs differ")
    del y, st, states, decay, want, g, s_in, y2, st2
    b, s, h, hd = args[0].shape
    n = args[2].shape[-1]
    nbytes = ssd_design_bytes(b, s, h, hd, n, q)
    stages = stage_ms(torch, ssd_kernel.FWD_KERNELS,
                      lambda: ssd_kernel.ssd_cuda(*args, chunk=q))
    stage_regs = kernel_registers(regs, SSD_FWD_INSTANCES)
    print("[b] mamba2_ssd main: kernels (torch.profiler) " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in stages.items())
        + f" ms; the design's bytes with its scratch {nbytes:.3e} B, "
        f"{nbytes / H100_BYTES_S * 1e3:.4f} ms at {H100_BYTES_S:.3g} B/s; "
        + " ".join(f"{k}: {v['registers']} registers, "
                   f"{v['spill_store_bytes']} B spill stores, "
                   f"{v['spill_load_bytes']} B spill loads;"
                   for k, v in stage_regs.items()))
    return {"fwd_stages_ms": stages, "fwd_states_max_rel_err": err,
            "fwd_design_bytes": nbytes, "fwd_regs": stage_regs}


def ssd_bwd_bound(b, s, h, hd, n, q, itemsize=4):
    """Least time for the chunked SSD's gradient, from counts of what the
    function needs: C.B^T over j <= t once per (b, chunk) (shared by the
    heads); per (b, h, chunk) the cumsum, the state entering the chunk (the
    forward's state walk), the decay exps, dM = dY.x^T, M^T.dY, dG.B and
    dG^T.C over j <= t, M, dG and dM o M there and the strict row and column
    sums of dM o M, dS.B, dY.S_in, x.dS and the dS update at hd x N per
    step, R, the inter-chunk term, <dS, S_in>, dcum and its reverse cumsum;
    dB and dC summed over the heads.  x, dA, B, C and dY read once, dx,
    d(dA), dB and dC written once.  Two bounds: every FLOP at the fp32
    rate; and the products (C.B^T, the state walk and dS update, dY.x^T,
    M^T.dY, dS.B, dG.B, dY.S_in, dG^T.C, x.dS) as 3xTF32 on the tensor
    cores, three TF32 products each at the TF32 rate, beside the rest at
    the fp32 rate (the two units run at once, so the larger).  Exps at the
    exp rate.  Returns (ms, bound_by, exps, flops, bytes, tc_ms)."""
    from repro_torch.kernels import cost
    flops, nbytes, exps, prod = cost.ssd_bwd(b, s, h, hd, n, q, itemsize)
    rest = flops - prod
    t_exp = exps / H100_EXP_S
    t_ops = max(t_exp, flops / H100_FP32_FLOPS)
    t_bytes = nbytes / H100_BYTES_S
    t_tc = max(t_exp, 3 * prod / H100_TF32_FLOPS, rest / H100_FP32_FLOPS,
               t_bytes)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", exps, flops,
            nbytes, t_tc * 1e3)


def stage_ms(torch, names, fn, reps=10):
    """The ms of each kernel in `names` that fn() launches: the device time
    by kernel name from torch.profiler's key_averages() over `reps` calls
    ("not measured" where the profiler shows none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        for name in times:
            if name in ev.key:
                times[name] += us / 1e3 / reps
    return {k: v if v > 0 else "not measured" for k, v in times.items()}


# The instance of each kernel whose registers and spills are reported: its
# template arguments at the main shape, demangled and mangled ("" for a
# kernel that is no template)
SSD_FWD_INSTANCES = {"ssd_fwd_chunk_state": ("<float, 64, 64, 64>",
                                             "IfLi64ELi64ELi64E"),
                     "ssd_fwd_state_pass": ("",),
                     "ssd_fwd_chunk_out": ("<float, 64, 64, 64>",
                                           "IfLi64ELi64ELi64E")}
SSD_BWD_INSTANCES = {"ssd_bwd_chunk_state": ("<float, 64, 64, 64>",
                                             "IfLi64ELi64ELi64E"),
                     "ssd_bwd_state_pass": ("",),
                     "ssd_bwd_chunk_grads": ("<float, 64, 64, 64>",
                                             "IfLi64ELi64ELi64E"),
                     "ssd_head_sum": ("<float>", "IfE")}
WKV_INSTANCES = {"wkv6_chunk_state": ("<64, 64>", "ILi64ELi64E"),
                 "wkv6_state_pass": ("",),
                 "wkv6_chunk_out": ("<64, 64>", "ILi64ELi64E")}


def kernel_registers(entries, instances):
    """Registers and spill bytes of the kernel instances named in
    `instances`, from the build's -Xptxas -v lines (names demangled, or
    mangled where the machine has no c++filt)."""
    out = {}
    for kern, nreg, st, ld in entries:
        for name, tails in instances.items():
            if any(name + tail in kern for tail in tails):
                out[name] = {"registers": nreg, "spill_store_bytes": st,
                             "spill_load_bytes": ld}
    return out


def phase_ssd_bwd(torch, ssd_ops, ssd_ref, ssd_kernel):
    """The fp32 SSD backward kernels, through the op's autograd (one
    backward, four launches), at the main shape in three decays and the
    JAX sweep, held within GRAD_TOL of: autograd through the plain version
    in fp64 on the same values (the plain version's exact gradient); the
    plain backward ssd_chunked_bwd in fp32; autograd through the plain
    version in fp32, for each gradient whose fp32 autograd lies itself
    within GRAD_TOL of the fp64 one.  Where it does not, the fp32 autograd
    cannot arbitrate (at the main shape in fast decay its d(dA) sums terms
    of dM o M that cancel on the diagonal, and lies ~1.3e-5 from its fp64
    value), and the line prints it.  At the main shape also the scratch
    after the scan over the chunks (S_in and dS of every chunk) against
    the plain stages 1 and 2, within GRAD_TOL.  Then bf16 at the main
    shape, within one rounding of the fp32 plain backward on the same
    values.  At the main shape the backward's ms and each launch's, both
    bounds, the recompute's ms (autograd of the plain version, the op's
    backward before it had a kernel) and the plain backward's ms, and each
    product's route.  Returns the row's bwd_* keys for the main-path
    case."""
    from repro_torch.kernels._recompute import recompute
    print("[b] mamba2_ssd backward kernels vs autograd through the plain "
          "version and vs the plain backward ssd_chunked_bwd; products: "
          + ", ".join(f"{k} {v}" for k, v in ssd_kernel.BWD_ROUTES.items()))
    gen = torch.Generator(device="cuda").manual_seed(3)
    keys = None
    cases = [("main", SSD_MAIN, "sweep"), ("main slow decay", SSD_MAIN, "slow"),
             ("main fast decay", SSD_MAIN, "fast")]
    cases += [("JAX sweep", (b, s, h, hd, n, q), "sweep")
              for b, s, h, hd, n in [(2, 128, 8, 16, 16), (1, 64, 4, 32, 8)]
              for q in (16, 32)]
    names = ("dxdt", "ddA", "dB", "dC")
    for name, (b, s, h, hd, n, q), decay in cases:
        ins = ssd_inputs(torch, gen, b, s, h, hd, n, decay)
        g = torch.randn((b, s, h, hd), generator=gen, device="cuda")
        a = [t.clone().requires_grad_() for t in ins]
        before = ssd_ops.ssd.bwd_launches
        kern = torch.autograd.grad(ssd_ops.ssd(*a, chunk=q), a, g)
        launched = ssd_ops.ssd.bwd_launches - before
        p = [t.clone().requires_grad_() for t in ins]
        auto = torch.autograd.grad(ssd_ref.ssd_chunked(*p, chunk=q)[0], p, g)
        p = [t.double().requires_grad_() for t in ins]
        auto64 = torch.autograd.grad(ssd_ref.ssd_chunked(*p, chunk=q)[0], p,
                                     g.double())
        plain = ssd_ref.ssd_chunked_bwd(*ins, g, chunk=q)
        torch.cuda.synchronize()

        def rel(x, y):
            return [float((u.double() - v.double()).abs().max())
                    / max(1.0, float(v.abs().max())) for u, v in zip(x, y)]
        e64, e_plain, e32 = (rel(kern, auto64), rel(kern, plain),
                             rel(kern, auto))
        own = rel(auto, auto64)      # the fp32 autograd's own distance
        held32 = [e for e, o in zip(e32, own) if o <= GRAD_TOL]
        ok = (max(e64 + e_plain + held32) <= GRAD_TOL and launched == 1
              and all(bool(torch.isfinite(t).all()) for t in kern))
        fmt = lambda e: " ".join(f"{k}={v:.2e}"  # noqa: E731
                                 for k, v in zip(names, e))
        print(f"[b] mamba2_ssd bwd {name}: (B,S,H,hd,N)={(b, s, h, hd, n)} "
              f"Q={q}: max|diff|/max(1, max|ref|) vs autograd fp64 "
              f"[{fmt(e64)}] vs ssd_chunked_bwd [{fmt(e_plain)}] vs autograd "
              f"fp32 [{fmt(e32)}] (tol {GRAD_TOL:.0e}; fp32 autograd to fp64 "
              f"[{fmt(own)}], held where within tol: {len(held32)} of 4); "
              f"ssd_chunked_bwd to fp64 {max(rel(plain, auto64)):.2e}; bwd "
              f"launches {launched} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"mamba2_ssd backward kernel disagrees with the "
                             f"plain version: {name} {(b, s, h, hd, n, q)}")
        if name == "main":
            _, states = ssd_kernel.ssd_bwd_cuda(*ins, g, chunk=q,
                                                return_states=True)
            want = ssd_ref.ssd_bwd_state_pass(
                *ssd_ref.ssd_bwd_chunk_state(*ins, g, chunk=q))
            e_states = rel(states, want)
            again = ssd_kernel.ssd_bwd_cuda(*ins, g, chunk=q)
            same = all(torch.equal(u, v) for u, v in zip(kern, again))
            ok = max(e_states) <= GRAD_TOL and same
            print(f"[b] mamba2_ssd bwd main: scratch after the scan over the "
                  f"chunks vs ssd_bwd_state_pass: S_in={e_states[0]:.2e} "
                  f"dS={e_states[1]:.2e} (tol {GRAD_TOL:.0e}); a second run "
                  f"the same bits: {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("mamba2_ssd backward: the states after the "
                                 "scan over the chunks disagree, or two runs "
                                 "differ")
            del again
            del states, want
            ms = cuda_ms(lambda: ssd_kernel.ssd_bwd_cuda(*ins, g, chunk=q), 10)
            stages = stage_ms(torch, ssd_kernel.BWD_KERNELS,
                              lambda: ssd_kernel.ssd_bwd_cuda(*ins, g,
                                                              chunk=q))
            out = recompute(lambda *t: ssd_kernel.ssd_cuda(*t, chunk=q)[0],
                            functools.partial(ssd_ops.ssd_plain, chunk=q), *a)
            recompute_ms = cuda_ms(lambda: torch.autograd.grad(
                out, a, g, retain_graph=True), 3)
            ref_ms = cuda_ms(lambda: ssd_ref.ssd_chunked_bwd(*ins, g, chunk=q),
                             3)
            bound_ms, bound_by, exps, flops, nbytes, tc_ms = ssd_bwd_bound(
                b, s, h, hd, n, q)
            print(f"[b] mamba2_ssd bwd main {SSD_MAIN[:5]} Q={q} fp32: "
                  f"kernel_ms={ms:.4f} (kernels, torch.profiler: "
                  + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                             else f"{k} {v}" for k, v in stages.items())
                  + f") bound_ms={bound_ms:.4f} ({bound_by}; "
                  f"{exps:.3e} exp, {flops:.3e} FLOP, {nbytes:.3e} B; every "
                  f"FLOP at the fp32 rate) bound_tc_ms={tc_ms:.4f} (the "
                  f"products in 3xTF32 at the TF32 rate) recompute_ms="
                  f"{recompute_ms:.3f} (autograd of the plain version) "
                  f"ssd_chunked_bwd_ms={ref_ms:.3f}")
            keys = {"bwd_ms": ms, "bwd_stage_ms": stages,
                    "bwd_bound_ms": bound_ms,
                    "bwd_bound_by": bound_by, "bwd_bound_tc_ms": tc_ms,
                    "bwd_plain_ms": recompute_ms, "bwd_ref_ms": ref_ms,
                    "bwd_max_abs_err": max(e64 + e_plain + held32),
                    "bwd_routes": ssd_kernel.BWD_ROUTES}
            del out
        del ins, g, a, p, kern, auto, auto64, plain
        torch.cuda.empty_cache()
    # bf16 inputs and cotangent: fp32 arithmetic inside, gradients rounded
    # once to bf16; held against the fp32 plain backward on the same values
    b, s, h, hd, n, q = SSD_MAIN
    ins = [t.bfloat16() for t in ssd_inputs(torch, gen, b, s, h, hd, n,
                                            "sweep")]
    g = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
    kern = ssd_kernel.ssd_bwd_cuda(*ins, g, chunk=q)
    plain = ssd_ref.ssd_chunked_bwd(*(t.float() for t in ins), g.float(),
                                    chunk=q)
    excess = [bf16_excess(u, v) for u, v in zip(kern, plain)]
    lims = [GRAD_TOL * max(1.0, float(v.abs().max())) for v in plain]
    ok = all(e <= lim for e, lim in zip(excess, lims)) and all(
        u.dtype == torch.bfloat16 and bool(torch.isfinite(u).all())
        for u in kern)
    print(f"[b] mamba2_ssd bwd bfloat16 main: beyond one bf16 rounding of the "
          f"fp32 plain backward: " + " ".join(
              f"{k}={e:.2e} (tol {lim:.2e})"
              for k, e, lim in zip(names, excess, lims))
          + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("mamba2_ssd backward kernel in bf16 is beyond one "
                         "rounding of the plain backward")
    del ins, g, kern, plain
    torch.cuda.empty_cache()
    return keys


def matmul_bound(k, m, n, itemsize, flops_peak):
    """Least time for C = A^T B: 2 K M N FLOPs at the type's rate (fp32
    outside the tensor cores, bf16 on them), A and B read once and C
    written once.  Returns (ms, bound_by, flops, bytes)."""
    from repro_torch.kernels import cost
    flops, nbytes = cost.tiled_matmul(k, m, n, itemsize)[:2]
    t_ops, t_bytes = flops / flops_peak, nbytes / H100_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_matmul(torch, mm_ops, mm_ref, mm_kernel, metg):
    """A^T B kernel vs plain version in fp32 and bf16 at the JAX sweep, a
    ragged shape and the METG ladder; beside each, torch.matmul(a.t(), b)
    with TF32 off.  Each is timed as launch.metg times the kernel: launches
    queued behind a sleep, so that the events bracket the card's work and
    not the host's pace (a small product takes less time on the card than
    its launch on the host).  Each case prints the kernel and tiling it
    took, which must be the one `plan` states (bf16: the tensor cores).
    Returns the row for the ladder's top in fp32, with every case under
    "shapes"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[b] tiled_matmul kernel vs plain version; library call "
          "torch.matmul(a.t(), b) timed with "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    row, shapes = None, []
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for kind, cases in (("sweep", MATMUL_SWEEP),
                            ("ragged", MATMUL_RAGGED),
                            ("ladder", MATMUL_LADDER)):
            for k, m, n in cases:
                a = torch.randn((k, m), generator=gen, device="cuda").to(dtype)
                b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
                pl = mm_kernel.plan(dtype, k, m, n, a.data_ptr(),
                                    b.data_ptr())
                if pl != mm_kernel.c_plan(a, b) or (pl.route == 1) != (
                        dt == "bfloat16"):
                    raise SystemExit(f"tiled_matmul plan: {pl} stated, "
                                     f"{mm_kernel.c_plan(a, b)} taken")
                out = mm_ops.tiled_matmul(a, b)
                exact = mm_ref.tiled_matmul_ref(a.float(), b.float())
                plain = mm_ref.tiled_matmul_ref(a, b)
                torch.cuda.synchronize()
                tol = metg.tolerance(k, float(a.abs().max()),
                                     float(b.abs().max()))
                err = float((out.float() - plain.float()).abs().max())
                if dt == "float32":
                    check, ok = f"(tol {tol:.3e})", err <= tol
                else:
                    excess = bf16_excess(out, exact)
                    check = (f"beyond one bf16 rounding of the fp32 result: "
                             f"{excess:.3e} (tol {tol:.3e})")
                    ok = excess <= tol
                if kind == "sweep":
                    check += f", sweep atol {MATMUL_SWEEP_ATOL[dt]:g}"
                    ok = ok and err <= MATMUL_SWEEP_ATOL[dt]
                ok = ok and bool(torch.isfinite(out).all())
                reps = 10 if k * m * n >= 2048 ** 3 else 100

                def timed(fn):
                    fn(0)                               # warm-up
                    return 1e3 * metg.device_seconds(fn, reps, a.device)[0]
                ms, plain_ms, lib_ms = (
                    timed(lambda i: mm_ops.tiled_matmul(a, b)),
                    timed(lambda i: mm_ref.tiled_matmul_ref(a, b)),
                    timed(lambda i: torch.matmul(a.t(), b)))
                bound_ms, bound_by, flops, nbytes = matmul_bound(
                    k, m, n, a.element_size(),
                    H100_BF16_FLOPS if dt == "bfloat16" else H100_FP32_FLOPS)
                print(f"[b] tiled_matmul {dt:8s} {kind} (K,M,N)={(k, m, n)}: "
                      f"max_abs_err={err:.3e} {check} kernel_ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                      f"bound_ms={bound_ms:.4f} ({bound_by}; {flops:.3e} "
                      f"FLOP, {nbytes:.3e} B; {flops / ms / 1e9:.2f} TFLOP/s)"
                      f" [{pl.describe()}] {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"tiled_matmul disagrees with its plain "
                                     f"version: {dt} {(k, m, n)} {check}")
                shapes.append({"dtype": dt, "kind": kind, "kmn": [k, m, n],
                               "max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by, "library_ms": lib_ms,
                               "tiling": pl.describe()})
                if (k, m, n) == MATMUL_LADDER[-1] and dt == "float32":
                    row = {"name": "tiled_matmul",
                           "path": f"dwork METG ladder, n = {n}, fp32",
                           "route": "cuda",
                           "source": "src/repro_torch/csrc/tiled_matmul.cu",
                           "replaces":
                               "src/repro/kernels/tiled_matmul/kernel.py:19",
                           "launches": None, "max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "library_ms": lib_ms,
                           "library": "torch.matmul(a.t(), b)",
                           "tiling": pl.describe()}
                del a, b, out, exact, plain
                torch.cuda.empty_cache()
    row["shapes"] = shapes
    return row


def phase_metg(torch, mm_ops, metg):
    """The paper's dwork scheduler at the full METG ladder and backlog
    (launch.metg.main with its defaults); returns the kernel's launches over
    the run, which must be one per task run plus the launches made without
    the scheduler (warm-up, timing, the plain loop), and the run's table of
    all three schedulers' METG."""
    gc.collect()
    torch.cuda.empty_cache()
    mm_ops.tiled_matmul.launches = 0
    t0 = time.perf_counter()
    res = metg.main(["--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = mm_ops.tiled_matmul.launches
    want, tasks = 0, 0
    for r in res["rows"]:
        runs = (r["loop"], r["overlap"], r["front_door"])
        for run in runs:
            st = run["stats"]
            if st["errors"] or st["completed"] != st["created"] \
                    or st["created"] != r["tasks"] + 1 or not run["gathered"]:
                raise SystemExit(f"dwork {run['client']} at n={r['n']}: {st}")
            tasks += run["matmul_tasks"]
        if r["launched"] != r["direct_launches"] + sum(
                run["matmul_tasks"] for run in runs):
            raise SystemExit(f"launch accounting at n={r['n']}: {r}")
        if r["checked"] == 0 or r["worst_err_over_tol"] > 1.0:
            raise SystemExit(f"sampled checks at n={r['n']}: {r['checked']} "
                             f"checked, worst/tol {r['worst_err_over_tol']}")
        want += r["launched"]
    print(f"[c] dwork METG ladder {[r['n'] for r in res['rows']]} in "
          f"{wall:.1f}s (run_loop, OverlapClient and the futures front "
          f"door): {tasks} tasks run through the kernel, every server "
          f"completed == created with 0 errors and its gather done; "
          f"tiled_matmul launches={launches} (want {want}: the tasks plus "
          f"{want - tasks} launches without the scheduler)")
    if launches != want:
        raise SystemExit(f"tiled_matmul launched {launches} times, want {want}")
    return launches, res["schedulers"]


def front_door_configs(jdir):
    """name -> (scheduler, Client keywords, kernel launches a task): the
    three schedulers inproc, dwork on a ShardedHub of 4, dwork on two
    threads, dwork with a transient fault on every task's first attempt,
    retries and a journal (README.md, "Durability and retries"), and dwork
    behind the forwarding tree (8 workers, 4 a leaf), alone and composed
    with a ShardedHub of 4 (README.md's `transport="tree", shards=4`)."""
    from repro_torch.core.engine import FaultPlan, RetryPolicy
    return {
        "dwork": ("dwork", {}, 1),
        "pmake": ("pmake", {}, 1),
        "mpi_list": ("mpi_list", {}, 1),
        "dwork shards=4": ("dwork", {"shards": 4}, 1),
        "dwork thread x2": ("dwork", {"transport": "thread", "workers": 2},
                            1),
        "dwork retry+journal": ("dwork", {
            "faults": FaultPlan(seed=1).fail_first_k(1),
            "retry": RetryPolicy(max_attempts=3),
            "journal_dir": str(jdir)}, 2),
        "dwork tree": ("dwork", {"transport": "tree", "workers": 8,
                                 "tree_fanout": 4}, 1),
        "dwork tree shards=4": ("dwork", {"transport": "tree", "workers": 8,
                                          "tree_fanout": 4, "shards": 4}, 1),
    }


def phase_front_door(torch, mm_ops, metg):
    """A^T B tasks on the card through `repro_torch.client.Client` for each
    of `front_door_configs`, FRONT_DOOR_TASKS a size: every future resolves
    ok, one C in 64 lies within `launch.metg.tolerance` of the plain
    version, `tiled_matmul` launched once per task run (twice a task in the
    retry run: its failed first attempt ran the kernel too), the backend
    completed every task it created with 0 errors, and `Engine.recover`
    finds nothing to redo in the retry run's journal, and the tree runs'
    backend stats carry their "tree" section and their trace its hop ops.
    Prints, and does not hold, the wall time per task, the efficiency
    against the kernel's time, the empirical per-task overhead and its
    crosscheck against the port's METGModel, and in the tree runs the mean
    us of each `hop:L1` / `hop:L1:s<j>` op from `rpc_by_op`.  Returns a
    summary for the JSON line."""
    from repro_torch.client import Client
    from repro_torch.core.engine import Engine, Journal, crosscheck
    from repro_torch.core.metg import METGModel
    gen = torch.Generator(device="cuda").manual_seed(3)
    jroot = Path(tempfile.mkdtemp(prefix="front_door_"))
    summary = {}
    try:
        for n in FRONT_DOOR_SIZES:
            tasks = metg.MatmulTasks([tuple(
                torch.randn((n, n), generator=gen, device="cuda")
                for _ in "ab") for _ in range(metg.PAIRS)])
            kernel_s, _ = metg.kernel_time(tasks)
            pairs = len(tasks.c)
            for name, (sched, kw, per_task) in front_door_configs(
                    jroot / f"wal{n}").items():
                checked0 = tasks.checked
                mm_ops.tiled_matmul.launches = 0
                gc.collect()
                gc.disable()
                try:
                    t0 = time.perf_counter()
                    with Client(scheduler=sched, **kw) as c:
                        if sched == "mpi_list":
                            def block(rank):
                                return all([tasks(
                                    f"mm:{n}:{i}", {"pair": i % pairs})
                                    for i in range(rank, FRONT_DOOR_TASKS,
                                                   FRONT_DOOR_RANKS)])
                            futs = c.map(block, range(FRONT_DOOR_RANKS))
                        else:
                            futs = [c.submit(tasks, f"mm:{n}:{i}",
                                             {"pair": i % pairs})
                                    for i in range(FRONT_DOOR_TASKS)]
                        values = c.gather(futs, timeout=600.0)
                        wall = time.perf_counter() - t0
                        ov = c.report()
                        steal_n = c.engine.steal_n
                        shards = c.engine.shards
                    rep = c.close()
                finally:
                    gc.enable()
                launches = mm_ops.tiled_matmul.launches
                st = rep.backend_stats
                per = st.get("shards", [st])
                created = sum(x["created"] for x in per)
                errors = sum(x["errors"] for x in per)
                want = FRONT_DOOR_TASKS * per_task
                per_task_s = wall / FRONT_DOOR_TASKS
                if sched == "pmake":
                    law = METGModel.from_measured(
                        launch_s=ov.rpc_per_task_s).pmake_metg(ov.workers)
                else:
                    law = METGModel.from_measured(
                        rtt_s=ov.rpc_per_task_s).dwork_metg(
                            ov.workers, steal_n=steal_n, shards=shards)
                chk = crosscheck(sched, ov.per_task_overhead_s, law)
                summ = ov.summary()
                print(f"[c] front door n={n} {name}: {len(futs)} futures, "
                      f"{FRONT_DOOR_TASKS} tasks in {wall:.3f}s, "
                      f"{per_task_s * 1e3:.4f} ms a task (kernel "
                      f"{kernel_s * 1e3:.4f}, efficiency "
                      f"{kernel_s / per_task_s:.3f}); empirical overhead "
                      f"{summ['per_task_overhead_us']} us a task, rpc "
                      f"{summ['rpc_per_task_us']} us, crosscheck same_order="
                      f"{chk['same_order']} (ratio {chk['ratio']:.3g}); "
                      f"tiled_matmul launches={launches} (want {want}); "
                      f"completed={st['completed']} created={created} "
                      f"errors={errors}; sampled C checked "
                      f"{tasks.checked - checked0}, worst/tol "
                      f"{tasks.worst:.3e}")
                if not all(v is True for v in values) or tasks.failures:
                    raise SystemExit(f"front door {name} at n={n}: a task "
                                     f"failed its check: {tasks.failures[:3]}")
                if launches != want:
                    raise SystemExit(f"front door {name} at n={n}: "
                                     f"tiled_matmul launched {launches} "
                                     f"times, want {want}")
                if st["completed"] != created or errors \
                        or created != len(futs):
                    raise SystemExit(f"front door {name} at n={n}: {st}")
                if tasks.checked == checked0:
                    raise SystemExit(f"front door {name} at n={n}: no C "
                                     f"was checked")
                hop_us = None
                if kw.get("transport") == "tree":
                    hops = {op: v for op, v in sorted(ov.rpc_by_op.items())
                            if op.startswith("hop:")}
                    hop_us = {op: t / c * 1e6 for op, (c, t) in hops.items()}
                    print(f"[c] front door n={n} {name}: tree "
                          f"{st.get('tree')}; mean us a hop "
                          + ", ".join(f"{op} {us:.1f} (n={hops[op][0]})"
                                      for op, us in hop_us.items()))
                    if "tree" not in st or not hops:
                        raise SystemExit(f"front door {name} at n={n}: no "
                                         f"tree stats or no hop ops: {st}")
                if "journal_dir" in kw:
                    jdir = kw["journal_dir"]
                    pending = Journal.replay(jdir).pending()
                    redo = sorted(Engine.recover(jdir).run(
                        lambda name, meta: True).completed)
                    print(f"[c] front door n={n} {name}: Engine.recover "
                          f"finds {len(redo)} tasks to redo, the journal "
                          f"{len(pending)} pending")
                    if pending or redo:
                        raise SystemExit(f"front door {name} at n={n}: "
                                         f"recover would redo {redo[:3]}")
                summary[f"{name} n={n}"] = {
                    "ms_per_task": per_task_s * 1e3,
                    "efficiency": kernel_s / per_task_s,
                    "overhead_us": summ["per_task_overhead_us"],
                    "launches": launches, "same_order": chk["same_order"]}
                if hop_us is not None:
                    summary[f"{name} n={n}"]["hop_us"] = hop_us
            del tasks
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(jroot, ignore_errors=True)
    return summary


def scrape_once(url: str) -> dict:
    """GET /stats and /metrics once: (the /stats JSON, the /metrics
    samples as {name{labels}: value})."""
    import urllib.request
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        stats = json.loads(r.read().decode())
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    samples = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            if not PROM_SAMPLE.match(line):
                raise SystemExit(f"proc: not a Prometheus sample: {line!r}")
            key, value = line.rsplit(" ", 1)
            samples[key] = float(value)
    return stats, samples


def phase_proc(torch, metg, front_door):
    """The proc transport on the card: `Client(scheduler="dwork",
    transport="proc", workers=PROC_WORKERS)` spawns worker PROCESSES, each
    with its own CUDA context, running `launch.metg.proc_matmul` tasks that
    make their operands from (n, PROC_SEED) on the card and launch
    `tiled_matmul` there.  One session, four runs:

      1. PROC_TASKS fp32 A^T B tasks a size, after a warm-up: every future
         ok, each C's sum within n x the tolerance of the plain C's (made
         here from the same seed: n^2 rounding errors of random sign add up
         to about n x theirs), one task in 64 held element by element
         against the plain version inside the worker, the pairs taken in
         turn; the pids seen are exactly `worker_pids()`'
         and none is this process's; every worker launched the kernel, and
         the launches summed over the processes equal the tasks run.  One
         /stats and /metrics scrape through `Client.stats_server()`:
         `repro_worker_rss_bytes` for every worker, and the xfer section;
      2. the fan-in: PROC_FAN producers return C (4 MiB, above inline_bytes:
         it stays in the producer's store), PROC_FAN consumers each take two
         producers' C and return the sum of their sum, held against the
         plain one as in 1.; peer fetches > 0, none lost; one producer's C gathered
         here through its RemoteValue, equal to the plain C;
      3. the SIGKILL drill: one worker killed mid-run of PROC_DRILL_TASKS:
         every future ok, each resolved exactly once, requeued >= 1;
      4. the backend completed every task it created, with 0 errors.

    Prints ms a task and efficiency against the kernel's time beside the
    in-process dwork rows of `[c] front door`, the peer and hub fetches,
    their bytes and seconds.  The launch counts live in the workers: each
    task returns its process's running count.  Returns a summary."""
    import collections
    import signal
    from repro_torch.client import Client
    from repro_torch.core.engine.comm import serialize
    # the operands the workers make (`metg.seeded_tasks`), made here from
    # the same seed, with their plain products
    ref = {n: metg.seeded_operands(n, PROC_SEED)
           for n in FRONT_DOOR_SIZES}
    kernel_s = {n: metg.kernel_time(t)[0] for n, t in ref.items()}
    plain_sum = {n: [float(c.double().sum()) for c in t.plain]
                 for n, t in ref.items()}
    pairs = metg.PAIRS
    summary = {"workers": PROC_WORKERS}
    runs = collections.Counter()          # tasks submitted, all runs
    last = {}                             # pid -> its last launch count
    worst = collections.defaultdict(float)  # what -> max |sum - plain| / tol

    def check_sum(n, pairs_of, total, want, what):
        lim = n * sum(ref[n].limit[p] for p in pairs_of)
        worst[what] = max(worst[what], abs(total - want) / lim)
        if not abs(total - want) <= lim:
            raise SystemExit(f"proc {what}: sum of C {total!r} vs plain "
                             f"{want!r} (tol {lim:.3e})")

    def take(vals, n, pairs_of, what):
        for (total, pid, launches, _), pair in zip(vals, pairs_of):
            check_sum(n, [pair], total, plain_sum[n][pair], what)
            last[pid] = max(last.get(pid, 0), launches)

    def checked(i):
        # one task in CHECK_EVERY, its pair turning with each block of them
        return i % metg.CHECK_EVERY == i // metg.CHECK_EVERY % pairs

    t_session = time.perf_counter()
    with Client(scheduler="dwork", transport="proc",
                workers=PROC_WORKERS) as c:
        eng = c.start().engine
        if not eng.wait_workers(PROC_WORKERS, timeout=120):
            raise SystemExit(f"proc: {len(eng.worker_pids())} of "
                             f"{PROC_WORKERS} workers joined in 120 s")
        pids = eng.worker_pids()
        if len(set(pids.values())) != PROC_WORKERS \
                or os.getpid() in pids.values():
            raise SystemExit(f"proc: worker pids {pids}, this process "
                             f"{os.getpid()}")
        t0 = time.perf_counter()
        for n in FRONT_DOOR_SIZES:
            warm = [c.submit(metg.proc_matmul, n, i % pairs, PROC_SEED,
                             hold_s=PROC_WARM_HOLD_S)
                    for i in range(PROC_WARM_TASKS)]
            take(c.gather(warm, timeout=300), n,
                 [i % pairs for i in range(PROC_WARM_TASKS)], "warm-up")
            runs["tasks"] += PROC_WARM_TASKS
        warm_s = time.perf_counter() - t0
        srv = c.stats_server()
        stats, samples = scrape_once(srv.url)
        rss = {w: samples.get(f'repro_worker_rss_bytes{{worker="{w}"}}')
               for w in pids}
        xfer = stats.get("engine", {}).get("xfer")
        pickler = serialize._pickler
        print(f"[c] proc: {PROC_WORKERS} workers joined, pids "
              f"{sorted(pids.values())} (this process {os.getpid()}), "
              f"tasks pickled by {pickler.__name__} "
              f"{getattr(pickler, '__version__', '')}; "
              f"warm-up {2 * PROC_WARM_TASKS} tasks in {warm_s:.2f}s; "
              f"/stats and /metrics scraped: repro_worker_rss_bytes "
              + ", ".join(f"{w} {v / 2**20:.0f} MiB" if v else f"{w} {v}"
                          for w, v in sorted(rss.items()))
              + f"; xfer {xfer}")
        if not all(v and v > 0 for v in rss.values()) or xfer is None:
            raise SystemExit(f"proc: /metrics rss {rss}, /stats xfer {xfer}")
        for n in FRONT_DOOR_SIZES:
            gc.collect()
            gc.disable()
            try:
                t0 = time.perf_counter()
                futs = [c.submit(metg.proc_matmul, n, i % pairs, PROC_SEED,
                                 check=checked(i))
                        for i in range(PROC_TASKS)]
                vals = c.gather(futs, timeout=600)
                wall = time.perf_counter() - t0
            finally:
                gc.enable()
            runs["tasks"] += PROC_TASKS
            take(vals, n, [i % pairs for i in range(PROC_TASKS)],
                 f"n={n}")
            ratios = [v[3] for v in vals if v[3] is not None]
            want_pairs = collections.Counter(
                i % pairs for i in range(PROC_TASKS) if checked(i))
            got_pairs = collections.Counter(
                i % pairs for i, v in enumerate(vals) if v[3] is not None)
            seen = collections.Counter(v[1] for v in vals)
            per_task = wall / PROC_TASKS
            inproc = (front_door or {}).get(f"dwork n={n}", {})
            print(f"[c] proc n={n}: {PROC_TASKS} tasks in {wall:.3f}s, "
                  f"{per_task * 1e3:.4f} ms a task (kernel "
                  f"{kernel_s[n] * 1e3:.4f}, efficiency "
                  f"{kernel_s[n] / per_task:.3f}; in-process dwork "
                  f"{inproc.get('ms_per_task', float('nan')):.4f} ms, "
                  f"efficiency {inproc.get('efficiency', float('nan')):.3f});"
                  f" tasks a worker {dict(sorted(seen.items()))}; C checked "
                  f"in the workers {len(ratios)} (a pair "
                  f"{dict(sorted(got_pairs.items()))}), worst max|C - plain|"
                  f"/tol {max(ratios):.3e}; sums of C: worst |sum - plain|/"
                  f"(n x tol) {worst[f'n={n}']:.3e}")
            if got_pairs != want_pairs or len(want_pairs) != pairs:
                raise SystemExit(f"proc n={n}: C checked a pair {got_pairs}, "
                                 f"want {want_pairs}")
            summary[f"n={n}"] = {
                "ms_per_task": per_task * 1e3,
                "efficiency": kernel_s[n] / per_task,
                "inproc_ms_per_task": inproc.get("ms_per_task"),
                "worst_over_tol": max(ratios)}
        if set(last) != set(pids.values()) \
                or sum(last.values()) != runs["tasks"] \
                or not all(v > 0 for v in last.values()):
            raise SystemExit(f"proc: launches a worker {last}, want a "
                             f"launch in each of {sorted(pids.values())} "
                             f"summing to {runs['tasks']} tasks")
        print(f"[c] proc: tiled_matmul launches a worker process "
              f"{dict(sorted(last.items()))}, sum {sum(last.values())} = "
              f"{runs['tasks']} tasks run")
        summary["launches"] = sum(last.values())
        summary["launches_by_pid"] = {str(k): v for k, v in last.items()}

        # 2. the fan-in, worker to worker
        n = FRONT_DOOR_SIZES[-1]
        t0 = time.perf_counter()
        prods = [c.submit(metg.proc_matmul_c, n, i % pairs, PROC_SEED)
                 for i in range(PROC_FAN)]
        cons = [c.submit(metg.checksum_of_sum, prods[i],
                         prods[(i + 1) % PROC_FAN]) for i in range(PROC_FAN)]
        sums = c.gather(cons, timeout=600)
        fan_s = time.perf_counter() - t0
        for i, total in enumerate(sums):
            p, q = i % pairs, (i + 1) % PROC_FAN % pairs
            check_sum(n, [p, q], total, plain_sum[n][p] + plain_sum[n][q],
                      f"fan-in consumer {i}")
        c0 = prods[0].result(timeout=600)
        err0 = float((c0.cuda() - ref[n].plain[0]).abs().max())
        with eng._xfer_lock:
            tot = {k: list(v) for k, v in eng.xfer_totals.items()}
        lost = eng.xfer_lost_total
        print(f"[c] proc fan-in n={n}: {PROC_FAN} producers (C "
              f"{c0.numel() * 4 / 2**20:.0f} MiB, inline_bytes "
              f"{eng.inline_bytes}), {PROC_FAN} consumers in {fan_s:.3f}s; "
              + "; ".join(f"{k}: {v[0]} fetches, {v[1] / 2**20:.1f} MiB, "
                          f"{v[2]:.4f}s" for k, v in sorted(tot.items()))
              + f"; lost {lost}; a producer's C gathered here: "
              f"max|C - plain| {err0:.3e} (tol {ref[n].limit[0]:.3e}); "
              f"consumers' sums: worst |sum - plain|/(n x tol) "
              f"{max(v for k, v in worst.items() if k.startswith('fan')):.3e}")
        if tot.get("peer", [0])[0] <= 0 or lost \
                or not err0 <= ref[n].limit[0]:
            raise SystemExit(f"proc fan-in: xfer {tot}, lost {lost}, "
                             f"C error {err0:.3e}")
        summary["fan_in"] = {"s": fan_s, "xfer": tot, "lost": lost}
        runs["fan"] += 2 * PROC_FAN

        # 3. the SIGKILL drill
        resolved = collections.Counter()
        futs = []
        for i in range(PROC_DRILL_TASKS):
            f = c.submit(metg.proc_matmul, n, i % pairs, PROC_SEED,
                         hold_s=PROC_DRILL_HOLD_S)
            f.add_done_callback(lambda fut: resolved.update([fut.name]))
            futs.append(f)
        deadline = time.monotonic() + 120
        while sum(f.done() for f in futs) < PROC_DRILL_TASKS // 4 \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        victim_w, victim = sorted(eng.worker_pids().items())[0]
        done_at_kill = sum(f.done() for f in futs)
        os.kill(victim, signal.SIGKILL)
        vals = c.gather(futs, timeout=600)
        take(vals, n, [i % pairs for i in range(PROC_DRILL_TASKS)], "drill")
        deaths = eng.worker_deaths
        # a value whose only copy died with the victim is recomputed under
        # an alias task of its own (the data plane's zero-loss path)
        recomputes = eng.xfer_lost_total
        runs["drill"] += PROC_DRILL_TASKS
    rep = c.close()
    st = rep.backend_stats
    requeued = st.get("requeued", 0)
    once = sorted(set(resolved.values())) == [1] \
        and len(resolved) == PROC_DRILL_TASKS
    print(f"[c] proc SIGKILL drill: killed {victim_w} (pid {victim}) with "
          f"{done_at_kill}/{PROC_DRILL_TASKS} done; every future ok, each "
          f"resolved once: {once}; worker deaths {deaths}; requeued "
          f"{requeued}; lost values recomputed {recomputes}; backend "
          f"completed={st['completed']} created={st['created']} "
          f"errors={st['errors']}; sums of C: worst |sum - plain|/(n x tol) "
          f"{worst['drill']:.3e}; session "
          f"{time.perf_counter() - t_session:.1f}s")
    created = sum(runs.values()) + recomputes
    if not once or deaths < 1 or requeued < 1 or st["errors"] \
            or st["completed"] != st["created"] or st["created"] != created:
        raise SystemExit(f"proc drill: once={once} deaths={deaths} "
                         f"requeued={requeued} stats={st} (created {created})")
    summary["drill"] = {"requeued": requeued, "deaths": deaths,
                        "done_at_kill": done_at_kill,
                        "recomputes": recomputes}
    del ref
    torch.cuda.empty_cache()
    return summary


# --------------------------------------------- the paper's other schedulers

def _train_log(path: Path) -> dict:
    """A train task's log: its steps' losses and step ms and the kernel op
    calls of its last line."""
    text = path.read_text()
    steps = [(float(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"\[train\] step \d+ loss (\S+) .*?step_ms (\S+)", text)]
    ops = re.search(r"\[train\] kernel op calls flash=(\d+) wkv=(\d+) "
                    r"ssd=(\d+)", text)
    if ops is None:
        raise SystemExit(f"{path.name} has no kernel op calls line:\n"
                         f"{text[-2000:]}")
    return {"losses": [s[0] for s in steps],
            "step_ms": [s[1] for s in steps],
            "flash": int(ops.group(1)), "wkv": int(ops.group(2)),
            "ssd": int(ops.group(3))}


def _no_wall(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "wall_s"}


def _campaign_cli(workdir: Path, dev: str) -> dict:
    """`python -m repro_torch.launch.campaign --workdir workdir --device
    dev`, its other flags at their defaults, from the checkout's src;
    returns its `[campaign]` stats."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.campaign", "--workdir",
         str(workdir), "--device", dev], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=CAMPAIGN_TIMEOUT_S)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[campaign] ")), None)
    if proc.returncode != 0 or line is None:
        logs = "".join(f"\n--- {p.name}\n{p.read_text()[-1500:]}"
                       for p in sorted(workdir.glob("*.log")))
        raise SystemExit(f"the campaign exited {proc.returncode}:\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}{logs}")
    return ast.literal_eval(line[len("[campaign] "):])


def phase_campaign(torch, card, dev="cuda"):
    """pmake on the card.  First `launch.campaign` with the reference's
    defaults (reduced gemma2-2b, 2 shards of 6 steps at batch 4 x seq 64, 2
    nodes): 3 tasks done, 0 errors, a report of 2 shards of 6 steps with
    finite losses, each shard's flash op calls one per layer and step; run
    again, it runs nothing and rewrites no log.  Then a campaign of the same
    shape at full width (FULL_CAMPAIGN_RULES: gemma2-2b, 2 steps at batch 2
    x 1024 a shard, 2 shards and a summarize task) through `PMake(...,
    total_nodes=1)`, which runs the shards one after the other, as one card
    holds one such run: 26 flash op calls a step in each shard's log,
    finite losses, 0 errors, no two tasks at once.  Prints each task's wall
    from `PMake.log`, the train's own step ms and the difference, and any
    kernel library the subprocesses built.  Returns a summary for the JSON
    line."""
    from repro_torch.configs import get_config
    from repro_torch.core.pmake import PMake
    from repro_torch.kernels import _build
    from repro_torch.launch import campaign
    reduced_layers = get_config("gemma2-2b").reduced().n_layers
    libs_before = set(_build.BUILD_DIR.glob("*.so"))
    root = Path(tempfile.mkdtemp(prefix="campaign_"))
    summary = {}
    try:
        ref = root / "reference"
        t0 = time.perf_counter()
        first = stats = _campaign_cli(ref, dev)
        wall = time.perf_counter() - t0
        report = json.loads((ref / "report.json").read_text())
        logs = {n: _train_log(ref / f"train.{n}.log") for n in range(2)}
        print(f"[c] pmake campaign (launch.campaign, its defaults: reduced "
              f"gemma2-2b, 2 shards x 6 steps, batch 4 x 64, 2 nodes) on "
              f"{card}: {stats} in {wall:.1f}s; report " + ", ".join(
                  f"shard {r['shard']}: {r['steps']} steps, loss "
                  f"{r['first_loss']:.4f} -> {r['last_loss']:.4f}"
                  for r in report["shards"]) + "; flash op calls "
              + ", ".join(f"shard {n}: {lg['flash']} ({lg['flash'] / 6:g} a "
                          f"step, want {reduced_layers})"
                          for n, lg in logs.items()))
        if stats["errors"] or stats["done"] != 3 or stats["tasks"] != 3:
            raise SystemExit(f"reference campaign: {stats}")
        if [r["steps"] for r in report["shards"]] != [6, 6] or not all(
                math.isfinite(r[k]) for r in report["shards"]
                for k in ("first_loss", "last_loss")):
            raise SystemExit(f"reference campaign report: {report}")
        if any(lg["flash"] != 6 * reduced_layers or len(lg["losses"]) != 6
               for lg in logs.values()):
            raise SystemExit(f"reference campaign shards: {logs}")
        mtimes = {p.name: p.stat().st_mtime_ns for p in ref.glob("*.log")}
        again = _campaign_cli(ref, dev)
        rewritten = [p.name for p in ref.glob("*.log")
                     if mtimes.get(p.name) != p.stat().st_mtime_ns]
        print(f"[c] pmake campaign rerun (file-sync restart): {again}; "
              f"logs rewritten: {rewritten}")
        if again["tasks"] != 0 or again["errors"] or rewritten \
                or len(mtimes) != 3:
            raise SystemExit(f"the restart ran tasks: {again}, rewrote "
                             f"{rewritten}")

        full = root / "full_width"
        full.mkdir()
        rules = campaign.with_summary_inputs(FULL_CAMPAIGN_RULES.format(
            python=sys.executable, src=ROOT / "src", steps=FULL_CAMPAIGN_STEPS,
            shards=2, device=dev), 2)
        targets = campaign.TARGETS_TMPL.format(shards=2)
        (full / "rules.yaml").write_text(rules)
        (full / "targets.yaml").write_text(targets)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        pm = PMake(rules, targets, root=str(full), total_nodes=1)
        print(f"[c] full-width pmake campaign: {len(pm.tasks)} tasks, EFT "
              f"priorities " + ", ".join(
                  f"{k} {t.priority:.4f}" for k, t in sorted(
                      pm.tasks.items(), key=lambda kv: -kv[1].priority))
              + f"; this process holds memory_reserved="
              f"{reserved / 1e9:.3f} GB of the card")
        stats = pm.run()
        spans = {}
        for e in pm.log:
            spans.setdefault(e["task"], {})[e["event"]] = e["t"]
        order = sorted(spans.items(), key=lambda kv: kv[1]["start"])
        overlap = [(a, b) for (a, sa), (b, sb) in zip(order, order[1:])
                   if sb["start"] < sa["done"]]
        rows = {}
        for n in range(2):
            lg = _train_log(full / f"train.{n}.log")
            recs = [json.loads(ln) for ln in (full / f"shard_{n}.jsonl")
                    .read_text().splitlines() if ln]
            sp = spans[f"train.{n}@."]
            task_s = sp["done"] - sp["start"]
            steps_s = sum(r["step_ms"] for r in recs) / 1e3
            rows[n] = {"task_s": task_s, "steps_s": steps_s,
                       "launch_s": task_s - steps_s, "flash": lg["flash"],
                       "losses": lg["losses"],
                       "step_ms": [r["step_ms"] for r in recs]}
            print(f"[c] full-width campaign shard {n} (gemma2-2b, "
                  f"{FULL_CAMPAIGN_STEPS} steps at batch 2 x 1024) on "
                  f"{card}: task wall {task_s:.3f}s (PMake.log), the "
                  f"train's own steps {steps_s:.3f}s (step_ms "
                  f"{', '.join(f'{x:.1f}' for x in rows[n]['step_ms'])}), "
                  f"difference {task_s - steps_s:.3f}s (the task's launch: "
                  f"sh, Python, imports, the model's init); flash op calls "
                  f"{lg['flash']} ({lg['flash'] / FULL_CAMPAIGN_STEPS:g} a "
                  f"step, want 26); losses {lg['losses']}")
        sp = spans.get("summarize@.", {})
        print(f"[c] full-width campaign: {stats}; summarize task wall "
              f"{sp.get('done', math.nan) - sp.get('start', math.nan):.3f}s;"
              f" tasks at once: {'none' if not overlap else overlap}")
        if stats["errors"] or stats["done"] != 3 or overlap:
            raise SystemExit(f"full-width campaign: {stats}, overlaps "
                             f"{overlap}")
        for n, r in rows.items():
            if r["flash"] != 26 * FULL_CAMPAIGN_STEPS or len(r["losses"]) \
                    != FULL_CAMPAIGN_STEPS or not np.isfinite(
                        r["losses"]).all():
                raise SystemExit(f"full-width campaign shard {n}: {r}")
        summary = {"reference": {"wall_s": wall, "stats": _no_wall(first),
                                 "restart": _no_wall(again),
                                 "flash_per_step": reduced_layers},
                   "full_width": {n: {k: r[k] for k in (
                       "task_s", "steps_s", "launch_s", "flash")}
                       for n, r in rows.items()},
                   "launches_per_step": 26}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    built = sorted(p.name for p in set(_build.BUILD_DIR.glob("*.so"))
                   - libs_before)
    print(f"[c] kernel libraries the campaigns' subprocesses built: "
          f"{built or 'none (they loaded the builds of phase (a))'}")
    return summary


def phase_mpi_list(torch, mm_ops, metg, card, dev="cuda"):
    """The engine-backed mpi-list `Context` on the card: 16 ranks on 4
    engine workers map MPI_ELEMENTS elements, each one fp32 A^T B at
    n = MPI_N (`launch.metg.MatmulTasks`: one C in 64 held against the
    plain version at `launch.metg.tolerance`); then the same with seeded
    straggler jitter, whose `straggler_crosscheck()` and mean sync gap are
    printed.  Holds one `tiled_matmul` launch an element, every element's
    check, and the collected list in order.  Returns a summary for the
    JSON line."""
    from repro_torch.core.mpi_list import Context
    tasks = metg.seeded_operands(MPI_N, 6, dev)
    kernel_s, _ = metg.kernel_time(tasks)
    pairs = len(tasks.c)
    out = {}
    for label, kw in (("no jitter", {}),
                      ("stragglers", {"straggler_sigma": MPI_SIGMA,
                                      "seed": 1})):
        C = Context(MPI_RANKS, engine_workers=MPI_WORKERS, **kw)
        checked0 = tasks.checked
        gc.collect()
        gc.disable()
        mm_ops.tiled_matmul.launches = 0
        try:
            t0 = time.perf_counter()
            res = C.iterates(MPI_ELEMENTS).map(
                lambda i: (i, tasks(f"mm:{i}", {"pair": i % pairs})))
            wall = time.perf_counter() - t0
        finally:
            gc.enable()
        launches = mm_ops.tiled_matmul.launches
        got = res.collect()
        res.check_partition_law()
        gap_ms = sum(C.gaps) / len(C.gaps) * 1e3
        line = (f"[c] mpi-list Context({MPI_RANKS}, engine_workers="
                f"{MPI_WORKERS}) {label} on {card}: iterates({MPI_ELEMENTS})"
                f".map(one A^T B at n={MPI_N}) in {wall:.3f}s, "
                f"{wall / MPI_ELEMENTS * 1e3:.4f} ms an element (kernel "
                f"{kernel_s * 1e3:.4f}, efficiency "
                f"{kernel_s * MPI_ELEMENTS / wall:.3f}); tiled_matmul "
                f"launches={launches} (want {MPI_ELEMENTS}); C checked "
                f"{tasks.checked - checked0}, worst/tol {tasks.worst:.3e}; "
                f"supersteps {C.step}, mean sync gap {gap_ms:.4f} ms, "
                f"per-rank ms min/max "
                f"{min(C.rank_times[0]) * 1e3:.3f}/"
                f"{max(C.rank_times[0]) * 1e3:.3f}")
        summ = {"wall_s": wall, "ms_per_element": wall / MPI_ELEMENTS * 1e3,
                "launches": launches, "mean_gap_ms": gap_ms}
        if kw:
            chk = C.straggler_crosscheck()
            line += (f"; injected sigma {MPI_SIGMA * 1e3:g} ms, virtual gap "
                     f"{C.virtual_gaps[0] * 1e3:.4f} ms; straggler_crosscheck"
                     f" {chk}")
            summ["crosscheck"] = chk
        print(line)
        if launches != MPI_ELEMENTS or tasks.failures \
                or got != [(i, True) for i in range(MPI_ELEMENTS)]:
            raise SystemExit(f"mpi-list {label}: {launches} launches, "
                             f"failures {tasks.failures[:3]}")
        if tasks.checked - checked0 < MPI_ELEMENTS // metg.CHECK_EVERY:
            raise SystemExit(f"mpi-list {label}: too few C checked")
        out[label] = summ
    return out


def phase_mesh_ops(torch, card, dev="cuda"):
    """The DFM bridge (`core.mpi_list.mesh_ops`) on the card: a seeded fp32
    DFM of MESH_ROWS rows and a pytree {"x": (2^20, 64) fp32, "y": (2^20,)
    int32}, held against numpy: map exactly (the same fp32 operations) or,
    for x*x+1, within 3 roundings of the fp64 value; sum and the pairwise
    reduce of the fp32 rows against the fp64 sum (MESH_SUM_CHAIN terms
    accumulated in a row at most, the reduce's depth 2 log2 N), integers
    exactly; the add scan against torch.cumsum in fp64 within
    ceil(log2 N) roundings of the running sum of |x| (the doubling scan's
    depth); group into 7 buckets exactly against np.argsort(kind="stable").
    Prints each operation's ms (CUDA events)."""
    from repro_torch.core.mpi_list import mesh_ops as mo
    u = 2.0 ** -24
    gen = torch.Generator(device=dev).manual_seed(7)
    n = MESH_ROWS
    x = torch.randn(n, generator=gen, device=dev)
    dest = torch.randint(0, 7, (n,), generator=gen, device=dev)
    xh = x.cpu().numpy().astype(np.float64)
    ms, held = {}, []
    ms["iterates"] = cuda_ms(lambda: mo.iterates(dev, n), 3)
    it = mo.iterates(dev, n)
    held.append(("iterates", it.dtype == torch.int32 and bool(
        (it == torch.arange(n, device=dev)).all())))
    del it
    f = lambda v: v * v + 1.0  # noqa: E731
    ms["map"] = cuda_ms(lambda: mo.dfm_map(dev, f, x), 3)
    m = mo.dfm_map(dev, f, x)
    mh = xh * xh + 1.0
    held.append(("map", bool(np.all(np.abs(m.cpu().numpy() - mh)
                                    <= 3 * u * mh))))
    mabs = float(np.abs(mh).sum())
    ms["sum"] = cuda_ms(lambda: mo.dfm_sum(dev, m), 3)
    s = float(mo.dfm_sum(dev, m))
    sum_err = abs(s - float(mh.sum()))
    held.append(("sum", sum_err <= MESH_SUM_CHAIN * u * mabs))
    add = lambda a, b: a + b  # noqa: E731
    ms["reduce"] = cuda_ms(lambda: mo.dfm_reduce(dev, add, m), 1)
    r = float(mo.dfm_reduce(dev, add, m))
    red_err = abs(r - float(mh.sum()))
    depth = 2 * math.ceil(math.log2(n))
    held.append(("reduce", red_err <= depth * u * mabs))
    del m
    ms["scan"] = cuda_ms(lambda: mo.dfm_scan(dev, add, x), 1)
    sc = mo.dfm_scan(dev, add, x)
    xd = x.double()
    ref = torch.cumsum(xd, 0)
    lim = math.ceil(math.log2(n)) * u * torch.cumsum(xd.abs(), 0)
    scan_err = float(((sc.double() - ref).abs() / lim).max())
    held.append(("scan", scan_err <= 1.0))
    del sc, xd, ref, lim
    ms["group"] = cuda_ms(lambda: mo.group(dev, dest, x), 3)
    g = mo.group(dev, dest, x).cpu().numpy()
    order = np.argsort(dest.to(torch.int8).cpu().numpy(), kind="stable")
    held.append(("group", bool(np.array_equal(g, x.cpu().numpy()[order]))))
    del g, order
    ms["repartition"] = cuda_ms(lambda: mo.repartition(dev, x), 3)
    held.append(("repartition", mo.repartition(dev, x).data_ptr()
                 == x.data_ptr()))

    rows = MESH_TREE_ROWS
    tree = {"x": torch.randn((rows, 64), generator=gen, device=dev),
            "y": torch.randint(0, 100, (rows,), generator=gen,
                               device=dev, dtype=torch.int32)}
    th = {k: v.cpu().numpy() for k, v in tree.items()}
    tf = lambda t: {"x": t["x"] * 2.0 + 1.0, "y": t["y"] * 3}  # noqa: E731
    ms["map tree"] = cuda_ms(lambda: mo.dfm_map(dev, tf, tree), 3)
    tm = mo.collect(mo.dfm_map(dev, tf, tree))
    held.append(("map tree", np.array_equal(tm["x"], th["x"] * np.float32(2)
                                            + np.float32(1))
                 and np.array_equal(tm["y"], th["y"] * 3)))
    ts = mo.collect(mo.dfm_sum(dev, tree))
    xs = th["x"].astype(np.float64)
    held.append(("sum tree", int(ts["y"]) == int(th["y"].astype(np.int64)
                                                 .sum())
                 and bool(np.all(np.abs(ts["x"] - xs.sum(0)) <=
                                 MESH_SUM_CHAIN * u * np.abs(xs).sum(0)))))
    tsc = mo.collect(mo.dfm_scan(dev, add, tree))
    held.append(("scan tree", np.array_equal(
        tsc["y"], np.cumsum(th["y"].astype(np.int64)).astype(np.int32))
        and bool(np.all(np.abs(tsc["x"] - np.cumsum(xs, 0)) <=
                        math.ceil(math.log2(rows)) * u
                        * np.cumsum(np.abs(xs), 0)))))
    tdest = tree["y"] % 7
    ms["group tree"] = cuda_ms(lambda: mo.group(dev, tdest, tree), 3)
    tg = mo.collect(mo.group(dev, tdest, tree))
    torder = np.argsort(th["y"] % 7, kind="stable")
    held.append(("group tree", all(np.array_equal(tg[k], th[k][torder])
                                   for k in th)))
    print(f"[c] mpi-list DFM bridge (mesh_ops) on {card}: {n} fp32 rows "
          f"({n * 4 / 2**20:.0f} MiB) and a pytree x {rows} x 64 fp32, y "
          f"{rows} int32; ms " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in ms.items())
          + f"; sum |err| {sum_err:.3e} (limit "
          f"{MESH_SUM_CHAIN * u * mabs:.3e}), reduce |err| {red_err:.3e} "
          f"(limit {depth * u * mabs:.3e}), scan max err/limit "
          f"{scan_err:.3e}; held: " + ", ".join(
              f"{k} {'ok' if ok else 'FAILED'}" for k, ok in held))
    bad = [k for k, ok in held if not ok]
    if bad:
        raise SystemExit(f"mesh_ops disagrees with numpy: {bad}")
    cut = MESH_ON_MESH_ROWS
    ms["mesh_s"] = mesh_ops_on_mesh(torch, mo, x[:cut], dest[:cut], tree)
    return ms


def mesh_ops_on_mesh(torch, mo, x, dest, tree):
    """The same DFMs (the first MESH_ON_MESH_ROWS rows of the fp32 one)
    through the bridge on a 1x1 mesh on the card: every operation's
    result equal to the one-device path's, bit for bit."""
    t0 = time.perf_counter()
    dev = "cuda"
    add = lambda a, b: a + b  # noqa: E731
    f = lambda v: v * v + 1.0  # noqa: E731
    tf = lambda t: {"x": t["x"] * 2.0 + 1.0, "y": t["y"] * 3}  # noqa: E731
    ops = {
        "iterates": lambda w: mo.iterates(w, x.shape[0]),
        "map": lambda w: mo.dfm_map(w, f, x),
        "sum": lambda w: mo.dfm_sum(w, mo.dfm_map(w, f, x)),
        "reduce": lambda w: mo.dfm_reduce(w, add, mo.dfm_map(w, f, x)),
        "scan": lambda w: mo.dfm_scan(w, add, x),
        "group": lambda w: mo.group(w, dest, x),
        "repartition": lambda w: mo.repartition(w, x),
        "map tree": lambda w: mo.dfm_map(w, tf, tree),
        "sum tree": lambda w: mo.dfm_sum(w, tree),
        "scan tree": lambda w: mo.dfm_scan(w, add, tree),
        "group tree": lambda w: mo.group(w, tree["y"] % 7, tree),
    }
    held = {}
    with host_mesh(torch) as mesh:
        for k, op in ops.items():
            one, on_mesh = mo.collect(op(dev)), mo.collect(op(mesh))
            a = one if isinstance(one, dict) else {"": one}
            b = on_mesh if isinstance(on_mesh, dict) else {"": on_mesh}
            held[k] = a.keys() == b.keys() and all(
                np.asarray(a[j]).dtype == np.asarray(b[j]).dtype
                and np.asarray(a[j]).tobytes() == np.asarray(b[j]).tobytes()
                for j in a)
    secs = time.perf_counter() - t0
    print(f"[c] mpi-list DFM bridge on a 1x1 mesh on the card (DTensors "
          f"split over data): " + ", ".join(
              f"{k} {'equal' if ok else 'DIFFERS'}" for k, ok in held.items())
          + f" to the one-device path bit for bit; phase {secs:.1f}s")
    bad = [k for k, ok in held.items() if not ok]
    if bad:
        raise SystemExit(f"mesh_ops on a mesh differs from one device: {bad}")
    return secs


def start_dryrun():
    """The DRYRUN_CELLS as subprocesses of `python -m
    repro_torch.launch.dryrun` (each a fake group on the CPU), all started
    together: {cell: (process, its record's path, start time)}."""
    out_dir = ROOT / "build" / "chip_dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for arch, shape, mesh, args in DRYRUN_CELLS:
        rec_path = out_dir / f"{arch}__{shape}__{mesh}.json"
        if rec_path.exists():
            rec_path.unlink()
        procs[arch, shape, mesh] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, *args, "--out-dir", str(out_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), rec_path, time.perf_counter())
    return procs


def phase_dryrun(procs):
    """The dry-run cells `start_dryrun` started: each must end ok within
    DRYRUN_TIMEOUT_S of its start; prints each cell's per-device FLOPs,
    HBM bytes and collective bytes, its roofline terms (counts over the
    H100 data-sheet rates, not times measured on the card) and its
    seconds.  Returns {cell name: its figures}."""
    out, failed = {}, []
    for (arch, shape, mesh), (p, rec_path, t0) in procs.items():
        try:
            _, err = p.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter()
                                                     - t0)))
        except subprocess.TimeoutExpired:
            for q, _, _ in procs.values():
                q.kill()
                q.communicate()
            raise SystemExit(f"the dry run of {arch} x {shape} on {mesh} "
                             f"did not end within {DRYRUN_TIMEOUT_S} s") \
                from None
        secs = time.perf_counter() - t0
        rec = json.loads(rec_path.read_text()) if rec_path.exists() else {}
        coll = rec.get("collective_bytes", {})
        print(f"[c] dry run {arch} x {shape} on a fake {mesh} mesh: "
              f"ok={rec.get('ok')} rc={p.returncode}, collected {secs:.1f}s "
              f"after its start (the cell itself {rec.get('seconds')}s); per "
              f"device flops="
              f"{rec.get('hlo_flops_per_device')} hbm_bytes="
              f"{rec.get('hlo_bytes_per_device')} collective bytes="
              f"{coll.get('total')} "
              f"{ {k: v for k, v in coll.items() if 'total' not in k} }; "
              f"roofline terms (counts over H100 SXM data-sheet rates) "
              f"{rec.get('roofline')}; error {rec.get('error')}")
        if p.returncode != 0 or rec.get("ok") is not True:
            print(err[-3000:], file=sys.stderr)
            failed.append(f"{arch} x {shape}: {rec.get('error')}")
            continue
        out[f"{arch}__{shape}__{mesh}"] = {
            "seconds": secs, "roofline": rec["roofline"],
            "flops_per_device": rec["hlo_flops_per_device"],
            "bytes_per_device": rec["hlo_bytes_per_device"],
            "collective_bytes": coll["total"]}
    if failed:
        raise SystemExit(f"the dry run failed: {failed}")
    return out


def phase_elastic(torch, mm_ops, metg, card, dev="cuda"):
    """The elastic pool and `run_pool` on the card, every task one fp32
    A^T B at n = MPI_N.  `ElasticPool`: ELASTIC_SHARDS shards, two workers,
    one crashing after 3 tasks; all shards complete, at least one is
    requeued, every future resolves ok, `tiled_matmul` launches once per
    shard run (a requeued shard runs again), and `remesh` sees the live
    worker counts (1, 2, then 1 after `lose_worker`).  `run_pool`: a
    `TaskServer` holding RUN_POOL_TASKS tasks at one worker; completed ==
    created with 0 errors, one launch a task.  Returns both summaries."""
    from repro_torch.core.dwork import InProcTransport, TaskServer, run_pool
    from repro_torch.core.dwork import Client as DworkClient
    from repro_torch.runtime.elastic import ElasticPool
    tasks = metg.seeded_operands(MPI_N, 8, dev)
    kernel_s, _ = metg.kernel_time(tasks)
    pairs = len(tasks.c)
    calls = []
    mm_ops.tiled_matmul.launches = 0
    t0 = time.perf_counter()
    with ElasticPool(lease_timeout=60.0, remesh=calls.append,
                     per_task_s=kernel_s) as pool:
        futs = [pool.submit(f"shard{i}", meta={"pair": i % pairs})
                for i in range(ELASTIC_SHARDS)]
        pool.start_worker("w_crash", tasks, fail_after=3)
        pool.start_worker("w_ok", tasks)
        stats = pool.join(timeout=600.0)
        wall = time.perf_counter() - t0
        ok = [f.exception(60.0) is None and f.result(0) is None
              for f in futs]
        ran = len(pool.completed)
        by_worker = {w: sum(1 for x, _ in pool.completed if x == w)
                     for w in ("w_crash", "w_ok")}
        steal_n = pool.engine.steal_n
        pool.lose_worker("w_crash")
    launches = mm_ops.tiled_matmul.launches
    elastic = {"completed": stats["completed"], "requeued":
               stats["requeued"], "launches": launches, "shards_run": ran,
               "remesh": calls, "wall_s": wall, "steal_n": steal_n}
    print(f"[c] ElasticPool on {card}: {ELASTIC_SHARDS} A^T B shards at "
          f"n={MPI_N}, workers w_crash (fail_after=3) and w_ok, steal_n "
          f"{steal_n}: {stats}; shards run {ran} {by_worker}, tiled_matmul "
          f"launches={launches}; futures ok {sum(ok)}/{len(ok)}; remesh "
          f"calls {calls}; {wall:.3f}s")
    if stats["completed"] != ELASTIC_SHARDS or stats["requeued"] < 1 \
            or stats["errors"] or not all(ok) or launches != ran \
            or calls != [1, 2, 1] or tasks.failures:
        raise SystemExit(f"elastic pool: {elastic}, failures "
                         f"{tasks.failures[:3]}")

    srv = TaskServer()
    srv.create_bulk([(f"mm:{i}", (), {"pair": i % pairs})
                     for i in range(RUN_POOL_TASKS)])
    mm_ops.tiled_matmul.launches = 0
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        rep = run_pool(srv, tasks, workers=1)
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
    launches = mm_ops.tiled_matmul.launches
    st = srv.stats()
    ov = rep.overhead().summary()
    print(f"[c] run_pool on {card}: a TaskServer of {RUN_POOL_TASKS} A^T B "
          f"tasks at n={MPI_N}, workers=1: {st}; {wall:.3f}s, "
          f"{wall / RUN_POOL_TASKS * 1e3:.4f} ms a task (kernel "
          f"{kernel_s * 1e3:.4f}, efficiency "
          f"{kernel_s * RUN_POOL_TASKS / wall:.3f}), empirical overhead "
          f"{ov['per_task_overhead_us']} us a task; tiled_matmul "
          f"launches={launches} (want {RUN_POOL_TASKS})")
    if st["completed"] != st["created"] or st["created"] != RUN_POOL_TASKS \
            or st["errors"] or launches != RUN_POOL_TASKS or tasks.failures \
            or len(rep.completed) != RUN_POOL_TASKS:
        raise SystemExit(f"run_pool: {st}, launches {launches}, failures "
                         f"{tasks.failures[:3]}")
    return elastic, {"completed": st["completed"], "launches": launches,
                     "ms_per_task": wall / RUN_POOL_TASKS * 1e3,
                     "overhead_us": ov["per_task_overhead_us"]}


def phase_metg_table(table: dict, card) -> dict:
    """`launch.metg`'s table of all three schedulers, printed by the ladder's
    run in `phase_metg` from the dwork round trip, the popen launch and the
    mpi-list sigma measured on this machine: held to the paper's ordering
    at 864 ranks and dwork's linear scaling, every METG positive."""
    checks = table["checks"]
    print(f"[c] METG, all three schedulers on {card} (the [metg] ranks= "
          f"lines above): {json.dumps(checks)}")
    bad = [row["ranks"] for row in table["rows"]
           if not all(v > 0 for v in row["metg_s"].values())]
    if not checks["ordering_mpilist<dwork<pmake"] \
            or not checks["dwork_scales_linearly"] or bad:
        raise SystemExit(f"METG table: {checks}, non-positive at {bad}")
    return checks

def grad_check(torch, name, kernel_fn, plain_fn, ins, g, out_tol):
    """The kernel op's outputs under autograd (a tensor, or a tuple whose
    first is differentiated and the others unused, as in training) against
    the plain version's on the same inputs, max |diff| <= out_tol *
    max(1, max |plain|) each; then the gradients of sum(out * g) through
    the op against autograd through the plain version (GRAD_TOL), and the
    op's backward ms (recompute and its autograd).  The op's backward is
    the plain version's autograd rerun, so the gradients check how the
    recompute is wired and the outputs check the kernel.  Returns (max
    rel gradient err, ms)."""
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    outs, plains = kernel_fn(*a), plain_fn(*b)
    if torch.is_tensor(outs):
        outs, plains = (outs,), (plains,)
    out_errs = [float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
                for x, y in zip(outs, plains)]
    ga = torch.autograd.grad(outs[0], a, g, retain_graph=True)
    gb = torch.autograd.grad(plains[0], b, g)
    errs = [float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
            for x, y in zip(ga, gb)]
    ok = (max(out_errs) <= out_tol and max(errs) <= GRAD_TOL
          and all(bool(torch.isfinite(x).all()) for x in outs + ga))
    ms = cuda_ms(lambda: torch.autograd.grad(outs[0], a, g,
                                             retain_graph=True), 3)
    print(f"[b] grad {name}: outputs max|diff|/max(1, max|plain|) "
          f"{[float(f'{e:.3e}') for e in out_errs]} (tol {out_tol:.0e}); "
          f"gradients per input {[float(f'{e:.3e}') for e in errs]} (tol "
          f"{GRAD_TOL:.0e}) backward_ms={ms:.2f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the kernel op's outputs or gradients "
                         f"disagree with the plain version's: {out_errs} "
                         f"{errs}")
    return max(errs), ms


def phase_grads(torch, fa_ops, fa_ref):
    """Gradients through the flash op at zamba2's training shape, fp32,
    against autograd through the plain version; then not causal at 448
    queries against 1500 keys (whisper's cross-attention) and at q/k 192
    with v 128 (MLA), each also against the plain version's fp64
    autograd (flash_grad_fp64).  Returns the backward ms per layer in the
    type training runs (bf16), and those two checks' figures."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    kw = dict(scale=ZHD ** -0.5, q_block=512, kv_block=512)
    qkv = [torch.randn((ZB, ZS, ZH, ZHD), generator=gen, device="cuda")
           for _ in range(3)]
    g = torch.randn((ZB, ZS, ZH, ZHD), generator=gen, device="cuda")
    grad_check(torch, f"flash_attention fp32 {(ZB, ZS, ZH, ZHD)} causal",
               lambda *a: fa_ops.flash_attention(*a, **kw),
               lambda *a: fa_ref.flash_attention_blockwise(*a, **kw), qkv, g,
               FP32_TOL)
    # whisper's cross-attention trained at batch 2 (448 queries against
    # 1500 keys, not causal), and MLA's q/k 192 with v 128 at deepseek-v2-
    # lite's training shape: each also against fp64
    t0 = time.perf_counter()
    extra = {}
    for name, (b, s, t, hq, g_, hd, hd_v, causal) in (
            ("whisper_cross", (2, 448, WHF, WHQ, WHG, WHD, WHD, False)),
            ("mla", (2, 1024, 1024, MLAH, MLAH, MLAHD, MLAHDV, True))):
        ins = [torch.randn(shape, generator=gen, device="cuda")
               for shape in ((b, s, hq, hd), (b, t, g_, hd), (b, t, g_, hd_v))]
        go = torch.randn((b, s, hq, hd_v), generator=gen, device="cuda")
        extra[name] = flash_grad_fp64(
            torch, f"flash_attention fp32 q{(b, s, hq, hd)} k{(b, t, g_, hd)} "
            f"v{(b, t, g_, hd_v)} causal={causal}", fa_ops, fa_ref, ins, go,
            dict(causal=causal, scale=hd ** -0.5, q_block=512, kv_block=512))
        del ins, go
    print(f"[b] the flash op's gradients not causal and at 192/128, against "
          f"fp32 and fp64: {time.perf_counter() - t0:.1f}s")
    qkv = [t.bfloat16().requires_grad_() for t in qkv]
    out = fa_ops.flash_attention(*qkv, **kw)
    fa_bwd = cuda_ms(lambda: torch.autograd.grad(out, qkv, g.bfloat16(),
                                                 retain_graph=True), 3)
    print(f"[b] flash_attention bf16 {(ZB, ZS, ZH, ZHD)} backward_ms="
          f"{fa_bwd:.2f} (recompute of the blockwise version, q/kv blocks 512)")
    del qkv, out
    torch.cuda.empty_cache()
    return fa_bwd, extra


def flex_yardstick(torch, q, k, v, window, cap, scale, compiled):
    """The one PyTorch call that computes the gemma2 row's function:
    flex_attention under torch.compile with the tanh softcap as score_mod,
    the causal (+ window) band as block_mask and enable_gqa.  Returns its
    output and its ms; the port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask
    s_len = q.shape[1]

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        return (qi >= ki) & (qi - ki < window)

    mask = create_block_mask(mask_mod, None, None, s_len, s_len,
                             device="cuda")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    call = functools.partial(compiled, qt, kt, vt, score_mod=score_mod,
                             block_mask=mask, scale=scale, enable_gqa=True)
    out = call().transpose(1, 2)
    return out, cuda_ms(call, 5)


def phase_kernel(torch, fa_ops, fa_ref, fa_kernel):
    """Kernel vs plain version; returns the rows for the two main paths'
    cases (gemma2-2b serving, zamba2-2.7b training), the latter with
    zamba2-2.7b serving's bf16 case (its prefill's shape, SDPA the library
    call) under "serve_shape".  Each case prints the kernel and tiling it
    took, which must be the one `route` states (bf16: the tensor cores)."""
    from torch.nn.attention.flex_attention import flex_attention
    print("[b] flash_attention kernel vs plain blockwise version")
    flex = torch.compile(flex_attention)
    flex_compile_s = None
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = zrow = zsrow = row_b1 = zsrow_b1 = ds_b1 = None
    sdpa_b1 = {}
    cases = [(dt, B, S, HQ, G, HD, w, CAP) for dt in ("bfloat16", "float32")
             for w in (4096, S + 1)]
    cases += [(dt, ZB, ZS, ZH, ZH, ZHD, None, 0.0)
              for dt in ("bfloat16", "float32")]
    cases += [("bfloat16", ZSB, ZSS, ZH, ZH, ZHD, None, 0.0)]
    # the served batches through the front door: one prompt each
    cases += [("bfloat16", 1, S, HQ, G, HD, S + 1, CAP),
              ("bfloat16", 1, ZSS, ZH, ZH, ZHD, None, 0.0)]
    # deepseek-7b's served prefill: head dim 128, MHA, causal only
    cases += [("bfloat16", 1, S, DSH, DSH, DSHD, None, 0.0)]
    cases += [(dt, 2, 203, 8, 2, hd, 50, CAP) for dt in ("bfloat16", "float32")
              for hd in (32, 80, 128, 256)]
    cases = [c + (c[5],) for c in cases]          # v's head dim: q's
    # the served MLA prefill of deepseek-v2-lite-16b (q/k 192, v 128) and
    # qwen2-vl-2b's GQA prefill, one prompt each; the pair at a ragged GQA
    # case in both types
    cases += [("bfloat16", 1, S, MLAH, MLAH, MLAHD, None, 0.0, MLAHDV),
              ("bfloat16", 1, S, VLH, VLG, VLHD, None, 0.0, VLHD)]
    # qwen2.5-32b's (GQA 6) and deepseek-67b's / arctic-480b's (GQA 8)
    # served prefill, one prompt each, in both types
    cases += [(dt, 1, S, hq, BIGG, BIGHD, None, 0.0, BIGHD)
              for hq in (QWH, DS67H) for dt in ("bfloat16", "float32")]
    cases += [(dt, 2, 203, 8, 2, MLAHD, 50, CAP, MLAHDV)
              for dt in ("bfloat16", "float32")]
    for dt, b, s, hq, g, hd, window, cap, hd_v in cases:
        dtype = getattr(torch, dt)
        rt = fa_kernel.route(dtype, hd, hd_v)
        if rt != fa_kernel.c_route(dtype, hd, hd_v) or (rt.route == 1) != (
                dt == "bfloat16"):
            raise SystemExit(f"flash_attention route: {rt} stated, "
                             f"{fa_kernel.c_route(dtype, hd, hd_v)} taken")
        q = torch.randn((b, s, hq, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, g, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, s, g, hd_v), generator=gen, device="cuda").to(
            dtype)
        kw = dict(window=window, logit_softcap=cap, scale=hd ** -0.5)
        out = fa_ops.flash_attention(q, k, v, **kw)
        # the plain version upcasts its inputs, so on q.float() etc. it
        # gives the fp32 result that it rounds to q's type
        plain32 = fa_ref.flash_attention_blockwise(
            q.float(), k.float(), v.float(), **kw)
        plain = plain32.to(dtype)
        err = float((out.float() - plain.float()).abs().max())
        if dt == "bfloat16":
            excess = bf16_excess(out, plain32)
            check = (f"beyond one bf16 rounding of the fp32 result: "
                     f"{excess:.3e} (tol {BF16_ATOL:.0e})")
            ok = excess <= BF16_ATOL
        else:
            check = f"(tol {FP32_TOL:.0e})"
            ok = err < FP32_TOL
        ok = ok and bool(torch.isfinite(out).all())
        main_shape = (b, s, hq, g, hd) == (B, S, HQ, G, HD)
        serve_shape = (b, s, hq, g, hd) == (ZSB, ZSS, ZH, ZH, ZHD)
        main_b1 = (b, s, hq, g, hd) == (1, S, HQ, G, HD)
        serve_b1 = (b, s, hq, g, hd) == (1, ZSS, ZH, ZH, ZHD)
        deepseek_b1 = (b, s, hq, g, hd) == (1, S, DSH, DSH, DSHD)
        # the other served prefill shapes in bf16, the type they are served
        # in
        served_b1 = {(1, S, MLAH, MLAH, MLAHD, MLAHDV): "deepseek_v2_lite_b1",
                     (1, S, VLH, VLG, VLHD, VLHD): "qwen2_vl_b1",
                     (1, S, QWH, BIGG, BIGHD, BIGHD): "qwen2_5_32b_b1",
                     (1, S, DS67H, BIGG, BIGHD, BIGHD): "deepseek_67b_b1"}.get(
            (b, s, hq, g, hd, hd_v)) if dt == "bfloat16" else None
        big = main_shape or serve_shape or (b, s) == (1, S)
        ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw),
                     5 if big else 20)
        plain_ms = cuda_ms(lambda: fa_ref.flash_attention_blockwise(
            q, k, v, **kw), 2 if big else 5)
        bound_ms, bound_by, flops = attention_bound(
            b, s, hq, g, hd, window, q.element_size(),
            H100_BF16_FLOPS if dt == "bfloat16" else H100_FP32_FLOPS, hd_v)
        print(f"[b] {dt:8s} q{(b, s, hq, hd)} k{(b, s, g, hd)} "
              f"v{(b, s, g, hd_v)} window={window}"
              f" softcap={cap}: max_abs_err={err:.3e} {check}"
              f" kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}"
              f" bound_ms={bound_ms:.4f} ({bound_by}, {flops:.3e} FLOP)"
              f" [{rt.describe()}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version: {dt} window={window} {check}")
        if (main_shape or main_b1) and dt == "bfloat16":
            if flex_compile_s is None or main_b1:   # a new shape compiles
                t0 = time.perf_counter()
                flex_yardstick(torch, q, k, v, window, cap, SCALE, flex)
                flex_compile_s = time.perf_counter() - t0
            flex_out, flex_ms = flex_yardstick(torch, q, k, v, window, cap,
                                               SCALE, flex)
            print(f"[b] library call torch.compile(flex_attention), softcap "
                  f"score_mod, causal{'' if window > S else ' + window'} "
                  f"block_mask, enable_gqa: flex_ms={flex_ms:.3f} "
                  f"(compiled in {flex_compile_s:.1f}s) kernel_ms={ms:.3f} "
                  f"max_abs_err vs plain fp32="
                  f"{float((flex_out.float() - plain32).abs().max()):.3e}")
            del flex_out
        if main_shape and dt == "bfloat16" and window == S + 1:
            row = {"name": "flash_attention", "path": "gemma2-2b serve",
                   "route": "cuda",
                   "source": "src/repro_torch/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
                   "launches": None, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": flex_ms,
                   "library": "torch.compile(flex_attention)",
                   "tiling": rt.describe()}
            # SDPA computes plain causal attention (no softcap, no window):
            # a yardstick at the same shape, beside the kernel at that setting
            ms_causal = cuda_ms(lambda: fa_ops.flash_attention(
                q, k, v, scale=SCALE), 5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = functools.partial(
                torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                is_causal=True, scale=SCALE, enable_gqa=True)
            sdpa_err = float((sdpa().transpose(1, 2).float() - fa_ops
                              .flash_attention(q, k, v, scale=SCALE).float())
                             .abs().max())
            sdpa_ms = cuda_ms(sdpa, 5)
            print(f"[b] causal only (softcap 0, no window), bf16 main shape: "
                  f"kernel_ms={ms_causal:.3f} sdpa_ms={sdpa_ms:.3f} "
                  f"max_abs_err vs sdpa={sdpa_err:.3e}")
        if main_b1:
            row_b1 = {"shape": [b, s, hq, g, hd], "max_abs_err": err,
                      "bf16_excess": excess, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": flex_ms,
                      "library": "torch.compile(flex_attention)",
                      "tiling": rt.describe()}
        zamba_shape = (b, s, hq, g, hd) == (ZB, ZS, ZH, ZH, ZHD)
        if deepseek_b1:
            # SDPA computes exactly this function: causal, no window, no
            # softcap, one K/V head per query head
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = functools.partial(
                torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                is_causal=True, scale=hd ** -0.5)
            sdpa_err = float((sdpa().transpose(1, 2).float() - out.float())
                             .abs().max())
            sdpa_ms = cuda_ms(sdpa, 5)
            print(f"[b] deepseek-7b serve batch 1 shape: sdpa_ms="
                  f"{sdpa_ms:.4f} max_abs_err vs sdpa={sdpa_err:.3e}")
            ds_b1 = {"shape": [b, s, hq, g, hd], "max_abs_err": err,
                     "bf16_excess": excess, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": sdpa_ms,
                     "library": "scaled_dot_product_attention",
                     "tiling": rt.describe()}
            del qt, kt, vt, sdpa
        if served_b1:
            lib_ms, lib = sdpa_yardstick(torch, q, k, v, out, hd ** -0.5,
                                         served_b1)
            sdpa_b1[served_b1] = {
                "shape": [b, s, hq, g, hd, hd_v], "max_abs_err": err,
                "bf16_excess": excess, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "library": lib,
                "tiling": rt.describe()}
        if (zamba_shape or serve_shape or serve_b1) and dt == "bfloat16":
            # SDPA computes exactly this function: causal, no window, no
            # softcap, one K/V head per query head
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = functools.partial(
                torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                is_causal=True, scale=hd ** -0.5)
            sdpa_err = float((sdpa().transpose(1, 2).float() - out.float())
                             .abs().max())
            sdpa_ms = cuda_ms(sdpa, 5 if serve_shape or serve_b1 else 20)
            what = ("serve" if serve_shape else "serve batch 1" if serve_b1
                    else "train")
            print(f"[b] zamba2 {what} shape: "
                  f"sdpa_ms={sdpa_ms:.4f} max_abs_err vs sdpa="
                  f"{sdpa_err:.3e}")
            del qt, kt, vt, sdpa
        if serve_shape or serve_b1:
            sub = {"shape": [b, s, hq, g, hd], "max_abs_err": err,
                   "bf16_excess": excess, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": sdpa_ms,
                   "library": "scaled_dot_product_attention",
                   "tiling": rt.describe()}
            if serve_shape:
                zsrow = sub
            else:
                zsrow_b1 = sub
        if zamba_shape and dt == "bfloat16":
            zrow = {"name": "flash_attention", "path": "zamba2-2.7b train",
                    "route": "cuda",
                    "source": "src/repro_torch/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
                    "launches": None, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": sdpa_ms,
                    "library": "scaled_dot_product_attention",
                    "tiling": rt.describe()}
        del q, k, v, out, plain, plain32
        torch.cuda.empty_cache()
    zrow["serve_shape"] = zsrow
    zrow["serve_b1"] = zsrow_b1
    row["serve_b1"] = row_b1
    row["deepseek_b1"] = ds_b1
    row.update(sdpa_b1)
    return row, zrow


def phase_kernel_whisper(torch, fa_ops, fa_ref, fa_kernel):
    """The flash kernel at whisper-base's three served shapes
    (WHISPER_CASES), bf16 and fp32, against its plain version (BF16_ATOL
    beyond one rounding, FP32_TOL), each with its ms, the plain version's,
    the bound and SDPA's (the same function: is_causal as the shape,
    enable_gqa); probs_bf16 at the encoder's shape in bf16 against the
    plain version with the flag at the kernel's tiles (probs_bf16_excess,
    PROBS_BF16_FLIP_SHARE), the kernel's output without the flag failing
    that check; and not causal with a window that leaves rows without a
    key: those rows exactly 0 in both types.  The training shapes (TRAIN_CASES) in bf16 likewise, each with
    its backward's ms (the plain version's recompute at blocks of 512).
    Returns the whisper row (the encoder's bf16 figures, the others under
    "cross", "decoder", "fp32", "probs_bf16", "train_encoder",
    "train_cross", "train_decoder") and the MLA training shape's figures."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(29)
    F = torch.nn.functional
    row, fp32, mla = None, {}, None
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        cases = WHISPER_CASES + (TRAIN_CASES if dt == "bfloat16" else ())
        for name, b, s, t, hq, g, hd, hd_v, causal in cases:
            rt, crt = (fa_kernel.route(dtype, hd, hd_v),
                       fa_kernel.c_route(dtype, hd, hd_v))
            if name in ("encoder", "train_mla"):
                print(f"[b] {dt} q/k {hd}, v {hd_v}: route() {rt}; the "
                      f"library's c_route() {crt}")
            if rt != crt:
                raise SystemExit(f"flash_attention route: {rt} stated, "
                                 f"{crt} taken")
            q = torch.randn((b, s, hq, hd), generator=gen,
                            device="cuda").to(dtype)
            k = torch.randn((b, t, g, hd), generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn((b, t, g, hd_v), generator=gen,
                            device="cuda").to(dtype)
            kw = dict(causal=causal, scale=hd ** -0.5)
            out = fa_ops.flash_attention(q, k, v, **kw)
            plain32 = fa_ref.flash_attention_blockwise(
                q.float(), k.float(), v.float(), **kw)
            err = float((out.float() - plain32.to(dtype).float()).abs().max())
            if dt == "bfloat16":
                excess = bf16_excess(out, plain32)
                check = (f"beyond one bf16 rounding of the fp32 result: "
                         f"{excess:.3e} (tol {BF16_ATOL:.0e})")
                ok = excess <= BF16_ATOL
            else:
                check = f"(tol {FP32_TOL:.0e})"
                ok = err < FP32_TOL
            ok = ok and bool(torch.isfinite(out).all())
            ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 20)
            plain_ms = cuda_ms(lambda: fa_ref.flash_attention_blockwise(
                q, k, v, **kw), 5)
            bound_ms, bound_by, flops = attention_bound(
                b, s, hq, g, hd, None, q.element_size(),
                H100_BF16_FLOPS if dt == "bfloat16" else H100_FP32_FLOPS,
                hd_v, t=t, causal=causal)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt,
                                     vt, is_causal=causal, scale=hd ** -0.5,
                                     enable_gqa=g != hq)
            sdpa_err = float((sdpa().transpose(1, 2).float() - out.float())
                             .abs().max())
            sdpa_ms = cuda_ms(sdpa, 20)
            bwd = ""
            if name.startswith("train"):
                # the op's backward in training: the plain version
                # recomputed at blocks of 512 and differentiated
                a = [x.detach().requires_grad_() for x in (q, k, v)]
                o = fa_ops.flash_attention(*a, q_block=512, kv_block=512,
                                           **kw)
                go = torch.randn(o.shape, generator=gen,
                                 device="cuda").to(dtype)
                bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                    o, a, go, retain_graph=True), 3)
                bwd = f" backward_ms={bwd_ms:.3f}"
                del a, o, go
            print(f"[b] {name} {dt:8s} q{(b, s, hq, hd)} k{(b, t, g, hd)} "
                  f"v{(b, t, g, hd_v)} causal={causal}: max_abs_err="
                  f"{err:.3e} {check} kernel_ms={ms:.4f} plain_ms="
                  f"{plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}, "
                  f"{flops:.3e} FLOP) sdpa_ms={sdpa_ms:.4f} max_abs_err vs "
                  f"sdpa={sdpa_err:.3e}{bwd} [{rt.describe()}] "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"flash_attention disagrees with its plain "
                                 f"version at the {name} shape, {dt}: "
                                 f"{check}")
            sub = {"shape": [b, s, t, hq, g, hd, hd_v], "causal": causal,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": sdpa_ms,
                   "library": "scaled_dot_product_attention",
                   "tiling": rt.describe()}
            if bwd:
                sub["bwd_ms"] = bwd_ms
            if name == "train_mla":
                mla = {**sub, "bf16_excess": excess}
            elif dt == "float32":
                fp32[name] = sub
            elif name == "encoder":
                row = {"name": "flash_attention", "path": "whisper-base serve",
                       "route": "cuda",
                       "source": "src/repro_torch/csrc/flash_attention.cu",
                       "replaces":
                           "src/repro/kernels/flash_attention/kernel.py:24",
                       "launches": None, **sub, "bf16_excess": excess}
                enc = (q, k, v)
            else:
                row[name] = {**sub, "bf16_excess": excess}
            del q, k, v, out, plain32, qt, kt, vt, sdpa
    row["fp32"] = fp32

    # probs_bf16 at the encoder's shape: P_hi . V alone
    q, k, v = enc
    kw = dict(causal=False, scale=WHD ** -0.5)
    out = fa_ops.flash_attention(q, k, v, probs_bf16=True, **kw)
    (units, share, worst), (c_units, c_share, _) = probs_bf16_excess(
        torch, fa_ref, [out, fa_ops.flash_attention(q, k, v, **kw)], q, k,
        v, kw)
    ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, probs_bf16=True,
                                                **kw), 20)
    print(f"[b] whisper encoder bf16 probs_bf16=True vs the plain version "
          f"with the flag at the kernel's 64-key tiles: beyond one bf16 "
          f"rounding of its fp32 result {worst:.3e}, beyond BF16_ATOL "
          f"{share:.3e} of the elements (tol {PROBS_BF16_FLIP_SHARE:g}), "
          f"the worst {units:.3f} of its row's flip unit (tol 1); the "
          f"kernel without the flag {c_share:.3e} and {c_units:.3f} (must "
          f"fail); kernel_ms={ms:.4f} (without {row['ms']:.4f})")
    ok = units <= 1 and share <= PROBS_BF16_FLIP_SHARE
    if not ok or (c_units <= 1 and c_share <= PROBS_BF16_FLIP_SHARE):
        raise SystemExit("flash_attention with probs_bf16 disagrees with "
                         "its plain version, or the check cannot tell the "
                         "flag's absence")
    row["probs_bf16"] = {"bf16_excess": worst, "flip_units": units,
                         "share_beyond_atol": share,
                         "without_flag_share": c_share, "ms": ms}
    del q, k, v, enc, out

    # not causal with a window: query s sees t in (s - 200, 100), so rows
    # s >= 299 see no key and give zeros
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, WHS, WHQ, WHD), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((1, 100, WHG, WHD), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        kw = dict(causal=False, window=200, scale=WHD ** -0.5)
        out = fa_ops.flash_attention(q, k, v, **kw)
        plain32 = fa_ref.flash_attention_blockwise(q.float(), k.float(),
                                                   v.float(), **kw)
        zero = bool((out[:, 299:] == 0).all())
        err = (bf16_excess(out, plain32) if dtype == torch.bfloat16 else
               float((out - plain32).abs().max()))
        tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_TOL
        print(f"[b] whisper rows without a key ({dtype}, not causal, window "
              f"200, 100 keys): rows 299.. all zero: {zero}; the rest "
              f"{err:.3e} (tol {tol:.0e})")
        if not zero or err > tol:
            raise SystemExit("flash_attention: a row without an allowed key "
                             "is not zero, or the others disagree")
    row["phase_s"] = time.perf_counter() - t_phase
    print(f"[b] whisper-base's and the training flash shapes: "
          f"{row['phase_s']:.1f}s")
    return row, mla


def flash_grad_fp64(torch, name, fa_ops, fa_ref, ins, g, kw):
    """grad_check of the flash op against its plain version's fp32
    autograd, then the op's gradients (fp32) against the plain version's
    autograd in fp64 on the same inputs, within GRAD_TOL of max(1, max
    |fp64 grad|) each (ROADMAP.md Queue 3: fp32 autograd is not an exact
    reference).  Returns the worst errors and the backward's ms."""
    err32, ms = grad_check(
        torch, name, lambda *a: fa_ops.flash_attention(*a, **kw),
        lambda *a: fa_ref.flash_attention_blockwise(*a, **kw), ins, g,
        FP32_TOL)
    a = [t.clone().requires_grad_() for t in ins]
    ga = torch.autograd.grad(fa_ops.flash_attention(*a, **kw), a, g)
    d = [t.double().requires_grad_() for t in ins]
    gd = torch.autograd.grad(fa_ref.flash_attention_blockwise(*d, **kw), d,
                             g.double())
    errs = [float((x.double() - y).abs().max()) / max(1.0,
                                                      float(y.abs().max()))
            for x, y in zip(ga, gd)]
    print(f"[b] grad {name}: the op's fp32 gradients vs the plain version's "
          f"fp64 autograd, per input {[float(f'{e:.3e}') for e in errs]} "
          f"(tol {GRAD_TOL:.0e}) {'ok' if max(errs) <= GRAD_TOL else 'FAIL'}")
    if max(errs) > GRAD_TOL:
        raise SystemExit(f"{name}: gradients off fp64 by {errs}")
    return {"grad_err_fp32": err32, "grad_err_fp64": max(errs), "bwd_ms": ms}


def sdpa_yardstick(torch, q, k, v, out, scale, what):
    """The one PyTorch call that computes causal attention (no window, no
    softcap) on q (B,S,Hq,hd), k (B,T,G,hd), v (B,T,G,hd_v): SDPA with
    enable_gqa, or, if it refuses the shape, torch.compile(flex_attention)
    with a causal block mask.  Prints and returns its ms and its name; the
    port never calls it."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    call = functools.partial(
        torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
        is_causal=True, scale=scale, enable_gqa=k.shape[2] != q.shape[2])
    lib = "scaled_dot_product_attention"
    try:
        ref_out = call()
    except RuntimeError as e:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        print(f"[b] {what}: SDPA refuses the shape ({e}); timing "
              f"torch.compile(flex_attention) instead")
        mask = create_block_mask(lambda b, h, qi, ki: qi >= ki, None, None,
                                 q.shape[1], k.shape[1], device="cuda")
        call = functools.partial(torch.compile(flex_attention), qt, kt, vt,
                                 block_mask=mask, scale=scale,
                                 enable_gqa=k.shape[2] != q.shape[2])
        lib = "torch.compile(flex_attention)"
        ref_out = call()
    err = float((ref_out.transpose(1, 2).float() - out.float()).abs().max())
    lib_ms = cuda_ms(call, 5)
    print(f"[b] {what} shape: {lib} ms={lib_ms:.4f} max_abs_err vs it="
          f"{err:.3e}")
    return lib_ms, lib


def front_door_checks(res, name: str) -> list:
    """What every serve through the front door holds: `launch.serve` raised
    unless every request was answered ok; the batches are the ones the
    frontend formed (they cover every request, in order); the backend ran
    each batch once: completed == created == batches, no errors and no
    requeue (a requeue would run a batch twice).  Prints the batches, the
    backend's stats and the trace's latency p50/p95/p99; returns those."""
    nb, st = len(res["batches"]), res["backend_stats"]
    pct = res["latency_pct_ms"]
    print(f"[c] {name} through Client.serve: batches the frontend formed "
          f"{res['batches']}; backend {st}; latency ms from the trace "
          f"p50={pct[0]:.1f} p95={pct[1]:.1f} p99={pct[2]:.1f}")
    if sum(res["batches"]) != len(res["replies"]) \
            or st["completed"] != st["created"] or st["created"] != nb \
            or st["errors"] or st["requeued"]:
        raise SystemExit(f"{name}: the front door ran {st} for batches "
                         f"{res['batches']}")
    return pct


def serve_batch(torch, cfg, toks):
    """The batch `launch.serve` makes of prompts `toks`: for an M-RoPE model
    also the text positions on all 3 streams; for an audio model zero bf16
    encoder frames."""
    batch = {"tokens": toks}
    if cfg.mrope:
        b, s = toks.shape
        batch["mrope_positions"] = torch.arange(
            s, device=toks.device).expand(3, b, s)
    if cfg.family == "audio":
        batch["encoder_frames"] = torch.zeros(
            (toks.shape[0], cfg.encoder.n_frames, cfg.d_model),
            dtype=torch.bfloat16, device=toks.device)
    return batch


def served_logits(torch, res, vocab):
    """The kernel path's bf16 last-position prefill logits of the served
    prompts in the batches the frontend formed them into: the composition
    each reply's first token came from."""
    model, params, out, i = res["model"], res["params"], [], 0
    with torch.inference_mode():
        for n in res["batches"]:
            toks = torch.as_tensor(np.stack(res["prompts"][i:i + n]),
                                   device="cuda").long()
            out.append(model.forward(params, serve_batch(torch, model.cfg,
                                                         toks),
                                     mode="prefill")[0][:, :vocab].float())
            i += n
    return torch.cat(out)


# a Prometheus text-format 0.0.4 sample line: name{label="v",...} value
PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})? '
    r'(-?\d+(\.\d+)?([eE][+-]?\d+)?|[+-]Inf|NaN)$')
# the "engine" keys of /stats, as the JAX package's StatsServer.stats()
# (src/repro/core/obs/server.py) builds them for an in-process engine
STATS_ENGINE_KEYS = {"live_workers", "worker_deaths", "tasks_done",
                     "tasks_failed", "tasks_retried", "journal_bytes",
                     "ready_depth", "shard_ready_depth", "trace", "xfer"}
SCRAPE_EVERY_S = 0.25
TRACE_OUT = ROOT / "build" / "chip_trace" / "gemma2.trace.json"


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def scrape_stats(url, stop, rounds, errors):
    """Thread body: GET /health, /stats and /metrics every SCRAPE_EVERY_S
    until `stop` is set, each round appended to `rounds` as (seconds, {path:
    body}); the first failure ends the thread and lands in `errors`, for
    the caller to raise."""
    import urllib.request
    try:
        while not stop.is_set():
            got = {}
            for ep in ("/health", "/stats", "/metrics"):
                with urllib.request.urlopen(url + ep, timeout=30) as r:
                    got[ep] = r.read().decode()
            rounds.append((time.perf_counter(), got))
            stop.wait(SCRAPE_EVERY_S)
    except BaseException as e:  # noqa: BLE001 - raised by the caller
        errors.append(e)


def observed_serve(serve, argv):
    """`serve.main(argv + --stats-port P --trace-out TRACE_OUT)` with a
    thread scraping the live stats server from the moment `serve.main`
    starts it until `serve.main` closes its client (held up to 60 s until
    3 rounds have run).  Raises the first failed scrape.  Returns
    (`serve.main`'s result, the scrape rounds)."""
    import threading
    from repro_torch.client import Client
    stop, rounds, errors, threads = threading.Event(), [], [], []
    real_stats_server, real_close = Client.stats_server, Client.close

    def stats_server(self, *args, **kw):
        srv = real_stats_server(self, *args, **kw)
        t = threading.Thread(target=scrape_stats, name="chip-smoke-scraper",
                             args=(srv.url, stop, rounds, errors),
                             daemon=True)
        t.start()
        threads.append(t)
        return srv

    def close(self, *args, **kw):
        t_end = time.monotonic() + 60.0
        while len(rounds) < 3 and not errors and threads \
                and time.monotonic() < t_end:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join()
        return real_close(self, *args, **kw)

    if TRACE_OUT.exists():
        TRACE_OUT.unlink()
    TRACE_OUT.parent.mkdir(parents=True, exist_ok=True)
    argv = argv + ["--stats-port", str(free_port()),
                   "--trace-out", str(TRACE_OUT)]
    with mock.patch.object(Client, "stats_server", stats_server), \
            mock.patch.object(Client, "close", close):
        res = serve.main(argv)
    stop.set()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if not threads:
        raise SystemExit("serve.main started no stats server")
    return res, rounds


def check_observability(res, rounds, name: str) -> dict:
    """What the served run's observability holds: at least 3 scrape rounds,
    /health ok in each, /metrics Prometheus text with a
    repro_tasks_completed_total that never decreases, /stats with the
    reference's engine keys; the Chrome trace at TRACE_OUT loads, with one
    task span a batch the frontend formed and one request span a request;
    the critical path names every batch and its attribution (scheduler +
    run) sums to its makespan within 5 %.  One worker runs the batches one
    after another, so the path's edges are that order: each batch waits on
    the batch the worker ran before it.  Prints the scrapes, the trace's
    spans and the path's makespan with its compute and scheduler shares;
    returns them."""
    from repro_torch.core.engine import BATCH_FORMED, RUN_START
    if len(rounds) < 3:
        raise SystemExit(f"{name}: {len(rounds)} scrape rounds, want >= 3")
    completed = []
    for _t, got in rounds:
        health = json.loads(got["/health"])
        if health.get("ok") is not True:
            raise SystemExit(f"{name}: /health answered {health}")
        value = None
        for line in got["/metrics"].splitlines():
            if not line or line.startswith("#"):
                continue
            if not PROM_SAMPLE.match(line):
                raise SystemExit(f"{name}: /metrics line {line!r} is not "
                                 f"Prometheus text")
            if line.startswith("repro_tasks_completed_total "):
                value = float(line.split()[1])
        if value is None:
            raise SystemExit(f"{name}: /metrics has no "
                             f"repro_tasks_completed_total")
        completed.append(value)
        engine = json.loads(got["/stats"]).get("engine", {})
        if set(engine) != STATS_ENGINE_KEYS:
            raise SystemExit(f"{name}: /stats engine keys {sorted(engine)}, "
                             f"want {sorted(STATS_ENGINE_KEYS)}")
    if any(b < a for a, b in zip(completed, completed[1:])):
        raise SystemExit(f"{name}: repro_tasks_completed_total went "
                         f"down: {completed}")
    span_s = rounds[-1][0] - rounds[0][0]
    print(f"[c] {name} live stats: {len(rounds)} scrape rounds of /health, "
          f"/stats, /metrics over {span_s:.1f}s, every one ok; "
          f"repro_tasks_completed_total {completed[0]:.0f} -> "
          f"{completed[-1]:.0f}; /stats engine keys = the reference's")

    doc = json.loads(TRACE_OUT.read_text())
    evs = doc["traceEvents"]
    tasks = [e for e in evs if e["ph"] == "X" and e.get("cat") == "task"]
    begins = [e for e in evs if e["ph"] == "b" and e.get("cat") == "request"]
    print(f"[c] {name} Chrome trace {TRACE_OUT.relative_to(ROOT)}: "
          f"{len(evs)} events, {len(tasks)} task spans, {len(begins)} "
          f"request spans")
    if len(tasks) != len(res["batches"]) \
            or len(begins) != len(res["replies"]):
        raise SystemExit(f"{name}: the trace has {len(tasks)} task spans "
                         f"and {len(begins)} request spans for "
                         f"{len(res['batches'])} batches and "
                         f"{len(res['replies'])} requests")

    trace = res["trace"]
    batches = [e.task for e in trace.events if e.event == BATCH_FORMED]
    order = [e.task for e in trace.events if e.event == RUN_START]
    cp = trace.report(workers=1).explain(
        deps={b: (a,) for a, b in zip(order, order[1:])})
    total = cp.sched_s + cp.run_s
    share = {"compute": cp.compute_s / cp.makespan_s,
             "scheduler": cp.sched_s / cp.makespan_s}
    print(f"[c] {name} critical path {cp.path}: makespan "
          f"{cp.makespan_s * 1e3:.3f} ms, compute {cp.compute_s * 1e3:.3f} "
          f"ms ({share['compute']:.6f}), scheduler {cp.sched_s * 1e3:.3f} ms "
          f"({share['scheduler']:.6f}: dep_wait {cp.dep_wait_s * 1e3:.3f}, "
          f"queue {cp.queue_s * 1e3:.3f}, dispatch "
          f"{cp.dispatch_s * 1e3:.3f}, notify {cp.notify_s * 1e3:.3f}); "
          f"attribution sums to {total / cp.makespan_s:.6f} of the makespan")
    if sorted(cp.path) != sorted(batches) or not batches:
        raise SystemExit(f"{name}: critical path {cp.path}, batches "
                         f"{batches}")
    if abs(total - cp.makespan_s) > 0.05 * cp.makespan_s:
        raise SystemExit(f"{name}: attribution {total} vs makespan "
                         f"{cp.makespan_s}")
    return {"scrapes": len(rounds), "trace_events": len(evs),
            "makespan_ms": cp.makespan_s * 1e3,
            "compute_share": share["compute"],
            "scheduler_share": share["scheduler"],
            "sched_ms": {k: getattr(cp, f"{k}_s") * 1e3 for k in (
                "dep_wait", "queue", "dispatch", "notify")}}


def phase_serve(torch, fa_ops, attention, fa_ref, serve):
    """The main path at full width with its live stats server scraped and
    its Chrome trace written (`check_observability`), then kernel-path vs
    plain-path logits."""
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    res, rounds = observed_serve(serve, ARGV)
    wall = time.perf_counter() - t0
    launches = fa_ops.flash_attention.launches
    model, params = res["model"], res["params"]
    cfg = model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (26, 2304, 256000)
    print(f"[c] served {len(res['replies'])} requests in {wall:.1f}s "
          f"(weights included); prefill_ms={res['prefill_s'] * 1e3:.1f} "
          f"decode_ms_per_token="
          f"{res['decode_s'] * 1e3 / res['decode_steps']:.2f} "
          f"max_memory_allocated_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    want = cfg.n_layers * len(res["batches"])
    print(f"[c] flash_attention launches={launches} "
          f"(want {cfg.n_layers} layers x {len(res['batches'])} batches)")
    if launches != want:
        raise SystemExit(f"kernel launched {launches} times, want {want}")
    front_door_checks(res, "gemma2-2b")
    obs = check_observability(res, rounds, "gemma2-2b")
    if len(res["replies"]) != 4:
        raise SystemExit("not every request was answered")
    for row in res["replies"]:
        if row.shape != (16,) or row.min() < 0 or row.max() >= cfg.vocab_size:
            raise SystemExit(f"bad reply {row}")

    toks = torch.as_tensor(np.stack(res["prompts"]), device="cuda").long()
    with torch.inference_mode():
        lg_kernel, _ = model.forward(params, {"tokens": toks}, mode="prefill")
        n = fa_ops.flash_attention.launches
        with mock.patch.object(attention, "flash_attention",
                               fa_ref.flash_attention_blockwise):
            lg_plain, _ = model.with_opts(q_block=1024, kv_block=1024) \
                .forward(params, {"tokens": toks}, mode="prefill")
        if fa_ops.flash_attention.launches != n:
            raise SystemExit("the plain path launched the kernel")
    V = cfg.vocab_size
    a, b = lg_kernel[:, :V].float(), lg_plain[:, :V].float()
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise SystemExit("non-finite prefill logits")
    err = float((a - b).abs().max())
    top = b.topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    sure = margin > LOGIT_TOL
    same = (a.argmax(-1) == b.argmax(-1)) | ~sure
    # the served first tokens: the argmax of the prefill in the batches
    # they were served in, where its top-2 margin exceeds LOGIT_TOL
    a_served = served_logits(torch, res, V)
    served = torch.as_tensor([r[0] for r in res["replies"]], device="cuda")
    same_served = (served == a_served.argmax(-1)) \
        | (top2_margin(a_served) <= LOGIT_TOL)
    print(f"[c] prefill last-position logits, kernel vs plain path: "
          f"max_abs_err={err:.4f} (tol {LOGIT_TOL}); |logit|max="
          f"{float(b.abs().max()):.3f}; top-2 margins="
          f"{[round(float(m), 4) for m in margin]}; first tokens compared "
          f"where margin > tol: {int(sure.sum())}/{len(sure)}")
    if err >= LOGIT_TOL or not bool(same.all()) or not bool(same_served.all()):
        raise SystemExit("kernel path and plain path disagree")
    obs["analysis"] = serve_analysis(torch, fa_ops, res)
    return launches, launches // len(res["batches"]), obs


def _meta_like(torch, tree):
    from repro_torch.models.common import tree_map
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def serve_analysis(torch, fa_ops, res):
    """One served prefill batch (the first prompt, 1 x prompt length, into
    the cache `launch.serve` gives it) on the card under
    `launch.hlo_analysis.analyze`: the flash kernel launched once a layer
    inside it, and its FLOPs and HBM bytes equal exactly the same call
    counted on meta tensors (both counts come from shapes).  Prints the
    roofline's compute and memory terms over the H100 data-sheet constants
    beside the measured prefill ms (CUDA events) and their ratio."""
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.runtime.serve_step import make_prefill_step
    t0 = time.perf_counter()
    model, params = res["model"], res["params"]
    cfg = model.cfg
    toks = torch.as_tensor(np.stack(res["prompts"][:1]), device="cuda").long()
    S = toks.shape[1]
    cache_len = S + 16 + 1              # ARGV's --max-new 16, as serve sizes it
    step = make_prefill_step(model)

    def one(p, batch, dev):
        return step(p, batch, model.init_cache(1, cache_len, device=dev))

    batch = serve_batch(torch, cfg, toks)
    with torch.inference_mode():
        n0 = fa_ops.flash_attention.launches
        card = hlo_analysis.analyze(one, params, batch, "cuda")
        launched = fa_ops.flash_attention.launches - n0
        meta = hlo_analysis.analyze(one, _meta_like(torch, params),
                                    _meta_like(torch, batch), "meta")
        ms = cuda_ms(lambda: one(params, batch, "cuda"), 3)
    compute_s = card["flops"] / PEAK_FLOPS_BF16
    memory_s = card["hbm_bytes"] / HBM_BW
    secs = time.perf_counter() - t0
    same = (card["flops"], card["hbm_bytes"]) == (meta["flops"],
                                                   meta["hbm_bytes"])
    print(f"[c] gemma2-2b served prefill 1 x {S} under hlo_analysis on "
          f"{card_line()}: flash_attention launches={launched} (want "
          f"{cfg.n_layers}); flops={card['flops']:.6e} hbm_bytes="
          f"{card['hbm_bytes']:.6e} (meta count: flops={meta['flops']:.6e} "
          f"hbm_bytes={meta['hbm_bytes']:.6e}; equal={same}); kernel ops "
          f"{card['kernels']}; compute_s={compute_s:.6e} memory_s="
          f"{memory_s:.6e} (H100 SXM data-sheet rates) vs measured "
          f"prefill_ms={ms:.3f}: ratio max(terms)/measured="
          f"{max(compute_s, memory_s) * 1e3 / ms:.4f}; phase {secs:.1f}s")
    if launched != cfg.n_layers:
        raise SystemExit(f"the analysed prefill launched the kernel "
                         f"{launched} times, want {cfg.n_layers}")
    if not same:
        raise SystemExit("the card's count differs from the meta count")
    return {"flops": card["flops"], "hbm_bytes": card["hbm_bytes"],
            "compute_s": compute_s, "memory_s": memory_s, "prefill_ms": ms,
            "launches": launched, "seconds": secs}


def wkv6_rechunked(fn, q, *args, chunk, initial_state=None):
    """`fn` in chunks of q steps in place of `chunk`."""
    return fn(*args, chunk=q, initial_state=initial_state)


def top2_margin(logits):
    top = logits.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def phase_serve_rwkv(torch, wkv_ops, rwkv, wkv_ref, serve):
    """The rwkv6 path at full width, then kernel-path vs plain-path prefill
    logits and states, with the kernel path's prefills timed."""
    torch.cuda.reset_peak_memory_stats()
    wkv_ops.wkv6.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", "rwkv6-1.6b", *ARGV])
    wall = time.perf_counter() - t0
    launches = wkv_ops.wkv6.launches
    model, params = res["model"], res["params"]
    cfg = model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (24, 2048, 65536)
    p50, p95, p99 = front_door_checks(res, "rwkv6-1.6b")
    print(f"[c] rwkv6-1.6b served {len(res['replies'])} requests in "
          f"{wall:.1f}s (weights included); prefill_ms="
          f"{res['prefill_s'] * 1e3:.1f} decode_ms_per_token="
          f"{res['decode_s'] * 1e3 / res['decode_steps']:.2f} latency_ms "
          f"p50={p50:.1f} p95={p95:.1f} p99={p99:.1f} "
          f"max_memory_allocated_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    want = cfg.n_layers * len(res["batches"])
    print(f"[c] wkv6 launches={launches} op calls, "
          f"{launches * len(WKV_INSTANCES)} kernel launches "
          f"({len(WKV_INSTANCES)} stages a call) (want {cfg.n_layers} layers "
          f"x {len(res['batches'])} batches)")
    if launches != want:
        raise SystemExit(f"wkv6 kernel launched {launches} times, want {want}")
    if len(res["replies"]) != 4:
        raise SystemExit("not every request was answered")
    for row in res["replies"]:
        if row.shape != (16,) or row.min() < 0 or row.max() >= cfg.vocab_size:
            raise SystemExit(f"bad reply {row}")

    toks = torch.as_tensor(np.stack(res["prompts"]), device="cuda").long()
    V = cfg.vocab_size
    results, prefill_ms = {}, {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            # the kernel path's prefill after the served one, timed on the
            # host clock around a synchronised forward
            prefill_ms[dtype] = []
            for _ in range(PREFILL_REPS):
                lg_kernel = st_kernel = None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg_kernel, st_kernel = model.forward(
                    params, {"tokens": toks}, mode="prefill", dtype=dtype)
                torch.cuda.synchronize()
                prefill_ms[dtype].append((time.perf_counter() - t0) * 1e3)
            n = wkv_ops.wkv6.launches
            with mock.patch.object(rwkv, "wkv6", wkv_ref.wkv6_chunked):
                lg_plain, st_plain = model.forward(
                    params, {"tokens": toks}, mode="prefill", dtype=dtype)
            if wkv_ops.wkv6.launches != n:
                raise SystemExit("the plain path launched the kernel")
            a, b = lg_kernel[:, :V].float(), lg_plain[:, :V].float()
            if not (bool(torch.isfinite(a).all())
                    and bool(torch.isfinite(b).all())):
                raise SystemExit("non-finite prefill logits")
            rel = [float((sk - sp).abs().max() / sp.abs().max().clamp(min=1.0))
                   for sk, sp in zip(st_kernel["S"], st_plain["S"])]
            results[dtype] = (a, b, rel)
            del lg_kernel, st_kernel, lg_plain, st_plain
        # yardstick for the bf16 figures: the plain path against itself with
        # chunks of 32, the same function summed in another order
        with mock.patch.object(rwkv, "wkv6", functools.partial(
                wkv6_rechunked, wkv_ref.wkv6_chunked, 32)):
            lg32, _ = model.forward(params, {"tokens": toks}, mode="prefill")
        err32 = float((lg32[:, :V].float() - results[torch.bfloat16][1])
                      .abs().max())
        print(f"[c] rwkv6 prefill in bfloat16, plain path at chunk 32 vs "
              f"{cfg.rwkv.chunk}: last-position logits max_abs_err="
              f"{err32:.4f}")
    print("[c] rwkv6 prefill forwards after the served one, kernel path, "
          "ms: " + "; ".join(f"{str(dtype)[6:]} {[round(t, 1) for t in ts]}"
                             for dtype, ts in prefill_ms.items()))
    for dtype, (a, b, rel) in results.items():
        print(f"[c] rwkv6 prefill in {str(dtype)[6:]}, kernel vs plain path: "
              f"last-position logits max_abs_err="
              f"{float((a - b).abs().max()):.4f}; |logit|max="
              f"{float(b.abs().max()):.3f}; top-2 margins="
              f"{[round(float(m), 4) for m in top2_margin(b)]}; S per layer "
              f"max|diff|/max(1, max|S|): {[float(f'{x:.3e}') for x in rel]}")
    # the served first tokens are the bf16 kernel path's argmax, in the
    # batches they were served in
    a = served_logits(torch, res, V)
    served = torch.as_tensor([r[0] for r in res["replies"]], device="cuda")
    if not bool(((served == a.argmax(-1)) | (top2_margin(a) <= LOGIT_TOL))
                .all()):
        raise SystemExit("rwkv6: served first tokens are not the prefill's")
    a, b, rel = results[torch.float32]
    err, sure = float((a - b).abs().max()), top2_margin(b) > LOGIT_TOL
    same = (a.argmax(-1) == b.argmax(-1)) | ~sure
    print(f"[c] rwkv6 fp32 check: logits max_abs_err={err:.3e} (tol "
          f"{LOGIT_TOL}); first tokens compared where margin > tol: "
          f"{int(sure.sum())}/{len(sure)}; S layer 0 {rel[0]:.3e} (tol "
          f"{WKV_TOL:.0e}), all layers max {max(rel):.3e} (tol "
          f"{STATE_TOL:.0e})")
    if err >= LOGIT_TOL or not bool(same.all()):
        raise SystemExit("rwkv6: kernel path and plain path disagree")
    if rel[0] > WKV_TOL or max(rel) > STATE_TOL:
        raise SystemExit("rwkv6: kernel-path and plain-path states disagree")
    return launches, launches // len(res["batches"])


class RouteLog:
    """Stands in for `models.moe.route`: calls it and keeps each call's
    `Routing` (one a MoE layer and forward)."""

    def __init__(self, moe):
        self.route, self.calls = moe.route, []

    def __call__(self, router, xg, cfg):
        r = self.route(router, xg, cfg)
        self.calls.append(r)
        return r


class RoutePin(RouteLog):
    """Stands in for `models.moe.route` on the plain path: records the
    path's own routing, and returns the experts, slots and drops another
    path chose (`pinned`, its `Routing`s in call order), with the gates
    renormalised from this path's own router probabilities at those
    experts.  Where the choices agree this is `route`'s result itself."""

    def __init__(self, moe, pinned):
        super().__init__(moe)
        self.pinned = list(pinned)

    def __call__(self, router, xg, cfg):
        import torch
        own = super().__call__(router, xg, cfg)
        ref = self.pinned[len(self.calls) - 1]
        G, g, _ = xg.shape
        k = cfg.moe.top_k
        probs = torch.softmax(xg.float() @ router.float(), dim=-1)
        vals = probs.gather(-1, ref.idx.reshape(G, k, g).transpose(1, 2))
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        return own._replace(idx=ref.idx, slot=ref.slot, keep=ref.keep,
                            gate=vals.transpose(1, 2).reshape(G, k * g))


def phase_serve_model(torch, fa_ops, attention, fa_ref, moe, serve, arch,
                      dims, n_params, argv=None, per_batch=None, depth=None,
                      prefix=None):
    """`arch` (deepseek-7b, deepseek-v2-lite-16b, qwen2-vl-2b, whisper-base;
    at a cut `depth`, LARGE_SERVES) at full width, and at full depth unless
    `depth` names one, through `launch.serve` and `Client.serve` (`argv`,
    by default ARGV: four batches of 1; the depth set by patching
    `serve.get_config`, as `launch.serve` has no flag for it): the front
    door's checks,
    `dims` (layers, d_model, heads, KV heads, head dim, vocab) and the
    parameter count, the flash kernel launched `per_batch` times a prefill
    batch (by default once a layer), 4 replies of 16 in-vocab tokens.
    Then the first served batch's prefill on the kernel path and the plain
    path (the params read through an fp32 cast), in fp32 and bf16
    (printed), on its first `prefix` tokens where `prefix` is given; an
    audio model's on seeded random frames (the serve gave it zeros).  A MoE
    model's router may pick another expert on the two paths where a token
    sits near a top-k tie (they sum attention in other orders): each
    layer's choices are recorded, the last position's printed per layer on
    both paths with the count of layers where they differ, and the count of
    (layer, token) pairs whose expert sets differ over the prompt.  The
    fp32 logits are held within DS_FP32_LOGIT_TOL (and the argmax where the
    top-2 margin exceeds twice that, which must hold for at least one
    token) only where no choice differs: as they are if none does (a model
    without experts), else against the plain path rerun with its routing
    pinned to the kernel path's choices (`RoutePin`), the unpinned error
    printed beside it.  The
    served first tokens are the bf16 kernel path's argmax over the whole
    prompts.  Prints prefill ms, decode ms a token beside its bound (the
    bytes a decode step needs, `decode_step_bytes`, at the HBM rate; and
    beside that the served tree's bytes at that rate), p50/p95/p99, the peak
    memory (held under 80 GB; the init's and the serve's apart) and, for a
    MoE model, the choices dropped over the served prefills (every token's
    k choices in every MoE layer counted), and the phase's seconds with the
    path checks' peak memory (also held under 80 GB) and what the phase's
    peak leaves free of 80 GB."""
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = 0
    init, marks = serve.init_serving_params, {}

    def init_then_mark(*args, **kwargs):
        """The init's peak, then the count restarted for the serve's."""
        out = init(*args, **kwargs)
        marks["init"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return out

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(serve, "init_serving_params",
                                              init_then_mark))
        if depth is not None:
            full = serve.get_config
            stack.enter_context(mock.patch.object(
                serve, "get_config",
                lambda a: full(a).replace(n_layers=depth)))
        res = serve.main(argv or ["--arch", arch, *ARGV])
    wall = time.perf_counter() - t0
    launches = fa_ops.flash_attention.launches
    serve_peak = torch.cuda.max_memory_allocated()
    peak = max(marks["init"], serve_peak)
    model, params = res["model"], res["params"]
    cfg = model.cfg
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.vocab_size)
    n = sum(t.numel() for _, t in leaf_items(params))
    if got != dims or n != n_params:
        raise SystemExit(f"{arch}: served {got} with {n:,} parameters, "
                         f"want {dims} with {n_params:,}")
    p50, p95, p99 = front_door_checks(res, arch)
    served_bytes = sum(t.numel() * t.element_size()
                       for _, t in leaf_items(params))
    served_ms = served_bytes / H100_BYTES_S * 1e3
    B = len(res["prompts"]) // len(res["batches"])
    steps = res["decode_steps"] // len(res["batches"])
    need, cache_need = decode_step_bytes(
        model, params, B, len(res["prompts"][0]) + (steps + 1) / 2)
    decode_bound_ms = need / H100_BYTES_S * 1e3
    print(f"[c] {arch} served {len(res['replies'])} requests in {wall:.1f}s "
          f"(weights included: {n:,} parameters, {cfg.n_layers} layers"
          f"{' of ' + str(full(arch).n_layers) if depth is not None else ''}"
          f"); prefill_ms={res['prefill_s'] * 1e3:.1f} decode_ms_per_token="
          f"{res['decode_s'] * 1e3 / res['decode_steps']:.2f} (bound "
          f"{decode_bound_ms:.3f}: the {need / 1e9:.3f} GB a step of a batch "
          f"of {B} needs, the cache's {cache_need / 1e9:.3f} GB among them; "
          f"the served tree read once, as the padded MoE dispatch reads "
          f"its experts: {served_bytes / 1e9:.2f} GB, {served_ms:.2f} ms) "
          f"latency_ms "
          f"p50={p50:.1f} p95={p95:.1f} p99={p99:.1f} "
          f"max_memory_allocated_GB={peak / 1e9:.2f} (the init's "
          f"{marks['init'] / 1e9:.2f}, the serve's {serve_peak / 1e9:.2f} "
          f"with the served tree's {served_bytes / 1e9:.2f} in it)")
    per_batch = per_batch or cfg.n_layers
    want = per_batch * len(res["batches"])
    print(f"[c] {arch} flash_attention launches={launches} (want "
          f"{per_batch} a prefill x {len(res['batches'])} batches)")
    if launches != want:
        raise SystemExit(f"{arch}: flash launched {launches} times, want "
                         f"{want}")
    if peak >= 80e9:
        raise SystemExit(f"{arch}: peak memory {peak / 1e9:.2f} GB")
    if len(res["replies"]) != 4:
        raise SystemExit(f"{arch}: not every request was answered")
    for row in res["replies"]:
        if row.shape != (16,) or row.min() < 0 or row.max() >= cfg.vocab_size:
            raise SystemExit(f"{arch}: bad reply {row}")
    V = cfg.vocab_size
    first = res["batches"][0]
    torch.cuda.reset_peak_memory_stats()          # the path checks' peak
    toks = torch.as_tensor(np.stack(res["prompts"][:first]),
                           device="cuda").long()[:, :prefix]
    batch = serve_batch(torch, cfg, toks)
    if cfg.family == "audio":
        batch["encoder_frames"] = torch.randn(
            (first, cfg.encoder.n_frames, cfg.d_model), device="cuda",
            generator=torch.Generator("cuda").manual_seed(30))
    logits, routes = {}, {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for path in ("kernel", "plain"):
                log = RouteLog(moe)
                before = fa_ops.flash_attention.launches
                with contextlib.ExitStack() as stack:
                    stack.enter_context(mock.patch.object(moe, "route", log))
                    m = model
                    if path == "plain":
                        stack.enter_context(mock.patch.object(
                            attention, "flash_attention",
                            fa_ref.flash_attention_blockwise))
                        m = model.with_opts(q_block=1024, kv_block=1024)
                    lg, _ = m.forward(params, batch, mode="prefill",
                                      dtype=dtype)
                grew = fa_ops.flash_attention.launches - before
                if grew != (per_batch if path == "kernel" else 0):
                    raise SystemExit(f"{arch}: the {path} path launched the "
                                     f"kernel {grew} times")
                logits[dtype, path] = lg[:, :V].float()
                routes[dtype, path] = log.calls
                del lg
    moe_keys = {}
    for dtype in (torch.float32, torch.bfloat16):
        ka, pa = routes[dtype, "kernel"], routes[dtype, "plain"]
        if not ka:
            continue
        last = [[r.idx.reshape(r.idx.shape[0], cfg.moe.top_k, -1)[-1, :, -1]
                 .tolist() for r in calls] for calls in (ka, pa)]
        sets = [[r.idx.reshape(r.idx.shape[0], cfg.moe.top_k, -1)
                 .transpose(1, 2).reshape(-1, cfg.moe.top_k).sort(-1).values
                 for r in calls] for calls in (ka, pa)]
        n_last = sum(sorted(a) != sorted(b) for a, b in zip(*last))
        n_pairs = sum(int((a != b).any(-1).sum()) for a, b in zip(*sets))
        name = "fp32" if dtype == torch.float32 else "bf16"
        print(f"[c] {arch} {name} prefill, the last position's experts per "
              f"MoE layer (choice order), kernel path: {last[0]}")
        print(f"[c] {arch} {name} prefill, plain path: {last[1]}")
        print(f"[c] {arch} {name} prefill: layers whose last-position "
              f"experts differ between the paths: {n_last} of {len(ka)}; "
              f"(layer, token) pairs whose expert sets differ: {n_pairs} of "
              f"{len(ka) * sets[0][0].shape[0]}")
        moe_keys[f"{name}_route_diff_layers_last"] = n_last
        moe_keys[f"{name}_route_diff_pairs"] = n_pairs
    a, b = logits[torch.float32, "kernel"], logits[torch.float32, "plain"]
    unpinned = ""
    if moe_keys.get("fp32_route_diff_pairs", 0):
        pin = RoutePin(moe, routes[torch.float32, "kernel"])
        with torch.inference_mode(), mock.patch.object(moe, "route", pin), \
                mock.patch.object(attention, "flash_attention",
                                  fa_ref.flash_attention_blockwise):
            lg, _ = model.with_opts(q_block=1024, kv_block=1024).forward(
                params, batch, mode="prefill", dtype=torch.float32)
        unpinned = (f"; the plain path unpinned (its own routing): "
                    f"max_abs_err={float((a - b).abs().max()):.3e}")
        moe_keys["fp32_logit_err_unpinned"] = float((a - b).abs().max())
        b = lg[:, :V].float()
        del lg, pin
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise SystemExit(f"{arch}: non-finite prefill logits")
    err = float((a - b).abs().max())
    sure = top2_margin(b) > 2 * DS_FP32_LOGIT_TOL
    same = (a.argmax(-1) == b.argmax(-1)) | ~sure
    a16 = logits[torch.bfloat16, "kernel"]
    b16 = logits[torch.bfloat16, "plain"]
    print(f"[c] {arch} prefill of the first served batch ({first} "
          f"prompt(s), {'the first ' if prefix else ''}{toks.shape[1]} "
          f"tokens{' of ' + str(len(res['prompts'][0])) if prefix else ''}),"
          f" kernel vs plain path"
          f"{' (its routing pinned to the kernel path' + chr(39) + 's)' if unpinned else ''}: "
          f"fp32 logits max_abs_err={err:.3e} (tol {DS_FP32_LOGIT_TOL})"
          f"{unpinned}, |logit|max={float(b.abs().max()):.3f}, top-2 margins="
          f"{[round(float(m), 4) for m in top2_margin(b)]}, first tokens "
          f"compared where margin > 2 x tol: {int(sure.sum())}/{len(sure)}; "
          f"bf16 max_abs_err={float((a16 - b16).abs().max()):.4f} (printed)")
    if err >= DS_FP32_LOGIT_TOL or not bool(same.all()) \
            or not bool(sure.any()):
        raise SystemExit(f"{arch}: kernel path and plain path disagree")
    del logits, routes
    # the served first tokens are the bf16 kernel path's argmax in the
    # batches they were served in; the same prefills count the dropped
    # choices
    log = RouteLog(moe)
    with mock.patch.object(moe, "route", log):
        a = served_logits(torch, res, V)
    served = torch.as_tensor([r[0] for r in res["replies"]], device="cuda")
    equal = int((served == a.argmax(-1)).sum())
    print(f"[c] {arch} served first tokens equal to the bf16 kernel-path "
          f"prefill's argmax: {equal}/{len(served)} (top-2 margin > "
          f"{LOGIT_TOL}: {int((top2_margin(a) > LOGIT_TOL).sum())})")
    if equal != len(served) or not len(served):
        raise SystemExit(f"{arch}: served first tokens are not the "
                         f"prefill's")
    if log.calls:
        dropped = sum(int((~r.keep).sum()) for r in log.calls)
        choices = sum(r.keep.numel() for r in log.calls)
        want = ((cfg.n_layers - cfg.moe.first_dense_layers)
                * len(res["prompts"]) * len(res["prompts"][0])
                * cfg.moe.top_k)
        if choices != want:
            raise SystemExit(f"{arch}: the served prefills routed {choices} "
                             f"choices, want {want}")
        r0 = log.calls[0]
        print(f"[c] {arch} MoE over the {len(res['batches'])} served "
              f"prefills: {len(log.calls)} routings of groups of "
              f"{r0.idx.shape[1] // cfg.moe.top_k} tokens, {r0.capacity} "
              f"slots an expert; choices dropped {dropped} of {choices}")
        moe_keys.update(dropped=dropped, choices=choices,
                        group=r0.idx.shape[1] // cfg.moe.top_k,
                        capacity=r0.capacity)
    phase_s = time.perf_counter() - t0
    check_peak = torch.cuda.max_memory_allocated()
    print(f"[c] {arch} serve phase: {phase_s:.1f}s; the path checks' "
          f"max_memory_allocated_GB={check_peak / 1e9:.2f}; the phase's peak "
          f"{max(peak, check_peak) / 1e9:.2f} GB leaves "
          f"{(80e9 - max(peak, check_peak)) / 1e9:.2f} of 80 free")
    if check_peak >= 80e9:
        raise SystemExit(f"{arch}: the path checks' peak memory "
                         f"{check_peak / 1e9:.2f} GB")
    return {"launches": launches,
            "launches_per_forward": launches // len(res["batches"]),
            "prefill_ms": res["prefill_s"] * 1e3,
            "decode_ms_per_token": res["decode_s"] * 1e3
            / res["decode_steps"],
            "decode_bound_ms": decode_bound_ms,
            "decode_served_tree_ms": served_ms,
            "latency_ms": [p50, p95, p99], "peak_gb": peak / 1e9,
            "init_peak_gb": marks["init"] / 1e9,
            "serve_peak_gb": serve_peak / 1e9,
            "check_peak_gb": check_peak / 1e9,
            "params": n, "n_layers": cfg.n_layers,
            "check_tokens": toks.shape[1], "fp32_logit_err": err,
            "serve_phase_s": phase_s, **moe_keys}


def zamba_cache_rel(a, b):
    """max|a - b| / max(1, max|b|) of two zamba2 caches: per layer for the
    SSM states and the conv rings, per shared-block application for the
    K/V caches (k and v, the larger)."""
    def rel(x, y):
        return float((x.float() - y.float()).abs().max()
                     / y.float().abs().max().clamp(min=1.0))
    out = {key: [rel(x, y) for x, y in zip(a["mamba"][key], b["mamba"][key])]
           for key in ("ssm", "conv")}
    out["kv"] = [max(rel(ka, kb), rel(va, vb)) for ka, kb, va, vb in zip(
        a["kv"][0], b["kv"][0], a["kv"][1], b["kv"][1])]
    return out


def zamba_cache_ok(rel) -> bool:
    """Layer 0's SSM state and conv ring within SSD_TOL (layer 0 runs the
    SSD on the same inputs on both sides); every layer's and every K/V
    application's within STATE_TOL (later layers carry the summation-order
    differences forward, as rwkv6's do)."""
    return (rel["ssm"][0] <= SSD_TOL and rel["conv"][0] <= SSD_TOL
            and max(rel["ssm"] + rel["conv"] + rel["kv"]) <= STATE_TOL)


def zamba_cache_line(rel) -> str:
    return "; ".join(
        f"{key} layer 0 {v[0]:.3e}, max {max(v):.3e} (at {v.index(max(v))})"
        for key, v in rel.items())


def phase_serve_zamba(torch, ssd_ops, fa_ops, attention, fa_ref, serve):
    """Full-width zamba2-2.7b served through `launch.serve` (the prefill
    through the SSD and flash kernels, decode carrying the state), then the
    kernel path's prefill against the plain path's (both ops patched to
    their plain versions) in bf16 and fp32, and in fp32 the chunked prefill
    of the first DECODE_CHECK_LEN tokens against token-by-token decode.
    Returns the SSD op calls and the flash launches of the served run, each
    with its count per prefill batch, and the served figures."""
    print(f"[c] zamba2-2.7b serve on {card_line()}")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ssd_ops.ssd.launches = fa_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", "zamba2-2.7b", *ARGV])
    wall = time.perf_counter() - t0
    n_ssd, n_fa = ssd_ops.ssd.launches, fa_ops.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    model, params = res["model"], res["params"]
    cfg = model.cfg
    if (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.n_heads,
            cfg.resolved_head_dim) != (54, 2560, 32000, 32, 80):
        raise SystemExit(f"not zamba2-2.7b at full width: {cfg}")
    n_app = cfg.n_layers // cfg.attn_every
    nb = len(res["batches"])
    p50, p95, p99 = front_door_checks(res, "zamba2-2.7b")
    figures = {"prefill_ms": res["prefill_s"] * 1e3,
               "decode_ms_per_token": res["decode_s"] * 1e3
               / res["decode_steps"],
               "latency_ms": [p50, p95, p99], "max_memory_allocated_GB":
               peak / 1e9}
    print(f"[c] zamba2-2.7b served {len(res['replies'])} requests in "
          f"{wall:.1f}s (weights included); prefill_ms="
          f"{figures['prefill_ms']:.1f} decode_ms_per_token="
          f"{figures['decode_ms_per_token']:.2f} latency_ms p50={p50:.1f} "
          f"p95={p95:.1f} p99={p99:.1f} max_memory_allocated_GB="
          f"{peak / 1e9:.2f}")
    print(f"[c] zamba2 serve: mamba2_ssd op calls={n_ssd} "
          f"({len(SSD_FWD_INSTANCES)} kernels each: "
          f"{n_ssd * len(SSD_FWD_INSTANCES)} launches), "
          f"flash_attention launches={n_fa} (want {cfg.n_layers} and "
          f"{n_app} a prefill batch x {nb} batches; decode launches neither)")
    if (n_ssd, n_fa) != (cfg.n_layers * nb, n_app * nb):
        raise SystemExit(f"zamba2 serve: {n_ssd} SSD op calls and {n_fa} "
                         f"flash launches over {nb} batches")
    if len(res["replies"]) != 4:
        raise SystemExit("not every request was answered")
    for row in res["replies"]:
        if row.shape != (16,) or row.min() < 0 or row.max() >= cfg.vocab_size:
            raise SystemExit(f"bad reply {row}")

    toks = torch.as_tensor(np.stack(res["prompts"]), device="cuda").long()
    V = cfg.vocab_size
    plain_model = model.with_opts(q_block=1024, kv_block=1024)
    results, prefill_ms = {}, {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            prefill_ms[dtype] = []
            for _ in range(PREFILL_REPS):
                lg_k = c_k = None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg_k, c_k = model.forward(params, {"tokens": toks},
                                          mode="prefill", dtype=dtype)
                torch.cuda.synchronize()
                prefill_ms[dtype].append((time.perf_counter() - t0) * 1e3)
            n = (ssd_ops.ssd.launches, fa_ops.flash_attention.launches)
            with mock.patch.object(ssd_ops, "ssd", ssd_ops.ssd_plain), \
                    mock.patch.object(attention, "flash_attention",
                                      fa_ref.flash_attention_blockwise):
                lg_p, c_p = plain_model.forward(params, {"tokens": toks},
                                                mode="prefill", dtype=dtype)
            if (ssd_ops.ssd.launches,
                    fa_ops.flash_attention.launches) != n:
                raise SystemExit("the plain path launched a kernel")
            a, b = lg_k[:, :V].float(), lg_p[:, :V].float()
            if not (bool(torch.isfinite(a).all())
                    and bool(torch.isfinite(b).all())):
                raise SystemExit("non-finite prefill logits")
            results[dtype] = (a, b, zamba_cache_rel(c_k, c_p))
            del lg_k, c_k, lg_p, c_p
            torch.cuda.empty_cache()
    print("[c] zamba2 prefill forwards after the served one, kernel path, "
          "ms: " + "; ".join(f"{str(dtype)[6:]} {[round(t, 1) for t in ts]}"
                             for dtype, ts in prefill_ms.items()))
    for dtype, (a, b, rel) in results.items():
        print(f"[c] zamba2 prefill in {str(dtype)[6:]}, kernel vs plain "
              f"path: last-position logits max_abs_err="
              f"{float((a - b).abs().max()):.4f}; |logit|max="
              f"{float(b.abs().max()):.3f}; top-2 margins="
              f"{[round(float(m), 4) for m in top2_margin(b)]}; "
              f"max|diff|/max(1, max|ref|): {zamba_cache_line(rel)}")
    # the served first tokens are the bf16 kernel path's argmax in the
    # batches they were served in: the same function on the same inputs
    # through the same kernels, so every token, not only those whose top-2
    # margin exceeds LOGIT_TOL
    a = served_logits(torch, res, V)
    served = torch.as_tensor([r[0] for r in res["replies"]], device="cuda")
    equal = int((served == a.argmax(-1)).sum())
    print(f"[c] zamba2 served first tokens equal to the bf16 kernel-path "
          f"prefill's argmax: {equal}/{len(served)} (top-2 margin > "
          f"{LOGIT_TOL}: {int((top2_margin(a) > LOGIT_TOL).sum())})")
    if equal != len(served):
        raise SystemExit("zamba2: served first tokens are not the prefill's")
    a, b, rel = results[torch.float32]
    err, sure = float((a - b).abs().max()), top2_margin(b) > LOGIT_TOL
    same = (a.argmax(-1) == b.argmax(-1)) | ~sure
    print(f"[c] zamba2 fp32 check, kernel vs plain path: logits max_abs_err="
          f"{err:.3e} (tol {LOGIT_TOL}); first tokens compared where margin "
          f"> tol: {int(sure.sum())}/{len(sure)}; states: layer 0 tol "
          f"{SSD_TOL:.0e}, every layer and K/V tol {STATE_TOL:.0e}")
    if err >= LOGIT_TOL or not bool(same.all()):
        raise SystemExit("zamba2: kernel path and plain path disagree")
    if not zamba_cache_ok(rel):
        raise SystemExit("zamba2: kernel-path and plain-path caches disagree")
    del results, a, b

    # where the device time goes: one bf16 prefill and one decode step
    # under the profiler, each beside the same work without it just before
    nreq, S = toks.shape
    with torch.inference_mode():
        cache = model.init_cache(nreq, S + 1, device="cuda")
        (lg, _), figures["prefill_profile"] = device_profile(
            torch, f"zamba2 prefill (bf16, {nreq} x {S})",
            lambda: model.forward(params, {"tokens": toks}, mode="prefill",
                                  cache=cache),
            float(np.median(prefill_ms[torch.bfloat16])))
        tok = lg[:, :V].argmax(-1)
        pos = torch.full((nreq,), S, device="cuda")

        def step():
            return model.decode_step(params, tok, pos, cache)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        _, figures["decode_profile"] = device_profile(
            torch, "zamba2 decode step (bf16)", step,
            (time.perf_counter() - t0) * 1e3 / 5)
        del cache, lg, tok

    # decode against the kernels' state: prefill T tokens at once, and
    # decode them one at a time, both from init_cache, in fp32
    T = DECODE_CHECK_LEN
    short = toks[:, :T]
    with torch.inference_mode():
        n = (ssd_ops.ssd.launches, fa_ops.flash_attention.launches)
        lg_p, c_p = model.forward(
            params, {"tokens": short}, mode="prefill", dtype=torch.float32,
            cache=model.init_cache(nreq, T, dtype=torch.float32,
                                   device="cuda"))
        if (ssd_ops.ssd.launches - n[0],
                fa_ops.flash_attention.launches - n[1]) != (cfg.n_layers,
                                                            n_app):
            raise SystemExit("zamba2: the short prefill did not run the "
                             "kernels")
        c_d = model.init_cache(nreq, T, dtype=torch.float32, device="cuda")
        n = (ssd_ops.ssd.launches, fa_ops.flash_attention.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            lg_d, c_d = model.decode_step(
                params, short[:, t], torch.full((nreq,), t, device="cuda"),
                c_d, dtype=torch.float32)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / T
        if (ssd_ops.ssd.launches, fa_ops.flash_attention.launches) != n:
            raise SystemExit("zamba2: decode launched a kernel")
    a, b = lg_p[:, :V].float(), lg_d[:, :V].float()
    rel = zamba_cache_rel(c_p, c_d)
    err, sure = float((a - b).abs().max()), top2_margin(b) > LOGIT_TOL
    same = (a.argmax(-1) == b.argmax(-1)) | ~sure
    print(f"[c] zamba2 fp32, chunked prefill (kernels) vs {T} decode steps "
          f"({step_ms:.1f} ms a step in fp32): logits max_abs_err={err:.3e} "
          f"(tol {LOGIT_TOL}); first tokens compared where margin > tol: "
          f"{int(sure.sum())}/{len(sure)}; max|diff|/max(1, max|decode|): "
          f"{zamba_cache_line(rel)}")
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise SystemExit("zamba2: non-finite logits in the decode check")
    if err >= LOGIT_TOL or not bool(same.all()) or not zamba_cache_ok(rel):
        raise SystemExit("zamba2: chunked prefill and token-by-token "
                         "decode disagree")
    print(f"[c] zamba2 serve phase took {time.perf_counter() - t_phase:.1f}s")
    return (n_ssd, n_ssd // nb), (n_fa, n_fa // nb), figures


def decode_step_bytes(model, params, batch, positions):
    """(bytes, of which the cache's) that one greedy decode step of `batch`
    sequences must read, each once: every served leaf, except the input
    embedding (its `batch` rows, where a head of its own gives the logits),
    the encoder (it ran at the prefill) and a MoE layer's routed experts
    (the at most batch x top_k of them the step picks: w1, w3 and w2 beside
    a router); and the cache over `positions` filled positions (a mean over
    the steps) with its parts of fixed length (an encoder's memory)."""
    cfg = model.cfg
    leaves = dict(leaf_items(params))
    n = 0
    for path, t in leaves.items():
        b = t.numel() * t.element_size()
        head, name = path.rsplit("/", 1)
        if path == "/embed" and "/head" in leaves:
            b = batch * t.shape[-1] * t.element_size()
        elif path.startswith("/enc/"):
            b = 0
        elif name in ("w1", "w2", "w3") and head + "/router" in leaves:
            E = cfg.moe.n_experts
            b = b * min(E, batch * cfg.moe.top_k) // E
        n += b
    one, two = (sum(t.numel() * t.element_size() for _, t in leaf_items(
        model.init_cache(batch, L, device="meta"))) for L in (1, 2))
    cache = (one - (two - one)) + (two - one) * positions
    return n + cache, cache


def leaf_items(tree, prefix=""):
    """(path, leaf) of a tree of dicts and tuples (a tuple's items keyed
    by their index)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_items(v, f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaf_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def phase_train_step(torch, arch, n_layers, patches, counters, want):
    """One fp32 train step's loss and gradients of `arch` at full width
    and `n_layers` of depth, kernel path vs plain path (each `patches`
    entry (module, attribute, plain version) swapped in), the same params
    and batch.  Every count of `counters` ({label: (function, attribute)})
    is set to 0 before the kernel path and held at `want` after it, and
    the plain path launches nothing."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.launch.train import to_device
    from repro_torch.models.common import Options, softmax_xent
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime.train_step import value_and_grad

    cfg = get_config(arch).replace(n_layers=n_layers)
    model = build_model(cfg, Options(q_block=512, kv_block=512))
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    batch = to_device(next(Pipeline(cfg.vocab_size, ZS, ZB).batches(1)),
                      "cuda")

    def loss_fn(p, b):
        logits = model.forward(p, b, dtype=torch.float32)
        return softmax_xent(logits, b["labels"], cfg.vocab_size), {}

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    (lk, _), gk = value_and_grad(loss_fn, params, batch)
    launches = read()
    with contextlib.ExitStack() as stack:
        for module, attr, plain in patches:
            stack.enter_context(mock.patch.object(module, attr, plain))
        (lp, _), gp = value_and_grad(loss_fn, params, batch)
    if read() != launches:
        raise SystemExit("the plain path launched a kernel")
    nk, np_ = float(global_norm(gk)), float(global_norm(gp))
    worst, bad = 0.0, []
    for (path, a), (_, b) in zip(leaf_items(gk), leaf_items(gp)):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, rel)
        if rel > STEP_GRAD_TOL or not bool(torch.isfinite(a).all()):
            bad.append((path, rel))
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    norm_rel = abs(nk - np_) / np_
    print(f"[c] {arch} {n_layers} layers at full width, fp32 train step, "
          f"kernel vs plain path: op calls {launches} (want {want}); loss "
          f"{float(lk):.6f} vs {float(lp):.6f} (rel {loss_rel:.2e}, tol "
          f"{STEP_LOSS_TOL:.0e}); grad norm {nk:.6f} vs {np_:.6f} (rel "
          f"{norm_rel:.2e}, tol {STEP_NORM_TOL:.0e}); worst leaf "
          f"max|diff|/max|plain| {worst:.2e} (tol {STEP_GRAD_TOL:.0e}) over "
          f"{len(list(leaf_items(gk)))} leaves")
    if launches != want:
        raise SystemExit(f"op calls {launches}, want {want}")
    if loss_rel > STEP_LOSS_TOL or norm_rel > STEP_NORM_TOL or bad:
        raise SystemExit(f"kernel-path train step disagrees: {bad}")
    del params, gk, gp
    gc.collect()
    torch.cuda.empty_cache()


def train_run(torch, train, argv, name, dims, want_params, counters,
              want_per_step):
    """Full-width training through `launch.train.main(argv)`, every count
    of `counters` ({label: (function, attribute)}) set to 0 just before and
    read just after.  Holds the config's (n_layers, d_model, vocab) `dims`,
    the param count, each count at `want_per_step` a step and finite
    losses; prints each step (a MoE model's with its aux loss).  Returns
    (launch.train's result, counts over the run, steps)."""
    from repro_torch.models.common import param_count

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    res = train.main(argv)
    counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    cfg, steps = res["model"].cfg, len(res["losses"])
    n_params = param_count(res["params"])
    if (cfg.n_layers, cfg.d_model, cfg.vocab_size) != dims:
        raise SystemExit(f"not {name} at full width: {cfg}")
    batch, seq = (argv[argv.index(f) + 1] for f in ("--global-batch",
                                                      "--seq"))
    print(f"[c] {name} trained {steps} steps at batch {batch} x {seq}: "
          f"params={n_params:,}; losses={[round(x, 4) for x in res['losses']]}"
          f"; peak max_memory_allocated_GB="
          f"{res['peak_bytes'] / 1e9:.2f}")
    for r in res["records"]:
        aux = f" moe_aux={r['moe_aux']:.6f}" if cfg.moe else ""
        print(f"[c]   step {r['step']}: step_ms={r['step_ms']:.1f} fwd_ms="
              f"{r['fwd_ms']:.1f} bwd_ms={r['bwd_ms']:.1f} opt_ms="
              f"{r['opt_ms']:.1f} tokens_per_s={r['tokens_per_s']:.0f} "
              f"grad_norm={r['grad_norm']:.4f}{aux}")
    print(f"[c] op calls per step: " + ", ".join(
        f"{k} {n / steps:g} (want {want_per_step[k]}; total {n})"
        for k, n in counts.items()))
    if n_params != want_params:
        raise SystemExit(f"param count {n_params}, want {want_params}")
    if any(counts[k] != want_per_step[k] * steps for k in counts):
        raise SystemExit(f"op calls {counts} over {steps} steps, want "
                         f"{want_per_step} a step")
    if not np.isfinite(res["losses"]).all():
        raise SystemExit("non-finite training loss")
    return res, counts, steps


def train_full_width(torch, train, argv, name, dims, want_params, counters,
                     want_per_step):
    """`train_run`, then gradient and repeated-batch checks, one of whose
    steps runs under the profiler.  Returns (counts over the run, steps,
    the run's records, losses and peak bytes, the profiled step's
    summary); the model is freed on return."""
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime.train_step import (make_loss_fn, make_train_step,
                                                value_and_grad)

    res, counts, steps = train_run(torch, train, argv, name, dims,
                                   want_params, counters, want_per_step)
    model, params, opt_state = res["model"], res["params"], res["opt_state"]
    cfg = model.cfg

    # one repeated batch: every leaf's gradient, then 4 steps at warmup 0
    batch = train.to_device(next(Pipeline(cfg.vocab_size, ZS, ZB, seed=1)
                                 .batches(1)), tree_leaves(params)[0].device)
    timings: dict = {}
    (loss0, _), grads = value_and_grad(make_loss_fn(model), params, batch,
                                       timings)
    leaves = list(leaf_items(grads))
    bad = [p for p, g in leaves
           if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    print(f"[c] gradients of the repeated batch: {len(leaves)} leaves, "
          f"{len(leaves) - len(bad)} finite and not all zero; loss "
          f"{float(loss0):.4f}; fwd_ms={timings['fwd_s'] * 1e3:.1f} "
          f"bwd_ms={timings['bwd_s'] * 1e3:.1f}")
    if bad:
        raise SystemExit(f"zero or non-finite gradients: {bad}")
    del grads
    # Fresh moments (zeroed in place: a second set would not fit beside the
    # first) and a small constant lr, so 4 Adam steps on one batch stay in
    # the regime where the loss must descend; at launch.train's default
    # lr 3e-4 a model of billions of parameters overshoots in its first
    # steps.
    for t in (*tree_leaves(opt_state.m), *tree_leaves(opt_state.v)):
        t.zero_()
    opt_state = opt_state._replace(count=torch.zeros_like(opt_state.count))
    step_fn = make_train_step(model, res["rc"].replace(
        lr=REPEAT_LR, warmup_steps=0, total_steps=1000))
    rep, profiled, step_ms = [], None, None
    for i in range(4):
        if i == 2:   # one step under the profiler: where the device time goes
            (params, opt_state, m), profiled = device_profile(
                torch, f"{name} train step", lambda: step_fn(
                    params, opt_state, batch), step_ms)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        rep.append(float(m["loss"]))
    print(f"[c] {name} repeated batch, 4 steps at lr {REPEAT_LR:g}, warmup "
          f"0, fresh moments: losses {[round(x, 4) for x in rep]}")
    if not (np.isfinite(rep).all() and rep[-1] < rep[0]):
        raise SystemExit("the repeated batch's loss did not fall")
    run = {"records": res["records"], "losses": res["losses"],
           "peak_bytes": res["peak_bytes"]}
    return counts, steps, run, profiled


def phase_train(torch, ssd_ops, fa_ops, train):
    """Full-width zamba2-2.7b through `launch.train.main` (train_full_width).
    Returns the launches of the run and per forward: ((ssd, per forward),
    (flash, per forward), ssd backward, the profiled step's summary)."""
    counts, steps, _, profiled = train_full_width(
        torch, train, TRAIN_ARGV, "zamba2-2.7b", (54, 2560, 32000),
        2_501_316_000,
        {"mamba2_ssd forward (3 kernels each)": (ssd_ops.ssd, "launches"),
         "mamba2_ssd backward (4 kernels each)": (ssd_ops.ssd,
                                                  "bwd_launches"),
         "flash_attention": (fa_ops.flash_attention, "launches")},
        {"mamba2_ssd forward (3 kernels each)": 54,
         "mamba2_ssd backward (4 kernels each)": 54, "flash_attention": 9})
    n_ssd, n_bwd, n_fa = counts.values()
    return (n_ssd, n_ssd // steps), (n_fa, n_fa // steps), n_bwd, profiled


def phase_wkv_grads(torch, wkv_ops, wkv_ref):
    """The WKV op at rwkv6's training shape (WTRAIN), fp32, in two decays,
    through grad_check: its y and final state under autograd (the kernel's)
    against `wkv6_chunked`'s (WKV_TOL), and its gradients (the recompute
    of `wkv6_chunked`) against autograd through `wkv6_chunked` on the card
    (GRAD_TOL), the final state unused as in training; the plain fp32
    autograd against fp64, printed; the op's forward ms, the plain
    version's and the bound, and the backward's ms (the recompute).
    Returns the WKV row's keys for them."""
    b, s, h, hd, q = WTRAIN
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for decay in ("sweep", "slow"):
        n = lambda: torch.randn((b, s, h, hd), generator=gen,  # noqa: E731
                                device="cuda")
        r, k, v = n() * 0.5, n() * 0.5, n()
        logw = -torch.exp(n() * 0.5 - 1.0 if decay == "sweep"
                          else n() * 0.1 - 6.0)
        u = torch.randn((h, hd), generator=gen, device="cuda") * 0.1
        g = n()
        ins = [r, k, v, logw, u]
        err, bwd_ms = grad_check(
            torch, f"wkv6 {WTRAIN[:4]} Q={q} {decay} decay",
            lambda *a: wkv_ops.wkv6(*a, chunk=q),
            lambda *a: wkv_ref.wkv6_chunked(*a, chunk=q), ins, g, WKV_TOL)
        a32 = [t.clone().requires_grad_() for t in ins]
        a64 = [t.double().requires_grad_() for t in ins]
        g32 = torch.autograd.grad(
            wkv_ref.wkv6_chunked(*a32, chunk=q)[0], a32, g)
        zero64 = torch.zeros((b, h, hd, hd), dtype=torch.float64,
                             device="cuda")
        g64 = torch.autograd.grad(wkv_ref.wkv6_chunked(
            *a64, chunk=q, initial_state=zero64)[0], a64, g.double())
        fp64_err = max(float((x.double() - y).abs().max())
                       / max(1.0, float(y.abs().max()))
                       for x, y in zip(g32, g64))
        print(f"[b] wkv6 {decay} decay: plain fp32 autograd vs fp64, "
              f"max|diff|/max(1, max|fp64|) over the inputs = "
              f"{fp64_err:.3e} (printed, not held)")
        del a32, a64, g32, g64, zero64
        if decay == "sweep":
            ms = cuda_ms(lambda: wkv_ops.wkv6(*ins, chunk=q), 10)
            plain_ms = cuda_ms(lambda: wkv_ref.wkv6_chunked(*ins, chunk=q),
                               3)
            bound_ms, bound_by, *_ = wkv_bound(b, s, h, hd, q, False)
            print(f"[b] wkv6 training shape {WTRAIN[:4]} Q={q}: kernel_ms="
                  f"{ms:.3f} plain_ms={plain_ms:.3f} bound_ms="
                  f"{bound_ms:.4f} ({bound_by}) backward_ms={bwd_ms:.2f} "
                  f"(the recompute)")
            out = {"bwd_ms": bwd_ms, "bwd_max_abs_err": err,
                   "bwd_fp64_err": fp64_err,
                   "train_shape": {"shape": list(WTRAIN[:4]), "chunk": q,
                                   "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bound_ms,
                                   "bound_by": bound_by, "library_ms": None}}
        else:
            out["bwd_fp64_err_slow"] = fp64_err
        del ins, r, k, v, logw, u, g
        torch.cuda.empty_cache()
    return out


def phase_grads_gemma2(torch, fa_ops, fa_ref):
    """Flash at gemma2's training shape (GTRAIN: q (2, 1024, 16, 256), k/v
    4 heads, softcap CAP, the local layers' window 4096): the gradients
    through the op against autograd through its plain version, fp32
    (GRAD_TOL); in bf16, the type training runs, the kernel against the
    plain version (one bf16 rounding, BF16_ATOL), its ms, the plain
    version's, the bound, torch.compile(flex_attention)'s ms and the
    backward's ms (the recompute).  Returns the gemma2 row's keys."""
    from torch.nn.attention.flex_attention import flex_attention
    b, s, hq, g, hd, window = GTRAIN
    kw = dict(window=window, logit_softcap=CAP, scale=SCALE, q_block=512,
              kv_block=512)
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn((b, s, hq, hd), generator=gen, device="cuda")
    k, v = (torch.randn((b, s, g, hd), generator=gen, device="cuda")
            for _ in range(2))
    gq = torch.randn((b, s, hq, hd), generator=gen, device="cuda")
    err, _ = grad_check(
        torch, f"flash_attention fp32 q{(b, s, hq, hd)} kv{(b, s, g, hd)} "
        f"window={window} softcap={CAP}",
        lambda *a: fa_ops.flash_attention(*a, **kw),
        lambda *a: fa_ref.flash_attention_blockwise(*a, **kw), [q, k, v], gq,
        FP32_TOL)
    qkv = [t.bfloat16() for t in (q, k, v)]
    out = fa_ops.flash_attention(*qkv, **kw)
    plain32 = fa_ref.flash_attention_blockwise(*(t.float() for t in qkv),
                                               **kw)
    excess = bf16_excess(out, plain32)
    ms = cuda_ms(lambda: fa_ops.flash_attention(*qkv, **kw), 10)
    plain_ms = cuda_ms(lambda: fa_ref.flash_attention_blockwise(*qkv, **kw),
                       3)
    bound_ms, bound_by, _ = attention_bound(b, s, hq, g, hd, window, 2,
                                            H100_BF16_FLOPS)
    flex = torch.compile(flex_attention)
    flex_yardstick(torch, *qkv, window, CAP, SCALE, flex)   # compiles
    flex_out, flex_ms = flex_yardstick(torch, *qkv, window, CAP, SCALE, flex)
    flex_err = float((flex_out.float() - plain32).abs().max())
    a = [t.requires_grad_() for t in qkv]
    out = fa_ops.flash_attention(*a, **kw)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, a, gq.bfloat16(), retain_graph=True), 3)
    print(f"[b] flash_attention bf16 gemma2 training shape q{(b, s, hq, hd)}"
          f": beyond one bf16 rounding of the fp32 result {excess:.3e} (tol "
          f"{BF16_ATOL:.0e}) kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) flex_ms={flex_ms:.3f} "
          f"(max_abs_err vs plain fp32 {flex_err:.3e}) backward_ms="
          f"{bwd_ms:.2f} (recompute of the blockwise version, q/kv blocks "
          f"512) {'ok' if excess <= BF16_ATOL else 'FAIL'}")
    if excess > BF16_ATOL or not bool(torch.isfinite(out).all()):
        raise SystemExit(f"flash_attention at gemma2's training shape "
                         f"disagrees with its plain version: {excess}")
    del q, k, v, gq, qkv, a, out, plain32, flex_out
    torch.cuda.empty_cache()
    return {"train_bwd_ms": bwd_ms,
            "train_shape": {"shape": [b, s, hq, g, hd], "window": window,
                            "grad_max_rel_err": err, "bf16_excess": excess,
                            "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": flex_ms,
                            "library": "torch.compile(flex_attention)"}}


def phase_train_gemma2(torch, fa_ops, train):
    """Full-width gemma2-2b, 4 steps (train_full_width), then 2 steps of
    the same run with --remat full: 52 flash op calls a step (the forward
    and its rerun), step 1's loss and grad norm equal to the first run's
    (REMAT_LOSS_TOL, REMAT_NORM_TOL) and a lower peak memory.  Returns the
    gemma2 row's keys and the profiled step's summary."""
    counter = {"flash_attention": (fa_ops.flash_attention, "launches")}
    counts, steps, run, profiled = train_full_width(
        torch, train, GEMMA_TRAIN_ARGV, "gemma2-2b", (26, 2304, 256000),
        2_859_708_672, counter, {"flash_attention": 26})
    gc.collect()
    torch.cuda.empty_cache()
    fa_ops.flash_attention.launches = 0
    remat = train.main(GEMMA_TRAIN_ARGV + ["--steps", "2", "--remat",
                                           "full"])
    n_remat = fa_ops.flash_attention.launches
    a, b = run["records"][0], remat["records"][0]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(a["loss"])
    norm_rel = abs(a["grad_norm"] - b["grad_norm"]) / a["grad_norm"]
    print(f"[c] gemma2-2b --remat full, 2 steps: flash op calls "
          f"{n_remat / 2:g} a step (want 52: the forward and its rerun); "
          f"step 1 loss {b['loss']:.6f} vs {a['loss']:.6f} without remat "
          f"(rel {loss_rel:.2e}, tol {REMAT_LOSS_TOL:.0e}), grad norm "
          f"{b['grad_norm']:.6f} vs {a['grad_norm']:.6f} (rel {norm_rel:.2e},"
          f" tol {REMAT_NORM_TOL:.0e}); peak max_memory_allocated_GB "
          f"{remat['peak_bytes'] / 1e9:.2f} vs {run['peak_bytes'] / 1e9:.2f} "
          f"without remat; step_ms " + ", ".join(
              f"{r['step_ms']:.1f}" for r in remat["records"]))
    if n_remat != 52 * 2:
        raise SystemExit(f"flash op calls under remat {n_remat}, want 104")
    if loss_rel > REMAT_LOSS_TOL or norm_rel > REMAT_NORM_TOL:
        raise SystemExit("remat changed step 1's loss or grad norm")
    if not remat["peak_bytes"] < run["peak_bytes"]:
        raise SystemExit("remat did not lower the peak memory")
    keys = {"train_launches": counts["flash_attention"],
            "train_launches_per_forward": counts["flash_attention"] // steps,
            "remat_launches": n_remat,
            "train_peak_GB": run["peak_bytes"] / 1e9,
            "remat_peak_GB": remat["peak_bytes"] / 1e9}
    del remat
    return keys, profiled


def phase_train_rwkv6(torch, wkv_ops, train):
    """Full-width rwkv6-1.6b, 4 steps (train_full_width): 24 WKV op calls
    (72 kernel launches) a step.  Returns the WKV row's keys and the
    profiled step's summary."""
    counts, steps, run, profiled = train_full_width(
        torch, train, RWKV_TRAIN_ARGV, "rwkv6-1.6b", (24, 2048, 65536),
        1_599_873_024, {"wkv6 (3 kernels each)": (wkv_ops.wkv6, "launches")},
        {"wkv6 (3 kernels each)": 24})
    n = counts["wkv6 (3 kernels each)"]
    return {"train_launches": n, "train_launches_per_forward": n // steps,
            "train_peak_GB": run["peak_bytes"] / 1e9}, profiled


@contextlib.contextmanager
def host_mesh(torch):
    """A 1x1 (data, model) mesh on the card over a world-size-1 group that
    is created here and destroyed on leaving."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if dist.is_initialized():
        raise SystemExit("a process group is already running")
    mesh = make_host_mesh("cuda")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def ckpt_onto_mesh(torch, d, step):
    """The params saved at `step` restored onto a 1x1 mesh on the card with
    the port's `param_specs`: every leaf a DTensor on the card with its
    spec's placements, equal to the saved array bit for bit."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.runtime.sharding import param_specs, placements
    t0 = time.perf_counter()
    cfg = get_config("gemma2-2b").reduced()
    template = {"params": build_model(cfg).init(torch.Generator(), "meta")}
    specs = {"params": param_specs(template["params"], cfg)}
    with host_mesh(torch) as mesh:
        back = ckpt.restore(d, step, template, mesh=mesh, spec_tree=specs)
        spec_of = dict(ckpt._items(specs))
        bad, n = [], 0
        with np.load(Path(d) / f"step_{step:08d}" / "arrays.npz") as data:
            for k, t in ckpt._items(back):
                n += 1
                loc = t.to_local()
                if (not hasattr(t, "device_mesh") or loc.device.type != "cuda"
                        or tuple(t.placements) != placements(mesh, spec_of[k])
                        or loc.cpu().numpy().tobytes() != data[k].tobytes()):
                    bad.append(k)
    secs = time.perf_counter() - t0
    print(f"[c] checkpoint step {step} restored onto a 1x1 mesh on the card "
          f"with param_specs: {n} leaves, {n - len(bad)} DTensors on the "
          f"card with their specs' placements and equal to arrays.npz bit "
          f"for bit; phase {secs:.1f}s")
    if bad or not n:
        raise SystemExit(f"restore onto the mesh differs: {bad}")
    return secs


def same_bytes(torch, t, arr) -> bool:
    """Tensor `t` holds exactly the bytes of numpy array `arr`."""
    a = t.detach().reshape(-1).view(torch.uint8).cpu().numpy()
    return np.array_equal(a, np.ascontiguousarray(arr).reshape(-1)
                          .view(np.uint8))


def restore_spy(torch, ckpt, calls: list):
    """A stand-in for `ckpt.restore` that calls it and appends to `calls`,
    for each call: the restored leaves' keys, the step's arrays.npz keys,
    the leaves not on the card or not equal to arrays.npz bit for bit,
    whether the restore wrote into the template's tensors (in place), how
    far the allocated device memory grew during it, the largest leaf's
    bytes and the restore's seconds.  The leaves are compared as soon as
    they are restored: the train step then updates them in place."""
    real = ckpt.restore

    def spy(directory, step, template, **kw):
        items = list(ckpt._items(template))
        ptrs = [t.data_ptr() for _, t in items]
        largest = max(t.numel() * t.element_size() for _, t in items)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = real(directory, step, template, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grown = torch.cuda.max_memory_allocated() - before
        items = list(ckpt._items(tree))
        with np.load(Path(directory) / f"step_{step:08d}"
                     / "arrays.npz") as data:
            files = sorted(data.files)
            diff = [k for k, t in items if t.device.type != "cuda"
                    or k not in files or not same_bytes(torch, t, data[k])]
        calls.append({
            "keys": sorted(k for k, _ in items), "files": files,
            "diff": diff, "in_place": tree is template
            and [t.data_ptr() for _, t in items] == ptrs,
            "grown": grown, "largest": largest, "seconds": secs})
        return tree

    return spy


def restore_checks(got: dict, what: str):
    """Fails unless the restore `restore_spy` recorded put every leaf of
    the checkpoint on the card bit for bit, wrote in place and grew the
    allocated device memory by no more than the largest leaf."""
    if got["diff"] or got["keys"] != got["files"]:
        raise SystemExit(f"{what}: restored leaves differ from the "
                         f"checkpoint: {got['diff']}")
    if not got["in_place"] or got["grown"] > got["largest"]:
        raise SystemExit(f"{what}: restore did not write into the run's "
                         f"tensors in place, or allocated more than one leaf "
                         f"on the card")


def phase_ckpt(torch, train):
    """Reduced gemma2-2b on the card, 4 steps saving every 2 into a
    temporary directory under build/, then --resume --steps 6: the run
    says it resumed from step 4, the params and moments it restored onto
    the card equal step 4's arrays.npz bit for bit, restore wrote them into
    the tensors the run initialised (in place) and grew the allocated
    device memory by no more than the largest leaf, and the resumed losses
    are finite."""
    from repro_torch.checkpoint import ckpt
    restored = []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        argv = ["--arch", "gemma2-2b", "--reduced", "--global-batch", "2",
                "--seq", "64", "--ckpt-dir", d, "--ckpt-every", "2",
                "--device", "cuda"]
        train.main(argv + ["--steps", "4"])
        out = io.StringIO()
        with mock.patch.object(ckpt, "restore",
                               restore_spy(torch, ckpt, restored)), \
                contextlib.redirect_stdout(out):
            res = train.main(argv + ["--steps", "6", "--resume"])
        print(out.getvalue(), end="")
        n_saved = sorted(p.name for p in Path(d).glob("step_*"))
        ckpt_onto_mesh(torch, d, 4)
    got = restored[0]
    said = "[train] resumed from step 4" in out.getvalue()
    n = len(got["keys"])
    print(f"[c] checkpoint on the card: resumed={said}; {n} leaves restored "
          f"onto the card, {n - len(got['diff'])} equal to step 4's "
          f"arrays.npz bit for bit; in place: {got['in_place']}; allocated "
          f"device memory grew by {got['grown']} B during the restore "
          f"(largest leaf {got['largest']} B); resumed losses "
          f"{[round(x, 4) for x in res['losses']]}; steps kept {n_saved}")
    if not said or res["start_step"] != 4 or len(res["losses"]) != 2:
        raise SystemExit("the run did not resume from step 4")
    restore_checks(got, "checkpoint")
    if not np.isfinite(res["losses"]).all():
        raise SystemExit("non-finite loss after the resume")


def phase_resume_full(torch, train):
    """Full-width gemma2-2b (d_model 2304, the 256000-row tied embedding:
    a 2.36 GB fp32 leaf, past 2^31 bytes) at RESUME_ARGV's 2 layers: one
    step saved into a directory under build/ (the checkpoint: fp32 params
    and both AdamW moments), then --resume --steps 2 (its own save of the
    last step skipped).  Held as phase_ckpt
    holds its reduced run (it resumed; every leaf restored onto the card
    equal to arrays.npz bit for bit; in place; the device memory grown by
    no more than the largest leaf; a finite loss), and the resumed step's
    loss and grad norm against the saving run's own state carried one step
    further by the same train step on the same batch (the pipeline's first:
    a resumed run is fed the first batches again, ROADMAP Queue 3), within
    RESUME_LOSS_TOL and RESUME_NORM_TOL.  Prints the checkpoint's bytes and
    the seconds of its save (the device-to-host copy, then the write) and
    of its restore; the directory is deleted at the end.  Returns the
    phase's figures."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.runtime.train_step import make_train_step
    t_phase = time.perf_counter()
    restored, skipped, saves = [], [], {"copy_s": [], "write_s": []}
    copy, write = ckpt.AsyncCheckpointer.save, ckpt.save

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            saves[key].append(time.perf_counter() - t0)
            return out
        return call

    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(dir=ROOT / "build", prefix="resume_full_")
    try:
        argv = RESUME_ARGV + ["--ckpt-dir", d, "--ckpt-every", "1"]
        with mock.patch.object(ckpt.AsyncCheckpointer, "save",
                               timed("copy_s", copy)), \
                mock.patch.object(ckpt, "save", timed("write_s", write)):
            first = train.main(argv + ["--steps", "1"])
        step_dir = Path(d) / "step_00000001"
        nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
        out = io.StringIO()
        # --ckpt-dir saves a run's last step too; the resumed run's save of
        # step 2 (another 9 GB, ~18 s) is skipped: the check reads step 1's
        with mock.patch.object(ckpt, "restore",
                               restore_spy(torch, ckpt, restored)), \
                mock.patch.object(ckpt.AsyncCheckpointer, "save",
                                  lambda self, step, *a, **k:
                                  skipped.append(step)), \
                contextlib.redirect_stdout(out):
            res = train.main(argv + ["--steps", "2", "--resume"])
        print(out.getvalue(), end="")
        n_saved = sorted(p.name for p in Path(d).glob("step_*"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    # the saving run's state, one step further on the batch the resumed
    # step was fed
    model, rc = first["model"], res["rc"]
    batch = next(Pipeline(model.cfg.vocab_size, RESUME_SEQ, RESUME_BATCH,
                          seed=rc.seed).batches(1))
    _, _, m = make_train_step(model, rc)(
        first["params"], first["opt_state"],
        train.to_device(batch, "cuda", model.cfg))
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    got, rec = restored[0], res["records"][0]
    said = "[train] resumed from step 1" in out.getvalue()
    loss_rel = abs(rec["loss"] - loss) / abs(loss)
    norm_rel = abs(rec["grad_norm"] - norm) / norm
    big = max(t.numel() * t.element_size() for _, t in leaf_items(
        res["params"]))
    n = len(got["keys"])
    save_s = saves["copy_s"][0] + saves["write_s"][0]
    phase_s = time.perf_counter() - t_phase
    print(f"[c] full-width checkpoint on the card (gemma2-2b, "
          f"{res['model'].cfg.n_layers} layers, d_model "
          f"{res['model'].cfg.d_model}, {first['records'][0]['step']} step "
          f"saved): {nbytes / 1e9:.3f} GB on disk, saved in "
          f"{save_s:.1f}s (device to host {saves['copy_s'][0]:.1f}s, write "
          f"{saves['write_s'][0]:.1f}s), restored in {got['seconds']:.1f}s "
          f"(the resumed run's saves of steps {skipped} skipped); "
          f"resumed={said}; {n} leaves "
          f"restored "
          f"onto the card, {n - len(got['diff'])} equal to arrays.npz bit "
          f"for bit, the largest {got['largest']} B (params' largest "
          f"{big} B); in place: {got['in_place']}; allocated device memory "
          f"grew by {got['grown']} B during the restore; resumed step 2 loss "
          f"{rec['loss']:.6f} vs {loss:.6f} uninterrupted (rel "
          f"{loss_rel:.2e}, tol {RESUME_LOSS_TOL:.0e}), grad norm "
          f"{rec['grad_norm']:.6f} vs {norm:.6f} (rel {norm_rel:.2e}, tol "
          f"{RESUME_NORM_TOL:.0e}); steps kept {n_saved}; phase "
          f"{phase_s:.1f}s")
    if not said or res["start_step"] != 1 or len(res["losses"]) != 1 \
            or len(saves["write_s"]) != 1 or skipped != [2]:
        raise SystemExit("the full-width run did not save step 1 once and "
                         "resume from it")
    restore_checks(got, "full-width checkpoint")
    if got["largest"] < 1 << 31:
        raise SystemExit(f"the largest restored leaf has {got['largest']} "
                         f"B, not past 2^31")
    if not np.isfinite(res["losses"]).all():
        raise SystemExit("non-finite loss after the full-width resume")
    if loss_rel > RESUME_LOSS_TOL or norm_rel > RESUME_NORM_TOL:
        raise SystemExit("the resumed step differs from the uninterrupted "
                         "run's")
    return {"ckpt_bytes": nbytes, "save_s": save_s,
            "restore_s": got["seconds"],
            "largest_leaf_bytes": got["largest"], "loss": rec["loss"],
            "loss_uninterrupted": loss, "phase_s": phase_s}


def phase_train_model(torch, fa_ops, train, argv, name, dims, n_params,
                      per_step):
    """`name` trained through `launch.train.main(argv)` (train_run) with
    fp32 AdamW: `per_step` flash op calls a step (the backward is the plain
    version's recompute), finite losses, and a MoE model's router aux loss
    finite and > 0 at every step.  Returns the row's training keys and the
    phase's seconds."""
    t0 = time.perf_counter()
    res, counts, steps = train_run(
        torch, train, argv, name, dims, n_params,
        {"flash_attention": (fa_ops.flash_attention, "launches")},
        {"flash_attention": per_step})
    keys = {"train_launches": counts["flash_attention"],
            "train_launches_per_forward": counts["flash_attention"] // steps,
            "train_step_ms": [r["step_ms"] for r in res["records"]],
            "train_losses": res["losses"],
            "train_peak_GB": res["peak_bytes"] / 1e9}
    if res["model"].cfg.moe is not None:
        keys["moe_aux"] = [r["moe_aux"] for r in res["records"]]
        if not all(np.isfinite(x) and x > 0 for x in keys["moe_aux"]):
            raise SystemExit(f"{name}: the router's aux loss is not finite "
                             f"and > 0: {keys['moe_aux']}")
    keys["train_phase_s"] = time.perf_counter() - t0
    print(f"[c] {name} training phase: {keys['train_phase_s']:.1f}s")
    return keys


def device_profile(torch, what, fn, ref_ms, top=10):
    """fn() once under torch.profiler: its wall ms (host clock, the device
    synchronised, the profiler's own cost included), the device ms summed
    over the kernels, memory copies and sets it ran (one stream, so they do
    not overlap), the device's idle share of ref_ms (the same work timed
    just before without the profiler), and the kernels that took the most
    device time with their launch counts.  Returns fn's result and that
    summary (device ms "not measured" where the profiler shows no device
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        kernels.append((us / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    if device_ms <= 0:
        print(f"[c] profiled {what}: wall_ms={wall_ms:.1f}; device time "
              f"not measured (the profiler shows none)")
        return out, {"wall_ms": wall_ms, "device_ms": "not measured"}
    summary = {"wall_ms": wall_ms, "unprofiled_ms": ref_ms,
               "device_ms": device_ms,
               "idle_share": 1.0 - device_ms / ref_ms,
               "top": [{"kernel": k[:120], "ms": ms, "launches": n}
                       for ms, n, k in kernels[:top]]}
    print(f"[c] profiled {what}: wall_ms={wall_ms:.1f} (profiler included) "
          f"device_ms={device_ms:.1f}; the same just before without the "
          f"profiler {ref_ms:.1f} ms, idle_share="
          f"{summary['idle_share']:.3f}; most device time: " + "; ".join(
              f"{k[:70]} {ms:.1f} ms / {n}" for ms, n, k in kernels[:top]))
    return out, summary


def run(where: dict) -> int:
    """Every phase in order; where["phase"] names the one running, for the
    failure line."""
    global H100_BF16_FLOPS, H100_BYTES_S
    import torch
    if not torch.cuda.is_available():
        why = "chip_smoke: no CUDA device; this script runs only on the card"
        print(why, file=sys.stderr)
        print(why, flush=True)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
    from repro_torch.kernels.mamba2_ssd import kernel as ssd_kernel
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
    from repro_torch.kernels.tiled_matmul import kernel as mm_kernel
    from repro_torch.kernels.tiled_matmul import ops as mm_ops
    from repro_torch.kernels.tiled_matmul import ref as mm_ref
    from repro_torch.launch import metg, serve, train
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.models import attention, moe, rwkv
    H100_BF16_FLOPS, H100_BYTES_S = PEAK_FLOPS_BF16, HBM_BW

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    where["phase"] = "(a) card and builds"
    card = card_line()
    print(f"[a] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices={torch.cuda.device_count()}")
    builds, regs = build_all(_build, ("flash_attention", "wkv6", "mamba2_ssd",
                                      "tiled_matmul"))

    where["phase"] = "(b) flash_attention"
    row, zrow = phase_kernel(torch, fa_ops, fa_ref, fa_kernel)
    where["phase"] = "(b) flash_attention at whisper-base's shapes"
    wrow, mla_train_shape = phase_kernel_whisper(torch, fa_ops, fa_ref,
                                                 fa_kernel)
    where["phase"] = "(b) wkv6"
    wkv_row = phase_wkv(torch, wkv_ops, wkv_ref, wkv_kernel, regs["wkv6"])
    where["phase"] = "(b) mamba2_ssd"
    ssd_row = phase_ssd(torch, ssd_ops, ssd_ref, ssd_kernel,
                        regs["mamba2_ssd"])
    where["phase"] = "(b) mamba2_ssd backward"
    ssd_row.update(phase_ssd_bwd(torch, ssd_ops, ssd_ref, ssd_kernel))
    ssd_row["bwd_regs"] = kernel_registers(regs["mamba2_ssd"],
                                           SSD_BWD_INSTANCES)
    where["phase"] = "(b) flash_attention gradients"
    zrow["bwd_ms"], grads_extra = phase_grads(torch, fa_ops, fa_ref)
    wrow["grad_cross"] = grads_extra["whisper_cross"]
    row["grad_mla"] = grads_extra["mla"]
    where["phase"] = "(b) tiled_matmul"
    mm_row = phase_matmul(torch, mm_ops, mm_ref, mm_kernel, metg)
    where["phase"] = "(c) dwork METG ladder"
    mm_row["launches"], metg_table = phase_metg(torch, mm_ops, metg)
    where["phase"] = "(c) the front door's schedulers on the card"
    mm_row["front_door"] = phase_front_door(torch, mm_ops, metg)
    where["phase"] = "(c) the proc transport: worker processes on the card"
    mm_row["proc"] = phase_proc(torch, metg, mm_row["front_door"])
    where["phase"] = "(c) pmake campaigns"
    row["campaign"] = phase_campaign(torch, card)
    where["phase"] = "(c) mpi-list on the card"
    mm_row["mpi_list"] = phase_mpi_list(torch, mm_ops, metg, card)
    where["phase"] = "(c) mpi-list DFM bridge"
    mm_row["mesh_ops_ms"] = phase_mesh_ops(torch, card)
    where["phase"] = "(c) elastic pool and run_pool"
    mm_row["elastic"], mm_row["run_pool"] = phase_elastic(torch, mm_ops,
                                                          metg, card)
    where["phase"] = "(c) METG, all three schedulers"
    mm_row["metg_schedulers"] = phase_metg_table(metg_table, card)
    gc.collect()
    torch.cuda.empty_cache()
    for r, lib in ((row, "flash_attention"), (zrow, "flash_attention"),
                   (wrow, "flash_attention"), (mm_row, "tiled_matmul")):
        r["sass_hgmma"] = builds[lib]
    # "launches": the count over the path's run (a serve: its prefill
    # batches; training: its steps); "launches_per_forward": per prefill
    # batch or training forward
    where["phase"] = "(c) gemma2-2b serve"
    row["launches"], row["launches_per_forward"], row["serve_obs"] = \
        phase_serve(torch, fa_ops, attention, fa_ref, serve)
    where["phase"] = "(c) rwkv6-1.6b serve"
    wkv_row["launches"], wkv_row["launches_per_forward"] = phase_serve_rwkv(
        torch, wkv_ops, rwkv, wkv_ref, serve)
    where["phase"] = "(c) zamba2-2.7b serve"
    (ssd_row["serve_launches"], ssd_row["serve_launches_per_forward"]), \
        (zrow["serve_launches"], zrow["serve_launches_per_forward"]), \
        zrow["serve"] = phase_serve_zamba(torch, ssd_ops, fa_ops, attention,
                                          fa_ref, serve)
    gc.collect()               # the served model and its caches go first
    torch.cuda.empty_cache()
    where["phase"] = "(c) deepseek-7b serve"
    row["deepseek"] = phase_serve_model(
        torch, fa_ops, attention, fa_ref, moe, serve, "deepseek-7b",
        (30, 4096, DSH, DSH, DSHD, 102400), 6_910_365_696)
    gc.collect()
    torch.cuda.empty_cache()
    where["phase"] = "(c) deepseek-v2-lite-16b serve"
    row["deepseek_v2_lite"] = phase_serve_model(
        torch, fa_ops, attention, fa_ref, moe, serve, "deepseek-v2-lite-16b",
        (27, 2048, 16, 16, 128, 102400), 15_706_484_224)
    gc.collect()
    torch.cuda.empty_cache()
    where["phase"] = "(c) qwen2-vl-2b serve"
    row["qwen2_vl"] = phase_serve_model(
        torch, fa_ops, attention, fa_ref, moe, serve, "qwen2-vl-2b",
        (28, 1536, 12, 2, 128, 151936), 1_587_965_440)
    gc.collect()
    torch.cuda.empty_cache()
    new_s = {}      # the seconds of the large serves and the full resume
    for arch, depth, dims, n_params, prefix in LARGE_SERVES:
        where["phase"] = f"(c) {arch} serve at {depth} layers"
        key = arch.replace("-", "_").replace(".", "_")
        row[key] = phase_serve_model(
            torch, fa_ops, attention, fa_ref, moe, serve, arch, dims,
            n_params, depth=depth, prefix=prefix)
        new_s[f"{arch} serve"] = row[key]["serve_phase_s"]
        gc.collect()
        torch.cuda.empty_cache()
    where["phase"] = "(c) whisper-base serve"
    wrow.update(phase_serve_model(
        torch, fa_ops, attention, fa_ref, moe, serve, "whisper-base",
        (6, 512, 8, 8, 64, 51865), 80_117_760, WH_ARGV, 18))
    gc.collect()
    torch.cuda.empty_cache()
    where["phase"] = "(c) whisper-base training"
    wrow.update(phase_train_model(torch, fa_ops, train, WHISPER_TRAIN_ARGV,
                                  "whisper-base", (6, 512, 51865),
                                  80_117_760, 18))
    gc.collect()
    torch.cuda.empty_cache()
    where["phase"] = "(c) deepseek-v2-lite-16b training at 2 layers"
    row["deepseek_v2_lite_train"] = phase_train_model(
        torch, fa_ops, train, DSV2_TRAIN_ARGV,
        "deepseek-v2-lite-16b at 2 layers", (2, 2048, 102400),
        1_085_287_424, 2)
    row["deepseek_v2_lite_train"]["train_shape"] = mla_train_shape
    gc.collect()
    torch.cuda.empty_cache()
    where["phase"] = "(c) zamba2 one-group train step"
    # one group of depth: 6 Mamba2 layers and the shared block
    phase_train_step(
        torch, "zamba2-2.7b", 6,
        [(ssd_ops, "ssd", ssd_ops.ssd_plain),
         (attention, "flash_attention", fa_ref.flash_attention_blockwise)],
        {"ssd forward (3 kernels each)": (ssd_ops.ssd, "launches"),
         "ssd backward (4 kernels each)": (ssd_ops.ssd, "bwd_launches"),
         "flash_attention": (fa_ops.flash_attention, "launches")},
        {"ssd forward (3 kernels each)": 6,
         "ssd backward (4 kernels each)": 6, "flash_attention": 1})
    where["phase"] = "(c) zamba2-2.7b training"
    (ssd_row["launches"], ssd_row["launches_per_forward"]), \
        (zrow["launches"], zrow["launches_per_forward"]), \
        ssd_row["bwd_launches"], ssd_row["train_step_profile"] = phase_train(
            torch, ssd_ops, fa_ops, train)
    gc.collect()               # the zamba2 model and its moments go first
    torch.cuda.empty_cache()
    where["phase"] = "(b) wkv6 gradients"
    wkv_row.update(phase_wkv_grads(torch, wkv_ops, wkv_ref))
    where["phase"] = "(b) flash_attention gradients at gemma2's shape"
    row.update(phase_grads_gemma2(torch, fa_ops, fa_ref))
    where["phase"] = "(c) gemma2 two-layer train step"
    phase_train_step(
        torch, "gemma2-2b", 2,
        [(attention, "flash_attention", fa_ref.flash_attention_blockwise)],
        {"flash_attention": (fa_ops.flash_attention, "launches")},
        {"flash_attention": 2})
    where["phase"] = "(c) rwkv6 two-layer train step"
    phase_train_step(
        torch, "rwkv6-1.6b", 2, [(rwkv, "wkv6", wkv_ref.wkv6_chunked)],
        {"wkv6 (3 kernels each)": (wkv_ops.wkv6, "launches")},
        {"wkv6 (3 kernels each)": 2})
    where["phase"] = "(c) gemma2-2b training"
    keys, row["train_step_profile"] = phase_train_gemma2(torch, fa_ops, train)
    row.update(keys)
    where["phase"] = "(c) rwkv6-1.6b training"
    keys, wkv_row["train_step_profile"] = phase_train_rwkv6(torch, wkv_ops,
                                                            train)
    wkv_row.update(keys)
    where["phase"] = "(c) checkpoint on the card"
    phase_ckpt(torch, train)
    gc.collect()
    torch.cuda.empty_cache()
    # the dry-run cells run on the CPU beside the full-width resume, which
    # waits mostly on the disk
    where["phase"] = "(c) full-width checkpoint and resume, the dry-run cells"
    t0 = time.perf_counter()
    dryrun = start_dryrun()
    try:
        row["resume_full"] = phase_resume_full(torch, train)
    except BaseException:
        for p, _, _ in dryrun.values():
            p.kill()
            p.communicate()
        raise
    row["dryrun"] = phase_dryrun(dryrun)
    new_s["resume_full and the dry-run cells"] = time.perf_counter() - t0
    print(f"[c] new phases' seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items())
          + f"; total {sum(new_s.values()):.1f}s")
    where["phase"] = "(d) results"
    print(f"[d] total {time.perf_counter() - t_start:.1f}s")
    print(card_line())
    print(json.dumps({"kernels": [row, zrow, wrow, wkv_row, ssd_row,
                                  mm_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    """`run`, with every failure reported on stdout with its phase: a
    failed check (SystemExit with its message) or any exception (its type
    and message; the traceback goes to stderr)."""
    where = {"phase": "imports"}
    try:
        return run(where)
    except SystemExit as e:
        if e.code in (None, 0):
            raise
        why = e.code
    except Exception as e:   # noqa: BLE001 - reported, then exit 1
        traceback.print_exc()
        why = f"{type(e).__name__}: {e}"
    print(f"chip_smoke: FAILED in phase {where['phase']}: {why}", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
