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
      dims 256, 80 and 32), the chunked WKV in fp32 (two decay regimes, an
      initial state; at the main shape its three stages' scratch after the
      scan over the chunks against the plain stages, two runs bit for bit,
      each stage's ms, the scratch bytes, registers and spills), the chunked
      SSD forward in fp32 (three chunk-parallel stages and a scan over the
      chunks, the products in 3xTF32 on the tensor cores; Y and the final
      state against the plain version in fp32 and fp64, in three decays,
      the JAX sweep and from initial states; at the main shape its stage-2
      states against the plain stages and bit for bit against the
      backward's, two runs bit for bit, each stage's ms, registers and
      spills, both bounds and the design's bytes), A^T B in fp32 and bf16
      (the JAX sweep, a ragged shape, the
      METG ladder); error against the stated tolerance, kernel / plain /
      library ms and the bound, and the kernel and tiling each case took
      (bf16 flash and A^T B: the tensor cores), held equal to what the
      launchers' `route` / `plan` state; the gemma2 row's library call is
      torch.compile(flex_attention) with its softcap and band, the zamba2
      row's SDPA; then the SSD backward kernels (three chunk-parallel
      stages and the sum over head groups, the products in 3xTF32 on the
      tensor cores) against autograd through the plain version and against
      the plain backward `ssd_chunked_bwd` (fp32 at the main shape in three
      decays and the JAX sweep, bf16 to one rounding), the states after
      their scan over the chunks against the plain stages, two runs bit for
      bit, its ms and each stage's, both bounds (fp32 rate; products at
      the TF32 rate), each product's route, beside the recompute's ms
      (autograd of the plain version, the op's backward before it had a
      kernel); the gradients through the flash op against autograd through
      its plain version, and its backward's ms;
  (c) the main paths, each with the launch counts set to 0 just before and
      read just after: the paper's dwork scheduler running the METG ladder
      of A^T B tasks (launch.metg: n = 256 ... 4096, backlogs of up to
      20,000 tasks and a gather task each, through Client.run_loop and
      OverlapClient), with every task completed without error and one
      kernel launch per task besides the launches made without the
      scheduler; serve 4 requests of 4200-token prompts through
      full-width gemma2-2b (26 layers) and through full-width rwkv6-1.6b (24
      layers), random weights from a seed; every kernel of the path must
      have launched once per layer and prefill batch, and the kernel path's
      prefill must agree with the plain path's.  Then zamba2-2.7b training:
      one fp32 train step at full width and one group of depth, kernel path
      against plain path (loss, grad norm, every gradient; 6 SSD forward and
      6 backward op calls); then the full model (54 Mamba2 layers) trained 6
      steps through launch.train at batch 2 x 1024, with 54 SSD forward
      (3 kernels each) and 54 backward (4 kernels each) op calls and 9 flash
      launches per step, a finite, non-zero
      gradient on every leaf, and 4 more steps on one repeated batch whose
      loss must fall;
  (d) last lines: the card, a JSON line of per-kernel results (flash
      attention once per path; A^T B at the ladder's top, with every shape
      it was held at; the WKV row with its stages' ms, scratch bytes,
      registers and spills; the SSD row with its forward's fwd_* keys,
      stage ms, TF32-rate bound, design bytes, registers and spills, and
      its backward's bwd_* keys: ms, stage ms, both bounds, routes,
      registers and spills), and
      {"ok": true, "device": {...}}.
Every exit with a non-zero code prints its reason on stdout: no card, a
failed import (as when the script stands alone, without src/), a failed
check or any exception, with the phase it happened in.
"""
from __future__ import annotations

import functools
import gc
import json
import shutil
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, same sheet
H100_TF32_FLOPS = 495e12     # dense TF32 on the tensor cores, same sheet
H100_BYTES_S = 3.35e12       # HBM3 rate, same sheet
# exp issue rate: 16 results per clock per SM for the special-function unit's
# base-2 exponential, which expf runs once (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), x 132 SMs x
# 1.98 GHz maximum boost clock (H100 SXM data sheet)
H100_EXP_S = 16 * 132 * 1.98e9
ARGV = ["--no-reduced", "--requests", "4", "--prompt-len", "4200",
        "--max-new", "16", "--device", "cuda"]
B, S, HQ, G, HD = 4, 4200, 16, 4, 256      # gemma2-2b prefill attention
SCALE, CAP = HD ** -0.5, 50.0              # 1/sqrt(query_pre_attn_scalar)
FP32_TOL = 1e-4       # fp32 output vs plain version: summation order only
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
REPEAT_LR = 1e-5     # the repeated-batch steps (see phase_train)
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


def attention_bound(b, s, hq, g, hd, window, itemsize, flops_peak):
    """Least time for the function: allowed (q, k) pairs x 4*hd FLOPs, and
    q, k, v read once plus o written once."""
    w = window or s + 1
    pairs = sum(min(i + 1, w) for i in range(s)) * b * hq
    flops = 4.0 * hd * pairs
    nbytes = itemsize * (2 * b * s * hq * hd + 2 * b * s * g * hd)
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
    pairs, n = q * (q - 1) // 2, (s // q) * b * h
    exps = n * (pairs * hd + (q - 1) * hd + q * hd + hd)
    flops = n * (q * hd + pairs * hd * 4 + pairs * hd * 2 + q * hd * 5
                 + (q - 1) * hd + q * hd * 2 + q * hd * hd * 2
                 + hd * hd * 2 + q * hd * hd * 2)
    nbytes = 4 * (5 * b * s * h * hd + h * hd
                  + (2 if with_state else 1) * b * h * hd * hd)
    t_ops = max(exps / H100_EXP_S, flops / H100_FP32_FLOPS)
    t_bytes = nbytes / H100_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", exps, flops,
            nbytes)


def phase_wkv(torch, wkv_ops, wkv_ref, wkv_kernel, regs):
    """Chunked-WKV kernels vs plain version in fp32, y and the final state
    within WKV_TOL.  At the main shape also the scratch after stage 2 (the
    state entering each chunk) against the plain stages 1 and 2 within
    WKV_TOL, a second run the same bits, each stage's ms (torch.profiler),
    the scratch bytes and each stage's registers and spills (`regs`: the
    build's entries for wkv6).  Returns the row for the main-path case
    (rwkv6-1.6b prefill, test-sweep inputs)."""
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
             ("initial state", (2, 256, 4, 64, 64), "sweep", True)]
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
        ms = cuda_ms(lambda: wkv_ops.wkv6(*args, chunk=q, initial_state=s0),
                     5 if is_main else 20)
        plain_ms = cuda_ms(lambda: wkv_ref.wkv6_chunked(
            *args, chunk=q, initial_state=s0), 1 if is_main else 5)
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


def ssd_bound(b, s, h, hd, n, q, itemsize=4, with_state=False):
    """Least time for the chunked SSD, from counts of what the function
    needs: C.B^T over the lower triangle j <= t once per (b, chunk), since
    with one group B and C are shared by every head (the Pallas kernel
    computes it once for all heads); per (b, h, chunk) the cumsum, the
    decay exps and M over j <= t, M.x, C.S and its scaling, the state
    update.  x, dA, B and C (and the initial state) read once, Y (and the
    final state) written once.  Two bounds: every FLOP at the fp32 rate;
    and the products (C.B^T, M.x, C.S, the state update) as 3xTF32 on the
    tensor cores, three TF32 products each at the TF32 rate, beside the
    rest at the fp32 rate (the two units run at once, so the larger).  Exps
    at the exp rate.  Returns (ms, bound_by, exps, flops, bytes, tc_ms)."""
    pairs, chunks = q * (q + 1) // 2, (s // q) * b
    nblk = chunks * h
    exps = nblk * (pairs + 2 * q)
    prod = chunks * pairs * n * 2 + nblk * (
        pairs * hd * 2 + q * n * hd * 2 + q * hd * n * 2)
    rest = nblk * (q + pairs * 2 + q * hd * 2 + q * hd + hd * n * 2)
    flops = prod + rest
    nbytes = (itemsize * (2 * b * s * h * hd + b * s * h + 2 * b * s * n)
              + (8 if with_state else 0) * b * h * hd * n)
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
    design's bytes.  Returns the row for the main-path case (zamba2-2.7b
    training, test-sweep inputs)."""
    print("[b] mamba2_ssd forward kernels vs plain chunked version; products: "
          + ", ".join(f"{k} {v}" for k, v in ssd_kernel.FWD_ROUTES.items()))
    gen = torch.Generator(device="cuda").manual_seed(2)
    row = None
    # (name, (B, S, H, hd, N, Q), decay, initial state)
    cases = [("main", SSD_MAIN, "sweep", False),
             ("main slow decay", SSD_MAIN, "slow", False),
             ("main fast decay", SSD_MAIN, "fast", False)]
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
        ms = cuda_ms(lambda: ssd_ops.ssd(*args, chunk=q), 10 if is_main else 20)
        plain_ms = cuda_ms(lambda: ssd_ref.ssd_chunked(*args, chunk=q),
                           3 if is_main else 5)
        bound_ms, bound_by, exps, flops, nbytes, tc_ms = ssd_bound(
            b, s, h, hd, n, q, with_state=with_state)
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
    pairs, chunks = q * (q + 1) // 2, (s // q) * b
    strict, nblk = q * (q - 1) // 2, chunks * h
    exps = nblk * (pairs + 2 * q)
    prod = chunks * pairs * n * 2 + nblk * (
        q * hd * n * 2 * 5 + pairs * hd * 2 * 2 + pairs * n * 2 * 2)
    rest = 2 * b * s * n * (h - 1) + nblk * (
        q + q * hd + hd * n * 2                         # cumsum, state walk
        + pairs * 3 + strict * 2                        # M, dG, P; sums
        + q * hd * 2                                    # dx
        + q * hd * 2 + q                                # R
        + q * n * 2                                     # dC
        + q * n * 2 + q                                 # inter-chunk term
        + q * n * 2                                     # dB
        + hd * n * 2                                    # <dS, S_in>
        + q * hd + hd * n * 2                           # dS update
        + q * 5)                                        # dcum, reverse cumsum
    flops = prod + rest
    nbytes = itemsize * (3 * b * s * h * hd + 2 * b * s * h + 4 * b * s * n)
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
    flops = 2.0 * k * m * n
    nbytes = itemsize * (k * m + k * n + m * n)
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
    the scheduler (warm-up, timing, the plain loop)."""
    gc.collect()
    torch.cuda.empty_cache()
    mm_ops.tiled_matmul.launches = 0
    t0 = time.perf_counter()
    res = metg.main(["--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = mm_ops.tiled_matmul.launches
    want, tasks = 0, 0
    for r in res["rows"]:
        for run in (r["loop"], r["overlap"]):
            st = run["stats"]
            if st["errors"] or st["completed"] != st["created"] \
                    or st["created"] != r["tasks"] + 1 or not run["gathered"]:
                raise SystemExit(f"dwork {run['client']} at n={r['n']}: {st}")
            tasks += run["matmul_tasks"]
        if r["launched"] != r["direct_launches"] + r["loop"]["matmul_tasks"] \
                + r["overlap"]["matmul_tasks"]:
            raise SystemExit(f"launch accounting at n={r['n']}: {r}")
        if r["checked"] == 0 or r["worst_err_over_tol"] > 1.0:
            raise SystemExit(f"sampled checks at n={r['n']}: {r['checked']} "
                             f"checked, worst/tol {r['worst_err_over_tol']}")
        want += r["launched"]
    print(f"[c] dwork METG ladder {[r['n'] for r in res['rows']]} in "
          f"{wall:.1f}s: {tasks} tasks run through the kernel, every server "
          f"completed == created with 0 errors and its gather done; "
          f"tiled_matmul launches={launches} (want {want}: the tasks plus "
          f"{want - tasks} launches without the scheduler)")
    if launches != want:
        raise SystemExit(f"tiled_matmul launched {launches} times, want {want}")
    return launches


def grad_check(torch, name, kernel_fn, plain_fn, ins, g):
    """Gradients of sum(out * g) through the kernel op against autograd
    through the plain version on the same inputs; then the kernel op's
    backward ms (recompute and its autograd).  Returns (max rel err, ms)."""
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    out = kernel_fn(*a)
    ga = torch.autograd.grad(out, a, g, retain_graph=True)
    gb = torch.autograd.grad(plain_fn(*b), b, g)
    errs = [float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
            for x, y in zip(ga, gb)]
    ok = max(errs) <= GRAD_TOL and all(bool(torch.isfinite(x).all())
                                       for x in ga)
    ms = cuda_ms(lambda: torch.autograd.grad(out, a, g, retain_graph=True), 3)
    print(f"[b] grad {name}: max|diff|/max(1, max|plain|) per input "
          f"{[float(f'{e:.3e}') for e in errs]} (tol {GRAD_TOL:.0e}) "
          f"backward_ms={ms:.2f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel-op gradients disagree with the "
                         f"plain version's autograd: {errs}")
    return max(errs), ms


def phase_grads(torch, fa_ops, fa_ref):
    """Gradients through the flash op at zamba2's training shape, fp32,
    against autograd through the plain version; the backward ms per layer
    in the type training runs (bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    kw = dict(scale=ZHD ** -0.5, q_block=512, kv_block=512)
    qkv = [torch.randn((ZB, ZS, ZH, ZHD), generator=gen, device="cuda")
           for _ in range(3)]
    g = torch.randn((ZB, ZS, ZH, ZHD), generator=gen, device="cuda")
    grad_check(torch, f"flash_attention fp32 {(ZB, ZS, ZH, ZHD)} causal",
               lambda *a: fa_ops.flash_attention(*a, **kw),
               lambda *a: fa_ref.flash_attention_blockwise(*a, **kw), qkv, g)
    qkv = [t.bfloat16().requires_grad_() for t in qkv]
    out = fa_ops.flash_attention(*qkv, **kw)
    fa_bwd = cuda_ms(lambda: torch.autograd.grad(out, qkv, g.bfloat16(),
                                                 retain_graph=True), 3)
    print(f"[b] flash_attention bf16 {(ZB, ZS, ZH, ZHD)} backward_ms="
          f"{fa_bwd:.2f} (recompute of the blockwise version, q/kv blocks 512)")
    del qkv, out
    torch.cuda.empty_cache()
    return fa_bwd


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
    cases (gemma2-2b serving, zamba2-2.7b training).  Each case prints the
    kernel and tiling it took, which must be the one `route` states (bf16:
    the tensor cores)."""
    from torch.nn.attention.flex_attention import flex_attention
    print("[b] flash_attention kernel vs plain blockwise version")
    flex = torch.compile(flex_attention)
    flex_compile_s = None
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = zrow = None
    cases = [(dt, B, S, HQ, G, HD, w, CAP) for dt in ("bfloat16", "float32")
             for w in (4096, S + 1)]
    cases += [(dt, ZB, ZS, ZH, ZH, ZHD, None, 0.0)
              for dt in ("bfloat16", "float32")]
    cases += [(dt, 2, 203, 8, 2, hd, 50, CAP) for dt in ("bfloat16", "float32")
              for hd in (32, 80, 256)]
    for dt, b, s, hq, g, hd, window, cap in cases:
        dtype = getattr(torch, dt)
        rt = fa_kernel.route(dtype, hd)
        if rt != fa_kernel.c_route(dtype, hd) or (rt.route == 1) != (
                dt == "bfloat16"):
            raise SystemExit(f"flash_attention route: {rt} stated, "
                             f"{fa_kernel.c_route(dtype, hd)} taken")
        q = torch.randn((b, s, hq, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, g, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, s, g, hd), generator=gen, device="cuda").to(dtype)
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
        ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw),
                     5 if main_shape else 20)
        plain_ms = cuda_ms(lambda: fa_ref.flash_attention_blockwise(
            q, k, v, **kw), 2 if main_shape else 5)
        bound_ms, bound_by, flops = attention_bound(
            b, s, hq, g, hd, window, q.element_size(),
            H100_BF16_FLOPS if dt == "bfloat16" else H100_FP32_FLOPS)
        print(f"[b] {dt:8s} q{(b, s, hq, hd)} kv{(b, s, g, hd)} window={window}"
              f" softcap={cap}: max_abs_err={err:.3e} {check}"
              f" kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}"
              f" bound_ms={bound_ms:.4f} ({bound_by}, {flops:.3e} FLOP)"
              f" [{rt.describe()}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version: {dt} window={window} {check}")
        if main_shape and dt == "bfloat16":
            if flex_compile_s is None:     # the first call compiles
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
        if (b, s, hq, g, hd) == (ZB, ZS, ZH, ZH, ZHD) and dt == "bfloat16":
            # SDPA computes exactly this function: causal, no window, no
            # softcap, one K/V head per query head
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = functools.partial(
                torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                is_causal=True, scale=hd ** -0.5)
            sdpa_err = float((sdpa().transpose(1, 2).float() - out.float())
                             .abs().max())
            sdpa_ms = cuda_ms(sdpa, 20)
            print(f"[b] zamba2 shape: sdpa_ms={sdpa_ms:.4f} max_abs_err vs "
                  f"sdpa={sdpa_err:.3e}")
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
    return row, zrow


def phase_serve(torch, fa_ops, attention, fa_ref, serve):
    """The main path at full width, then kernel-path vs plain-path logits."""
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    res = serve.main(ARGV)
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
    served = torch.as_tensor([r[0] for r in res["replies"]], device="cuda")
    same_served = (served == a.argmax(-1)) | ~sure
    print(f"[c] prefill last-position logits, kernel vs plain path: "
          f"max_abs_err={err:.4f} (tol {LOGIT_TOL}); |logit|max="
          f"{float(b.abs().max()):.3f}; top-2 margins="
          f"{[round(float(m), 4) for m in margin]}; first tokens compared "
          f"where margin > tol: {int(sure.sum())}/{len(sure)}")
    if err >= LOGIT_TOL or not bool(same.all()) or not bool(same_served.all()):
        raise SystemExit("kernel path and plain path disagree")
    return launches, launches // len(res["batches"])


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
    p50, p95, p99 = np.percentile(res["latency_ms"], [50, 95, 99])
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
    # the served first tokens are the bf16 kernel path's argmax
    a = results[torch.bfloat16][0]
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


def leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_items(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def phase_train_step(torch, ssd_ops, fa_ops, fa_ref, attention):
    """One fp32 train step's loss and gradients at full width and one group
    of depth (6 Mamba2 layers, one shared block), kernel path vs plain
    path, the same params and batch."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.launch.train import to_device
    from repro_torch.models.common import Options, softmax_xent
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime.train_step import value_and_grad

    cfg = get_config("zamba2-2.7b").replace(n_layers=6)
    model = build_model(cfg, Options(q_block=512, kv_block=512))
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    batch = to_device(next(Pipeline(cfg.vocab_size, ZS, ZB).batches(1)),
                      "cuda")

    def loss_fn(p, b):
        logits = model.forward(p, b, dtype=torch.float32)
        return softmax_xent(logits, b["labels"], cfg.vocab_size), {}

    ssd_ops.ssd.launches = ssd_ops.ssd.bwd_launches = 0
    fa_ops.flash_attention.launches = 0
    (lk, _), gk = value_and_grad(loss_fn, params, batch)
    launches = (ssd_ops.ssd.launches, ssd_ops.ssd.bwd_launches,
                fa_ops.flash_attention.launches)
    with mock.patch.object(ssd_ops, "ssd", ssd_ops.ssd_plain), \
            mock.patch.object(attention, "flash_attention",
                              fa_ref.flash_attention_blockwise):
        (lp, _), gp = value_and_grad(loss_fn, params, batch)
    if (ssd_ops.ssd.launches, ssd_ops.ssd.bwd_launches,
            fa_ops.flash_attention.launches) != launches:
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
    print(f"[c] zamba2 one group (6 Mamba2 layers + shared block), fp32 "
          f"train step, kernel vs plain path: op calls (ssd forward, 3 "
          f"kernels each; ssd backward, 4 each; flash)="
          f"{launches}; loss {float(lk):.6f} vs {float(lp):.6f} (rel "
          f"{loss_rel:.2e}, tol {STEP_LOSS_TOL:.0e}); grad norm {nk:.6f} vs "
          f"{np_:.6f} (rel {norm_rel:.2e}, tol {STEP_NORM_TOL:.0e}); worst "
          f"leaf max|diff|/max|plain| {worst:.2e} (tol {STEP_GRAD_TOL:.0e}) "
          f"over {len(list(leaf_items(gk)))} leaves")
    if launches != (6, 6, 1):
        raise SystemExit(f"launches {launches}, want 6 SSD forward, 6 SSD "
                         f"backward and 1 flash")
    if loss_rel > STEP_LOSS_TOL or norm_rel > STEP_NORM_TOL or bad:
        raise SystemExit(f"kernel-path train step disagrees: {bad}")
    del params, gk, gp


def phase_train(torch, ssd_ops, fa_ops, train):
    """Full-width zamba2-2.7b through `launch.train.main`, then gradient
    and repeated-batch checks, one of whose steps runs under the profiler.
    Returns the launches of the run and per forward: ((ssd, per forward),
    (flash, per forward), ssd backward, the profiled step's summary)."""
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.models.common import param_count, tree_leaves
    from repro_torch.runtime.train_step import (make_loss_fn, make_train_step,
                                                value_and_grad)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ssd_ops.ssd.launches = ssd_ops.ssd.bwd_launches = 0
    fa_ops.flash_attention.launches = 0
    res = train.main(TRAIN_ARGV)
    n_ssd, n_fa = ssd_ops.ssd.launches, fa_ops.flash_attention.launches
    n_bwd = ssd_ops.ssd.bwd_launches
    model, params, opt_state = res["model"], res["params"], res["opt_state"]
    cfg, steps = model.cfg, len(res["losses"])
    n_params = param_count(params)
    if (cfg.n_layers, cfg.d_model, cfg.vocab_size) != (54, 2560, 32000):
        raise SystemExit(f"not zamba2-2.7b at full width: {cfg}")
    print(f"[c] zamba2-2.7b trained {steps} steps at batch {ZB} x {ZS}: "
          f"params={n_params:,}; losses={[round(x, 4) for x in res['losses']]}"
          f"; peak max_memory_allocated_GB="
          f"{res['peak_bytes'] / 1e9:.2f}")
    for r in res["records"]:
        print(f"[c]   step {r['step']}: step_ms={r['step_ms']:.1f} fwd_ms="
              f"{r['fwd_ms']:.1f} bwd_ms={r['bwd_ms']:.1f} opt_ms="
              f"{r['opt_ms']:.1f} tokens_per_s={r['tokens_per_s']:.0f} "
              f"grad_norm={r['grad_norm']:.4f}")
    print(f"[c] op calls per step: mamba2_ssd {n_ssd / steps:g} forward (3 "
          f"kernels each) and {n_bwd / steps:g} backward (4 kernels each), "
          f"flash_attention {n_fa / steps:g} (want 54, 54 and 9; totals "
          f"{n_ssd}, {n_bwd}, {n_fa})")
    if n_params != 2_501_316_000:
        raise SystemExit(f"param count {n_params}")
    if (n_ssd, n_bwd, n_fa) != (54 * steps, 54 * steps, 9 * steps):
        raise SystemExit(f"launches {n_ssd}, {n_bwd}, {n_fa} over {steps} "
                         f"steps")
    if not np.isfinite(res["losses"]).all():
        raise SystemExit("non-finite training loss")

    # one repeated batch: every leaf's gradient, then 4 steps at warmup 0
    batch = train.to_device(next(Pipeline(cfg.vocab_size, ZS, ZB, seed=1)
                                 .batches(1)), "cuda")
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
    # lr 3e-4 the 2.5B-parameter model overshoots in its first steps.
    for t in (*tree_leaves(opt_state.m), *tree_leaves(opt_state.v)):
        t.zero_()
    opt_state = opt_state._replace(count=torch.zeros_like(opt_state.count))
    step_fn = make_train_step(model, res["rc"].replace(
        lr=REPEAT_LR, warmup_steps=0, total_steps=1000))
    rep, profiled, step_ms = [], None, None
    for i in range(4):
        if i == 2:   # one step under the profiler: where the device time goes
            params, opt_state, m, profiled = profiled_step(
                torch, step_fn, params, opt_state, batch, step_ms)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        rep.append(float(m["loss"]))
    print(f"[c] repeated batch, 4 steps at lr {REPEAT_LR:g}, warmup 0, "
          f"fresh moments: losses "
          f"{[round(x, 4) for x in rep]}")
    if not (np.isfinite(rep).all() and rep[-1] < rep[0]):
        raise SystemExit("the repeated batch's loss did not fall")
    return (n_ssd, n_ssd // steps), (n_fa, n_fa // steps), n_bwd, profiled


def profiled_step(torch, step_fn, params, opt_state, batch, step_ms,
                  top=10):
    """One train step under torch.profiler: its wall ms (host clock, the
    device synchronised, the profiler's own cost included), the device ms
    summed over the kernels, memory copies and sets it ran (one stream, so
    they do not overlap), the device's idle share of step_ms, the wall ms
    of the same step without the profiler, and the kernels that took the
    most device time with their launch counts.  Returns the step's outputs
    and that summary (device ms "not measured" where the profiler shows no
    device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt_state, m = step_fn(params, opt_state, batch)
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
        print(f"[c] profiled train step: wall_ms={wall_ms:.1f}; device time "
              f"not measured (the profiler shows none)")
        return params, opt_state, m, {"wall_ms": wall_ms,
                                      "device_ms": "not measured"}
    summary = {"wall_ms": wall_ms, "step_ms": step_ms,
               "device_ms": device_ms,
               "idle_share": 1.0 - device_ms / step_ms,
               "top": [{"kernel": k[:120], "ms": ms, "launches": n}
                       for ms, n, k in kernels[:top]]}
    print(f"[c] profiled train step: wall_ms={wall_ms:.1f} (profiler "
          f"included) device_ms={device_ms:.1f}; the step before it without "
          f"the profiler step_ms={step_ms:.1f}, idle_share="
          f"{summary['idle_share']:.3f}; most device time: " + "; ".join(
              f"{k[:70]} {ms:.1f} ms / {n}" for ms, n, k in kernels[:top]))
    return params, opt_state, m, summary


def run(where: dict) -> int:
    """Every phase in order; where["phase"] names the one running, for the
    failure line."""
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
    from repro_torch.models import attention, rwkv

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
    zrow["bwd_ms"] = phase_grads(torch, fa_ops, fa_ref)
    where["phase"] = "(b) tiled_matmul"
    mm_row = phase_matmul(torch, mm_ops, mm_ref, mm_kernel, metg)
    where["phase"] = "(c) dwork METG ladder"
    mm_row["launches"] = phase_metg(torch, mm_ops, metg)
    for r, lib in ((row, "flash_attention"), (zrow, "flash_attention"),
                   (mm_row, "tiled_matmul")):
        r["sass_hgmma"] = builds[lib]
    # "launches": the count over the path's run (a serve: its prefill
    # batches; training: its steps); "launches_per_forward": per prefill
    # batch or training forward
    where["phase"] = "(c) gemma2-2b serve"
    row["launches"], row["launches_per_forward"] = phase_serve(
        torch, fa_ops, attention, fa_ref, serve)
    where["phase"] = "(c) rwkv6-1.6b serve"
    wkv_row["launches"], wkv_row["launches_per_forward"] = phase_serve_rwkv(
        torch, wkv_ops, rwkv, wkv_ref, serve)
    where["phase"] = "(c) zamba2 one-group train step"
    phase_train_step(torch, ssd_ops, fa_ops, fa_ref, attention)
    where["phase"] = "(c) zamba2-2.7b training"
    (ssd_row["launches"], ssd_row["launches_per_forward"]), \
        (zrow["launches"], zrow["launches_per_forward"]), \
        ssd_row["bwd_launches"], ssd_row["train_step_profile"] = phase_train(
            torch, ssd_ops, fa_ops, train)
    where["phase"] = "(d) results"
    print(f"[d] total {time.perf_counter() - t_start:.1f}s")
    print(card_line())
    print(json.dumps({"kernels": [row, zrow, wkv_row, ssd_row, mm_row]}))
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
