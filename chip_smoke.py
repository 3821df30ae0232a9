#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  (a) card: name and power limit from nvidia-smi; build every kernel from
      src/repro_torch/csrc, one nvcc per source, all started together, with
      each build's seconds and its register and spill lines;
  (b) each kernel against its plain PyTorch version on the card, at the main
      paths' shapes and small cases: flash attention in bf16 and fp32 (head
      dims 256, 80 and 32), the chunked WKV in fp32 (two decay regimes, an
      initial state), the chunked SSD in fp32 (the JAX sweep, slow and fast
      decay); error against the stated tolerance, kernel / plain / library
      ms and the bound; then the gradients through the flash and SSD ops
      against autograd through their plain versions, and the backward's ms;
  (c) the main paths, each with the launch counts set to 0 just before and
      read just after: serve 4 requests of 4200-token prompts through
      full-width gemma2-2b (26 layers) and through full-width rwkv6-1.6b (24
      layers), random weights from a seed; every kernel of the path must
      have launched once per layer and prefill batch, and the kernel path's
      prefill must agree with the plain path's.  Then zamba2-2.7b training:
      one fp32 train step at full width and one group of depth, kernel path
      against plain path (loss, grad norm, every gradient); then the full
      model (54 Mamba2 layers) trained 6 steps through launch.train at batch
      2 x 1024, with 54 SSD and 9 flash launches per forward, a finite,
      non-zero gradient on every leaf, and 4 more steps on one repeated
      batch whose loss must fall;
  (d) last lines: the card, a JSON line of per-kernel results (flash
      attention once per path), and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import functools
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, same sheet
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
# Gradients through a kernel op vs autograd through its plain version, fp32:
# the backward IS the plain version's autograd, recomputed from the same
# inputs, so only the cotangent path differs; max |diff| <= 1e-5 * max(1,
# max |plain grad|).
GRAD_TOL = 1e-5
# One fp32 train step at full width and one group of depth, kernel path vs
# plain path: the kernels' summation-order differences (~1e-6 relative) pass
# through 6 Mamba2 layers and the shared block and back.  Loss within 1e-5
# relative, grad norm within 1e-4 relative, each leaf's gradient within 1e-3
# of its largest |plain grad|; a wrong kernel or a dropped backward term is
# off by O(1).
STEP_LOSS_TOL, STEP_NORM_TOL, STEP_GRAD_TOL = 1e-5, 1e-4, 1e-3
REPEAT_LR = 1e-5     # the repeated-batch steps (see phase_train)


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


def build_all(_build, names):
    """One nvcc per source, all started together; each build's seconds and
    its -Xptxas -v register and spill lines."""
    def one(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        done = dict(zip(names, pool.map(one, names)))
    for name, (log, secs) in done.items():
        print(f"[a] {name} built in {secs:.1f}s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[a] {name}: {line.strip()}")


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


def phase_wkv(torch, wkv_ops, wkv_ref):
    """Chunked-WKV kernel vs plain version in fp32; returns the row for the
    main-path case (rwkv6-1.6b prefill, test-sweep inputs)."""
    print("[b] wkv6 kernel vs plain chunked version")
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
        del args, r, k, v, logw, y, st, py, ps
        torch.cuda.empty_cache()
    return row


def ssd_bound(b, s, h, hd, n, q, itemsize=4):
    """Least time for the chunked SSD, from counts of what the function
    needs: C.B^T over the lower triangle j <= t once per (b, chunk), since
    with one group B and C are shared by every head (the Pallas kernel
    computes it once for all heads); per (b, h, chunk) the cumsum, the
    decay exps and M over j <= t, M.x, C.S and its scaling, the state
    update.  fp32 FLOPs at the fp32 rate, exps at the exp rate; x, dA, B
    and C read once, Y written once.  Returns (ms, bound_by, exps, flops,
    bytes)."""
    pairs, chunks = q * (q + 1) // 2, (s // q) * b
    nblk = chunks * h
    exps = nblk * (pairs + 2 * q)
    flops = chunks * pairs * n * 2 + nblk * (
        q + pairs * 2 + pairs * hd * 2 + q * n * hd * 2 + q * hd * 2
        + q * hd + q * hd * n * 2 + hd * n * 2)
    nbytes = itemsize * (2 * b * s * h * hd + b * s * h + 2 * b * s * n)
    t_ops = max(exps / H100_EXP_S, flops / H100_FP32_FLOPS)
    t_bytes = nbytes / H100_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", exps, flops,
            nbytes)


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


def phase_ssd(torch, ssd_ops, ssd_ref):
    """Chunked-SSD kernel vs plain version in fp32; returns the row for the
    main-path case (zamba2-2.7b training, test-sweep inputs)."""
    print("[b] mamba2_ssd kernel vs plain chunked version")
    gen = torch.Generator(device="cuda").manual_seed(2)
    row = None
    cases = [("main", SSD_MAIN, "sweep"), ("main slow decay", SSD_MAIN, "slow"),
             ("main fast decay", SSD_MAIN, "fast")]
    cases += [("JAX sweep", (b, s, h, hd, n, q), "sweep")
              for b, s, h, hd, n in [(2, 128, 8, 16, 16), (1, 64, 4, 32, 8)]
              for q in (16, 32)]
    for name, (b, s, h, hd, n, q), decay in cases:
        args = ssd_inputs(torch, gen, b, s, h, hd, n, decay)
        y = ssd_ops.ssd(*args, chunk=q)
        plain, _ = ssd_ref.ssd_chunked(*args, chunk=q)
        torch.cuda.synchronize()
        err = float((y - plain).abs().max())
        lim = SSD_TOL * max(1.0, float(plain.abs().max()))
        ok = err <= lim and bool(torch.isfinite(y).all())
        is_main = (b, s, h, hd, n, q) == SSD_MAIN
        ms = cuda_ms(lambda: ssd_ops.ssd(*args, chunk=q), 10 if is_main else 20)
        plain_ms = cuda_ms(lambda: ssd_ref.ssd_chunked(*args, chunk=q),
                           3 if is_main else 5)
        bound_ms, bound_by, exps, flops, nbytes = ssd_bound(b, s, h, hd, n, q)
        print(f"[b] mamba2_ssd {name}: (B,S,H,hd,N)={(b, s, h, hd, n)} Q={q}:"
              f" max_abs_err={err:.3e} (tol {lim:.3e}) kernel_ms={ms:.4f}"
              f" plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by};"
              f" {exps:.3e} exp, {flops:.3e} FLOP, {nbytes:.3e} B)"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"mamba2_ssd disagrees with its plain version: "
                             f"{name} {(b, s, h, hd, n, q)} {err} > {lim}")
        if is_main and decay == "sweep":
            row = {"name": "mamba2_ssd", "path": "zamba2-2.7b train",
                   "route": "cuda", "source": "src/repro_torch/csrc/mamba2_ssd.cu",
                   "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:17",
                   "launches": None, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by,
                   # no single PyTorch call computes the chunked SSD
                   "library_ms": None}
        del args, y, plain
        torch.cuda.empty_cache()
    return row


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


def phase_grads(torch, fa_ops, fa_ref, ssd_ops, ssd_ref):
    """Gradients through the flash and SSD ops at zamba2's training shapes,
    fp32, against autograd through the plain versions; the backward ms per
    layer in the types training runs (SSD fp32, attention bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, h, hd, n, q = SSD_MAIN
    ins = ssd_inputs(torch, gen, b, s, h, hd, n, "sweep")
    g = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    _, ssd_bwd = grad_check(
        torch, f"mamba2_ssd fp32 {SSD_MAIN[:5]} Q={q}",
        lambda *a: ssd_ops.ssd(*a, chunk=q),
        lambda *a: ssd_ref.ssd_chunked(*a, chunk=q)[0], ins, g)
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
    del ins, qkv, out
    torch.cuda.empty_cache()
    return ssd_bwd, fa_bwd


def phase_kernel(torch, fa_ops, fa_ref):
    """Kernel vs plain version; returns the rows for the two main paths'
    cases (gemma2-2b serving, zamba2-2.7b training)."""
    print("[b] flash_attention kernel vs plain blockwise version")
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
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version: {dt} window={window} {check}")
        if main_shape and dt == "bfloat16" and window == S + 1:
            row = {"name": "flash_attention", "path": "gemma2-2b serve",
                   "route": "cuda",
                   "source": "src/repro_torch/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
                   "launches": None, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
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
                    "bound_by": bound_by, "library_ms": sdpa_ms}
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
    logits and states."""
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
    print(f"[c] wkv6 launches={launches} "
          f"(want {cfg.n_layers} layers x {len(res['batches'])} batches)")
    if launches != want:
        raise SystemExit(f"wkv6 kernel launched {launches} times, want {want}")
    if len(res["replies"]) != 4:
        raise SystemExit("not every request was answered")
    for row in res["replies"]:
        if row.shape != (16,) or row.min() < 0 or row.max() >= cfg.vocab_size:
            raise SystemExit(f"bad reply {row}")

    toks = torch.as_tensor(np.stack(res["prompts"]), device="cuda").long()
    V = cfg.vocab_size
    results = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            lg_kernel, st_kernel = model.forward(
                params, {"tokens": toks}, mode="prefill", dtype=dtype)
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

    ssd_ops.ssd.launches = fa_ops.flash_attention.launches = 0
    (lk, _), gk = value_and_grad(loss_fn, params, batch)
    launches = (ssd_ops.ssd.launches, fa_ops.flash_attention.launches)
    with mock.patch.object(ssd_ops, "ssd", ssd_ops.ssd_plain), \
            mock.patch.object(attention, "flash_attention",
                              fa_ref.flash_attention_blockwise):
        (lp, _), gp = value_and_grad(loss_fn, params, batch)
    if (ssd_ops.ssd.launches, fa_ops.flash_attention.launches) != launches:
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
          f"train step, kernel vs plain path: launches (ssd, flash)="
          f"{launches}; loss {float(lk):.6f} vs {float(lp):.6f} (rel "
          f"{loss_rel:.2e}, tol {STEP_LOSS_TOL:.0e}); grad norm {nk:.6f} vs "
          f"{np_:.6f} (rel {norm_rel:.2e}, tol {STEP_NORM_TOL:.0e}); worst "
          f"leaf max|diff|/max|plain| {worst:.2e} (tol {STEP_GRAD_TOL:.0e}) "
          f"over {len(list(leaf_items(gk)))} leaves")
    if launches != (6, 1):
        raise SystemExit(f"launches {launches}, want 6 SSD and 1 flash")
    if loss_rel > STEP_LOSS_TOL or norm_rel > STEP_NORM_TOL or bad:
        raise SystemExit(f"kernel-path train step disagrees: {bad}")
    del params, gk, gp


def phase_train(torch, ssd_ops, fa_ops, train):
    """Full-width zamba2-2.7b through `launch.train.main`, then gradient
    and repeated-batch checks.  Returns the launches of the run and per
    forward: ((ssd, per forward), (flash, per forward))."""
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.models.common import param_count, tree_leaves
    from repro_torch.runtime.train_step import (make_loss_fn, make_train_step,
                                                value_and_grad)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ssd_ops.ssd.launches = fa_ops.flash_attention.launches = 0
    res = train.main(TRAIN_ARGV)
    n_ssd, n_fa = ssd_ops.ssd.launches, fa_ops.flash_attention.launches
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
    print(f"[c] launches per forward: mamba2_ssd {n_ssd / steps:g}, "
          f"flash_attention {n_fa / steps:g} (want 54 and 9; totals "
          f"{n_ssd}, {n_fa})")
    if n_params != 2_501_316_000:
        raise SystemExit(f"param count {n_params}")
    if (n_ssd, n_fa) != (54 * steps, 9 * steps):
        raise SystemExit(f"launches {n_ssd}, {n_fa} over {steps} steps")
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
    rep = []
    for _ in range(4):
        params, opt_state, m = step_fn(params, opt_state, batch)
        rep.append(float(m["loss"]))
    print(f"[c] repeated batch, 4 steps at lr {REPEAT_LR:g}, warmup 0, "
          f"fresh moments: losses "
          f"{[round(x, 4) for x in rep]}")
    if not (np.isfinite(rep).all() and rep[-1] < rep[0]):
        raise SystemExit("the repeated batch's loss did not fall")
    return (n_ssd, n_ssd // steps), (n_fa, n_fa // steps)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
    from repro_torch.launch import serve, train
    from repro_torch.models import attention, rwkv

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"[a] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices={torch.cuda.device_count()}")
    build_all(_build, ("flash_attention", "wkv6", "mamba2_ssd"))

    row, zrow = phase_kernel(torch, fa_ops, fa_ref)
    wkv_row = phase_wkv(torch, wkv_ops, wkv_ref)
    ssd_row = phase_ssd(torch, ssd_ops, ssd_ref)
    ssd_row["bwd_ms"], zrow["bwd_ms"] = phase_grads(torch, fa_ops, fa_ref,
                                                    ssd_ops, ssd_ref)
    # "launches": the count over the path's run (a serve: its prefill
    # batches; training: its steps); "launches_per_forward": per prefill
    # batch or training forward
    row["launches"], row["launches_per_forward"] = phase_serve(
        torch, fa_ops, attention, fa_ref, serve)
    wkv_row["launches"], wkv_row["launches_per_forward"] = phase_serve_rwkv(
        torch, wkv_ops, rwkv, wkv_ref, serve)
    phase_train_step(torch, ssd_ops, fa_ops, fa_ref, attention)
    (ssd_row["launches"], ssd_row["launches_per_forward"]), \
        (zrow["launches"], zrow["launches_per_forward"]) = phase_train(
            torch, ssd_ops, fa_ops, train)
    print(f"[d] total {time.perf_counter() - t_start:.1f}s")
    print(card_line())
    print(json.dumps({"kernels": [row, zrow, wkv_row, ssd_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
