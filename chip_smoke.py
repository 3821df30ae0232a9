#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  (a) card: name and power limit from nvidia-smi; build the kernel from
      src/repro_torch/csrc with nvcc, with seconds;
  (b) each kernel against its plain PyTorch version on the card, at the main
      path's shapes and a small ragged case, in bf16 and fp32: max-abs error
      against the stated tolerance, kernel / plain / library ms and the bound;
  (c) the main path: serve 4 requests of 4200-token prompts through
      full-width gemma2-2b (26 layers, random weights from a seed) with the
      launch counts set to 0 just before; every kernel of the path must have
      launched, and the prefill logits of the kernel path must agree with
      those of the plain path;
  (d) last lines: the card, a JSON line of per-kernel results, and
      {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, same sheet
H100_BYTES_S = 3.35e12       # HBM3 rate, same sheet
ARGV = ["--no-reduced", "--requests", "4", "--prompt-len", "4200",
        "--max-new", "16", "--device", "cuda"]
B, S, HQ, G, HD = 4, 4200, 16, 4, 256      # gemma2-2b prefill attention
SCALE, CAP = HD ** -0.5, 50.0              # 1/sqrt(query_pre_attn_scalar)
FP32_TOL = 1e-4       # fp32 output vs plain version: summation order only
BF16_ATOL = 1e-5      # bf16 output: one rounding of the fp32 result, see below
LOGIT_TOL = 0.15               # prefill logits, kernel path vs plain path


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


def phase_kernel(torch, fa_ops, fa_ref):
    """Kernel vs plain version; returns the row for the main-path case."""
    print("[b] flash_attention kernel vs plain blockwise version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = None
    cases = [(dt, B, S, HQ, G, HD, w, CAP) for dt in ("bfloat16", "float32")
             for w in (4096, S + 1)]
    cases += [(dt, 2, 203, 8, 2, hd, 50, CAP) for dt in ("bfloat16", "float32")
              for hd in (32, 256)]
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
            row = {"name": "flash_attention", "route": "cuda",
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
        del q, k, v, out, plain, plain32
        torch.cuda.empty_cache()
    return row


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
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch import serve
    from repro_torch.models import attention

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"[a] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices={torch.cuda.device_count()}")
    t_build = time.perf_counter()
    log = _build.build("flash_attention")
    print(f"[a] flash_attention built in {time.perf_counter() - t_build:.1f}s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[a] flash_attention: {line.strip()}")

    row = phase_kernel(torch, fa_ops, fa_ref)
    row["launches"] = phase_serve(torch, fa_ops, attention, fa_ref, serve)
    print(f"[d] total {time.perf_counter() - t_start:.1f}s")
    print(card_line())
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
