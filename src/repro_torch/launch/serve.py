"""Serving entry point: seeded generation requests answered in arrival order, in
batches of up to --requests, through prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \
        --requests 4 --prompt-len 4200 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --no-reduced --requests 4 --prompt-len 4200 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --no-reduced --requests 4 --prompt-len 4200 --max-new 16

Runs on the card unless --device cpu.  Weights are random, made from --seed
on the device, and cast to bf16 once at load, except the leaves the model
reads in fp32 (norms; rwkv's decay and bonus params; the Mamba2 layers'
A_log, dt_bias and D_skip).
Per-request latency runs from submit to reply.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.common import Options
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_step import greedy_generate, serving_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="tiny same-family config "
                    "(--no-reduced for full width)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    """Serve the requests; returns a dict with the model, its params, the
    prompts, the replies and the timings, for callers that check them."""
    args = parse_args(argv)
    if args.requests < 1 or args.prompt_len < 1 or args.max_new < 1:
        raise SystemExit("--requests, --prompt-len and --max-new must be >= 1")
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, Options(q_block=64, kv_block=64))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = serving_params(model, model.init(gen, device))

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(2, cfg.vocab_size, size=args.prompt_len)
               .astype(np.int32) for _ in range(args.requests)]
    t0 = time.perf_counter()
    submitted = [t0] * len(prompts)          # every request arrives at t0
    replies, latency, batches = [None] * len(prompts), [0.0] * len(prompts), []
    pending = list(range(len(prompts)))
    prefill_s = decode_s = 0.0
    while pending:
        idx, pending = pending[:args.requests], pending[args.requests:]
        toks = torch.from_numpy(np.stack([prompts[i] for i in idx])).to(device)
        timings: dict = {}
        out = greedy_generate(model, params, {"tokens": toks}, args.max_new,
                              args.prompt_len + args.max_new + 1, timings)
        out = out.cpu().numpy()
        done_t = time.perf_counter()
        if out.shape != (len(idx), args.max_new):
            raise RuntimeError(f"batch answered with shape {out.shape}")
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            raise RuntimeError("token outside [0, vocab_size)")
        for i, row in zip(idx, out):
            replies[i] = row
            latency[i] = done_t - submitted[i]
        batches.append(len(idx))
        prefill_s += timings["prefill_s"]
        decode_s += timings["decode_s"]

    lat_ms = np.asarray(latency) * 1e3
    p50, p95, p99 = np.percentile(lat_ms, [50, 95, 99])
    decode_tokens = (args.max_new - 1) * len(batches)
    print(f"[serve] all {len(replies)} requests served in "
          f"{time.perf_counter() - t0:.1f}s; batches={len(batches)} "
          f"mean_batch={np.mean(batches):.1f}")
    print(f"[serve] latency ms: p50={p50:.1f} p95={p95:.1f} p99={p99:.1f}")
    print(f"[serve] prefill ms={prefill_s * 1e3:.1f} decode ms/token="
          f"{decode_s * 1e3 / max(decode_tokens, 1):.2f} on {device}")
    return {"model": model, "params": params, "prompts": prompts,
            "replies": replies, "latency_ms": lat_ms.tolist(),
            "batches": batches, "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_steps": decode_tokens}


if __name__ == "__main__":
    main()
