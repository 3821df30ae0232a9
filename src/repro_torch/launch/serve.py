"""Continuous-serving driver: seeded generation requests through the futures
client's resident engine and METG-batching frontend, each batch a prefill
and greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \
        --requests 4 --prompt-len 4200 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --no-reduced --requests 4 --prompt-len 4200 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --no-reduced --requests 4 --prompt-len 4200 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --no-reduced --requests 4 \
        --prompt-len 4200 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --no-reduced --requests 4 --prompt-len 432 --max-new 16

The session rides the same front door as the JAX package's driver
(`repro_torch.client.Client`): `client.serve(execute_batch)` attaches a
bounded-admission `Frontend` that coalesces requests into engine tasks
sized by the METG model for the live worker count, or by the --max-wait-ms
deadline, and the resident engine runs each batch on its worker.  Per-request
p50/p95/p99 latency comes from the trace.  Any request that fails or times
out stops the driver.

Runs on the card unless --device cpu.  Weights are random, made from --seed
on the device, each matrix cast to bf16 as soon as it is drawn, except the
leaves the model reads in fp32 (norms; the MoE router; rwkv's decay and
bonus params; the Mamba2 layers' A_log, dt_bias and D_skip).  A text prompt
of an M-RoPE model (qwen2-vl-2b) carries its positions on all 3 streams; a
batch of an audio model (whisper-base) carries zero encoder frames (B,
n_frames, d_model) in bf16, as the JAX package's driver gives them.
--probs-bf16 rounds the attention probabilities to V's type before P.V
(`Options.probs_bf16`, the flash kernel's flag), where the model family
reads it (transformer, MLA, zamba2).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.client import Client
from repro_torch.configs import get_config
from repro_torch.core.engine import BATCH_FORMED
from repro_torch.models.common import Options
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_step import (greedy_generate,
                                            init_serving_params)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="tiny same-family config "
                    "(--no-reduced for full width)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="frontend deadline before a partial batch ships")
    ap.add_argument("--stats-port", type=int, default=None,
                    help="serve /stats, /health, /metrics on this port "
                         "while requests run (0 = ephemeral; see "
                         "python -m repro_torch.core.obs.top)")
    ap.add_argument("--trace-out", default=None,
                    help="write the session as a Perfetto-loadable "
                         "Chrome trace (.trace.json) at exit")
    ap.add_argument("--probs-bf16", action="store_true",
                    help="round the attention probabilities to V's type "
                         "before P.V (Options.probs_bf16)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    """Serve the requests; returns a dict with the model, its params, the
    prompts, the replies, the batches the frontend formed, the timings,
    the backend's stats and the session's `TraceRecorder`, for callers
    that check them."""
    args = parse_args(argv)
    if args.requests < 1 or args.prompt_len < 1 or args.max_new < 1:
        raise SystemExit("--requests, --prompt-len and --max-new must be >= 1")
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, Options(q_block=64, kv_block=64, moe_group=64,
                                     probs_bf16=args.probs_bf16))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_serving_params(model, gen, device)
    totals = {"prefill_s": 0.0, "decode_s": 0.0}

    def execute_batch(prompts):
        """One engine task: prefill + greedy decode of the batch, on the
        engine's worker thread."""
        toks = torch.from_numpy(np.stack(prompts)).to(device)
        batch = {"tokens": toks}
        if cfg.mrope:
            B, S = toks.shape
            batch["mrope_positions"] = torch.arange(
                S, device=device).expand(3, B, S)
        if cfg.family == "audio":
            batch["encoder_frames"] = torch.zeros(
                (toks.shape[0], cfg.encoder.n_frames, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        timings: dict = {}
        out = greedy_generate(model, params, batch, args.max_new,
                              args.prompt_len + args.max_new + 1, timings)
        out = out.cpu().numpy()
        if out.shape != (len(prompts), args.max_new):
            raise RuntimeError(f"batch answered with shape {out.shape}")
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            raise RuntimeError("token outside [0, vocab_size)")
        totals["prefill_s"] += timings["prefill_s"]
        totals["decode_s"] += timings["decode_s"]
        return list(out)

    client = Client(scheduler="dwork", workers=args.workers,
                    lease_timeout=120.0)
    try:
        if args.stats_port is not None:
            srv = client.stats_server(port=args.stats_port)
            print(f"[serve] live stats at {srv.url}/stats "
                  f"(/health, /metrics; dashboard: python -m "
                  f"repro_torch.core.obs.top --url {srv.url})", flush=True)
        frontend = client.serve(execute_batch,
                                max_queue=max(args.requests, 16),
                                max_batch=max(args.requests, 1),
                                max_wait_s=args.max_wait_ms * 1e-3,
                                per_request_s0=0.05)
        print(f"[serve] METG batch target for {args.workers} worker(s): "
              f"{frontend.target_batch()}")
        rng = np.random.default_rng(args.seed)
        prompts = [rng.integers(2, cfg.vocab_size, size=args.prompt_len)
                   .astype(np.int32) for _ in range(args.requests)]
        t0 = time.perf_counter()
        reqs = [frontend.submit(p) for p in prompts]
        for r in reqs:
            if not r.wait(600.0):
                raise RuntimeError(f"request {r.name} never completed")
            if not r.ok:
                raise RuntimeError(f"request {r.name} failed: {r.error}")
    finally:
        report = client.close()
    wall = time.perf_counter() - t0
    if args.trace_out:
        report.trace.to_chrome_trace(args.trace_out)
        print(f"[serve] Chrome trace written to {args.trace_out} "
              f"(open in https://ui.perfetto.dev)")
    lat = report.trace.latency_report()
    batches = [e.extra["size"] for e in report.trace.of(BATCH_FORMED)]
    decode_tokens = (args.max_new - 1) * len(batches)
    print(f"[serve] all {len(reqs)} requests served in {wall:.1f}s; "
          f"batches={lat.n_batches} mean_batch={lat.mean_batch:.1f}")
    print(f"[serve] latency ms: p50={lat.p50_s * 1e3:.1f} "
          f"p95={lat.p95_s * 1e3:.1f} p99={lat.p99_s * 1e3:.1f}")
    print(f"[serve] prefill ms={totals['prefill_s'] * 1e3:.1f} decode "
          f"ms/token={totals['decode_s'] * 1e3 / max(decode_tokens, 1):.2f} "
          f"on {device}")
    print(f"[serve] server stats: {report.backend_stats}")
    return {"model": model, "params": params, "prompts": prompts,
            "replies": [r.value for r in reqs],
            "latency_ms": [r.latency_s * 1e3 for r in reqs],
            "batches": batches, "prefill_s": totals["prefill_s"],
            "decode_s": totals["decode_s"], "decode_steps": decode_tokens,
            "latency_pct_ms": [lat.p50_s * 1e3, lat.p95_s * 1e3,
                               lat.p99_s * 1e3],
            "backend_stats": report.backend_stats, "trace": report.trace}


if __name__ == "__main__":
    main()
