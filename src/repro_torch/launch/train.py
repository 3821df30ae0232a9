"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --no-reduced --steps 6 --global-batch 2 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --reduced --steps 3 --global-batch 2 --seq 32 --device cpu

The flags and `build` of the JAX package's `launch/train.py`; runs on the
card unless --device cpu.
Weights are random, made from --seed on the device; batches come from the
synthetic pipeline.  Each step prints loss, grad norm, step ms (forward,
backward, optimizer) and tokens/s; the run ends with the peak device
memory.  Checkpointing (--ckpt-dir, --resume) and --remat are not ported
yet and raise.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.models.common import Options, param_count
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import init_opt
from repro_torch.runtime.train_step import make_train_step


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.d_model:
        cfg = cfg.replace(d_model=args.d_model,
                          d_ff=args.d_ff or 4 * args.d_model,
                          head_dim=max(32, args.d_model // cfg.n_heads))
    opts = Options(q_block=min(512, args.seq), kv_block=min(512, args.seq))
    model = build_model(cfg, opts)
    rc = RunConfig(remat=args.remat, microbatches=args.microbatches,
                   lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                   total_steps=args.steps, seed=args.seed)
    return cfg, model, rc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False, help="tiny same-family config")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def main(argv=None):
    """Train; returns a dict with the model, params, optimizer state, run
    config, per-step records and losses, for callers that check them."""
    args = parse_args(argv)
    if args.ckpt_dir or args.resume:
        raise NotImplementedError("checkpointing is not ported yet "
                                  "(ROADMAP Queue 1, checkpoint/ckpt.py)")
    if args.remat != "none":
        raise NotImplementedError("--remat is not ported yet (ROADMAP "
                                  "Queue 1, maybe_remat)")
    device = torch.device(args.device)
    cfg, model, rc = build(args)
    gen = torch.Generator(device=device).manual_seed(rc.seed)
    params = model.init(gen, device)
    opt_state = init_opt(params, rc)
    print(f"[train] arch={cfg.name} params={param_count(params):,} "
          f"on {device}")

    pipe = Pipeline(cfg.vocab_size, args.seq, args.global_batch, seed=rc.seed)
    step_fn = make_train_step(model, rc)
    if args.metrics_out:
        Path(args.metrics_out).parent.mkdir(parents=True, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with (open(args.metrics_out, "a") if args.metrics_out
          else contextlib.nullcontext()) as logf:
        params, opt_state, records, losses = _train(
            args, step_fn, pipe, params, opt_state, device, logf)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if peak is not None:
        print(f"[train] peak device memory {peak / 1e9:.2f} GB")
    assert np.isfinite(losses).all(), "NaN/inf loss"
    if len(losses) > 10:
        assert np.mean(losses[-5:]) < np.mean(losses[:5]), \
            "loss did not decrease"
    print(f"[train] done: first {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return {"model": model, "params": params, "opt_state": opt_state,
            "rc": rc, "records": records, "losses": losses,
            "peak_bytes": peak}


def _train(args, step_fn, pipe, params, opt_state, device, logf):
    """The step loop.  Returns (params, opt_state, records, losses)."""
    tokens_per_step = args.global_batch * args.seq
    records, losses = [], []
    t_start = time.perf_counter()
    for i, batch in enumerate(pipe.batches(args.steps)):
        step = i + 1
        tb = to_device(batch, device)
        timings: dict = {}
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, tb, timings)
        loss = float(m["loss"])           # waits for the step
        step_s = time.perf_counter() - t0
        losses.append(loss)
        rec = {"step": step, "loss": loss,
               "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
               "step_ms": step_s * 1e3,
               "fwd_ms": timings["fwd_s"] * 1e3,
               "bwd_ms": timings["bwd_s"] * 1e3,
               "opt_ms": timings["opt_s"] * 1e3,
               "tokens_per_s": tokens_per_step / step_s,
               "wall_s": time.perf_counter() - t_start}
        records.append(rec)
        if logf:
            logf.write(json.dumps(rec) + "\n")
            logf.flush()
        print(f"[train] step {step} loss {loss:.4f} gnorm "
              f"{rec['grad_norm']:.3f} step_ms {rec['step_ms']:.1f} (fwd "
              f"{rec['fwd_ms']:.1f} bwd {rec['bwd_ms']:.1f} opt "
              f"{rec['opt_ms']:.1f}) tokens/s {rec['tokens_per_s']:.0f}")
    return params, opt_state, records, losses


if __name__ == "__main__":
    main()
