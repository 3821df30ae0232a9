"""A serving cell: requests through the program's front door
(`Client.serve` -> `core/serving.Frontend` -> the resident engine), each
engine batch one `runtime.serve_step.greedy_generate`, under a closed
loop of clients, for a measured window; then the served tokens of a sample
of the finished requests are judged against the plain reference."""
from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np
import torch

from bench.harness import traffic as tr
from bench.harness import weights
from bench.reference import lm

WAIT_S = 120.0      # past the window's close, a reply never comes
SAME_BATCH_S = 0.05  # the replies of one batch resolve within this
WARM_BATCHES = 2    # the first builds and loads the kernels, the second times


def port_config(config: dict):
    """The program's ModelConfig holding the configuration file's numbers."""
    from repro_torch.configs import get_config
    m = dict(config["model"])
    base = get_config(config["arch"])
    if m.pop("family") != base.family:
        raise ValueError("the file's family is not the program's")
    return base.replace(**m)


class Phases:
    """Logs the seconds each set-up phase took."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, what: str):
        now = time.perf_counter()
        log(f"[setup] {what}: {now - self.t:.3f} s")
        self.t = now


class Session:
    """The program set up for one cell and seed: model, weights, front door."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.client import Client
        from repro_torch.models.common import Options
        from repro_torch.models.model import build_model
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        t = cell.traffic
        self.S, self.new = t["prompt_len"], t["max_new"]
        clock = Phases()
        self.model = build_model(port_config(cell.config), Options())
        self.skeleton = weights.layout(self.model)
        clock("model and the serving leaf probe")
        self.closed = threading.Event()      # set when the window closes
        self.batches = []                    # one record a batch run
        self._lock = threading.Lock()
        self.reseed(seed)
        clock("weights drawn")
        self.client = Client(scheduler="dwork", workers=1,
                             lease_timeout=600.0)
        self.frontend = self.client.serve(
            self._execute, max_queue=max(64, t["clients"] * 2),
            max_batch=t["max_batch"], max_wait_s=t["max_wait_ms"] * 1e-3,
            per_request_s0=t["per_request_s0"], target_eff=t["target_eff"])
        clock("front door up")
        warm_prompts = tr.Prompts(seed, self.vocab, self.S)
        for i in range(WARM_BATCHES):
            # a full batch at a time, as the window's clients send them
            rs = [self.frontend.submit(warm_prompts.next(10_000 + j))
                  for j in range(i * t["max_batch"], (i + 1) * t["max_batch"])]
            for r in rs:
                if not r.wait(1200.0) or not r.ok:
                    raise RuntimeError(f"warm-up request failed: {r.error}")
            clock(f"warm-up batch {i + 1}")
        with self._lock:
            self.batches.clear()

    def reseed(self, seed: int):
        """Draw the weights of `seed` for a further window (the kernels and
        the front door stay as they are)."""
        self.seed, self.params = seed, None
        self.params = weights.make(self.skeleton, self.cell.config["init"],
                                   seed, self.device)
        self.closed.clear()
        with self._lock:
            self.batches.clear()

    @property
    def vocab(self) -> int:
        return self.cell.model["vocab_size"]

    def _execute(self, prompts):
        """One engine batch: prefill and greedy decode of the batch.  After
        the window closes a batch is answered with None, unrun."""
        if self.closed.is_set():
            return [None] * len(prompts)
        from repro_torch.runtime.serve_step import greedy_generate
        toks = torch.from_numpy(np.stack(prompts)).to(self.device)
        timings: dict = {}
        out = greedy_generate(self.model, self.params, {"tokens": toks},
                              self.new, self.S + self.new + 1, timings)
        out = out.cpu().numpy()
        with self._lock:
            self.batches.append({"b": len(prompts), "steps": self.new - 1,
                                 **timings})
        return list(out)

    # ------------------------------------------------------------------
    def run_window(self, seconds: float, on_open=None) -> dict:
        """Offer the mix's load for `seconds`: each client sends its next
        request when its reply arrives.  Returns the requests (submitted,
        done, ok, prompt, tokens) and the window's bounds."""
        prompts = tr.Prompts(self.seed, self.vocab, self.S)
        reqs, lock = [], threading.Lock()
        if on_open is not None:
            on_open()
        t0 = time.perf_counter()
        end = t0 + seconds

        def client(c):
            while time.perf_counter() < end:
                p = prompts.next(c)
                rec = {"sub": time.perf_counter(), "prompt": p}
                rec["req"] = r = self.frontend.submit(p)
                with lock:
                    reqs.append(rec)
                if not r.wait(WAIT_S):
                    return

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(self.cell.traffic["clients"])]
        for th in threads:
            th.start()
        while (d := end - time.perf_counter()) > 0:
            time.sleep(min(d, 0.05))
        self.closed.set()
        for th in threads:
            th.join()
        for rec in reqs:
            rec["req"].wait(WAIT_S)
        for rec in reqs:
            r = rec.pop("req")
            rec.update(done=r.t_done if r.done else None, ok=r.ok,
                       error=r.error, tokens=r.value)
        return {"requests": reqs, "t0": t0, "end": end}

    def close(self):
        self.client.close()

    def drop_program(self):
        """Free the program's weights and caches (the reference follows)."""
        self.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# End-to-end numbers
# ---------------------------------------------------------------------------


def close_of(win: dict) -> float:
    """The window closes with the last reply of the batch running at its
    nominal end (no later batch starts), so that the work it counts is
    whole batches.  The front door resolves a batch's replies in one loop,
    within SAME_BATCH_S; the next batch's come a prefill later."""
    after = sorted(r["done"] for r in win["requests"] if r["ok"]
                   and r["tokens"] is not None and r["done"] >= win["end"])
    if not after:
        return win["end"]
    return max(d for d in after if d <= after[0] + SAME_BATCH_S)


def finished(win: dict) -> list:
    """Requests answered inside the window, in the order they were sent."""
    close = close_of(win)
    return [r for r in sorted(win["requests"], key=lambda r: r["sub"])
            if r["ok"] and r["tokens"] is not None and r["done"] <= close]


def end_to_end(cell, win: dict) -> dict:
    """tokens_per_s, and the requests sent and failed: a reply that says
    the request failed, or none within WAIT_S of the close."""
    t = cell.traffic
    done = finished(win)
    return {"tokens_per_s": len(done) * (t["prompt_len"] + t["max_new"])
            / (close_of(win) - win["t0"]),
            "attempted": len(win["requests"]),
            "failed": sum(1 for r in win["requests"]
                          if r["done"] is None or not r["ok"])}


# ---------------------------------------------------------------------------
# Correctness
# ---------------------------------------------------------------------------


def sample(done: list, seed: int, k: int) -> list:
    """k of the finished requests, drawn from the seed (all when fewer)."""
    if len(done) <= k:
        return list(done)
    idx = tr.rng(seed, 4).choice(len(done), size=k, replace=False)
    return [done[i] for i in sorted(idx)]


def gaps(session: Session, picked: list, *, control: bool = False,
         group: int = 4) -> dict:
    """The widest gap by which a served token's logit lies below the
    reference's best, over the picked requests; with `control`, also the
    widest gap of the tokens that the fp8 reference puts first at the same
    positions.  The weights are drawn again from the seed."""
    cell, S, new = session.cell, session.S, session.new
    params = weights.make(session.skeleton, cell.config["init"],
                          session.seed, session.device)
    pos = list(range(S - 1, S + new - 1))
    widest, widest_ctl, n = 0.0, 0.0, 0
    for i in range(0, len(picked), group):
        part = picked[i:i + group]
        seqs = np.stack([np.concatenate([r["prompt"], r["tokens"][:-1]])
                         for r in part])
        toks = torch.from_numpy(seqs).to(session.device)
        served = torch.from_numpy(np.stack([r["tokens"] for r in part])
                                  ).to(session.device).long()
        ref = lm.logits_at(params, cell.model, toks, pos)
        best = ref.max(-1).values
        g = best - ref.gather(-1, served[..., None])[..., 0]
        widest = max(widest, float(g.max()))
        n += served.numel()
        if control:
            low = lm.logits_at(params, cell.model, toks, pos,
                               precision="fp8")
            pick = low.argmax(-1)
            gc = best - ref.gather(-1, pick[..., None])[..., 0]
            widest_ctl = max(widest_ctl, float(gc.max()))
        del ref
    out = {"max_logit_gap": widest, "tokens_compared": n}
    if control:
        out["control_max_logit_gap"] = widest_ctl
    return out


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float):
    """Set up, measure, judge.  Returns (result fields, the per-layer run
    record for the metric readers, the numbers compared)."""
    from repro_torch.core.engine import BATCH_FORMED
    from repro_torch.kernels.flash_attention.ops import flash_attention

    from bench.harness import trace as tracing
    sess = Session(cell, seed, device)
    launches0 = flash_attention.launches
    prof = []
    win = sess.run_window(seconds, on_open=(
        (lambda: prof.append(tracing.start())) if traced else None))
    span_end = win["end"]
    tr_obj = None
    if prof:
        if sess.device.type == "cuda":
            torch.cuda.synchronize()
        span_end = time.perf_counter()       # before the trace is gathered
        prof[0].stop()
        tr_obj = tracing.collect(prof[0])
    launches = {"flash": flash_attention.launches - launches0}
    peak = (torch.cuda.max_memory_allocated() if sess.device.type == "cuda"
            else 0)
    e2e = end_to_end(cell, win)
    e2e["setup_s"] = win["t0"] - t_start
    formed = [e.extra["size"] for e in
              sess.client.engine.tracer.of(BATCH_FORMED)
              if win["t0"] <= e.t <= span_end]
    sess.close()
    record = {"cell": cell, "model": cell.model, "traffic": cell.traffic,
              "span_s": (span_end if traced else win["end"]) - win["t0"],
              "batches": list(sess.batches), "formed": formed,
              "launches": launches, "trace": tr_obj}
    sess.drop_program()
    done = finished(win)
    picked = sample(done, seed, cell.traffic["check_requests"])
    t_check = time.perf_counter()
    numbers = gaps(sess, picked) if picked else {"max_logit_gap": math.inf,
                                                 "tokens_compared": 0}
    t_check = time.perf_counter() - t_check
    log(f"[bench] {e2e['attempted']} requests sent, {len(done)} answered "
        f"in the window, in {len(formed)} batches of {formed}; "
        f"{numbers['tokens_compared']} served tokens of {len(picked)} "
        f"requests compared against the reference in {t_check:.1f} s")
    fields = {"attempted": e2e["attempted"], "failed": e2e["failed"],
              "memory_peak_bytes": peak, "e2e": e2e}
    return fields, record, {"max_logit_gap": numbers["max_logit_gap"]}
