"""The paper's METG measurement for dwork (§3-§4), with every task one fp32
A^T B on the card through the tiled-matmul kernel.

    PYTHONPATH=src python -m repro_torch.launch.metg
    PYTHONPATH=src python -m repro_torch.launch.metg --device cpu \
        --sizes 32,64 --max-tasks 200 --seconds 0.05

The counterpart of the dwork half of `benchmarks/metg.py` (`measure_dwork_rtt`
and `run`), whose tasks are no-ops.  Runs on the card unless --device cpu.
For each square size n of the ladder (K = M = N = n), with operands made
from --seed on the device (4 pairs, one C buffer each):

  (a) the kernel's time per task, launches back to back, no scheduler
      (CUDA events; the host clock on the CPU), and the host's time to
      launch one;
  (b) the wall time per task through `Client.run_loop` over
      `InProcTransport`, steal_n = 1, one worker;
  (c) the same through `OverlapClient`, which keeps one Steal in flight;
  (d) once, the no-op round trip in-proc and over TCP on loopback;
  (e) the wall time per task of the same launch and synchronise in a plain
      loop, without the scheduler: (e) - (a) is the host's cost of a task
      on the card, (b) - (e) the scheduler's;
  (f) the wall time per task through the futures front door,
      `repro_torch.client.Client(scheduler="dwork", workers=1)`: each task
      `submit`ted, then the gather task submitted with every future as its
      arguments (the `client` path of `benchmarks/client_overhead.py`, with
      an A^T B on the card for its no-op), and the session's empirical
      per-task overhead from `report().summary()`.

Each size's backlog is the tasks (a) says take --seconds of card time,
capped at --max-tasks, created in one `create_bulk`, plus one `gather:n`
task that depends on all of them and checks every pair's C.  Every task
synchronises the device before it returns (a dwork Complete means done),
and one task in every 64 holds its C against the plain version.  The run
prints one line per size with the measured efficiency (a)/(b), (a)/(c) and
(a)/(f) beside `metg.efficiency(t, rtt)`, then where the measured efficiency
crosses 0.5 beside `METGModel.from_measured(rtt_s=...).dwork_metg(1)`.  It
raises if a server records a failed task or completes fewer tasks than were
created, or if a future of (f) resolves with an error.

Then the other two halves of `benchmarks/metg.py` (`run`, `:78-115`): the
METG of all three schedulers at the paper's rank counts RANKS, from the
paper's Summit constants and from this machine's measured ones (the dwork
round trips above, `measure_pmake_launch`'s popen launch of a no-op shell
task, `measure_mpilist_sigma`'s per-rank jitter of a trivial map through the
port's mpi-list `Context`), with the efficiency at each of TASK_SIZES and the
reference's checks: one `[metg] ranks=` line per rank count, then `[metg]
checks`.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch.client import Client as FuturesClient
from repro_torch.core.dwork import (Client, InProcTransport, OverlapClient,
                                    TaskServer, TCPServer, TCPTransport)
from repro_torch.core.metg import METGModel, efficiency, same_order
from repro_torch.core.mpi_list import Context
from repro_torch.kernels.tiled_matmul.ops import tiled_matmul, tiled_matmul_ref

SIZES = (256, 512, 1024, 2048, 4096)
RANKS = (6, 60, 864, 6912)                          # benchmarks/metg.py's
TASK_SIZES = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)
PAIRS = 4
CHECK_EVERY = 64
TIMING_S = 0.25        # card time spent on (a) per size
# (a) queues its launches behind a sleep on the card, so that the events
# bracket the kernels alone and not the host's pace of launching them: the
# sleep is sized for HOST_LAUNCH_S a launch (a few times what (a) measures on
# an H100's host), and `device_seconds` checks that it was still running once
# the last launch was queued, doubling it up to SLEEP_TRIES times.
# MAX_QUEUED stays below the queue of pending launches a device takes, which
# would otherwise block the host.
HOST_LAUNCH_S, MAX_QUEUED, SLEEP_HZ, SLEEP_TRIES = 100e-6, 400, 2e9, 4
BARE_TASKS = 2000      # tasks of (e), at most
FRONT_DOOR_WAIT_S = 600.0   # the longest (f) waits for its gather task
# fp32 C against the plain version: only the order of the sums differs.  The
# roundings of a reordered sum of K terms, each at most max|a| * max|b|, add
# up as a random walk, so each element is held to
# 1e-5 * sqrt(K) * max(1, max|a| * max|b|).  sqrt(K) counts once: max |C|
# itself grows as sqrt(K), so a limit scaled by it would count it twice.  A
# wrong index or a dropped k-slice is off by O(1); inputs rounded to TF32
# (10 mantissa bits) are off by 5-7 times the limit at n = 256 ... 1024.
FP32_TOL = 1e-5


def tolerance(k: int, a_absmax: float, b_absmax: float) -> float:
    return FP32_TOL * math.sqrt(k) * max(1.0, a_absmax * b_absmax)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="comma-separated square sizes n (K = M = N = n)")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="card time of each size's backlog, from (a)")
    ap.add_argument("--max-tasks", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def measure_dwork_rtt(n: int = 2000) -> dict:
    """Per-task Steal+Complete round trip of no-op tasks, in-proc and over
    TCP on loopback (`benchmarks/metg.py:29`, the paper's 23 us analog)."""
    out = {}
    srv = TaskServer()
    cl = Client(InProcTransport(srv), "w")
    for i in range(n):
        cl.create(f"t{i}")
    t0 = time.perf_counter()
    done = cl.run_loop(lambda *_: True, steal_n=1, max_idle=1)
    out["inproc_rtt_s"] = (time.perf_counter() - t0) / max(done, 1)

    srv2 = TaskServer()
    tcp = TCPServer(("127.0.0.1", 0), srv2)
    tcp.serve_background()
    cl2 = Client(TCPTransport(*tcp.server_address), "w")
    try:
        n2 = min(n, 500)
        for i in range(n2):
            cl2.create(f"t{i}")
        t0 = time.perf_counter()
        done = cl2.run_loop(lambda *_: True, steal_n=1, max_idle=1)
        out["tcp_rtt_s"] = (time.perf_counter() - t0) / max(done, 1) / 2.0
    finally:
        cl2.t.close()
        tcp.shutdown()
        tcp.server_close()
    return out


def measure_pmake_launch(n: int = 15) -> float:
    """popen launch cost of a no-op shell task (jsrun analog;
    `benchmarks/metg.py:54`)."""
    t0 = time.perf_counter()
    for _ in range(n):
        subprocess.run(["sh", "-c", "true"], check=True)
    return (time.perf_counter() - t0) / n


def measure_mpilist_sigma(procs: int = 16, n_tasks: int = 2000) -> float:
    """Per-rank runtime jitter (straggler sigma) of a trivial map over the
    mpi-list `Context`'s rank blocks (`benchmarks/metg.py:62`)."""
    C = Context(procs)
    times = []
    dfm = C.iterates(n_tasks)
    for _ in range(5):
        t_ranks = []
        for blk in dfm.parts:
            t0 = time.perf_counter()
            _ = [x * x for x in blk]
            t_ranks.append(time.perf_counter() - t0)
        times.append(np.std(t_ranks))
    return float(np.mean(times))


def run(rtt: dict = None, quick: bool = True) -> dict:
    """`benchmarks/metg.py`'s `run`: each scheduler's METG at RANKS from the
    paper's constants and the measured ones, the efficiency at TASK_SIZES,
    and the checks.  `rtt` takes `measure_dwork_rtt`'s result when the
    caller has one."""
    model = METGModel.from_paper()
    meas = rtt or measure_dwork_rtt(400 if quick else 2000)
    launch = measure_pmake_launch(8 if quick else 30)
    sigma = measure_mpilist_sigma(8, 500 if quick else 4000)

    rows = []
    for ranks in RANKS:
        metg = {
            "pmake_paper": model.pmake_metg(ranks),
            "pmake_measured": launch * (1 + math.log(ranks) / 10),
            "dwork_paper": model.dwork_metg(ranks),
            "dwork_measured_inproc": meas["inproc_rtt_s"] * ranks,
            "dwork_measured_tcp": meas["tcp_rtt_s"] * ranks,
            "mpilist_paper": model.mpilist_metg(ranks),
            "mpilist_measured": sigma * math.sqrt(2 * math.log(ranks)),
        }
        effs = {f"eff@{t:g}s": {k: round(efficiency(t, v), 3)
                                for k, v in metg.items()}
                for t in TASK_SIZES}
        rows.append({"ranks": ranks, "metg_s": metg, **effs})

    # paper §4 headline: ordering + magnitudes at 864 ranks
    r864 = rows[2]["metg_s"]
    checks = {
        "ordering_mpilist<dwork<pmake":
            r864["mpilist_paper"] < r864["dwork_paper"] < r864["pmake_paper"],
        "dwork_scales_linearly":
            abs(rows[3]["metg_s"]["dwork_paper"]
                / r864["dwork_paper"] - 6912 / 864) < 1e-6,
        "paper_864_dwork_ms": round(r864["dwork_paper"] * 1e3, 1),
        "paper_864_pmake_s": round(r864["pmake_paper"], 2),
        "measured_dwork_rtt_us": round(meas["inproc_rtt_s"] * 1e6, 1),
        "measured_tcp_rtt_us": round(meas["tcp_rtt_s"] * 1e6, 1),
        "measured_pmake_launch_s": round(launch, 4),
        "measured_mpilist_sigma_s": round(sigma, 6),
    }
    return {"rows": rows, "checks": checks}


def print_table(table: dict):
    """One `[metg] ranks=` line per rank count: each scheduler's METG in ms,
    the paper's and the measured, and the efficiency at each task size."""
    for row in table["rows"]:
        m = row["metg_s"]
        effs = " ".join(
            f"eff@{t:g}s=" + "/".join(
                f"{row[f'eff@{t:g}s'][k]:.3f}" for k in m)
            for t in TASK_SIZES)
        print(f"[metg] ranks={row['ranks']} METG ms: " + " ".join(
            f"{k}={v * 1e3:.6g}" for k, v in m.items())
            + f"; {effs} (in the order of the METG columns)", flush=True)
    print(f"[metg] checks {json.dumps(table['checks'])}", flush=True)


class MatmulTasks:
    """`execute(name, meta)` for one size's tasks: a task {"pair": i} runs
    C_i = a_i^T b_i into pair i's C buffer and synchronises the device; one
    in every `check_every` then holds C_i against the plain result, made
    once per pair.  The `gather:` task holds every pair's C.  A mismatch
    returns False; an exception is recorded in `failures` and re-raised
    (`Client.run_loop` turns it into a failed task)."""

    def __init__(self, operands, check_every: int = CHECK_EVERY):
        self.a = [a for a, _ in operands]
        self.b = [b for _, b in operands]
        self.device = self.a[0].device
        self.c = [torch.empty((a.shape[1], b.shape[1]), dtype=a.dtype,
                              device=self.device) for a, b in operands]
        self.plain = [tiled_matmul_ref(a, b) for a, b in operands]
        self.limit = [tolerance(a.shape[0], float(a.abs().max()),
                                float(b.abs().max())) for a, b in operands]
        self.check_every = check_every
        self.launched = 0      # tiled_matmul calls, timing included
        self.ran = 0           # matmul tasks executed
        self.checked = 0
        self.worst = 0.0       # largest max |C - plain| / limit seen
        self.failures: list = []

    def launch(self, pair: int):
        tiled_matmul(self.a[pair], self.b[pair], out=self.c[pair])
        self.launched += 1

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def compare(self, name: str, pair: int) -> bool:
        c, plain = self.c[pair], self.plain[pair]
        err = float((c - plain).abs().max())
        ok = err <= self.limit[pair] and bool(torch.isfinite(c).all())
        self.checked += 1
        self.worst = max(self.worst, err / self.limit[pair])
        if not ok:
            self.failures.append(f"{name}: pair {pair} max|C - plain| "
                                 f"{err:.3e} > {self.limit[pair]:.3e}")
        return ok

    def __call__(self, name: str, meta: dict) -> bool:
        try:
            if name.startswith("gather:"):
                return all([self.compare(name, p) for p in range(len(self.c))])
            pair = meta["pair"]
            self.launch(pair)
            self.sync()
            self.ran += 1
            if (self.ran - 1) % self.check_every == 0:
                return self.compare(name, pair)
            return True
        except Exception as e:
            self.failures.append(f"{name}: {e!r}")
            raise


# A^T B tasks for worker PROCESSES (`Client(transport="proc")`): functions
# named at module level, so plain pickle ships them as cloudpickle does.  No
# CUDA tensor crosses the process boundary: each process makes a size's
# operands from (n, seed) on its own device, once, and so holds the same A_i
# and B_i as a parent that made them from the same seed.
_SEEDED: dict = {}


def seeded_operands(n: int, seed: int, device="cuda") -> MatmulTasks:
    """The PAIRS operand pairs of size n made from `seed` on `device`, with
    their plain results."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return MatmulTasks([tuple(
        torch.randn((n, n), generator=gen, device=device) for _ in "ab")
        for _ in range(PAIRS)])


def seeded_tasks(n: int, seed: int, device="cuda") -> MatmulTasks:
    """`seeded_operands`, made once a process."""
    key = (n, seed, str(device))
    if key not in _SEEDED:
        _SEEDED[key] = seeded_operands(n, seed, device)
    return _SEEDED[key]


def proc_matmul(n: int, pair: int, seed: int, *, check: bool = False,
                hold_s: float = 0.0, device="cuda") -> tuple:
    """One task: C_pair = A^T B through the kernel, synchronised; with
    `check`, C held against the plain version within `tolerance` (raises
    past it); then `hold_s` seconds of sleep.  -> (the sum of C in float64,
    this process's pid, its tiled_matmul launches so far, max |C - plain|
    over the tolerance or None)."""
    tasks = seeded_tasks(n, seed, device)
    tasks.launch(pair)
    tasks.sync()
    c = tasks.c[pair]
    ratio = None
    if check:
        err = float((c - tasks.plain[pair]).abs().max())
        ratio = err / tasks.limit[pair]
        if not (ratio <= 1.0 and bool(torch.isfinite(c).all())):
            raise ValueError(f"A^T B n={n} pair {pair}: max|C - plain| "
                             f"{err:.3e} > {tasks.limit[pair]:.3e}")
    if hold_s:
        time.sleep(hold_s)
    return (float(c.double().sum()), os.getpid(), tiled_matmul.launches,
            ratio)


def proc_matmul_c(n: int, pair: int, seed: int, device="cuda"):
    """A producer: C_pair through the kernel, copied to the host (n = 1024:
    4 MiB, a value that stays in the producing worker's store)."""
    tasks = seeded_tasks(n, seed, device)
    tasks.launch(pair)
    return tasks.c[pair].cpu()


def checksum_of_sum(x, y) -> float:
    """A consumer: the sum of two producers' C, in float64."""
    return float((x + y).double().sum())


def device_seconds(launch, reps: int, device) -> tuple[float, float]:
    """Seconds per call of `launch(i)`, i = 0 .. reps-1, on the device and
    on the host.  On the card: CUDA events around the calls, queued behind a
    sleep (reps <= MAX_QUEUED), and the host clock around their enqueueing;
    if the sleep ended before the last call was queued, the card may have
    waited on the host, so the run is repeated behind a sleep twice as long,
    and after SLEEP_TRIES such runs it raises.  On the CPU: the host clock
    for both."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(reps):
            launch(i)
        t = (time.perf_counter() - t0) / reps
        return t, t
    if reps > MAX_QUEUED:
        raise ValueError(f"{reps} launches would fill the launch queue")
    for attempt in range(SLEEP_TRIES):
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(reps * HOST_LAUNCH_S * SLEEP_HZ) << attempt)
        start.record()
        t0 = time.perf_counter()
        for i in range(reps):
            launch(i)
        host = (time.perf_counter() - t0) / reps
        sleep_over = start.query()
        end.record()
        end.synchronize()
        if not sleep_over:
            return start.elapsed_time(end) / 1e3 / reps, host
    raise RuntimeError(
        f"the host took {host * 1e6:.1f} us a launch; the sleep ahead of "
        f"{reps} launches ended before they were queued, {SLEEP_TRIES} times")


def kernel_time(tasks: MatmulTasks) -> tuple[float, float]:
    """(a): seconds per launch on the device, back to back over the pairs,
    and on the host (a warm-up, a short run that sizes the timed one, the
    timed one)."""
    def launch(i):
        tasks.launch(i % len(tasks.c))

    launch(0)                           # the build at first use, the caches
    tasks.sync()
    t, _ = device_seconds(launch, 3, tasks.device)
    reps = min(MAX_QUEUED, max(10, int(TIMING_S / max(t, 1e-9))))
    return device_seconds(launch, reps, tasks.device)


def bare_loop(tasks: MatmulTasks, count: int) -> float:
    """(e): wall seconds per task of `count` launches, each synchronised, in
    a plain loop over the pairs: a task's work without the scheduler."""
    gc.disable()
    try:
        t0 = time.perf_counter()
        for i in range(count):
            tasks.launch(i % len(tasks.c))
            tasks.sync()
        return (time.perf_counter() - t0) / count
    finally:
        gc.enable()


def run_backlog(client_cls, tasks: MatmulTasks, n: int, count: int) -> dict:
    """`count` matmul tasks and one gather task on a fresh server, drained by
    one `client_cls` worker over the in-proc transport.  Raises unless every
    task completed without error."""
    srv = TaskServer()
    names = [f"mm:{n}:{i}" for i in range(count)]
    srv.create_bulk([(name, (), {"n": n, "pair": i % len(tasks.c)})
                     for i, name in enumerate(names)])
    srv.create_bulk([(f"gather:{n}", names, {"n": n})])
    cl = client_cls(InProcTransport(srv), "w0")
    ran = tasks.ran
    gc.disable()
    try:
        t0 = time.perf_counter()
        done = cl.run_loop(tasks, steal_n=1)
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
    stats = srv.stats()
    gathered = f"gather:{n}" in srv.completed
    if stats["errors"] or stats["completed"] != stats["created"] \
            or not gathered:
        raise RuntimeError(
            f"dwork {client_cls.__name__} at n={n}: {stats}, gather done: "
            f"{gathered}; first failures: {tasks.failures[:3]}")
    return {"client": client_cls.__name__, "tasks": done,
            "matmul_tasks": tasks.ran - ran, "wall_s": wall,
            "per_task_s": wall / done, "stats": stats, "gathered": gathered}


def run_front_door(tasks: MatmulTasks, n: int, count: int) -> dict:
    """(f): `count` matmul tasks submitted to a futures `Client` (dwork, one
    inproc worker, the engine resident), then a gather task whose arguments
    are all their futures and which checks every pair's C.  Raises unless
    every future resolved without error to a passed check and the backend
    completed every task it created."""
    ran = tasks.ran
    pairs = len(tasks.c)

    def gather(*oks):
        return all(oks) and tasks(f"gather:{n}", {})

    gc.disable()
    try:
        client = FuturesClient(scheduler="dwork", workers=1)
        try:
            t0 = time.perf_counter()
            futs = [client.submit(tasks, f"mm:{n}:{i}", {"pair": i % pairs},
                                  key=f"mm:{n}:{i}") for i in range(count)]
            futs.append(client.submit(gather, *futs, key=f"gather:{n}"))
            futs[-1].exception(FRONT_DOOR_WAIT_S)
            wall = time.perf_counter() - t0
        finally:
            report = client.close()
    finally:
        gc.enable()
    errors = [f.exception(0) for f in futs]
    stats = report.backend_stats
    if any(e is not None for e in errors) \
            or not all(f.result(0) for f in futs) or stats["errors"] \
            or stats["completed"] != stats["created"]:
        bad = next((e for e in errors if e is not None), None)
        raise RuntimeError(
            f"front door at n={n}: {stats}, first error {bad!r}; first "
            f"failures: {tasks.failures[:3]}")
    return {"client": "front_door", "tasks": len(futs),
            "matmul_tasks": tasks.ran - ran, "wall_s": wall,
            "per_task_s": wall / len(futs), "stats": stats,
            "gathered": True, "overhead": report.overhead().summary()}


def crossing(rows: list, key: str):
    """Where the measured efficiency `key` crosses 0.5 on the ladder,
    interpolated linearly in log n, with the task time there interpolated
    in log-log; None when it does not cross between two sizes."""
    pts = [(math.log(r["n"]), r[key], math.log(r["kernel_s"])) for r in rows]
    for (x0, e0, t0), (x1, e1, t1) in zip(pts, pts[1:]):
        if e0 != e1 and (e0 - 0.5) * (e1 - 0.5) <= 0:
            x = x0 + (0.5 - e0) / (e1 - e0) * (x1 - x0)
            t = t0 + (x - x0) / (x1 - x0) * (t1 - t0)
            return {"n": math.exp(x), "task_s": math.exp(t)}
    return None


def _fmt_crossing(c, rows, key) -> str:
    if c is not None:
        return f"n={c['n']:.0f}, task {c['task_s'] * 1e3:.4f} ms"
    side = "above" if all(r[key] >= 0.5 for r in rows) else "below"
    return f"not on the ladder (efficiency {side} 0.5 at every size)"


def main(argv=None) -> dict:
    """Run the ladder; returns the round trips, one row per size, the
    crossings and the model's METG, for callers that check them."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but there is no CUDA card; "
                               "--device cpu runs the plain version")
        # the plain version's fp32 product in fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        where = torch.cuda.get_device_name(device)
    else:
        where = str(device)
    sizes = [int(s) for s in args.sizes.split(",")]
    gen = torch.Generator(device=device).manual_seed(args.seed)

    gc.disable()
    try:
        rtt = measure_dwork_rtt()
    finally:
        gc.enable()
    model = METGModel.from_measured(rtt_s=rtt["inproc_rtt_s"])
    metg_s = model.dwork_metg(1)
    print(f"[metg] on {where}: dwork no-op round trip in-proc "
          f"{rtt['inproc_rtt_s'] * 1e6:.2f} us, TCP loopback "
          f"{rtt['tcp_rtt_s'] * 1e6:.2f} us; model METG (rtt x P, P = 1) "
          f"{metg_s * 1e3:.4f} ms", flush=True)

    rows = []
    for n in sizes:
        tasks = MatmulTasks([tuple(torch.randn((n, n), generator=gen,
                                               device=device)
                                   for _ in "ab") for _ in range(PAIRS)])
        kernel_s, launch_host_s = kernel_time(tasks)
        count = min(args.max_tasks, max(1, math.ceil(args.seconds / kernel_s)))
        bare_s = bare_loop(tasks, min(count, BARE_TASKS))
        direct = tasks.launched            # (a) and (e): no scheduler
        loop = run_backlog(Client, tasks, n, count)
        overlap = run_backlog(OverlapClient, tasks, n, count)
        front = run_front_door(tasks, n, count)
        model_eff = efficiency(kernel_s, metg_s)
        row = {"n": n, "tasks": count, "kernel_s": kernel_s,
               "launch_host_s": launch_host_s, "bare_per_task_s": bare_s,
               "direct_launches": direct, "launched": tasks.launched,
               "loop": loop, "overlap": overlap, "front_door": front,
               "eff_loop": kernel_s / loop["per_task_s"],
               "eff_overlap": kernel_s / overlap["per_task_s"],
               "eff_front_door": kernel_s / front["per_task_s"],
               "model_eff": model_eff, "checked": tasks.checked,
               "worst_err_over_tol": tasks.worst}
        row["same_order_loop"] = same_order(row["eff_loop"], model_eff)
        row["same_order_overlap"] = same_order(row["eff_overlap"], model_eff)
        row["same_order_front_door"] = same_order(row["eff_front_door"],
                                                  model_eff)
        rows.append(row)
        print(f"[metg] n={n} tasks={count}+1 kernel_ms={kernel_s * 1e3:.4f} "
              f"launch_host_ms={launch_host_s * 1e3:.4f} "
              f"no_scheduler_ms_per_task={bare_s * 1e3:.4f} "
              f"run_loop_ms_per_task={loop['per_task_s'] * 1e3:.4f} "
              f"overlap_ms_per_task={overlap['per_task_s'] * 1e3:.4f} "
              f"front_door_ms_per_task={front['per_task_s'] * 1e3:.4f} "
              f"efficiency run_loop={row['eff_loop']:.3f} overlap="
              f"{row['eff_overlap']:.3f} front_door="
              f"{row['eff_front_door']:.3f} model={model_eff:.3f} same_order="
              f"{row['same_order_loop']}/{row['same_order_overlap']}/"
              f"{row['same_order_front_door']} front_door_overhead_us="
              f"{front['overhead']['per_task_overhead_us']} "
              f"checked={tasks.checked} worst max|C - plain|/tol="
              f"{tasks.worst:.3e}", flush=True)
        del tasks
        if device.type == "cuda":
            torch.cuda.empty_cache()

    labels = {"eff_loop": "run_loop", "eff_overlap": "overlap",
              "eff_front_door": "front_door"}
    cross = {k: crossing(rows, k) for k in labels}
    print("[metg] efficiency 0.5: " + "; ".join(
        f"{label} {_fmt_crossing(cross[k], rows, k)}"
        for k, label in labels.items())
        + f"; model dwork_metg(1) = {metg_s * 1e3:.4f} ms", flush=True)
    table = run(rtt, quick=False)
    print_table(table)
    return {"device": where, "rtt": rtt, "rows": rows, "crossing": cross,
            "model_metg_s": metg_s, "schedulers": table}


if __name__ == "__main__":
    main()
