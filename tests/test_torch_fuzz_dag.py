"""The proc rows of tests/test_fuzz_dag.py's matrix, through the port's
`Client`: seeded random DAGs over the port's worker processes, with
payloads straddling the inline threshold, seeded transient failures and
one mid-run SIGKILL of a worker process.  Held as there: exact sink values
against the DAG modelled locally (the same model, `_expected_values`),
exactly-once future resolution, zero task loss, the transient failures
retried.  A failure prints `REPRO_FUZZ_SEEDS=<seed>` and the shards."""
import collections
import hashlib
import os
import random
import signal
import time

import pytest

from repro_torch.client import Client
from repro_torch.core.engine import RetryPolicy
from test_fuzz_dag import (FAIL_RATE, HB, INLINE, MATRIX, N_TASKS,
                           SEEDS, _expected_values, _gen_dag)

PROC_ROWS = [row for row in MATRIX if row[0] == "proc"]


def _run_proc_case(shards: int, seed: int, tmp_path) -> None:
    rng = random.Random(seed)
    specs = _gen_dag(rng, N_TASKS)
    expected = _expected_values(specs)
    ctx = f"REPRO_FUZZ_SEEDS={seed} transport=proc shards={shards} (port)"

    def make_fn(i, size, marker, pause):
        # closure, not a module-level def: cloudpickle ships it by value
        def fn(*dep_vals):
            if marker is not None and not os.path.exists(marker):
                open(marker, "w").close()
                raise RuntimeError(f"transient-{os.path.basename(marker)}")
            if pause:
                time.sleep(pause)
            h = hashlib.md5(f"task{i}".encode())
            for d in dep_vals:
                h.update(d[:16])
            return (h.digest() * (size // 16 + 1))[:size]
        return fn

    c = Client(transport="proc", workers=4, shards=shards, heartbeat_s=HB,
               inline_bytes=INLINE,
               retry=RetryPolicy(max_attempts=3, backoff=0.0, seed=seed))
    try:
        futs = []
        resolutions: collections.Counter = collections.Counter()
        for i, (deps, size, fail_once) in enumerate(specs):
            marker = (str(tmp_path / f"fail-{seed}-{i}") if fail_once
                      else None)
            pause = 0.004 if rng.random() < 0.5 else 0.0
            f = c.submit(make_fn(i, size, marker, pause),
                         *[futs[d] for d in deps], key=f"fz{i}")
            f.add_done_callback(
                lambda fut: resolutions.update([fut.name]))
            futs.append(f)
        # one mid-run SIGKILL: wait for some progress, then kill a real
        # worker process — requeue and (if it held the only copy of a big
        # value) the lost-value recompute must absorb it
        c._ensure_running()
        deadline = time.monotonic() + 30
        while sum(1 for f in futs if f.done()) < N_TASKS // 6 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        pids = list(c.engine.worker_pids().values())
        if pids:
            os.kill(rng.choice(pids), signal.SIGKILL)
        values = c.gather(futs, timeout=120)
        for i, (got, want) in enumerate(zip(values, expected)):
            assert got == want, \
                f"[{ctx}] task fz{i} value corrupted " \
                f"(len {len(got)} vs {len(want)})"
        multi = {n: k for n, k in resolutions.items() if k != 1}
        assert not multi, f"[{ctx}] futures resolved != once: {multi}"
        assert len(resolutions) == N_TASKS, \
            f"[{ctx}] task loss: {N_TASKS - len(resolutions)} futures " \
            "never resolved"
        # the SIGKILL can eat unreported first-run failures (the rerun
        # sees the marker and succeeds uncharged): one worker's batch of
        # slack, as the reference allows
        n_transient = sum(1 for _, _, f in specs if f)
        if n_transient:
            assert c.engine.retries_total >= max(n_transient - 4, 1), \
                f"[{ctx}] {c.engine.retries_total} retries for " \
                f"{n_transient} transient tasks"
    except Exception:
        print(f"\nFUZZ REPLAY: {ctx}")
        raise
    finally:
        c.close()


def test_the_rows_are_the_references():
    assert PROC_ROWS == [("proc", 1), ("proc", 4)] and 0 < FAIL_RATE < 1


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("transport,shards", PROC_ROWS)
def test_fuzz_dag_proc(transport, shards, seed, tmp_path):
    _run_proc_case(shards, seed, tmp_path)
