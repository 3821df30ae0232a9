"""A^T B tasks on the card through the port's futures front door.

Needs an NVIDIA Hopper card and nvcc: the kernel has no CPU mode, so these
tests skip elsewhere.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_client_cuda.py``.
This file imports no JAX, so it runs where JAX is not installed.

Each task is one fp32 A^T B through `tiled_matmul`, submitted as a future;
a gather task takes every future as an argument.  Tasks run off the main
thread (the engine's dispatch thread under inproc, its pool's threads under
thread), so the device is passed with the tensors and the launch count must
still come out exact.  Tolerance: `launch.metg.tolerance` (fp32, only the
order of the sums differs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.client import Client  # noqa: E402
from repro_torch.core.engine import FaultPlan, RetryPolicy  # noqa: E402
from repro_torch.kernels.tiled_matmul import ops  # noqa: E402
from repro_torch.launch.metg import tolerance  # noqa: E402

N, TASKS = 256, 200


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain fp32 product


def _operands(pairs=4, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.standard_normal((N, N))
                                   .astype(np.float32)).cuda()
                  for _ in "ab") for _ in range(pairs)]


def _task(a, b):
    c = ops.tiled_matmul(a, b)
    torch.cuda.current_stream(c.device).synchronize()
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("transport,workers", [("inproc", 1), ("thread", 2),
                                               ("inproc", 4)])
def test_matmul_tasks_through_the_client(transport, workers):
    _need_card()
    pairs = _operands()
    ops.tiled_matmul.launches = 0
    with Client(scheduler="dwork", workers=workers,
                transport=transport) as c:
        futs = [c.submit(_task, *pairs[i % len(pairs)]) for i in range(TASKS)]
        total = c.submit(lambda *cs: len(cs), *futs)
        assert total.result(timeout=120) == TASKS
        outs = c.gather(futs, timeout=120)
    rep = c.close()
    assert ops.tiled_matmul.launches == TASKS
    assert rep.backend_stats["completed"] == rep.backend_stats["created"] \
        == TASKS + 1
    assert rep.backend_stats["errors"] == 0
    for i in range(0, TASKS, 16):
        a, b = pairs[i % len(pairs)]
        want = a.T @ b
        err = float((outs[i] - want).abs().max())
        assert err <= tolerance(N, float(a.abs().max()), float(b.abs().max()))


@pytest.mark.cuda
def test_retry_on_the_card_counts_every_attempt(tmp_path):
    _need_card()
    a, b = _operands(1)[0]
    ops.tiled_matmul.launches = 0
    with Client(workers=1, faults=FaultPlan(seed=1).fail_first_k(1),
                retry=RetryPolicy(max_attempts=3),
                journal_dir=str(tmp_path)) as c:
        futs = [c.submit(_task, a, b) for _ in range(20)]
        c.gather(futs, timeout=120)
        assert c.engine.retries_total == 20
    # an injected failure marks the attempt failed after its body ran, so
    # each task launched twice: the failed first attempt and the retry
    assert ops.tiled_matmul.launches == 40
    assert c.close().backend_stats["errors"] == 0


@pytest.mark.cuda
def test_a_failing_task_on_the_card_raises_its_error():
    _need_card()
    a, b = _operands(1)[0]
    with Client(workers=1) as c:
        bad = c.submit(ops.tiled_matmul, a, b[:-1])     # K mismatch
        with pytest.raises(Exception):
            bad.result(timeout=60)
        down = c.submit(lambda x: x, bad)
        with pytest.raises(Exception, match="failed"):
            down.result(timeout=60)


@pytest.mark.cuda
def test_proc_workers_launch_the_kernel_in_their_own_processes():
    """`transport="proc"`: each worker process launches `tiled_matmul` on
    its own CUDA context for the tasks it runs (`launch.metg.proc_matmul`,
    operands made in the worker from a seed); the launches the tasks report
    sum to the tasks, and each sum of C is the plain one's."""
    import os
    from repro_torch.launch import metg
    _need_card()
    seed, count = 5, 64
    ref = metg.seeded_operands(N, seed, "cuda")
    with Client(scheduler="dwork", transport="proc", workers=2) as c:
        vals = c.gather([c.submit(metg.proc_matmul, N, i % metg.PAIRS, seed,
                                  check=i % 8 == 0) for i in range(count)],
                        timeout=300)
        pids = set(c.engine.worker_pids().values())
    last = {}
    for i, (total, pid, launches, _ratio) in enumerate(vals):
        p = i % metg.PAIRS
        assert abs(total - float(ref.plain[p].double().sum())) \
            <= N * N * ref.limit[p]
        last[pid] = max(last.get(pid, 0), launches)
    assert set(last) <= pids and os.getpid() not in pids
    assert sum(last.values()) == count
