"""Port parity for the METG model and for the slice as a whole: the paper's
dwork scheduler running A^T B tasks.

`repro_torch.core.metg` against `repro.core.metg`: every function and
constant equal (exactly: the port's copy does the same float arithmetic) at
benchmarks/metg.py's RANKS x TASK_SIZES and at the cases of
tests/test_metg.py.

The slice: on the CPU, JAX dwork with execute = the JAX `tiled_matmul`
(Pallas, interpret mode) and the port's dwork with execute =
`launch.metg.MatmulTasks` (the port's `tiled_matmul`, its plain version
here) run the same 64 seeded tasks and a gather task: the same steal
order, completed set and final stats, each task's C within the fp32
tolerance 1e-5 * sqrt(K) * max(1, max|a| * max|b|) (only the order of the
sums differs; `launch.metg.tolerance`).  Then `launch.metg.main` runs a small ladder on the CPU."""
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import dwork as jax_dwork  # noqa: E402
from repro.core import metg as jax_metg  # noqa: E402
from repro.core.dwork.overlap import OverlapClient as JaxOverlapClient  # noqa: E402
from repro.kernels.tiled_matmul.ops import tiled_matmul as jax_tiled_matmul  # noqa: E402
from repro_torch.core import dwork as port_dwork  # noqa: E402
from repro_torch.core import metg  # noqa: E402
from repro_torch.kernels.tiled_matmul import ops  # noqa: E402
from repro_torch.launch import metg as launch_metg  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "_bench_metg", Path(__file__).resolve().parents[1] / "benchmarks"
    / "metg.py")
_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_bench)
RANKS, TASK_SIZES = _bench.RANKS, _bench.TASK_SIZES


def test_constants_equal():
    for name in ("PAPER_JSRUN", "PAPER_ALLOC", "PAPER_DWORK_RTT",
                 "PAPER_MPILIST_SYNC", "PAPER_METG_864"):
        assert getattr(metg, name) == getattr(jax_metg, name)


@pytest.mark.parametrize("points", [jax_metg.PAPER_JSRUN,
                                    jax_metg.PAPER_MPILIST_SYNC,
                                    {2: 1.0, 4: 3.0, 1000: 7.5}])
def test_fit_log_equal(points):
    assert metg.fit_log(points) == jax_metg.fit_log(points)


def _models(mod):
    return {"paper": mod.METGModel.from_paper(),
            "measured": mod.METGModel.from_measured(
                launch_s=0.05, alloc_s=0.2, rtt_s=1.7e-5),
            "default": mod.METGModel()}


@pytest.mark.parametrize("which", ["paper", "measured", "default"])
@pytest.mark.parametrize("ranks", RANKS + (1, 44000))
def test_scaling_laws_equal(which, ranks):
    m, j = _models(metg)[which], _models(jax_metg)[which]
    assert vars(m) == vars(j)
    assert m.jsrun_time(ranks) == j.jsrun_time(ranks)
    assert m.pmake_metg(ranks) == j.pmake_metg(ranks)
    for kw in ({}, {"steal_n": 8}, {"shards": 4}, {"steal_n": 0, "shards": 0}):
        assert m.dwork_metg(ranks, **kw) == j.dwork_metg(ranks, **kw)
        assert m.metg("dwork", ranks, **kw) == j.metg("dwork", ranks, **kw)
    for sigma in (0.0, 1e-3, 0.3e-3 / math.sqrt(2 * math.log(864))):
        assert m.mpilist_metg(ranks, per_rank_sigma=sigma) == \
            j.mpilist_metg(ranks, per_rank_sigma=sigma)
    assert m.metg("pmake", ranks) == j.metg("pmake", ranks)
    assert m.metg("mpi-list", ranks) == j.metg("mpi-list", ranks)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("t", TASK_SIZES)
def test_efficiency_and_batching_equal(ranks, t):
    """benchmarks/metg.py's table: efficiency at every task size and rank
    count for each scheduler's METG, and the batch size that reaches 0.9."""
    m = metg.METGModel.from_paper()
    for sched in ("pmake", "dwork", "mpi-list"):
        v = m.metg(sched, ranks)
        assert metg.efficiency(t, v) == jax_metg.efficiency(t, v)
        assert metg.same_order(t, v) == jax_metg.same_order(t, v)
        for shards in (1, 4):
            assert metg.pick_batch_size(sched, ranks, t, shards=shards) == \
                jax_metg.pick_batch_size(sched, ranks, t, shards=shards)


@pytest.mark.parametrize("a,b,factor", [(1.0, 9.0, 10.0), (1.0, 11.0, 10.0),
                                        (0.0, 1.0, 10.0), (-1.0, 1.0, 10.0),
                                        (2.0, 5.0, 2.0)])
def test_same_order_equal(a, b, factor):
    assert metg.same_order(a, b, factor) == jax_metg.same_order(a, b, factor)


def test_metg_cases_of_the_jax_tests():
    """tests/test_metg.py's cases, on the port's copy."""
    m = metg.METGModel.from_paper()
    for ranks, t in metg.PAPER_JSRUN.items():
        assert abs(m.jsrun_time(ranks) - t) < 0.5
    mpil = m.mpilist_metg(864, per_rank_sigma=0.3e-3
                          / math.sqrt(2 * math.log(864)))
    assert mpil < m.dwork_metg(864) < m.pmake_metg(864)
    assert 10e-3 < m.dwork_metg(864) < 40e-3 and 3.5 < m.pmake_metg(864) < 5.5
    assert 0.9 < m.dwork_metg(44000) < 1.1
    assert abs(metg.efficiency(1.0, 1.0) - 0.5) < 1e-12
    n = metg.pick_batch_size("dwork", ranks=864, per_task_s=0.001,
                             target_eff=0.9)
    assert 0.001 * n / (0.001 * n + m.dwork_metg(864)) >= 0.9
    assert metg.pick_batch_size("dwork", 6, per_task_s=1.0) == 1


# --------------------------------------------------------------- the slice

N, TASKS = 64, 64


def _operands():
    rng = np.random.default_rng(14)
    return [(rng.standard_normal((N, N)).astype(np.float32),
             rng.standard_normal((N, N)).astype(np.float32))
            for _ in range(launch_metg.PAIRS)]


def _create_backlog(srv, count):
    """What `launch.metg.run_backlog` creates."""
    names = [f"mm:{N}:{i}" for i in range(count)]
    srv.create_bulk([(name, (), {"n": N, "pair": i % launch_metg.PAIRS})
                     for i, name in enumerate(names)])
    srv.create_bulk([(f"gather:{N}", names, {"n": N})])


class _JaxTasks:
    """The reference execute: each task one JAX `tiled_matmul` (Pallas,
    interpret mode, two k blocks); the gather holds every pair against the
    JAX oracle."""

    def __init__(self, operands):
        self.ops = [(jnp.asarray(a), jnp.asarray(b)) for a, b in operands]
        self.c = [None] * len(operands)
        self.log = []

    def __call__(self, name, meta):
        if name.startswith("gather:"):
            self.log.append((name, None))
            return all(np.allclose(np.asarray(c), np.asarray(a).T
                                   @ np.asarray(b), rtol=0, atol=1e-3)
                       for c, (a, b) in zip(self.c, self.ops))
        a, b = self.ops[meta["pair"]]
        self.c[meta["pair"]] = jax_tiled_matmul(a, b, bm=N, bn=N, bk=N // 2)
        self.log.append((name, np.asarray(self.c[meta["pair"]])))
        return True


class _PortTasks(launch_metg.MatmulTasks):
    """`launch.metg.MatmulTasks`, recording each task's C."""

    def __init__(self, operands):
        super().__init__([(torch.from_numpy(a), torch.from_numpy(b))
                          for a, b in operands])
        self.log = []

    def __call__(self, name, meta):
        ok = super().__call__(name, meta)
        self.log.append((name, None if name.startswith("gather:")
                         else self.c[meta["pair"]].numpy().copy()))
        return ok


@pytest.mark.parametrize("client", ["run_loop", "overlap"])
def test_slice_runs_the_same_tasks_as_jax(client):
    operands = _operands()
    jsrv = jax_dwork.TaskServer()
    _create_backlog(jsrv, TASKS)
    jcls = jax_dwork.Client if client == "run_loop" else JaxOverlapClient
    jtasks = _JaxTasks(operands)
    jdone = jcls(jax_dwork.InProcTransport(jsrv), "w0").run_loop(jtasks)

    ptasks = _PortTasks(operands)
    pcls = port_dwork.Client if client == "run_loop" \
        else port_dwork.OverlapClient
    launches = ops.tiled_matmul.launches
    res = launch_metg.run_backlog(pcls, ptasks, N, TASKS)
    assert ops.tiled_matmul.launches == launches    # the CPU: plain version

    assert res["tasks"] == jdone == TASKS + 1 and res["gathered"]
    assert [n for n, _ in ptasks.log] == [n for n, _ in jtasks.log]
    assert ptasks.log[-1][0] == f"gather:{N}"
    assert res["stats"] == jsrv.stats()
    assert res["stats"]["completed"] == res["stats"]["created"] == TASKS + 1
    assert res["stats"]["errors"] == 0
    assert res["matmul_tasks"] == ptasks.ran == TASKS
    assert ptasks.checked == TASKS // launch_metg.CHECK_EVERY \
        + launch_metg.PAIRS                          # sampled + the gather
    for (name, pc), (_, jc) in zip(ptasks.log[:-1], jtasks.log[:-1]):
        a, b = operands[int(name.split(":")[2]) % launch_metg.PAIRS]
        tol = launch_metg.tolerance(N, float(np.abs(a).max()),
                                    float(np.abs(b).max()))
        assert np.abs(pc - jc).max() <= tol


def test_slice_records_a_wrong_product_as_failed_tasks(monkeypatch):
    """A product that disagrees with the plain version fails its task, the
    server poisons the gather, and `run_backlog` raises rather than report a
    run of failed tasks as completed."""
    def wrong(a, b, *, out=None):
        return out.zero_()
    monkeypatch.setattr(launch_metg, "tiled_matmul", wrong)
    tasks = launch_metg.MatmulTasks([(torch.from_numpy(a), torch.from_numpy(b))
                                     for a, b in _operands()])
    with pytest.raises(RuntimeError, match="errors"):
        launch_metg.run_backlog(port_dwork.Client, tasks, N, TASKS)
    assert tasks.failures and "max|C - plain|" in tasks.failures[0]


def test_crossing_interpolates_in_log_n():
    rows = [{"n": 256, "kernel_s": 1e-5, "e": 0.25},
            {"n": 1024, "kernel_s": 1e-3, "e": 0.75}]
    c = launch_metg.crossing(rows, "e")
    assert c["n"] == pytest.approx(512.0)
    assert c["task_s"] == pytest.approx(1e-4)
    assert launch_metg.crossing(rows[:1], "e") is None
    assert launch_metg.crossing([dict(r, e=0.9) for r in rows], "e") is None


def test_metg_main_runs_on_the_cpu(capsys):
    launches = ops.tiled_matmul.launches
    res = launch_metg.main(["--device", "cpu", "--sizes", "16,32",
                            "--max-tasks", "70", "--seconds", "1e-9"])
    out = capsys.readouterr().out
    assert ops.tiled_matmul.launches == launches
    assert res["device"] == "cpu" and res["rtt"]["inproc_rtt_s"] > 0
    assert res["model_metg_s"] == res["rtt"]["inproc_rtt_s"]
    assert [r["n"] for r in res["rows"]] == [16, 32]
    for r in res["rows"]:
        assert r["tasks"] == 1                      # --seconds: one task
        for run in (r["loop"], r["overlap"]):
            assert run["stats"]["completed"] == run["stats"]["created"] == 2
            assert run["stats"]["errors"] == 0 and run["gathered"]
        assert r["launched"] == r["direct_launches"] \
            + r["loop"]["matmul_tasks"] + r["overlap"]["matmul_tasks"]
        assert r["model_eff"] == metg.efficiency(r["kernel_s"],
                                                  res["model_metg_s"])
        assert 0 < r["eff_loop"] and 0 < r["eff_overlap"]
        assert r["bare_per_task_s"] > 0 and r["launch_host_s"] > 0
    lines = [ln for ln in out.splitlines() if ln.startswith("[metg] n=")]
    assert len(lines) == 2 and "efficiency run_loop=" in lines[0]
    assert "[metg] efficiency 0.5:" in out


def test_metg_main_defaults_to_the_card():
    assert launch_metg.parse_args([]).device == "cuda"
    assert launch_metg.parse_args([]).sizes == "256,512,1024,2048,4096"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            launch_metg.main([])
