"""Port parity for mpi-list beyond the properties: the deterministic cases of
tests/test_mpi_list.py and tests/test_engine.py through both `Context`s,
engine mode with seeded stragglers, the data pipeline's packing, and the DFM
bridge `mesh_ops` against the JAX package's on the CPU (a 1x1 mesh, as the
JAX test builds it).

Tolerances: integer results and every max / exchange / scan of exactly
representable values are held exactly.  fp32 sums and scans of N seeded
values are held within N * 2^-24 * sum|x| (a bound on the rounding of any
order of summation of N terms): the two packages add in different orders.
`group` is held to numpy's stable argsort, not to the JAX call, which fails
on jax 0.9 (`tests/test_mpi_list.py::test_mesh_bridge_single_device`);
`dfm_reduce` is held to the JAX reduce on arrays without a sharding, since
on an array placed on the mesh it fails the same way for N >= 2."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.mpi_list import Context as JaxContext  # noqa: E402
from repro.core.mpi_list import mesh_ops as jax_mesh_ops  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro_torch.core.mpi_list import Context, mesh_ops  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402

U = 2.0 ** -24            # fp32 unit roundoff


def test_flatmap_and_filter_equal():
    out = [C.iterates(10).flatMap(lambda x: [x, x])
           .filter(lambda x: x % 2 == 0).parts
           for C in (JaxContext(3), Context(3))]
    assert out[0] == out[1]
    assert sum(out[1], []) == [x for i in range(10) for x in (i, i)
                               if x % 2 == 0]


def test_straggler_accounting():
    C = Context(4, jitter=lambda p: 0.01 * p)
    C.iterates(16).map(lambda x: x)
    assert C.sync_time >= 0.029


def _engine_run(ctx_cls, seed, sigma=1e-3, workers=4):
    C = ctx_cls(16, engine_workers=workers, straggler_sigma=sigma, seed=seed)
    a = C.scatter(list(range(64))).map(lambda x: x + 1)
    b = a.flatMap(lambda x: [x, -x]).filter(lambda x: x % 3 != 0)
    return C, a.parts, b.parts


@pytest.mark.parametrize("seed", [0, 42, 43])
def test_engine_mode_virtual_gaps_equal(seed):
    port, pa, pb = _engine_run(Context, seed)
    ref, ja, jb = _engine_run(JaxContext, seed)
    assert (pa, pb) == (ja, jb)
    assert port.step == ref.step == 3
    assert port.virtual_gaps == ref.virtual_gaps
    assert len(port.gaps) == len(port.rank_times) == 3
    assert all(len(t) == 16 for t in port.rank_times)


def test_engine_mode_seeds_differ():
    assert _engine_run(Context, 42)[0].virtual_gaps[0] != \
        _engine_run(Context, 43)[0].virtual_gaps[0]


def test_straggler_crosscheck_equal():
    """On the same gaps (the injected ones, reproducible for a seed) both
    crosschecks are equal; on the measured gaps the analytic side is equal
    and the empirical one is the injected gap plus wall-clock noise."""
    port = _engine_run(Context, 7, sigma=1e-2)[0]
    ref = _engine_run(JaxContext, 7, sigma=1e-2)[0]
    real = port.straggler_crosscheck(), ref.straggler_crosscheck()
    assert real[0]["analytic_s"] == real[1]["analytic_s"]
    assert real[0]["scheduler"] == real[1]["scheduler"] == "mpi-list"
    injected = sum(port.virtual_gaps) / len(port.virtual_gaps)
    for r in real:
        assert abs(r["empirical_s"] - injected) < 0.5 * injected
    port.gaps, ref.gaps = list(port.virtual_gaps), list(ref.virtual_gaps)
    assert port.straggler_crosscheck() == ref.straggler_crosscheck()
    assert port.straggler_crosscheck(factor=2.0) == \
        ref.straggler_crosscheck(factor=2.0)


def test_crosscheck_needs_injected_jitter():
    for ctx_cls in (Context, JaxContext):
        C = ctx_cls(4, engine_workers=2)
        assert C.iterates(8).map(lambda x: 2 * x).collect() == \
            [2 * x for x in range(8)]
        with pytest.raises(ValueError, match="straggler_sigma"):
            C.straggler_crosscheck()
        with pytest.raises(ValueError, match="no engine-mode"):
            ctx_cls(4).straggler_crosscheck()


def test_engine_rank_failure_raises():
    def bad(x):
        if x == 5:
            raise ZeroDivisionError("rank block")
        return x
    for ctx_cls in (Context, JaxContext):
        with pytest.raises(RuntimeError, match="mpi-list rank"):
            ctx_cls(4, engine_workers=2).iterates(8).map(bad)


@pytest.mark.parametrize("ranks", [1, 3, 4])
def test_pipeline_packs_through_the_context_as_jax(ranks):
    docs = pipeline.SyntheticCorpus(512, seed=5, mean_len=40).docs(12)
    ours = pipeline.pack_documents(Context(ranks), docs, 33)
    theirs = jax_pipeline.pack_documents(JaxContext(ranks), docs, 33)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    p = pipeline.Pipeline(512, 32, 4, seed=2, n_ranks=ranks)
    assert p.ctx.procs == ranks
    b = next(iter(p.batches(1)))
    jb = next(iter(jax_pipeline.Pipeline(512, 32, 4, seed=2,
                                         n_ranks=ranks).batches(1)))
    for k in ("tokens", "labels"):
        assert np.array_equal(b[k], jb[k])


def test_pipeline_holds_a_four_rank_context():
    assert pipeline.Pipeline(512, 32, 4).ctx.procs == 4


# ------------------------------------------------------------ mesh_ops

N = 64


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 4)).astype(np.float32),
            "y": rng.integers(-50, 50, n).astype(np.int32)}


def _port(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _jax(mesh, tree):
    return {k: jax_mesh_ops.scatter(mesh, v) for k, v in tree.items()}


def _fp32_tol(x, axis=0):
    """N * u * sum|x| along the list dim."""
    return x.shape[axis] * U * np.abs(x.astype(np.float64)).sum(axis=axis)


def test_iterates_equal(mesh):
    ours = mesh_ops.iterates("cpu", 32)
    theirs = np.asarray(jax_mesh_ops.iterates(mesh, 32))
    assert ours.dtype == torch.int32 and theirs.dtype == np.int32
    assert np.array_equal(mesh_ops.collect(ours), theirs)
    assert np.array_equal(mesh_ops.collect(
        mesh_ops.scatter("cpu", theirs.copy())), theirs)


@pytest.mark.parametrize("donate", [False, True])
def test_map_equal(mesh, donate):
    sq = mesh_ops.dfm_map("cpu", lambda x: x * x, mesh_ops.iterates("cpu", 32),
                          donate=donate)
    assert sq.dtype == torch.int32
    assert np.array_equal(mesh_ops.collect(sq), np.asarray(
        jax_mesh_ops.dfm_map(mesh, lambda x: x * x,
                             jax_mesh_ops.iterates(mesh, 32))))
    data = _data(1)

    def f(t):
        return {"x": t["x"] * 2.0 + 1.0, "y": t["y"] * 3,
                "n": (t["x"] * t["x"]).sum()}
    ours = mesh_ops.collect(mesh_ops.dfm_map("cpu", f, _port(data)))
    theirs = jax_mesh_ops.collect(jax_mesh_ops.dfm_map(mesh, f,
                                                       _jax(mesh, data)))
    assert sorted(ours) == sorted(theirs)
    assert np.array_equal(ours["x"], np.asarray(theirs["x"]))
    assert np.array_equal(ours["y"], np.asarray(theirs["y"]))
    np.testing.assert_allclose(ours["n"], np.asarray(theirs["n"]), rtol=0,
                               atol=float(_fp32_tol(data["x"], 1).max()))


def test_map_rejects_data_dependent_control_flow_as_jax(mesh):
    def f(x):
        return x * 2 if x > 3 else x
    with pytest.raises(RuntimeError):
        mesh_ops.dfm_map("cpu", f, mesh_ops.iterates("cpu", 8))
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jax_mesh_ops.dfm_map(mesh, f, jax_mesh_ops.iterates(mesh, 8))


def test_sum_and_reduce_equal(mesh):
    data = _data(2)
    ours, theirs = _port(data), _jax(mesh, data)
    s = mesh_ops.dfm_sum("cpu", ours)
    js = jax_mesh_ops.dfm_sum(mesh, theirs)
    assert s["y"].dtype == torch.int32 and int(s["y"]) == int(js["y"]) \
        == int(data["y"].astype(np.int64).sum())
    tol = _fp32_tol(data["x"])
    exact = data["x"].astype(np.float64).sum(axis=0)
    assert np.all(np.abs(s["x"].numpy() - exact) <= tol)
    assert np.all(np.abs(np.asarray(js["x"]) - exact) <= tol)
    for name, f in (("add", lambda a, b: a + b),
                    ("max", lambda a, b: torch.maximum(a, b)
                     if isinstance(a, torch.Tensor) else jnp.maximum(a, b))):
        for n in (1, 2, 7, N):
            sub = {k: v[:n] for k, v in data.items()}
            r = mesh_ops.collect(mesh_ops.dfm_reduce("cpu", f, _port(sub)))
            # on arrays without a sharding: the JAX reduce's strided slices
            # of an array on the mesh raise ShardingTypeError on jax 0.9
            jr = jax_mesh_ops.collect(jax_mesh_ops.dfm_reduce(
                mesh, f, {k: jnp.asarray(v) for k, v in sub.items()}))
            assert np.array_equal(r["y"], np.asarray(jr["y"]))
            if name == "max":
                assert np.array_equal(r["x"], np.asarray(jr["x"]))
                assert np.array_equal(r["x"], sub["x"].max(axis=0))
            else:
                # the same pairwise order on both sides
                assert np.all(np.abs(r["x"] - np.asarray(jr["x"]))
                              <= _fp32_tol(sub["x"]))


def _affine(p, q):
    """x -> a x + b as rows (a, b): p first, then q (not commutative)."""
    lib = torch if isinstance(p, torch.Tensor) else jnp
    a = p[..., 0] * q[..., 0]
    b = q[..., 0] * p[..., 1] + q[..., 1]
    return lib.stack([a, b], axis=-1) if lib is jnp \
        else torch.stack([a, b], dim=-1)


def _affine_scan_exact(rows):
    out, acc = [], np.array([1.0, 0.0])
    for a, b in rows.astype(np.float64):
        acc = np.array([acc[0] * a, a * acc[1] + b])
        out.append(acc)
    return np.asarray(out)


@pytest.mark.parametrize("n", [1, 2, 5, N, 100])
def test_scan_equal(mesh, n):
    data = _data(3, n)
    ours, theirs = _port(data), _jax(mesh, data)
    add = mesh_ops.collect(mesh_ops.dfm_scan("cpu", lambda a, b: a + b, ours))
    jadd = jax_mesh_ops.collect(jax_mesh_ops.dfm_scan(
        mesh, lambda a, b: a + b, theirs))
    assert np.array_equal(add["y"], np.asarray(jadd["y"]))
    assert np.array_equal(add["y"], np.cumsum(data["y"]).astype(np.int32))
    exact = np.cumsum(data["x"].astype(np.float64), axis=0)
    tol = n * U * np.cumsum(np.abs(data["x"].astype(np.float64)), axis=0)
    assert np.all(np.abs(add["x"] - exact) <= tol)
    assert np.all(np.abs(np.asarray(jadd["x"]) - exact) <= tol)
    mx = mesh_ops.collect(mesh_ops.dfm_scan("cpu", torch.maximum, ours))
    jmx = jax_mesh_ops.collect(jax_mesh_ops.dfm_scan(mesh, jnp.maximum,
                                                     theirs))
    for k in ("x", "y"):
        assert np.array_equal(mx[k], np.asarray(jmx[k]))
        assert np.array_equal(mx[k], np.maximum.accumulate(data[k], axis=0))
    # a non-commutative monoid: a in {-1, 1} and small integer b keep every
    # composition exact in fp32, so any swapped operand shows
    rng = np.random.default_rng(n)
    rows = np.stack([rng.choice([-1.0, 1.0], n),
                     rng.integers(-9, 10, n)], axis=-1).astype(np.float32)
    aff = mesh_ops.collect(mesh_ops.dfm_scan("cpu", _affine,
                                             torch.from_numpy(rows)))
    jaff = np.asarray(jax_mesh_ops.dfm_scan(mesh, _affine,
                                            jax_mesh_ops.scatter(mesh, rows)))
    assert np.array_equal(aff, jaff)
    assert np.array_equal(aff, _affine_scan_exact(rows))
    # and with real-valued coefficients, to the fp32 rounding of a product
    # chain of n terms (|a| <= 1, so each b-term is bounded by |b|)
    real = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    raff = mesh_ops.collect(mesh_ops.dfm_scan("cpu", _affine,
                                              torch.from_numpy(real)))
    rjaff = np.asarray(jax_mesh_ops.dfm_scan(mesh, _affine,
                                             jax_mesh_ops.scatter(mesh, real)))
    rex = _affine_scan_exact(real)
    lim = 4 * n * U * (1 + np.cumsum(np.abs(real[:, 1])))
    assert np.all(np.abs(raff - rex) <= lim[:, None])
    assert np.all(np.abs(rjaff - rex) <= lim[:, None])


def test_repartition_equal(mesh):
    data = _data(4)
    ours = mesh_ops.collect(mesh_ops.repartition("cpu", _port(data)))
    theirs = jax_mesh_ops.collect(jax_mesh_ops.repartition(mesh,
                                                           _jax(mesh, data)))
    for k in data:
        assert np.array_equal(ours[k], np.asarray(theirs[k]))
        assert np.array_equal(ours[k], data[k])
    lst = mesh_ops.repartition("cpu", [np.arange(3), (np.ones(2),)])
    assert isinstance(lst, list) and isinstance(lst[1], tuple)
    assert isinstance(lst[1][0], torch.Tensor)


@pytest.mark.parametrize("buckets", [1, 3, 7])
def test_group_is_a_stable_bucket_sort(buckets):
    data = _data(5, 200)
    dest = np.random.default_rng(buckets).integers(0, buckets, 200)
    out = mesh_ops.collect(mesh_ops.group("cpu", torch.from_numpy(dest),
                                          _port(data)))
    order = np.argsort(dest, kind="stable")
    for k in data:
        assert np.array_equal(out[k], data[k][order])
    single = mesh_ops.group("cpu", [i % 3 for i in range(32)],
                            mesh_ops.iterates("cpu", 32))
    assert mesh_ops.collect(single).tolist() == \
        [i for r in range(3) for i in range(r, 32, 3)]


@pytest.mark.parametrize("device", [("cpu", "cpu"), ["cpu"], None, 0])
def test_anything_but_one_device_raises(device):
    with pytest.raises(NotImplementedError, match="one device"):
        mesh_ops.iterates(device, 4)
    with pytest.raises(NotImplementedError, match="one device"):
        mesh_ops.dfm_sum(device, torch.ones(3))


def test_bridge_single_device_program():
    """tests/test_mpi_list.py::test_mesh_bridge_single_device's program on
    the port, `group` included."""
    dfm = mesh_ops.iterates("cpu", 32)
    out = mesh_ops.dfm_map("cpu", lambda x: x * x, dfm)
    assert int(mesh_ops.dfm_sum("cpu", out)) == sum(i * i for i in range(32))
    sc = mesh_ops.dfm_scan("cpu", lambda a, b: a + b, dfm)
    assert int(sc[-1]) == sum(range(32))
    grouped = mesh_ops.group("cpu", torch.tensor([i % 3 for i in range(32)]),
                             dfm)
    assert sorted(mesh_ops.collect(grouped).tolist()) == list(range(32))
    assert math.isclose(float(mesh_ops.dfm_sum("cpu", dfm.float())), 496.0)
