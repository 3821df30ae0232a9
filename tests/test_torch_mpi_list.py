"""Port parity for mpi-list: the properties of tests/test_mpi_list.py, run
through the JAX package's `Context` and the port's on the same inputs.
Both must satisfy the paper's partition law and the monoid / functor laws,
and give equal outputs, block for block."""
import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.mpi_list import Context as JaxContext  # noqa: E402
from repro.core.mpi_list import partition_bounds as jax_bounds  # noqa: E402
from repro_torch.core.mpi_list import Context, partition_bounds  # noqa: E402


@given(st.integers(0, 500), st.integers(1, 32))
def test_partition_law(N, P):
    spans = [partition_bounds(N, P, p) for p in range(P)]
    assert spans == [jax_bounds(N, P, p) for p in range(P)]
    assert spans[0][0] == 0 and spans[-1][1] == N
    for (s0, e0), (s1, e1) in zip(spans, spans[1:]):
        assert e0 == s1
    sizes = [e - s for s, e in spans]
    assert max(sizes) - min(sizes) <= 1


@given(st.integers(0, 200), st.integers(1, 16))
def test_iterates_collect_roundtrip(N, P):
    dfm, ref = Context(P).iterates(N), JaxContext(P).iterates(N)
    dfm.check_partition_law()
    assert dfm.parts == ref.parts
    assert dfm.collect() == ref.collect() == list(range(N))


@given(st.lists(st.integers(-100, 100), max_size=100), st.integers(1, 8))
def test_map_functor_law(xs, P):
    f, g = (lambda x: x + 1), (lambda x: x * 2)
    out = {}
    for side, C in (("jax", JaxContext(P)), ("port", Context(P))):
        a = C.scatter(xs).map(f).map(g)
        b = C.scatter(xs).map(lambda x: g(f(x)))
        assert a.collect() == b.collect() == [g(f(x)) for x in xs]
        out[side] = a.parts
    assert out["port"] == out["jax"]


@given(st.lists(st.integers(-50, 50), max_size=80), st.integers(1, 8))
def test_reduce_and_scan(xs, P):
    port, ref = Context(P).scatter(xs), JaxContext(P).scatter(xs)
    add = lambda a, b: a + b  # noqa: E731
    assert port.reduce(add, 0) == ref.reduce(add, 0) == sum(xs)
    prefix = port.scan(add, 0)
    assert prefix.parts == ref.scan(add, 0).parts
    assert prefix.collect() == [int(v) for v in np.cumsum(xs)]


@given(st.lists(st.integers(0, 1000), max_size=80), st.integers(1, 8),
       st.integers(1, 5))
def test_group_conserves_elements(xs, P, K):
    out = {}
    for side, C in (("jax", JaxContext(P)), ("port", Context(P))):
        g = C.scatter(xs).group(lambda x: {x % K: [x]},
                                lambda p, recs: sorted(recs))
        assert sorted(sum(g.collect(), [])) == sorted(xs)
        out[side] = g.parts
    assert out["port"] == out["jax"]


@given(st.lists(st.lists(st.integers(), max_size=20), max_size=10),
       st.integers(1, 6))
def test_repartition_balances(chunks, P):
    out = {}
    for side, C in (("jax", JaxContext(P)), ("port", Context(P))):
        res = C.scatter(chunks).repartition(
            len, lambda x, n: [[e] for e in x],
            lambda cs: [e for c in cs for e in c])
        flat = [e for blk in res.parts for x in blk for e in x]
        assert flat == [e for c in chunks for e in c]
        N = sum(len(c) for c in chunks)
        for p, blk in enumerate(res.parts):
            s, e = partition_bounds(N, P, p)
            assert sum(len(x) for x in blk) == e - s
        out[side] = res.parts
    assert out["port"] == out["jax"]
