"""Port parity for the serving frontend: the same arrival script through
the JAX package's `Client.serve` and the port's, under a `ManualClock`
that only the script advances.

The script fixes the trace clock at every point where a batch forms or a
request resolves, so both sides must form the same batches (size, queue
wait, METG target, depth after) and report the same `LatencyReport`.
Every wait on a request is bounded."""
import pytest

import repro.client as jax_client
import repro.core.engine as jax_engine
import repro.core.serving as jax_serving
import repro_torch.client as port_client
import repro_torch.core.engine as port_engine
import repro_torch.core.serving as port_serving

SIDES = {"jax": (jax_client, jax_engine, jax_serving),
         "port": (port_client, port_engine, port_serving)}
T = 10.0


def batches_of(trace, E):
    return [(e.extra["size"], round(e.extra["wait_s"], 12),
             e.extra["target"], e.extra["depth"])
            for e in trace.of(E.BATCH_FORMED)]


def wait_all(reqs):
    for r in reqs:
        assert r.wait(T), f"{r} never resolved"


def scripted(side):
    """Ten requests queued before the coalescer starts (six at t=0, four
    at t=0.25), a deadline flush of the last two, then three more and an
    explicit flush."""
    _, E, S = SIDES[side]
    clk = E.ManualClock(tick=0.0)
    eng = E.Engine(workers=1, resident=True, clock=clk, lease_timeout=120.0)
    fe = S.Frontend(eng, lambda ps: [p * 2 for p in ps], max_batch=4,
                    max_wait_s=0.05, per_request_s0=1e-6, max_queue=32)
    reqs = [fe.submit(i) for i in range(6)]     # the coalescer is not up
    clk.advance(0.25)
    reqs += [fe.submit(i) for i in range(6, 10)]
    fe.start()
    wait_all(reqs[:8])
    pending = [r.done for r in reqs[8:]]
    clk.advance(0.1)                       # the last two pass max_wait
    wait_all(reqs[8:])
    more = [fe.submit(i) for i in range(10, 13)]
    fe.flush()
    wait_all(more)
    reqs += more
    fe.close()
    rep = eng.shutdown()
    lat = rep.trace.latency_report()
    out = {"values": [r.value for r in reqs], "ok": [r.ok for r in reqs],
           "latency": [r.latency_s for r in reqs],
           "pending_before_deadline": pending,
           "batches": batches_of(rep.trace, E),
           "report": lat.summary(), "n_batches": lat.n_batches,
           "mean_batch": lat.mean_batch, "stats": rep.backend_stats}
    return out


def test_scripted_arrivals_form_the_same_batches():
    port, jax = scripted("port"), scripted("jax")
    assert port == jax
    assert [b[0] for b in port["batches"]] == [4, 4, 2, 3]
    assert port["pending_before_deadline"] == [False, False]
    assert port["values"] == [2 * i for i in range(13)]
    assert port["latency"][8:10] == [pytest.approx(0.1)] * 2
    assert port["stats"]["completed"] == port["stats"]["created"] == 4


def driver_like(side, n=4, per_request_s0=0.05):
    """What the serve driver does: one worker, per_request_s0=0.05, the
    requests submitted one after another to a running frontend."""
    C, E, _ = SIDES[side]
    clk = E.ManualClock(tick=0.0)
    with C.Client(scheduler="dwork", workers=1, lease_timeout=120.0,
                  clock=clk) as c:
        fe = c.serve(lambda ps: [p + 1 for p in ps], max_queue=max(n, 16),
                     max_batch=max(n, 1), max_wait_s=0.02,
                     per_request_s0=per_request_s0)
        target = fe.target_batch()
        reqs = []
        for i in range(n):
            reqs.append(fe.submit(i))
            wait_all(reqs)
            clk.advance(0.5)
    rep = c.close()
    return (target, [r.value for r in reqs], batches_of(rep.trace, E),
            rep.trace.latency_report().summary(), rep.backend_stats)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_driver_traffic_is_one_request_a_batch(n):
    port, jax = driver_like("port", n), driver_like("jax", n)
    assert port == jax
    target, values, batches, _, stats = port
    assert target == 1 and values == [i + 1 for i in range(n)]
    assert [b[0] for b in batches] == [1] * n
    assert stats["completed"] == stats["created"] == n


def test_batch_target_follows_workers_shards_and_observed_time():
    out = {}
    for side, (C, E, S) in SIDES.items():
        eng = E.Engine(workers=4, resident=True, shards=2)
        fe = S.Frontend(eng, lambda ps: ps, max_batch=4096,
                        per_request_s0=1e-6)
        targets = [fe.target_batch()]
        eng._live = 16
        targets.append(fe.target_batch())
        fe._per_req_s = 1e-3
        targets.append(fe.target_batch())
        out[side] = targets
    assert out["port"] == out["jax"]
    assert out["port"][1] > out["port"][0] > out["port"][2]


def failures_and_backpressure(side):
    C, E, S = SIDES[side]
    clk = E.ManualClock(tick=0.0)
    eng = E.Engine(workers=1, resident=True, clock=clk)
    full = S.Frontend(eng, lambda ps: ps, max_queue=2, policy="reject")
    full.submit(0)
    full.submit(1)
    with pytest.raises(S.AdmissionFull):
        full.submit(2)
    bad = S.Frontend(eng, lambda ps: 1 / 0, max_wait_s=0.001)
    bad.start()
    r = bad.submit(1)
    assert r.wait(T) and not r.ok and "ZeroDivisionError" in r.error
    late = S.Frontend(eng, lambda ps: ps, max_batch=64, max_wait_s=5.0,
                      per_request_s0=1e-7)
    late.start()
    doomed = late.submit(1, timeout=0.05)
    kept = late.submit(2)
    clk.advance(0.1)
    assert doomed.wait(T) and doomed.timed_out and not doomed.ok
    late.flush()
    assert kept.wait(T) and kept.ok
    for fe in (bad, late):
        fe.close()
    rep = eng.shutdown()
    # request names carry a per-package sequence number: compare without
    return (full.rejected, r.error, doomed.error.replace(doomed.name, "R"),
            kept.value,
            late.stats(), rep.trace.latency_report().summary(),
            rep.trace.count(E.REQ_TIMEOUT), rep.trace.count(E.REQ_REJECTED))


def test_failures_timeouts_and_backpressure_agree():
    port = failures_and_backpressure("port")
    assert port == failures_and_backpressure("jax")
    assert port[0] == 1 and port[3] == 2 and port[6] == port[7] == 1


def test_serve_needs_a_resident_client():
    c = port_client.Client(resident=False)
    with pytest.raises(RuntimeError, match="resident"):
        c.serve(lambda ps: ps)
    eng = port_engine.Engine(workers=1)
    with pytest.raises(ValueError, match="resident"):
        port_serving.Frontend(eng, lambda ps: ps)
