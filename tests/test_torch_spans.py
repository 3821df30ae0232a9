"""The port's program spans (`repro_torch.core.engine.tracing.span`): free
when nothing records, the layer tree under a CPU profiler, the front door's
SPAN events on the engine's clock, and their Chrome-trace slices."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.engine import Engine, ManualClock, TraceRecorder
from repro_torch.core.engine import tracing
from repro_torch.core.engine.model import SPAN
from repro_torch.core.obs import to_chrome_trace
from repro_torch.core.serving import Frontend
from repro_torch.models.common import Options
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_step import greedy_generate

T = 30.0
MAX_NEW = 4


@pytest.fixture(scope="module")
def deepseek():
    cfg = get_config("deepseek-7b").reduced()
    model = build_model(cfg, Options())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    return cfg, model, params, {"tokens": toks}


def generate(deepseek):
    _, model, params, batch = deepseek
    return greedy_generate(model, params, batch, MAX_NEW, 6 + MAX_NEW + 1)


def test_no_tracer_no_profiler_is_one_shared_null_context(deepseek,
                                                          monkeypatch):
    made, entered = [], []

    class Counted(tracing._Range):
        def __init__(self, name):
            made.append(name)
            super().__init__(name)

    real = torch._C._autograd._record_function_with_args_enter

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(tracing, "_Range", Counted)
    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter", counted)
    assert tracing.span("a") is tracing.span("b", None) is tracing._NO_SPAN
    out = generate(deepseek)
    assert out.shape == (2, MAX_NEW)
    assert made == [] and entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        generate(deepseek)
    assert "serve_step.decode" in entered and "block.ffn" in made


def ranges_of(prof) -> list:
    return sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if str(e.activity_type()) == "user_annotation"),
                  key=lambda r: (r[0], -r[1]))


def inside(ranges, outer) -> list:
    return [r[2] for r in ranges if r is not outer
            and outer[0] <= r[0] and r[1] <= outer[1]]


def test_profiled_generate_gives_the_layer_tree(deepseek):
    cfg = deepseek[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plain = generate(deepseek)
    assert torch.equal(plain, generate(deepseek))
    ranges = ranges_of(prof)
    names = [r[2] for r in ranges]
    for name in ("serve_step.cache_init", "serve_step.prefill"):
        assert names.count(name) == 1
    decode = [r for r in ranges if r[2] == "serve_step.decode"]
    assert len(decode) == MAX_NEW - 1
    L = cfg.n_layers
    for step in decode:
        held = inside(ranges, step)
        for name in ("block.attention", "attention.qkv",
                     "attention.cache_write", "attention.core",
                     "attention.out", "block.ffn"):
            assert held.count(name) == L, (name, held)
        assert held.count("model.embed") == held.count("model.head") == 1
        assert held.count("serve_step.sample") == 1
        # each block's attention holds its four children once, the FFN none
        for blk in (r for r in ranges if r[2] == "block.attention"
                    and step[0] <= r[0] and r[1] <= step[1]):
            assert sorted(inside(ranges, blk)) == [
                "attention.cache_write", "attention.core", "attention.out",
                "attention.qkv"]
    for ffn in (r for r in ranges if r[2] == "block.ffn"):
        assert inside(ranges, ffn) == []
    # prefill writes the cache after each block, outside its attention
    prefill = next(r for r in ranges if r[2] == "serve_step.prefill")
    held = inside(ranges, prefill)
    assert held.count("attention.core") == held.count(
        "attention.cache_write") == held.count("block.ffn") == L


def test_span_records_on_the_tracers_clock():
    clk = ManualClock(tick=0.5)
    tr = TraceRecorder(clock=clk)
    with tracing.span("serve.batch", tr, size=3) as outer:
        outer.extra["seen"] = outer.t0
        with pytest.raises(ValueError):
            with tracing.span("serve.execute", tr):
                raise ValueError("kept")
    inner, outer_ev = tr.of(SPAN)
    assert inner.extra == {"name": "serve.execute", "t0": 1.0,
                           "parent": "serve.batch"}
    assert inner.t == 1.5
    assert outer_ev.extra == {"name": "serve.batch", "t0": 0.5,
                              "parent": None, "size": 3, "seen": 0.5}
    assert outer_ev.t == 2.0
    with tracing.span("again", tr):
        pass
    assert tr.of(SPAN)[-1].extra["parent"] is None


def served(tick=0.0):
    """Two requests queued at t=0 and t=0.25, the coalescer started at
    t=0.75 and flushed; then one more at t=1.0."""
    clk = ManualClock(tick=tick)
    eng = Engine(workers=1, resident=True, clock=clk, lease_timeout=120.0)
    fe = Frontend(eng, lambda ps: [p * 2 for p in ps], max_batch=4,
                  max_wait_s=10.0, per_request_s0=1e-6, max_queue=32)
    reqs = [fe.submit(1)]
    clk.advance(0.25)
    reqs.append(fe.submit(2))
    clk.advance(0.5)
    fe.start()
    fe.flush()
    for r in reqs:
        assert r.wait(T)
    clk.advance(0.25)
    late = fe.submit(3)
    fe.flush()
    assert late.wait(T)
    fe.close()
    return eng.shutdown().trace, reqs + [late]


def test_front_door_spans_carry_the_batches_waits():
    trace, reqs = served()
    spans = trace.of(SPAN)
    batches = [e for e in spans if e.extra["name"] == "serve.batch"]
    assert [e.extra["size"] for e in batches] == [2, 1]
    assert batches[0].extra["wait_sum_s"] == pytest.approx(0.75 + 0.5)
    assert batches[1].extra["wait_sum_s"] == pytest.approx(0.0)
    for b, rs in zip(batches, (reqs[:2], reqs[2:])):
        assert b.extra["wait_sum_s"] == pytest.approx(
            sum(b.extra["t0"] - r.t_enqueue for r in rs))
    assert [(e.extra["name"], e.extra["parent"]) for e in spans] == [
        ("serve.execute", "serve.batch"), ("serve.resolve", "serve.batch"),
        ("serve.batch", None)] * 2
    assert [r.value for r in reqs] == [2, 4, 6]


def test_front_door_spans_nest_in_order_under_a_ticking_clock():
    trace, _ = served(tick=1e-3)
    for b in (e for e in trace.of(SPAN) if e.extra["name"] == "serve.batch"):
        kids = [e for e in trace.of(SPAN) if e.extra["parent"]
                and b.extra["t0"] <= e.extra["t0"] and e.t <= b.t]
        ex, rs = sorted(kids, key=lambda e: e.extra["t0"])[:2]
        assert ex.extra["name"] == "serve.execute"
        assert b.extra["t0"] < ex.extra["t0"] < ex.t < rs.extra["t0"] < b.t


def test_chrome_trace_nests_spans_under_their_task():
    trace, _ = served(tick=1e-3)
    with tracing.span("outside", trace):
        pass
    doc = to_chrome_trace(trace)
    evs = doc["traceEvents"]
    lanes = {e["args"]["name"]: e["tid"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    tasks = [e for e in evs if e.get("cat") == "task"]
    spans = [e for e in evs if e.get("cat") == "span"]
    assert len(tasks) == 2 and len(spans) == 7
    for s in spans:
        if s["name"] == "outside":
            assert s["tid"] == lanes["spans"]
            continue
        assert s["tid"] == lanes["w0"]
        task = next(t for t in tasks if t["ts"] <= s["ts"]
                    and s["ts"] + s["dur"] <= t["ts"] + t["dur"])
        assert task["tid"] == s["tid"]
    batch = next(s for s in spans if s["name"] == "serve.batch")
    assert set(batch["args"]) == {"size", "wait_sum_s"}
    assert min(e["ts"] for e in evs if "ts" in e) >= 0.0
