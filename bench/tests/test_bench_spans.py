"""Device time by program span, on the CPU: attribution by correlation id
on synthetic events, the front door's and the engine's readings of SPAN
events, the fit of the program's clock to a CPU profile's, and the
accepted trace readers' values with and without the program's ranges."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import span_report  # noqa: E402
from bench.harness import spans, spec  # noqa: E402
from bench.harness import trace as tracing  # noqa: E402
from repro_torch.core.engine import TraceRecorder  # noqa: E402
from repro_torch.core.engine.model import SPAN  # noqa: E402
from repro_torch.core.engine.tracing import span  # noqa: E402

DEVICE = {"kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation"}


class Ev:
    """A raw profiler event as torch gives it."""

    def __init__(self, kind, name, t0, dt, corr=0):
        self._kind, self._name, self._t0, self._dt = kind, name, t0, dt
        self._corr = corr

    def activity_type(self):
        return self._kind

    def device_type(self):
        return DeviceType.CUDA if self._kind in DEVICE else DeviceType.CPU

    def name(self):
        return self._name

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._dt

    def start_us(self):
        return self._t0 / 1000

    def duration_us(self):
        return self._dt / 1000

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return 1


class OldEv(Ev):
    """The same event from a torch that gives no `activity_type`."""
    activity_type = None

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return super().__getattribute__(name)

    def is_user_annotation(self):
        return self._kind.endswith("user_annotation")


def synthetic(E=Ev):
    return [
        E("user_annotation", "serve_step.decode", 0, 100),
        E("user_annotation", "block.attention", 10, 40),
        E("user_annotation", "attention.core", 20, 20),
        E("user_annotation", "block.ffn", 60, 30),
        E("user_annotation", "not.program", 0, 100),
        E("cuda_runtime", "cudaLaunchKernel", 25, 2, corr=1),
        E("cuda_runtime", "cudaMemcpyAsync", 70, 2, corr=2),
        E("cuda_runtime", "cudaMemsetAsync", 5, 2, corr=3),
        E("cuda_driver" if E is Ev else "cuda_runtime", "cuLaunchKernelEx",
          200, 2, corr=4),
        E("kernel", "gemv", 300, 1000, corr=1),
        E("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1400, 2000,
          corr=2),
        E("gpu_memset", "Memset (Device)", 3500, 500, corr=3),
        E("kernel", "flash", 4100, 100, corr=4),
        E("kernel", "orphan", 4300, 50, corr=99),
        E("gpu_user_annotation", "attention.core", 300, 1000, corr=1),
    ]


@pytest.mark.parametrize("E", [Ev, OldEv])
def test_device_time_goes_to_the_innermost_open_span(E):
    st = spans.from_events(synthetic(E))
    assert st.total_s == pytest.approx(3650e-9)
    assert st.by_path == pytest.approx({
        ("serve_step.decode", "block.attention", "attention.core"): 1e-6,
        ("serve_step.decode", "block.ffn"): 2e-6,
        ("serve_step.decode",): 0.5e-6, (): 150e-9})
    assert st.under("serve_step.decode", "attention.core") == \
        pytest.approx(1e-6)
    assert st.under("block.ffn") == pytest.approx(2e-6)
    assert st.under("serve_step.decode") == pytest.approx(3.5e-6)
    assert st.named_share() == pytest.approx(3500 / 3650)
    assert list(st.innermost()) == ["block.ffn", "attention.core",
                                    "serve_step.decode", ""]
    assert st.counts == {"serve_step.decode": 1, "block.attention": 1,
                         "attention.core": 1, "block.ffn": 1}
    assert st.top_ops("serve_step.decode") == [
        ["Memcpy DtoD (Device -> Device)", pytest.approx(2e-6)],
        ["gemv", pytest.approx(1e-6)],
        ["Memset (Device)", pytest.approx(0.5e-6)]]
    assert st.top_ops("attention.core", n=1) == [["gemv",
                                                  pytest.approx(1e-6)]]


def test_paths_follow_nesting_and_ends():
    ranges = [(0, 10, "a"), (2, 4, "b"), (3, 3, "c"), (6, 20, "d")]
    assert spans.paths(ranges, [1, 3, 5, 7, 15, 30]) == [
        ("a",), ("a", "b", "c"), ("a",), ("a", "d"), ("d",), ()]


def span_events(rows):
    """SPAN events from (name, t0, t1, extra) rows."""
    tr = TraceRecorder()
    for name, t0, t1, extra in rows:
        tr.emit_at(t1, SPAN, name=name, t0=t0, parent=None, **extra)
    return tr.of(SPAN)


def test_queue_wait_and_turnaround_read_the_span_events():
    ev = span_events([
        ("serve.batch", 1.0, 3.0, {"size": 2, "wait_sum_s": 0.5}),
        ("serve.execute", 1.1, 2.9, {}),
        ("serve.batch", 3.1, 5.0, {"size": 2, "wait_sum_s": 1.5}),
        ("serve.execute", 3.2, 4.9, {}),
        ("serve.batch", 5.4, 7.1, {"size": 1, "wait_sum_s": 0.0}),
        ("serve.execute", 5.5, 7.0, {})])
    assert spans.queue_wait_ms(ev) == pytest.approx(2000 / 5)
    # the third batch formed after the second's execute ended: left out
    assert spans.turnaround_ms(ev, [0.9, 2.0, 5.3]) == pytest.approx(300)
    assert spans.turnaround_ms(ev, [0.9, 3.0, 5.3]) is None
    assert spans.queue_wait_ms([]) is None


def test_clock_fit_on_a_cpu_profile():
    tr = TraceRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(40):
            with span("serve.batch", tr, size=1, wait_sum_s=0.0):
                with span("serve.execute", tr):
                    torch.ones(64).sum()
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if spans.kind(e) == "user_annotation"]
    ev = tr.of(SPAN)
    place, dist = spans.fit_clock(ev, ranges)
    assert len(dist) == 4 * 40
    assert dist[len(dist) // 2] < 50e-6
    # the engine's events land on their ranges
    ex = sorted(e.t for e in ev if e.extra["name"] == "serve.execute")
    ends = sorted(b for _, b, n in ranges if n == "serve.execute")
    near = sorted(abs(place(t) - b) for t, b in zip(ex, ends))
    assert near[len(near) // 2] < 50e3
    with pytest.raises(ValueError):
        spans.fit_clock(ev, ranges[1:])


class Prof:
    def __init__(self, events):
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events))


def base_events():
    ms = 1_000_000
    return [
        Ev("cpu_op", "aten::mm", 0, 4 * ms),
        Ev("cpu_op", "aten::add", 5 * ms, 3 * ms),
        Ev("kernel", "k1", 0, 2 * ms),
        Ev("kernel", "k2", 1 * ms, 2 * ms),
        Ev("kernel", "flash_fwd_tc<128>", 10 * ms, 1 * ms),
        Ev("gpu_memset", "Memset (Device)", 25 * ms // 2, ms // 2),
    ]


def program_events():
    ms = 1_000_000
    return [Ev("user_annotation", "serve.execute", 0, 13 * ms),
            Ev("user_annotation", "serve_step.decode", 4 * ms, 8 * ms),
            Ev("gpu_user_annotation", "serve_step.decode", 9 * ms, 4 * ms)]


def test_accepted_readers_do_not_see_the_program_ranges():
    plain = tracing.collect(Prof(base_events()))
    named = tracing.collect(Prof(base_events() + program_events()))
    assert plain.kernels == named.kernels
    assert plain.busy_s() == named.busy_s()
    assert plain.top_ops() == named.top_ops()
    assert [g[1] for g in plain.idle_gaps()] == \
        [g[1] for g in named.idle_gaps()]
    # only the names of the gaps change: after the innermost host range
    assert [g[0] for g in plain.idle_gaps()] == ["aten::add", "host idle"]
    assert [g[0] for g in named.idle_gaps()] == ["aten::add",
                                                 "serve_step.decode"]
    cell = spec.load("deepseek-7b.serve.backlog4k")
    values = []
    for tr in (plain, named):
        run = SimpleNamespace(
            cell=cell, model=cell.model, traffic=cell.traffic, span_s=0.02,
            batches=[{"b": 8, "steps": 15, "prefill_s": 1.1,
                      "decode_s": 1.4}], formed=[8],
            launches={"flash": 30}, trace=tr)
        values.append({m["name"]: spec.reader(m["name"])(run)
                       for m in cell.per_layer})
    assert values[0] == values[1] and len(values[0]) == 6
    assert all(v is not None for v in values[0].values())


def test_execute_gaps_are_named_after_the_open_spans():
    tr = tracing.collect(Prof(base_events()))
    ms = 1_000_000
    ranges = [(0, 13 * ms, "serve.execute"),
              (4 * ms, 12 * ms, "serve_step.decode")]
    assert span_report.execute_gaps(tr, ranges) == [
        [["serve.execute", "serve_step.decode"], pytest.approx(7e-3)],
        [["serve.execute", "serve_step.decode"], pytest.approx(1.5e-3)]]
    assert span_report.execute_gaps(tr, ranges[1:]) == []
