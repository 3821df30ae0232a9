"""Whole runs of the harness past its look for a card: a sound run comes
out correct, and a run whose timed path is broken underneath, or whose
program is the control (the reference in fp8), comes out not correct.  On
the CPU at a small size; the control against the committed limit at the
cell's own size, on the card."""
import time

import pytest
import torch

from bench import run as bench_run
from bench.harness import serve, spec
from bench.tests.small import small_cell

SERVE = ["deepseek-7b.serve.backlog4k"]


def one_run(cell, seed=2**31 + 3, seconds=3.0, device="cpu"):
    fields, record, numbers = serve.run(cell, seed, seconds, False, device,
                                        time.perf_counter())
    return bench_run.result_line(cell, fields, record, numbers, False,
                                 device, 1)


@pytest.mark.parametrize("workload", SERVE)
def test_a_sound_run_is_correct(workload):
    out = one_run(small_cell(workload))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"tokens_per_s", "setup_s"}


@pytest.mark.parametrize("workload", SERVE)
def test_the_front_door_forms_the_mixs_batches(workload):
    """The mix's `target_eff` lifts the METG target to `max_batch`, so the
    closed loop's clients are served a full batch at a time."""
    cell = small_cell(workload)
    _, record, _ = serve.run(cell, 7, 3.0, True, "cpu", time.perf_counter())
    formed = record["formed"]
    assert formed and max(formed) == cell.traffic["max_batch"]
    assert sum(formed) / len(formed) > 0.75 * cell.traffic["max_batch"]
    assert spec.reader("frontend.mean_batch")(
        type("Run", (), record)) == sum(formed) / len(formed)


@pytest.mark.parametrize("workload", SERVE)
def test_a_token_altered_where_it_is_produced(workload, monkeypatch):
    from repro_torch.runtime import serve_step
    greedy = serve_step._greedy

    def altered(logits, vocab_size):
        tok = greedy(logits, vocab_size)
        tok[0] = (tok[0] + 1) % vocab_size        # one row's token, each step
        return tok

    monkeypatch.setattr(serve_step, "_greedy", altered)
    out = one_run(small_cell(workload))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_reads_wider_than_the_program(workload, seed):
    """At every position of four 64-token rows: the widest gap of the
    program's bf16 argmax and of the fp8 control's, each against the fp32
    reference.  At this size the control's gaps are smaller than at the
    cell's (the card test below holds those to the limit); what holds here
    is the separation."""
    import numpy as np

    from bench.harness import weights
    from bench.reference import lm
    from repro_torch.models.common import Options
    from repro_torch.models.model import build_model
    cell = small_cell(workload)
    model = build_model(serve.port_config(cell.config),
                        Options(q_block=16, kv_block=16))
    params = weights.make(weights.layout(model), cell.config["init"], seed,
                          "cpu")
    V = cell.model["vocab_size"]
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, V, size=(4, 64)))
    pos = list(range(64))
    ref = lm.logits_at(params, cell.model, toks, pos)
    best = ref.max(-1).values

    def widest(logits):
        pick = logits[..., :V].float().argmax(-1)
        return float((best - ref.gather(-1, pick[..., None])[..., 0]).max())

    program = widest(model.forward(params, {"tokens": toks}))
    control = widest(lm.logits_at(params, cell.model, toks, pos,
                                  precision="fp8"))
    assert control > 3 * program and control > 0.1, (program, control)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SERVE)
def test_the_control_in_the_programs_place_is_not_correct(workload, card,
                                                          monkeypatch):
    """A whole run at the cell's own size and load, whose compared number is
    the control's (the tokens the fp8 reference puts first at the served
    positions), judged by `result_line` against the committed limit."""
    program_gaps = serve.gaps

    def control_in_place(sess, picked, **kw):
        g = program_gaps(sess, picked, control=True)
        return {"max_logit_gap": g["control_max_logit_gap"],
                "tokens_compared": g["tokens_compared"]}

    monkeypatch.setattr(serve, "gaps", control_in_place)
    out = one_run(spec.load(workload), seconds=10.0, device=card)
    assert out["checks"]["max_logit_gap"]["limit"] == \
        spec.load(workload).limits["max_logit_gap"]
    assert not out["correct"], out["checks"]
