"""The whole served step's share of the card's bf16 peak: the model FLOPs
of the batches run in the traced span (`bench.harness.work.serve_flops`,
from the configuration's shapes alone), over the span, over 989 TFLOP/s."""
from bench.harness import work


def read(run):
    if not run.batches or run.span_s <= 0:
        return None
    t = run.traffic
    flops = sum(work.serve_flops(run.model, b["b"], t["prompt_len"],
                                 t["max_new"]) for b in run.batches)
    return 100.0 * flops / run.span_s / work.PEAK_BF16
