"""Prefill milliseconds a batch: `runtime/serve_step.greedy_generate`'s
timings["prefill_s"] (the device synchronised at each end), the mean over
the batches run in the traced span."""


def read(run):
    b = [x for x in run.batches if "prefill_s" in x]
    if not b:
        return None
    return sum(x["prefill_s"] for x in b) / len(b) * 1e3
