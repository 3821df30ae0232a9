"""Decode milliseconds a step: `runtime/serve_step.greedy_generate`'s
timings["decode_s"] over its decode steps (max_new - 1 a batch), summed
over the batches run in the traced span."""


def read(run):
    b = [x for x in run.batches if "decode_s" in x]
    steps = sum(x["steps"] for x in b)
    if not steps:
        return None
    return sum(x["decode_s"] for x in b) / steps * 1e3
