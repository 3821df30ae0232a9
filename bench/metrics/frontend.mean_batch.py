"""Requests a batch that the front door formed (`core/serving.Frontend`'s
BATCH_FORMED events in the engine's trace) in the traced span."""


def read(run):
    if not run.formed:
        return None
    return sum(run.formed) / len(run.formed)
