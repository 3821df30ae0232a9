"""The share of the traced span in which no operation ran on the card: one
minus the union of the device operations' intervals over the span."""


def read(run):
    if run.trace is None or run.span_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.span_s)
