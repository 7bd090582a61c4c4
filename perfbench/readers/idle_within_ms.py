"""Milliseconds an epoch the card sat idle while the runner thread was
inside a span named ``spec["span"]`` (its children included), over the
pass traced with the host's operators: the gaps between the card's
busy intervals in that pass's slice, met with the span's intervals."""
from perfbench.spans import idle_within, spans_of


def read(ctx, spec):
    sp = spans_of(ctx, "gap_spans")
    epochs = sum(s["name"] == "runner.epoch" for s in sp)
    tr = getattr(ctx, "gap_trace", None)
    if not epochs or tr is None or not tr.events:
        return None
    start, end = ctx.gap_slice
    ns = idle_within(sp, spec["span"], tr.busy_intervals(), start, end)
    return ns / 1e6 / epochs
