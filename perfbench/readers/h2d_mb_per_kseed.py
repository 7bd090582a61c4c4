"""Megabytes the runner copies host to card a thousand seeds: the
``runner.h2d_bytes`` counter (the table and offsets at each ``run``
call, each epoch's staged arrays at its boundary) over the seeds of the
whole-job traced pass's epochs."""
from perfbench.spans import per_kseed, spans_of


def read(ctx, spec):
    n = (getattr(ctx, "spans", None) or {}).get("counters", {}).get(
        "runner.h2d_bytes")
    epochs = sum(s["name"] == "runner.epoch"
                 for s in spans_of(ctx, "spans"))
    if n is None or not epochs or not ctx.reports:
        return None
    return per_kseed(n / 1e6, ctx.seeds / len(ctx.reports) * epochs)
