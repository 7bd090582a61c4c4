"""Milliseconds a ``run`` call spends before its first epoch: the copy
of the table and offsets to the card (``runner.table_copy``) and the
synchronous bootstrap stage (``runner.stage`` with ``bootstrap``), over
the ``run`` calls of the whole-job traced pass."""
from perfbench.spans import length_ns, spans_of


def read(ctx, spec):
    sp = spans_of(ctx, "spans")
    runs = sum(s["name"] == "runner.run" for s in sp)
    if not runs:
        return None
    ns = sum(length_ns(s) for s in sp
             if s["name"] == "runner.table_copy"
             or (s["name"] == "runner.stage" and s["attrs"].get("bootstrap")))
    return ns / 1e6 / runs
