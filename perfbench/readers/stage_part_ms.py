"""Milliseconds a staged epoch of one part of staging, the spans named
by ``spec["span"]`` inside the staging thread's ``runner.stage`` spans
(the bootstrap's left out), over the whole-job traced pass."""
from perfbench.spans import spans_of, stage_parts_ms


def read(ctx, spec):
    return stage_parts_ms(spans_of(ctx, "spans")).get(spec["span"])
