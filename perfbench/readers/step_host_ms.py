"""The host's milliseconds a step: the mean length of the runner
thread's ``epoch.step`` spans over the whole-job traced pass (dispatch
only; no step synchronises with the card)."""
from perfbench.spans import length_ns, spans_of


def read(ctx, spec):
    steps = [length_ns(s) for s in spans_of(ctx, "spans")
             if s["name"] == "epoch.step"]
    return sum(steps) / 1e6 / len(steps) if steps else None
