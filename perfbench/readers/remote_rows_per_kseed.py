"""Rows the exchange moves across workers per 1,000 seeds trained: the
window's ``DeviceEpochReport.wire_rows`` (the padded pull lanes of every
step, masked lanes included) summed over epochs, over the seeds."""


def read(ctx, spec):
    if not ctx.reports or ctx.seeds == 0:
        return None
    return sum(int(r.wire_rows) for r in ctx.reports) / (ctx.seeds / 1000.0)
