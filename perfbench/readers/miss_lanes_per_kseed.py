"""Residual-miss rows pulled across workers per 1,000 seeds trained:
the window's ``DeviceEpochReport.miss_lanes`` summed over workers and
epochs, over the seeds (rows actually requested; the padded rows the
exchange moves are ``remote_rows_per_kseed``)."""


def read(ctx, spec):
    if not ctx.reports or ctx.seeds == 0:
        return None
    rows = sum(int(r.miss_lanes.sum()) for r in ctx.reports)
    return rows / (ctx.seeds / 1000.0)
