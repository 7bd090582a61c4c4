"""Helpers the readers share: a per-epoch mean of a report timing, and
a kernel group's share of its byte roofline over the traced pass."""


def window_mean_ms(ctx, field, staged_only=False):
    """The mean over the window's epochs of ``DeviceEpochReport.<field>``
    (seconds) in milliseconds; ``staged_only`` keeps the epochs that
    staged a successor (a pass's last epoch stages nothing)."""
    vals = [float(getattr(r, field)) for r in ctx.reports]
    if staged_only:
        vals = [v for v in vals if v > 0.0]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)


def roofline_share(ctx, spec, batch_bytes):
    """The bytes the traced epochs' work needs (``batch_bytes(ctx, wc)``
    per worker-epoch of schedule counts ``wc``, with its hot-set size
    under ``n_hot``) over the card's HBM rate, divided by the traced
    time of the kernels named in ``spec["trace_names"]``; in percent."""
    tr = ctx.trace
    if tr is None or not ctx.traced_epochs:
        return None
    t = tr.kernel_seconds(spec["trace_names"])
    if t <= 0:
        return None
    nbytes = 0
    for e in ctx.traced_epochs:
        s = ctx.summary(e)
        for wc, n_hot in zip(s["workers"], s["n_hot_used"]):
            if wc["m"].size:
                nbytes += batch_bytes(ctx, dict(wc, n_hot=n_hot))
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / t
