"""The card's idle share over the job's whole pass: one minus the union
of its kernel, copy and memset intervals in the traced pass, over the
median wall of the window's untraced whole passes, which do the same
work (the same epochs and schedules). The profiler slows the host's
dispatch, so over its own pass's wall the share would read high; with
no whole pass in the window, over the traced pass's wall."""


def read(ctx, spec):
    tr = ctx.trace
    if tr is None or not tr.events or tr.window_s <= 0:
        return None
    wall = ctx.window_pass_s or tr.window_s
    return 100.0 * (1.0 - tr.busy_s / wall)
