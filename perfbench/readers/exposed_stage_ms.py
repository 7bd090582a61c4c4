"""Staging wall left exposed after training, per epoch of the window
(``DeviceEpochReport.exposed_stage_s``)."""
from perfbench.readers.common import window_mean_ms


def read(ctx, spec):
    return window_mean_ms(ctx, "exposed_stage_s")
