"""The epoch-boundary copy of the staged arrays to the card, per epoch
of the window (``DeviceEpochReport.copy_s``, synchronised)."""
from perfbench.readers.common import window_mean_ms


def read(ctx, spec):
    return window_mean_ms(ctx, "copy_s")
