"""The staging thread's wall for one next epoch (schedule compile when
lazy, collation, C_sec), over the window's epochs that staged one
(``DeviceEpochReport.stage_s``)."""
from perfbench.readers.common import window_mean_ms


def read(ctx, spec):
    return window_mean_ms(ctx, "stage_s", staged_only=True)
