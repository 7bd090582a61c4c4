"""Host-sim oracle of the device epoch's fetch accounting, from the
reference's ``repro/dist/runner.py``.

Only ``host_miss_matrix`` is ported so far: the per-(epoch, worker)
``cache_misses`` of the host-sim ``RapidGNNRunner``, which the device
epoch's residual-miss pull lanes must equal exactly. The multi-epoch
device runners (``DeviceRapidGNNRunner``, ``DeviceBaselineRunner``,
``assert_host_parity``) are ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.schedule import WorkerSchedule


def host_miss_matrix(schedules: Sequence[WorkerSchedule], pg,
                     batch_size: int) -> np.ndarray:
    """(E, P) host-sim ``cache_misses`` per (epoch, worker): every worker
    run through ``core.runtime.RapidGNNRunner`` on the same schedule."""
    from repro_torch.core.fetch import ShardedFeatureStore
    from repro_torch.core.metrics import NetworkModel
    from repro_torch.core.runtime import RapidGNNRunner

    E = len(schedules[0].epochs)
    out = np.zeros((E, len(schedules)), np.int64)
    for w, ws in enumerate(schedules):
        store = ShardedFeatureStore(pg, worker=w,
                                    net=NetworkModel(enabled=False))
        m = RapidGNNRunner(ws, store, batch_size=batch_size).run()
        out[:, w] = [em.cache_misses for em in m.epochs]
    return out
