"""Synthetic token streams: the port's copy of ``zipf_tokens`` from
``repro/data/pipeline.py``. Callers draw through a keyed stream,
``repro_torch.graph.sampler.rng_from(seed)``. The LM batches
(``make_batch``) wait for the LM training slice (ROADMAP Queue 1 item
12)."""
from __future__ import annotations

import numpy as np


def zipf_tokens(rng: np.random.Generator, vocab: int, shape,
                a: float = 1.1) -> np.ndarray:
    """Zipf-distributed token ids over [0, vocab)."""
    ranks = rng.zipf(a, size=shape).astype(np.int64)
    return ((ranks - 1) % vocab).astype(np.int32)
