"""Plain PyTorch version of the ``seg_sort`` kernel: a stable sort.

The schedule compiler sorts composite ``(batch, id)`` keys, so one
global sort acts per batch (keys never cross segment boundaries). Keys
are int32, non-negative, padded with the INT32_MAX sentinel so padding
sorts after every real key. ``stable=True`` keeps equal keys in input
order, as the LSD radix kernel does, so the payload comes out in the
same order from both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def seg_sort_ref(keys: torch.Tensor, payload: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sort int32 ``keys`` ascending; permute ``payload`` along with
    them (stable). Returns ``(sorted_keys, sorted_payload_or_None)``."""
    sk, idx = torch.sort(keys, stable=True)
    return sk, None if payload is None else payload[idx]
