"""Public wrapper of the ``seg_sort`` kernel.

Replaces the TPU kernel ``repro/kernels/seg_sort/seg_sort.py:73``
``radix_sort``: a stable ascending sort of non-negative int32 keys, with
an optional int32 payload permuted along. Real keys lie below
``2^num_bits``; the INT32_MAX pad sentinel (and any key at or above
``2^num_bits``) sorts after them, in input order. The output is
bit-identical to a stable comparison sort of the keys.

CPU tensors (or ``interpret=True``) take the plain version in ``ref.py``
(``torch.sort(stable=True)``); CUDA tensors launch the radix kernel or
raise. There is no size limit and no fallback on the card: the TPU
kernel's VMEM bound ``MAX_VMEM_N`` has no counterpart in HBM.

On the card a call is ``1 + passes`` launches (``seg_sort.passes``, 3
passes for 20-bit keys): a histogram of every pass's digits, then one
one-sweep launch a pass in thread block clusters (``seg_sort.py``).
Bound: bytes, each key (and payload) read once and written once; the
design reads the keys ``1 + passes`` times and writes them ``passes``
times.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import LaunchCount, expect, use_plain
from repro_torch.kernels.seg_sort.ref import seg_sort_ref
from repro_torch.kernels.seg_sort.seg_sort import launch_radix_sort

LAUNCHES = LaunchCount("seg_sort")


def seg_sort(keys: torch.Tensor, payload: Optional[torch.Tensor] = None, *,
             num_bits: int = 31, interpret: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """keys (n,) int32 >= 0; payload (n,) int32 or None ->
    (sorted keys, payload in the same order or None)."""
    expect(keys, "keys", torch.int32, 1)
    tensors = [keys]
    if payload is not None:
        expect(payload, "payload", torch.int32, 1)
        if payload.shape != keys.shape:
            raise ValueError(f"payload of {payload.shape[0]} entries for "
                             f"{keys.shape[0]} keys")
        tensors.append(payload)
    if not 1 <= num_bits <= 31:
        raise ValueError(f"num_bits={num_bits} is outside 1..31")
    if keys.shape[0] >= 2 ** 31:
        raise ValueError(f"{keys.shape[0]} keys: the kernel indexes int32")
    if use_plain(interpret, *tensors):
        return seg_sort_ref(keys, payload)
    keys_out = torch.empty_like(keys)
    pay_out = None if payload is None else torch.empty_like(payload)
    if keys.shape[0] == 0:
        return keys_out, pay_out
    launch_radix_sort(keys, payload, keys_out, pay_out, num_bits)
    LAUNCHES.bump()
    return keys_out, pay_out
