"""Keyed random streams: ``rng_from(s0, *fields)`` is a Philox generator
seeded by BLAKE2b-8 of ``(s0, *fields)``, the arithmetic the port's
sampler, partitioner and generator use (frozen here so that the
benchmark's inputs and its reference do not move with the program)."""
from __future__ import annotations

import hashlib
import struct

import numpy as np


def derive_seed(s0: int, *fields: int) -> int:
    """H(s0, *fields) -> uint64, H = BLAKE2b with an 8-byte digest."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<q", s0))
    for f in fields:
        h.update(struct.pack("<q", int(f)))
    return struct.unpack("<Q", h.digest())[0]


def rng_from(s0: int, *fields: int) -> np.random.Generator:
    return np.random.default_rng(np.random.Philox(derive_seed(s0, *fields)))
