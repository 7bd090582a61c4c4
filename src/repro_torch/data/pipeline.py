"""Token data pipeline with RapidGNN-style deterministic scheduling: the
port's copy of ``repro/data/pipeline.py``.

The same H(s0, e, i) seed derivation as the graph sampler drives batch
composition (``repro_torch.graph.sampler.rng_from``), so the full
token-access pattern of a run is enumerable offline -- which is what the
hot-token embedding cache (``models/transformer/embedding.py``)
consumes. Token ids follow a Zipf distribution. Batches are CPU
tensors.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.graph.sampler import rng_from
from repro_torch.models.transformer.common import ArchConfig


def zipf_tokens(rng: np.random.Generator, vocab: int, shape,
                a: float = 1.1) -> np.ndarray:
    """Zipf-distributed token ids over [0, vocab)."""
    ranks = rng.zipf(a, size=shape).astype(np.int64)
    return ((ranks - 1) % vocab).astype(np.int32)


def make_batch(cfg: ArchConfig, rng: np.random.Generator, batch: int,
               seq: int) -> Dict[str, torch.Tensor]:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    toks = zipf_tokens(rng, cfg.vocab_size, (batch, seq))
    out = {"tokens": t(toks),
           "labels": t(np.roll(toks, -1, axis=1)),
           "loss_mask": torch.ones((batch, seq), dtype=torch.float32)}
    if cfg.mrope_sections:
        out["mrope_positions"] = torch.arange(
            seq, dtype=torch.int32)[None, None].expand(3, batch, seq)
    if cfg.frontend == "vision":
        out["embeds"] = t((0.02 * rng.standard_normal(
            (batch, seq, cfg.d_model))).astype(np.float32))
    if cfg.kind == "encdec":
        out["enc_embeds"] = t((0.02 * rng.standard_normal(
            (batch, seq, cfg.d_model))).astype(np.float32))
    return out


def synthetic_lm_batches(cfg: ArchConfig, batch: int, seq: int, steps: int,
                         s0: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    for i in range(steps):
        yield make_batch(cfg, rng_from(s0, 0, i), batch, seq)


def enumerate_token_accesses(cfg: ArchConfig, batch: int, seq: int,
                             steps: int, s0: int = 0) -> np.ndarray:
    """Offline enumeration of the token-id access counts for a whole run
    (paper Alg. 1 lines 1-3 applied to the embedding table)."""
    counts = np.zeros(cfg.vocab_size, np.int64)
    for i in range(steps):
        toks = zipf_tokens(rng_from(s0, 0, i), cfg.vocab_size,
                           (batch, seq))
        counts += np.bincount(toks.reshape(-1), minlength=cfg.vocab_size)
    return counts
