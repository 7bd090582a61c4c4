"""Micro-batch collation for online inference (DESIGN.md §11).

Reuses the training stack end to end: each request is sampled by the
deterministic ``KHopSampler`` on its OWN Philox stream keyed
``H(s0, worker, SERVE_EPOCH, rid)``, the slot batches are packed through
``FlatEpoch.from_batches`` and collated from its zero-copy ``batch(i)``
views with the same ``collate`` used for training -- so a request's
computation graph is a pure function of (s0, rid, seeds), independent
of micro-batch composition. That is the whole bit-equality story: the
batched response can be checked against a clean single-request oracle
because batching cannot change what is computed per slot.

Shapes are WORST-CASE static: padding bounds assume every sampled
neighbour is new (``m`` grows by the full fan-out each hop), so every
micro-batch -- any traffic, any request sizes up to ``batch_size`` --
collates to one fixed (R, m_max)/(R, E_l) layout, so every kernel
launch of the service sees the same shapes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.schedule import CollatedBatch, collate
from repro_torch.graph.sampler import FlatEpoch, KHopSampler
from repro_torch.serve.gnn.request import InferenceRequest

#: sampling-epoch slot for serving streams. Domain separation per the
#: §2.2 RNG contract: training draws use epoch >= 0 and the epoch
#: shuffle uses index -1, so ``(s0, w, -2, rid)`` can never collide
#: with either for any rid.
SERVE_EPOCH = -2


def serve_pad_bounds(fanouts: Sequence[int],
                     batch_size: int) -> Tuple[int, List[int]]:
    """Worst-case ``(m_max, edge_max)`` for a ``batch_size``-seed
    request: walking output->input like the sampler, each hop emits
    exactly ``frontier * fanout`` edges and at worst every source is
    new, so the frontier grows by ``x(1 + fanout)``."""
    cur = int(batch_size)
    edge_rev: List[int] = []
    for fanout in reversed(list(fanouts)):
        edge_rev.append(cur * int(fanout))
        cur *= 1 + int(fanout)
    return cur, list(reversed(edge_rev))


def empty_collated(batch_size: int, m_max: int,
                   edge_max: Sequence[int]) -> CollatedBatch:
    """Fully-padded slot for micro-batches shorter than R: every id -1,
    every mask False -- the assemble kernel serves it zeros and the
    response slot is discarded."""
    L = len(edge_max)
    return CollatedBatch(
        seeds=np.full(batch_size, -1, np.int64),
        seed_mask=np.zeros(batch_size, bool),
        labels=np.zeros(batch_size, np.int32),
        input_nodes=np.full(m_max, -1, np.int64),
        input_mask=np.zeros(m_max, bool),
        num_inputs=0,
        edge_src=[np.zeros(edge_max[l], np.int32) for l in range(L)],
        edge_dst=[np.zeros(edge_max[l], np.int32) for l in range(L)],
        edge_mask=[np.zeros(edge_max[l], bool) for l in range(L)],
        num_dst=[0] * L)


@dataclasses.dataclass
class MicroBatch:
    """R request slots stacked into the service's one static layout."""
    requests: List[Optional[InferenceRequest]]   # None = padding slot
    collated: List[CollatedBatch]                # per slot, R entries
    input_nodes: np.ndarray                      # (R, m_max) int64, -1 pad
    input_mask: np.ndarray                       # (R, m_max) bool
    edge_src: List[np.ndarray]                   # per layer (R, E_l) int32
    edge_dst: List[np.ndarray]
    edge_mask: List[np.ndarray]                  # per layer (R, E_l) bool

    @property
    def num_slots(self) -> int:
        return len(self.collated)


class ServeCollator:
    """Stateless per-service collator: sampler + static pad bounds."""

    def __init__(self, sampler: KHopSampler, s0: int, worker: int,
                 max_requests: int):
        self.sampler = sampler
        self.s0 = int(s0)
        self.worker = int(worker)
        self.max_requests = int(max_requests)
        self.batch_size = sampler.batch_size
        self.m_max, self.edge_max = serve_pad_bounds(
            sampler.fanouts, sampler.batch_size)
        # labels are a training concern; inference collation feeds a
        # zero table so ``collate`` stays shared with the train path
        self._labels = np.zeros(sampler.graph.num_nodes, np.int32)
        self._empty = empty_collated(self.batch_size, self.m_max,
                                     self.edge_max)

    def collate_one(self, req: InferenceRequest) -> CollatedBatch:
        """The single-request form -- also the oracle's collation."""
        if req.seeds.shape[0] > self.batch_size:
            raise ValueError(
                f"request {req.rid} has {req.seeds.shape[0]} seeds > "
                f"batch_size {self.batch_size}")
        b = self.sampler.sample_batch(self.s0, self.worker, SERVE_EPOCH,
                                      req.rid, req.seeds)
        return collate(b, self._labels, self.batch_size, self.m_max,
                       self.edge_max)

    def collate_micro_batch(self,
                            reqs: Sequence[InferenceRequest]) -> MicroBatch:
        """Sample every request, pack through FlatEpoch, collate each
        zero-copy view, stack to the (R, ...) static layout."""
        if not 0 < len(reqs) <= self.max_requests:
            raise ValueError(f"{len(reqs)} requests for micro-batch of "
                             f"at most {self.max_requests}")
        sampled = [self.sampler.sample_batch(self.s0, self.worker,
                                             SERVE_EPOCH, r.rid, r.seeds)
                   for r in reqs]
        flat = FlatEpoch.from_batches(sampled, epoch=SERVE_EPOCH,
                                      worker=self.worker,
                                      num_layers=len(self.sampler.fanouts))
        cbs = [collate(flat.batch(i), self._labels, self.batch_size,
                       self.m_max, self.edge_max)
               for i in range(flat.num_batches)]
        requests: List[Optional[InferenceRequest]] = list(reqs)
        while len(cbs) < self.max_requests:     # pad to static R
            cbs.append(self._empty)
            requests.append(None)
        L = len(self.edge_max)
        return MicroBatch(
            requests=requests, collated=cbs,
            input_nodes=np.stack([cb.input_nodes for cb in cbs]),
            input_mask=np.stack([cb.input_mask for cb in cbs]),
            edge_src=[np.stack([cb.edge_src[l] for cb in cbs])
                      for l in range(L)],
            edge_dst=[np.stack([cb.edge_dst[l] for cb in cbs])
                      for l in range(L)],
            edge_mask=[np.stack([cb.edge_mask[l] for cb in cbs])
                       for l in range(L)])
