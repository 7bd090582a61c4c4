"""Serving tiers of the port: the GNN inference service (``serve.gnn``)
and the sequence-sharded decode attention (``serve.attention``)."""
from repro_torch.serve.attention import (sharded_decode_attention,
                                         sharded_decode_shard)

__all__ = ["sharded_decode_attention", "sharded_decode_shard"]
