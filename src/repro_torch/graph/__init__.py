"""Graph substrate: CSR storage, synthetic datasets, partitioning, sampling
(the port's copies of the JAX package's numpy modules)."""
from repro_torch.graph.graph import Graph
from repro_torch.graph.generate import make_powerlaw_graph, DATASETS, load_dataset
from repro_torch.graph.partition import random_partition, greedy_partition, PartitionedGraph, partition_graph
from repro_torch.graph.sampler import FlatEpoch, KHopSampler, SampledBatch

__all__ = [
    "Graph", "make_powerlaw_graph", "DATASETS", "load_dataset",
    "random_partition", "greedy_partition", "PartitionedGraph", "partition_graph",
    "KHopSampler", "SampledBatch", "FlatEpoch",
]
