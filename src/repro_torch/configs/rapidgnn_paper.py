"""The paper's own experimental configs (Table 1 / §5.1).

GraphSAGE fan-outs follow DistDGL defaults (25, 10); the Dist-GCN
baseline builds larger computation blocks (fan-out 50, 50 capped full
neighborhood) exactly as §5.2 attributes its higher fetch volume to
"large subgraph construction".
"""
import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class GNNExperimentConfig:
    dataset: str
    model: str                  # "sage" | "gcn"
    fanouts: Tuple[int, ...]
    batch_size: int
    hidden_dim: int
    num_layers: int
    num_epochs: int
    n_hot: int                  # steady-cache size
    Q: int                      # prefetch window
    num_workers: int
    partition: str              # "metis" (greedy stand-in) | "random"
    s0: int = 42


def sage(dataset: str, batch: int, workers: int = 4,
         partition: str = "metis", n_hot: int = 4096,
         epochs: int = 10) -> GNNExperimentConfig:
    return GNNExperimentConfig(dataset=dataset, model="sage",
                               fanouts=(25, 10), batch_size=batch,
                               hidden_dim=256, num_layers=2,
                               num_epochs=epochs, n_hot=n_hot, Q=4,
                               num_workers=workers, partition=partition)


def gcn(dataset: str, batch: int, workers: int = 4,
        epochs: int = 10) -> GNNExperimentConfig:
    return GNNExperimentConfig(dataset=dataset, model="gcn",
                               fanouts=(50, 50), batch_size=batch,
                               hidden_dim=256, num_layers=2,
                               num_epochs=epochs, n_hot=0, Q=0,
                               num_workers=workers, partition="metis")


#: paper Table 2 grid: 3 datasets x 3 batch sizes
PAPER_GRID: List[GNNExperimentConfig] = [
    sage(ds, b)
    for ds in ("reddit_sim", "ogbn_products_sim", "ogbn_papers_sim")
    for b in (1000, 2000, 3000)
]
