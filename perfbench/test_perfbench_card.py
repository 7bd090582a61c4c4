"""The control of each cell on the card: the reference computed with
TF32 matrix products (the precision below the configurations' float32)
put in the program's place must fail one of the cell's training
numbers. Runs on the card only (``python -m pytest -m gpu perfbench``);
skips without one."""
import pytest
import torch

from perfbench import graphgen, harness
from perfbench.manifest import load_cell, load_manifest
from perfbench.reference import check, model, partition, sampler

CELLS = [w["name"] for w in load_manifest()["workloads"]]
SEED = 2 ** 31 + 4099


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = load_cell(cell)
    cfg = c.config
    g = graphgen.make_graph(cfg, int(cfg["graph_seed"]))
    P = int(cfg["num_workers"])
    owner = partition.greedy_owner(g.indptr, g.indices, P,
                                   int(cfg["partition_seed"]))
    batches = [[sampler.sample_epoch(g.indptr, g.indices, owner,
                                     g.train_mask, cfg["fanouts"],
                                     int(c.traffic["batch_size"]),
                                     int(cfg["n_hot"]), SEED, w, e).batches
                for w in range(P)]
               for e in range(min(harness.WARM_EPOCHS, int(cfg["epochs"])))]
    p0 = model.init_params(model.layer_dims(cfg), SEED)
    X = torch.from_numpy(g.features).cuda()
    y = torch.from_numpy(g.labels).cuda()
    ref = model.train_steps(p0, int(cfg["num_layers"]), X, y, batches,
                            cfg["optimizer"])
    ctl = model.train_steps(p0, int(cfg["num_layers"]), X, y, batches,
                            cfg["optimizer"], tf32=True)
    nums = check.training_numbers(ctl["losses"], p0, ctl["params"],
                                  ctl["mu"], p0, ref)
    assert any(v > c.limits[k] for k, v in nums.items()), nums
