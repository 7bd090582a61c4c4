"""The paper's other datasets and scaling axis in the port against the
JAX package, on the CPU.

``load_dataset`` of ``ogbn_products_sim`` (192,000 nodes, d 100) and
``ogbn_papers_sim`` (256,000 nodes, d 128, 172 classes) at full size:
the same ``DatasetSpec``, and CSR, features, labels and train mask bit
for bit. ``partition_graph`` (``metis``, the launcher's, and ``random``,
``dgl-random``'s) at 4 and 8 parts on graphs of the same specs cut to
PARTITION_NODES nodes, generated in both packages: the owners and every
worker's nodes bit for bit. The RoPE frequencies the decode of
``long_500k`` rotates by are evaluated on the host once a device.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.graph import generate as j_generate
from repro.graph import load_dataset as j_load_dataset
from repro.graph import partition_graph as j_partition_graph
from repro.models.transformer.common import rope_freqs as j_rope_freqs
from repro_torch.graph import generate as t_generate
from repro_torch.graph import load_dataset, partition_graph
from repro_torch.models.transformer.common import rope_freqs
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

PAPER = ("ogbn_products_sim", "ogbn_papers_sim")
#: the partition cases' graphs: the paper specs at this many nodes
PARTITION_NODES = 24_000
GRAPH_FIELDS = ("indptr", "indices", "features", "labels", "train_mask")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("name", PAPER)
def test_paper_dataset_bit_equal_to_reference(name):
    spec = t_generate.DATASETS[name]
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        j_generate.DATASETS[name])
    try:
        g, ref = load_dataset(name), j_load_dataset(name)
        assert (g.num_nodes, g.feat_dim, g.num_classes) == (
            spec.num_nodes, spec.feat_dim, spec.num_classes)
        for f in GRAPH_FIELDS:
            _same(getattr(g, f), getattr(ref, f), f"{name} {f}")
    finally:
        # a full-size graph is a few hundred MB: not kept past the test
        t_generate._CACHE.pop((name, 0), None)
        j_generate._CACHE.pop((name, 0), None)


@pytest.fixture(scope="module")
def cut_graphs():
    """Each paper spec at PARTITION_NODES nodes, in both packages."""
    out = {}
    for name in PAPER:
        t_spec = dataclasses.replace(t_generate.DATASETS[name],
                                     num_nodes=PARTITION_NODES)
        j_spec = dataclasses.replace(j_generate.DATASETS[name],
                                     num_nodes=PARTITION_NODES)
        out[name] = (t_generate.make_powerlaw_graph(t_spec, seed=0),
                     j_generate.make_powerlaw_graph(j_spec, seed=0))
    return out


@pytest.mark.parametrize("name", PAPER)
@pytest.mark.parametrize("parts", [4, 8])
@pytest.mark.parametrize("method", ["metis", "random"])
def test_paper_partition_bit_equal_to_reference(cut_graphs, name, parts,
                                                method):
    g, ref_g = cut_graphs[name]
    for f in GRAPH_FIELDS:
        _same(getattr(g, f), getattr(ref_g, f), f"{name} cut {f}")
    pg = partition_graph(g, parts, method)
    ref = j_partition_graph(ref_g, parts, method)
    assert pg.num_parts == ref.num_parts == parts
    _same(pg.owner, ref.owner, "owner")
    assert len(pg.local_nodes) == len(ref.local_nodes) == parts
    for w, (a, b) in enumerate(zip(pg.local_nodes, ref.local_nodes)):
        _same(a, b, f"worker {w}'s nodes")
    assert all(len(ln) for ln in pg.local_nodes)


@pytest.mark.parametrize("head_dim,theta", [(256, 10000.0), (64, 10000.0),
                                            (128, 1000000.0)])
def test_rope_freqs_evaluated_on_the_host_once_a_device(head_dim, theta):
    """One float32 table a (head_dim, theta, device), computed on the host
    (a card's ``pow`` rounds some bands an ulp away, which positions near
    2^19 turn into 0.03 rad) and within an ulp of the reference's."""
    host = rope_freqs(head_dim, theta)
    assert rope_freqs(head_dim, theta, torch.device("cpu")) is host
    meta = rope_freqs(head_dim, theta, torch.device("meta"))
    assert meta.device.type == "meta"
    assert meta.shape == host.shape == (head_dim // 2,)
    assert meta.dtype == host.dtype == torch.float32
    with torch.inference_mode():
        assert rope_freqs(head_dim, theta) is host
    assert not host.is_inference()
    np.testing.assert_array_max_ulp(
        host.numpy(), np.asarray(j_rope_freqs(head_dim, theta),
                                 dtype=np.float32), maxulp=1)
