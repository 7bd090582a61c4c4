"""The port's host-side copies, its model and its isolation, held against
the JAX reference package.

  * numpy copies (dataset, partition, sampler, micro-batch collation,
    warmer snapshots) must equal the reference bit for bit;
  * ``forward`` on one ``CollatedBatch`` with the reference's parameters
    carried over by ``params_from_numpy`` must match the JAX forward to
    ``rtol=1e-4, atol=1e-5`` (the reference's own cross-program
    tolerance): matrix products and the ``segment`` sums run in another
    order on another library;
  * the port imports nothing of JAX or of the ``repro`` package.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.core.metrics import EpochMetrics as JEpochMetrics
from repro.core.fetch import ShardedFeatureStore as JStore
from repro.dist.gnn_step import DeviceView as JDeviceView
from repro.graph import KHopSampler as JSampler
from repro.graph import load_dataset as j_load, partition_graph as j_part
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import forward as j_forward, init_params as j_init
from repro.serve.gnn.collator import ServeCollator as JCollator
from repro.serve.gnn.request import InferenceRequest as JRequest
from repro.serve.gnn.warmer import CacheWarmer as JWarmer
from repro_torch.core.fetch import ShardedFeatureStore as TStore
from repro_torch.core.metrics import EpochMetrics as TEpochMetrics
from repro_torch.dist.gnn_step import DeviceView as TDeviceView
from repro_torch.graph import KHopSampler as TSampler
from repro_torch.graph import load_dataset as t_load, partition_graph as t_part
from repro_torch.graph.sampler import rng_from
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.models.gnn import (forward as t_forward,
                                    init_params as t_init,
                                    params_from_numpy, params_to_numpy)
from repro_torch.serve.gnn.collator import ServeCollator as TCollator
from repro_torch.serve.gnn.request import InferenceRequest as TRequest
from repro_torch.serve.gnn.warmer import CacheWarmer as TWarmer
from _torch_threads import capped_env

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FANOUTS = (3, 3)
BATCH = 4


@pytest.fixture(scope="module")
def worlds():
    gj, gt = j_load("tiny", seed=0), t_load("tiny", seed=0)
    return (gj, j_part(gj, 4, "greedy")), (gt, t_part(gt, 4, "greedy"))


def _requests(cls, g, n, seed=5):
    rng = rng_from(seed, 0x7E57)
    return [cls(rid=r, seeds=rng.integers(0, g.num_nodes,
                                          size=int(rng.integers(1, 5))),
                deadline=float("inf"), submitted_at=0.0)
            for r in range(n)]


# ---------------------------------------------------------------------------
# numpy copies: bit for bit
# ---------------------------------------------------------------------------

def test_dataset_and_partition_bit_identical(worlds):
    (gj, pj), (gt, pt) = worlds
    for name in ("indptr", "indices", "features", "labels", "train_mask"):
        a, b = getattr(gj, name), getattr(gt, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert gj.num_classes == gt.num_classes
    np.testing.assert_array_equal(pj.owner, pt.owner)
    for a, b in zip(pj.local_nodes, pt.local_nodes):
        np.testing.assert_array_equal(a, b)
    rj, rt = j_part(gj, 4, "random", seed=3), t_part(gt, 4, "random", seed=3)
    np.testing.assert_array_equal(rj.owner, rt.owner)


def test_sample_batch_bit_identical(worlds):
    (gj, _), (gt, _) = worlds
    sj = JSampler(gj, fanouts=list(FANOUTS), batch_size=BATCH)
    st = TSampler(gt, fanouts=list(FANOUTS), batch_size=BATCH)
    for i, seeds in enumerate(([1, 2, 3, 4], [7], [999, 0, 500])):
        bj = sj.sample_batch(7, 0, -2, i, np.array(seeds))
        bt = st.sample_batch(7, 0, -2, i, np.array(seeds))
        np.testing.assert_array_equal(bj.input_nodes, bt.input_nodes)
        for xj, xt in zip(bj.blocks, bt.blocks):
            assert (xj.num_src, xj.num_dst) == (xt.num_src, xt.num_dst)
            for f in ("edge_src", "edge_dst", "edge_mask"):
                a, b = getattr(xj, f), getattr(xt, f)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_collate_micro_batch_bit_identical(worlds):
    (gj, _), (gt, _) = worlds
    cj = JCollator(JSampler(gj, list(FANOUTS), BATCH), 7, 1, 4)
    ct = TCollator(TSampler(gt, list(FANOUTS), BATCH), 7, 1, 4)
    assert (cj.m_max, cj.edge_max) == (ct.m_max, ct.edge_max)
    mj = cj.collate_micro_batch(_requests(JRequest, gj, 3))
    mt = ct.collate_micro_batch(_requests(TRequest, gt, 3))
    for f in ("input_nodes", "input_mask"):
        np.testing.assert_array_equal(getattr(mj, f), getattr(mt, f))
    for f in ("edge_src", "edge_dst", "edge_mask"):
        for a, b in zip(getattr(mj, f), getattr(mt, f)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_warmer_snapshot_bit_identical(worlds):
    (gj, pj), (gt, pt) = worlds
    wj = JWarmer(JStore(pj, 0), JDeviceView.build(pj), 16,
                 JEpochMetrics(epoch=-2))
    wt = TWarmer(TStore(pt, 0), TDeviceView.build(pt), 16,
                 TEpochMetrics(epoch=-2))
    rng = rng_from(9, 1)
    for _ in range(3):
        traffic = rng.integers(0, gj.num_nodes, size=40)
        traffic = traffic[pj.owner[traffic] != 0]
        wj.observe(traffic)
        wt.observe(traffic)
    assert wj.warm_now() and wt.warm_now()
    (sj, _), (st, _) = wj.snapshot(), wt.snapshot()
    for f in ("dev_ids", "dev_feats"):
        a, b = getattr(sj, f), getattr(st, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sj.cache.ids, st.cache.ids)
    assert wj.metrics.vector_pull_bytes == wt.metrics.vector_pull_bytes


# ---------------------------------------------------------------------------
# model: forward against the JAX forward
# ---------------------------------------------------------------------------

def _batch(worlds):
    _, (gt, _) = worlds
    ct = TCollator(TSampler(gt, list(FANOUTS), BATCH), 7, 0, 1)
    cb = ct.collate_one(_requests(TRequest, gt, 1, seed=8)[0])
    feats = np.where(cb.input_mask[:, None],
                     gt.features[np.where(cb.input_mask, cb.input_nodes, 0)],
                     0.0).astype(np.float32)
    return gt, cb, feats


@pytest.mark.parametrize("kind", ["sage", "gcn"])
@pytest.mark.parametrize("backends", [("segment", "segment"),
                                      ("kernel", "pallas_interpret")])
def test_forward_matches_jax(worlds, kind, backends):
    g, cb, feats = _batch(worlds)
    t_backend, j_backend = backends
    kw = dict(kind=kind, in_dim=g.feat_dim, hidden_dim=16,
              num_classes=g.num_classes, num_layers=2, fanouts=FANOUTS)
    jcfg = JConfig(agg_backend=j_backend, **kw)
    tcfg = TConfig(agg_backend=t_backend, **kw)
    jparams = j_init(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = params_from_numpy(tree)
    want = np.asarray(j_forward(jcfg, jparams, feats, cb.edge_src,
                                cb.edge_dst, cb.edge_mask))
    with torch.no_grad():
        got = t_forward(tcfg, tparams, torch.from_numpy(feats),
                        [torch.from_numpy(e) for e in cb.edge_src],
                        [torch.from_numpy(e) for e in cb.edge_dst],
                        [torch.from_numpy(e) for e in cb.edge_mask])
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    back = params_to_numpy(tparams)
    for lj, lt in zip(tree["layers"], back["layers"]):
        for k in lj:
            np.testing.assert_array_equal(lj[k], lt[k])


def test_batched_forward_is_slot_independent(worlds):
    """A slot's logits do not depend on which slot it occupies: the
    property the service's per-response oracle bit-equality rests on."""
    g, _cb, _ = _batch(worlds)
    ct = TCollator(TSampler(g, list(FANOUTS), BATCH), 7, 0, 4)
    mb = ct.collate_micro_batch(_requests(TRequest, g, 4, seed=12))
    feats = np.where(mb.input_mask[..., None],
                     g.features[np.where(mb.input_mask, mb.input_nodes, 0)],
                     0.0).astype(np.float32)
    cfg = TConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=16,
                  num_classes=g.num_classes, num_layers=2, fanouts=FANOUTS,
                  agg_backend="kernel")
    params = t_init(cfg, torch.Generator().manual_seed(0))
    perm = [2, 0, 3, 1]

    def run(idx):
        with torch.no_grad():
            return t_forward(
                cfg, params, torch.from_numpy(feats[idx]),
                [torch.from_numpy(e[idx]) for e in mb.edge_src],
                [torch.from_numpy(e[idx]) for e in mb.edge_dst],
                [torch.from_numpy(e[idx]) for e in mb.edge_mask])
    base, shuffled = run([0, 1, 2, 3]), run(perm)
    assert torch.equal(shuffled, base[perm])


def test_init_params_seeded_and_config_checks():
    cfg = TConfig(kind="gcn", in_dim=5, hidden_dim=4, num_classes=3,
                  num_layers=2)
    a = t_init(cfg, torch.Generator().manual_seed(1))
    b = t_init(cfg, torch.Generator().manual_seed(1))
    for la, lb in zip(a["layers"], b["layers"]):
        for k in la:
            assert torch.equal(la[k], lb[k])
    w = a["layers"][0]["w"]
    assert w.shape == (5, 4) and w.abs().max() <= 1 / np.sqrt(5)
    with pytest.raises(ValueError):
        TConfig(kind="sage", in_dim=5, hidden_dim=4, num_classes=3,
                num_layers=2, agg_backend="kernel")       # no fanouts
    with pytest.raises(ValueError):
        TConfig(kind="sage", in_dim=5, hidden_dim=4, num_classes=3,
                num_layers=2, agg_backend="pallas")


# ---------------------------------------------------------------------------
# isolation: no jax, no repro
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n")
    env = capped_env(PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert int(p.stdout.split()[0]) > 30


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)
