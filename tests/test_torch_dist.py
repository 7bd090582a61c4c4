"""The port's device-distributed slice against the JAX package, on the
CPU: the ``merge_gather`` kernel family, the staged assembly, the pull
plans and the all-to-all exchange, the epoch collation, the pipelined
and on-demand epochs, and the hot-token embedding cache.

Bit for bit: every copy output -- ``merge_gather``/``cache_lookup``
(plain version) against the JAX kernel in interpret mode and its
``cache_lookup_ref``, ``to_device_ids``, the numpy pull plans and epoch
collation (with their ``ValueError``s), ``pull_features`` against the
JAX ``pull_features`` on 4 emulated devices, ``pull_shard`` on 4 gloo
ranks against ``pull_features``, the staged assembly against the fused
and ref backends and the JAX staged chain, and the embedding lookup.
Within the reference's cross-program tolerance (``rtol=1e-4,
atol=1e-5``): the pipelined and on-demand epochs' losses, accuracies and
final parameters against the JAX epochs. Within the port, the rapid,
staged and on-demand loss curves are bit-equal, two runs are
bit-identical, and the pull lanes equal the host-sim miss counts.

The JAX results that need a mesh come from one subprocess
(``tests/_torch_dist_ref.py``) with 4 emulated devices; this process
never starts a multi-device JAX.
"""
import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_cases import (ASSEMBLE_CASES, MERGE_CASES, SENTINEL, as_dtype,
                          assemble_case, merge_case, to_t)
from repro.core import build_schedule as j_build_schedule
from repro.core.schedule import epoch_edge_maxima as j_edge_maxima
from repro.data.pipeline import (enumerate_token_accesses as j_enumerate,
                                 synthetic_lm_batches as j_lm_batches)
from repro.configs import get_reduced as j_get_reduced
from repro.dist.feature_a2a import (_fast_key_fits as j_fast_key_fits,
                                    build_pull_plan as j_build_pull_plan,
                                    cache_gather as j_cache_gather,
                                    pack_pull_lanes as j_pack_pull_lanes)
from repro.dist.gnn_step import (DeviceView as JDeviceView,
                                 collate_device_epoch as j_collate,
                                 collate_device_epoch_loop as j_collate_loop,
                                 empty_caches as j_empty_caches,
                                 epoch_k_max as j_epoch_k_max,
                                 prefetch_stream as j_prefetch_stream,
                                 stack_caches as j_stack_caches)
from repro.dist.runner import host_miss_matrix as j_host_miss_matrix
from repro.graph import KHopSampler as JSampler
from repro.graph import load_dataset as j_load, partition_graph as j_part
from repro.kernels.assemble.ops import assemble_features as j_assemble
from repro.kernels.cache_lookup.cache_lookup import (
    merge_gather as j_merge_gather)
from repro.kernels.cache_lookup.ops import (cache_lookup as j_cache_lookup,
                                            to_device_ids as j_to_device_ids)
from repro.kernels.cache_lookup.ref import cache_lookup_ref as j_lookup_ref
from repro.models.transformer.embedding import HotEmbeddingSim as JSim
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.core import build_schedule as t_build_schedule
from repro_torch.core.schedule import epoch_edge_maxima as t_edge_maxima
from repro_torch.data.pipeline import (enumerate_token_accesses as
                                       t_enumerate, make_batch as t_make_batch,
                                       synthetic_lm_batches as t_lm_batches)
from repro_torch.dist import (DeviceRapidGNNRunner, Topology,
                              DeviceView as TDeviceView, cache_gather,
                              collate_device_epoch, collate_device_epoch_loop,
                              empty_caches, epoch_k_max, host_miss_matrix,
                              make_mesh, make_ondemand_epoch,
                              make_pipelined_epoch, prefetch_stream,
                              pull_features, stack_caches)
from repro_torch.dist import feature_a2a as t_a2a
from repro_torch.graph import KHopSampler as TSampler
from repro_torch.graph import load_dataset as t_load, partition_graph as t_part
from repro_torch.kernels.assemble.ops import assemble_features as t_assemble
from repro_torch.kernels.cache_lookup import ops as t_lookup_ops
from repro_torch.kernels.cache_lookup.ref import (cache_lookup_ref,
                                                  merge_gather_ref)
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.models.gnn import params_from_numpy, params_to_numpy
from repro_torch.models.transformer.embedding import (
    HotEmbeddingSim as TSim, device_embedding_lookup)
from repro_torch.train import AdamW as TAdamW
from _torch_threads import capped_env

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
P_ = 4
#: the reference script's epoch settings (tests/_torch_dist_ref.py)
N_HOT, B, HIDDEN, FANOUTS, S0, LR = 64, 16, 32, (5, 5), 7, 3e-3


def _f32(a) -> np.ndarray:
    """A JAX or torch array of any float dtype as float32 numpy (exact
    for bfloat16)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _bits_equal(a, b) -> None:
    a, b = _f32(a), _f32(b)
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's mesh results (4 emulated devices) from one
    subprocess."""
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = capped_env("--xla_force_host_platform_device_count=4",
                     PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(REPO / "tests" /
                                            "_torch_dist_ref.py"), str(out)],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# merge_gather, cache_lookup, to_device_ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_merge_gather_matches_jax_kernel(name):
    ids, feats, q, base, cdt, bdt = merge_case(name)
    t_ids, t_q = to_t(ids, q)
    t_feats, t_base = as_dtype(feats, cdt), as_dtype(base, bdt)
    j_feats = jnp.asarray(feats).astype(getattr(jnp, cdt))
    j_base = jnp.asarray(base).astype(getattr(jnp, bdt))
    pos, hit = t_lookup_ops.search(t_ids, t_q)
    got = t_lookup_ops.merge_gather(t_feats, t_base, pos, hit)
    want = j_merge_gather(j_feats, j_base, jnp.asarray(pos.numpy()),
                          jnp.asarray(hit.numpy()), interpret=True)
    assert got.dtype == t_base.dtype
    _bits_equal(got, want)
    _bits_equal(merge_gather_ref(t_feats, t_base, pos, hit), want)


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_cache_lookup_matches_jax_kernel_and_ref(name):
    ids, feats, q, base, cdt, bdt = merge_case(name)
    t_ids, t_q = to_t(ids, q)
    t_feats, t_base = as_dtype(feats, cdt), as_dtype(base, bdt)
    j_args = (jnp.asarray(ids), jnp.asarray(feats).astype(getattr(jnp, cdt)),
              jnp.asarray(q), jnp.asarray(base).astype(getattr(jnp, bdt)))
    merged, hit = t_lookup_ops.cache_lookup(t_ids, t_feats, t_q, t_base)
    k_merged, k_hit = j_cache_lookup(*j_args, use_kernel=True, interpret=True)
    r_merged, r_hit = j_lookup_ref(*j_args)
    for m_, h_ in ((k_merged, k_hit), (r_merged, r_hit)):
        _bits_equal(merged, m_)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(h_))
    p_merged, p_hit = cache_lookup_ref(t_ids, t_feats, t_q, t_base)
    _bits_equal(p_merged, merged)
    assert torch.equal(p_hit, hit)
    assert not hit[(t_q == -1) | (t_q == SENTINEL)].any()


def test_merge_gather_contract():
    ids, feats, q, base, _, _ = merge_case("mixed_d130")
    t_ids, t_feats, t_q, t_base = to_t(ids, feats, q, base)
    # pos past the cache clamps to its last row (the TPU kernel's clamp)
    pos = torch.full((t_base.shape[0],), 10 ** 6, dtype=torch.int32)
    hit = torch.ones(t_base.shape[0], dtype=torch.bool)
    got = t_lookup_ops.merge_gather(t_feats, t_base, pos, hit)
    assert torch.equal(got, t_feats[-1:].expand_as(got))
    # an empty cache returns base itself: nothing can hit
    empty = t_feats[:0]
    p0, h0 = t_lookup_ops.search(t_ids[:0], t_q)
    assert t_lookup_ops.merge_gather(empty, t_base, p0, h0) is t_base
    assert t_lookup_ops.cache_lookup(t_ids[:0], empty, t_q, t_base)[0] \
        is t_base
    # m = 0 gives an empty result
    z = t_lookup_ops.merge_gather(t_feats, t_base[:0], pos[:0], hit[:0])
    assert z.shape == (0, t_base.shape[1])
    with pytest.raises(ValueError):
        t_lookup_ops.merge_gather(t_feats.long(), t_base, pos, hit)
    with pytest.raises(ValueError):
        t_lookup_ops.merge_gather(t_feats[:, :5], t_base, pos, hit)
    with pytest.raises(ValueError):
        t_lookup_ops.merge_gather(t_feats, t_base, pos[:3], hit)
    with pytest.raises(ValueError):
        t_lookup_ops.merge_gather(t_feats, t_base, pos.long(), hit)
    # the CPU takes the plain version without counting a launch
    before = t_lookup_ops.MERGE_LAUNCHES.value
    t_lookup_ops.cache_lookup(t_ids, t_feats, t_q, t_base)
    assert t_lookup_ops.MERGE_LAUNCHES.value == before


def test_to_device_ids_matches_jax():
    ids = np.array([-1, 0, 5, 2 ** 31 - 2, 2 ** 31 - 1, 2 ** 31, 2 ** 40],
                   np.int64)
    got = t_lookup_ops.to_device_ids(torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_to_device_ids(ids[:5])).tolist()
                                  + [SENTINEL, SENTINEL])


def test_cache_gather_matches_jax():
    ids, feats, q, base, _, _ = merge_case("padded")
    got, hit = cache_gather(*to_t(ids, feats, q, base))
    want, whit = j_cache_gather(*(jnp.asarray(a) for a in (ids, feats, q,
                                                           base)))
    _bits_equal(got, want)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(whit))


# ---------------------------------------------------------------------------
# the staged assembly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ASSEMBLE_CASES))
def test_staged_equals_fused_ref_and_jax_staged(name):
    table, base, ids, feats, q, pulled = assemble_case(name)
    args = (to_t(table)[0], base, *to_t(ids, feats, q, pulled))
    staged = t_assemble(*args, backend="staged")
    for other in ("fused", "ref"):
        assert torch.equal(staged, t_assemble(*args, backend=other)), other
    want = j_assemble(jnp.asarray(table), base, jnp.asarray(ids),
                      jnp.asarray(feats), jnp.asarray(q),
                      jnp.asarray(pulled), backend="staged", interpret=True)
    _bits_equal(staged, want)
    cacheless = t_assemble(*args[:2], None, None, *args[4:],
                           backend="staged")
    want0 = j_assemble(jnp.asarray(table), base, None, None, jnp.asarray(q),
                       jnp.asarray(pulled), backend="staged")
    _bits_equal(cacheless, want0)
    assert torch.equal(cacheless, t_assemble(*args[:2], None, None,
                                             *args[4:], backend="fused"))


# ---------------------------------------------------------------------------
# pull plans (numpy copies)
# ---------------------------------------------------------------------------

def _plan_equal(a, b) -> None:
    for f in ("send_ids", "send_pos", "send_mask", "counts"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.payload_bytes(24) == b.payload_bytes(24)
    assert a.wire_bytes(24) == b.wire_bytes(24)
    assert a.request_bytes() == b.request_bytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_pull_plan_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, parts = 200, 4
    owner = rng.integers(0, parts, size=n)
    ids = rng.integers(-1, n, size=60)
    pos = rng.integers(0, 40, size=60)
    ids[5], pos[5] = ids[4], pos[4]                 # an exact duplicate
    ids[7], pos[7] = max(ids[6], 0), pos[6] + 1     # same id, other row
    k_max = 40
    _plan_equal(t_a2a.build_pull_plan(ids, pos, owner, parts, k_max),
                j_build_pull_plan(ids, pos, owner, parts, k_max))


def test_pull_plan_errors_match_jax():
    owner = np.array([0, 1, 2, 3, 0, 1])
    for fn in (t_a2a.build_pull_plan, j_build_pull_plan):
        with pytest.raises(ValueError, match="length mismatch"):
            fn(np.arange(3), np.arange(4), owner, 4, 8)
        with pytest.raises(ValueError, match="overflow"):
            fn(np.array([0, 4]), np.array([0, 1]), owner, 4, 1)
        with pytest.raises(ValueError, match="owner id out of range"):
            fn(np.array([2]), np.array([0]), owner, 2, 4)
    for fn in (t_a2a.pack_pull_lanes, j_pack_pull_lanes):
        with pytest.raises(ValueError, match="overflow"):
            fn(np.array([1, 2]), np.array([0, 1]), np.array([0, 0]),
               np.array([1, 1]), 1, 2, 1)
        with pytest.raises(ValueError, match="owner id out of range"):
            fn(np.array([1]), np.array([0]), np.array([0]), np.array([5]),
               1, 2, 4)


@pytest.mark.parametrize("kind,unique", [("small", False), ("small", True),
                                         ("dups", False),
                                         ("huge_span", False),
                                         ("empty", False)])
def test_pack_pull_lanes_matches_jax(kind, unique):
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    groups, parts, n = 6, 4, 300
    ids = rng.integers(-1, 1000, size=n)
    pos = rng.permutation(n)
    if kind == "dups":
        ids[10:20], pos[10:20] = ids[:10], pos[:10]
    if kind == "huge_span":                   # forces the lexsort path
        ids = ids * (2 ** 33)
        pos = pos * (2 ** 20)
    if kind == "empty":
        ids[:] = -1
    group = rng.integers(0, groups, size=n)
    owner = rng.integers(0, parts, size=n)
    if unique:                                # (group, id) unique
        keep = np.unique(np.stack([group, ids], 1), axis=0,
                         return_index=True)[1]
        ids, pos, group, owner = ids[keep], pos[keep], group[keep], owner[keep]
    args = (ids, pos, group, owner, groups, parts, n)
    got = t_a2a.pack_pull_lanes(*args, assume_unique=unique)
    want = j_pack_pull_lanes(*args, assume_unique=unique)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for spans in ((4, 4, 2 ** 30, 2 ** 30), (4, 4, 2 ** 30, 2 ** 28 - 1),
                  (1, 1, 1, 1)):
        assert t_a2a._fast_key_fits(*spans) == j_fast_key_fits(*spans)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def _pull_inputs(ref):
    return (torch.from_numpy(ref["pull_table"]),
            *to_t(ref["pull_send_ids"], ref["pull_send_pos"],
                  ref["pull_send_mask"], ref["pull_offsets"]),
            int(ref["pull_m_max"]))


def test_pull_features_matches_jax(jax_ref):
    mesh = make_mesh((P_,), ("data",), device=CPU)
    got = pull_features(mesh, *_pull_inputs(jax_ref))
    _bits_equal(got, jax_ref["pull_out"])
    # the -0.0 feature row comes back +0.0, as in the reference
    assert not np.signbit(got.numpy()[got.numpy() == 0]).any()
    # the buffers hold exactly the requested rows at send_pos
    table = jax_ref["pull_table"].reshape(-1, got.shape[-1])
    for w in range(P_):
        want = np.zeros(got.shape[1:], np.float32)
        msk = jax_ref["pull_send_mask"][w]
        want[jax_ref["pull_send_pos"][w][msk]] = \
            table[jax_ref["pull_send_ids"][w][msk]] + 0.0
        assert want.tobytes() == got[w].numpy().tobytes()
    # into a given buffer, the same bits
    out = torch.full_like(got, 7.0)
    pull_features(mesh, *_pull_inputs(jax_ref), out=out)
    assert torch.equal(out, got)


def test_pull_shard_on_gloo_ranks_equals_pull_features(jax_ref, tmp_path):
    inp = tmp_path / "in.npz"
    np.savez(inp, table=jax_ref["pull_table"],
             send_ids=jax_ref["pull_send_ids"],
             send_pos=jax_ref["pull_send_pos"],
             send_mask=jax_ref["pull_send_mask"],
             offsets=jax_ref["pull_offsets"], m_max=jax_ref["pull_m_max"])
    env = capped_env(PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, str(REPO / "tests" /
                                            "_torch_dist_gloo.py"), str(inp),
                        str(tmp_path)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    mesh = make_mesh((P_,), ("data",), device=CPU)
    want = pull_features(mesh, *_pull_inputs(jax_ref)).numpy()
    for r in range(P_):
        assert np.load(tmp_path / f"rank{r}.npy").tobytes() == \
            want[r].tobytes()


def test_mesh_and_topology_raise(worlds):
    mesh = make_mesh((P_,), ("data",), device=CPU)
    assert mesh.num_workers == P_ and mesh.device == CPU
    assert mesh.hosts == 1 and mesh.axis_names == ("data",)
    hier = make_mesh((2, 2), ("dcn", "data"), device=CPU)
    assert hier.num_workers == P_ and hier.hosts == 2
    assert hier.devices_per_host == 2 and hier.axis_names == ("dcn", "data")
    assert Topology.parse("2x2", P_).make_mesh(CPU) == hier
    for shape, axes in (((2, 2), ("data", "dcn")), ((4,), ("model",)),
                        ((1, 2, 2), ("x", "dcn", "data"))):
        with pytest.raises(NotImplementedError):
            make_mesh(shape, axes, device=CPU)
    for bad in ("2x3", "2x", "hosts"):
        with pytest.raises(ValueError):
            Topology.parse(bad, P_)
    # a topology whose worker count disagrees with the runner's
    g, _, ws, dv, _ = worlds["torch"]
    cfg = TConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=4,
                  num_classes=g.num_classes, num_layers=2)
    with pytest.raises(ValueError, match="describes 6 workers"):
        DeviceRapidGNNRunner(ws, dv, cfg, TAdamW(lr=LR), hier, B, g.labels,
                             topology=Topology.hierarchical(2, 3))
    # a hierarchical epoch needs the mesh's host split
    for make in (make_pipelined_epoch, make_ondemand_epoch):
        with pytest.raises(ValueError, match="topology 2x2"):
            make(cfg, TAdamW(lr=LR), mesh, 8,
                 topology=Topology.hierarchical(2, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((P_,), ("data",))


# ---------------------------------------------------------------------------
# collation (numpy copies)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    """The tiny graph's P = 4 epoch in both packages: (graph, partition,
    schedules, device view, epoch schedules) for "jax" and "torch", plus
    the shared bounds."""
    out = {}
    for key, load, part, sampler, build, dv in (
            ("jax", j_load, j_part, JSampler, j_build_schedule, JDeviceView),
            ("torch", t_load, t_part, TSampler, t_build_schedule,
             TDeviceView)):
        g = load("tiny")
        pg = part(g, P_, "greedy")
        smp = sampler(g, fanouts=list(FANOUTS), batch_size=B)
        ws = [build(smp, pg, worker=w, s0=S0, num_epochs=1, n_hot=N_HOT)
              for w in range(P_)]
        out[key] = (g, pg, ws, dv.build(pg), [w.epoch(0) for w in ws])
    es = out["torch"][4]
    m_max = max(e.m_max for e in es)
    edge_max = None
    for e in es:
        em = t_edge_maxima(e)
        edge_max = em if edge_max is None else [max(a, b) for a, b
                                                in zip(edge_max, em)]
    je = out["jax"][4]
    assert m_max == max(e.m_max for e in je)
    assert [max(a) for a in zip(*(j_edge_maxima(e) for e in je))] == \
        list(edge_max)
    out["bounds"] = (m_max, list(edge_max),
                     max(e.num_batches for e in es))
    return out


def _epoch_equal(a, b) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        xs, ys = (a[k], b[k]) if isinstance(a[k], list) else ([a[k]], [b[k]])
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def _collated(worlds, key, cached=True):
    g, _, _, dv, es = worlds[key]
    m_max, edge_max, S = worlds["bounds"]
    if cached:
        caches = [dv.remap_cache(e.cache_ids) for e in es]
    else:
        caches = (j_empty_caches if key == "jax" else empty_caches)(
            P_, g.feat_dim)
    k_max = (j_epoch_k_max if key == "jax" else epoch_k_max)(es, caches, dv)
    collate = j_collate if key == "jax" else collate_device_epoch
    return (collate(es, caches, dv, g.labels, B, m_max, edge_max, k_max, S),
            caches, k_max)


@pytest.mark.parametrize("cached", [True, False])
def test_collate_device_epoch_matches_jax(worlds, cached):
    got, caches, k_max = _collated(worlds, "torch", cached)
    want, jcaches, jk = _collated(worlds, "jax", cached)
    assert k_max == jk
    _epoch_equal(got, want)
    g, _, _, dv, es = worlds["torch"]
    m_max, edge_max, S = worlds["bounds"]
    _epoch_equal(got, collate_device_epoch_loop(es, caches, dv, g.labels, B,
                                                m_max, edge_max, k_max, S))
    jg, _, _, jdv, jes = worlds["jax"]
    _epoch_equal(got, j_collate_loop(jes, jcaches, jdv, jg.labels, B, m_max,
                                     edge_max, jk, S))
    if cached:
        for x, y in zip(stack_caches(caches, dv, N_HOT),
                        j_stack_caches(jcaches, jdv, N_HOT)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_collation_errors_match_jax(worlds):
    for key, collate, stack in (("torch", collate_device_epoch,
                                 stack_caches),
                                ("jax", j_collate, j_stack_caches)):
        g, _, _, dv, es = worlds[key]
        m_max, edge_max, S = worlds["bounds"]
        caches = [dv.remap_cache(e.cache_ids) for e in es]
        with pytest.raises(ValueError, match="num_steps"):
            collate(es, caches, dv, g.labels, B, m_max, edge_max, 64, S - 1)
        with pytest.raises(ValueError, match="overflow"):
            collate(es, caches, dv, g.labels, B, m_max, edge_max, 1, S)
        with pytest.raises(ValueError, match="n_hot"):
            stack(caches, dv, 1)


def test_prefetch_stream_matches_jax():
    rng = np.random.default_rng(11)
    send = {"send_ids": rng.integers(0, 99, size=(5, 4, 4, 3)).astype(
                np.int32),
            "send_pos": rng.integers(0, 99, size=(5, 4, 4, 3)).astype(
                np.int32),
            "send_mask": rng.random((5, 4, 4, 3)) < 0.5}
    got = prefetch_stream({k: torch.from_numpy(v) for k, v in send.items()})
    want = j_prefetch_stream({k: jnp.asarray(v) for k, v in send.items()})
    for k in send:
        assert got[k].dtype == torch.from_numpy(send[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert not got["send_mask"][-1].any()


def test_host_miss_matrix_matches_jax_and_lanes(worlds):
    _, tpg, tws, _, _ = worlds["torch"]
    _, jpg, jws, _, _ = worlds["jax"]
    got = host_miss_matrix(tws, tpg, B)
    np.testing.assert_array_equal(got, j_host_miss_matrix(jws, jpg, B))
    batches, _, _ = _collated(worlds, "torch")
    np.testing.assert_array_equal(got[0],
                                  batches["send_mask"].sum(axis=(0, 2, 3)))


# ---------------------------------------------------------------------------
# the epochs
# ---------------------------------------------------------------------------

def _init_params(ref):
    n = len({k.split("_")[1] for k in ref if k.startswith("init_")})
    tree = {"layers": [{k: ref[f"init_{l}_{k}"] for k in
                        ("w_self", "w_neigh", "b")} for l in range(n)]}
    return params_from_numpy(tree, CPU)


def _run_epoch(worlds, ref, kind, backend="auto", agg="segment"):
    g, _, _, dv, _ = worlds["torch"]
    m_max = worlds["bounds"][0]
    cfg = TConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=HIDDEN,
                  num_classes=g.num_classes, num_layers=2, fanouts=FANOUTS,
                  agg_backend=agg)
    mesh = make_mesh((P_,), ("data",), device=CPU)
    opt = TAdamW(lr=LR)
    params = _init_params(ref)
    if kind == "rapid":
        batches, caches, _ = _collated(worlds, "torch")
        cids, cfeats = stack_caches(caches, dv, N_HOT)
        fn = make_pipelined_epoch(cfg, opt, mesh, m_max,
                                  assemble_backend=backend)
        out = fn(params, opt.init(params), dv.table, dv.offsets, cids,
                 cfeats, batches)
    else:
        batches, _, _ = _collated(worlds, "torch", cached=False)
        fn = make_ondemand_epoch(cfg, opt, mesh, m_max,
                                 assemble_backend=backend)
        out = fn(params, opt.init(params), dv.table, dv.offsets, batches)
    return out[0], out[2], out[3]


@pytest.mark.parametrize("kind,backend,agg", [
    ("rapid", "ref", "segment"), ("rapid", "fused", "kernel"),
    ("rapid", "staged", "kernel"), ("ondemand", "auto", "segment"),
    ("ondemand", "staged", "kernel")])
def test_epoch_matches_jax(worlds, jax_ref, kind, backend, agg):
    params, losses, accs = _run_epoch(worlds, jax_ref, kind, backend, agg)
    np.testing.assert_allclose(losses.numpy(), jax_ref[f"{kind}_losses"],
                               **TOL)
    np.testing.assert_allclose(accs.numpy(), jax_ref[f"{kind}_accs"], **TOL)
    for l, layer in enumerate(params_to_numpy(params)["layers"]):
        for k, v in layer.items():
            np.testing.assert_allclose(v, jax_ref[f"{kind}_{l}_{k}"], **TOL)
    assert losses[-1] < losses[0]


def test_epoch_curves_bit_equal_within_port(worlds, jax_ref):
    runs = {(kind, be): _run_epoch(worlds, jax_ref, kind, be, "kernel")
            for kind, be in (("rapid", "fused"), ("rapid", "staged"),
                             ("rapid", "ref"), ("ondemand", "fused"))}
    again = _run_epoch(worlds, jax_ref, "rapid", "fused", "kernel")
    base = runs[("rapid", "fused")]
    for key, (p, losses, accs) in runs.items():
        assert torch.equal(losses, base[1]) and torch.equal(accs, base[2]), \
            key
        for x, y in zip(params_to_numpy(p)["layers"],
                        params_to_numpy(base[0])["layers"]):
            for k in x:
                assert x[k].tobytes() == y[k].tobytes(), (key, k)
    assert torch.equal(again[1], base[1])
    rapid, _, _ = _collated(worlds, "torch")
    ondemand, _, _ = _collated(worlds, "torch", cached=False)
    lanes = rapid["send_mask"].sum(axis=(0, 2, 3))
    assert (ondemand["send_mask"].sum(axis=(0, 2, 3)) >= lanes).all()
    _, tpg, tws, _, _ = worlds["torch"]
    np.testing.assert_array_equal(lanes, host_miss_matrix(tws, tpg, B)[0])


# ---------------------------------------------------------------------------
# token pipeline and the hot-token embedding cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-2b", "smollm-360m"])
def test_token_pipeline_matches_jax(arch):
    tcfg, jcfg = t_get_reduced(arch), j_get_reduced(arch)
    np.testing.assert_array_equal(t_enumerate(tcfg, 2, 32, 4, s0=9),
                                  j_enumerate(jcfg, 2, 32, 4, s0=9))
    for tb, jb in zip(t_lm_batches(tcfg, 2, 16, 3, s0=5),
                      j_lm_batches(jcfg, 2, 16, 3, s0=5)):
        assert sorted(tb) == sorted(jb)
        for k in tb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
            assert tb[k].numpy().dtype == np.asarray(jb[k]).dtype, k


def test_make_batch_options():
    import dataclasses
    cfg = dataclasses.replace(t_get_reduced("smollm-360m"),
                              mrope_sections=(2, 1, 1), frontend="vision",
                              kind="encdec")
    from repro_torch.graph.sampler import rng_from
    b = t_make_batch(cfg, rng_from(1), 2, 16)
    assert b["mrope_positions"].shape == (3, 2, 16)
    assert b["embeds"].shape == b["enc_embeds"].shape == (2, 16, cfg.d_model)
    assert b["embeds"].dtype == torch.float32


def test_hot_embedding_sim_matches_jax():
    rng = np.random.default_rng(5)
    counts = rng.zipf(1.2, size=1000).astype(np.int64)
    t = TSim(vocab=1000, d=8, num_workers=4, n_hot=64, counts=counts)
    j = JSim(vocab=1000, d=8, num_workers=4, n_hot=64, counts=counts)
    np.testing.assert_array_equal(t.owner, j.owner)
    for a, b in zip(t.cache, j.cache):
        np.testing.assert_array_equal(a, b)
    toks = rng.integers(0, 1000, size=(4, 64))
    for w in range(4):
        assert t.batch_traffic(toks, w) == j.batch_traffic(toks, w)
    assert t.cache_build_bytes() == j.cache_build_bytes()


def test_device_embedding_lookup_matches_jax(jax_ref):
    mesh = make_mesh((P_,), ("data",), device=CPU)
    plan = {k: torch.from_numpy(jax_ref[f"emb_{k}"]) for k in
            ("send_ids", "send_pos", "send_mask", "offsets")}
    tokens = jax_ref["emb_tokens"]
    got = device_embedding_lookup(
        mesh, torch.from_numpy(jax_ref["emb_table"]),
        *to_t(jax_ref["emb_cache_ids"], jax_ref["emb_cache_feats"], tokens),
        plan, tokens.shape[1])
    _bits_equal(got, jax_ref["emb_out"])
    table = jax_ref["emb_table"].reshape(-1, got.shape[-1])
    assert got.numpy().tobytes() == table[tokens].tobytes()
    assert (jax_ref["emb_cache_ids"] != SENTINEL).any()
