"""The port's schedule compiler against the JAX package, on the CPU.

Bit for bit, dtypes included: the ``seg_sort`` plain version against the
JAX radix kernel (interpret mode) and ``jax.lax.sort``; the port's numpy
epoch compilers and its device compiler (run on CPU tensors, so the
sorts take the plain version) against the JAX compilers, on both lookup
paths and both fallbacks; the remote-frequency count and the hot set;
and ``build_schedule`` with every compiler, in memory, spilled to npz
and lazy.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_cases import SMALL_SORT_CASES, sort_case, to_t
from strategies import build_sampler_graph
from repro.core import build_schedule as j_build_schedule
from repro.core.schedule import load_epoch_npz as j_load_epoch_npz
from repro.core.schedule import select_hot_set as j_select_hot_set
from repro.graph import KHopSampler as JSampler
from repro.graph import load_dataset as j_load, partition_graph as j_part
from repro.graph.device_sampler import \
    sample_epoch_batched_device as j_device_epoch
from repro.kernels.seg_sort.ref import seg_sort_ref as j_sort_ref
from repro.kernels.seg_sort.seg_sort import radix_sort as j_radix_sort
import repro_torch.graph.device_sampler as t_dsm
import repro_torch.graph.sampler as t_sampler_mod
from repro_torch.core import build_schedule as t_build_schedule
from repro_torch.core.schedule import load_epoch_npz as t_load_epoch_npz
from repro_torch.graph import KHopSampler as TSampler
from repro_torch.graph import load_dataset as t_load, partition_graph as t_part
from repro_torch.graph.device_sampler import (device_remote_freq,
                                              device_select_hot_set,
                                              sample_epoch_batched_device)
from repro_torch.graph.graph import Graph as TGraph
from repro_torch.kernels.seg_sort import ops as t_sort_ops
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

CPU = torch.device("cpu")


def assert_flat_bit_equal(ref, got):
    """Every FlatEpoch array AND dtype identical."""
    assert (ref.epoch, ref.worker) == (got.epoch, got.worker)
    assert ref.num_batches == got.num_batches
    assert ref.num_layers == got.num_layers
    for f in ("seeds", "seed_starts", "input_nodes", "input_starts",
              "num_dst"):
        a, b = getattr(ref, f), getattr(got, f)
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert a.dtype == b.dtype, f
    for l in range(ref.num_layers):
        for f in ("edge_src", "edge_dst", "edge_mask", "edge_starts"):
            a, b = getattr(ref, f)[l], getattr(got, f)[l]
            np.testing.assert_array_equal(a, b, err_msg=f"{f}[{l}]")
            assert a.dtype == b.dtype, f"{f}[{l}]"


def port_graph(g):
    return TGraph(indptr=g.indptr, indices=g.indices, features=g.features,
                  labels=g.labels, num_classes=g.num_classes,
                  train_mask=g.train_mask)


# ---------------------------------------------------------------------------
# seg_sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SMALL_SORT_CASES)
def test_seg_sort_plain_equals_jax_radix_kernel_and_ref(name):
    keys, payload, num_bits = sort_case(name)
    before = t_sort_ops.LAUNCHES.value
    tp = None if payload is None else to_t(payload)[0]
    jp = None if payload is None else jnp.asarray(payload)
    rk, rp = j_radix_sort(jnp.asarray(keys), jp, num_bits=num_bits,
                          interpret=True)
    fk, fp = j_sort_ref(jnp.asarray(keys), jp)
    for interpret in (False, True):
        sk, sp = t_sort_ops.seg_sort(to_t(keys)[0], tp, num_bits=num_bits,
                                     interpret=interpret)
        for want in (rk, fk):
            np.testing.assert_array_equal(sk.numpy(), np.asarray(want))
        assert sk.dtype == torch.int32
        if payload is None:
            assert sp is None and rp is None
        else:
            np.testing.assert_array_equal(sp.numpy(), np.asarray(rp))
            np.testing.assert_array_equal(sp.numpy(), np.asarray(fp))
    assert t_sort_ops.LAUNCHES.value == before      # CPU: no kernel


def test_seg_sort_interspersed_sentinels_sort_last_stably():
    """Sentinels between real keys (the backward's masked-out edges)
    sort after every real key, in input order, as a stable sort of the
    full keys puts them."""
    keys, payload, num_bits = sort_case("interspersed_sentinel")
    sk, sp = t_sort_ops.seg_sort(*to_t(keys, payload), num_bits=num_bits)
    fk, fp = j_sort_ref(jnp.asarray(keys), jnp.asarray(payload))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(fk))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(fp))


def test_seg_sort_checks_inputs():
    k = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_sort_ops.seg_sort(k.long())
    with pytest.raises(ValueError):
        t_sort_ops.seg_sort(k, torch.zeros(3, dtype=torch.int32))
    for bits in (0, 32):
        with pytest.raises(ValueError):
            t_sort_ops.seg_sort(k, num_bits=bits)


# ---------------------------------------------------------------------------
# epoch compilers
# ---------------------------------------------------------------------------

def _sampler_pair(case):
    if case == "tiny":
        gj = j_load("tiny", seed=0)
        gt = t_load("tiny", seed=0)
        pt = t_part(gt, 4, "greedy")
        train = pt.local_nodes[1][gt.train_mask[pt.local_nodes[1]]]
        fanouts, batch = [5, 5], 16
    elif case == "zero_degree":
        gj = build_sampler_graph(5, n=60, n_zero=10)
        gt = port_graph(gj)
        train = np.arange(60, dtype=np.int64)
        fanouts, batch = [4, 3], 9
    else:                       # three layers, one batch larger than train
        gj = build_sampler_graph(2, n=40, n_zero=6, avg_deg=2)
        gt = port_graph(gj)
        train = np.arange(0, 40, 3, dtype=np.int64)
        fanouts, batch = [3, 2, 2], 20
    return (JSampler(gj, fanouts=fanouts, batch_size=batch),
            TSampler(gt, fanouts=fanouts, batch_size=batch), train)


@pytest.mark.parametrize("case", ["tiny", "zero_degree", "three_layers"])
def test_epoch_compilers_bit_equal_to_jax(case):
    js, ts, train = _sampler_pair(case)
    s0, w, e = 13, 1, 2
    want = js.sample_epoch_batched(s0, w, e, train)
    assert_flat_bit_equal(want, ts.sample_epoch_batched(s0, w, e, train))
    assert_flat_bit_equal(
        want, j_device_epoch(js, s0, w, e, train))
    got = sample_epoch_batched_device(ts, s0, w, e, train, device=CPU)
    assert_flat_bit_equal(want, got)
    loop_j = js.sample_epoch(s0, w, e, train)
    loop_t = ts.sample_epoch(s0, w, e, train)
    assert len(loop_j) == len(loop_t) == want.num_batches
    for a, b in zip(loop_j, loop_t):
        np.testing.assert_array_equal(a.input_nodes, b.input_nodes)
        for x, y in zip(a.blocks, b.blocks):
            for f in ("edge_src", "edge_dst", "edge_mask"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
                assert getattr(x, f).dtype == getattr(y, f).dtype


def test_device_compiler_searchsorted_path(monkeypatch):
    """Key spaces past the dense-table budget take the searchsorted
    branch (``use_table=False``, the payload-carrying sort) -- still
    bit-equal to the JAX compilers."""
    js, ts, train = _sampler_pair("zero_degree")
    want = js.sample_epoch_batched(13, 1, 2, train)
    monkeypatch.setattr(t_dsm, "DEVICE_TABLE_MAX_SLOTS", 0)
    assert_flat_bit_equal(want, sample_epoch_batched_device(
        ts, 13, 1, 2, train, device=CPU))


def test_device_compiler_int64_key_fallback(monkeypatch):
    """Key spaces past the int32 bound take the numpy wide-key path."""
    js, ts, train = _sampler_pair("zero_degree")
    want = js.sample_epoch_batched(11, 0, 1, train)
    monkeypatch.setattr(t_dsm, "KEY_INT32_MAX_SLOTS", 0)
    monkeypatch.setattr(t_sampler_mod, "KEY_INT32_MAX_SLOTS", 0)
    got = sample_epoch_batched_device(ts, 11, 0, 1, train, device=CPU)
    assert_flat_bit_equal(want, got)


def test_device_compiler_empty_epoch():
    js, ts, _ = _sampler_pair("zero_degree")
    empty = np.zeros(0, np.int64)
    got = sample_epoch_batched_device(ts, 5, 0, 0, empty, device=CPU)
    assert got.num_batches == 0
    assert_flat_bit_equal(js.sample_epoch_batched(5, 0, 0, empty), got)


# ---------------------------------------------------------------------------
# remote frequencies and the hot set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("span", [100, 2 ** 31])
def test_device_remote_freq_matches_unique(span):
    rng = np.random.default_rng(4)
    for remote in (rng.integers(0, 97, size=500).astype(np.int64),
                   np.zeros(0, np.int64), np.array([5], np.int64)):
        ids, freq = device_remote_freq(remote, span=span, device=CPU)
        ri, rf = np.unique(remote, return_counts=True)
        np.testing.assert_array_equal(ids, ri)
        np.testing.assert_array_equal(freq, rf)
        assert ids.dtype == np.int64 and freq.dtype == np.int64


@pytest.mark.parametrize("n_hot", [0, 1, 7, 40, 1000])
def test_device_select_hot_set_matches_jax(n_hot):
    rng = np.random.default_rng(9)
    ids = np.unique(rng.integers(0, 5000, size=300)).astype(np.int64)
    freq = rng.integers(1, 6, size=ids.shape[0]).astype(np.int64)  # ties
    want = j_select_hot_set(ids, freq, n_hot)
    got = device_select_hot_set(ids, freq, n_hot, device=CPU)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    wide = ids.copy()
    wide[-1] = 2 ** 31 - 1               # an id at the sentinel: numpy path
    np.testing.assert_array_equal(
        device_select_hot_set(wide, freq, n_hot, device=CPU),
        j_select_hot_set(wide, freq, n_hot))


# ---------------------------------------------------------------------------
# build_schedule end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    gj, gt = j_load("tiny", seed=0), t_load("tiny", seed=0)
    return ((gj, j_part(gj, 4, "greedy")), (gt, t_part(gt, 4, "greedy")))


def _assert_schedules_equal(jw, tw, n_epochs):
    for e in range(n_epochs):
        a, b = jw.epoch(e), tw.epoch(e)
        assert a.epoch == b.epoch and a.m_max == b.m_max
        assert_flat_bit_equal(a.flat, b.flat)
        for f in ("remote_ids", "remote_freq", "cache_ids"):
            x, y = getattr(a, f), getattr(b, f)
            np.testing.assert_array_equal(x, y, err_msg=f)
            assert x.dtype == y.dtype, f
    assert jw.pad_bounds() == tw.pad_bounds()


@pytest.mark.parametrize("compiler", ["batched", "device", "loop"])
def test_build_schedule_equals_jax(worlds, compiler):
    (gj, pj), (gt, pt) = worlds
    kw = dict(s0=42, num_epochs=2, n_hot=64)
    for w in (0, 2):
        jw = j_build_schedule(JSampler(gj, fanouts=[5, 5], batch_size=16),
                              pj, worker=w, **kw)
        tw = t_build_schedule(TSampler(gt, fanouts=[5, 5], batch_size=16),
                              pt, worker=w, compiler=compiler, device=CPU,
                              **kw)
        _assert_schedules_equal(jw, tw, 2)
    with pytest.raises(ValueError):
        t_build_schedule(TSampler(gt, fanouts=[5, 5], batch_size=16), pt,
                         worker=0, compiler="bogus", **kw)


def test_build_schedule_spill_and_lazy_equal_jax(worlds, tmp_path):
    """Spilled to npz (the port's files load in the JAX package and the
    JAX files in the port) and lazy, the schedule is the JAX one."""
    (gj, pj), (gt, pt) = worlds
    kw = dict(worker=1, s0=7, num_epochs=2, n_hot=32)
    jw = j_build_schedule(JSampler(gj, fanouts=[5, 5], batch_size=16), pj,
                          spill_dir=str(tmp_path / "jax"), **kw)
    ts = TSampler(gt, fanouts=[5, 5], batch_size=16)
    spilled = t_build_schedule(ts, pt, spill_dir=str(tmp_path / "port"),
                               compiler="device", device=CPU, **kw)
    assert spilled.epochs == [None, None]
    _assert_schedules_equal(jw, spilled, 2)
    lazy = t_build_schedule(ts, pt, lazy=True, compiler="device",
                            device=CPU, **kw)
    assert lazy.epochs == [None, None] and lazy.spill_dir is None
    _assert_schedules_equal(jw, lazy, 2)
    for e in range(2):
        for load, d in ((j_load_epoch_npz, "port"), (t_load_epoch_npz, "jax")):
            es = load(str(tmp_path / d / f"w1_e{e}.npz"))
            np.testing.assert_array_equal(es.cache_ids,
                                          jw.epoch(e).cache_ids)
            np.testing.assert_array_equal(es.flat.input_nodes,
                                          jw.epoch(e).flat.input_nodes)
