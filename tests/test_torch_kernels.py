"""The port's kernel modules held against the JAX reference.

For each of ``search``, ``assemble_features`` and ``gather_agg`` the
same numpy inputs (made from a seed) go through the JAX package's Pallas
kernel in interpret mode, its jnp ``ref``, and the port's wrapper on CPU
tensors (which takes the plain PyTorch version). Tolerances:

  * ``search`` and ``assemble`` are integer ranks and row copies: bit-exact.
  * ``gather_agg`` sums the fan-out rows in order from zero in both the
    TPU kernel and the port, so it is bit-exact against the interpret-mode
    kernel; against the jnp ref, which reduces with ``sum(axis=1)`` in
    another order, it holds to ``rtol=1e-6, atol=1e-6``.

The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.assemble.ops import assemble_features as j_assemble
from repro.kernels.cache_lookup.cache_lookup import search as j_search
from repro.kernels.cache_lookup.ref import cache_lookup_ref as j_lookup_ref
from repro.kernels.gather_agg.gather_agg import gather_agg as j_gather_agg
from repro.kernels.gather_agg.ref import gather_agg_ref as j_gather_ref
from repro_torch.kernels._build import use_plain
from repro_torch.kernels.assemble import ops as t_assemble_ops
from repro_torch.kernels.assemble.ops import assemble_features as t_assemble
from repro_torch.kernels.cache_lookup import ops as t_search_ops
from repro_torch.kernels.gather_agg import ops as t_gather_ops

from _torch_cases import (ASSEMBLE_CASES, GATHER_CASES, SEARCH_CASES,
                          SENTINEL, assemble_case, cache_ids_for,
                          gather_case, search_case, to_t)
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SEARCH_CASES))
def test_search_matches_jax_kernel_and_ref(name):
    ids, q = search_case(name)
    pos_t, hit_t = t_search_ops.search(torch.from_numpy(ids),
                                       torch.from_numpy(q))
    assert pos_t.dtype == torch.int32 and hit_t.dtype == torch.bool
    pos_j, hit_j = j_search(jnp.asarray(ids), jnp.asarray(q),
                            interpret=True)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    # the jnp oracle's hit vector (its merged rows are not needed here)
    d = 3
    _, hit_r = j_lookup_ref(jnp.asarray(ids),
                            jnp.zeros((ids.shape[0], d), jnp.float32),
                            jnp.asarray(q), jnp.zeros((q.shape[0], d)))
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_r))
    if ids.shape[0]:
        np.testing.assert_array_equal(
            pos_t.numpy(), np.searchsorted(ids, q, side="left"))
    # sentinel and -1 queries never hit
    assert not hit_t.numpy()[(q == SENTINEL) | (q == -1)].any()


def test_search_all_hit_and_all_miss():
    rng = np.random.default_rng(3)
    ids = cache_ids_for(rng, 32, 100, 400)
    for q in (rng.choice(ids, size=40).astype(np.int32),          # all hit
              rng.integers(500, 900, size=40).astype(np.int32)):  # all miss
        pos_t, hit_t = t_search_ops.search(torch.from_numpy(ids),
                                           torch.from_numpy(q))
        pos_j, hit_j = j_search(jnp.asarray(ids), jnp.asarray(q),
                                interpret=True)
        np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
        np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
        assert hit_t.all() or not hit_t.any()


# ---------------------------------------------------------------------------
# assemble
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ASSEMBLE_CASES))
def test_assemble_matches_jax_kernel_and_ref(name):
    table, base, ids, feats, q, pulled = assemble_case(name)
    j_args = (jnp.asarray(table), base, jnp.asarray(ids),
              jnp.asarray(feats), jnp.asarray(q), jnp.asarray(pulled))
    want_kernel = np.asarray(j_assemble(*j_args, backend="fused",
                                        interpret=True))
    want_ref = np.asarray(j_assemble(*j_args, backend="ref"))
    np.testing.assert_array_equal(want_kernel, want_ref)
    tt, ti, tf, tq, tp = to_t(table, ids, feats, q, pulled)
    for backend in ("auto", "fused", "ref"):
        got = t_assemble(tt, base, ti, tf, tq, tp, backend=backend)
        assert got.shape == pulled.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want_kernel)


def test_assemble_cacheless_matches_jax():
    table, base, _ids, _feats, q, pulled = assemble_case("mixed")
    want = np.asarray(j_assemble(jnp.asarray(table), base, None, None,
                                 jnp.asarray(q), jnp.asarray(pulled),
                                 backend="ref"))
    tt, tq, tp = to_t(table, q, pulled)
    for backend in ("fused", "ref"):
        got = t_assemble(tt, base, None, None, tq, tp, backend=backend)
        np.testing.assert_array_equal(got.numpy(), want)


def test_assemble_priority_local_over_cache():
    """An id both local and cached must serve the LOCAL row."""
    rng = np.random.default_rng(11)
    d, n_per, base = 8, 10, 20
    table = rng.normal(size=(n_per, d)).astype(np.float32)
    ids = np.array([21, 25, 40], np.int32)          # 21, 25 also local
    feats = rng.normal(size=(3, d)).astype(np.float32)
    q = np.array([21, 25, 40, 41, -1], np.int32)
    pulled = rng.normal(size=(5, d)).astype(np.float32)
    got = t_assemble(*to_t(table), base, *to_t(ids, feats, q, pulled),
                     backend="fused").numpy()
    np.testing.assert_array_equal(got[0], table[1])
    np.testing.assert_array_equal(got[1], table[5])
    np.testing.assert_array_equal(got[2], feats[2])
    np.testing.assert_array_equal(got[3], pulled[3])
    np.testing.assert_array_equal(got[4], pulled[4])


def test_assemble_backend_validation():
    with pytest.raises(ValueError):
        t_assemble_ops.resolve_backend("pallas", torch.device("cpu"))
    assert t_assemble_ops.resolve_backend(
        "staged", torch.device("cpu")) == "staged"
    assert t_assemble_ops.resolve_backend(
        "auto", torch.device("cpu")) == "ref"
    assert t_assemble_ops.resolve_backend(
        "auto", torch.device("cuda")) == "fused"


# ---------------------------------------------------------------------------
# gather_agg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GATHER_CASES))
def test_gather_agg_matches_jax_kernel_and_ref(name):
    h, src, mask, nd, fo = gather_case(name)
    got = t_gather_ops.gather_agg(*to_t(h, src, mask), nd=nd,
                                  fanout=fo).numpy()
    assert got.shape == (nd, h.shape[1])
    kernel = np.asarray(j_gather_agg(jnp.asarray(h), jnp.asarray(src),
                                     jnp.asarray(mask), nd, fo,
                                     interpret=True))
    # both sum j = 0..fanout-1 in order from zero: exact
    np.testing.assert_array_equal(got, kernel)
    ref = np.asarray(j_gather_ref(jnp.asarray(h), jnp.asarray(src),
                                  jnp.asarray(mask), nd, fo))
    # the jnp ref reduces in another order
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], 0.0)    # zero-degree row


def test_gather_agg_refuses_gradients():
    """First-order gradients flow to ``h`` (``test_torch_train`` holds
    them against the JAX VJP); a gradient of the gradient is refused,
    as the backward is a kernel with no backward of its own."""
    h, src, mask, nd, fo = gather_case("small")
    th = torch.from_numpy(h).requires_grad_(True)
    out = t_gather_ops.gather_agg(th, *to_t(src, mask), nd=nd, fanout=fo)
    (dh,) = torch.autograd.grad(out.sum(), th, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dh.sum(), th)
    with torch.no_grad():
        t_gather_ops.gather_agg(th, *to_t(src, mask), nd=nd, fanout=fo)


def test_wrappers_check_inputs():
    h, src, mask, nd, fo = gather_case("small")
    with pytest.raises(ValueError):        # wrong dtype
        t_gather_ops.gather_agg(torch.from_numpy(h).double(),
                                *to_t(src, mask), nd=nd, fanout=fo)
    with pytest.raises(ValueError):        # wrong edge count
        t_gather_ops.gather_agg(*to_t(h, src, mask), nd=nd + 1, fanout=fo)
    with pytest.raises(ValueError):        # int64 ids
        t_search_ops.search(torch.zeros(3, dtype=torch.int64),
                            torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):        # non-contiguous
        t_search_ops.search(torch.zeros(3, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32)[::2])


def test_cpu_tensors_take_the_plain_version_without_launching():
    """On the CPU the wrappers never count a launch: only a kernel
    launch on a CUDA tensor bumps the counter."""
    counts = [c.value for c in (t_search_ops.LAUNCHES,
                                t_assemble_ops.LAUNCHES,
                                t_gather_ops.LAUNCHES)]
    test_assemble_matches_jax_kernel_and_ref("mixed")
    test_gather_agg_matches_jax_kernel_and_ref("small")
    assert counts == [c.value for c in (t_search_ops.LAUNCHES,
                                        t_assemble_ops.LAUNCHES,
                                        t_gather_ops.LAUNCHES)]
    assert use_plain(False, torch.zeros(1))
    assert use_plain(True, torch.zeros(1))
    with pytest.raises(ValueError):
        use_plain(False, torch.zeros(1, device="meta"))
