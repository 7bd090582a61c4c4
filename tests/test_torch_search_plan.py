"""The two rank plans of the hot-set lookup, emulated on the CPU and held
against the JAX package and the port's plain versions.

The kernels run only on the card; what is tested here is the arithmetic
their designs commit to, step by step as the kernels take it, so that a
fault in a plan shows without a GPU. Ranks and hits are integers and
assembled rows are copies: every comparison is bit-exact.

Fused assembly (``kernels/assemble/csrc/assemble.cu``). A warp owns one
output row. Unless the row is local it ranks its query with a 32-ary
search: at each level (``rank_steps``) lane k probes
``ids[min(lo + (k + 1) * step - 1, n_hot - 1)]``, the ballot of
``probe < q`` counts the probes below q and moves ``lo`` by that many
steps (held at ``n_hot``). The last level's lane ``count & 31`` holds
``ids[pos]`` for the hit test. The emulation must equal ``search_ref``
and the JAX ``search`` (Pallas kernel in interpret mode), and the rows
it selects must equal ``assemble_ref`` and the JAX ``assemble``.

Standalone ``search`` (``kernels/cache_lookup/csrc/search.cu``). A
splitter table holds the last id of each segment of ``seg`` ids
(``splitter_plan``); a thread binary-searches it for the first splitter
not below q, then takes the lower bound of q inside that one segment,
whose last id (its splitter) is known not to be below q, and reads
``ids[pos] == q`` there. The emulation must equal ``search_ref`` and the
JAX ``search``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_cases import (PLAN_KINDS, PLAN_N_HOTS, SENTINEL,
                          plan_assemble_case, plan_case, to_t)
from repro.kernels.assemble.ops import assemble_features as j_assemble
from repro.kernels.cache_lookup.cache_lookup import search as j_search
from repro_torch.kernels.assemble.ops import assemble_features as t_assemble
from repro_torch.kernels.assemble.ref import assemble_ref
from repro_torch.kernels.cache_lookup.ops import search as t_search
from repro_torch.kernels.cache_lookup.ref import search_ref
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

#: ``csrc/search.cu``'s splitter table words and the ids of a line
TABLE_WORDS, LINE = 2048, 32

CASES = [(n, k) for n in PLAN_N_HOTS for k in PLAN_KINDS]
IDS = [f"n{n}-{k}" for n, k in CASES]


# ---------------------------------------------------------------------------
# the two plans
# ---------------------------------------------------------------------------

def rank_steps(n_hot):
    """The steps of the fused kernel's 32-ary levels over n_hot >= 1
    sorted ids: ceil(n_hot / 32), then ceil(step / 32) down to 1."""
    steps = [-(-n_hot // 32)]
    while steps[-1] > 1:
        steps.append(-(-steps[-1] // 32))
    return steps


def splitter_plan(n_hot):
    """-> (seg, n_split) of the standalone kernel: segments of one line
    of ids, or of the least multiple of a line that keeps the table
    within TABLE_WORDS splitters."""
    seg = LINE * -(-n_hot // (TABLE_WORDS * LINE))
    return seg, -(-n_hot // seg)


def ballot_rank(ids, q):
    """The fused kernel's warp rank: -> (pos int32, hit bool, levels)."""
    n = ids.shape[0]
    ids64, q64 = ids.long(), q.long()
    lanes = torch.arange(1, 33, dtype=torch.int64)
    lo = torch.zeros(q.shape, dtype=torch.int64)
    steps = rank_steps(n)
    for step in steps:
        at = (lo[:, None] + lanes * step - 1).clamp(max=n - 1)
        probe = ids64[at]                                # one load a lane
        below = (probe < q64[:, None]).sum(1)            # ballot, popc
        lo = (lo + below * step).clamp(max=n)
    at_rank = probe.gather(1, (below & 31)[:, None])[:, 0]   # shfl
    hit = (lo < n) & (at_rank == q64) & (q64 != SENTINEL)
    return lo.to(torch.int32), hit, len(steps)


def splitter_rank(ids, q):
    """The standalone kernel's rank: -> (pos int32, hit bool)."""
    n = ids.shape[0]
    seg, n_split = splitter_plan(n)
    ids64, q64 = ids.long(), q.long()
    last = (torch.arange(1, n_split + 1, dtype=torch.int64) * seg - 1) \
        .clamp(max=n - 1)
    split = ids64[last]                                  # shared memory
    c = _lower_bound(split, q64, torch.zeros_like(q64),
                     torch.full_like(q64, n_split))
    inside = c < n_split
    # ids[end - 1] is segment c's splitter, not below q: the lower bound
    # lands in [begin, end - 1], one line of ids at seg = 32
    begin = (c * seg).clamp(max=n - 1)
    end = torch.minimum(begin + seg, torch.full_like(c, n))
    a = _lower_bound(ids64, q64, begin, end - 1)
    assert bool((ids64[a] >= q64)[inside].all())
    pos = torch.where(inside, a, torch.full_like(a, n))
    hit = inside & (ids64[a] == q64) & (q64 != SENTINEL)
    return pos.to(torch.int32), hit


def _lower_bound(s, q, lo, hi):
    """A thread's binary search, thread by thread: the first k in
    [lo, hi) with s[k] >= q, else hi."""
    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) >> 1
        less = s[mid.clamp(max=s.shape[0] - 1)] < q
        lo = torch.where(live & less, mid + 1, lo)
        hi = torch.where(live & ~less, mid, hi)
    return lo


def fused_rows(table, base, ids, feats, q, pulled):
    """The fused kernel's rows: local shard, else a hit's cache row at
    min(pos, n_hot - 1), else the pulled row."""
    n_per, n = table.shape[0], ids.shape[0]
    slot = q.long() - base
    local = (slot >= 0) & (slot < n_per)
    out = pulled.clone()
    if n:
        pos, hit, _ = ballot_rank(ids, q)
        take = ~local & hit
        out[take] = feats[pos.long().clamp(max=n - 1)[take]]
    out[local] = table[slot[local]]
    return out


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_search(n_hot, kind):
    ids, q = plan_case(n_hot, kind)
    pos, hit = j_search(jnp.asarray(ids), jnp.asarray(q), interpret=True)
    return np.asarray(pos), np.asarray(hit)


def _check_rank(pos, hit, n_hot, kind):
    ids, q = plan_case(n_hot, kind)
    want_pos, want_hit = search_ref(*to_t(ids, q))
    assert pos.dtype == torch.int32 and hit.dtype == torch.bool
    assert torch.equal(pos, want_pos) and torch.equal(hit, want_hit)
    j_pos, j_hit = _jax_search(n_hot, kind)
    np.testing.assert_array_equal(pos.numpy(), j_pos)
    np.testing.assert_array_equal(hit.numpy(), j_hit)
    np.testing.assert_array_equal(pos.numpy(),
                                  np.searchsorted(ids, q, side="left"))
    assert not hit.numpy()[(q == SENTINEL) | (q == -1)].any()
    real = ids[ids != SENTINEL]
    if kind == "all_hit" and real.size:
        assert bool(hit.all())
    if kind == "all_miss" or not real.size:
        assert not bool(hit.any())


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_hot,kind", CASES, ids=IDS)
def test_ballot_rank_equals_search_ref_and_jax(n_hot, kind):
    ids, q = plan_case(n_hot, kind)
    pos, hit, levels = ballot_rank(*to_t(ids, q))
    _check_rank(pos, hit, n_hot, kind)
    # 32-ary: ceil(log32(n_hot)) levels, at least one
    assert levels == max(1, int(np.ceil(np.log(n_hot) / np.log(32) - 1e-9)))


@pytest.mark.parametrize("n_hot,kind", CASES, ids=IDS)
def test_splitter_rank_equals_search_ref_and_jax(n_hot, kind):
    ids, q = plan_case(n_hot, kind)
    pos, hit = splitter_rank(*to_t(ids, q))
    _check_rank(pos, hit, n_hot, kind)
    # the port's wrapper on CPU tensors (the plain version) agrees too
    t_pos, t_hit = t_search(*to_t(ids, q))
    assert torch.equal(t_pos, pos) and torch.equal(t_hit, hit)


@pytest.mark.parametrize("n_hot,kind", CASES, ids=IDS)
def test_fused_plan_equals_assemble_ref_and_jax(n_hot, kind):
    table, base, ids, feats, q, pulled = plan_assemble_case(n_hot, kind)
    tt, ti, tf, tq, tp = to_t(table, ids, feats, q, pulled)
    got = fused_rows(tt, base, ti, tf, tq, tp)
    assert torch.equal(got, assemble_ref(tt, base, ti, tf, tq, tp))
    assert torch.equal(got, t_assemble(tt, base, ti, tf, tq, tp,
                                       backend="fused"))
    want = j_assemble(jnp.asarray(table), base, jnp.asarray(ids),
                      jnp.asarray(feats), jnp.asarray(q),
                      jnp.asarray(pulled), backend="fused", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_plan_cacheless_equals_jax():
    """No cache: the kernel never ranks; local shard over pulled rows."""
    table, base, _, _, q, pulled = plan_assemble_case(33, "mixed")
    tt, tq, tp = to_t(table, q, pulled)
    got = fused_rows(tt, base, torch.zeros(0, dtype=torch.int32),
                     torch.zeros((0, tp.shape[1])), tq, tp)
    assert torch.equal(got, t_assemble(tt, base, None, None, tq, tp,
                                       backend="fused"))
    want = j_assemble(jnp.asarray(table), base, None, None, jnp.asarray(q),
                      jnp.asarray(pulled), backend="fused", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_hot", PLAN_N_HOTS)
def test_plans_fit_their_budgets(n_hot):
    """The splitter table stays within 2,048 words of shared memory, its
    segments are whole lines (one line up to 65,536 ids) and cover the
    ids once; the 32-ary search takes 3 levels at the serving cache and
    the paper grid's largest."""
    seg, n_split = splitter_plan(n_hot)
    assert n_split <= TABLE_WORDS and seg % LINE == 0
    assert (n_split - 1) * seg < n_hot <= n_split * seg
    if n_hot <= TABLE_WORDS * LINE:
        assert seg == LINE
    steps = rank_steps(n_hot)
    assert steps[-1] == 1 and 32 * steps[0] >= n_hot
    assert all(32 * b >= a for a, b in zip(steps, steps[1:]))
    if n_hot in (4096, 32768):
        assert steps == ([128, 4, 1] if n_hot == 4096 else [1024, 32, 1])
