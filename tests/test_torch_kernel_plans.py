"""The work plans of two CUDA kernels, emulated on the CPU and held
against the JAX package and the port's plain versions.

The kernels themselves run only on the card; what is tested here is the
arithmetic their designs commit to, so that a fault in the plan shows
without a GPU.

``gather_agg`` backward. The order kernel cuts the sources into tiles,
one a thread block cluster (``plan_backward``), and the dst rows into
slices, one a block of the cluster (``slice_rows``): each block counts
its slice's edges of the tile, the counts are scanned into each
(source, block) pair's first slot, and each block places its slice's
edges round by round from those cursors, ranked among a round's edges of
the same source in edge order (one warp places all of a source's edges
of a round). The emulation below does the same, with the blocks placing
in a random order (they run in no order): each run must come out in
edge order, the stable sort by source with masked edges left out. The
sum kernel cuts the placed edges into equal shares (``unit_share``), a
row that straddles two shares by columns (``row_columns``): every (row,
column) of a row some edge reads must fall in exactly one share (the
order kernel writes the zeros of the others), and each block's first
row, as the order kernel's owners write it, must be the row its share
starts in. The row sums add g[i] / count[i] in run
order from +0, so they must equal ``gather_agg_bwd_ref`` on the CPU bit
for bit (both add the same float32 quotients in edge order), and
``jax.vjp`` through the JAX ``gather_agg`` (Pallas kernel in interpret
mode) within the reference's cross-program tolerance ``rtol=1e-4,
atol=1e-5`` (XLA's ``segment_sum`` adds in its own order).

``flash_decode``. Each element's valid range ``[start, length)`` is cut
into ``plan_splits`` equal parts (``split_range``), each part's (acc, m,
l) partials are taken, and the parts are combined in split order 0..n-1,
as the kernel's last block does. The tensor-core kernel's own order is
modelled too: 16 KB tiles of keys taken round-robin by the block's key groups,
each with its own base-2 online softmax, p split into three bf16 terms
for P.V, the groups merged in group order, the splits combined in order.
The normalised output, m and l must be within ``rtol=1e-4, atol=1e-5``
(float32 outputs summed in another order) of the Pallas kernel in
interpret mode and of ``flash_decode_batched_ref``. The plan itself is a
function of the shapes: the card filled at every served shape, one split
at the decode loop's caches.
"""
import functools
import inspect
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (BWD_CASES, BWD_FULL_CASES, FLASH_DECODE_CASES,
                          as_dtype, bwd_case, flash_decode_case,
                          to_t)
from repro.kernels.flash_decode.flash_decode import DEFAULT_TS
from repro.kernels.flash_decode.ops import flash_decode as j_flash_decode
from repro.kernels.gather_agg.ops import gather_agg as j_gather_agg
from repro_torch.kernels.flash_decode.flash_decode import (
    MAX_SPLITS, MIN_SPLIT_BYTES, SLICE_HEADS, TILE_HEADS, head_slices,
    MMA_WARPS, launch_plan, mma_warps, plan_splits, row_slices, row_tiles,
    split_range)
from repro_torch.kernels.flash_decode.ref import (combine,
                                                  flash_decode_batched_ref)
from repro_torch.kernels.gather_agg.gather_agg import (
    MAX_TILE_ROWS, plan_backward, row_columns, slice_rows, unit_share)
from repro_torch.kernels.gather_agg.ref import gather_agg_bwd_ref
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

TOL = dict(rtol=1e-4, atol=1e-5)
#: the H100's multiprocessors, for the split plan
H100_SMS = 132

ALL_BWD = sorted({**BWD_CASES, **BWD_FULL_CASES})


# ---------------------------------------------------------------------------
# gather_agg backward: the by-source order and the ordered row sums
# ---------------------------------------------------------------------------

#: order clusters of 8 blocks an H100 runs at once
#: (``cudaOccupancyMaxActiveClusters`` for the order kernel)
H100_CLUSTERS = 16
#: the order kernel's rounds (edges compacted and placed at once) and
#: chunks (dst rows whose counts it holds), as in gather_agg_bwd.cu
ORDER_ROUND = 4096
ORDER_CHUNK_ROWS = 2048


def bwd_plan(m):
    return plan_backward(m, H100_SMS, H100_CLUSTERS)


def stable_ranks(keys):
    """Each entry's rank among the earlier entries of the same key."""
    order = np.argsort(keys, kind="stable")
    ranked = np.arange(keys.size) - np.searchsorted(keys[order],
                                                    keys[order])
    out = np.empty(keys.size, np.int64)
    out[order] = ranked
    return out


def placed_runs(src, mask, m, fanout, seed):
    """(begin, end) of each row and the dst rows of the placed pairs, as
    the order kernel leaves them: per tile, each block's counts of its
    slice, each (source, block)'s first slot from the scan, then each
    block's slice placed round by round from its cursors, the blocks in
    an order drawn from ``seed``."""
    nd = src.size // fanout
    cluster, tiles, tile_rows, _ = bwd_plan(m)
    valid = mask & (src >= 0) & (src < m)
    placed = np.full(int(valid.sum()), -1, np.int64)
    begin = np.empty(m + 1, np.int64)
    rng = np.random.default_rng(seed)
    for t in range(tiles):
        s0, s1 = t * tile_rows, min(m, (t + 1) * tile_rows)
        hist = np.zeros((cluster, s1 - s0), np.int64)
        below = 0
        for b in range(cluster):
            lo, hi = slice_rows(nd, cluster, b)
            s, v = src[lo * fanout:hi * fanout], valid[lo * fanout:hi * fanout]
            below += int((v & (s < s0)).sum())
            inn = v & (s >= s0) & (s < s1)
            hist[b] = np.bincount(s[inn] - s0, minlength=s1 - s0)
        runs = hist.sum(0)
        start = np.cumsum(runs) - runs
        cursor = start + np.cumsum(hist, 0) - hist        # (block, source)
        begin[s0:s1] = below + start
        for b in rng.permutation(cluster):
            lo, hi = slice_rows(nd, cluster, b)
            for c0 in range(lo, hi, ORDER_CHUNK_ROWS):
                ce1 = min(hi, c0 + ORDER_CHUNK_ROWS) * fanout
                for e0 in range(c0 * fanout, ce1, ORDER_ROUND):
                    e = np.arange(e0, min(e0 + ORDER_ROUND, ce1))
                    e = e[valid[e] & (src[e] >= s0) & (src[e] < s1)]
                    sl = src[e] - s0
                    slots = cursor[b, sl] + stable_ranks(sl)
                    assert (placed[below + slots] == -1).all()
                    placed[below + slots] = e // fanout
                    np.add.at(cursor[b], sl, 1)
    begin[m] = placed.size
    assert (placed >= 0).all()
    return begin[:-1], begin[1:], placed


def runs_of(begin, end, dst_rows):
    """Each row's run of dst rows, in the order the row sums take them."""
    return [dst_rows[b:e] for b, e in zip(begin, end)]


def ordered_row_sums(g, mask, nd, fo, runs):
    """dh (m, d): each run summed from +0 in float32, one quotient at a
    time in the order given, as the kernel's lanes add them."""
    cnt = np.maximum(mask.reshape(nd, fo).sum(1), 1).astype(np.float32)
    quot = g / cnt[:, None]                                # float32
    dh = np.zeros((len(runs), g.shape[1]), np.float32)
    length = np.array([r.size for r in runs])
    if length.size == 0:
        return dh
    for step in range(length.max(initial=0)):
        rows = np.flatnonzero(length > step)
        dh[rows] = dh[rows] + quot[[runs[r][step] for r in rows]]
    return dh


def sum_shares(begin, end, vec, nv):
    """The sum kernel's cells: per block j, its first row as the order
    kernel's owners write it (``bounds``), then (row, c0, c1) for each row
    its share of the placed edges reaches, as ``row_columns`` cuts them."""
    m, blocks = begin.size, H100_SMS
    run = end - begin
    units = int(end[-1]) if m else 0
    # owner s (run > 0) writes bounds[j] for ceil(b G / U) <= j <
    # ceil(e G / U), [b, e) its placed edges
    first_j = -(-begin * blocks // max(units, 1))
    last_j = np.minimum(-(-end * blocks // max(units, 1)), blocks)
    bounds = np.repeat(np.arange(m), np.where(run > 0, last_j - first_j, 0))
    assert bounds.size == (blocks if units else 0)
    parts = []
    for j in range(bounds.size):
        lo, hi = unit_share(units, blocks, j)
        assert bounds[j] == np.searchsorted(end, lo, "right")
        s = int(bounds[j])
        while lo < hi and s < m and begin[s] < hi:
            c0, c1 = row_columns(int(begin[s]), int(run[s]), lo, hi, nv)
            if c1 > c0:
                parts.append((j, s, c0, c1))
            s += 1
    return parts


def _vec(d):
    return 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1


def _jax_vjp(g, src, mask, m, nd, fo):
    rng = np.random.default_rng(m + nd)
    h = rng.normal(size=(m, g.shape[1])).astype(np.float32)
    _, vjp = jax.vjp(lambda hh: j_gather_agg(
        hh, jnp.asarray(src), jnp.asarray(mask), nd=nd, fanout=fo,
        use_kernel=True, interpret=True), jnp.asarray(h))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("name", ALL_BWD)
def test_backward_runs_are_the_stable_sort_by_source(name):
    g, src, mask, m, nd, fo = bwd_case(name)
    key = np.where(mask, src, m)
    stable = np.argsort(key, kind="stable")
    stable = stable[key[stable] < m]                        # masked last
    for seed in (0, 1):
        begin, end, dst_rows = placed_runs(src, mask, m, fo, seed)
        assert np.array_equal(dst_rows, stable // fo)
        assert np.array_equal(end - begin, np.bincount(src[mask],
                                                       minlength=m))


@pytest.mark.parametrize("name", ALL_BWD)
def test_backward_row_sums_equal_plain_version_and_jax(name):
    g, src, mask, m, nd, fo = bwd_case(name)
    plain = gather_agg_bwd_ref(*to_t(g, src, mask), m, nd, fo).numpy()
    vec = _vec(g.shape[1])
    for seed in (0, 1):
        begin, end, dst_rows = placed_runs(src, mask, m, fo, seed)
        whole = ordered_row_sums(g, mask, nd, fo,
                                 runs_of(begin, end, dst_rows))
        # the order kernel writes the zeros of the rows no edge reads;
        # each sum block its cells of the rows its share reaches
        dh = np.full_like(whole, np.nan)
        dh[end == begin] = 0.0
        for _, s, c0, c1 in sum_shares(begin, end, vec, g.shape[1] // vec):
            dh[s, c0 * vec:c1 * vec] = whole[s, c0 * vec:c1 * vec]
        np.testing.assert_array_equal(dh, plain)
    np.testing.assert_allclose(dh, _jax_vjp(g, src, mask, m, nd, fo), **TOL)


@pytest.mark.parametrize("name", ALL_BWD)
def test_backward_sum_shares_cover_each_cell_once(name):
    """Every (row, vector column) of dh is written once: the rows no edge
    reads by the order kernel, every other cell in exactly one sum
    block's share (shares meet inside a row only at adjacent columns); a
    block's share holds about edges / blocks placed edges."""
    g, src, mask, m, nd, fo = bwd_case(name)
    vec = _vec(g.shape[1])
    nv = g.shape[1] // vec
    begin, end, _ = placed_runs(src, mask, m, fo, 0)
    cover = np.zeros((m, nv), np.int32)
    cover[end == begin] += 1
    for _, s, c0, c1 in sum_shares(begin, end, vec, nv):
        cover[s, c0:c1] += 1
    assert (cover == 1).all()
    units = int(end[-1])
    sizes = [np.subtract(*unit_share(units, H100_SMS, j)[::-1])
             for j in range(H100_SMS)]
    assert sum(sizes) == units and max(sizes) - min(sizes) <= 1


#: (nd, fanout, m): the training path's layers, the rank-0 dry-run's,
#: tiny, ragged and huge row counts
PLAN_SHAPES = {
    "layer1": (1000, 10, 21_093),
    "layer0": (4777, 25, 21_093),
    "dryrun_rank0": (1000, 25, 26_000),
    "one_row": (3, 4, 1),
    "fewer_dst_rows_than_blocks": (5, 3, 64),
    "no_dst_rows": (0, 5, 10),
    "rows_above_tiles": (500, 4, 300_000),
    "ragged": (1639, 10, 16_385),
    "max_rows_a_wave": (7, 2, 16 * MAX_TILE_ROWS),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_backward_plan_cuts_edges_into_slices_and_sources_into_tiles(name):
    """Every edge lies in exactly one block's slice, the slices in edge
    order and made of whole dst rows; the tiles cover [0, m) once, each
    at most one block's histogram, and no more tiles than one wave of
    clusters unless m needs them."""
    nd, fo, m = PLAN_SHAPES[name]
    cluster, tiles, tile_rows, sum_blocks = bwd_plan(m)
    assert cluster == 8 and sum_blocks == H100_SMS
    cuts = [slice_rows(nd, cluster, b) for b in range(cluster)]
    edges = [e for lo, hi in cuts for e in range(lo * fo, hi * fo)]
    assert edges == list(range(nd * fo))
    assert cuts[0][0] == 0 and cuts[-1][1] == nd
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert 1 <= tile_rows <= MAX_TILE_ROWS
    assert (tiles - 1) * tile_rows < m <= tiles * tile_rows
    assert tiles <= max(H100_CLUSTERS, -(-m // MAX_TILE_ROWS))
    if m >= H100_CLUSTERS:
        assert tiles >= H100_CLUSTERS - 1 or tile_rows == MAX_TILE_ROWS


def test_backward_plan_is_a_function_of_shapes_only():
    """The plan reads m and the card (multiprocessors, clusters a wave),
    never the edges: the path's two layers share one plan."""
    assert list(inspect.signature(plan_backward).parameters) == [
        "m", "sms", "clusters"]
    assert list(inspect.signature(slice_rows).parameters) == [
        "nd", "cluster", "b"]
    assert bwd_plan(21_093) == (8, 16, 1319, H100_SMS) == bwd_plan(21_093)
    assert bwd_plan(1) == (8, 1, 1, H100_SMS)
    assert bwd_plan(300_000)[1:3] == (19, MAX_TILE_ROWS)
    hub = bwd_case("hub")
    assert np.bincount(hub[1][hub[2]]).max() > 300           # a hub row
    skew = bwd_case("edges_above_100k")
    assert skew[1].size > 100_000 and np.bincount(skew[1]).max() > 2000
    assert bwd_case("rows_above_tiles")[3] > MAX_TILE_ROWS
    assert bwd_case("all_masked")[2].sum() == 0


# ---------------------------------------------------------------------------
# flash_decode: each element's own range cut into splits, combined in order
# ---------------------------------------------------------------------------

def split_partials(q, k, v, length, start, softcap, n_split):
    """The kernel's plan on the plain version: (acc, m, l) of every split
    of every element's valid range, combined in split order."""
    B, S = k.shape[0], k.shape[1]
    parts = []
    for sp in range(n_split):
        cut = [split_range(int(start[b]), int(length[b]), S, n_split, sp)
               for b in range(B)]
        lo = torch.tensor([c[0] for c in cut], dtype=torch.int32)
        hi = torch.tensor([c[1] for c in cut], dtype=torch.int32)
        parts.append(flash_decode_batched_ref(q, k, v, hi, lo,
                                              softcap=softcap))
    return combine(parts)


def _pallas(q, k, v, length, start, softcap):
    """The Pallas kernel in interpret mode, element by element, on a cache
    padded with zeros to its tile (positions past ``length`` are never
    valid, so the padding changes nothing)."""
    B, S = k.shape[0], k.shape[1]
    ts = min(DEFAULT_TS, S)
    pad = -S % ts
    kp, vp = (np.pad(np.asarray(x.float()), ((0, 0), (0, pad), (0, 0),
                                               (0, 0))) for x in (k, v))
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    outs = [j_flash_decode(jnp.asarray(q[b].float().numpy()).astype(jdt),
                           jnp.asarray(kp[b]).astype(jdt),
                           jnp.asarray(vp[b]).astype(jdt),
                           jnp.asarray(length[b], jnp.int32),
                           jnp.asarray(start[b], jnp.int32), softcap=softcap,
                           use_kernel=True, interpret=True)
            for b in range(B)]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]


def _normalised(acc, m, l):
    """(acc / max(l, 1e-30), m, l) as float64 numpy."""
    acc, m, l = (np.asarray(x, np.float64) for x in (acc, m, l))
    return acc / np.maximum(l, 1e-30)[..., None], m, l


#: the tensor-core kernel's base-2 softmax
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def mma_partials(q, k, v, length, start, softcap, n_split):
    """The tensor-core kernel's order on the CPU: per (b, kv head) and
    split, the split's tiles (4096 / dh keys: 16 KB of K and V at the
    instance's width) taken round-robin by the block's key
    groups (``mma_warps`` of the grid, ``rtb`` row tiles a group), each
    group with its own base-2 running (m, l, acc) and p = p_hi + p_mid +
    p_lo in bf16 for P.V; the groups merged in group order, the splits combined
    in split order, m returned in natural units (-1e30 where no key is
    valid). Row tiles do not interact, so a group's heads run at once."""
    B, H, dh = q.shape
    S, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    scale = dh ** -0.5
    rtb = -(-row_tiles(G) // row_slices(G))
    warps = mma_warps(B * kvH * row_slices(G) * n_split, G, H100_SMS)
    groups = warps // (4 if rtb == 3 else rtb)
    # keys a tile: 16 KB of K and V at the instance's width (64/128/256)
    kt = 4096 // (64 if dh <= 64 else 128 if dh <= 128 else 256)
    c1 = scale / softcap if softcap > 0 else scale * LOG2E
    acc = torch.zeros((B, H, dh))
    m = torch.full((B, H), -1e30)
    l = torch.zeros((B, H))

    def merged(states):
        mg = torch.stack([st[0] for st in states]).amax(0)
        a, s_ = torch.zeros_like(states[0][2]), torch.zeros_like(mg)
        for m_, l_, a_ in states:
            w = torch.exp2(m_ - mg)
            s_, a = s_ + l_ * w, a + a_ * w[:, None]
        return mg, s_, a
    for b in range(B):
        for h in range(kvH):
            qg = q[b, h * G:(h + 1) * G].float()
            kb, vb = k[b, :, h].float(), v[b, :, h].float()
            splits = []
            for sp in range(n_split):
                lo, hi = split_range(int(start[b]), int(length[b]), S,
                                     n_split, sp)
                tiles = -(-max(hi - lo, 0) // kt)
                states = []
                for kg in range(groups):
                    mg = torch.full((G,), -1e30)
                    lg, ag = torch.zeros(G), torch.zeros((G, dh))
                    for t in range(kg, tiles, groups):
                        keys = slice(lo + kt * t, min(lo + kt * t + kt, hi))
                        x = (qg @ kb[keys].T) * c1
                        if softcap > 0:
                            x = torch.tanh(x) * (softcap * LOG2E)
                        mn = torch.maximum(mg, x.amax(1))
                        alpha = torch.exp2(mg - mn)
                        p = torch.exp2(x - mn[:, None])
                        p_hi = p.bfloat16().float()
                        p_mid = (p - p_hi).bfloat16().float()
                        p_lo = (p - p_hi - p_mid).bfloat16().float()
                        lg = lg * alpha + p.sum(1)
                        ag = ag * alpha[:, None] + p_hi @ vb[keys] + \
                            p_mid @ vb[keys] + p_lo @ vb[keys]
                        mg = mn
                    states.append((mg, lg, ag))
                splits.append(merged(states))
            mg, lg, ag = merged([(m_, l_, a_) for m_, l_, a_ in splits])
            rows = slice(h * G, (h + 1) * G)
            acc[b, rows], l[b, rows] = ag, lg
            m[b, rows] = torch.where(mg == -1e30, mg, mg * LN2)
    return acc, m, l


@functools.lru_cache(maxsize=None)
def _references(name):
    """The case's plain version and Pallas kernel, normalised."""
    qn, kn, vn, length, start, cap, dtype = flash_decode_case(name)
    q, k, v = (as_dtype(x, dtype) for x in (qn, kn, vn))
    want = flash_decode_batched_ref(q, k, v, torch.from_numpy(length),
                                    torch.from_numpy(start), softcap=cap)
    return (_normalised(*want),
            _normalised(*_pallas(q, k, v, length, start, cap)))


def _check(q, k, v, length, start, softcap, n_splits, refs=None,
           partials=split_partials):
    """acc is compared normalised, as ``finalize`` gives it: it is a sum
    of up to 20,000 terms p * v with p <= 1, so its rounding grows with
    l, and an absolute 1e-5 on it would hold the order of a long sum, not
    the plan (the plain version and the Pallas kernel themselves differ
    by 2.7e-5 in acc where l is 825). m and l are compared as they are."""
    if refs is None:
        want = flash_decode_batched_ref(q, k, v, torch.from_numpy(length),
                                        torch.from_numpy(start),
                                        softcap=softcap)
        refs = [_normalised(*want),
                _normalised(*_pallas(q, k, v, length, start, softcap))]
    for n_split in n_splits:
        got = _normalised(*partials(q, k, v, length, start, softcap,
                                    n_split))
        for ref in refs:
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a, b, **TOL)


def _case_plan(name):
    qn, kn, vn, length, start, cap, dtype = flash_decode_case(name)
    q, k, v = (as_dtype(x, dtype) for x in (qn, kn, vn))
    B, S, kvH = k.shape[0], k.shape[1], k.shape[2]
    plan = launch_plan(B, S, q.shape[1], kvH, q.shape[2], q.dtype,
                       H100_SMS)[1]
    return q, k, v, length, start, cap, plan


@pytest.mark.parametrize("name", sorted(FLASH_DECODE_CASES))
def test_flash_decode_split_plan_matches_pallas_and_plain(name):
    q, k, v, length, start, cap, plan = _case_plan(name)
    _check(q, k, v, length, start, cap, sorted({1, plan, 7}),
           refs=_references(name))


@pytest.mark.parametrize("name", sorted(FLASH_DECODE_CASES))
def test_flash_decode_tensor_core_order_matches_pallas_and_plain(name):
    """The tensor-core kernel's arithmetic order (``mma_partials``) at
    the card's split plan and at 3 splits."""
    q, k, v, length, start, cap, plan = _case_plan(name)
    _check(q, k, v, length, start, cap, sorted({plan, 3}),
           refs=_references(name), partials=mma_partials)


def test_flash_decode_split_plan_at_the_decode_loop_shape():
    """gemma2-2b's decode loop: B=8, 8 q heads over 4 kv heads, dh 256,
    a 48-slot bfloat16 cache filled to lengths 16..47 (one split), in
    the split plan's order and the tensor-core kernel's."""
    rng = np.random.default_rng(48)
    B, H, kvH, dh, S = 8, 8, 4, 256, 48
    assert launch_plan(B, S, H, kvH, dh, torch.bfloat16,
                       H100_SMS) == (1, 1, 4)
    for lens in np.arange(16, 48, dtype=np.int32).reshape(4, B):
        q, k, v = (as_dtype(rng.normal(size=shape).astype(np.float32),
                            "bfloat16")
                   for shape in ((B, H, dh), (B, S, kvH, dh),
                                 (B, S, kvH, dh)))
        _check(q, k, v, lens, np.zeros(B, np.int32), 50.0, (1, 3))
        _check(q, k, v, lens, np.zeros(B, np.int32), 50.0, (1,),
               partials=mma_partials)


def test_flash_decode_head_slices_cut_wide_groups_evenly():
    """float32: more than 8 q heads a kv head are cut into the fewest
    equal slices of at most 8 (each a block); 8 or fewer stay whole."""
    for G in range(1, 65):
        n = head_slices(G)
        assert G % n == 0 and G // n <= SLICE_HEADS
        assert all(G % m or G // m > SLICE_HEADS for m in range(1, n))
    assert [head_slices(G) for G in (1, 2, 4, 8, 16)] == [1, 1, 1, 1, 2]


def test_flash_decode_row_tiles_hold_every_group_in_one_block():
    """bfloat16: ceil(G/16) row tiles of the MMA, all in one block up to
    one tile a warp (64 heads), more in the fewest blocks beyond; so every
    served group (G = 1, 2, 8, 16) is one block a kv head and its K/V
    are read once."""
    for G in range(1, 200):
        assert row_tiles(G) == math.ceil(G / TILE_HEADS)
        n = row_slices(G)
        assert n * MMA_WARPS >= row_tiles(G) > (n - 1) * MMA_WARPS
    assert [row_slices(G) for G in (1, 2, 8, 16, 24, 32, 64, 65, 129)] == \
        [1, 1, 1, 1, 1, 1, 1, 2, 3]
    for G, dh in ((8, 128), (16, 256), (2, 256), (1, 64)):
        assert launch_plan(8, 4096, G * 4, 4, dh, torch.bfloat16,
                           H100_SMS)[0] == 1
    assert launch_plan(8, 4096, 64, 4, 128, torch.float32,
                       H100_SMS)[0] == 2


#: every served model's decode shape on the card (B, S, H, kvH, dh):
#: gemma2-2b's long cache, recurrentgemma-9b's window, qwen3-moe's and
#: qwen2-vl-72b's caches, the sharded call folded at tp = 4, seamless's
#: self and cross caches
ROW_SHAPES = {
    "gemma2-2b long": (16, 32768, 8, 4, 256),
    "recurrentgemma-9b window": (8, 2048, 16, 1, 256),
    "qwen3-moe-30b-a3b": (8, 4096, 32, 4, 128),
    "qwen2-vl-72b": (8, 8192, 64, 8, 128),
    "qwen3-moe folded tp=4": (32, 1024, 32, 4, 128),
    "seamless-m4t-medium self": (8, 8192, 16, 16, 64),
    "seamless-m4t-medium cross": (8, 4096, 16, 16, 64),
}
#: the decode loops' 48-slot caches
LOOP_SHAPES = {
    "gemma2-2b": (8, 48, 8, 4, 256),
    "recurrentgemma-9b": (8, 48, 16, 1, 256),
    "qwen3-moe-30b-a3b": (8, 48, 32, 4, 128),
    "qwen2-vl-72b": (8, 48, 64, 8, 128),
    "seamless-m4t-medium": (8, 48, 16, 16, 64),
}


@pytest.mark.parametrize("name", sorted(ROW_SHAPES))
def test_flash_decode_plan_fills_the_card_at_every_row(name):
    """Every served shape's grid gives at least 96 % of the card's
    multiprocessors a block (recurrentgemma-9b's 8 columns: 16 splits,
    128 blocks, one wave of one block a multiprocessor; 17 would start a
    second wave for 4 blocks), no split under the floor of K/V bytes."""
    B, S, H, kvH, dh = ROW_SHAPES[name]
    for dtype in (torch.bfloat16, torch.float32):
        slices, n_split, _ = launch_plan(B, S, H, kvH, dh, dtype, H100_SMS)
        assert B * kvH * slices * n_split >= 0.96 * H100_SMS
        assert 1 < n_split <= MAX_SPLITS
        assert math.ceil(S / n_split) * 2 * dh * dtype.itemsize >= \
            MIN_SPLIT_BYTES
    assert launch_plan(8, 2048, 16, 1, 256, torch.bfloat16,
                       H100_SMS) == (1, 16, 4)
    assert plan_splits(8, 2048, 1024, 132) * 8 <= 132


@pytest.mark.parametrize("name", sorted(LOOP_SHAPES))
def test_flash_decode_plan_takes_one_split_at_the_loop_shapes(name):
    B, S, H, kvH, dh = LOOP_SHAPES[name]
    for dtype in (torch.bfloat16, torch.float32):
        assert launch_plan(B, S, H, kvH, dh, dtype, H100_SMS)[1] == 1


def test_flash_decode_plan_is_a_function_of_shapes_only():
    """The plan reads shapes, a dtype and the card's multiprocessors,
    never the lengths; bfloat16 at G >= 2 takes the tensor-core kernel
    with 4 warps a block on grids of about one block a multiprocessor
    (the decode loops, recurrentgemma-9b's window) and on wide groups, 2
    on larger grids; G = 1 and float32 take the CUDA-core kernel."""
    assert list(inspect.signature(plan_splits).parameters) == [
        "columns", "S", "row_bytes", "sms"]
    assert list(inspect.signature(launch_plan).parameters) == [
        "B", "S", "H", "kvH", "dh", "dtype", "sms"]
    for shape in (*ROW_SHAPES.values(), *LOOP_SHAPES.values()):
        assert launch_plan(*shape, torch.bfloat16, H100_SMS) == \
            launch_plan(*shape, torch.bfloat16, H100_SMS)
    for name, (B, S, H, kvH, dh) in LOOP_SHAPES.items():
        # G = 1 (seamless-m4t-medium) takes the CUDA-core kernel
        assert launch_plan(B, S, H, kvH, dh, torch.bfloat16,
                           H100_SMS)[2] == (4 if H > kvH else 0)
    assert launch_plan(*ROW_SHAPES["recurrentgemma-9b window"],
                       torch.bfloat16, H100_SMS)[2] == 4
    assert launch_plan(*ROW_SHAPES["qwen2-vl-72b"], torch.bfloat16,
                       H100_SMS)[2] == 2
    assert mma_warps(10 ** 6, 33, H100_SMS) == 4     # 3 row tiles
    assert launch_plan(8, 4096, 64, 4, 128, torch.float32,
                       H100_SMS)[2] == 0


def test_flash_decode_split_ranges_cover_each_element_once():
    """The splits of [start, length) are disjoint, in order, cover it,
    and differ in size by at most one chunk's remainder; an empty or
    inverted range gives empty splits."""
    for start, length, S, n_split in ((0, 32768, 32768, 17),
                                      (999, 1000, 32768, 17),
                                      (5, 3, 8, 4), (0, 0, 1, 1),
                                      (-3, 40, 32, 5), (28672, 32768, 32768,
                                                        17)):
        cuts = [split_range(start, length, S, n_split, sp)
                for sp in range(n_split)]
        lo_b, hi_b = max(start, 0), min(length, S)
        covered = [p for lo, hi in cuts for p in range(lo, hi)]
        assert covered == list(range(lo_b, max(hi_b, lo_b)))
        sizes = [hi - lo for lo, hi in cuts]
        assert max(sizes) == -(-max(hi_b - lo_b, 0) // n_split)
    # the long cache of the card's check: 64 (b, kv head) columns, the
    # most splits
    assert launch_plan(16, 32768, 8, 4, 256, torch.bfloat16,
                       H100_SMS)[:2] == (1, MAX_SPLITS)
