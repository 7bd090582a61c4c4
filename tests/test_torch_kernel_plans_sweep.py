"""The work plans of the ``gather_agg`` forward and the clustered
one-sweep ``seg_sort`` kernels, emulated on the CPU and held against the JAX
package and the port's plain versions.

The kernels run only on the card; what is tested here is the arithmetic
and the index plan their designs commit to, so that a fault in the plan
shows without a GPU.

``gather_agg`` forward (``csrc/gather_agg.cu``). ``plan_forward`` gives
``splits`` warps a dst row, each a slice of the row's ``d // vec``
vectors taken in column passes of ``32 * chunks``; lanes load the row's
edges in rounds of 32, the unmasked ones are taken ``unroll`` at a time
(all their rows loaded before their adds) and added in edge order from
+0, then divided by ``max(count, 1)``. The emulation walks that plan
warp by warp and lane by lane, for the plan the card picks and for
other splits and vector widths: every output element must be written
exactly once, the result must equal ``gather_agg_ref`` bit for bit (the
same float32 adds in the same order, the same IEEE division) and lie
within the reference's cross-program tolerance ``rtol=1e-4, atol=1e-5``
of the JAX ``gather_agg`` (the Pallas kernel in interpret mode).

``seg_sort`` (``csrc/radix_sort.cu``). One histogram of every pass's
digits, then per ``DIGIT_BITS``-bit pass: each tile of ``TILE`` keys
ranks its keys (warp w a contiguous run of ``32 * ROUNDS`` keys, round
by round, lanes in order); clusters of ``CLUSTER`` tiles (the last one
partial) scan each digit's tile counts across the cluster, and each
cluster publishes its count of each digit as an "aggregate" and looks
back over the earlier clusters' status words, a group of lanes a digit
reading one word a lane a step, until an "inclusive" one, publishing its
own inclusive prefix when its walk ends; cluster 0 publishes the global
histogram's exclusive scan plus its count at once. The emulation runs
the look-back under random interleavings (clusters publish in random
orders and each digit's walk advances on its own), so walks read partial
("aggregate") predecessors; whatever the order, the sort must equal
``seg_sort_ref`` bit for bit, payload included, and the JAX
``radix_sort`` (interpret mode) where sentinels stand only at the tail,
which is the reference's own contract (``ROADMAP.md`` Queue 3,
"Sentinel ranking").
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_cases import SENTINEL, to_t
from repro.kernels.gather_agg.ops import gather_agg as j_gather_agg
from repro.kernels.seg_sort.seg_sort import radix_sort as j_radix_sort
from repro_torch.kernels.gather_agg.gather_agg import (plan_forward,
                                                       vec_width)
from repro_torch.kernels.gather_agg.ref import gather_agg_ref
from repro_torch.kernels.seg_sort.ref import seg_sort_ref
from repro_torch.kernels.seg_sort.seg_sort import (CLUSTER, DIGIT_BITS,
                                                   ROUNDS, THREADS, TILE,
                                                   passes)
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

TOL = dict(rtol=1e-4, atol=1e-5)
#: the H100's multiprocessors
H100_SMS = 132
WARPS = THREADS // 32


# ---------------------------------------------------------------------------
# gather_agg forward: a warp a row (or a column slice), vector columns
# ---------------------------------------------------------------------------

def forward_plan(h, src, mask, nd, fo, vec, splits, chunks, unroll):
    """The forward kernel's plan on numpy float32 -> (out (nd, d), times
    each element was written)."""
    m, d = h.shape
    nvec = d // vec
    hv = h.reshape(m, nvec, vec)
    out = np.zeros((nd, nvec, vec), np.float32)
    writes = np.zeros((nd, nvec), int)
    per = -(-nvec // splits)
    lanes = np.arange(32)[:, None] + 32 * np.arange(chunks)[None, :]
    for i in range(nd):
        e0 = i * fo
        for s in range(splits):
            v0, v1 = s * per, min(s * per + per, nvec)
            for base in range(v0, v1, 32 * chunks):
                cols = base + lanes                    # (lane, chunk)
                live = cols < v1
                safe = np.where(live, cols, 0)
                acc = np.zeros((32, chunks, vec), np.float32)
                cnt = 0
                for j0 in range(0, fo, 32):            # rounds of 32 edges
                    nj = min(fo - j0, 32)
                    bits = np.flatnonzero(mask[e0 + j0:e0 + j0 + nj])
                    cnt += bits.size
                    for g in range(0, bits.size, unroll):
                        rows = [hv[src[e0 + j0 + j]][safe]
                                for j in bits[g:g + unroll]]
                        for row in rows:               # adds in edge order
                            acc = acc + row
                res = acc / np.float32(max(cnt, 1))
                out[i, cols[live]] = res[live]
                np.add.at(writes[i], cols[live], 1)
    return out.reshape(nd, d), writes


FORWARD_CASES = {
    # name: (nd, fanout, m, d)
    "d1_fo1": (9, 1, 12, 1),
    "d3_fo10": (7, 10, 20, 3),
    "d3_fo50": (4, 50, 30, 3),
    "d256_fo10": (10, 10, 40, 256),
    "d256_fo25_nd1": (1, 25, 30, 256),
    "d602_fo25": (6, 25, 30, 602),
    "d602_fo1": (5, 1, 8, 602),
    "d602_fo50_nd1": (1, 50, 60, 602),
    "d130_fo33": (3, 33, 20, 130),
}


def forward_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    nd, fo, m, d = FORWARD_CASES[name]
    h = rng.normal(size=(m, d)).astype(np.float32)
    src = rng.integers(0, m, size=nd * fo).astype(np.int32)
    mask = rng.random(nd * fo) < 0.7
    mask[:fo] = False                       # a fully masked row
    if nd > 2:
        mask[fo:2 * fo] = True              # a full row
    return h, src, mask, nd, fo


def plans(nd, d):
    """(vec, splits, chunks, unroll): the card's plan at every vector
    width d allows, and the same widths with one warp a row and with the
    most warps a row."""
    out = set()
    for vec in (1, 2, 4):
        if d % vec:
            continue
        card = plan_forward(nd, d, vec, H100_SMS)
        out.add((vec,) + card)
        nvec = d // vec
        for splits in (1, max(1, nvec // 32), max(1, -(-nvec // 32))):
            width = -(-nvec // splits)
            for chunks in (1, min(8, -(-width // 32))):
                out.add((vec, splits, chunks, max(1, 16 // chunks)))
    return sorted(out)


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_forward_plan_equals_plain_version_and_jax(name):
    h, src, mask, nd, fo = forward_case(name)
    plain = gather_agg_ref(*to_t(h, src, mask), nd, fo).numpy()
    pallas = np.asarray(j_gather_agg(
        jnp.asarray(h), jnp.asarray(src), jnp.asarray(mask), nd=nd,
        fanout=fo, use_kernel=True, interpret=True))
    np.testing.assert_allclose(plain, pallas, **TOL)
    for vec, splits, chunks, unroll in plans(nd, h.shape[1]):
        got, writes = forward_plan(h, src, mask, nd, fo, vec, splits, chunks,
                                   unroll)
        assert (writes == 1).all(), (vec, splits, chunks)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(got, pallas, **TOL)
    assert not plain[0].any()               # the fully masked row is 0


def test_forward_plan_at_the_path_shapes():
    """The card's plans at the shapes the main paths give the kernel:
    training layer 0 (4,777 rows, d 602: float2, one warp a row, two
    column passes of 5 vectors a lane), training layer 1 (1,000 rows, d
    256: float4, two warps a row), serving layer 0 (2,816 rows) and
    layer 1 (256 rows)."""
    # d 602: a 2,408-byte row stride is only 8-byte aligned
    assert vec_width(602, 0, 0) == 2
    assert vec_width(256, 0, 0) == 4
    assert vec_width(256, 8, 0) == 2       # h starts 8-byte aligned
    assert vec_width(256, 0, 4) == 1       # the output 4-byte aligned
    assert plan_forward(4777, 602, 2, H100_SMS) == (1, 5, 3)
    assert plan_forward(1000, 256, 4, H100_SMS) == (2, 1, 16)
    assert plan_forward(2816, 602, 2, H100_SMS) == (1, 5, 3)
    assert plan_forward(256, 256, 4, H100_SMS) == (2, 1, 16)
    for nd in (1, 5, 300, 5000, 100000):
        for d, vec in ((1, 1), (3, 1), (256, 4), (602, 2), (2304, 4)):
            splits, chunks, unroll = plan_forward(nd, d, vec, H100_SMS)
            nvec = d // vec
            assert 1 <= splits <= max(1, nvec // 32)
            assert 1 <= chunks <= 8 and chunks * unroll <= 16


# ---------------------------------------------------------------------------
# seg_sort: one histogram launch, then one clustered one-sweep launch a pass
# ---------------------------------------------------------------------------

def tile_ranks(u, shift, warps, rounds, bits=DIGIT_BITS):
    """One tile's digits -> (count per digit, each key's slot in the
    tile's sorted order), as the kernel ranks them: warp w owns keys
    [w*32*rounds, (w+1)*32*rounds), round r lanes 0..31; a key's rank is
    the earlier keys of its digit in its warp (a round whose lanes share
    one digit takes ranks in lane order at once, which is the same);
    warps take slots in order within each digit, digits in order."""
    digits = 1 << bits
    d = (u >> shift) & (digits - 1)
    n = d.size
    warp_count = np.zeros((warps, digits), np.int64)
    rank = np.zeros(n, np.int64)
    for w in range(warps):
        for r in range(rounds):
            lo = w * 32 * rounds + r * 32
            lane_d = d[lo:min(lo + 32, n)]
            # the count before this round plus the lanes below with the
            # same digit (the round's shared match word)
            below = np.tril(lane_d[:, None] == lane_d[None, :], -1).sum(1)
            rank[lo:lo + lane_d.size] = warp_count[w, lane_d] + below
            np.add.at(warp_count[w], lane_d, 1)
    first = np.cumsum(warp_count, axis=0) - warp_count   # warp's first slot
    count = warp_count.sum(0)
    tile_off = np.cumsum(count) - count
    warp_of = np.arange(n) // (32 * rounds)
    return count, tile_off[d] + first[warp_of, d] + rank


def look_back(agg, global_excl, lanes, rng, stats):
    """Every cluster's exclusive prefix per digit under one random
    interleaving: clusters publish their counts ("aggregates") in a random
    order (cluster 0: its inclusive prefix, from the global offsets at
    once); each digit of a published cluster is walked by a group of
    `lanes` lanes, lane g reading the (g + 1)-th nearest predecessor, on
    its own (a random subset of the walks takes a step at a time): the
    aggregates before the nearest inclusive word are summed with it and
    end the walk, or, where an unpublished word comes first, the
    aggregates before it are summed and the next step starts from it;
    then the cluster publishes its inclusive prefix."""
    clusters, digits = agg.shape
    flag = np.zeros((clusters, digits), np.int8)   # 0 none, 1 agg, 2 incl
    value = np.zeros((clusters, digits), np.int64)
    ptr = np.tile(np.arange(clusters)[:, None] - 1, (1, digits))
    total = np.zeros((clusters, digits), np.int64)
    done = np.zeros((clusters, digits), bool)
    excl = np.zeros((clusters, digits), np.int64)
    order = list(rng.permutation(clusters))
    published = np.zeros(clusters, bool)
    g = np.arange(lanes)
    while not done.all():
        walking = np.flatnonzero(published & ~done.all(1))
        pick = rng.integers(int(bool(order)) + walking.size)
        if order and pick == 0:                    # a cluster publishes
            c = order.pop()
            published[c] = True
            if c == 0:
                excl[0] = global_excl
                value[0], flag[0] = global_excl + agg[0], 2
                done[0] = True
            else:
                value[c], flag[c] = agg[c], 1
            continue
        c = walking[pick - int(bool(order))]
        for dg in np.flatnonzero(~done[c] & (rng.random(digits) < 0.5)):
            at = ptr[c, dg] - g                    # one word a lane
            f = np.where(at >= 0, flag[np.maximum(at, 0), dg], 2)
            v = np.where(at >= 0, value[np.maximum(at, 0), dg], 0)
            stop = np.flatnonzero(f != 1)
            first = stop[0] if stop.size else lanes
            fin = first < lanes and f[first] == 2
            take = first + 1 if fin else first
            total[c, dg] += v[:take].sum()
            stats["aggregate_reads"] += int((f[:take] == 1).sum())
            if fin:
                excl[c, dg] = total[c, dg]
                value[c, dg], flag[c, dg] = total[c, dg] + agg[c, dg], 2
                done[c, dg] = True
            else:
                ptr[c, dg] -= take
    return excl


def onesweep(keys, payload, num_bits, *, warps=WARPS, rounds=ROUNDS,
             cluster=CLUSTER, bits=DIGIT_BITS, seed=0, stats=None):
    """The clustered one-sweep plan -> (sorted keys, payload or None):
    tiles of warps * 32 * rounds keys, clusters of `cluster` tiles (the
    last one partial, its missing tiles empty), each block's offset within
    its cluster scanned from the cluster's tile counts, the cluster's
    offsets from the look-back over clusters (a digit's group has
    cluster / (digits / THREADS) lanes)."""
    stats = {"aggregate_reads": 0} if stats is None else stats
    rng = np.random.default_rng(seed)
    digits = 1 << bits
    lanes = cluster * THREADS // digits
    tile = warps * 32 * rounds
    n = keys.size
    clamp = 1 << num_bits
    n_pass = -(-min(num_bits + 1, 32) // bits)
    u = np.minimum(keys.astype(np.int64), clamp)
    k, p = keys.copy(), None if payload is None else payload.copy()
    # launch 1: every pass's digit counts, summed over blocks
    hist = [sum(np.bincount((c >> (bits * q)) & (digits - 1),
                            minlength=digits)
                for c in np.array_split(u, 3)) for q in range(n_pass)]
    for q in range(n_pass):
        shift = bits * q
        u = np.minimum(k.astype(np.int64), clamp)
        tiles = -(-n // tile)
        clusters = -(-tiles // cluster)
        ranked = [tile_ranks(u[t * tile:(t + 1) * tile], shift, warps,
                             rounds, bits) for t in range(tiles)]
        counts = np.zeros((clusters * cluster, digits), np.int64)
        for t, (c, _) in enumerate(ranked):
            counts[t] = c
        counts = counts.reshape(clusters, cluster, digits)
        assert (counts.sum((0, 1)) == hist[q]).all()
        below = np.cumsum(counts, axis=1) - counts      # within the cluster
        excl = look_back(counts.sum(1), np.cumsum(hist[q]) - hist[q],
                         lanes, rng, stats)
        dst = np.empty(n, np.int64)
        for t, (count, slot) in enumerate(ranked):
            c, b = divmod(t, cluster)
            d = (u[t * tile:(t + 1) * tile] >> shift) & (digits - 1)
            tile_off = np.cumsum(count) - count
            base = excl[c] + below[c, b]
            dst[t * tile:(t + 1) * tile] = base[d] - tile_off[d] + slot
        assert np.array_equal(np.sort(dst), np.arange(n))
        nk = np.empty_like(k)
        nk[dst] = k
        k = nk
        if p is not None:
            npay = np.empty_like(p)
            npay[dst] = p
            p = npay
    return k, p


#: keys a full cluster of tiles takes (36,864)
SPAN = CLUSTER * TILE

SORT_PLAN_CASES = {
    # name: (n, num_bits, kind, payload); TILE = 4,608 keys, SPAN a cluster
    "one": (1, 3, "random", True),
    "tile_minus_one": (TILE - 1, 20, "tail", True),
    "tile_plus_one": (TILE + 1, 31, "random", False),
    "two_tiles_plus_one": (2 * TILE + 1, 20, "interspersed", True),
    "all_equal": (2 * TILE + 1, 20, "equal", True),
    "num_bits_1": (TILE + 7, 1, "interspersed", True),
    "num_bits_3": (3 * TILE, 3, "random", False),
    "seventeen_tiles": (16 * TILE + 1, 20, "interspersed", True),
    "fewer_tiles_than_a_cluster": (5 * TILE + 3, 20, "random", True),
    "cluster_minus_one": (SPAN - 1, 20, "tail", False),
    "cluster": (SPAN, 20, "interspersed", True),
    "partial_last_cluster": (SPAN + 3 * TILE + 5, 20, "interspersed",
                             False),
    "num_bits_21": (2 * TILE + 9, 21, "interspersed", True),
    "num_bits_22": (2 * TILE + 9, 22, "interspersed", False),
    "num_bits_31": (2 * TILE + 9, 31, "interspersed", True),
}


def sort_plan_case(name, n=None):
    rng = np.random.default_rng(sum(map(ord, name)))
    n0, num_bits, kind, with_payload = SORT_PLAN_CASES[name]
    n = n0 if n is None else n
    if kind == "equal":
        keys = np.full(n, 5 % (1 << num_bits), np.int32)
    else:
        keys = rng.integers(0, 1 << num_bits, size=n).astype(np.int32)
    if kind == "tail":
        keys[-(n // 7 + 1):] = SENTINEL
    if kind == "interspersed":
        keys[rng.random(n) < 0.2] = SENTINEL       # between real keys
    payload = rng.permutation(n).astype(np.int32) if with_payload else None
    return keys, payload, num_bits


@pytest.mark.parametrize("name", sorted(SORT_PLAN_CASES))
def test_onesweep_plan_equals_plain_version(name):
    keys, payload, num_bits = sort_plan_case(name)
    want = seg_sort_ref(torch.from_numpy(keys), None if payload is None
                        else torch.from_numpy(payload))
    stats = {"aggregate_reads": 0}
    for seed in range(3):
        k, p = onesweep(keys, payload, num_bits, seed=seed, stats=stats)
        np.testing.assert_array_equal(k, want[0].numpy())
        if payload is not None:
            np.testing.assert_array_equal(p, want[1].numpy())
    if -(-keys.size // SPAN) > 2:                 # walks past cluster 1
        assert stats["aggregate_reads"] > 0


#: 128-key tiles in clusters of 2: many clusters per input, look-back
#: walks over partial predecessors
SMALL_TILE = dict(warps=2, rounds=2, cluster=2)


@pytest.mark.parametrize("n,num_bits", [(1, 1), (127, 3), (129, 20),
                                        (2000, 20), (1500, 31)])
def test_onesweep_plan_with_small_tiles_equals_jax(n, num_bits):
    """Many clusters, look-back walks over partial predecessors; the
    sentinels stand at the tail, so the JAX radix sort (interpret mode)
    sorts them as the kernel does."""
    rng = np.random.default_rng(n + num_bits)
    keys = rng.integers(0, 1 << num_bits, size=n).astype(np.int32)
    keys[n - n // 9:] = SENTINEL
    payload = rng.permutation(n).astype(np.int32)
    jk, jp = (np.asarray(x) for x in j_radix_sort(
        jnp.asarray(keys), jnp.asarray(payload), num_bits=num_bits,
        interpret=True))
    wk, wp = (x.numpy() for x in seg_sort_ref(*to_t(keys, payload)))
    stats = {"aggregate_reads": 0}
    for seed in range(3):
        k, p = onesweep(keys, payload, num_bits, seed=seed, stats=stats,
                        **SMALL_TILE)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(k, wk)
        np.testing.assert_array_equal(p, wp)
    if n > 4 * 128:
        assert stats["aggregate_reads"] > 0


def test_onesweep_launches_and_ranks_sentinels_last():
    """1 + passes launches a call (4 at the compiler's 20-bit keys); a
    sentinel between real keys sorts after every real key, even after
    2^num_bits - 1, where the JAX kernel would tie it."""
    assert (TILE, THREADS, CLUSTER, DIGIT_BITS) == (4608, 256, 8, 8)
    assert [passes(b) for b in (1, 3, 7, 8, 15, 20, 23, 24, 31)] == \
        [1, 1, 1, 2, 2, 3, 3, 4, 4]
    keys = np.array([SENTINEL, 7, 3, SENTINEL, 7, 0], np.int32)
    pay = np.arange(6, dtype=np.int32)
    k, p = onesweep(keys, pay, 3)
    np.testing.assert_array_equal(k, [0, 3, 7, 7, SENTINEL, SENTINEL])
    np.testing.assert_array_equal(p, [5, 2, 1, 4, 0, 3])
