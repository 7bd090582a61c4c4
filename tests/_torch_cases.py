"""Seeded inputs shared by the port's kernel tests (numpy + torch only,
so the card-only tests can run where JAX is not installed)."""
import zlib

import numpy as np
import torch

SENTINEL = 2 ** 31 - 1


def cache_ids_for(rng, n_hot, lo, hi):
    """Sorted unique ids in [lo, hi), padded to n_hot with the sentinel."""
    k = min(n_hot, hi - lo)
    real = np.sort(rng.choice(np.arange(lo, hi), size=k, replace=False))
    out = np.full(n_hot, SENTINEL, np.int32)
    out[:k] = real
    return out


SEARCH_CASES = {
    # name: (n_hot, m)
    "mixed": (64, 200),
    "empty_cache": (0, 50),
    "m_one": (16, 1),
    "big_cache": (1500, 300),
}


def search_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n_hot, m = SEARCH_CASES[name]
    ids = cache_ids_for(rng, n_hot, 0, 4 * max(n_hot, 1) + 10)
    if n_hot > 4:
        ids[-3:] = SENTINEL                     # padded tail
        ids[:-3] = np.sort(ids[:-3])
    q = rng.integers(0, 4 * max(n_hot, 1) + 20, size=m).astype(np.int32)
    if m > 4:
        q[::5] = -1                             # padding queries
        q[1::7] = SENTINEL                      # sentinel queries
        real = ids[ids != SENTINEL]
        if real.size:
            q[2::3] = rng.choice(real, size=q[2::3].shape[0])   # hits
    return ids, q


ASSEMBLE_CASES = {
    # name: (m, n_hot, d, query kind)
    "mixed": (96, 24, 40, "mixed"),
    "empty_cache": (64, 0, 24, "mixed"),
    "all_hit": (48, 32, 16, "hit"),
    "all_miss": (48, 32, 16, "miss"),
    "all_local": (48, 16, 16, "local"),
    "padded": (64, 20, 16, "padded"),
    "d_not_mult_128": (40, 12, 130, "mixed"),
    "d_602": (24, 8, 602, "mixed"),
    "m_one": (1, 8, 33, "mixed"),
}


def assemble_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    m, n_hot, d, kind = ASSEMBLE_CASES[name]
    n_per, base, n_total = 50, 100, 400
    table = rng.normal(size=(n_per, d)).astype(np.float32)
    remote = np.setdiff1d(np.arange(n_total), np.arange(base, base + n_per))
    cache_ids = np.sort(rng.choice(remote, size=n_hot, replace=False)) \
        .astype(np.int32)
    cache_feats = rng.normal(size=(n_hot, d)).astype(np.float32)
    if kind == "hit":
        q = rng.choice(cache_ids, size=m)
    elif kind == "miss":
        q = rng.choice(np.setdiff1d(remote, cache_ids), size=m)
    elif kind == "local":
        q = rng.integers(base, base + n_per, size=m)
    else:
        q = rng.integers(0, n_total, size=m)
        if n_hot and m > 2:
            q[::3] = rng.choice(cache_ids, size=q[::3].shape[0])
        if kind == "padded":
            q[::4] = -1
            q[1::6] = SENTINEL
    q = q.astype(np.int32)
    pulled = rng.normal(size=(m, d)).astype(np.float32)
    pulled[q == -1] = 0.0
    return table, base, cache_ids, cache_feats, q, pulled


def to_t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


GATHER_CASES = {
    # name: (nd, fanout, m, d)
    "small": (6, 3, 20, 16),
    "d_not_mult_128": (9, 4, 30, 130),
    "d_602": (5, 25, 60, 602),
    "nd_one": (1, 10, 12, 8),
}


def gather_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    nd, fo, m, d = GATHER_CASES[name]
    h = rng.normal(size=(m, d)).astype(np.float32)
    src = rng.integers(0, m, size=nd * fo).astype(np.int32)
    mask = rng.random(nd * fo) < 0.7
    mask[:fo] = False                     # a zero-degree dst row
    return h, src, mask, nd, fo


SORT_CASES = {
    # name: (n, num_bits, kind, payload)
    "empty": (0, 8, "random", True),
    "one": (1, 5, "random", True),
    "sentinel_tail": (300, 12, "tail", True),
    "duplicates_payload": (2048, 4, "random", True),
    "keys_only": (1000, 20, "random", False),
    "all_equal_payload": (700, 9, "equal", True),
    "num_bits_1": (257, 1, "random", True),
    "num_bits_31": (500, 31, "random", True),
    "block_minus_one": (4095, 20, "tail", True),
    "block": (4096, 4, "random", True),
    "block_plus_one": (4097, 31, "random", False),
    "interspersed_sentinel": (3000, 10, "interspersed", True),
    "two_to_21_plus_5": (2 ** 21 + 5, 20, "tail", False),
}

#: cases the JAX interpret-mode radix kernel takes in seconds (n <= 2048,
#: sentinels only in the tail, which is what that kernel sorts right)
SMALL_SORT_CASES = sorted(k for k, (n, _, kind, _) in SORT_CASES.items()
                          if n <= 2048 and kind != "interspersed")


def sort_case(name):
    """-> (keys (n,) int32, payload (n,) int32 or None, num_bits):
    keys below 2^num_bits, with INT32_MAX sentinels in the tail or
    between real keys."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n, num_bits, kind, with_payload = SORT_CASES[name]
    if kind == "equal":
        keys = np.full(n, (1 << num_bits) - 1, np.int32)
    else:
        keys = rng.integers(0, 1 << num_bits, size=n).astype(np.int32)
    if kind == "tail" and n:
        keys[-(n // 7 + 1):] = SENTINEL
    if kind == "interspersed":
        keys[rng.random(n) < 0.3] = SENTINEL
        keys[::11] = (1 << num_bits) - 1         # ties with the clamp
    payload = (rng.permutation(n).astype(np.int32) if with_payload
               else None)
    return keys, payload, num_bits


BWD_CASES = {
    # name: (nd, fanout, m, d, kind)
    "small": (6, 3, 20, 16, "random"),
    "zero_rows": (5, 4, 64, 8, "random"),
    "hub": (200, 10, 300, 32, "hub"),
    "all_masked": (4, 3, 10, 5, "masked"),
    "d_602": (20, 25, 500, 602, "random"),
    "layer1_like": (100, 10, 2000, 256, "hub"),
    # 16,390 edges (the size the one-block order of an earlier design
    # stopped at)
    "above_one_block": (1639, 10, 3000, 8, "hub"),
    # over 100,000 edges, sources crowded at low rows as at training's
    # layer 0 (runs of thousands of edges), at the path's m
    "edges_above_100k": (10_240, 10, 21_093, 3, "skew"),
    # more rows than one block's histogram holds (16,384), and more tiles
    # than an H100 runs clusters at once
    "rows_above_tiles": (500, 4, 300_000, 2, "random"),
}


#: backward cases every row of which some edge reads (m = 1)
BWD_FULL_CASES = {
    "m_one": (4, 3, 1, 8, "random"),
}


def bwd_case(name):
    """-> (g (nd, d), edge_src, edge_mask, m, nd, fanout) for the
    gather_agg backward: zero-count dst rows, rows of h no edge reads,
    repeated sources, and a hub row that half the edges read ("hub") or
    sources crowded at the low rows ("skew")."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    nd, fo, m, d, kind = {**BWD_CASES, **BWD_FULL_CASES}[name]
    g = rng.normal(size=(nd, d)).astype(np.float32)
    src = rng.integers(0, m, size=nd * fo).astype(np.int32)
    mask = rng.random(nd * fo) < 0.7
    mask[:fo] = False                     # a zero-count dst row
    if kind == "hub":
        src[rng.random(nd * fo) < 0.5] = 7
    if kind == "skew":
        src = (m * rng.random(nd * fo) ** 4).astype(np.int32)
    if kind == "masked":
        mask[:] = False
    return g, src, mask, m, nd, fo


FLASH_ATTN_CASES = {
    # name: (B, S, H, kvH, dh, causal, window, softcap, dtype); S is never
    # a multiple of the kernel's 64-row / 64-key tiles except where named
    "odd_s_g1_dh64": (2, 77, 4, 4, 64, True, 0, 0.0, "float32"),
    "s_one": (1, 1, 2, 1, 64, True, 0, 0.0, "float32"),
    "dh48_g3_softcap": (1, 70, 3, 1, 48, True, 0, 50.0, "float32"),
    "g3_dh256_softcap": (1, 129, 6, 2, 256, True, 0, 30.0, "float32"),
    "g1_dh128_window_one": (1, 33, 2, 2, 128, True, 1, 0.0, "float32"),
    "g2_dh128_window_softcap_bf16": (1, 301, 4, 2, 128, True, 50, 50.0,
                                     "bfloat16"),
    "g2_dh256_window_bf16": (1, 200, 8, 4, 256, True, 64, 50.0, "bfloat16"),
    "g3_dh64_noncausal_window_bf16": (2, 65, 3, 1, 64, False, 10, 0.0,
                                      "bfloat16"),
    "g2_dh64_causal_softcap_bf16": (3, 100, 4, 2, 64, True, 0, 50.0,
                                    "bfloat16"),
    "s_128_tile_multiple": (1, 128, 4, 2, 64, True, 0, 0.0, "float32"),
    # bfloat16 (the warpgroup-MMA kernel: 128-row blocks, 64 rows a
    # consumer warpgroup, 128-key tiles (64 at dh 256) by TMA in a
    # two-stage ring, dh zero-filled to 64/128/256)
    "bf16_s1_g8_dh256_softcap": (1, 1, 8, 1, 256, True, 0, 50.0,
                                 "bfloat16"),
    "bf16_s63_dh48_g2_softcap": (2, 63, 4, 2, 48, True, 0, 50.0,
                                 "bfloat16"),
    "bf16_s65_g8_dh128": (1, 65, 8, 1, 128, True, 0, 0.0, "bfloat16"),
    "bf16_s1000_g2_dh256_window_softcap": (1, 1000, 8, 4, 256, True, 300,
                                           50.0, "bfloat16"),
    "bf16_s1000_g8_dh48_causal": (1, 1000, 8, 1, 48, True, 0, 0.0,
                                  "bfloat16"),
    "bf16_window_ge_s_g6_dh64": (1, 200, 6, 1, 64, True, 256, 30.0,
                                 "bfloat16"),
    "bf16_noncausal_window_g2_dh256": (1, 150, 4, 2, 256, False, 40, 50.0,
                                       "bfloat16"),
    "bf16_noncausal_g3_dh48": (2, 90, 3, 1, 48, False, 0, 0.0, "bfloat16"),
    # 16 q heads a kv head: recurrentgemma-9b's MQA local layers
    "bf16_g16_dh256_window": (1, 300, 16, 1, 256, True, 64, 0.0,
                              "bfloat16"),
    "g16_dh64_causal": (1, 90, 16, 1, 64, True, 0, 0.0, "float32"),
}


#: attention without a mask: k/v of their own length Skv (the enc-dec
#: model's cross-attention: Skv 1, 17 and the ragged 4001), and at Skv ==
#: Sq (its encoder's non-causal self-attention)
CROSS_ATTN_CASES = {
    # name: (B, Sq, Skv, H, kvH, dh, dtype)
    "bf16_g1_dh64_skv4001": (1, 300, 4001, 4, 4, 64, "bfloat16"),
    "bf16_g1_dh64_skv1": (2, 70, 1, 2, 2, 64, "bfloat16"),
    "bf16_g8_dh128_skv17": (2, 129, 17, 16, 2, 128, "bfloat16"),
    "bf16_g8_dh128_skv4001": (1, 65, 4001, 8, 1, 128, "bfloat16"),
    "f32_g1_dh64_skv17": (2, 77, 17, 4, 4, 64, "float32"),
    "f32_g1_dh128_skv1": (1, 33, 1, 2, 2, 128, "float32"),
    "f32_g8_dh64_skv4001": (1, 40, 4001, 16, 2, 64, "float32"),
    "f32_g8_dh128_skv17": (1, 100, 17, 8, 1, 128, "float32"),
    "bf16_self_g1_dh64": (2, 333, 333, 4, 4, 64, "bfloat16"),
    "bf16_self_g8_dh128": (1, 200, 200, 16, 2, 128, "bfloat16"),
    "f32_self_g1_dh64": (1, 130, 130, 2, 2, 64, "float32"),
}


def cross_attn_case(name):
    """-> (q (B,Sq,H,dh), k, v (B,Skv,kvH,dh)) float32 numpy and the
    dtype name of the case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B, Sq, Skv, H, kvH, dh, dtype = CROSS_ATTN_CASES[name]
    q = rng.normal(size=(B, Sq, H, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, Skv, kvH, dh)).astype(np.float32)
            for _ in range(2))
    return q, k, v, dtype


def flash_attn_case(name):
    """-> (q (B,S,H,dh), k, v (B,S,kvH,dh)) float32 numpy, and the
    kwargs and dtype name of the case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B, S, H, kvH, dh, causal, window, cap, dtype = FLASH_ATTN_CASES[name]
    q, k, v = (rng.normal(size=(B, S, n, dh)).astype(np.float32)
               for n in (H, kvH, kvH))
    return q, k, v, dict(causal=causal, window=window, softcap=cap), dtype


FLASH_DECODE_CASES = {
    # name: (B, H, kvH, dh, S, lengths, starts, softcap, dtype); lengths
    # and starts at 0, 1 and S
    "len_0_1_S_g2_dh256_bf16": (3, 8, 4, 256, 1001, (0, 1, 1001), (0, 0, 0),
                                50.0, "bfloat16"),
    "start_0_1_S_g3_dh64": (3, 6, 2, 64, 777, (777, 777, 777), (0, 1, 777),
                            0.0, "float32"),
    "g1_dh128_window": (2, 4, 4, 128, 4099, (4099, 3000), (3, 2000), 30.0,
                        "float32"),
    "g2_dh64_long_split_bf16": (2, 4, 2, 64, 20001, (20001, 12345), (0, 100),
                                50.0, "bfloat16"),
    "s_one_g8": (1, 8, 1, 128, 1, (1,), (0,), 0.0, "float32"),
    "dh48_g3": (2, 3, 1, 48, 33, (33, 17), (5, 17), 0.0, "float32"),
    # 16 q heads a kv head: recurrentgemma-9b's MQA (G = 16, dh 256)
    "g16_mqa_dh256_bf16": (2, 16, 1, 256, 48, (48, 17), (0, 3), 0.0,
                           "bfloat16"),
    "g16_dh64_window_softcap": (3, 32, 2, 64, 300, (300, 0, 150),
                                (40, 0, 150), 30.0, "float32"),
    # the enc-dec model's cross caches: MHA (G = 1), dh 64, a length of
    # its own a sequence, 0 among them
    "g1_dh64_cross_ragged_bf16": (4, 16, 16, 64, 1001, (1001, 904, 0, 1),
                                  (0, 0, 0, 0), 0.0, "bfloat16"),
    # the tensor-core kernel's served groups: qwen3-moe's and qwen2-vl's
    # G = 8 at dh 128 (ragged, starts past 0), recurrentgemma-9b's G = 16
    # at dh 256 over a window (start = length - 512), softcap 30; and a
    # head width 16 does not divide (zero-padded to the MMA's k)
    "g8_dh128_ragged_start_bf16": (3, 16, 2, 128, 4099, (4099, 2500, 1001),
                                   (0, 700, 1000), 0.0, "bfloat16"),
    "g16_dh256_window_softcap_bf16": (2, 16, 1, 256, 1500, (1500, 1100),
                                      (988, 588), 30.0, "bfloat16"),
    "g4_dh72_bf16": (2, 8, 2, 72, 300, (300, 77), (0, 3), 30.0,
                     "bfloat16"),
}


def flash_decode_case(name):
    """-> (q (B,H,dh), k, v (B,S,kvH,dh)) float32 numpy, length/start (B,)
    int32, softcap and dtype name."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B, H, kvH, dh, S, lens, starts, cap, dtype = FLASH_DECODE_CASES[name]
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, kvH, dh)).astype(np.float32)
            for _ in range(2))
    return (q, k, v, np.array(lens, np.int32), np.array(starts, np.int32),
            cap, dtype)


MERGE_CASES = {
    # name: (m, n_hot, d, cache dtype, base dtype, query kind)
    "mixed_d130": (40, 12, 130, "float32", "float32", "mixed"),
    "d_one": (33, 5, 1, "float32", "float32", "mixed"),
    "d_602": (21, 9, 602, "float32", "float32", "mixed"),
    "d_2304": (6, 4, 2304, "float32", "float32", "mixed"),
    "empty_cache": (17, 0, 24, "float32", "float32", "mixed"),
    "all_hit": (30, 16, 40, "float32", "float32", "hit"),
    "no_hit": (30, 16, 40, "float32", "float32", "miss"),
    "padded": (48, 20, 16, "float32", "float32", "padded"),
    "m_one": (1, 8, 33, "float32", "float32", "mixed"),
    "bf16": (25, 10, 130, "bfloat16", "bfloat16", "mixed"),
    "f32_cache_bf16_base": (25, 10, 67, "float32", "bfloat16", "mixed"),
    "bf16_cache_f32_base": (25, 10, 67, "bfloat16", "float32", "mixed"),
}


def merge_case(name):
    """-> (cache_ids (n_hot,) int32 sorted, cache_feats (n_hot, d), query
    (m,) int32, base (m, d)) as float32 numpy arrays plus the two dtype
    names: hits, misses, -1 padding and INT32_MAX sentinel queries."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    m, n_hot, d, cdt, bdt, kind = MERGE_CASES[name]
    ids = np.sort(rng.choice(np.arange(500), size=n_hot, replace=False)) \
        .astype(np.int32)
    feats = rng.normal(size=(n_hot, d)).astype(np.float32)
    if kind == "hit":
        q = rng.choice(ids, size=m)
    elif kind == "miss":
        q = rng.choice(np.setdiff1d(np.arange(520), ids), size=m)
    else:
        q = rng.integers(0, 520, size=m)
        if n_hot and m > 2:
            q[::3] = rng.choice(ids, size=q[::3].shape[0])
        if kind == "padded":
            q[::4] = -1
            q[1::6] = SENTINEL
    base = rng.normal(size=(m, d)).astype(np.float32)
    return ids, feats, q.astype(np.int32), base, cdt, bdt


def as_dtype(a, dtype_name):
    """float32 numpy -> torch tensor of the named dtype (bf16 rounds to
    nearest even, as JAX's astype does)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        getattr(torch, dtype_name))


#: hot-set sizes of the rank plans: the sentinel alone, one line and its
#: edges, a 32-ary level's edges, the serving cache, the paper grid's
#: largest (spec.py) and one beyond a one-line splitter table (65,536)
PLAN_N_HOTS = (1, 31, 32, 33, 1023, 1024, 1025, 4096, 32768, 70000)
PLAN_KINDS = ("mixed", "all_hit", "all_miss")


def plan_case(n_hot, kind, m=256):
    """-> (cache_ids (n_hot,) sorted int32, query (m,) int32). n_hot 1 is
    the one INT32_MAX sentinel row of an empty cache; above 32 the ids end
    in a padded INT32_MAX tail. ``mixed`` queries hold -1 padding,
    INT32_MAX, hits (the smallest and largest id among them), misses, and
    ids below the smallest and above the largest; ``all_hit`` draws from
    the real ids (none for the sentinel cache), ``all_miss`` from the
    gaps."""
    rng = np.random.default_rng(zlib.crc32(f"{n_hot}-{kind}".encode()))
    pad = 3 if n_hot > 32 else 0
    lo, hi = 100, 100 + 4 * n_hot + 10
    if n_hot == 1:
        real = np.zeros(0, np.int32)
    else:
        real = np.sort(rng.choice(np.arange(lo, hi), size=n_hot - pad,
                                  replace=False)).astype(np.int32)
    ids = np.full(n_hot, SENTINEL, np.int32)
    ids[:real.size] = real
    gaps = np.setdiff1d(np.arange(0, hi + 100), real)
    if kind == "all_hit" and real.size:
        q = rng.choice(real, size=m)
    elif kind == "all_miss":
        q = rng.choice(gaps, size=m)
    else:
        q = rng.integers(0, hi + 100, size=m)
        if real.size:
            q[2::3] = rng.choice(real, size=q[2::3].shape[0])
            q[5], q[6] = real[0], real[-1]
        q[::5] = -1
        q[1::7] = SENTINEL
        q[3::11] = rng.integers(0, lo, size=q[3::11].shape[0])
        q[4::13] = rng.integers(hi, hi + 100, size=q[4::13].shape[0])
    return ids, q.astype(np.int32)


def plan_assemble_case(n_hot, kind, m=96, d=5):
    """-> (table, base, cache_ids, cache_feats, query, pulled): the rank
    plan's cache and queries, with a shard of 40 rows just above the ids
    and some of its ids among the queries (local rows win)."""
    ids, q = plan_case(n_hot, kind, m)
    rng = np.random.default_rng(zlib.crc32(f"asm-{n_hot}-{kind}".encode()))
    n_per, base = 40, 100 + 4 * n_hot + 10
    q[7::9] = rng.integers(base, base + n_per, size=q[7::9].shape[0])
    table = rng.normal(size=(n_per, d)).astype(np.float32)
    feats = rng.normal(size=(n_hot, d)).astype(np.float32)
    pulled = rng.normal(size=(m, d)).astype(np.float32)
    return table, base, ids, feats, q, pulled
