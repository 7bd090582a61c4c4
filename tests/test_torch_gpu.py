"""Card-only tests of the port: each CUDA kernel against its plain
PyTorch version on the same inputs, the serving slice on ``cuda``
against its own oracle and the CPU path, the training slice (the
device-compiled schedule, the train step) against the CPU path, and the
transformer decode-serving slice (prefill and decode) against the CPU
path, the device-distributed epoch (the ``merge_gather`` kernel,
``cache_gather``, a staged epoch) and the multi-epoch runner (flat and
``2x2``, and a checkpointed resume) against the CPU path. They import
no JAX, so they run on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips (the fixture decides, at run
time, so every pytest worker collects the same tests).
"""
import numpy as np
import pytest
import torch

from _torch_cases import (ASSEMBLE_CASES, BWD_CASES, BWD_FULL_CASES,
                          FLASH_ATTN_CASES,
                          FLASH_DECODE_CASES, GATHER_CASES, MERGE_CASES,
                          SEARCH_CASES, SORT_CASES, as_dtype, assemble_case,
                          bwd_case, flash_attn_case, flash_decode_case,
                          gather_case, merge_case, search_case, sort_case,
                          to_t)
from repro_torch.kernels.assemble import ops as t_assemble_ops
from repro_torch.kernels.assemble.ops import assemble_features as t_assemble
from repro_torch.kernels.cache_lookup import ops as t_search_ops
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_decode import ops as t_fd_ops
from repro_torch.kernels.flash_decode.ref import (combine,
                                                  flash_decode_batched_ref,
                                                  finalize)
from repro_torch.kernels.gather_agg import ops as t_gather_ops
from repro_torch.kernels.gather_agg.ref import gather_agg_ref as t_gather_ref
from repro_torch.kernels.seg_sort import ops as t_sort_ops


def device_kernels(torch_fn):
    """The number of operations the card runs (kernels, memsets and
    copies) a ``torch_fn()`` call: one call captured in a CUDA graph, its
    nodes counted with libcuda's ``cuGraphGetNodes``."""
    import ctypes
    torch_fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        torch_fn()
    torch.cuda.synchronize()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    ops = 0
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        ops += kind.value in (0, 1, 2)        # kernel, memcpy, memset
    return ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SEARCH_CASES))
def test_search_kernel_equals_plain_on_card(cuda, name):
    ids, q = search_case(name)
    args = [t.to(cuda) for t in to_t(ids, q)]
    before = t_search_ops.LAUNCHES.value
    pos, hit = t_search_ops.search(*args)
    want_pos, want_hit = t_search_ops.search(*args, interpret=True)
    torch.cuda.synchronize()
    assert torch.equal(pos, want_pos) and torch.equal(hit, want_hit)
    assert t_search_ops.LAUNCHES.value == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ASSEMBLE_CASES))
def test_assemble_kernel_equals_plain_on_card(cuda, name):
    table, base, ids, feats, q, pulled = assemble_case(name)
    tt, ti, tf, tq, tp = [t.to(cuda) for t in to_t(table, ids, feats, q,
                                                  pulled)]
    before = t_assemble_ops.LAUNCHES.value
    got = t_assemble(tt, base, ti, tf, tq, tp, backend="fused")
    want = t_assemble(tt, base, ti, tf, tq, tp, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert t_assemble_ops.LAUNCHES.value == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GATHER_CASES))
def test_gather_agg_kernel_equals_plain_on_card(cuda, name):
    h, src, mask, nd, fo = gather_case(name)
    th, ts, tm = [t.to(cuda) for t in to_t(h, src, mask)]
    before = t_gather_ops.LAUNCHES.value
    got = t_gather_ops.gather_agg(th, ts, tm, nd=nd, fanout=fo)
    want = t_gather_ref(th, ts, tm, nd, fo)
    torch.cuda.synchronize()
    # same order of sums, IEEE division on both: exact
    assert torch.equal(got, want)
    assert t_gather_ops.LAUNCHES.value == before + 1


GATHER_PLAN_CASES = {
    # name: (nd, fanout, m, d, floats h starts past an aligned address):
    # each vector width, a row's columns split over warps (few rows) or not
    # (many), fan-outs above 32 (loaded in rounds), one dst row
    "d256_float4_split": (1000, 10, 3000, 256, 0),
    "d256_float2": (1000, 10, 3000, 256, 2),
    "d256_float": (1000, 10, 3000, 256, 1),
    "d256_many_rows": (6000, 10, 3000, 256, 0),
    "d602_training_layer0": (4777, 25, 21093, 602, 0),
    "d602_float_nd1": (1, 25, 30, 602, 1),
    "d3_fo50": (7, 50, 40, 3, 0),
    "d130_fo33": (2, 33, 10, 130, 0),
    "d1_fo1": (5, 1, 5, 1, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GATHER_PLAN_CASES))
def test_gather_agg_plan_edges_on_card(cuda, name):
    """The forward's plan at its edges: bit-equal to the plain version and
    to a second run, one card operation a call."""
    from repro_torch.kernels.gather_agg.gather_agg import vec_width
    nd, fo, m, d, off = GATHER_PLAN_CASES[name]
    rng = np.random.default_rng(len(name) + nd)
    flat = torch.empty(m * d + off, device=cuda)
    flat[off:] = torch.from_numpy(rng.normal(size=m * d).astype(np.float32))
    th = flat[off:].view(m, d)
    ts = torch.from_numpy(rng.integers(0, m, size=nd * fo).astype(np.int32))
    mask = rng.random(nd * fo) < 0.7
    mask[:fo] = False                       # a fully masked row
    ts, tm = ts.to(cuda), torch.from_numpy(mask).to(cuda)
    want_vec = 4 if d % 4 == 0 and off % 4 == 0 else \
        2 if d % 2 == 0 and off % 2 == 0 else 1
    assert vec_width(d, th.data_ptr(), 0) == want_vec
    before = t_gather_ops.LAUNCHES.value
    got = t_gather_ops.gather_agg(th, ts, tm, nd=nd, fanout=fo)
    again = t_gather_ops.gather_agg(th, ts, tm, nd=nd, fanout=fo)
    want = t_gather_ref(th, ts, tm, nd, fo)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)
    assert t_gather_ops.LAUNCHES.value == before + 2
    assert device_kernels(lambda: t_gather_ops.gather_agg(
        th, ts, tm, nd=nd, fanout=fo)) == 1


@pytest.mark.gpu
def test_service_on_card_matches_oracle_and_cpu(cuda):
    """The serving slice on ``cuda`` at a small size: uncached then fresh
    responses bit-equal to the card's own oracle and within the
    reference's cross-program tolerance of the CPU path, with every
    kernel launched while serving."""
    from repro_torch.graph import KHopSampler, load_dataset, partition_graph
    from repro_torch.graph.sampler import rng_from
    from repro_torch.models.gnn import GNNConfig, init_params
    from repro_torch.serve.gnn import GNNInferenceService

    g = load_dataset("tiny", seed=0)
    pg = partition_graph(g, 4, "greedy")
    sampler = KHopSampler(g, fanouts=[3, 3], batch_size=4)
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=16,
                    num_classes=g.num_classes, num_layers=2, fanouts=(3, 3),
                    agg_backend="kernel")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    counters = (t_search_ops.LAUNCHES, t_assemble_ops.LAUNCHES,
                t_gather_ops.LAUNCHES)
    before = [c.value for c in counters]
    rng = rng_from(4, 0x7E57)
    streams = [rng.integers(0, g.num_nodes, size=4) for _ in range(8)]
    svc = GNNInferenceService(pg, sampler, cfg, params, s0=7, n_hot=32,
                              default_timeout_s=30.0, device=cuda)
    ref = GNNInferenceService(pg, sampler, cfg, params, s0=7, n_hot=32,
                              device="cpu")
    try:
        for lo, hi in ((0, 4), (4, 8)):
            if lo:
                assert svc.warmer.warm_now()
            pendings = [svc.submit(s) for s in streams[lo:hi]]
            assert svc.step(timeout=1.0) == hi - lo
            for p, s in zip(pendings, streams[lo:hi]):
                r = p.result(timeout=5.0)
                np.testing.assert_array_equal(r.logits, svc.oracle(s, r.rid))
                np.testing.assert_allclose(r.logits, ref.oracle(s, r.rid),
                                           rtol=1e-4, atol=1e-5)
    finally:
        svc.close()
        ref.close()
    assert svc.health()["served_uncached"] == 4
    assert svc.health()["served_fresh"] == 4
    assert all(c.value > b for c, b in zip(counters, before))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SORT_CASES))
def test_seg_sort_kernel_equals_plain_on_card(cuda, name):
    keys, payload, num_bits = sort_case(name)
    tk = to_t(keys)[0].to(cuda)
    tp = None if payload is None else to_t(payload)[0].to(cuda)
    before = t_sort_ops.LAUNCHES.value
    sk, sp = t_sort_ops.seg_sort(tk, tp, num_bits=num_bits)
    wk, wp = t_sort_ops.seg_sort(tk, tp, num_bits=num_bits, interpret=True)
    torch.cuda.synchronize()
    assert torch.equal(sk, wk)
    assert (sp is None and wp is None) or torch.equal(sp, wp)
    assert t_sort_ops.LAUNCHES.value == before + (1 if keys.size else 0)


SORT_TILE_CASES = {
    # name: (n, num_bits, payload); a tile is 4,096 keys
    "tile_minus_one": (4095, 20, True),
    "tile": (4096, 20, False),
    "tile_plus_one": (4097, 20, True),
    "two_tiles_plus_one_bits_31": (8193, 31, True),
    "many_tiles_bits_3": (3 * 4096 + 5, 3, True),
    "bits_1": (5000, 1, False),
    "all_equal": (10000, 20, True),
    "two_to_20_plus_3": (2 ** 20 + 3, 20, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SORT_TILE_CASES))
def test_seg_sort_tiles_on_card(cuda, name):
    """Across tile boundaries, with sentinels between real keys: bit-equal
    to the plain version and to a second run, payload included, in at
    most 1 + passes card operations a call."""
    from repro_torch.kernels.seg_sort.seg_sort import passes
    n, num_bits, with_payload = SORT_TILE_CASES[name]
    rng = np.random.default_rng(n + num_bits)
    keys = rng.integers(0, 1 << num_bits, size=n).astype(np.int32)
    if name == "all_equal":
        keys[:] = 3
    keys[rng.random(n) < 0.3] = 2 ** 31 - 1
    tk = torch.from_numpy(keys).to(cuda)
    tp = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda) \
        if with_payload else None
    sk, sp = t_sort_ops.seg_sort(tk, tp, num_bits=num_bits)
    ak, ap = t_sort_ops.seg_sort(tk, tp, num_bits=num_bits)
    wk, wp = t_sort_ops.seg_sort(tk, tp, num_bits=num_bits, interpret=True)
    torch.cuda.synchronize()
    assert torch.equal(sk, wk) and torch.equal(sk, ak)
    assert (sp is None and wp is None) or (torch.equal(sp, wp)
                                           and torch.equal(sp, ap))
    n_ops = device_kernels(lambda: t_sort_ops.seg_sort(
        tk, tp, num_bits=num_bits))
    assert n_ops <= 1 + passes(num_bits), n_ops


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted({**BWD_CASES, **BWD_FULL_CASES}))
def test_gather_agg_bwd_kernel_equals_plain_on_card(cuda, name):
    g, src, mask, m, nd, fo = bwd_case(name)
    tg, ts, tm = [t.to(cuda) for t in to_t(g, src, mask)]
    before = t_gather_ops.BWD_LAUNCHES.value
    got = t_gather_ops.gather_agg_bwd(tg, ts, tm, m=m, nd=nd, fanout=fo)
    # the plain version on the CPU sums each row in edge order from +0,
    # as the kernel does (on the card its index_add_ sums in atomic
    # order): the same float32 quotients added in the same order
    want = t_gather_ops.gather_agg_bwd(*to_t(g, src, mask), m=m, nd=nd,
                                       fanout=fo)
    again = t_gather_ops.gather_agg_bwd(tg, ts, tm, m=m, nd=nd, fanout=fo)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)     # bit for bit
    assert torch.equal(got, again)          # deterministic: no atomics
    assert t_gather_ops.BWD_LAUNCHES.value == before + 2
    if name == "layer1_like":
        n = device_kernels(lambda: t_gather_ops.gather_agg_bwd(
            tg, ts, tm, m=m, nd=nd, fanout=fo))
        assert 1 <= n <= 3, n


@pytest.mark.gpu
def test_gather_agg_backward_through_autograd_on_card(cuda):
    """The autograd Function launches the backward kernel for an ``h``
    that needs a gradient, twice to the same bits, and never for one
    that needs none."""
    g, src, mask, m, nd, fo = bwd_case("layer1_like")
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(m, g.shape[1])).astype(np.float32))
    ts, tm, tg = [t.to(cuda) for t in to_t(src, mask, g)]
    grads = []
    for _ in range(2):
        th = h.to(cuda).requires_grad_(True)
        (t_gather_ops.gather_agg(th, ts, tm, nd=nd, fanout=fo) * tg).sum() \
            .backward()
        grads.append(th.grad)
    cpu = h.clone().requires_grad_(True)
    (t_gather_ops.gather_agg(cpu, *to_t(src, mask), nd=nd, fanout=fo)
     * torch.from_numpy(g)).sum().backward()
    before = t_gather_ops.BWD_LAUNCHES.value
    t_gather_ops.gather_agg(h.to(cuda), ts, tm, nd=nd, fanout=fo).sum()
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0].cpu(), cpu.grad, rtol=1e-5,
                               atol=1e-5)
    assert t_gather_ops.BWD_LAUNCHES.value == before


@pytest.mark.gpu
def test_training_slice_on_card_matches_cpu(cuda):
    """The schedule compiled on the card equals the numpy compiler's,
    and three train steps on the card follow the CPU steps."""
    from repro_torch.core import build_schedule, collate
    from repro_torch.graph import KHopSampler, load_dataset, partition_graph
    from repro_torch.models.gnn import (GNNConfig, batch_to_device,
                                        init_params, make_train_step)
    from repro_torch.train import AdamW

    g = load_dataset("tiny", seed=0)
    pg = partition_graph(g, 4, "greedy")
    sampler = KHopSampler(g, fanouts=[5, 5], batch_size=32)
    kw = dict(worker=0, s0=3, num_epochs=2, n_hot=64)
    before = t_sort_ops.LAUNCHES.value
    dev = build_schedule(sampler, pg, compiler="device", device=cuda, **kw)
    ref = build_schedule(sampler, pg, compiler="batched", **kw)
    assert t_sort_ops.LAUNCHES.value > before
    for e in range(2):
        a, b = ref.epoch(e), dev.epoch(e)
        for f in ("remote_ids", "remote_freq", "cache_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for x, y in zip(a.flat.edge_src + [a.flat.input_nodes],
                        b.flat.edge_src + [b.flat.input_nodes]):
            np.testing.assert_array_equal(x, y)
    assert ref.pad_bounds() == dev.pad_bounds()

    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=16,
                    num_classes=g.num_classes, num_layers=2, fanouts=(5, 5),
                    agg_backend="kernel")
    m_max, edge_max = ref.pad_bounds()
    losses = {}
    for device in (cuda, torch.device("cpu")):
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
        opt = AdamW(lr=3e-3)
        state, step = opt.init(params), make_train_step(cfg, opt)
        losses[device.type] = []
        for b in ref.epoch(0).batches[:3]:
            cb = collate(b, g.labels, 32, m_max, edge_max)
            feats = np.zeros((m_max, g.feat_dim), np.float32)
            feats[cb.input_mask] = g.features[cb.input_nodes[cb.input_mask]]
            params, state, aux = step(params, state,
                                      batch_to_device(cb, feats, device))
            losses[device.type].append(float(aux["loss"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4,
                               atol=1e-5)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    """float32: the reference's tolerance. bfloat16 outputs: both sides
    round a float32 value (summed in another order) once to bfloat16, so
    they may be one bfloat16 step apart, at most 2^-7 of the value."""
    return (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
            else dict(rtol=2 ** -7, atol=1e-5))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FLASH_ATTN_CASES))
def test_flash_attention_kernel_equals_plain_on_card(cuda, name):
    q, k, v, kw, dtype = flash_attn_case(name)
    tq, tk, tv = [t.to(cuda, _DTYPES[dtype]) for t in to_t(q, k, v)]
    before = t_fa_ops.LAUNCHES.value
    got = t_fa_ops.flash_attention(tq, tk, tv, **kw)
    want = flash_attention_ref(tq, tk, tv, **kw)
    torch.cuda.synchronize()
    assert got.dtype == tq.dtype and got.shape == tq.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert t_fa_ops.LAUNCHES.value == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FLASH_DECODE_CASES))
def test_flash_decode_kernel_equals_plain_on_card(cuda, name):
    q, k, v, length, start, cap, dtype = flash_decode_case(name)
    tq, tk, tv = [t.to(cuda, _DTYPES[dtype]) for t in to_t(q, k, v)]
    tl, ts = [t.to(cuda) for t in to_t(length, start)]
    before = t_fd_ops.LAUNCHES.value
    got = t_fd_ops.flash_decode_batched(tq, tk, tv, tl, ts, softcap=cap)
    acc, m, l = flash_decode_batched_ref(tq, tk, tv, tl, ts, softcap=cap)
    # the partials of each element, one launch each
    parts = [t_fd_ops.flash_decode(tq[b], tk[b], tv[b], tl[b], ts[b],
                                   softcap=cap) for b in range(q.shape[0])]
    torch.cuda.synchronize()
    tol = dict(rtol=1e-4, atol=1e-5)          # float32 outputs
    torch.testing.assert_close(got, finalize(acc, l), **tol)
    for b, (pa, pm, pl) in enumerate(parts):
        torch.testing.assert_close(pa, acc[b], **tol)
        torch.testing.assert_close(pm, m[b], **tol)
        torch.testing.assert_close(pl, l[b], **tol)
    empty = torch.from_numpy(np.minimum(length, k.shape[1]) <= start)
    assert bool((got[empty.to(cuda)] == 0).all())
    assert bool((m[empty.to(cuda)] == -1e30).all())
    assert t_fd_ops.LAUNCHES.value == before + 1 + q.shape[0]


@pytest.mark.gpu
def test_flash_decode_combine_over_shards_on_card(cuda):
    q, k, v, length, start, cap, _ = flash_decode_case("g1_dh128_window")
    tq, tk, tv = [t.to(cuda) for t in to_t(q[0], k[0], v[0])]
    ln, st = int(length[0]), int(start[0])

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=cuda)
    full = t_fd_ops.flash_decode(tq, tk, tv, i32(ln), i32(st), softcap=cap)
    S, step = tk.shape[0], 1000
    parts = []
    for lo in range(0, S, step):
        hi = min(S, lo + step)
        parts.append(t_fd_ops.flash_decode(
            tq, tk[lo:hi].contiguous(), tv[lo:hi].contiguous(),
            i32(np.clip(ln - lo, 0, hi - lo)), i32(max(st - lo, 0)),
            softcap=cap))
    acc, m, l = combine(parts)
    torch.cuda.synchronize()
    torch.testing.assert_close(m, full[1], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(finalize(acc, l), finalize(full[0], full[2]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_flash_decode_at_the_decode_loop_shape_on_card(cuda):
    """gemma2-2b's decode loop: B=8, 8 q heads over 4 kv heads, dh 256, a
    48-slot bfloat16 cache filled to lengths 16..47, softcap 50: one
    launch and one kernel on the card a call, within the reference's
    tolerance of the plain version (float32 outputs)."""
    gen = torch.Generator().manual_seed(48)
    B, H, kvH, dh, S = 8, 8, 4, 256, 48
    for lens in torch.arange(16, 48, dtype=torch.int32).reshape(4, B):
        q = torch.randn((B, H, dh), generator=gen).to(cuda, torch.bfloat16)
        k, v = (torch.randn((B, S, kvH, dh), generator=gen)
                .to(cuda, torch.bfloat16) for _ in range(2))
        ln, st = lens.to(cuda), torch.zeros(B, dtype=torch.int32,
                                            device=cuda)
        before = t_fd_ops.LAUNCHES.value
        got = t_fd_ops.flash_decode_batched(q, k, v, ln, st, softcap=50.0)
        acc, m, l = flash_decode_batched_ref(q, k, v, ln, st, softcap=50.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, finalize(acc, l), rtol=1e-4,
                                   atol=1e-5)
        assert t_fd_ops.LAUNCHES.value == before + 1
        assert device_kernels(lambda: t_fd_ops.flash_decode_batched(
            q, k, v, ln, st, softcap=50.0)) == 1


@pytest.mark.gpu
def test_flash_decode_ragged_long_cache_on_card(cuda):
    """A long cache with ragged lengths and starts (0, 1, S, a window,
    start == length), split over the card: one kernel a call, the same
    bits on a second run whichever block combines, and within the
    reference's tolerance of the plain version."""
    gen = torch.Generator().manual_seed(7)
    B, H, kvH, dh, S = 8, 4, 2, 128, 16384
    q = torch.randn((B, H, dh), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((B, S, kvH, dh), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    ln = torch.tensor([S, 1, 0, 1000, S // 2, S, 3, S - 1],
                      dtype=torch.int32, device=cuda)
    st = torch.tensor([0, 0, 0, 999, S // 2 - 4096, S - 4096, 3, 1],
                      dtype=torch.int32, device=cuda)
    got = t_fd_ops.flash_decode_batched(q, k, v, ln, st, softcap=50.0)
    again = t_fd_ops.flash_decode_batched(q, k, v, ln, st, softcap=50.0)
    parts = t_fd_ops.flash_decode(q[0], k[0], v[0], ln[0], st[0],
                                  softcap=50.0)
    parts2 = t_fd_ops.flash_decode(q[0], k[0], v[0], ln[0], st[0],
                                   softcap=50.0)
    acc, m, l = flash_decode_batched_ref(q, k, v, ln, st, softcap=50.0)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert all(torch.equal(a, b) for a, b in zip(parts, parts2))
    torch.testing.assert_close(got, finalize(acc, l), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(parts[1], m[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(parts[2], l[0], rtol=1e-4, atol=1e-5)
    assert bool((got[2] == 0).all()) and bool((got[6] == 0).all())
    assert device_kernels(lambda: t_fd_ops.flash_decode_batched(
        q, k, v, ln, st, softcap=50.0)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 16, 100])
def test_noncausal_windowed_attention_on_card_equals_cpu(cuda, window):
    """``attention(causal=False, window>0)``: a window is always causal,
    on the card as in the reference's ``_banded`` and the CPU path."""
    from repro_torch.models.transformer.attention import attention
    gen = torch.Generator().manual_seed(window)
    q = torch.randn((2, 70, 4, 64), generator=gen)
    k, v = (torch.randn((2, 70, 2, 64), generator=gen) for _ in range(2))
    kw = dict(causal=False, window=window, attn_softcap=50.0)
    got = attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    want = attention(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, **_tol("float32"))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-2b", "smollm-360m"])
def test_transformer_slice_on_card_matches_cpu(cuda, arch):
    """Reduced configs in float32: ``forward`` at an odd S past the
    gemma2 window (one ``flash_attention`` launch a layer) and the
    ``serve_step`` loop with the local ring wrapping (one
    ``flash_decode`` launch a layer a step) against the CPU path."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import (forward, init_decode_state,
                                                init_params, serve_step)

    cfg = get_reduced(arch)
    cpu = torch.device("cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    dev_params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    B, S = 2, 37
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    with torch.inference_mode():
        fa0, fd0 = t_fa_ops.LAUNCHES.value, t_fd_ops.LAUNCHES.value
        got = forward(cfg, dev_params, toks.to(cuda))
        assert t_fa_ops.LAUNCHES.value == fa0 + cfg.num_layers
        want = forward(cfg, params, toks)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        st_dev = init_decode_state(cfg, B, max_len=S, device=cuda)
        st_cpu = init_decode_state(cfg, B, max_len=S, device=cpu)
        for t in range(S):
            pos = torch.full((B,), t, dtype=torch.int32)
            lg_dev, st_dev = serve_step(cfg, dev_params, st_dev,
                                        toks[:, t:t + 1].to(cuda),
                                        pos.to(cuda))
            lg_cpu, st_cpu = serve_step(cfg, params, st_cpu,
                                        toks[:, t:t + 1], pos)
            torch.testing.assert_close(lg_dev.cpu(), lg_cpu, rtol=1e-4,
                                       atol=1e-4)
            torch.testing.assert_close(lg_dev.cpu(), want[:, t:t + 1],
                                       rtol=1e-4, atol=1e-4)
        assert t_fd_ops.LAUNCHES.value == fd0 + cfg.num_layers * S
        for a, b in zip(st_dev["scan"], st_cpu["scan"]):
            torch.testing.assert_close(a["k"].cpu(), b["k"], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.gpu
def test_serve_decode_launcher_on_card(cuda, capsys):
    from repro_torch.launch.serve_decode import main

    before = t_fd_ops.LAUNCHES.value
    main(["--arch", "gemma2-2b", "--batch", "2", "--prompt-len", "4",
          "--gen", "6"])
    out = capsys.readouterr().out
    assert "== serve gemma2-2b (reduced) on cuda ==" in out
    assert t_fd_ops.LAUNCHES.value == before + 2 * 9


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_merge_gather_kernel_equals_plain_on_card(cuda, name):
    ids, feats, q, base, cdt, bdt = merge_case(name)
    t_ids, t_q = (t.to(cuda) for t in to_t(ids, q))
    t_feats = as_dtype(feats, cdt).to(cuda)
    t_base = as_dtype(base, bdt).to(cuda)
    pos, hit = t_search_ops.search(t_ids, t_q)
    before = t_search_ops.MERGE_LAUNCHES.value
    got = t_search_ops.merge_gather(t_feats, t_base, pos, hit)
    want = t_search_ops.merge_gather(t_feats, t_base, pos, hit,
                                     interpret=True)
    merged, mhit = t_search_ops.cache_lookup(t_ids, t_feats, t_q, t_base)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(merged, want) and torch.equal(mhit, hit)
    launched = 0 if ids.shape[0] == 0 else 2
    assert t_search_ops.MERGE_LAUNCHES.value == before + launched


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype,row_offset", [
    (602, torch.float32, 1), (602, torch.float32, 0), (2304, torch.float32, 3),
    (1, torch.float32, 1), (1, torch.bfloat16, 1), (3, torch.bfloat16, 1),
    (130, torch.bfloat16, 0)])
def test_merge_gather_misaligned_rows_on_card(cuda, d, dtype, row_offset):
    """Views that start mid-allocation give rows aligned to 2, 4, 8 or 16
    bytes; the kernel picks its vector width per row."""
    gen = torch.Generator().manual_seed(d + row_offset)
    m, n_hot = 1000, 97
    big = torch.randn((m + row_offset, d), generator=gen).to(cuda, dtype)
    base = big[row_offset:]
    cbig = torch.randn((n_hot + row_offset, d), generator=gen).to(cuda, dtype)
    feats = cbig[row_offset:]
    pos = torch.randint(0, n_hot + 5, (m,), generator=gen,
                        dtype=torch.int32).to(cuda)
    hit = (torch.rand((m,), generator=gen) < 0.6).to(cuda)
    got = t_search_ops.merge_gather(feats, base, pos, hit)
    want = t_search_ops.merge_gather(feats, base, pos, hit, interpret=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cache_gather_on_card_matches_cpu(cuda):
    from repro_torch.dist import cache_gather
    ids, feats, q, base, _, _ = merge_case("padded")
    cpu = cache_gather(*to_t(ids, feats, q, base))
    card = cache_gather(*(t.to(cuda) for t in to_t(ids, feats, q, base)))
    torch.cuda.synchronize()
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[1].cpu(), cpu[1])


@pytest.mark.gpu
def test_staged_epoch_on_card_matches_cpu(cuda):
    """The tiny graph's pipelined epoch, P = 4 workers on the card: the
    staged curve equals the fused one bit for bit and follows the CPU's
    within the reference's tolerance; merge_gather launches."""
    from repro_torch.core import build_schedule
    from repro_torch.core.schedule import epoch_edge_maxima
    from repro_torch.dist import (DeviceView, collate_device_epoch,
                                  epoch_k_max, make_mesh,
                                  make_pipelined_epoch, stack_caches)
    from repro_torch.graph import KHopSampler, load_dataset, partition_graph
    from repro_torch.models.gnn import GNNConfig, init_params
    from repro_torch.train import AdamW

    P, B = 4, 16
    g = load_dataset("tiny", seed=0)
    pg = partition_graph(g, P, "greedy")
    sampler = KHopSampler(g, fanouts=[5, 5], batch_size=B)
    es = [build_schedule(sampler, pg, worker=w, s0=7, num_epochs=1,
                         n_hot=64).epoch(0) for w in range(P)]
    dv = DeviceView.build(pg)
    caches = [dv.remap_cache(e.cache_ids) for e in es]
    m_max = max(e.m_max for e in es)
    edge_max = [max(x) for x in zip(*(epoch_edge_maxima(e) for e in es))]
    S = max(e.num_batches for e in es)
    batches = collate_device_epoch(es, caches, dv, g.labels, B, m_max,
                                   edge_max, epoch_k_max(es, caches, dv), S)
    cids, cfeats = stack_caches(caches, dv, 64)
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=32,
                    num_classes=g.num_classes, num_layers=2, fanouts=(5, 5),
                    agg_backend="kernel")
    curves = {}
    for device, backend in ((cuda, "staged"), (cuda, "fused"),
                            (torch.device("cpu"), "staged")):
        mesh = make_mesh((P,), ("data",), device=device)
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
        opt = AdamW(lr=3e-3)
        before = t_search_ops.MERGE_LAUNCHES.value
        fn = make_pipelined_epoch(cfg, opt, mesh, m_max,
                                  assemble_backend=backend)
        _, _, losses, _ = fn(params, opt.init(params), dv.table, dv.offsets,
                             cids, cfeats, batches)
        curves[(device.type, backend)] = losses.cpu()
        if device.type == "cuda" and backend == "staged":
            assert t_search_ops.MERGE_LAUNCHES.value == before + S * P
    assert torch.equal(curves[("cuda", "staged")], curves[("cuda", "fused")])
    np.testing.assert_allclose(curves[("cuda", "staged")].numpy(),
                               curves[("cpu", "staged")].numpy(), rtol=1e-4,
                               atol=1e-5)


def _runner_world(epochs: int = 3):
    from repro_torch.core import build_schedule
    from repro_torch.dist import DeviceView
    from repro_torch.graph import KHopSampler, load_dataset, partition_graph
    from repro_torch.models.gnn import GNNConfig

    g = load_dataset("tiny", seed=0)
    pg = partition_graph(g, 4, "greedy")
    sampler = KHopSampler(g, fanouts=[5, 5], batch_size=16)
    ws = [build_schedule(sampler, pg, worker=w, s0=7, num_epochs=epochs,
                         n_hot=64) for w in range(4)]
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=32,
                    num_classes=g.num_classes, num_layers=2, fanouts=(5, 5),
                    agg_backend="kernel")
    return g, pg, ws, DeviceView.build(pg), cfg


def _device_runner(world, device, layout="flat", **kw):
    from repro_torch.dist import DeviceRapidGNNRunner, Topology, make_mesh
    from repro_torch.train import AdamW
    g, _, ws, dv, cfg = world
    topo = Topology.parse(layout, 4)
    mesh = (topo.make_mesh(device) if topo.is_hierarchical
            else make_mesh((4,), ("data",), device=device))
    return DeviceRapidGNNRunner(ws, dv, cfg, AdamW(lr=3e-3), mesh, 16,
                                g.labels, topology=topo, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["flat", "2x2"])
def test_device_runner_on_card_matches_cpu(cuda, layout):
    """Three epochs of 4 workers on the card: lanes and wire rows equal
    the CPU port's, losses within the reference's tolerance, host
    parity, one shape key, and the card's kernels launched."""
    from repro_torch.dist import assert_host_parity
    world = _runner_world()
    before = {"search": t_search_ops.LAUNCHES.value,
              "assemble": t_assemble_ops.LAUNCHES.value,
              "gather_agg": t_gather_ops.LAUNCHES.value,
              "gather_agg_bwd": t_gather_ops.BWD_LAUNCHES.value}
    card_runner = _device_runner(world, cuda, layout)
    card = card_runner.run()
    torch.cuda.synchronize()
    for name, counter in (("search", t_search_ops.LAUNCHES),
                          ("assemble", t_assemble_ops.LAUNCHES),
                          ("gather_agg", t_gather_ops.LAUNCHES),
                          ("gather_agg_bwd", t_gather_ops.BWD_LAUNCHES)):
        assert counter.value > before[name], name
    cpu = _device_runner(world, torch.device("cpu"), layout).run()
    assert card_runner.trace_count == 1
    for a, b in zip(card, cpu):
        d_a, d_b = a.to_dict(), b.to_dict()
        for f in ("miss_lanes", "intra_lanes", "inter_lanes", "wire_rows",
                  "intra_wire_rows", "inter_wire_rows"):
            assert d_a[f] == d_b[f], f
        np.testing.assert_allclose(a.losses, b.losses, rtol=1e-4, atol=1e-5)
    _, pg, ws, _, _ = world
    assert_host_parity(ws, pg, 16, card)


@pytest.mark.gpu
def test_device_runner_resume_on_card_bit_equal(cuda, tmp_path):
    """Epoch 0 checkpointed on the card, epochs [1, 3) resumed by a fresh
    runner: the stitched curve and final weights equal an uninterrupted
    card run bit for bit."""
    from repro_torch.models.gnn import init_params
    from repro_torch.train import load_run_state
    world = _runner_world()
    full_runner = _device_runner(world, cuda)
    full = full_runner.run()
    head = _device_runner(world, cuda, checkpoint_dir=str(tmp_path)).run(
        stop_epoch=1)
    tail_runner = _device_runner(world, cuda)
    like_p = init_params(tail_runner.cfg, torch.Generator().manual_seed(1),
                         cuda)
    state, step = load_run_state(str(tmp_path), {
        "params": like_p, "opt": tail_runner.opt.init(like_p)})
    assert step == 1 and state["params"]["layers"][0]["b"].is_cuda
    tail = tail_runner.run(params=state["params"], opt_state=state["opt"],
                           start_epoch=1)
    stitched = np.concatenate([r.losses for r in head + tail])
    assert stitched.tobytes() == np.concatenate(
        [r.losses for r in full]).tobytes()
    for a, b in zip(tail_runner.params["layers"],
                    full_runner.params["layers"]):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert int(tail_runner.opt_state.step) == int(full_runner.opt_state.step)


@pytest.mark.gpu
def test_campaign_device_cell_on_card(cuda):
    """One fast-grid device cell (the rapid runner, 4 workers on the
    card) through the campaign's cell runner: ``search``, ``assemble``
    and ``gather_agg`` (forward and backward) launch, the cell's integer
    fields equal the same cell on the CPU, losses within the reference's
    tolerance, one shape key."""
    from repro_torch.eval import fast_grid, run_device_cells
    spec = fast_grid().device_cells()[0]
    assert spec.is_rapid and spec.topology == "flat"
    counters = (t_search_ops.LAUNCHES, t_assemble_ops.LAUNCHES,
                t_gather_ops.LAUNCHES, t_gather_ops.BWD_LAUNCHES)
    before = [c.value for c in counters]
    card = run_device_cells([spec], device=cuda)[0]
    torch.cuda.synchronize()
    for c, b in zip(counters, before):
        assert c.value > b, c.name
    cpu = run_device_cells([spec], device="cpu")[0]
    assert card.trace_count == 1
    for f in ("rpc_count", "miss_matrix", "wire_rows", "request_bytes",
              "payload_bytes", "vector_pull_bytes", "intra_wire_rows"):
        assert getattr(card, f) == getattr(cpu, f), f
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4,
                               atol=1e-5)
