"""Card-only tests of the port: each CUDA kernel against its plain
PyTorch version on the same inputs, the serving slice on ``cuda``
against its own oracle and the CPU path, the training slice (the
device-compiled schedule, the train step) against the CPU path, and the
transformer decode-serving slice (prefill and decode; the enc-dec and
M-RoPE models too) against the CPU path, the device-distributed epoch (the ``merge_gather`` kernel,
``cache_gather``, a staged epoch), the multi-epoch runner (flat and
``2x2``, and a checkpointed resume) and LM training (reduced configs,
the MoE, SSD, RG-LRU, enc-dec and M-RoPE families among them) against
the CPU path, and LM training at granite-3-2b's width run twice
bit-equal. They import
no JAX, so they run on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips (the fixture decides, at run
time, so every pytest worker collects the same tests).
"""
import numpy as np
import pytest
import torch

from _torch_cases import (ASSEMBLE_CASES, BWD_CASES, BWD_FULL_CASES,
                          CROSS_ATTN_CASES, FLASH_ATTN_CASES,
                          FLASH_DECODE_CASES, GATHER_CASES, MERGE_CASES,
                          PLAN_KINDS, PLAN_N_HOTS, SEARCH_CASES, SORT_CASES,
                          as_dtype, assemble_case, bwd_case, cross_attn_case,
                          flash_attn_case, flash_decode_case, gather_case,
                          merge_case, plan_assemble_case, plan_case,
                          search_case, sort_case, to_t)
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
from repro_torch.kernels.seg_sort.seg_sort import CLUSTER, TILE
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)


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


PLAN_CASES = [(n, k) for n in PLAN_N_HOTS for k in PLAN_KINDS]
PLAN_IDS = [f"n{n}-{k}" for n, k in PLAN_CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("n_hot,kind", PLAN_CASES, ids=PLAN_IDS)
def test_search_kernel_at_plan_sizes_on_card(cuda, n_hot, kind):
    """The splitter-table kernel from one line of ids to beyond a
    one-line table (70,000): bit-equal to its plain version, one launch
    and one card operation a call."""
    ids, q = [t.to(cuda) for t in to_t(*plan_case(n_hot, kind, m=4096))]
    before = t_search_ops.LAUNCHES.value
    pos, hit = t_search_ops.search(ids, q)
    want_pos, want_hit = t_search_ops.search(ids, q, interpret=True)
    torch.cuda.synchronize()
    assert torch.equal(pos, want_pos) and torch.equal(hit, want_hit)
    assert t_search_ops.LAUNCHES.value == before + 1
    assert device_kernels(lambda: t_search_ops.search(ids, q)) == 1


def _fused_one_launch(tt, base, ti, tf, tq, tp):
    """Fused assembly on the card: bit-equal to the plain version, one
    ``assemble`` launch, no ``search`` launch, one card operation."""
    before = (t_assemble_ops.LAUNCHES.value, t_search_ops.LAUNCHES.value)
    got = t_assemble(tt, base, ti, tf, tq, tp, backend="fused")
    want = t_assemble(tt, base, ti, tf, tq, tp, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (t_assemble_ops.LAUNCHES.value,
            t_search_ops.LAUNCHES.value) == (before[0] + 1, before[1])
    assert device_kernels(lambda: t_assemble(tt, base, ti, tf, tq, tp,
                                             backend="fused")) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ASSEMBLE_CASES))
def test_assemble_kernel_equals_plain_on_card(cuda, name):
    table, base, ids, feats, q, pulled = assemble_case(name)
    tt, ti, tf, tq, tp = [t.to(cuda) for t in to_t(table, ids, feats, q,
                                                  pulled)]
    _fused_one_launch(tt, base, ti, tf, tq, tp)


@pytest.mark.gpu
@pytest.mark.parametrize("n_hot,kind", PLAN_CASES, ids=PLAN_IDS)
def test_fused_assemble_at_plan_sizes_on_card(cuda, n_hot, kind):
    """The warp's 32-ary rank from one line of ids to 70,000 (4 levels),
    with local, hit, missed, -1 and sentinel rows."""
    table, base, ids, feats, q, pulled = plan_assemble_case(
        n_hot, kind, m=2048, d=602)
    _fused_one_launch(*[t.to(cuda) if torch.is_tensor(t) else t for t in (
        *to_t(table), base, *to_t(ids, feats, q, pulled))])


@pytest.mark.gpu
def test_fused_assemble_cacheless_on_card(cuda):
    """No cache (the on-demand epoch's call): still one launch, no fill
    kernel for a stand-in cache, no search."""
    table, base, _, _, q, pulled = assemble_case("mixed")
    tt, tq, tp = [t.to(cuda) for t in to_t(table, q, pulled)]
    _fused_one_launch(tt, base, None, None, tq, tp)


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
    reference's cross-program tolerance of the CPU path, with the
    assembly and ``gather_agg`` kernels launched while serving and no
    ``search`` (the fused assembly ranks inside its own kernel)."""
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
    counters = (t_assemble_ops.LAUNCHES, t_gather_ops.LAUNCHES)
    before = [c.value for c in counters]
    searched = t_search_ops.LAUNCHES.value
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
    # the fused assembly ranks inside its own kernel
    assert t_search_ops.LAUNCHES.value == searched


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


#: keys a cluster of tiles takes
SPAN = CLUSTER * TILE

SORT_TILE_CASES = {
    # name: (n, num_bits, payload); a tile is TILE keys
    "tile_minus_one": (TILE - 1, 20, True),
    "tile": (TILE, 20, False),
    "tile_plus_one": (TILE + 1, 20, True),
    "two_tiles_plus_one_bits_31": (2 * TILE + 1, 31, True),
    "many_tiles_bits_3": (3 * TILE + 5, 3, True),
    "bits_1": (5000, 1, False),
    "all_equal": (10000, 20, True),
    "two_to_20_plus_3": (2 ** 20 + 3, 20, True),
    "cluster_minus_one": (SPAN - 1, 20, True),
    "cluster_minus_one_keys_only": (SPAN - 1, 21, False),
    "cluster": (SPAN, 22, True),
    "cluster_plus_one": (SPAN + 1, 20, True),
    "cluster_plus_one_keys_only": (SPAN + 1, 31, False),
    "three_clusters_plus_one": (3 * SPAN + 1, 20, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SORT_TILE_CASES))
def test_seg_sort_tiles_on_card(cuda, name):
    """Across tile and cluster boundaries, with sentinels between real
    keys: bit-equal to the plain version and to a second run, payload
    included, in at most 1 + passes card operations a call."""
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
@pytest.mark.parametrize("key_off,pay_off", [(1, 3), (2, 0), (3, 1)])
def test_seg_sort_unaligned_views_on_card(cuda, key_off, pay_off):
    """Keys and payload that start 4, 8 or 12 bytes past a 16-byte
    boundary (views into larger tensors): each tile's ends come by
    threads, its aligned body by the bulk copy; bit-equal to the plain
    version."""
    n, num_bits = SPAN + 2 * TILE + 5, 20
    rng = np.random.default_rng(key_off * 4 + pay_off)
    keys = rng.integers(0, 1 << num_bits, size=n + 4).astype(np.int32)
    keys[rng.random(n + 4) < 0.2] = 2 ** 31 - 1
    pay = rng.permutation(n + 4).astype(np.int32)
    tk = torch.from_numpy(keys).to(cuda)[key_off:key_off + n]
    tp = torch.from_numpy(pay).to(cuda)[pay_off:pay_off + n]
    assert tk.data_ptr() % 16 == 4 * key_off and tp.is_contiguous()
    sk, sp = t_sort_ops.seg_sort(tk, tp, num_bits=num_bits)
    wk, wp = t_sort_ops.seg_sort(tk.cpu(), tp.cpu(), num_bits=num_bits)
    torch.cuda.synchronize()
    assert torch.equal(sk.cpu(), wk) and torch.equal(sp.cpu(), wp)


@pytest.mark.gpu
@pytest.mark.parametrize("with_payload", [False, True])
def test_seg_sort_graph_replays_on_card(cuda, with_payload):
    """A call captured in a CUDA graph and replayed twice, over new keys
    each time, is bit-equal to the plain version both times: the per-card
    state (the histogram every call leaves zero) is fit for the next
    call."""
    n, num_bits = 3 * SPAN + 17, 20
    rng = np.random.default_rng(29 + with_payload)

    def draw():
        keys = rng.integers(0, 1 << num_bits, size=n).astype(np.int32)
        keys[rng.random(n) < 0.2] = 2 ** 31 - 1
        return torch.from_numpy(keys), torch.from_numpy(
            rng.permutation(n).astype(np.int32))
    k0, p0 = draw()
    tk = k0.to(cuda)
    tp = p0.to(cuda) if with_payload else None
    t_sort_ops.seg_sort(tk, tp, num_bits=num_bits)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sk, sp = t_sort_ops.seg_sort(tk, tp, num_bits=num_bits)
    for _ in range(2):
        k, p = draw()
        tk.copy_(k)
        if with_payload:
            tp.copy_(p)
        graph.replay()
        torch.cuda.synchronize()
        wk, wp = t_sort_ops.seg_sort(k, p if with_payload else None,
                                     num_bits=num_bits)
        assert torch.equal(sk.cpu(), wk)
        assert (sp is None and wp is None) or torch.equal(sp.cpu(), wp)


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
    # one route at every size: the order and the sums, no set-up ops
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
@pytest.mark.parametrize("name", sorted(CROSS_ATTN_CASES))
def test_flash_attention_without_mask_equals_plain_on_card(cuda, name):
    """``causal=False``, no window: k/v of their own length (Skv 1, 17,
    4001 against other Sq) and Skv == Sq, one launch, one card op."""
    q, k, v, dtype = cross_attn_case(name)
    tq, tk, tv = [t.to(cuda, _DTYPES[dtype]) for t in to_t(q, k, v)]
    before = t_fa_ops.LAUNCHES.value
    got = t_fa_ops.flash_attention(tq, tk, tv, causal=False)
    want = flash_attention_ref(tq, tk, tv, causal=False)
    torch.cuda.synchronize()
    assert got.dtype == tq.dtype and got.shape == tq.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert t_fa_ops.LAUNCHES.value == before + 1
    assert device_kernels(lambda: t_fa_ops.flash_attention(
        tq, tk, tv, causal=False)) == 1
    again = t_fa_ops.flash_attention(tq, tk, tv, causal=False)
    assert torch.equal(again, got)


#: the warpgroup-MMA kernel's edges, (B, S, Skv, H, kvH, dh, causal,
#: window, softcap): k/v lengths that end inside a TMA box (128 keys a
#: box at dh <= 128, 64 at dh 256), dh 48 and 72 zero-filled inside the
#: 64 and 128 instances, G = 3 and 16 with a group's rows split across
#: the two consumer warpgroups' 64-row edge, S = 1, and the served
#: models' first attention layers (PERF.md section 6 row 6) at a reduced
#: S, gemma2-2b's and recurrentgemma-9b's windows still binding
WGMMA_ROWS = {
    "skv129_across_a_box_g1_dh64": (1, 200, 129, 4, 4, 64, False, 0, 0.0),
    "skv65_across_a_box_g2_dh256": (1, 100, 65, 4, 2, 256, False, 0, 50.0),
    "skv4001_s1_g1_dh64": (2, 1, 4001, 4, 4, 64, False, 0, 0.0),
    "dh48_in_64_g2_softcap": (1, 257, 257, 4, 2, 48, True, 0, 50.0),
    "dh72_in_128_g3_window": (2, 150, 150, 6, 2, 72, True, 40, 30.0),
    "g3_across_warpgroups_dh128": (1, 129, 129, 9, 3, 128, True, 0, 0.0),
    "g16_across_warpgroups_dh256_window": (1, 300, 300, 16, 1, 256, True,
                                           100, 0.0),
    "s1_g8_dh128": (1, 1, 1, 8, 1, 128, True, 0, 0.0),
    "gemma2_local_s4608": (1, 4608, 4608, 8, 4, 256, True, 4096, 50.0),
    "gemma2_global_s2048": (1, 2048, 2048, 8, 4, 256, True, 0, 50.0),
    "recurrentgemma_local_s2560": (1, 2560, 2560, 16, 1, 256, True, 2048,
                                   0.0),
    "qwen3_moe_s1024": (1, 1024, 1024, 32, 4, 128, True, 0, 0.0),
    "qwen2_vl_s1024": (1, 1024, 1024, 64, 8, 128, True, 0, 0.0),
    "seamless_self_s2048": (1, 2048, 2048, 16, 16, 64, True, 0, 0.0),
    "seamless_encoder_s1024": (1, 1024, 1024, 16, 16, 64, False, 0, 0.0),
    "seamless_cross_s2048": (1, 2048, 1024, 16, 16, 64, False, 0, 0.0),
    "qwen15_32b_s1024_g1_dh128": (1, 1024, 1024, 40, 40, 128, True, 0,
                                  0.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WGMMA_ROWS))
def test_flash_attention_wgmma_edges_on_card(cuda, name):
    """bf16 on the warpgroup-MMA kernel within ``_tol("bfloat16")`` of
    the plain version, two runs bit-identical, a CUDA graph's replay
    equal to the eager call, one launch and one card operation a call."""
    B, S, Skv, H, kvH, dh, causal, window, cap = WGMMA_ROWS[name]
    gen = torch.Generator().manual_seed(S + 7 * Skv + H + dh)
    q = torch.randn((B, S, H, dh), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((B, Skv, kvH, dh), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap)

    def call():
        return t_fa_ops.flash_attention(q, k, v, **kw)
    before = t_fa_ops.LAUNCHES.value
    got, again = call(), call()
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_fa_ops.LAUNCHES.value == before + 2
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol("bfloat16"))
    assert torch.equal(got, again)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)
    assert device_kernels(call) == 1


@pytest.mark.gpu
def test_masked_attention_with_another_key_length_raises_on_card(cuda):
    """A causal or windowed call with Skv != Sq has no diagonal in the
    reference: the kernel's wrapper and the model's dispatch refuse it
    (no chunked path, no plain version on the card)."""
    from repro_torch.models.transformer.attention import attention
    q = torch.zeros((1, 40, 4, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 24, 4, 64), device=cuda, dtype=torch.bfloat16)
    before = t_fa_ops.LAUNCHES.value
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="only without a mask"):
            t_fa_ops.flash_attention(q, k, k, **kw)
    with pytest.raises(NotImplementedError, match="Sq=40 != Skv=24"):
        attention(q, k, k, causal=True)
    with pytest.raises(NotImplementedError, match="q_offset"):
        attention(q, q, q, q_offset=8)
    assert t_fa_ops.LAUNCHES.value == before


@pytest.mark.gpu
def test_flash_decode_cross_cache_on_card(cuda):
    """seamless-m4t-medium's cross caches: B=8, 16 heads over 16 kv heads
    (G = 1), dh 64, 4096 source positions, a length of its own a
    sequence (4096 - 97 b, then one 0), through ``decode_attention``:
    one launch, the plain version's result, exactly 0 where x_len = 0."""
    from repro_torch.models.transformer.attention import decode_attention
    gen = torch.Generator(device=cuda).manual_seed(23)
    B, H, dh, S = 8, 16, 64, 4096
    q = torch.randn((B, 1, H, dh), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, S, H, dh), generator=gen, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    x_len = (S - 97 * torch.arange(B, device=cuda)).to(torch.int32)
    x_len[5] = 0
    before = t_fd_ops.LAUNCHES.value
    got = decode_attention(q, k, v, x_len)
    acc, m, l = flash_decode_batched_ref(q[:, 0], k, v, x_len)
    torch.cuda.synchronize()
    assert t_fd_ops.LAUNCHES.value == before + 1
    torch.testing.assert_close(got[:, 0].float(),
                               finalize(acc, l).to(torch.bfloat16).float(),
                               rtol=2 ** -7, atol=1e-5)
    assert bool((got[5] == 0).all()) and bool(torch.isfinite(got).all())


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
@pytest.mark.parametrize("S", [48, 2048])
def test_flash_decode_sixteen_heads_a_kv_head_on_card(cuda, S):
    """recurrentgemma-9b's decode: B=8, 16 q heads over 1 kv head, dh
    256, bfloat16, the decode loop's 48-slot cache and a full 2048-slot
    window, lengths from 0 to S: one launch a call, within the
    reference's tolerance of the plain version (float32 outputs)."""
    gen = torch.Generator().manual_seed(S)
    B, H, kvH, dh = 8, 16, 1, 256
    q = torch.randn((B, H, dh), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((B, S, kvH, dh), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    ln = torch.tensor([S, S - 1, 1, 0, S // 2, 17, S, 3], dtype=torch.int32,
                      device=cuda)
    st = torch.tensor([0, 0, 0, 0, 5, 17, S // 3, 0], dtype=torch.int32,
                      device=cuda)
    before = t_fd_ops.LAUNCHES.value
    got = t_fd_ops.flash_decode_batched(q, k, v, ln, st)
    acc, m, l = flash_decode_batched_ref(q, k, v, ln, st)
    parts = t_fd_ops.flash_decode(q[0], k[0], v[0], ln[0], st[0])
    torch.cuda.synchronize()
    tol = dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got, finalize(acc, l), **tol)
    for g_, w_ in zip(parts, (acc[0], m[0], l[0])):
        torch.testing.assert_close(g_, w_, **tol)
    assert bool((got[3] == 0).all()) and bool((got[5] == 0).all())
    assert t_fd_ops.LAUNCHES.value == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("G", [12, 24, 32])
def test_flash_decode_wide_groups_on_card(cuda, G):
    """More than 16 q heads a kv head, or a group that 8 does not divide:
    the tensor-core kernel takes ceil(G/16) row tiles in one block (12 ->
    1, 24 and 32 -> 2), one launch a call, within the reference's
    tolerance of the plain version."""
    gen = torch.Generator().manual_seed(G)
    B, S, kvH, dh = 3, 300, 2, 128
    q = torch.randn((B, G * kvH, dh), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((B, S, kvH, dh), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    ln = torch.tensor([S, 77, 1], dtype=torch.int32, device=cuda)
    before = t_fd_ops.LAUNCHES.value
    got = t_fd_ops.flash_decode_batched(q, k, v, ln, softcap=30.0)
    acc, _, l = flash_decode_batched_ref(q, k, v, ln, softcap=30.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, finalize(acc, l), rtol=1e-4, atol=1e-5)
    assert t_fd_ops.LAUNCHES.value == before + 1


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


#: the served groups on the tensor-core kernel, (B, S, H, kvH, dh,
#: window): qwen3-moe-30b-a3b's and qwen2-vl-72b's heads (G = 8, dh 128)
#: at the decode loop's 48 slots and at 4096, recurrentgemma-9b's (G =
#: 16, dh 256) over a 2048-slot window of a longer cache
MMA_ROWS = {
    "qwen3-moe-48": (8, 48, 32, 4, 128, 0),
    "qwen3-moe-4096": (8, 4096, 32, 4, 128, 0),
    "qwen2-vl-48": (8, 48, 64, 8, 128, 0),
    "qwen2-vl-4096": (8, 4096, 64, 8, 128, 0),
    "recurrentgemma-window": (8, 4096, 16, 1, 256, 2048),
    # G = 1 in bfloat16: the CUDA-core kernel
    "qwen1.5-32b-48": (8, 48, 40, 40, 128, 0),
    "qwen1.5-32b-4096": (8, 4096, 40, 40, 128, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MMA_ROWS))
def test_flash_decode_served_groups_on_card(cuda, name):
    """The served models' groups, full and ragged lengths (0 and 1 among
    them): within the reference's tolerance of the plain version (the
    normalised output and the partials), exactly 0 where no slot is
    valid, two runs bit-identical, a CUDA graph's replay equal to the
    eager call, one launch and one card operation a call."""
    B, S, H, kvH, dh, window = MMA_ROWS[name]
    gen = torch.Generator().manual_seed(S + H)
    q = torch.randn((B, H, dh), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((B, S, kvH, dh), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    ln = torch.tensor([S, S - 1, 1, 0, S // 2, 17, S, 3], dtype=torch.int32,
                      device=cuda)
    st = (ln - window).clamp(min=0).to(torch.int32) if window else None

    def call():
        return t_fd_ops.flash_decode_batched(q, k, v, ln, st)
    before = t_fd_ops.LAUNCHES.value
    got, again = call(), call()
    parts = t_fd_ops.flash_decode_partials(q, k, v, ln, st)
    acc, m, l = flash_decode_batched_ref(q, k, v, ln, st)
    torch.cuda.synchronize()
    assert t_fd_ops.LAUNCHES.value == before + 3
    tol = dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got, finalize(acc, l), **tol)
    for g_, w_ in zip(parts, (acc, m, l)):
        torch.testing.assert_close(g_, w_, **tol)
    assert torch.equal(got, again)
    assert bool((got[3] == 0).all()) and bool((parts[1][3] == -1e30).all())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)
    assert device_kernels(call) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("tp", [2, 4])
def test_flash_decode_shard_planned_for_the_folded_batch_on_card(cuda, tp):
    """A rank's shard of a sequence-sharded cache, launched with
    ``plan_batch`` = the folded batch, gives the folded launch's rows bit
    for bit (qwen3-moe-30b-a3b's 4096 slots, bfloat16), so the process-
    group body equals the in-process form whatever the split plan."""
    gen = torch.Generator().manual_seed(tp)
    B, S, H, kvH, dh = 8, 4096, 32, 4, 128
    s = S // tp
    q = torch.randn((B, H, dh), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((B, S, kvH, dh), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    ln = torch.tensor([S, 1, S // 2, S // 2 + 1, 3 * S // 4, 17, S - 1,
                       S // 3], dtype=torch.int32, device=cuda)
    lf = (ln[:, None] - torch.arange(tp, device=cuda)[None, :] * s).clamp(
        0, s).to(torch.int32)
    folded = t_fd_ops.flash_decode_partials(
        q.repeat_interleave(tp, dim=0), k.reshape(B * tp, s, kvH, dh),
        v.reshape(B * tp, s, kvH, dh), lf.reshape(-1))
    for r in range(tp):
        kr, vr = (t[:, r * s:(r + 1) * s].contiguous() for t in (k, v))
        got = t_fd_ops.flash_decode_partials(q, kr, vr,
                                             lf[:, r].contiguous(),
                                             plan_batch=B * tp)
        for g_, f_ in zip(got, folded):
            assert torch.equal(g_, f_.reshape(B, tp, *f_.shape[1:])[:, r])


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [8, 24, 40, 72, 136, 200])
def test_flash_decode_head_widths_sixteen_does_not_divide_on_card(cuda, dh):
    """A head width that 16 does not divide (zero-padded to the MMA's k
    in shared memory) or that the instance's width exceeds: bfloat16, G
    = 4, ragged lengths and starts, softcap 30, against the plain version
    (output and partials)."""
    gen = torch.Generator().manual_seed(dh)
    B, S, H, kvH = 3, 700, 8, 2
    q = torch.randn((B, H, dh), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((B, S, kvH, dh), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    ln = torch.tensor([S, 333, 1], dtype=torch.int32, device=cuda)
    st = torch.tensor([0, 100, 0], dtype=torch.int32, device=cuda)
    got = t_fd_ops.flash_decode_batched(q, k, v, ln, st, softcap=30.0)
    parts = t_fd_ops.flash_decode_partials(q, k, v, ln, st, softcap=30.0)
    acc, m, l = flash_decode_batched_ref(q, k, v, ln, st, softcap=30.0)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got, finalize(acc, l), **tol)
    for g_, w_ in zip(parts, (acc, m, l)):
        torch.testing.assert_close(g_, w_, **tol)


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
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-72b"])
def test_encdec_and_mrope_slice_on_card_matches_cpu(cuda, arch):
    """Reduced configs in float32: the prefill (``encode`` and ``forward``
    with ``enc_out``, Sq != Skv; or patch embeddings and distinct M-RoPE
    streams) and a ``serve_step`` loop (cross caches filled from the
    encoder, ragged lengths, one 0; or M-RoPE streams a step) on the card
    against the CPU, one kernel launch an attention."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import (encode, forward,
                                                init_decode_state,
                                                init_params, serve_step)
    from repro_torch.train.optim import tree_map

    cfg = get_reduced(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    dev_params = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(2)
    B, S, S_src = 3, 37, 29
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32))
    frames = torch.from_numpy((0.02 * rng.standard_normal(
        (B, S_src if cfg.kind == "encdec" else S, cfg.d_model))).astype(
            np.float32))
    t = torch.arange(S)[None, :] + 3 * torch.arange(B)[:, None]
    streams = torch.stack([t, t // 8, t % 8]).to(torch.int32)
    x_len = torch.tensor([S_src, 11, 0], dtype=torch.int32)

    def run(dev, p):
        fa0, fd0 = t_fa_ops.LAUNCHES.value, t_fd_ops.LAUNCHES.value
        with torch.inference_mode():
            if cfg.kind == "encdec":
                enc = encode(cfg, p, frames.to(dev))
                full = forward(cfg, p, toks.to(dev), enc_out=enc)
            else:
                full = forward(cfg, p, toks.to(dev), embeds=frames.to(dev),
                               mrope_positions=streams.to(dev))
            st = init_decode_state(cfg, B, S, device=dev)
            if cfg.kind == "encdec":
                xp = p["blocks"][0]["xattn"]
                shape = (B, S_src, cfg.num_kv_heads, cfg.head_dim)
                st["scan"][0]["xk"] = torch.stack(
                    [(enc @ w).reshape(shape) for w in xp["wk"]])
                st["scan"][0]["xv"] = torch.stack(
                    [(enc @ w).reshape(shape) for w in xp["wv"]])
                st["scan"][0]["x_len"] = x_len.to(dev).expand(
                    cfg.num_layers, B).contiguous()
            steps = []
            for i in range(S):
                lg, st = serve_step(
                    cfg, p, st, toks[:, i:i + 1].to(dev),
                    torch.full((B,), i, dtype=torch.int32, device=dev),
                    mrope_positions=streams[:, :, i:i + 1].to(dev)
                    if cfg.mrope_sections else None)
                steps.append(lg[:, 0])
        n = cfg.num_layers * (2 if cfg.kind == "encdec" else 1)
        launches = (t_fa_ops.LAUNCHES.value - fa0,
                    t_fd_ops.LAUNCHES.value - fd0)
        return full.cpu(), torch.stack(steps, 1).cpu(), launches, n

    card = run(cuda, dev_params)
    host = run(torch.device("cpu"), params)
    n = card[3]
    assert card[2] == (n + cfg.num_enc_layers, n * S)
    for a, b in zip(card[:2], host[:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_encdec_default_state_serves_on_card(cuda):
    """seamless-m4t-medium (reduced, float32) decoding from
    ``init_decode_state``'s default cross caches of no source positions:
    the cross sub-block is skipped (one ``flash_decode`` a layer a step),
    and the card's logits are the CPU's."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import (init_decode_state,
                                                init_params, serve_step)
    from repro_torch.train.optim import tree_map

    cfg = get_reduced("seamless-m4t-medium")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    dev_params = tree_map(lambda t: t.to(cuda), params)
    B, S = 3, 9
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))

    def run(dev, p):
        st = init_decode_state(cfg, B, S, device=dev)
        assert st["scan"][0]["xk"].shape[2] == 0
        steps = []
        with torch.inference_mode():
            for i in range(S):
                lg, st = serve_step(
                    cfg, p, st, toks[:, i:i + 1].to(dev),
                    torch.full((B,), i, dtype=torch.int32, device=dev))
                steps.append(lg[:, 0].cpu())
        return torch.stack(steps, 1)

    before = t_fd_ops.LAUNCHES.value
    card = run(cuda, dev_params)
    assert t_fd_ops.LAUNCHES.value - before == cfg.num_layers * S
    assert bool(torch.isfinite(card).all())
    torch.testing.assert_close(card, run(torch.device("cpu"), params),
                               rtol=1e-4, atol=1e-4)


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
    for name, counter in (("assemble", t_assemble_ops.LAUNCHES),
                          ("gather_agg", t_gather_ops.LAUNCHES),
                          ("gather_agg_bwd", t_gather_ops.BWD_LAUNCHES)):
        assert counter.value > before[name], name
    # the fused assembly ranks inside its own kernel
    assert t_search_ops.LAUNCHES.value == before["search"]
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
    card) through the campaign's cell runner: ``assemble`` and
    ``gather_agg`` (forward and backward) launch, ``search`` does not (the
    fused assembly ranks inside its own kernel), the cell's integer
    fields equal the same cell on the CPU, losses within the reference's
    tolerance, one shape key."""
    from repro_torch.eval import fast_grid, run_device_cells
    spec = fast_grid().device_cells()[0]
    assert spec.is_rapid and spec.topology == "flat"
    counters = (t_assemble_ops.LAUNCHES, t_gather_ops.LAUNCHES,
                t_gather_ops.BWD_LAUNCHES)
    before = [c.value for c in counters]
    searched = t_search_ops.LAUNCHES.value
    card = run_device_cells([spec], device=cuda)[0]
    torch.cuda.synchronize()
    for c, b in zip(counters, before):
        assert c.value > b, c.name
    assert t_search_ops.LAUNCHES.value == searched
    cpu = run_device_cells([spec], device="cpu")[0]
    assert card.trace_count == 1
    for f in ("rpc_count", "miss_matrix", "wire_rows", "request_bytes",
              "payload_bytes", "vector_pull_bytes", "intra_wire_rows"):
        assert getattr(card, f) == getattr(cpu, f), f
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4,
                               atol=1e-5)


def _lm_train(cfg, device, gen_device, batch, seq, steps=3):
    """The launcher's AdamW and batches through ``make_train_step``: the
    loss curve, and the kernels' launches over the steps."""
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.models.transformer import init_params, make_train_step
    from repro_torch.train import AdamW

    params = init_params(cfg, torch.Generator(device=gen_device).manual_seed(
        0), device)
    opt = AdamW(lr=3e-4, weight_decay=0.01, max_grad_norm=1.0)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    before = (t_fa_ops.LAUNCHES.value, t_fd_ops.LAUNCHES.value)
    losses = []
    for b in synthetic_lm_batches(cfg, batch=batch, seq=seq, steps=steps,
                                  s0=0):
        params, state, aux = step(params, state,
                                  {k: v.to(device) for k, v in b.items()})
        losses.append(aux["loss"].item())
    launched = (t_fa_ops.LAUNCHES.value - before[0],
                t_fd_ops.LAUNCHES.value - before[1])
    return losses, launched


@pytest.mark.gpu
def test_lm_training_at_granite_width_bit_equal_on_card(cuda):
    """granite-3-2b's full width in bfloat16 at 2 layers, B=1, S=4096:
    the gradient path launches no attention kernel, and two fresh runs
    give the same loss curve bit for bit (the embedding's backward sums
    repeated Zipf tokens)."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("granite-3-2b"), num_layers=2)
    a, launched = _lm_train(cfg, cuda, cuda, 1, 4096)
    b, _ = _lm_train(cfg, cuda, cuda, 1, 4096)
    assert launched == (0, 0)
    assert all(np.isfinite(a)) and a == b


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b", "granite-3-2b",
                                  "qwen1.5-32b"])
def test_lm_training_reduced_on_card_matches_cpu(cuda, arch):
    """3 steps of the launcher's run in float32 from the same parameters:
    the card's losses within the reference's tolerance of the CPU's, a
    second card run bit-equal, no kernel launched."""
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch)
    cpu = torch.device("cpu")
    card, launched = _lm_train(cfg, cuda, cpu, 8, 128)
    again, _ = _lm_train(cfg, cuda, cpu, 8, 128)
    host, _ = _lm_train(cfg, cpu, cpu, 8, 128)
    assert launched == (0, 0) and card == again
    np.testing.assert_allclose(card, host, rtol=1e-4, atol=1e-5)


#: the non-dense families (config fields set on each): recurrentgemma-9b
#: at 5 layers holds its two rglru tail blocks
FAMILIES = {"qwen3-moe-30b-a3b": {}, "arctic-480b": {}, "mamba2-1.3b": {},
            "recurrentgemma-9b": {"num_layers": 5},
            "seamless-m4t-medium": {}, "qwen2-vl-72b": {}}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_lm_training_families_on_card_match_cpu(cuda, arch):
    """The MoE dispatch and combine, the SSD chunk scan, the RG-LRU scan,
    the encoder with cross-attention and M-RoPE under autograd: 3 steps of
    the launcher's run in float32 from the same parameters, the card's
    losses within the reference's tolerance of the CPU's, a second card
    run bit-equal, no kernel launched."""
    import dataclasses
    from repro_torch.configs import get_reduced
    cfg = dataclasses.replace(get_reduced(arch), **FAMILIES[arch])
    cpu = torch.device("cpu")
    card, launched = _lm_train(cfg, cuda, cpu, 8, 128)
    again, _ = _lm_train(cfg, cuda, cpu, 8, 128)
    host, _ = _lm_train(cfg, cpu, cpu, 8, 128)
    assert launched == (0, 0) and card == again
    np.testing.assert_allclose(card, host, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the ("data", "model") mesh: sequence-sharded decode, expert-parallel MoE
# ---------------------------------------------------------------------------

def _folded_case(G, cuda, B=8, S=1024, kvH=2, dh=128, tp=4):
    """A bfloat16 cache of B elements split into tp shards and folded into
    the batch; lengths whose later shards hold no valid slot (and one
    element of none at all)."""
    gen = torch.Generator().manual_seed(G)
    q = torch.randn((B, 1, kvH * G, dh), generator=gen)
    k, v = (torch.randn((B, S, kvH, dh), generator=gen) for _ in range(2))
    ln = torch.tensor([1, S // tp, S // tp + 1, S, 0, 3 * S // tp - 1, 17,
                       S - 1][:B], dtype=torch.int32)
    return [t.to(cuda, torch.bfloat16) for t in (q, k, v)] + [ln.to(cuda)]


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 8, 16])
def test_flash_decode_folded_shards_and_combine_equal_plain_on_card(cuda, G):
    """One ``flash_decode`` launch in partials mode over the folded (B*tp,
    S/tp) shards equals the plain version row by row (empty shards exactly
    m = -1e30, l = 0, acc = 0), and ``sharded_decode_attention`` equals
    the unsharded plain result; one kernel launch a call."""
    from repro_torch.dist import make_mesh
    from repro_torch.serve import sharded_decode_attention
    tp = 4
    q, k, v, ln = _folded_case(G, cuda, tp=tp)
    B, S = k.shape[:2]
    s = S // tp
    lf = (ln[:, None] - torch.arange(tp, device=cuda)[None, :] * s).clamp(
        0, s).reshape(-1).to(torch.int32)
    qf = q[:, 0].repeat_interleave(tp, dim=0)
    kf, vf = (t.reshape(B * tp, s, *t.shape[2:]) for t in (k, v))
    got = t_fd_ops.flash_decode_partials(qf, kf, vf, lf, softcap=50.0)
    want = flash_decode_batched_ref(qf, kf, vf, lf, softcap=50.0)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-5)
    empty = lf == 0
    assert bool(empty.any()) and bool((got[1][empty] == -1e30).all())
    assert bool((got[2][empty] == 0).all()) and \
        bool((got[0][empty] == 0).all())
    mesh = make_mesh((1, tp), ("data", "model"), device=cuda)
    before = t_fd_ops.LAUNCHES.value
    out = sharded_decode_attention(mesh, q, k, v, ln, attn_softcap=50.0)
    assert t_fd_ops.LAUNCHES.value == before + 1
    acc, m, l = flash_decode_batched_ref(q[:, 0], k, v, ln, softcap=50.0)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out[:, 0].float(),
                               finalize(acc, l).to(q.dtype).float(),
                               rtol=2 ** -7, atol=1e-5)
    assert bool((out[ln == 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("resident", [False, True])
def test_moe_apply_over_a_mesh_on_card_matches_cpu(cuda, resident):
    """The expert-parallel MoE (and its weight-stationary variant) of
    reduced qwen3-moe-30b-a3b over a (2, 2) mesh, capacity factor 1.0 so
    tokens are dropped: float32 on the card within ``rtol=1e-4,
    atol=1e-5`` of the CPU, a second card run bit-equal."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.dist import make_mesh
    from repro_torch.models.transformer.moe import (init_moe_params,
                                                    moe_apply)
    cfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"),
                              capacity_factor=1.0,
                              moe_resident_experts=resident)
    cpu = torch.device("cpu")
    p = init_moe_params(cfg, torch.Generator().manual_seed(2),
                        torch.float32)
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    runs = [moe_apply({k: t.to(dev) for k, t in p.items()}, x.to(dev), cfg,
                      mesh=make_mesh((2, 2), ("data", "model"), device=dev))
            .cpu() for dev in (cuda, cuda, cpu)]
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0], runs[2], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_dryrun_argument_bytes_are_what_the_card_allocates(cuda, shape):
    """``materialize`` allocates what the shape-only leaves declare: the
    inputs of a reduced granite-3-2b combination on a (1, 1) mesh, made
    on the card, grow the bytes asked of the allocator by
    ``argument_size_bytes`` exactly and ``memory_allocated`` by it up to
    512 B a leaf. Unsharded, this does not check the sharding arithmetic
    (the CPU tests hold that to the reference's compiled argument
    sizes). One step runs, finite, and the dry-run touches no card
    memory."""
    import math
    from repro_torch.configs import get_reduced
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.launch.dryrun import argument_bytes, run_one
    from repro_torch.launch.specs import make_dryrun_spec, materialize
    from repro_torch.train.optim import tree_leaves

    cfg = get_reduced("granite-3-2b")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rec = run_one("granite-3-2b", shape, False, cfg=cfg, S=64, B=2)
    assert torch.cuda.memory_allocated() == before
    mesh = make_mesh((1,), ("data",), cuda)
    spec = make_dryrun_spec("granite-3-2b", shape, mesh, cfg=cfg, S=64, B=2)
    want = argument_bytes(spec, mesh)
    a0 = torch.cuda.memory_allocated()
    r0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    args = materialize(list(spec.args), cuda,
                       torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    leaves = tree_leaves(args)
    grown = torch.cuda.memory_allocated() - a0
    assert torch.cuda.memory_stats()["requested_bytes.all.current"] - r0 \
        == want
    rounded = sum(math.ceil(t.numel() * t.element_size() / 512) * 512
                  for t in leaves)
    assert want <= grown <= rounded
    out = spec.fn(*args)
    first = out[2] if shape == "train_4k" else (
        out[0] if isinstance(out, tuple) else out)
    assert bool(torch.isfinite(first.float()).all())
    assert rec["memory"]["argument_size_bytes"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,theta", [(256, 10000.0), (64, 10000.0),
                                            (128, 1000000.0), (64, 1e6)])
def test_rope_at_long_500k_positions_on_card_equals_cpu(cuda, head_dim,
                                                        theta):
    """The RoPE frequencies on the card are the host's bit for bit, so a
    rotation at the positions of ``long_500k`` (up to 524,287) agrees
    with the CPU's; the card's own ``pow`` rounded some bands an ulp off,
    0.03 rad at those positions."""
    from repro_torch.models.transformer.common import apply_rope, rope_freqs
    assert torch.equal(rope_freqs(head_dim, theta, cuda).cpu(),
                       rope_freqs(head_dim, theta))
    gen = torch.Generator().manual_seed(head_dim)
    x = torch.randn((1, 4, 2, head_dim), generator=gen)
    pos = torch.tensor([[0, 4097, 524_286, 524_287]], dtype=torch.int32)
    got = apply_rope(x.to(cuda), pos.to(cuda), theta).cpu()
    np.testing.assert_allclose(got, apply_rope(x, pos, theta), rtol=1e-5,
                               atol=1e-5)
