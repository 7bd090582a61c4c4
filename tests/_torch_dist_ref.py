"""The JAX package's device-distributed results for the port's tests
(``tests/test_torch_dist.py``), on 4 emulated host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/_torch_dist_ref.py OUT.npz

The device count of JAX is fixed when it first starts, so this runs in
a process of its own; the test process never starts a multi-device JAX.
Writes one ``.npz`` with the inputs and outputs of:

  * ``pull_features`` on a random plan (``pull_*``),
  * the pipelined and on-demand epochs of the ``tiny`` graph, P = 4,
    B = 16, GraphSAGE hidden 32, AdamW lr 3e-3, one epoch, parameters
    from ``jax.random.key(0)`` (``init_*``, ``rapid_*``, ``ondemand_*``),
  * the embedding lookup (``pull_features``, then ``cache_gather`` per
    worker) with a hot cache per worker (``emb_*``).
"""
import sys

import numpy as np
import jax
import jax.numpy as jnp

P_ = 4
EPOCH = dict(n_hot=64, batch=16, hidden=32, fanouts=(5, 5), s0=7, lr=3e-3)


def pull_case(out):
    from repro.dist import build_pull_plan, make_mesh, pull_features
    n_per, d, m_max, k_max = 16, 8, 12, 6
    rng = np.random.default_rng(0)
    table = rng.normal(size=(P_ * n_per, d)).astype(np.float32)
    table[3, :2] = -0.0                      # signed zeros become +0.0
    owner = np.repeat(np.arange(P_), n_per)
    plans = []
    for _ in range(P_):
        ids = rng.choice(P_ * n_per, size=m_max - 2, replace=False)
        pos = rng.permutation(m_max)[:m_max - 2]
        plans.append(build_pull_plan(ids.astype(np.int32),
                                     pos.astype(np.int32), owner, P_, k_max))
    send = {k: np.stack([getattr(p, k) for p in plans])
            for k in ("send_ids", "send_pos", "send_mask")}
    offsets = (np.arange(P_) * n_per).astype(np.int32)
    mesh = make_mesh((P_,), ("data",))
    with mesh:
        got = pull_features(mesh, jnp.asarray(table.reshape(P_, n_per, d)),
                            *(jnp.asarray(send[k]) for k in send),
                            jnp.asarray(offsets), m_max)
    out.update(pull_table=table.reshape(P_, n_per, d), pull_offsets=offsets,
               pull_m_max=np.int64(m_max), pull_out=np.asarray(got),
               **{f"pull_{k}": v for k, v in send.items()})


def epoch_case(out):
    from repro.core import build_schedule
    from repro.core.schedule import epoch_edge_maxima
    from repro.dist import (DeviceView, collate_device_epoch, empty_caches,
                            epoch_k_max, make_mesh, make_ondemand_epoch,
                            make_pipelined_epoch, stack_caches)
    from repro.graph import KHopSampler, load_dataset, partition_graph
    from repro.models import GNNConfig, init_params
    from repro.train import AdamW

    c = EPOCH
    g = load_dataset("tiny")
    pg = partition_graph(g, P_, "greedy")
    sampler = KHopSampler(g, fanouts=list(c["fanouts"]),
                          batch_size=c["batch"])
    schedules = [build_schedule(sampler, pg, worker=w, s0=c["s0"],
                                num_epochs=1, n_hot=c["n_hot"])
                 for w in range(P_)]
    dv = DeviceView.build(pg)
    es_list = [ws.epoch(0) for ws in schedules]
    m_max = max(es.m_max for es in es_list)
    edge_max = None
    for es in es_list:
        em = epoch_edge_maxima(es)
        edge_max = em if edge_max is None else [max(a, b) for a, b
                                                in zip(edge_max, em)]
    S = max(es.num_batches for es in es_list)
    caches = [dv.remap_cache(es.cache_ids) for es in es_list]
    batches = collate_device_epoch(es_list, caches, dv, g.labels,
                                   c["batch"], m_max, edge_max,
                                   epoch_k_max(es_list, caches, dv), S)
    cids, cfeats = stack_caches(caches, dv, c["n_hot"])
    empty = empty_caches(P_, g.feat_dim)
    base_batches = collate_device_epoch(es_list, empty, dv, g.labels,
                                        c["batch"], m_max, edge_max,
                                        epoch_k_max(es_list, empty, dv), S)
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=c["hidden"],
                    num_classes=g.num_classes, num_layers=2)
    params = init_params(cfg, jax.random.key(0))
    for l, layer in enumerate(params["layers"]):
        for k, v in layer.items():
            out[f"init_{l}_{k}"] = np.asarray(v)
    mesh = make_mesh((P_,), ("data",))

    def tree(bt):
        return jax.tree.map(jnp.asarray, bt)

    for name, fn, args in (
            ("rapid", make_pipelined_epoch(cfg, AdamW(lr=c["lr"]), mesh,
                                           m_max),
             (jnp.asarray(cids), jnp.asarray(cfeats), tree(batches))),
            ("ondemand", make_ondemand_epoch(cfg, AdamW(lr=c["lr"]), mesh,
                                             m_max),
             (tree(base_batches),))):
        opt = AdamW(lr=c["lr"])
        with mesh:
            p2, _, losses, accs = fn(params, opt.init(params),
                                     jnp.asarray(dv.table),
                                     jnp.asarray(dv.offsets), *args)
        out[f"{name}_losses"] = np.asarray(losses)
        out[f"{name}_accs"] = np.asarray(accs)
        for l, layer in enumerate(p2["layers"]):
            for k, v in layer.items():
                out[f"{name}_{l}_{k}"] = np.asarray(v)


def embedding_case(out):
    from repro.dist import (build_pull_plan, cache_gather, make_mesh,
                            pull_features)
    from repro.models.transformer.embedding import HotEmbeddingSim
    vocab, d, m, n_hot = 256, 16, 24, 8
    vper = vocab // P_
    rng = np.random.default_rng(3)
    table = rng.normal(size=(vocab, d)).astype(np.float32)
    ranks = rng.zipf(1.3, size=(P_, m)).astype(np.int64)
    tokens = ((ranks - 1) % vocab).astype(np.int32)
    counts = np.bincount(tokens.reshape(-1), minlength=vocab)
    sim = HotEmbeddingSim(vocab=vocab, d=d, num_workers=P_, n_hot=n_hot,
                          counts=counts)
    cache_ids = np.full((P_, n_hot), 2 ** 31 - 1, np.int32)
    cache_feats = np.zeros((P_, n_hot, d), np.float32)
    plans = []
    for w in range(P_):
        c = sim.cache[w]
        cache_ids[w, :c.size] = c
        cache_feats[w, :c.size] = table[c]
        miss = ~np.isin(tokens[w], c)
        plans.append(build_pull_plan(tokens[w][miss],
                                     np.flatnonzero(miss).astype(np.int32),
                                     sim.owner, P_, m))
    plan = {k: np.stack([getattr(p, k) for p in plans])
            for k in ("send_ids", "send_pos", "send_mask")}
    plan["offsets"] = (np.arange(P_) * vper).astype(np.int32)
    mesh = make_mesh((P_,), ("data",))
    # device_embedding_lookup's own vmap over the sharded pulled buffers
    # and the unsharded caches raises under jax 0.9.0 ("Mapped away
    # dimension of inputs passed to vmap should be sharded the same"), so
    # its two steps run here one after the other: the pull on the mesh,
    # then one cache_gather per worker
    with mesh:
        pulled = np.asarray(pull_features(
            mesh, jnp.asarray(table.reshape(P_, vper, d)),
            *(jnp.asarray(plan[k]) for k in ("send_ids", "send_pos",
                                              "send_mask")),
            jnp.asarray(plan["offsets"]), m))
    got = np.stack([np.asarray(cache_gather(
        jnp.asarray(cache_ids[w]), jnp.asarray(cache_feats[w]),
        jnp.asarray(tokens[w]), jnp.asarray(pulled[w]))[0])
        for w in range(P_)])
    out.update(emb_table=table.reshape(P_, vper, d), emb_cache_ids=cache_ids,
               emb_cache_feats=cache_feats, emb_tokens=tokens,
               emb_out=np.asarray(got),
               **{f"emb_{k}": v for k, v in plan.items()})


def main(path: str) -> None:
    if jax.device_count() != P_:
        raise SystemExit(f"needs {P_} devices (XLA_FLAGS="
                         f"--xla_force_host_platform_device_count={P_})")
    out = {}
    pull_case(out)
    epoch_case(out)
    embedding_case(out)
    np.savez(path, **out)
    print("torch dist reference OK")


if __name__ == "__main__":
    main(sys.argv[1])
