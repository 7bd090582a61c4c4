"""The whole serving slice: the port's ``GNNInferenceService`` on the CPU
against the JAX reference service driven through its Pallas kernels in
interpret mode (``backend="fused"``, ``agg_backend="pallas_interpret"``).

Both services get the same graph, parameters, ``s0`` and request stream
and are stepped synchronously through the uncached -> fresh -> stale
ladder. Per response: logits within ``rtol=1e-4, atol=1e-5`` of the
reference (the reference's own cross-program tolerance; matrix products
sum in another order), tier, ``stale`` and ``cache_generation`` equal.
Accounting (``rpc_count``, ``remote_bytes``, ``served_*``,
``pull_retries``) is exactly equal, and every port response is bit-equal
to the port's own ``oracle()``.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import repro.fault as jfault
import repro_torch.fault as tfault
from repro.graph import KHopSampler as JSampler
from repro.graph import load_dataset as j_load, partition_graph as j_part
from repro.models.gnn import GNNConfig as JConfig, init_params as j_init
from repro.serve.gnn import GNNInferenceService as JService
from repro.serve.gnn import ServePullError as JServePullError
from repro.serve.gnn import WarmerError as JWarmerError
from repro_torch.graph import KHopSampler as TSampler
from repro_torch.graph import load_dataset as t_load, partition_graph as t_part
from repro_torch.graph.sampler import rng_from
from repro_torch.models.gnn import GNNConfig as TConfig, params_from_numpy
from repro_torch.serve.gnn import (TIER_FRESH, TIER_STALE, TIER_UNCACHED,
                                   GNNInferenceService as TService,
                                   ServePullError as TServePullError,
                                   WarmerError as TWarmerError)

S0 = 7
FANOUTS = (3, 3)
COUNTERS = ("served_fresh", "served_stale", "served_uncached", "errors",
            "completed", "micro_batches", "rpc_count", "remote_bytes",
            "pull_retries", "warm_generation", "warm_failures")
_CACHE = {}


def _worlds():
    if "worlds" not in _CACHE:
        gj, gt = j_load("tiny", seed=0), t_load("tiny", seed=0)
        kw = dict(kind="sage", in_dim=gj.feat_dim, hidden_dim=16,
                  num_classes=gj.num_classes, num_layers=2, fanouts=FANOUTS)
        jcfg = JConfig(agg_backend="pallas_interpret", **kw)
        tcfg = TConfig(agg_backend="kernel", **kw)
        jparams = j_init(jcfg, jax.random.key(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
        _CACHE["worlds"] = (
            (gj, j_part(gj, 4, "greedy"), JSampler(gj, list(FANOUTS), 4),
             jcfg, jparams),
            (gt, t_part(gt, 4, "greedy"), TSampler(gt, list(FANOUTS), 4),
             tcfg, tparams))
    return _CACHE["worlds"]


def _services(**kw):
    (gj, pj, sj, jcfg, jp), (gt, pt, st, tcfg, tp) = _worlds()
    kw.setdefault("n_hot", 32)
    kw.setdefault("default_timeout_s", 30.0)
    jsvc = JService(pj, sj, jcfg, jp, s0=S0, backend="fused",
                    interpret=True, program=_CACHE.get("jprogram"), **kw)
    _CACHE["jprogram"] = jsvc.program
    tsvc = TService(pt, st, tcfg, tp, s0=S0, device="cpu", **kw)
    return jsvc, tsvc


def _drain(svc, pendings, errors):
    served = 0
    while served < len(pendings):
        got = svc.step(timeout=0.1)
        assert got > 0, "dispatcher starved with requests outstanding"
        served += got
    out = []
    for p in pendings:
        try:
            out.append(p.result(timeout=5.0))
        except errors as exc:
            out.append(exc)
    return out


def _round(jsvc, tsvc, streams):
    """Submit the same streams to both services; -> paired results."""
    rj = _drain(jsvc, [jsvc.submit(s) for s in streams],
                (JServePullError,))
    rt = _drain(tsvc, [tsvc.submit(s) for s in streams],
                (TServePullError,))
    return list(zip(rj, rt))


def _check_pair(jr, tr, tsvc, seeds):
    if isinstance(jr, BaseException):
        assert isinstance(tr, TServePullError), (jr, tr)
        return
    assert not isinstance(tr, BaseException), tr
    assert tr.rid == jr.rid
    assert (tr.tier, tr.stale, tr.cache_generation) == \
        (jr.tier, jr.stale, jr.cache_generation)
    assert np.isfinite(tr.logits).all()
    np.testing.assert_allclose(tr.logits, jr.logits, rtol=1e-4, atol=1e-5)
    # the port is bit-equal to its own clean single-request oracle
    np.testing.assert_array_equal(tr.logits, tsvc.oracle(seeds, tr.rid))


def _same_health(jsvc, tsvc):
    hj, ht = jsvc.health(), tsvc.health()
    assert set(ht) == set(hj)
    assert ht["trace_count"] == 1
    for k in COUNTERS:
        assert ht[k] == hj[k], (k, ht[k], hj[k])


def _streams(seed, g, n):
    rng = rng_from(seed, 0x7E57)
    return [rng.integers(0, g.num_nodes, size=int(k))
            for k in rng.integers(1, 5, size=n)]


def test_tier_ladder_matches_jax_service():
    jsvc, tsvc = _services()
    g = _worlds()[1][0]
    try:
        streams = _streams(1, g, 8)
        for (jr, tr), s in zip(_round(jsvc, tsvc, streams[:3]), streams):
            assert tr.tier == TIER_UNCACHED
            _check_pair(jr, tr, tsvc, s)
        assert jsvc.warmer.warm_now() and tsvc.warmer.warm_now()
        for (jr, tr), s in zip(_round(jsvc, tsvc, streams[3:6]),
                               streams[3:]):
            assert tr.tier == TIER_FRESH
            _check_pair(jr, tr, tsvc, s)
        # a persistent fault on warm generation 2: both degrade to stale
        with jfault.active_plan(jfault.plan_from_profile(
                "serve-warm-stale", seed=0)), \
                tfault.active_plan(tfault.plan_from_profile(
                    "serve-warm-stale", seed=0)):
            with pytest.raises(JWarmerError):
                jsvc.warmer.warm_now()
            with pytest.raises(TWarmerError):
                tsvc.warmer.warm_now()
            for (jr, tr), s in zip(_round(jsvc, tsvc, streams[6:]),
                                   streams[6:]):
                assert tr.tier == TIER_STALE and tr.stale
                c = tr.served_cache
                np.testing.assert_array_equal(c.feats, g.features[c.ids])
                _check_pair(jr, tr, tsvc, s)
        _same_health(jsvc, tsvc)
        assert tsvc.health()["served_stale"] == 2
    finally:
        jsvc.close()
        tsvc.close()


@pytest.mark.parametrize("profile", ["serve-pull-flaky", "serve-pull-dead"])
def test_pull_faults_match_jax_service(profile):
    """Under the same seeded serve_pull plan the same rids fail typed and
    the retry count matches the reference."""
    jsvc, tsvc = _services()
    g = _worlds()[1][0]
    try:
        streams = _streams(6, g, 6)
        with jfault.active_plan(jfault.plan_from_profile(profile, seed=3)), \
                tfault.active_plan(tfault.plan_from_profile(profile,
                                                            seed=3)):
            pairs = _round(jsvc, tsvc, streams)
        failed_j = [i for i, (jr, _) in enumerate(pairs)
                    if isinstance(jr, BaseException)]
        failed_t = [i for i, (_, tr) in enumerate(pairs)
                    if isinstance(tr, BaseException)]
        assert failed_t == failed_j
        assert (failed_t == [1]) == (profile == "serve-pull-dead")
        for (jr, tr), s in zip(pairs, streams):
            _check_pair(jr, tr, tsvc, s)
        _same_health(jsvc, tsvc)
        assert tsvc.health()["pull_retries"] > 0
    finally:
        jsvc.close()
        tsvc.close()


def test_service_needs_a_device_or_an_explicit_cpu(monkeypatch):
    (_g, pt, st, tcfg, tp) = _worlds()[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TService(pt, st, tcfg, tp, s0=S0)
    svc = TService(pt, st, tcfg, tp, s0=S0, device="cpu")
    assert svc.device.type == "cpu"
    svc.close()


def test_launcher_serves_a_stream_on_the_cpu():
    """``python -m repro_torch.launch.serve_gnn --device cpu`` serves a
    small Poisson stream end to end and prints its health snapshot."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_gnn", "--device",
         "cpu", "--requests", "12", "--rate", "400", "--fanouts", "3", "3"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "12 requests in" in p.stdout and "0 errors" in p.stdout
    health = json.loads(p.stdout[p.stdout.index("{"):])
    assert health["completed"] == 12 and health["errors"] == 0


def test_threaded_service_serves_bit_equal_to_oracle():
    """Online mode: dispatcher and warmer threads running, responses
    still bit-equal to the oracle (any tier), clean shutdown."""
    (g, pt, st, tcfg, tp) = _worlds()[1]
    svc = TService(pt, st, tcfg, tp, s0=S0, device="cpu", n_hot=32,
                   default_timeout_s=30.0, warm_interval_s=0.01).start()
    try:
        streams = _streams(2, g, 12)
        pendings = [svc.submit(s) for s in streams]
        for p, s in zip(pendings, streams):
            r = p.result(timeout=60.0)
            np.testing.assert_array_equal(r.logits, svc.oracle(s, r.rid))
    finally:
        svc.close()
    assert svc.pending_error() is None
    assert svc.health()["completed"] == len(streams)


def test_services_sharing_one_program_keep_one_trace():
    """Two services handed the same ``ServeProgram`` serve a request
    stream through it: the program sees one static input shape, so
    ``trace_count`` stays 1 on both, and each service's responses stay
    bit-equal to its oracle. A program of other static shapes is
    refused."""
    (g, pt, st, tcfg, tp) = _worlds()[1]
    kw = dict(s0=S0, device="cpu", n_hot=32, default_timeout_s=30.0)
    a = TService(pt, st, tcfg, tp, **kw)
    b = TService(pt, st, tcfg, tp, program=a.program, **kw)
    try:
        assert b.program is a.program and a.trace_count == 0
        for svc, seed in ((a, 3), (b, 4), (a, 5)):
            streams = _streams(seed, g, 6)
            got = _drain(svc, [svc.submit(s) for s in streams], ())
            for r, s in zip(got, streams):
                np.testing.assert_array_equal(r.logits, svc.oracle(s, r.rid))
            svc.warmer.warm_now()
        assert a.trace_count == b.trace_count == 1
        assert a.health()["trace_count"] == b.health()["trace_count"] == 1
        with pytest.raises(ValueError, match="static shape"):
            TService(pt, st, tcfg, tp, program=a.program,
                     max_batch_requests=2, **kw)
    finally:
        a.close()
        b.close()
