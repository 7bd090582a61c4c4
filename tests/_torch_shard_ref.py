"""The JAX package's results over a ``("data", "model")`` mesh for the
port's tests (``tests/test_torch_sharding.py``), on 4 emulated host
devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/_torch_shard_ref.py OUT.npz

The device count of JAX is fixed when it first starts, so this runs in
a process of its own. Each function runs in the mesh context it needs
under jax 0.9.0:

  * ``sharded_decode_attention`` under ``with mesh:`` (``DECODE_CASES``:
    meshes (2, 2), (1, 2), (1, 4), G = 1 to 16, ragged lengths whose
    later shards hold no valid slot, softcap 50; ``dec_*``), and under
    ``jax.set_mesh`` where dp does not divide the batch;
  * ``moe_apply(mesh)``, both variants, and its gradient under
    ``jax.set_mesh`` (``MOE_CASES``: capacity factors 1.0 and 4.0, B*S
    divisible and not by dp; ``moe_*``);
  * ``forward(mesh)`` under ``with mesh:`` (``FORWARD_CASES``; ``fwd_*``);
  * 16-step ``serve_step(mesh)`` loops with ``unroll_layers=True`` under
    ``jax.set_mesh`` (``SERVE_CASES``; ``srv_*``).

Each call goes through ``jax.jit`` of the reference's own function:
eagerly, every ``shard_map`` traces and compiles anew at each call (some
5 s a decode step). ``serve_step`` itself does not run under ``jit``
(its cache scatter then meets data-sharded updates), so inside its loop
``sharded_decode_attention`` and ``moe_apply`` are routed through their
jitted selves.

Inputs are drawn here from seeded numpy and written beside the outputs;
parameters are the reference's ``init_params`` with every zero leaf
(norm scales) filled from a seed, written as ``<case>_p<i>`` in
``jax.tree.leaves`` order.
"""
import dataclasses
import sys
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

#: name -> (mesh shape, B, G, softcap, lengths); S=32, kvH=2, dh=16
DECODE_CASES = {
    "m22_g1": ((2, 2), 4, 1, 0.0, (0, 9, 32, 20)),
    "m22_g4_cap": ((2, 2), 4, 4, 50.0, (1, 17, 32, 8)),
    "m22_b3_g2": ((2, 2), 3, 2, 0.0, (5, 32, 16)),
    "m12_g8": ((1, 2), 4, 8, 0.0, (16, 3, 32, 17)),
    "m14_g16_cap": ((1, 4), 4, 16, 50.0, (1, 9, 32, 24)),
    "m14_g1": ((1, 4), 2, 1, 0.0, (7, 25)),
}
DECODE_DIMS = dict(S=32, kvH=2, dh=16)
#: name -> (mesh shape, experts, resident, capacity factor, (B, S))
MOE_CASES = {
    f"m22_{'res' if res else 'ep'}_cf{cf:g}_{B}x{S}": (
        (2, 2), 4, res, cf, (B, S))
    for res in (False, True) for cf in (1.0, 4.0)
    for B, S in ((2, 8), (1, 5))}
MOE_CASES.update({
    "m14_ep_cf1_2x8": ((1, 4), 8, False, 1.0, (2, 8)),
    "m14_res_cf1_2x8": ((1, 4), 8, True, 1.0, (2, 8)),
})
MOE_DIMS = dict(d_model=32, top_k=2, moe_d_ff=16)
#: name -> (reduced architecture, config fields); mesh (2, 2), tokens
#: FORWARD_TOKENS
FORWARD_CASES = {
    "qwen3-moe-30b-a3b-cf1": ("qwen3-moe-30b-a3b", {"capacity_factor": 1.0}),
    "arctic-480b": ("arctic-480b", {}),
    "arctic-480b-cf1": ("arctic-480b", {"capacity_factor": 1.0}),
}
FORWARD_TOKENS = (2, 16)
#: name -> (reduced architecture, config fields, mesh shape); B=2, 16
#: steps over a 16-slot cache
SERVE_CASES = {
    "gemma2-2b": ("gemma2-2b", {}, (1, 4)),
    "qwen3-moe-30b-a3b-cf1": ("qwen3-moe-30b-a3b",
                              {"capacity_factor": 1.0}, (2, 2)),
}
SERVE_B, SERVE_STEPS = 2, 16


def filled_params(cfg, seed):
    """``init_params`` with every all-zero leaf drawn from a seed."""
    from repro.models.transformer import init_params
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if not np.any(a):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(fill, init_params(cfg, jax.random.key(seed)))


def put_params(out, prefix, tree):
    for i, a in enumerate(jax.tree.leaves(tree)):
        out[f"{prefix}_p{i}"] = np.asarray(a)


def decode_case(out):
    from repro.dist import make_mesh
    from repro.serve.attention import sharded_decode_attention
    S, kvH, dh = (DECODE_DIMS[k] for k in ("S", "kvH", "dh"))
    for name, (shape, B, G, cap, lens) in DECODE_CASES.items():
        rng = np.random.default_rng(len(name) * 7 + G)
        q = rng.normal(size=(B, 1, kvH * G, dh)).astype(np.float32)
        k = rng.normal(size=(B, S, kvH, dh)).astype(np.float32)
        v = rng.normal(size=(B, S, kvH, dh)).astype(np.float32)
        ln = np.asarray(lens, np.int32)
        mesh = make_mesh(shape, ("data", "model"))
        # a batch that dp does not divide (replicated) runs only under
        # jax.set_mesh; under ``with mesh:`` its gather asks for it
        with mesh if B % shape[0] == 0 else jax.set_mesh(mesh):
            got = jax.jit(partial(sharded_decode_attention, mesh,
                                  attn_softcap=cap))(
                *map(jnp.asarray, (q, k, v, ln)))
        out.update({f"dec_{name}_q": q, f"dec_{name}_k": k,
                    f"dec_{name}_v": v, f"dec_{name}_len": ln,
                    f"dec_{name}_out": np.asarray(got)})


def moe_cfg(E, res, cf):
    from repro.models.transformer.common import ArchConfig
    return ArchConfig(name="moe", moe=True, num_experts=E, dtype="float32",
                      capacity_factor=cf, moe_resident_experts=res,
                      **MOE_DIMS)


def moe_case(out):
    from repro.dist import make_mesh
    from repro.models.transformer.moe import moe_apply
    for name, (shape, E, res, cf, (B, S)) in MOE_CASES.items():
        cfg = moe_cfg(E, res, cf)
        rng = np.random.default_rng(len(name) * 13 + E)
        d, ff = MOE_DIMS["d_model"], MOE_DIMS["moe_d_ff"]
        params = {"router": rng.normal(size=(d, E)),
                  "w1": rng.normal(size=(E, d, ff)) * d ** -0.5,
                  "w3": rng.normal(size=(E, d, ff)) * d ** -0.5,
                  "w2": rng.normal(size=(E, ff, d)) * ff ** -0.5}
        params = {k: v.astype(np.float32) for k, v in params.items()}
        x = rng.normal(size=(B, S, d)).astype(np.float32)
        ct = rng.normal(size=(B, S, d)).astype(np.float32)
        mesh = make_mesh(shape, ("data", "model"))

        def out_and_grads(p, x_):
            out, vjp = jax.vjp(partial(moe_apply, cfg=cfg, mesh=mesh), p, x_)
            return (out,) + vjp(jnp.asarray(ct))
        with jax.set_mesh(mesh):
            got, gp, gx = jax.jit(out_and_grads)(
                jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        out.update({f"moe_{name}_x": x, f"moe_{name}_ct": ct,
                    f"moe_{name}_out": np.asarray(got),
                    f"moe_{name}_gx": np.asarray(gx)})
        for k in params:
            out[f"moe_{name}_{k}"] = params[k]
            out[f"moe_{name}_g{k}"] = np.asarray(gp[k])


def forward_case(out):
    from repro.configs import get_reduced
    from repro.dist import make_mesh
    from repro.models.transformer import forward
    mesh = make_mesh((2, 2), ("data", "model"))
    for name, (arch, kw) in FORWARD_CASES.items():
        cfg = dataclasses.replace(get_reduced(arch), **kw)
        params = filled_params(cfg, 5)
        toks = np.random.default_rng(6).integers(
            0, cfg.vocab_size, FORWARD_TOKENS).astype(np.int32)
        with mesh:
            got = jax.jit(partial(forward, cfg, mesh=mesh))(
                params, jnp.asarray(toks))
        put_params(out, f"fwd_{name}", params)
        out.update({f"fwd_{name}_tokens": toks,
                    f"fwd_{name}_out": np.asarray(got)})


def jit_shard_maps():
    """Route ``block_decode``'s two ``shard_map`` users through
    ``jax.jit`` of themselves (compiled once per shape)."""
    import repro.models.transformer.blocks as blocks
    import repro.serve.attention as attn
    sda = jax.jit(attn.sharded_decode_attention, static_argnums=0,
                  static_argnames=("attn_softcap", "scale"))
    attn.sharded_decode_attention = \
        lambda mesh, *a, **kw: sda(mesh, *a, **kw)
    moe = jax.jit(blocks.moe_apply, static_argnums=2,
                  static_argnames=("mesh", "dp_spec", "cap"))
    blocks.moe_apply = lambda p, x, cfg, **kw: moe(p, x, cfg, **kw)


def serve_case(out):
    from repro.configs import get_reduced
    from repro.dist import make_mesh
    from repro.models.transformer import init_decode_state, serve_step
    jit_shard_maps()
    for name, (arch, kw, shape) in SERVE_CASES.items():
        cfg = dataclasses.replace(get_reduced(arch), unroll_layers=True,
                                  **kw)
        params = filled_params(cfg, 8)
        toks = np.random.default_rng(9).integers(
            0, cfg.vocab_size, (SERVE_B, SERVE_STEPS)).astype(np.int32)
        mesh = make_mesh(shape, ("data", "model"))
        states = init_decode_state(cfg, SERVE_B, SERVE_STEPS)
        steps = []
        with jax.set_mesh(mesh):
            for t in range(SERVE_STEPS):
                lg, states = serve_step(
                    cfg, params, states, jnp.asarray(toks[:, t:t + 1]),
                    jnp.full((SERVE_B,), t, jnp.int32), mesh=mesh)
                steps.append(np.asarray(lg[:, 0]))
        put_params(out, f"srv_{name}", params)
        out.update({f"srv_{name}_tokens": toks,
                    f"srv_{name}_logits": np.stack(steps, 1),
                    f"srv_{name}_k0": np.asarray(states["scan"][0]["k"])})


if __name__ == "__main__":
    assert len(jax.devices()) == 4, jax.devices()
    res = {}
    decode_case(res)
    moe_case(res)
    forward_case(res)
    serve_case(res)
    np.savez(sys.argv[1], **res)
    print("shard reference OK")
