"""The JAX package's dry-run results for the port's tests
(``tests/test_torch_dryrun.py``), in a process of its own: the device
count of JAX is fixed when it first starts.

    XLA_FLAGS=--xla_force_host_platform_device_count=512 \\
        PYTHONPATH=src python tests/_torch_dryrun_ref.py specs OUT.json
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/_torch_dryrun_ref.py compile OUT.json

``specs``: ``make_dryrun_spec`` of every (arch x input shape) on the
16x16 and the 2x16x16 production meshes, without lowering; for each
argument, every leaf's shape, dtype and ``PartitionSpec`` (nested dicts
and lists; an optimizer state's fields as a dict). ``init_params`` is
shape-evaluated once an architecture (the same ``eval_shape`` each
combination would repeat).

``compile``: the compiled step's ``memory_analysis()`` of the reduced
configs in ``ARG_CASES`` on a (2, 2) ``("data", "model")`` mesh, the
``cost_analysis()["flops"]`` of one reduced cost-variant prefill on one
device (``FLOP_CASE``), and the collectives of the pipelined GNN epoch on
4 devices at the small shapes of ``GNN_DIMS``: the reference's own
``collective_bytes`` over the whole program and over the scan's while
body, and each all-to-all and all-reduce of the body with every operand
of its result tuple.
"""
import functools
import json
import re
import sys

import jax

#: (arch, shape) on the (2, 2) mesh at S=32, B=4
ARG_CASES = [(a, s) for a in ("granite-3-2b", "qwen3-moe-30b-a3b",
                              "seamless-m4t-medium", "qwen2-vl-72b")
             for s in ("train_4k", "prefill_32k", "decode_32k")]
ARG_S, ARG_B = 32, 4
#: (arch, repeats, S, B) of the cost-variant prefill on one device
FLOP_CASE = ("granite-3-2b", 2, 64, 2)
#: the GNN epoch at P = 4 (names as launch.dryrun_gnn.GNNDims)
GNN_DIMS = dict(d=16, B=20, n_hot=32, k_max=64, m_max=100, n_per=500, S=2,
                classes=8, hidden=32)
GNN_P = 4


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _leaf(x, sh):
    return {"shape": list(x.shape), "dtype": str(x.dtype),
            "spec": [_entry(e) for e in tuple(sh.spec)]}


def _plain(tree):
    """Containers -> dicts and lists (a NamedTuple -> a dict of fields)."""
    if isinstance(tree, dict):
        return {str(k): _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def specs() -> dict:
    from repro.configs import ARCH_NAMES, INPUT_SHAPES
    from repro.launch import specs as sp
    from repro.launch.mesh import make_production_mesh

    cached = functools.lru_cache(maxsize=None)(sp._eval_params)
    sp._eval_params = cached
    out = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        tag = "pod2" if multi_pod else "pod1"
        out[tag] = {}
        for arch in ARCH_NAMES:
            for shape in INPUT_SHAPES:
                spec = sp.make_dryrun_spec(arch, shape, mesh)
                args = [_plain(jax.tree.map(_leaf, a, s))
                        for a, s in zip(spec.args, spec.in_shardings)]
                out[tag][f"{arch}/{shape}"] = {
                    "args": args,
                    "attn_variant": spec.meta.get("attn_variant", "full")}
    return out


def _auto_mesh(shape, axes):
    """A mesh of the first devices with ``Auto`` axes: ``jax.make_mesh``
    makes ``Explicit`` ones under jax 0.9.0, whose sharding-in-types
    rejects the reference's train step (ROADMAP Queue 3 item 3)."""
    import numpy as np
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             axes)


def _compiled(spec, mesh):
    with mesh:
        jitted = jax.jit(spec.fn, in_shardings=spec.in_shardings,
                         out_shardings=spec.out_shardings)
        return jitted.lower(*spec.args).compile()


_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _computations(text: str) -> dict:
    """HLO module text -> {computation name: its text}."""
    comps, name, lines = {}, None, []
    for line in text.splitlines():
        if name is None:
            m = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
            if m:
                name, lines = m.group(1), []
        elif line.startswith("}"):
            comps[name] = "\n".join(lines)
            name = None
        else:
            lines.append(line)
    return comps


def _operands(body: str, op: str) -> list:
    """Each ``op`` instruction of ``body``: the bytes of every shape of
    its result (a tuple when several arrays travel at once: an
    all-to-all of G pieces, an all-reduce of a whole gradient tree)."""
    from repro.launch.dryrun import _shape_bytes
    out = []
    for line in body.splitlines():
        m = re.match(rf"\s*%?[\w.\-]+\s*=\s*(.*?)\s{op}(-start)?\(", line)
        if m:
            out.append([_shape_bytes(*s) for s in
                        _SHAPE_RE.findall(m.group(1))])
    return out


def gnn_collectives() -> dict:
    import numpy as np
    from repro.dist.gnn_step import make_pipelined_epoch
    from repro.launch.dryrun import collective_bytes
    from repro.launch.dryrun_gnn import specs as gnn_specs
    from repro.models.gnn import GNNConfig, init_params
    from repro.train.optim import AdamW

    g = GNN_DIMS
    edge_max = [g["m_max"] * 2, g["B"] * 25]
    cfg = GNNConfig(kind="sage", in_dim=g["d"], hidden_dim=g["hidden"],
                    num_classes=g["classes"], num_layers=2)
    opt = AdamW(lr=3e-3)
    params_s = jax.eval_shape(lambda k: init_params(cfg, k),
                              jax.random.key(0))
    opt_s = jax.eval_shape(opt.init, params_s)
    table, offsets, cids, cfeats, batches = gnn_specs(
        GNN_P, g["S"], g["m_max"], edge_max, g["B"], g["n_per"], g["d"],
        g["n_hot"], g["k_max"], g["classes"])
    mesh = _auto_mesh((GNN_P,), ("data",))
    with mesh:
        fn = make_pipelined_epoch(cfg, opt, mesh, g["m_max"])
        text = jax.jit(fn).lower(params_s, opt_s, table, offsets, cids,
                                 cfeats, batches).compile().as_text()
    comps = _computations(text)
    bodies = [m.group(1) for m in
              re.finditer(r"while\(.*?body=%?([\w.\-]+)", text)]
    per_body = {b: collective_bytes(comps[b]) for b in bodies}
    scan = [b for b in bodies if per_body[b]["counts"]["all-to-all"]]
    if len(scan) != 1:
        raise SystemExit(f"expected one while body with all-to-alls, got "
                         f"{scan} of {bodies}")
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree.leaves(params_s))
    return {"program": collective_bytes(text),
            "body": per_body[scan[0]],
            "body_operands": {op: _operands(comps[scan[0]], op)
                              for op in ("all-to-all", "all-reduce")},
            "n_params": n_params}


def compile_cases() -> dict:
    from repro.configs import get_reduced
    from repro.launch.specs import cost_variant_cfg, make_dryrun_spec

    mesh = _auto_mesh((2, 2), ("data", "model"))
    args = {}
    for arch, shape in ARG_CASES:
        spec = make_dryrun_spec(arch, shape, mesh, cfg=get_reduced(arch),
                                S=ARG_S, B=ARG_B)
        mem = _compiled(spec, mesh).memory_analysis()
        args[f"{arch}/{shape}"] = {
            "argument_size_in_bytes": mem.argument_size_in_bytes,
            "output_size_in_bytes": mem.output_size_in_bytes}
    arch, r, S, B = FLOP_CASE
    one = _auto_mesh((1, 1), ("data", "model"))
    cfg = cost_variant_cfg(get_reduced(arch), r, S)
    ca = _compiled(make_dryrun_spec(arch, "prefill_32k", one, cfg=cfg, S=S,
                                    B=B), one).cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return {"args": args, "flops": float(ca["flops"]),
            "gnn": gnn_collectives()}


if __name__ == "__main__":
    what, path = sys.argv[1], sys.argv[2]
    jax.devices()                     # fix the device count first
    res = specs() if what == "specs" else compile_cases()
    with open(path, "w") as f:
        json.dump(res, f)
