"""The JAX package's multi-epoch device runners for the port's tests
(``tests/test_torch_runner.py`` at 4 workers,
``tests/test_torch_runner8.py`` at 8), on P emulated host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/_torch_runner_ref.py OUT.npz [P]

The device count of JAX is fixed when it first starts, so this runs in
a process of its own. Runs ``DeviceRapidGNNRunner`` and
``DeviceBaselineRunner`` on the ``tiny`` graph, P greedy parts (4 by
default), B = 16, GraphSAGE hidden 32, AdamW lr 3e-3, 3 epochs,
parameters from ``jax.random.key(0)``, on the flat mesh and on
``Topology.hierarchical(2, P // 2)``; writes each run's per-epoch report
(``{run}_{e}_{field}``), its ``to_dict`` keys, the final parameters and
the initial ones (``init_*``) to one ``.npz``. Runs are named
``rapid_flat``, ``rapid_2xD``, ``baseline_flat`` and ``baseline_2xD``
(D = P // 2).
"""
import sys

import numpy as np
import jax

P_, B, EPOCHS, N_HOT, HIDDEN, FANOUTS, S0, LR = 4, 16, 3, 64, 32, (5, 5), 7, 3e-3
FIELDS = ("losses", "accs", "miss_lanes", "wire_rows", "intra_lanes",
          "inter_lanes", "intra_wire_rows", "inter_wire_rows", "steps")


def main(path: str, P_: int = P_) -> None:
    from repro.core import build_schedule
    from repro.dist import (DeviceBaselineRunner, DeviceRapidGNNRunner,
                            DeviceView, Topology, make_mesh)
    from repro.graph import KHopSampler, load_dataset, partition_graph
    from repro.models import GNNConfig, init_params
    from repro.train import AdamW

    if jax.device_count() != P_:
        raise SystemExit(f"needs {P_} devices (XLA_FLAGS="
                         f"--xla_force_host_platform_device_count={P_})")
    g = load_dataset("tiny")
    pg = partition_graph(g, P_, "greedy")
    sampler = KHopSampler(g, fanouts=list(FANOUTS), batch_size=B)
    schedules = [build_schedule(sampler, pg, worker=w, s0=S0,
                                num_epochs=EPOCHS, n_hot=N_HOT)
                 for w in range(P_)]
    dv = DeviceView.build(pg)
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=HIDDEN,
                    num_classes=g.num_classes, num_layers=2)
    out = {}
    for l, layer in enumerate(init_params(cfg, jax.random.key(0))["layers"]):
        for k, v in layer.items():
            out[f"init_{l}_{k}"] = np.asarray(v)
    for kind, cls in (("rapid", DeviceRapidGNNRunner),
                      ("baseline", DeviceBaselineRunner)):
        for name, topo in (("flat", None),
                           (f"2x{P_ // 2}",
                            Topology.hierarchical(2, P_ // 2))):
            mesh = (make_mesh((P_,), ("data",)) if topo is None
                    else topo.make_mesh())
            runner = cls(schedules, dv, cfg, AdamW(lr=LR), mesh, B,
                         g.labels, topology=topo)
            run = f"{kind}_{name}"
            for r in runner.run():
                for f in FIELDS:
                    v = getattr(r, f)
                    out[f"{run}_{r.epoch}_{f}"] = np.asarray(
                        r.miss_lanes * 0 if v is None else v)
            out[f"{run}_keys"] = np.array(sorted(r.to_dict()))
            for l, layer in enumerate(runner.params["layers"]):
                for k, v in layer.items():
                    out[f"{run}_final_{l}_{k}"] = np.asarray(v)
    np.savez(path, **out)
    print("torch runner reference OK")


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:]))
