"""The production meshes of the dry-run and the card's constants for its
roofline: the port of ``repro/launch/mesh.py``.

``make_production_mesh`` has the reference's shapes and axis names --
``(16, 16)`` over ``("data", "model")``, and ``(2, 16, 16)`` over
``("pod", "data", "model")`` -- as a shape-only ``dist.mesh.Mesh`` on
the ``meta`` device: the model functions and ``dp_axes`` read it as they
read an in-process mesh, and nothing runs on it but a shape-only trace
(``launch.specs``, ``launch.dryrun``). A function, not a module
constant, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.dist.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    pods = 2 if multi_pod else 1
    return Mesh(num_workers=pods * 16, device=torch.device("meta"),
                model=16, pods=pods)


# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU data sheet:
# dense bfloat16 tensor-core peak (989.4 TFLOP/s without sparsity), HBM3
# bandwidth, memory size, and NVLink 4 bandwidth (900 GB/s in all, 450
# GB/s each way). These feed the dry-run's computed bounds only.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s per card
HBM_BW = 3.35e12                  # bytes/s per card
HBM_BYTES = 80e9                  # bytes per card
NVLINK_BW = 450e9                 # bytes/s per card, each way
