"""Deprecation shim: ``repro_torch.launch.serve`` is
``repro_torch.launch.serve_decode``, as in the reference
(``repro/launch/serve.py``).

The transformer-decode demo lives at ``repro_torch.launch.serve_decode``;
the GNN inference service launcher is ``repro_torch.launch.serve_gnn``.
``python -m repro_torch.launch.serve`` prints that pointer on stderr and
runs the decode demo with the same arguments.
"""
from __future__ import annotations

import sys

from repro_torch.launch.serve_decode import main

if __name__ == "__main__":
    print("[deprecated] repro_torch.launch.serve is now repro_torch.launch."
          "serve_decode (GNN serving: repro_torch.launch.serve_gnn)",
          file=sys.stderr)
    main()
