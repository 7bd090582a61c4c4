"""Hand-written CUDA kernels of the port (Hopper, ``sm_90a``).

Each ``kernels/<family>/`` holds the ops/ref/impl triple: ``ops.py`` is
the public wrapper (plain version for CPU tensors or ``interpret=True``,
the CUDA kernel for CUDA tensors, a launch counter), ``ref.py`` the
plain PyTorch version the kernel is held against, ``<family>.py`` the
``ctypes`` binding of the kernel built from ``csrc/*.cu``
(``kernels/_build.py``).
"""
