"""Build, load and count the port's hand-written CUDA kernels.

Each kernel family keeps its CUDA C++ sources under
``kernels/<family>/csrc/*.cu``. At first use the family is compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface and loaded with ``ctypes`` -- no PyTorch headers, so a build
takes seconds. Libraries land in ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused.

Each C entry point launches on the stream it is handed (PyTorch's
current stream), allocates nothing and returns ``cudaGetLastError()``;
``check`` turns a non-zero code into an exception. ``LaunchCount`` is
the per-kernel launch counter the wrappers bump right after a launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
#: checkout root (``src/repro_torch/kernels`` -> three levels up)
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"

FAMILIES = ("cache_lookup", "assemble", "gather_agg", "seg_sort",
            "flash_attention", "flash_decode")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: one lock per family, so families may be built from threads at once
_locks: Dict[str, threading.Lock] = {f: threading.Lock() for f in FAMILIES}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}; the CUDA kernels are "
            f"built on a machine with the CUDA toolkit")
    return path


def sources(family: str) -> List[Path]:
    srcs = sorted((KERNELS_DIR / family / "csrc").glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"kernel family {family!r} has no csrc/*.cu")
    return srcs


def library_path(family: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(family):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{family}-{h.hexdigest()[:16]}.so"


def _compile(family: str) -> None:
    """Run ``nvcc`` for ``family`` unless its library exists; the output
    goes to a per-process file renamed over the library once complete,
    beside the compiler's log."""
    out = library_path(family)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sources(family))]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for kernel family {family!r} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(proc.stdout)


def library(family: str) -> ctypes.CDLL:
    """The loaded library of ``family``, built on first use."""
    with _locks[family]:
        lib = _libs.get(family)
        if lib is not None:
            return lib
        _compile(family)
        lib = ctypes.CDLL(str(library_path(family)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[family] = lib
        return lib


def check(family: str, kernel: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library(family).repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"error {err} ({msg})")


_sms: Dict[int, int] = {}


def multiprocessors(device) -> int:
    """The streaming multiprocessors of the CUDA ``device`` (cached)."""
    import torch
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _sms[idx]


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device`` as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class LaunchCount:
    """Launches of one kernel: its wrapper bumps it right after each
    launch and nowhere else, so a run can show it went through the
    kernel."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def bump(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def expect(t, name: str, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype``/``ndim``."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def use_plain(interpret: bool, *tensors) -> bool:
    """True when a wrapper must take its plain PyTorch version: the
    tensors lie on the CPU, or ``interpret=True`` asks for it. CUDA
    tensors otherwise go to the kernel; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if interpret or device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False
