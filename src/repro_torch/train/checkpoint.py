"""Checkpointing: parameter tree -> one npz of leaves + JSON manifest.

The port of ``save_checkpoint`` / ``load_checkpoint`` /
``checkpoint_step`` from the JAX package's ``repro/train/checkpoint.py``
in the same on-disk format: leaves are keyed by their path with ``/``
between parts (``layers/0/w_self``), stored as ``::``-joined names in
``arrays.npz``, beside a ``manifest.json`` of step, shapes and dtypes.
So a checkpoint written by either package loads in the other.

Crash safety: every file is written tmp + fsync + rename, and the
manifest is renamed LAST -- it is the commit marker, so a crash at any
point leaves either the previous checkpoint or a complete new one,
never a torn mix under the final names. Loads validate leaf set, shapes,
manifest agreement, and (optionally) the step, raising
``CheckpointCorruptError`` instead of raw numpy errors.
``save_run_state``/``load_run_state`` layer per-step directories
(``root/step_XXXXXXXX/``) and an atomic ``LATEST`` pointer on top for
periodic crash-resume, in the reference's layout, so a run state written
by either package resumes in the other.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.fault.inject import fault_point
from repro_torch.train.optim import tree_map

PyTree = Any
_SEP = "/"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity at load: torn archive, manifest
    missing/disagreeing, leaf-set/shape/step mismatch."""


def _flatten(tree: PyTree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf}, with the JAX key paths (dict keys sorted, list
    indices as numbers, a NamedTuple's fields as ``.name``)."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif hasattr(tree, "_fields"):
        items = ((f".{k}", getattr(tree, k)) for k in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, t in items:
        flat.update(_flatten(t, f"{prefix}{_SEP}{k}" if prefix else k))
    return flat


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _commit_bytes(path: str, write_fn) -> None:
    """Atomic file write: tmp + flush + fsync + rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(path: str, tree: PyTree, step: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    manifest = {"step": step, "leaves": {
        k: {"shape": list(a.shape), "dtype": str(a.dtype)}
        for k, a in arrays.items()}}
    named = {k.replace(_SEP, "::"): v for k, v in arrays.items()}

    def _write_arrays(f):
        # repro: allow(SPILL-SAFETY) -- checkpoint shards are flat ndarrays keyed by leaf path; allow_pickle stays off
        np.savez(f, **named)

    _commit_bytes(os.path.join(path, "arrays.npz"), _write_arrays)
    # crash probe between the two commits: dying here must leave any
    # PREVIOUS checkpoint valid (the manifest rename below is the
    # commit marker, so a stale manifest + new arrays cannot happen)
    fault_point("checkpoint", epoch=step)
    _commit_bytes(os.path.join(path, "manifest.json"),
                  lambda f: f.write(json.dumps(manifest,
                                               indent=1).encode()))


def load_checkpoint(path: str, like: PyTree,
                    expect_step: Optional[int] = None) -> PyTree:
    """The checkpoint at ``path`` as a tree shaped like ``like``: a
    tensor leaf of ``like`` gives a tensor on its device, any other leaf
    a numpy array."""
    mpath = os.path.join(path, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest {mpath}: {exc!r}") from exc
    if expect_step is not None and manifest.get("step") != expect_step:
        raise CheckpointCorruptError(
            f"checkpoint step mismatch at {path}: manifest says "
            f"{manifest.get('step')}, expected {expect_step}")
    apath = os.path.join(path, "arrays.npz")
    try:
        # repro: allow(SPILL-SAFETY) -- reads back the flat npz checkpoint shards; allow_pickle stays off
        with np.load(apath) as z:
            data = {k.replace("::", _SEP): z[k] for k in z.files}
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as exc:
        raise CheckpointCorruptError(
            f"torn checkpoint shards {apath}: {exc!r}") from exc
    flat_like = _flatten(like)
    if set(data) != set(flat_like):
        missing = sorted(set(flat_like) - set(data))[:4]
        extra = sorted(set(data) - set(flat_like))[:4]
        raise CheckpointCorruptError(
            f"checkpoint leaf set at {path} does not match the restore "
            f"target: missing {missing}, unexpected {extra}")
    mleaves = manifest.get("leaves", {})
    if set(mleaves) != set(data):
        raise CheckpointCorruptError(
            f"manifest/arrays leaf sets disagree at {path} (torn commit)")
    for key, leaf in flat_like.items():
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise CheckpointCorruptError(
                f"shape mismatch for {key} at {path}: saved "
                f"{tuple(arr.shape)}, restore target {tuple(leaf.shape)}")
        ml = mleaves[key]
        if (list(arr.shape) != list(ml["shape"])
                or str(arr.dtype) != ml["dtype"]):
            raise CheckpointCorruptError(
                f"manifest disagrees with arrays for {key} at {path}")
    leaves = iter(data[k] for k in flat_like)

    def restore(leaf):
        arr = next(leaves)
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(arr).to(leaf.device)
        return arr
    return tree_map(restore, like)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]


# ---------------------------------------------------------------------------
# periodic run state: per-step dirs + atomic LATEST pointer
# ---------------------------------------------------------------------------

def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def save_run_state(root: str, tree: PyTree, step: int) -> str:
    """One periodic checkpoint: ``root/step_XXXXXXXX/`` committed first,
    then the ``LATEST`` pointer renamed in -- so a crash anywhere leaves
    ``LATEST`` naming a COMPLETE checkpoint (possibly the previous one,
    never a torn one)."""
    os.makedirs(root, exist_ok=True)
    d = _step_dir(root, step)
    save_checkpoint(d, tree, step=step)
    _commit_bytes(os.path.join(root, "LATEST"),
                  lambda f: f.write(f"{step}\n".encode()))
    return d


def latest_step(root: str) -> Optional[int]:
    """The step ``LATEST`` names under ``root``; None when there is no
    pointer. A pointer that does not hold a step number raises
    ``CheckpointCorruptError``."""
    p = os.path.join(root, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        text = f.read().strip()
    try:
        return int(text)
    except ValueError as exc:
        raise CheckpointCorruptError(
            f"torn LATEST pointer {p}: {text!r}") from exc


def load_run_state(root: str, like: PyTree) -> Tuple[PyTree, int]:
    """Resume from the newest committed checkpoint under ``root``:
    -> (the tree shaped like ``like``, its step)."""
    step = latest_step(root)
    if step is None:
        raise CheckpointCorruptError(f"no LATEST pointer under {root}")
    tree = load_checkpoint(_step_dir(root, step), like, expect_step=step)
    return tree, step
