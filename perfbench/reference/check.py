"""The numbers that decide ``correct``, each read beside its limit.

Exact numbers (limit 0): the partition, the sampled epochs' schedule
and hot sets, their residual-miss rows, and padded rows of the exchange
short of those rows. Training numbers (limits from
``limits/<cell>.json``): the loss of each of the first three steps,
and by the worst leaf the norm of AdamW's first moment and of the
parameters' change after the epochs that set-up trains (two calls of
the runner, the second staging while it trains, as the window's
passes do), each gap of norms over the
larger of the leaf's reference norm and the median leaf's; and the
median leaf's norm of the difference of the parameters' change,
relative to the reference's (``update_diff``): a gap of norms is blind
to a perturbation of random sign, such as rounding in a lower
precision, which this number sees. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out of the norms.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

#: a leaf whose step-1 reference gradient norm is under this share of
#: the median leaf's is left out of the norm gaps
NOUGHT_SHARE = 1e-3


def array_mismatch(a: np.ndarray, b: np.ndarray) -> int:
    """Elements that differ; a shape mismatch counts every element."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return int(max(a.size, b.size, 1))
    return int(np.count_nonzero(a != b))


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def counted_leaves(grad0: Dict[str, torch.Tensor]) -> List[str]:
    n = _norms(grad0)
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= NOUGHT_SHARE * med]


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: Sequence[str]) -> Tuple[float, str]:
    """Worst leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖) ->
    (gap, leaf)."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double()))
          for k in leaves}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double()))
          for k in leaves}
    med = float(np.median(list(rn.values())))
    worst, where = 0.0, ""
    for k in leaves:
        gap = abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
        if gap >= worst:
            worst, where = gap, k
    return worst, where


def diff_share(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: Sequence[str]) -> float:
    """The median leaf's ‖prog - ref‖ / ‖ref‖."""
    return float(np.median([
        float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
        / max(float(torch.linalg.vector_norm(ref[k].double())), 1e-30)
        for k in leaves]))


#: the steps whose losses are compared
LOSS_STEPS = 3


def loss_gaps(prog: Sequence[float], ref: Sequence[float]) -> List[float]:
    """Each step's |prog - ref| / |ref|."""
    return [abs(a - b) / max(abs(b), 1e-30) if np.isfinite(a)
            else float("inf") for a, b in zip(prog, ref)]


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The widest relative gap over the first ``LOSS_STEPS`` steps (later
    steps' losses fall near 0, where a relative gap is rounding)."""
    if len(prog) != len(ref):
        return float("inf")
    return float(max(loss_gaps(prog[:LOSS_STEPS], ref[:LOSS_STEPS])))


def training_numbers(prog_losses: Sequence[float],
                     prog_p0: Dict[str, torch.Tensor],
                     prog_p: Dict[str, torch.Tensor],
                     prog_mu: Dict[str, torch.Tensor],
                     ref_p0: Dict[str, torch.Tensor],
                     ref: Dict[str, object]) -> Dict[str, float]:
    """The training numbers of set-up's epochs: the program's losses,
    initial and final parameters and first moments against a
    ``model.train_steps`` result and the reference's initial
    parameters."""
    leaves = counted_leaves(ref["grad0"])
    d_prog = {k: prog_p[k].cpu() - prog_p0[k].cpu() for k in leaves}
    d_ref = {k: ref["params"][k].cpu() - ref_p0[k].cpu() for k in leaves}
    mu_ref = {k: ref["mu"][k].cpu() for k in leaves}
    mu_prog = {k: prog_mu[k].cpu() for k in leaves}
    return {"loss_gap": loss_gap(prog_losses, ref["losses"]),
            "moment_gap": norm_gap(mu_prog, mu_ref, leaves)[0],
            "update_gap": norm_gap(d_prog, d_ref, leaves)[0],
            "update_diff": diff_share(d_prog, d_ref, leaves)}
