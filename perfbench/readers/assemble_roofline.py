"""The fused assembly's share of its byte roofline: each input row of a
batch read once from its winning source and written once, its int32
query read, and the worker's hot-set ids read once."""
import numpy as np

from perfbench.readers.common import roofline_share


def batch_bytes(ctx, wc):
    d = ctx.layer_dims()[0]
    return int(np.sum(2 * wc["m"] * d * 4 + wc["m"] * 4)
               + wc["m"].size * wc["n_hot"] * 4)


def read(ctx, spec):
    return roofline_share(ctx, spec, batch_bytes)
