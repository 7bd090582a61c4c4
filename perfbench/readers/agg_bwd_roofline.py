"""The ``gather_agg`` backward's share of its byte roofline, at every
layer but the first (whose input, the features, takes no gradient):
the dst rows' gradient read, each unmasked edge read (int32 source,
bool mask), and the gradient of every src row of the layer written."""
import numpy as np

from perfbench.readers.common import roofline_share


def batch_bytes(ctx, wc):
    dims = ctx.layer_dims()
    return int(sum(np.sum(wc["num_dst"][l] * dims[l] * 4
                          + wc["edges"][l] * 5
                          + wc["num_dst"][l - 1] * dims[l] * 4)
                   for l in range(1, wc["num_dst"].shape[0])))


def read(ctx, spec):
    return roofline_share(ctx, spec, batch_bytes)
