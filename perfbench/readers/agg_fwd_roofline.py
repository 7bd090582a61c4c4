"""The ``gather_agg`` forward's share of its byte roofline: at every
layer the distinct unmasked sources' rows read, the dst rows written,
and each unmasked edge's int32 source and bool mask read."""
import numpy as np

from perfbench.readers.common import roofline_share


def batch_bytes(ctx, wc):
    dims = ctx.layer_dims()
    return int(sum(np.sum(wc["uniq_src"][l] * dims[l] * 4
                          + wc["num_dst"][l] * dims[l] * 4
                          + wc["edges"][l] * 5)
                   for l in range(wc["num_dst"].shape[0])))


def read(ctx, spec):
    return roofline_share(ctx, spec, batch_bytes)
