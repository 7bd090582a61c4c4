"""The whole training step's share of the card's float32 peak: the
model's operations over the window's epochs, over the window's wall.

Operations of one worker's batch with n0 layer-0 dst rows, n1 seeds,
d inputs, H hidden, C classes and E0, E1 unmasked edges (GraphSAGE,
two layers, mean aggregation), counting unpadded rows and only the
products the gradient needs (layer 0's input, the features, takes no
gradient):
  forward   4 n0 d H + 4 n1 H C         (self and neighbour products)
            E0 d + n0 d + E1 H + n1 H   (the means' sums and divisions)
  backward  4 n0 d H                    (layer 0's weight gradients)
            8 n1 H C                    (layer 1's weight and input
                                         gradients)
            E1 H                        (layer 1's mean, scattered back)
Elementwise work (bias, ReLU, softmax, AdamW) is left out."""
import numpy as np


def batch_ops(d, H, C, n0, n1, E0, E1):
    return (8 * n0 * d * H + 12 * n1 * H * C
            + E0 * d + n0 * d + 2 * E1 * H + n1 * H)


def epoch_ops(ctx, e):
    d, H, C = ctx.layer_dims()
    tot = 0.0
    for wc in ctx.summary(e)["workers"]:
        if wc["m"].size:
            f = [x.astype(np.float64) for x in (
                wc["num_dst"][0], wc["num_dst"][1], wc["edges"][0],
                wc["edges"][1])]
            tot += float(np.sum(batch_ops(d, H, C, *f)))
    return tot


def read(ctx, spec):
    if ctx.window_s <= 0 or not ctx.reports or len(ctx.layer_dims()) != 3:
        return None
    ops = sum(epoch_ops(ctx, r.epoch) for r in ctx.reports)
    return 100.0 * ops / ctx.window_s / ctx.peaks["fp32_flop_per_s"]
