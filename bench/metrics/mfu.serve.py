"""The whole step: the model's FLOPs for the graphs served in the
untraced window (``work.model.flops`` over each batch's real nodes and
valid edges) over the window's length times the card's fp32 peak, in %."""
from bench.peaks import FP32_FLOPS_PER_S
from bench.work import model as work


def read(ctx):
    w = ctx.window
    if not w["served"] or w["seconds"] <= 0:
        return None
    per_batch = [work.flops(ctx.model, *c) for c in ctx.batch_counts]
    done = sum(per_batch[p] for p in w["served"])
    return 100.0 * done / (w["seconds"] * FP32_FLOPS_PER_S)
